from ortools_tpu_torch._native.build import load_library  # noqa: F401
