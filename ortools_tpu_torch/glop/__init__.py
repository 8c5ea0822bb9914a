from ortools_tpu_torch.glop.simplex import SimplexResult, solve  # noqa: F401
