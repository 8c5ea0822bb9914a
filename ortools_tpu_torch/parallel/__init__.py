from ortools_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
