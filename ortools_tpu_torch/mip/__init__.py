from ortools_tpu_torch.mip.branch_and_bound import MipParams, MipResult, solve  # noqa: F401
