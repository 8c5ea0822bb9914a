from ortools_tpu_torch.flatzinc.driver import solve_flatzinc, solve_fzn_text  # noqa: F401
