from ortools_tpu_torch.scheduling.jobshop import (  # noqa: F401
    JobshopInstance,
    parse_jobshop,
    solve_jobshop,
    solve_jobshop_cdcl,
)
from ortools_tpu_torch.scheduling.rcpsp import RcpspInstance, parse_rcpsp  # noqa: F401
