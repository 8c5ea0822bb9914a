from ortools_tpu_torch.packing.bin_packing import (  # noqa: F401
    BinPackingInstance,
    first_fit_decreasing,
    solve_bin_packing,
)
