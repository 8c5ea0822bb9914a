"""Weighted partial max-SAT from a wCNF string (parity:
examples using sat_runner with sat_cnf_reader.h inputs).

Demonstrates the SAT I/O layer (sat/sat_io.py): hard clauses become
bool_or constraints, soft clauses get weighted relaxation literals, and
the objective rides the core-guided (OLL) descent — or the MaxHS
hitting-set optimizer via ``core_algorithm="max_hs"``.
"""

import argparse

from ortools_tpu_torch.sat.params import SatParameters
from ortools_tpu_torch.sat.sat_io import read_wcnf
from ortools_tpu_torch.sat.solver import solve_model
from ortools_tpu_torch.utils.status import SolveStatus

# hard: x1 or x2; x3 or not x1.  soft: not x1 (w=3), not x2 (w=5),
# not x3 (w=2).  Best: x1 true forces x3 -> cost 3+2=5... but x2 true
# alone costs 5 too; x1,x3 true costs 5 as well — tie at 5.
WCNF = """\
c tiny weighted partial max-SAT
p wcnf 3 5 100
100 1 2 0
100 3 -1 0
3 -1 0
5 -2 0
2 -3 0
"""


def main(device="cuda"):
    model = read_wcnf(WCNF)
    for algo in ("oll", "max_hs"):
        params = SatParameters(core_algorithm=algo)
        r = solve_model(model, params, device=device)
        assert r.status == SolveStatus.OPTIMAL
        print(f"{algo}: optimal soft-violation cost = {r.objective_value}")
        assert r.objective_value == 5
    return 5


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(device=p.parse_args().device)
