"""N-queens with CP-SAT (parity: sat/samples/nqueens_sat)."""

import argparse

from ortools_tpu_torch.sat import CpModel, CpSolver, CpSolverSolutionCallback


def main(board_size: int = 8, device="cuda"):
    model = CpModel()
    queens = [model.new_int_var(0, board_size - 1, f"q{i}")
              for i in range(board_size)]
    model.add_all_different(queens)
    model.add_all_different(queens[i] + i for i in range(board_size))
    model.add_all_different(queens[i] - i for i in range(board_size))

    class Counter(CpSolverSolutionCallback):
        def __init__(self):
            super().__init__()
            self.count = 0

        def on_solution_callback(self):
            self.count += 1

    solver = CpSolver(device=device)
    solver.parameters.enumerate_all_solutions = True
    counter = Counter()
    solver.solve(model, counter)
    print(f"{board_size}-queens: {counter.count} solutions, "
          f"{solver.num_branches} branches")
    if board_size == 8:
        assert counter.count == 92
    return counter.count


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("board_size", type=int, nargs="?", default=8)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    main(args.board_size, device=args.device)
