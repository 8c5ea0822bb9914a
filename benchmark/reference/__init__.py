"""The benchmark's plain reference: NumPy, CPU torch for rounding, and
scipy's HiGHS for deciding that a node has no feasible point.

Nothing here imports the program under test, JAX or the JAX package.
``generators/<name>.py`` makes the instances from a seed, each with a
feasibility certificate of its own where it has one; ``kkt`` judges a
returned solution by the optimality conditions, in float64, from the
instance alone; ``feasibility`` decides a node's feasibility.
"""
