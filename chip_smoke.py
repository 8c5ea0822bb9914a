#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit code:

1. Environment: the card's name and power limit, CUDA, nvcc, triton.
2. Build the CUDA kernels from ``ortools_tpu_torch/ops/csrc`` and print
   what ``-Xptxas -v`` says of each (registers, shared memory, spills);
   an SpMM instantiation that spills fails the run.  Beside them, g++
   builds the native small-LP core (``ortools_tpu_torch/_native/smalllp.cc``)
   that the MIP path's simplex node backend loads, the CDCL core
   (``cdcl.cc``) that MaxHS loads, and CP-SAT's lazy-clause-generation
   and pseudo-Boolean cores (``lcg.cc``, ``pbsat.cc``).
3. Each kernel against its plain PyTorch version on the card: A (8x128)
   and its transpose (128x8) at the bench shape, every other block shape
   the kernels take and its transpose at a smaller size, a skewed matrix
   (one block-row of 96 blocks, a quarter of the rest with one block, the
   others empty: both of the kernels' row variants in one launch) and an
   empty matrix; exact in f32 and f64, fast (bf16) in f32; each run twice,
   bit-identical.  The row kernel (``block_spmv_rows``, the 1-D product
   over the row layout of a low-fill matrix) the same way, in f32 and f64,
   on rows of every team width, empty and padded rows, rows longer than a
   team's pass, one-row, one-column and empty matrices.
4. ``pdlp.solve`` on moderate LPs (four seeds) to OPTIMAL, each held
   against HiGHS; the SpMVs against their plain versions on the first
   seed's matrices as the solve builds them (the row kernel, where they
   take the row layout, as under the defaults).
5. The main path at full width: ``pdlp.solve`` on the bench LP
   (block_random_lp 16384 x 16384, 4096 blocks of 8x128, seed 0, f32,
   default parameters) with an iteration limit, with the launch counters
   set to 0 just before and read just after.  Then, through the solver's
   own majors (CUDA graphs replayed from static buffers): PDHG iter/s of
   each stream, host syncs per major, graph capture time, device kernels
   per iteration and the device's busy share of a major, and the time of
   the statistics pass under ADAPTIVE_KKT and ADAPTIVE_HEURISTIC; peak
   device memory; each kernel's time at the bench shape beside its bound,
   its plain version and a PyTorch sparse CSR product (L2-cold), with its
   L2-warm time and, for the exact kernel, a block-sparse (BSR) product
   beside them; the launch floor (each kernel on a one-block matrix); and
   the kernels' times on the other block sizes of the same bytes (f64
   bench A and A^T, f32 32x128 and 128x128 blocks) beside their bounds;
   and the row kernel on the benchmark's matrices (``ROW_CONFIGS``: the
   flow LP of ``mcf.solve`` in f64 and the relaxation of
   ``mcnd.nodes-b64`` in f32, A and Aᵀ as the solve scales them),
   L2-cold and L2-warm, beside the block kernel on the same matrix, its
   plain version, torch's CSR product, its bytes and their bound, and the
   benchmark's roofline share; and both exact kernels on the same
   matrices around the layout rule's boundary (``boundary_times``: 8x128
   blocks at fills of 1/16 to 1/2 in three shapes, f32 and f64, A and
   Aᵀ), each layout's bytes and time.
6. The rest of the single-device solve: a moderate LP to OPTIMAL against
   HiGHS under ADAPTIVE_HEURISTIC restarts, the Malitsky-Pock linesearch,
   feasibility polishing and presolve (one solve each), and the bench LP
   at full width under ADAPTIVE_HEURISTIC with Malitsky-Pock for 8 majors,
   each with the launch counters set to 0 just before and read just after.
7. The batched solve: the SpMM kernel against its plain version (bench A
   and A^T at B = 64, the other block shapes and their transposes at B =
   8, f32 and f64, each twice and bit-identical); ``solve_batch`` on 8
   instances of moderate LP seed 3, each with its own bounds, to OPTIMAL
   against HiGHS in f32 and f64; tests/test_mip.py's infeasible/feasible
   pair; and the batched main path at full width: ``PdhgNodeBackend`` on
   the bench LP at B = 64 (root bounds tiled, 8 majors), with the launch
   counters set to 0 just before its first call and read just after, then
   a second call that must capture nothing and a call with 4x the iteration
   limit that must keep the backend's solver; aggregate LP-iterations/s, host
   syncs per major, capture seconds, peak memory, kernels per iteration and
   the busy share of a batched major, and the SpMM's time at B = 64 beside
   its bound and the bytes it gathers through L2, its plain version and
   cuSPARSE SpMM (f32, L2-cold and L2-warm), and its f64 time.
9. The MIP path (run before phase 8's lines): the device feasibility jump
   at the branch-and-bound root's call shape (64 seeds, 128 steps a round,
   40 rounds, objective descent from a feasible start) on
   edge_packing_300_s15 and set_cover_400x150_s3 (a round under
   ``torch.cuda.set_sync_debug_mode("error")``, the device time of single
   rounds, the round's peak memory, every solution of the whole call
   checked in numpy against the rows, binarity and the cutoff);
   ``mip.solve`` with the PDHG node backend on gap_20x5_s10,
   set_cover_150x60_s1 and the mixed-integer fixed_charge_60_s7, each
   OPTIMAL within 1e-4·(1+|ref|) of HiGHS (``scipy.optimize.milp``), one
   of them with a node-LP batch of several nodes, with its nodes, node-LP
   batches, node LPs/s, BatchSolvers built and capture seconds;
   ``mip.solve`` under ``MipParams``' defaults (the PDHG backend by the
   auto rule, the device FJ) on edge_packing_300_s15 with a 35 s limit
   (60 s until phase 17 needed the room): a
   verified incumbent, a valid bound, the device FJ run, its share of the
   root time, HiGHS under a 10 s limit in a thread beside it; after each
   solve, the SpMVs (the row kernel too, where the matrix has its row
   layout) and the SpMM (at the node batch size, 64) against
   their plain versions on the scaled A and Aᵀ of the first BatchSolver
   it used, in
   f32 and f64; and the kernels' launches on the MIP path, with the
   counters set to 0 just before each solve and read just after.
10. The front end (run before phase 8's lines): the bench LP written as
   MPS (about 169 MB) with ``write_mps``, read back with
   ``Model.import_from_mps_file`` and ``to_qp``, equal to the generated QP
   exactly; ``Solver("pdlp")`` on the imported model at the bench's
   parameters, its iterations and solutions bit for bit those of
   ``pdlp.solve`` on the generated QP, both SpMVs launched; ``python -m
   ortools_tpu_torch solve`` in subprocesses from the checkout, the
   kernels built: moderate LP seed 1 under pdlp (OPTIMAL against HiGHS,
   the .sol file checked against the rows and bounds), a 128 x 256 LP under
   glop (the host simplex ends ABNORMAL on the 2048^2 LPs) and
   gap_20x5_s10 (INTORG markers) under mip, OPTIMAL at milp's objective;
   ``math_opt.solve(PDLP)`` on moderate LP seed 1 against HiGHS;
   ``dp_knapsack_torch`` at 1,000 items and capacity 10^6 against a numpy
   DP, under ``torch.cuda.set_sync_debug_mode("error")``, with a call's
   time, its peak memory, and its kernels per item and their device time
   (``torch.profiler``); ``KnapsackSolver``'s
   multi-dimensional MIP fallback (3 x 40) and ``solve_set_cover_mip`` on
   set_cover_150x60_s1's matrix, OPTIMAL at milp's objective; with the
   launches of its in-process solves, the counters set to 0 just before
   each and read just after.
11. The mesh (run before phase 8's lines): a one-rank NCCL group in this
   process; the bench LP through ``solve(mesh=...)`` on a 1-D mesh and a
   2-D (1, 1) mesh at phase 5's parameters, bit for bit the single path's
   exact stream (for one rank the padding, the block order and the
   collectives are the identity; the fast stream is exact under a mesh),
   with the launch counters set to 0 just before each and read just after;
   the majors' iter/s beside the single exact stream's (in turns), host
   syncs and host-side collective calls per replayed major (the
   collectives are captured in the graphs), and the collectives' device
   time per major from ``torch.profiler``.  Then gloo ranks sharing the
   card (``graft_entry.start_ranks``; the kernels were built in phase 2):
   1-D on 2 ranks and 2-D (2, 2) on 4, moderate LP seed 1 in f32, OPTIMAL
   within 1e-4·(1+|ref|) of HiGHS, every rank's result bit for bit rank
   0's and bit for bit one process's solve whose products sum in the
   mesh's order (``mesh_arithmetic_solve``), each rank's shard SpMVs
   against their plain versions as in phase 3 (the row kernel too, where
   a shard has its row layout), and the iteration count printed beside
   the single exact path's; the 2-D mesh again in f64, bit for bit its
   one-process solve and within a tenth of the single exact path's
   iteration count (``F64_MESH_ITERATIONS``).
12. The host front ends that reach the card through ``mip.solve`` (run
   before phase 8's lines): ``solve_bin_packing`` on Falkenauer's u120
   (120 sizes uniform in [20, 100] from seed 0, capacity 150; LB 49, FFD
   50) under a 10 s limit, its assignment MIP sent to ``PdhgNodeBackend``
   by the auto rule, the SpMV and the SpMM launched and held to their
   plain versions on the first BatchSolver's scaled A and Aᵀ, the device
   FJ's calls (none without a root incumbent: the B&B's gate), the
   packing checked (or ``None`` printed), HiGHS beside it;
   ``solve_boolean_lp`` on edge_packing_300_s15 under a 10 s limit, its
   incumbent checked in numpy and its bound valid against HiGHS's 10 s
   incumbent (the limits were 60 s and 20 s, cut to 40 s to make room for
   phase 16 and to 10 s for phase 17); ``IntegralSolver`` on gap_20x5_s10
   and
   ``solve_vector_bin_packing`` on tests/test_scheduling_packing.py's
   three cases and u60 (LB 24, FFD 25, 1,194 arcs), OPTIMAL at milp's
   objective; ``minimize_max_hs`` on tests/test_max_hs.py's weighted
   max-SAT models (n 10, m 18, seeds 0 and 1) built on the port's IR,
   OPTIMAL at milp's objective, with the device FJ's share of each call;
   the launches of each solve, the counters set to 0 just before it and
   read just after.  Matching is not on the card: its blossom runs on the
   host and its MIP fallback cannot be reached on complete even graphs.
13. CP-SAT (run before phase 8's lines), every solve through
   ``CpSolver(device="cuda")`` with its solution checked by the port's
   ``checker.solution_is_feasible``: ft10 (``tests/data/ft10.jssp``, the
   interval + no_overlap + precedence model, makespan minimized) under the
   defaults with a 120 s limit, OPTIMAL at 930 with the bound at 930 and
   every precedence and machine checked in numpy; ``core_algorithm=
   "max_hs"`` on tests/test_max_hs.py's weighted max-SAT models (seeds 1
   and 7) built with the port's ``CpModel``, OPTIMAL at milp's objective,
   with the node backends that ``choose_backend`` built and the device
   FJ's calls; one small solve on each other route (a planted 3-SAT model
   on the CDCL core, a feasible and an infeasible bin-assignment model on
   the pseudo-Boolean core, a planted integer model on LCG and on the
   integer encoding, an optimization on the DFS engine with the node LP
   propagator at milp's optimum) and 8-queens enumerated (92 solutions);
   the route each solve took, its seconds, conflicts and peak device
   memory, and its launches, the counters set to 0 just before it and read
   just after.
14. CP-SAT's portfolios, model I/O, the graph algorithms and routing (run
   before phase 8's lines), every solve on the card's default device:
   ft10 under ``num_workers=8``, interleaved (20 s) and then forked
   (``interleave_search=False``; 5 s, 20 s until phase 17 needed the
   room), each FEASIBLE or OPTIMAL with
   930 <= makespan and bound <= 930 and the schedule checked; the
   shared-tree portfolio on a 0/1 knapsack (n 20) OPTIMAL at milp's
   optimum; each forked solve under a SIGALRM guard, with the workers
   forked, exited, terminated and left alive counted, none alive after;
   then the SpMV kernels against their plain versions on a 2048^2 matrix
   (the CUDA context survives the forks); phase 13's max-SAT models
   written as WCNF and read back through ``sat_io`` (the IR equal to the
   ``CpModel``'s, solved to milp's optimum), a model through
   ``model_to_json`` / ``model_from_json``, ``python -m
   ortools_tpu_torch.sat.runner`` on a WCNF file in a subprocess (its
   Objective milp's), PHP(7, 6) on the CDCL core with its DRAT proof
   checked by ``drat.check_drat``; ``SimpleMaxFlow`` and
   ``dijkstra_shortest_path`` on 100,000 nodes and 10^6 arcs against
   scipy, ``LinearSumAssignment`` at 1,000 x 1,000 against scipy,
   ``SimpleMinCostFlow`` on a 100 x 100 transportation problem against
   HiGHS, ``christofides_tsp`` on 200 points within 1.5x the 1-tree
   bound; a 101-node CVRP (12 vehicles of 100) and a 101-node VRPTW of
   Solomon R1's shape (written as Solomon text, read by
   ``parse_solomon``), each under GLS for 5 s (10 s until phase 17 needed
   the room) with every visit,
   capacity and time window checked in numpy; a 10-node TSP under
   ``cp_sat_certification_share=0.5`` and ``solve_with_cp_sat`` at the
   brute-force optimum; ``schedule_route_with_breaks`` on
   tests/test_routing.py:318's case.  Each solve prints its seconds, its
   peak device memory and its launches, the counters set to 0 just
   before it and read just after.
15. The last modules (run before phase 8's lines): the bench LP written
   with ``write_lp`` and read back with ``read_lp``, every field equal
   (its empty rows come back as explicit zeros, counted and dropped for
   the comparison), and ``pdlp.solve`` of the QP as read bit for bit the
   generated QP's at phase 5's parameters, with both SpMVs launched and
   held against their plain versions on the read A and A^T; phase 4's
   four moderate LPs stacked block-diagonally, split by ``decompose`` into
   four blocks, each solved on the card to OPTIMAL, their objectives
   summed within 1e-4 of phase 4's HiGHS optima summed and the assembled
   x held to the stack's rows and bounds (the rows without entries that
   ``decompose`` drops, each with 0 in its bounds, counted); ft10 through
   ``solve_jobshop`` on its default LCG route (60 s limit) OPTIMAL at 930,
   ft06 through ``solve_jobshop_cdcl`` and ``engine="cp"`` at 55 and
   tests/test_scheduling_packing.py's RCPSP at 9, each schedule checked;
   phase 14's knapsack written as FlatZinc through ``solve_fzn_text`` and
   ``python -m ortools_tpu_torch.flatzinc --device cuda`` at milp's
   optimum; 8-queens through ``pywrapcp.Solver`` with an all-solutions
   collector (92) and a ``Minimize`` at milp's optimum; the nine
   ``examples_torch/`` scripts, each ``main(device="cuda")``
   (``pdlp_large_lp`` launching the SpMV, ``maxsat_wcnf``'s MaxHS given
   the card).  Each prints its seconds, peak device memory and launches,
   the counters set to 0 just before it and read just after.
16. The bench port (run before phase 8's lines), each script in a
   subprocess from the checkout with the kernels of phase 2: ``python -m
   ortools_tpu_torch bench`` (``bench_torch.py``), ``bench_large_torch.py``
   and ``bench_miplib_torch.py 0.25 1``: the whole battery (20 MIPs) at
   scale 0.25 with a 1 s limit an instance and HiGHS under the same limit
   (cuts: bench_miplib's defaults are scale 1.0 and 120 s; MIPLIB_SCALE
   and MIPLIB_LIMIT, 1.0 and 3 s until phase 17 needed the room).  Each
   must exit 0 with
   a JSON last line: the bench's every key of bench.py's ``_emit`` and the
   port's additions, its rates finite and positive, both benches naming
   the card; 20 instance records, each with its feasibility check run
   (no matched fraction is required at 3 s).  Prints each script's
   seconds and ``#`` lines, and the bench's exact and fast rates beside
   phase 5's for the same stream (the bench leaves out the statistics and
   the host's read) with their ratio; the scripts' launches, summed from
   their ``# launches`` lines, must each be above 0.
17. The JAX package's last scripts (run before phase 8's lines), each in
   a subprocess from the checkout with the kernels of phase 2, each exiting
   0 with its JSON last line, every key present and every number finite:
   ``scripts/bench_roofline_torch.py`` (y <- x(1 + 1e-9 i) + y over two
   256 MiB f32 arrays, 1-256 steps a CUDA graph; the fitted in-graph rate
   above 0 and at most 1.05 x 3,350 GB/s, printed beside phase 16's
   ``device_stream_gbps``); ``bench_lp_suite_batch_torch.py`` (12 LPs
   stacked block-diagonally, f32: PRIMAL_INFEASIBLE, as in the JAX
   package, its blocks 10 and 11 being infeasible; each block checked
   against HiGHS; the SpMVs against their plain versions on the stacked A
   and Aᵀ); ``bench_onchip_search_torch.py --host-limit 5`` (the root and
   128 warm-started node LPs of a 4,640 x 25,600 multicommodity LP at B =
   64, all OPTIMAL; the SpMM against its plain version on that A and Aᵀ at
   B = 64; the device FJ's cover on set_cover_250x100_s2 at or below
   0.99 x the greedy cover's cost, checked in numpy; the host baselines
   cut from 120 s to 5 s each, ``ONCHIP_HOST_LIMIT``);
   ``bench_multichip_large_torch.py --mesh 2x2`` (the 1,036,800-nonzero
   multicommodity LP in f64 at 1e-7: the 2x4 cell census equal to the JAX
   package's, the single solve and the mesh solve on 4 gloo ranks sharing
   the card (a cut: the script's default mesh is 2x4 on 8 ranks,
   ``MULTICHIP_MESH``) both OPTIMAL within 1e-6 relative, the single
   solve's peak
   device memory; the SpMVs against their plain versions on that A and
   Aᵀ).  Each script's launches, from its ``# launches`` line, must be
   above 0 for the kernels it runs.  The host scripts
   (``bench_inprocessing_torch.py``, ``bench_opb_torch.py``,
   ``bench_routing_torch.py``, ``bench_scheduling_torch.py``) reach no
   kernel (no model of theirs takes MaxHS, CP-SAT's one route to the
   card): the CPU tests hold them (``tests/test_torch_scripts.py``).
8. The ``kernels`` line (JSON, with each kernel's launches on the MIP
   path, on the front end, on the mesh path, on the host front ends, on
   CP-SAT, on phase 14, on phase 15, on phase 16 (``phase16_launches``,
   the bench scripts' own) and on phase 17 (``phase17_launches``, the
   scripts' own), the SpMVs' errors after the forks,
   and the fast SpMV's bf16 CSR yardstick), the total time,
   the card's name and power limit, and last ``{"ok": true, "device":
   {...}}``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import itertools
import json
import math
import multiprocessing
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch
from scipy.optimize import (Bounds, LinearConstraint, linear_sum_assignment,
                            linprog, milp)
from scipy.sparse.csgraph import dijkstra as scipy_dijkstra, maximum_flow

import ortools_tpu_torch
import ortools_tpu_torch.pdlp as pdlp_pkg
from ortools_tpu_torch import math_opt, mip
from ortools_tpu_torch._native import build as native_build
from ortools_tpu_torch.algorithms import KnapsackSolver, SetCoverModel
from ortools_tpu_torch.algorithms.knapsack import (dp_knapsack_table,
                                                   dp_knapsack_torch)
from ortools_tpu_torch.algorithms.set_cover import solve_set_cover_mip
from ortools_tpu_torch.bop import IntegralSolver
from ortools_tpu_torch.bop.portfolio import solve_boolean_lp
from ortools_tpu_torch.constraint_solver import pywrapcp
from ortools_tpu_torch.flatzinc import solve_fzn_text
from ortools_tpu_torch.graph import (LinearSumAssignment, SimpleMaxFlow,
                                     SimpleMinCostFlow, dijkstra_shortest_path)
from ortools_tpu_torch.graph.tsp_paths import (christofides_tsp,
                                               one_tree_lower_bound)
from ortools_tpu_torch.linear_solver import LinearExpr, Model, Solver
from ortools_tpu_torch.mip import MipParams
from ortools_tpu_torch.mip import branch_and_bound as bnb
from ortools_tpu_torch.mip.node_lp import PdhgNodeBackend
from ortools_tpu_torch.models.generators import (block_random_lp,
                                                 multicommodity_flow_lp)
from ortools_tpu_torch.models.mip_generators import miplib_like_battery
from ortools_tpu_torch.models.lp import QuadraticProgram
from ortools_tpu_torch.models.lp_decomposer import decompose
from ortools_tpu_torch.models.lp_format import read_lp, write_lp
from ortools_tpu_torch.models.mps import write_mps
from ortools_tpu_torch.ops import _build, tiled_spmv
from ortools_tpu_torch.ops.block_sparse import BlockSparseMatrix
from ortools_tpu_torch.packing import (BinPackingInstance,
                                       first_fit_decreasing,
                                       solve_bin_packing)
from ortools_tpu_torch.packing.arc_flow import (build_arc_flow_graph,
                                                solve_vector_bin_packing)
from ortools_tpu_torch.pdlp import PdhgParams, solve
from ortools_tpu_torch.pdlp import batched
from ortools_tpu_torch.pdlp import solver as pdlp_solver
from ortools_tpu_torch.pdlp.batched import solve_batch
from ortools_tpu_torch.pdlp.params import RestartStrategy
from ortools_tpu_torch.routing import (LocalSearchMetaheuristic,
                                       RoutingIndexManager, RoutingModel,
                                       default_routing_search_parameters,
                                       sat_path)
from ortools_tpu_torch.routing.breaks import (BreakInterval,
                                              schedule_route_with_breaks)
from ortools_tpu_torch.routing.parsers import parse_solomon
from ortools_tpu_torch.sat import (CpModel, CpSolver,
                                   CpSolverSolutionCallback, fj_device)
from ortools_tpu_torch.sat import cdcl as cp_cdcl
from ortools_tpu_torch.sat import core_guided as cp_core_guided
from ortools_tpu_torch.sat import drat as cp_drat
from ortools_tpu_torch.sat import engine as cp_engine
from ortools_tpu_torch.sat import integer_encoding as cp_encoding
from ortools_tpu_torch.sat import lcg as cp_lcg
from ortools_tpu_torch.sat import lp_propagator as cp_lp
from ortools_tpu_torch.sat import max_hs as cp_max_hs
from ortools_tpu_torch.sat import model_ir as ir
from ortools_tpu_torch.sat import parallel_portfolio as cp_parallel
from ortools_tpu_torch.sat import pb_bridge as cp_pb_bridge
from ortools_tpu_torch.sat import pure_sat as cp_pure_sat
from ortools_tpu_torch.sat import sat_io as cp_sat_io
from ortools_tpu_torch.sat import serialization as cp_serialization
from ortools_tpu_torch.sat.checker import solution_is_feasible
from ortools_tpu_torch.sat.max_hs import minimize_max_hs
from ortools_tpu_torch.sat.solver import solve_model
from ortools_tpu_torch.scheduling import (parse_jobshop, solve_jobshop,
                                          solve_jobshop_cdcl)
from ortools_tpu_torch.scheduling.rcpsp import parse_rcpsp, solve_rcpsp
from ortools_tpu_torch.utils.status import TerminationReason

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate and the f32 and f64 rates outside
# the tensor cores (the kernels multiply on the CUDA cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12  # f64 outside the tensor cores (the SpMM's f64 FMAs)
L2_BYTES = 50 * 2**20

BENCH = dict(m=16384, n=16384, num_blocks=4096, block_shape=(8, 128), seed=0)
# The bench's solver parameters (bench.py:106): f32, blocks of 8x128.
BENCH_PARAMS = dict(dtype=torch.float32, block_shape=(8, 128))
MODERATE = dict(m=2048, n=2048, num_blocks=512, block_shape=(8, 128))
MODERATE_SEEDS = (0, 1, 2, 3)
BENCH_ITERATION_LIMIT = 64 * 8
TIMED_MAJORS = 12

KERNELS = {
    "block_spmv_exact": dict(
        route="cuda", source="ortools_tpu_torch/ops/csrc/block_spmv.cu",
        replaces="ortools_tpu/ops/tiled_spmv.py:262",
        wrapper=tiled_spmv.tiled_matvec, plain=tiled_spmv.tiled_matvec_plain),
    "block_spmv_fast": dict(
        route="cuda", source="ortools_tpu_torch/ops/csrc/block_spmv.cu",
        replaces="ortools_tpu/ops/tiled_spmv.py:332",
        wrapper=tiled_spmv.tiled_matvec_fast,
        plain=tiled_spmv.tiled_matvec_fast_plain),
}
# The batched path's product: device code that the JAX package leaves to
# XLA (block_sparse.py::_block_matmat), a hand kernel in the port.
SPMM = dict(
    name="block_spmm_exact", route="cuda",
    source="ortools_tpu_torch/ops/csrc/block_spmm.cu",
    replaces="ortools_tpu/ops/block_sparse.py:285",
    wrapper=tiled_spmv.tiled_matmat, plain=tiled_spmv.tiled_matmat_plain)
# The 1-D product over the row layout of a low-fill matrix: no TPU kernel
# and no XLA code of the JAX package matches it (the TPU stores blocks).
ROWS = dict(
    name="block_spmv_rows", route="cuda",
    source="ortools_tpu_torch/ops/csrc/block_spmv.cu",
    replaces="none: the row layout's 1-D product, for low-fill matrices",
    wrapper=tiled_spmv.rows_matvec, plain=tiled_spmv.rows_matvec_plain)
# The batched product over the same row layout: no TPU kernel and no XLA
# code matches it either.
ROWS_SPMM = dict(
    name="block_spmm_rows", route="cuda",
    source="ortools_tpu_torch/ops/csrc/block_spmm.cu",
    replaces="none: the row layout's batched product, for low-fill matrices",
    wrapper=tiled_spmv.rows_matmat, plain=tiled_spmv.rows_matmat_plain)
# The benchmark's configurations whose matrices take the row layout
# (benchmark/configs; their instance 0, made by the benchmark's generator).
ROW_CONFIGS = (("mcf.solve", "mcnd-c-30-700-400-open-f64", torch.float64),
               ("mcnd.nodes-b64", "mcnd-c-30-520-100-relax-f32",
                torch.float32))
# The layout rule's boundary (tiled_spmv.prefer_rows): matrices of 8x128
# blocks whose entries are nonzero with probability BOUNDARY_FILLS, around
# where the row layout reads half the blocks' bytes (a fill of 1/3 in f64,
# 1/4 in f32), 8,192 blocks each: one block a block-row on 128 block
# columns (A's rows of 128·fill nonzeros, as the flow LP's), four, and 64
# on 8,192 block columns (Aᵀ's rows of 8·fill, as the flow LP's Aᵀ).
BOUNDARY_FILLS = (1 / 16, 1 / 8, 1 / 4, 1 / 3, 1 / 2)
# block rows, blocks in each, block columns
BOUNDARY_SHAPES = ((8192, 1, 128), (2048, 4, 128), (128, 64, 8192))
# The batched rule's boundary (tiled_spmv.prefer_rows_batched): the same
# matrices at these batches.
BOUNDARY_BATCHES = (8, 64)
BATCH = 64  # bench.py's batched configuration (bench.py:255-293)
BATCH_MAJORS = 8
MODERATE_BATCH = 8


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


_T_START = time.perf_counter()


def phase(title: str) -> None:
    print(f"\n== {title} (at {time.perf_counter() - _T_START:.1f} s)",
          flush=True)


def reset_counters() -> None:
    for k in list(KERNELS.values()) + [SPMM, ROWS, ROWS_SPMM]:
        k["wrapper"].launches = 0


def _launches() -> dict:
    """Each kernel's launch count since ``reset_counters``."""
    out = {k: v["wrapper"].launches for k, v in KERNELS.items()}
    out[SPMM["name"]] = SPMM["wrapper"].launches
    out[ROWS["name"]] = ROWS["wrapper"].launches
    out[ROWS_SPMM["name"]] = ROWS_SPMM["wrapper"].launches
    return out


def batched_products(launches: dict) -> int:
    """The batched products among ``launches``: the block SpMM's and the
    batched row kernel's (a low-fill matrix takes the second)."""
    return (launches.get(SPMM["name"], 0)
            + launches.get(ROWS_SPMM["name"], 0))


def exact_spmvs(launches: dict) -> int:
    """The exact 1-D products among ``launches``: the block kernel's and
    the row kernel's (a low-fill matrix takes the second)."""
    return (launches.get("block_spmv_exact", 0)
            + launches.get(ROWS["name"], 0))


# ---------------------------------------------------------------------------
# 1. Environment
# ---------------------------------------------------------------------------


def environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print("nvidia-smi:", smi)
    print("device:", torch.cuda.get_device_name(0),
          "count:", torch.cuda.device_count())
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(nvcc.stdout.strip().splitlines()[-1])
    try:
        import triton  # noqa: F401
        print("triton imports:", triton.__version__)
    except ImportError as e:
        print("triton does not import:", e)
    print("float32 matmul precision:", torch.get_float32_matmul_precision(),
          "tf32 matmul:", torch.backends.cuda.matmul.allow_tf32,
          "tf32 cudnn:", torch.backends.cudnn.allow_tf32)
    require(torch.get_float32_matmul_precision() == "highest"
            and not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32, "TF32 must be off")
    return smi.splitlines()[0]


# The native cores: the simplex node backend's, MaxHS's CDCL solver,
# CP-SAT's lazy-clause-generation and pseudo-Boolean cores, and the graph
# algorithms' (max flow, min cost flow, assignment, Dijkstra)
NATIVE = ("smalllp", "cdcl", "lcg", "pbsat", "graph")


def build_native() -> threading.Thread:
    """Build ``ortools_tpu_torch/_native/{smalllp,cdcl,lcg,pbsat,graph}.cc`` with
    g++ from the sources, on a thread beside the kernels' nvcc: any library
    left from an earlier build is removed first.  The thread's ``error`` is
    the build's exception, or None."""
    shutil.rmtree(native_build.OUT_DIR, ignore_errors=True)

    def run():
        try:
            for name in NATIVE:
                native_build.load_library(name)
        except Exception as e:  # reported by the caller through require
            th.error = e

    th = threading.Thread(target=run)
    th.error = None
    th.start()
    return th


# ---------------------------------------------------------------------------
# 3. Kernels against their plain versions
# ---------------------------------------------------------------------------


def _x_for(mat: BlockSparseMatrix, dtype: torch.dtype, seed: int):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(mat.padded_shape[1], generator=g, dtype=torch.float64)
    return x.to(dtype=dtype, device="cuda")


def _rel_err(y, ref) -> tuple:
    err = float((y.double() - ref.double()).abs().max()) if y.numel() else 0.0
    scale = 1.0 + (float(ref.double().abs().max()) if ref.numel() else 0.0)
    return err, scale


def check_matrix(label: str, mat: BlockSparseMatrix, errs: dict) -> None:
    """Exact (f32, f64) and fast kernels against their plain versions on
    ``mat`` (a matrix without layout); records the largest errors."""
    m32 = dataclasses.replace(mat, data=mat.data.float(),
                              tiled=None).with_tiled(hi=True)
    m64 = dataclasses.replace(mat, data=mat.data.double(),
                              tiled=None).with_tiled()
    x32 = _x_for(mat, torch.float32, 1)
    x64 = _x_for(mat, torch.float64, 1)
    exact = tiled_spmv.tiled_matvec
    fast = tiled_spmv.tiled_matvec_fast

    y, y2 = exact(m32.tiled, x32), exact(m32.tiled, x32)
    ref = tiled_spmv.tiled_matvec_plain(m32.tiled, x32)
    d, d2 = exact(m64.tiled, x64), exact(m64.tiled, x64)
    ref64 = tiled_spmv.tiled_matvec_plain(m64.tiled, x64)
    f, f2 = fast(m32.tiled, x32), fast(m32.tiled, x32)
    fref = tiled_spmv.tiled_matvec_fast_plain(m32.tiled, x32)
    torch.cuda.synchronize()

    e32, s32 = _rel_err(y, ref)
    e64, s64 = _rel_err(d, ref64)
    ef, sf = _rel_err(f, fref)
    efx, sfx = _rel_err(f, ref)
    print(f"{label:34s} long rows f32 {m32.tiled.num_long}/"
          f"{m32.tiled.num_block_rows}, f64 {m64.tiled.num_long}:"
          f" exact f32 {e32:.3e} (<= {1e-5 * s32:.3e})"
          f"  exact f64 {e64:.3e} (<= {1e-12 * s64:.3e})"
          f"  fast {ef:.3e} (<= {1e-5 * sf:.3e})"
          f"  fast-exact {efx:.3e} (<= {3e-2 * sfx:.3e})")
    require(e32 <= 1e-5 * s32, f"{label}: exact f32 kernel disagrees")
    require(e64 <= 1e-12 * s64, f"{label}: exact f64 kernel disagrees")
    require(ef <= 1e-5 * sf, f"{label}: fast kernel disagrees with plain")
    require(efx <= 3e-2 * sfx, f"{label}: fast kernel too far from exact")
    require(torch.equal(y, y2) and torch.equal(d, d2) and torch.equal(f, f2),
            f"{label}: a repeated launch is not bit-identical")
    nonzero = bool(ref.abs().max() > 0) if ref.numel() else False
    if nonzero:
        require(not torch.equal(f, y), f"{label}: fast equals exact")
    else:
        require(float(y.abs().max()) == 0.0 and float(f.abs().max()) == 0.0,
                f"{label}: an empty matrix gives nonzero y")
    errs["block_spmv_exact"] = max(errs.get("block_spmv_exact", 0.0), e32)
    errs["block_spmv_fast"] = max(errs.get("block_spmv_fast", 0.0), ef)


# Every block shape besides the bench's, with the transposes: all nine
# that the kernels take.  Blocks per 2048^2 matrix.
SMALL_SHAPES = (((8, 8), 4096), ((8, 32), 1024), ((32, 8), 1024),
                ((32, 32), 512), ((32, 128), 128), ((128, 128), 64))


def skewed_matrix(seed: int = 3) -> BlockSparseMatrix:
    """2048 x 16384 at 8x128: block-row 0 holds 96 blocks (a long row),
    every fourth of the others one block (short rows), the rest none."""
    rng = np.random.default_rng(seed)
    bm, bn, gm, gn = 8, 128, 256, 128
    brows = np.concatenate([np.zeros(96, np.int64), np.arange(1, gm, 4)])
    bcols = np.concatenate([rng.choice(gn, 96, replace=False),
                            rng.integers(0, gn, brows.size - 96)])
    rows = (brows[:, None, None] * bm + np.arange(bm)[None, :, None]
            + np.zeros(bn, np.int64)[None, None, :]).ravel()
    cols = (bcols[:, None, None] * bn + np.zeros(bm, np.int64)[None, :, None]
            + np.arange(bn)[None, None, :]).ravel()
    a = sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(gm * bm, gn * bn))
    return BlockSparseMatrix.from_scipy(a, block_shape=(bm, bn),
                                        dtype=torch.float64, device="cuda")


def kernels_against_plain(bench_prob) -> dict:
    errs: dict = {}
    for name, mat in (("A", bench_prob.a), ("A^T", bench_prob.at)):
        bm, bn = mat.block_shape
        check_matrix(f"bench {name} ({bm}x{bn})", mat.without_tiled(), errs)
    for block_shape, nb in SMALL_SHAPES:
        qp = block_random_lp(2048, 2048, nb, block_shape, seed=1)
        mat = BlockSparseMatrix.from_scipy(
            qp.constraint_matrix, block_shape=block_shape,
            dtype=torch.float64, device="cuda")
        bm, bn = block_shape
        check_matrix(f"2048^2 A ({bm}x{bn})", mat, errs)
        check_matrix(f"2048^2 A^T ({bn}x{bm})", mat.block_transpose(), errs)
    skewed = skewed_matrix()
    lay = dataclasses.replace(skewed, data=skewed.data.float()).with_tiled()
    require(lay.tiled.num_long == 1,
            "skewed: the f32 schedule should hold one long row")
    check_matrix("skewed 2048x16384 (8x128)", skewed, errs)
    check_matrix("skewed^T (128x8)", skewed.block_transpose(), errs)
    empty = BlockSparseMatrix.from_scipy(sp.csr_matrix((50, 60)),
                                         device="cuda")
    check_matrix("empty 50x60 (8x128)", empty, errs)
    check_matrix("empty^T (128x8)", empty.block_transpose(), errs)
    errs.update(rows_against_plain())
    return errs


def check_rows(label: str, csr, shape, errs: dict) -> None:
    """The row kernel against its plain version on the row layout of
    ``csr`` padded to ``shape``, in f32 and f64, each run twice and
    bit-identical; records the largest error."""
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        lay = tiled_spmv.make_row_layout(csr, shape[0], shape[1], dtype,
                                         "cuda")
        g = torch.Generator(device="cpu").manual_seed(4)
        x = torch.randn(shape[1], generator=g, dtype=torch.float64).to(
            dtype=dtype, device=lay.values.device)
        y, y2 = ROWS["wrapper"](lay, x), ROWS["wrapper"](lay, x)
        ref = ROWS["plain"](lay, x)
        torch.cuda.synchronize()
        err, scale = _rel_err(y, ref)
        print(f"{label:34s} rows {lay.bin_rows} {str(dtype)[6:]}: "
              f"{err:.3e} (<= {tol * scale:.3e})", flush=True)
        require(err <= tol * scale, f"{label}: the row kernel disagrees "
                f"with its plain version in {dtype}")
        require(torch.equal(y, y2), f"{label}: a repeated launch of the "
                f"row kernel is not bit-identical")
        errs[ROWS["name"]] = max(errs.get(ROWS["name"], 0.0), err)


def check_rows_spmm(label: str, csr, shape, batches, errs: dict) -> None:
    """The batched row kernel against its plain version on the row layout
    of ``csr`` padded to ``shape``, at each of ``batches`` instances, in
    f32 and f64, each run twice and bit-identical; records the largest
    error."""
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        lay = tiled_spmv.make_row_layout(csr, shape[0], shape[1], dtype,
                                         "cuda")
        out = []
        for batch in batches:
            g = torch.Generator(device="cpu").manual_seed(5)
            x = torch.randn(batch, shape[1], generator=g,
                            dtype=torch.float64).to(dtype=dtype,
                                                    device="cuda")
            y = ROWS_SPMM["wrapper"](lay, x)
            y2 = ROWS_SPMM["wrapper"](lay, x)
            ref = ROWS_SPMM["plain"](lay, x)
            torch.cuda.synchronize()
            err, scale = _rel_err(y, ref)
            out.append(f"B={batch} {err:.3e} (<= {tol * scale:.3e})")
            require(err <= tol * scale, f"{label}: the batched row kernel "
                    f"disagrees with its plain version in {dtype} at B = "
                    f"{batch}")
            require(torch.equal(y, y2), f"{label}: a repeated launch of the "
                    f"batched row kernel is not bit-identical")
            errs[ROWS_SPMM["name"]] = max(errs.get(ROWS_SPMM["name"], 0.0),
                                          err)
        print(f"{label:34s} batched rows {str(dtype)[6:]}: "
              + ", ".join(out), flush=True)


def check_built(label: str, mat: BlockSparseMatrix, errs: dict,
                batch: int = 8) -> None:
    """The products of a built problem's matrix against their plain
    versions: the block kernels on its blocks, and the row kernels (1-D
    and, at ``batch`` instances, batched) on its nonzeros where set-up
    gave it the row layout."""
    check_matrix(label, mat.without_tiled(), errs)
    if mat.rows is not None:
        check_rows(label, mat.to_csr(), mat.padded_shape, errs)
        check_rows_spmm(label, mat.to_csr(), mat.padded_shape, (batch,),
                        errs)


def _fold(into: dict, errs: dict) -> None:
    for name, e in errs.items():
        into[name] = max(into.get(name, 0.0), e)


def rows_against_plain() -> dict:
    """The row kernel on matrices of every team width and on the edges:
    rows empty, padded, longer than a team's pass, and one-row, one-column
    and empty matrices."""
    errs: dict = {}
    rng = np.random.default_rng(5)
    lengths = np.concatenate([[900, 129, 128], rng.integers(0, 70, 297),
                              np.zeros(100, np.int64)])
    rows = np.repeat(np.arange(lengths.size), lengths)
    cols = np.concatenate([rng.choice(1000, k, replace=False)
                           for k in lengths])
    skewed = sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                           shape=(lengths.size, 1000))
    for label, a in (("rows 400x1000 (900..0 nonzeros)", skewed),
                     ("rows^T 1000x400", skewed.T.tocsr()),
                     ("rows one row 1x1000", sp.random(
                         1, 1000, density=0.9, random_state=1, format="csr")),
                     ("rows one column 1000x1", sp.random(
                         1000, 1, density=0.9, random_state=2,
                         format="csr")),
                     ("rows empty 50x60", sp.csr_matrix((50, 60)))):
        shape = tuple(-(-max(d, 1) // 128) * 128 for d in a.shape)
        check_rows(label, a, shape, errs)
        check_rows_spmm(label, a, shape, (1, 3, BATCH), errs)
    return errs


def benchmark_qp(config: str):
    """Instance 0 of a configuration of the benchmark (``benchmark/``),
    made by its generator, as the program's QuadraticProgram."""
    bench_dir = ROOT / "benchmark"
    if str(bench_dir) not in sys.path:
        sys.path.insert(0, str(bench_dir))
    from lpbench import instances

    cfg = json.loads((bench_dir / "configs" / f"{config}.json").read_text())
    return instances.to_program(instances.make_instance(bench_dir, cfg, 0))


def _row_cold_copies(lay) -> list:
    """Copies of the row layout, enough that their bytes cycled over
    exceed L2 twice."""
    nbytes = sum(t.nbytes for t in (lay.values, lay.cols, lay.row_ptr,
                                    lay.order))
    return [lay._replace(values=lay.values.clone(), cols=lay.cols.clone(),
                         row_ptr=lay.row_ptr.clone(), order=lay.order.clone())
            for _ in range(1 + (2 * L2_BYTES) // max(1, nbytes))]


def row_times() -> dict:
    """The row kernel on the benchmark's matrices (A and Aᵀ of
    ``ROW_CONFIGS``, scaled as the solve scales them), L2-cold: its time
    against its plain version (held to it first), the block kernel on the
    same matrix, torch's CSR product (cuSPARSE, the library yardstick; the
    port never calls it), its bytes a launch and their bound, and the
    share of the benchmark's roofline (work nnz·s + (m + n)·s)."""
    out = {}
    for cell, config, dtype in ROW_CONFIGS:
        qp = benchmark_qp(config)
        prob = pdlp_solver.build_device_problem(
            qp, PdhgParams(dtype=dtype), "cuda")
        s = torch.tensor([], dtype=dtype).element_size()
        work = (qp.constraint_matrix.nnz * s
                + (qp.num_constraints + qp.num_variables) * s)
        for orient, mat in (("A", prob.a), ("A^T", prob.at)):
            label = f"{cell} {orient}"
            lay = mat.rows
            require(lay is not None, f"{label}: no row layout attached")
            x = _x_for(mat, dtype, 6)
            y = ROWS["wrapper"](lay, x)
            ref = ROWS["plain"](lay, x)
            blk = tiled_spmv.tiled_matvec(mat.tiled, x)
            torch.cuda.synchronize()
            tol = 1e-12 if dtype == torch.float64 else 1e-5
            err, scale = _rel_err(y, ref)
            berr, _ = _rel_err(y, blk)
            require(err <= tol * scale and berr <= tol * scale,
                    f"{label}: the row kernel disagrees ({err:.3e} from its "
                    f"plain version, {berr:.3e} from the block kernel)")
            lays = _row_cold_copies(lay)
            args = [(t, x) for t in lays]
            ms = time_launches(ROWS["wrapper"], args, 400)
            warm_ms = time_launches(ROWS["wrapper"], args[:1], 400)
            plain_ms = time_launches(ROWS["plain"], args[:2], 20)
            blocks = _cold_copies(mat.tiled)
            block_ms = time_launches(tiled_spmv.tiled_matvec,
                                     [(t, x) for t in blocks], 100)
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", message="Sparse")
                csrs = [torch.sparse_csr_tensor(t.row_ptr, t.cols, t.values,
                                                size=mat.padded_shape)
                        for t in lays]
                library_ms = time_launches(lambda a, v: a @ v,
                                           [(c, x) for c in csrs], 200)
            m, n = mat.padded_shape
            nbytes = (lay.nnz * (s + 4) + (m + 1) * 4 + m * 4 + (m + n) * s)
            bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            share = work / PEAK_BYTES_PER_S * 1e3 / ms
            print(f"{label:20s} {lay.nnz} nonzeros, bins {lay.bin_rows}: "
                  f"row kernel {ms:.4f} ms (L2-warm {warm_ms:.4f}), bound "
                  f"{bound_ms:.4f} ms ({nbytes} bytes; {bound_ms / ms:.1%});"
                  f" roofline share {share:.1%}; block kernel {block_ms:.4f}"
                  f" ms ({mat.num_blocks} blocks of {mat.block_shape}); "
                  f"plain {plain_ms:.4f} ms; torch CSR {library_ms:.4f} ms; "
                  f"error {err:.3e}", flush=True)
            out[label] = dict(ms=ms, warm_ms=warm_ms, bound_ms=bound_ms,
                              bytes=nbytes, roofline_share=share,
                              block_ms=block_ms, plain_ms=plain_ms,
                              library_ms=library_ms, max_abs_err=err)
            del lays, blocks, csrs
        del prob
        torch.cuda.empty_cache()
    return out


def rows_spmm_times() -> dict:
    """The batched row kernel at B = ``BATCH`` on the node LPs' matrices
    (A and Aᵀ of the f32 configuration of ``ROW_CONFIGS``, scaled as the
    solve scales them), L2-cold: its time against its plain version (held
    to it first), the block SpMM on the same matrix, torch's CSR product
    with a dense [N, B] matrix (cuSPARSE SpMM, the library yardstick; the
    port never calls it), and the benchmark's bound and roofline share
    (work nnz·s + B·(m + n)·s)."""
    out = {}
    for cell, config, dtype in ROW_CONFIGS:
        if dtype != torch.float32:
            continue
        qp = benchmark_qp(config)
        prob = pdlp_solver.build_device_problem(
            qp, PdhgParams(dtype=dtype), "cuda")
        s = torch.tensor([], dtype=dtype).element_size()
        work = (qp.constraint_matrix.nnz * s
                + BATCH * (qp.num_constraints + qp.num_variables) * s)
        bound_ms = work / PEAK_BYTES_PER_S * 1e3
        for orient, mat in (("A", prob.a), ("A^T", prob.at)):
            label = f"{cell} {orient} B={BATCH}"
            lay = mat.rows
            require(lay is not None, f"{label}: no row layout attached")
            require(tiled_spmv.prefer_rows_batched(
                lay.nnz, lay.num_rows, mat.num_blocks, mat.block_shape, s,
                BATCH), f"{label}: the rule keeps the blocks")
            x = _batch_x(mat, BATCH, dtype, 6)
            y = ROWS_SPMM["wrapper"](lay, x)
            ref = ROWS_SPMM["plain"](lay, x)
            blk = tiled_spmv.tiled_matmat(mat.tiled, x)
            torch.cuda.synchronize()
            err, scale = _rel_err(y, ref)
            berr, _ = _rel_err(y, blk)
            require(err <= 1e-5 * scale and berr <= 1e-5 * scale,
                    f"{label}: the batched row kernel disagrees ({err:.3e} "
                    f"from its plain version, {berr:.3e} from the block "
                    f"SpMM)")
            lays = _row_cold_copies(lay)
            args = [(t, x) for t in lays]
            ms = time_launches(ROWS_SPMM["wrapper"], args, 200)
            warm_ms = time_launches(ROWS_SPMM["wrapper"], args[:1], 200)
            plain_ms = time_launches(ROWS_SPMM["plain"], args[:2], 10)
            blocks = _cold_copies(mat.tiled)
            block_ms = time_launches(tiled_spmv.tiled_matmat,
                                     [(t, x) for t in blocks], 50)
            xt = x.t().contiguous()
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", message="Sparse")
                csrs = [torch.sparse_csr_tensor(
                    t.row_ptr, t.cols, t.values, size=mat.padded_shape)
                    for t in lays]
                library_ms = time_launches(lambda a, v: a @ v,
                                           [(c, xt) for c in csrs], 50)
            share = bound_ms / ms
            print(f"{label:26s} {lay.nnz} nonzeros: batched row kernel "
                  f"{ms:.4f} ms (L2-warm {warm_ms:.4f}), bound "
                  f"{bound_ms:.4f} ms ({work} bytes), roofline share "
                  f"{share:.1%}; block SpMM {block_ms:.4f} ms "
                  f"({mat.num_blocks} blocks of {mat.block_shape}); plain "
                  f"{plain_ms:.4f} ms; torch CSR SpMM {library_ms:.4f} ms; "
                  f"error {err:.3e}", flush=True)
            out[label] = dict(ms=ms, warm_ms=warm_ms, bound_ms=bound_ms,
                              bytes=work, roofline_share=share,
                              block_ms=block_ms, plain_ms=plain_ms,
                              library_ms=library_ms, max_abs_err=err)
            del lays, blocks, csrs
        del prob
        torch.cuda.empty_cache()
    return out


def boundary_matrix(block_rows: int, per_row: int, gn: int, fill: float,
                    seed: int) -> sp.csr_matrix:
    """``block_rows`` x ``gn`` blocks of 8x128, ``per_row`` of them stored
    in each block-row at random columns, each of their entries nonzero
    with probability ``fill``."""
    rng = np.random.default_rng(seed)
    bm, bn = 8, 128
    brows = np.repeat(np.arange(block_rows), per_row)
    bcols = np.argsort(rng.random((block_rows, gn)), axis=1)[:, :per_row]
    b, i, j = np.nonzero(rng.random((brows.size, bm, bn)) < fill)
    return sp.csr_matrix(
        (rng.standard_normal(b.size),
         (brows[b] * bm + i, bcols.ravel()[b] * bn + j)),
        shape=(block_rows * bm, gn * bn))


def boundary_times() -> dict:
    """Both exact kernels on the same matrices around the layout rule's
    boundary (``BOUNDARY_SHAPES`` x ``BOUNDARY_FILLS``, A and Aᵀ, f32 and
    f64), L2-cold, the row kernel held to its plain version and to the
    block kernel first: each layout's bytes a product (the rule's count:
    values and column indices of the nonzeros and the row pointers, against
    every stored entry), their ratio, the kernels' times and theirs, and
    whether the rule gives rows; in f32 the block kernel's bf16 stream
    too, which the block route adds where it keeps the blocks."""
    out = {}
    for block_rows, per_row, gn in BOUNDARY_SHAPES:
        for fill in BOUNDARY_FILLS:
            a = boundary_matrix(block_rows, per_row, gn, fill, seed=7)
            for dtype in (torch.float32, torch.float64):
                s = torch.tensor([], dtype=dtype).element_size()
                for orient, csr, shape in (("A", a, (8, 128)),
                                           ("A^T", a.T.tocsr(), (128, 8))):
                    label = (f"{block_rows}x{per_row}/{gn} fill {fill:.3f}"
                             f" {str(dtype)[6:]} {orient}")
                    mat = BlockSparseMatrix.from_scipy(
                        csr, block_shape=shape, dtype=dtype,
                        device="cuda").with_tiled(hi=dtype == torch.float32)
                    lay = tiled_spmv.make_row_layout(
                        csr, *mat.padded_shape, dtype, "cuda")
                    x = _x_for(mat, dtype, 8)
                    y = ROWS["wrapper"](lay, x)
                    ref = ROWS["plain"](lay, x)
                    blk = tiled_spmv.tiled_matvec(mat.tiled, x)
                    torch.cuda.synchronize()
                    tol = 1e-12 if dtype == torch.float64 else 1e-5
                    err, scale = _rel_err(y, ref)
                    berr, _ = _rel_err(y, blk)
                    require(err <= tol * scale and berr <= tol * scale,
                            f"{label}: the row kernel disagrees ({err:.3e} "
                            f"from its plain version, {berr:.3e} from the "
                            f"block kernel)")
                    # each the least of two timings: a few µs a launch,
                    # and the clocks may still be rising in the first
                    lays = [(t, x) for t in _row_cold_copies(lay)]
                    blocks = [(t, x) for t in _cold_copies(mat.tiled)]
                    rows_ms = min(time_launches(ROWS["wrapper"], lays, 200)
                                  for _ in range(2))
                    block_ms = min(time_launches(tiled_spmv.tiled_matvec,
                                                 blocks, 200)
                                   for _ in range(2))
                    fast_ms = (min(time_launches(
                        tiled_spmv.tiled_matvec_fast, blocks, 200)
                        for _ in range(2))
                        if dtype == torch.float32 else None)
                    bm, bn = shape
                    row_bytes = lay.nnz * (s + 4) + 4 * (lay.num_rows + 1)
                    block_bytes = mat.num_blocks * bm * bn * s
                    rule = tiled_spmv.prefer_rows(
                        lay.nnz, lay.num_rows, mat.num_blocks, shape, s)
                    fast = ("" if fast_ms is None
                            else f", bf16 stream {fast_ms:.4f} ms")
                    print(f"{label:34s} bytes rows/blocks {row_bytes}/"
                          f"{block_bytes} = {row_bytes / block_bytes:.3f};"
                          f" row kernel {rows_ms:.4f} ms, block kernel "
                          f"{block_ms:.4f} ms{fast}: time rows/blocks "
                          f"{rows_ms / block_ms:.3f}; the rule gives "
                          f"{'rows' if rule else 'blocks'}", flush=True)
                    out[label] = dict(
                        row_bytes=row_bytes, block_bytes=block_bytes,
                        rows_ms=rows_ms, block_ms=block_ms, fast_ms=fast_ms,
                        rule_rows=rule, max_abs_err=err)
                    del lays, blocks
                    for batch in BOUNDARY_BATCHES:
                        out[f"{label} B={batch}"] = boundary_spmm(
                            f"{label} B={batch}", mat, lay, s, batch)
                    del mat, lay
            torch.cuda.empty_cache()
    return out


def boundary_spmm(label: str, mat: BlockSparseMatrix, lay, s: int,
                  batch: int) -> dict:
    """Both batched kernels on one boundary matrix at ``batch``
    instances, L2-cold, the row kernel held to its plain version first:
    the bytes each moves through L2 by the batched rule's count, their
    ratio, the times and theirs, and what the rule gives."""
    x = _batch_x(mat, batch, lay.values.dtype, 9)
    y = ROWS_SPMM["wrapper"](lay, x)
    ref = ROWS_SPMM["plain"](lay, x)
    torch.cuda.synchronize()
    tol = 1e-12 if s == 8 else 1e-5
    err, scale = _rel_err(y, ref)
    require(err <= tol * scale, f"{label}: the batched row kernel disagrees "
            f"({err:.3e} from its plain version)")
    lays = [(t, x) for t in _row_cold_copies(lay)]
    blocks = [(t, x) for t in _cold_copies(mat.tiled)]
    rows_ms = min(time_launches(ROWS_SPMM["wrapper"], lays, 50)
                  for _ in range(2))
    block_ms = min(time_launches(tiled_spmv.tiled_matmat, blocks, 50)
                   for _ in range(2))
    bm, bn = mat.block_shape
    row_bytes = (lay.nnz * (s + 4 + batch * s) + 4 * (lay.num_rows + 1))
    block_bytes = mat.num_blocks * bn * (bm + batch) * s
    rule = tiled_spmv.prefer_rows_batched(lay.nnz, lay.num_rows,
                                          mat.num_blocks, (bm, bn), s, batch)
    print(f"{label:40s} bytes rows/blocks {row_bytes}/{block_bytes} = "
          f"{row_bytes / block_bytes:.3f}; batched row kernel {rows_ms:.4f} "
          f"ms, block SpMM {block_ms:.4f} ms: time rows/blocks "
          f"{rows_ms / block_ms:.3f}; the rule gives "
          f"{'rows' if rule else 'blocks'}", flush=True)
    return dict(row_bytes=row_bytes, block_bytes=block_bytes,
                rows_ms=rows_ms, block_ms=block_ms, rule_rows=rule,
                max_abs_err=err)


# ---------------------------------------------------------------------------
# 4. A moderate LP to OPTIMAL
# ---------------------------------------------------------------------------


def highs_objective(qp) -> float:
    res = linprog(qp.objective_vector, A_ub=qp.constraint_matrix,
                  b_ub=qp.constraint_upper,
                  bounds=list(zip(qp.variable_lower, qp.variable_upper)),
                  method="highs")
    require(res.status == 0, f"HiGHS failed: {res.message}")
    return float(res.fun)


def in_threads(fn, args_list: list) -> list:
    """``fn(*args)`` for each of ``args_list``, in threads: HiGHS releases
    the GIL while it solves, so a phase's references take about as long as
    the slowest of them."""
    with ThreadPoolExecutor(max_workers=min(8, len(args_list))) as ex:
        return list(ex.map(lambda a: fn(*a), args_list))


_MODERATE_REFS: dict = {}


def moderate_refs(seeds) -> dict:
    """HiGHS's optimum of each seed's moderate LP, computed once a seed."""
    todo = [s for s in seeds if s not in _MODERATE_REFS]
    if todo:
        refs = in_threads(
            lambda s: highs_objective(block_random_lp(**MODERATE, seed=s)),
            [(s,) for s in todo])
        _MODERATE_REFS.update(zip(todo, refs))
    return {s: _MODERATE_REFS[s] for s in seeds}


def moderate_solve(seeds=MODERATE_SEEDS, errs: dict = None) -> None:
    """Each seed's moderate LP to OPTIMAL with default parameters: the
    iterations and time to tolerance, held against HiGHS.  Several seeds,
    because one LP's count moves by majors under a change of summation
    order.  Then the SpMVs against their plain versions on the first
    seed's scaled matrices as the solve built them (largest errors into
    ``errs``, where given)."""
    refs = moderate_refs(seeds)
    for seed in seeds:
        qp = block_random_lp(**MODERATE, seed=seed)
        ref = refs[seed]
        reset_counters()
        r = solve(qp, PdhgParams(record_iteration_stats=True))
        launches = _launches()
        streams = [rec["stream"] for rec in r.iteration_stats]
        rel = abs(r.primal_objective - ref) / (1 + abs(ref))
        print(f"moderate LP {MODERATE} seed {seed}: "
              f"{r.termination_reason.name} in {r.iterations} iterations, "
              f"{r.solve_time_sec:.3f} s; objective {r.primal_objective!r} "
              f"HiGHS {ref!r} (rel {rel:.2e}); fast majors "
              f"{streams.count('fast')}, exact majors "
              f"{streams.count('exact')}; launches {launches}", flush=True)
        require(r.termination_reason == TerminationReason.OPTIMAL,
                f"moderate LP seed {seed} did not reach OPTIMAL")
        require(rel <= 1e-4,
                f"moderate LP seed {seed} objective disagrees with HiGHS")
        require(exact_spmvs(launches) > 0
                and (launches["block_spmv_fast"] > 0) == ("fast" in streams),
                f"a kernel was not launched by the moderate solve: {launches}")
    prob = pdlp_solver.build_device_problem(
        block_random_lp(**MODERATE, seed=seeds[0]), PdhgParams(), "cuda")
    for name, mat in (("A", prob.a), ("A^T", prob.at)):
        bm, bn = mat.block_shape
        check_built(f"moderate LP seed {seeds[0]} {name} ({bm}x{bn})", mat,
                    {} if errs is None else errs)


# ---------------------------------------------------------------------------
# 5. Full width: the main path, stream rates, kernel times
# ---------------------------------------------------------------------------


def main_path(qp) -> dict:
    """The bench LP through ``solve`` with default parameters; the launch
    counters are zeroed just before and read just after."""
    params = PdhgParams(iteration_limit=BENCH_ITERATION_LIMIT,
                        record_iteration_stats=True, **BENCH_PARAMS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    pdlp_solver.host_syncs = 0
    reset_counters()
    r = solve(qp, params)
    torch.cuda.synchronize()
    launches = {k: v["wrapper"].launches for k, v in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    streams = [rec["stream"] for rec in r.iteration_stats]
    print(f"bench LP {BENCH}: {r.termination_reason.name} after "
          f"{r.iterations} iterations in {r.solve_time_sec:.3f} s (host "
          f"set-up included); majors fast {streams.count('fast')} exact "
          f"{streams.count('exact')}; host syncs {pdlp_solver.host_syncs} "
          f"({pdlp_solver.host_syncs / max(1, len(streams)):.1f} per "
          f"major); launches {launches}; max_memory_allocated {peak} bytes "
          f"({held} held before the solve)")
    require(r.termination_reason == TerminationReason.ITERATION_LIMIT
            and r.iterations == BENCH_ITERATION_LIMIT,
            "bench solve did not run to its iteration limit")
    require(r.primal_solution.shape == (qp.num_variables,)
            and r.dual_solution.shape == (qp.num_constraints,),
            "bench solution has the wrong shape")
    require(bool(np.all(np.isfinite(r.primal_solution))
                 and np.all(np.isfinite(r.dual_solution))),
            "bench solution is not finite")
    require(all(np.isfinite(rec["kkt_current"]) for rec in r.iteration_stats),
            "bench KKT error is not finite")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the main path was not launched: {launches}")
    return launches


def bench_majors(prob, **kw):
    """The solver's majors on ``prob`` with the bench parameters (and
    ``kw``), loaded with the initial state from the seed-0 power-iteration
    start.  Each stream's graphs are captured at its first major."""
    params = PdhgParams(**BENCH_PARAMS, **kw)
    g = torch.Generator(device="cpu").manual_seed(0)
    v0 = torch.randn(prob.c.shape[0], generator=g,
                     dtype=torch.float64).to(prob.c)
    sigma = pdlp_solver._make_power_iter(params)(prob, v0)
    majors = pdlp_solver._Majors(prob, params)
    majors.load(pdlp_solver._make_initial_state(params)(prob, sigma))
    return majors


def stream_rates(prob) -> tuple:
    """Iter/s of the solver's own majors (captured graphs, replayed),
    fast stream then exact stream, from one shared start; host syncs per
    major and the share of the major's wall time the host spends blocked
    in them.  Returns the seconds per major of each stream and the
    majors."""
    majors = bench_majors(prob)
    freq = majors.freq
    for name in ("fast", "exact"):  # a stream's first major captures it
        torch.cuda.synchronize()
        held0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pdlp_solver.capture_seconds = 0.0
        majors.major(name == "fast")
        torch.cuda.synchronize()
        print(f"{name} stream: capture of its major, tail and statistics "
              f"graphs (warm-up included) {pdlp_solver.capture_seconds:.3f}"
              f" s; device memory held after its first major +"
              f"{torch.cuda.memory_allocated() - held0} bytes, peak during "
              f"it +{torch.cuda.max_memory_allocated() - held0} bytes")
    # Host time varies from turn to turn: the streams take turns (fast,
    # exact, exact, fast), TIMED_MAJORS majors each, and sum their turns.
    total = {name: [0.0, 0, 0.0] for name in ("fast", "exact")}
    for name in ("fast", "exact", "exact", "fast"):
        syncs0 = pdlp_solver.host_syncs
        blocked0 = pdlp_solver.host_sync_seconds
        t0 = time.perf_counter()
        for _ in range(TIMED_MAJORS):
            majors.major(name == "fast")
        torch.cuda.synchronize()
        t = total[name]
        t[0] += time.perf_counter() - t0
        t[1] += pdlp_solver.host_syncs - syncs0
        t[2] += pdlp_solver.host_sync_seconds - blocked0
        require(bool(torch.isfinite(majors.state.x).all()),
                f"{name} stream majors gave a non-finite iterate")
    major_s = {}
    for name, (dt, syncs, blocked) in total.items():
        n_majors = 2 * TIMED_MAJORS
        print(f"{name} stream: {n_majors * freq / dt:.1f} PDHG iter/s "
              f"({dt / n_majors * 1e3:.3f} ms per {freq}-step major); "
              f"host syncs per major {syncs / n_majors:.2f}, host blocked in"
              f" them {blocked / dt:.1%} of the major's wall time")
        major_s[name] = dt / n_majors
    host_parts(majors, False, "exact stream major")
    return major_s, majors


def host_parts(majors, fast: bool, label: str) -> None:
    """The host's time in a major, part by part (the steps of
    ``_Majors.major`` when no instance falls short), over TIMED_MAJORS
    majors: the two replays, the read of the scalars (the wait for the
    device included), and the rest."""
    parts = np.zeros(3)
    t_start = time.perf_counter()
    for _ in range(TIMED_MAJORS):
        t0 = time.perf_counter()
        majors._run("main", fast)
        t1 = time.perf_counter()
        _, scalars = majors._run("stats", fast)
        t2 = time.perf_counter()
        pdlp_solver._read_scalars(*scalars)
        parts += (t1 - t0, t2 - t1, time.perf_counter() - t2)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t_start) / TIMED_MAJORS
    parts /= TIMED_MAJORS
    print(f"{label} on the host, ms per major: replay of the major graph "
          f"{parts[0] * 1e3:.3f}, of the statistics graph "
          f"{parts[1] * 1e3:.3f}, read of the scalars (the wait included) "
          f"{parts[2] * 1e3:.3f}, the rest {(wall - parts.sum()) * 1e3:.3f};"
          f" wall {wall * 1e3:.3f}")


def _graph(majors, kind: str, fast: bool):
    return majors._graphs[(kind, fast)][0]


def device_profile(majors, major_s: dict,
                   streams=(("fast", True), ("exact", False))) -> None:
    """Each stream's major graph and statistics graph under
    torch.profiler: device kernels per iteration and device time by
    kernel; then the device time of a major (the two graphs replayed back
    to back, CUDA events, the host ahead of the device) against the wall
    time of an unprofiled major (``major_s``, from ``stream_rates``): the
    device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    freq = majors.freq
    for name, fast in streams:
        seen = {}
        for kind in ("main", "stats"):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _graph(majors, kind, fast).replay()
                torch.cuda.synchronize()
            by_name: dict = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    t, n = by_name.get(e.name, (0.0, 0))
                    by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
            seen[kind] = by_name
        graphs = [_graph(majors, kind, fast) for kind in ("main", "stats")]
        device_ms = time_launches(
            lambda: [g.replay() for g in graphs], [()], 10)
        print(f"{name} stream: device time of a major (major and statistics"
              f" graphs, CUDA events) {device_ms:.3f} ms, busy "
              f"{device_ms / 1e3 / major_s[name]:.1%} of an unprofiled "
              f"major ({major_s[name] * 1e3:.3f} ms)")
        main, stats = seen["main"], seen["stats"]
        if not main:
            print(f"{name} stream: the profiler saw no device time in a "
                  f"replayed graph; kernels per iteration not measured")
            continue
        busy_us = sum(t for t, _ in main.values())
        kernels = sum(n for _, n in main.values())
        s_us = sum(t for t, _ in stats.values())
        s_n = sum(n for _, n in stats.values())
        print(f"{name} stream, profiled: {kernels / freq:.1f} device kernels"
              f" per iteration, {busy_us / 1e3:.3f} ms of kernels in the "
              f"major graph; statistics graph {s_n} kernels, "
              f"{s_us / 1e3:.3f} ms")
        top = sorted(main.items(), key=lambda kv: -kv[1][0])[:8]
        for kname, (t, n) in top:
            print(f"    {t / 1e3:9.3f} ms {n:6d}x  {kname[:100]}")


def stats_times(prob) -> None:
    """Milliseconds of one statistics pass (its graph replayed, CUDA
    events) in each stream under ADAPTIVE_KKT and ADAPTIVE_HEURISTIC (the
    latter adds the two trust-region bisections)."""
    for rule in (RestartStrategy.ADAPTIVE_KKT,
                 RestartStrategy.ADAPTIVE_HEURISTIC):
        majors = bench_majors(prob, restart_strategy=rule)
        times = []
        for name, fast in (("fast", True), ("exact", False)):
            majors.major(fast)
            graph = _graph(majors, "stats", fast)
            times.append(f"{name} {time_launches(graph.replay, [()], 20):.4f}"
                         f" ms")
        print(f"statistics pass under {rule.name}: {', '.join(times)}")
        del majors


def time_launches(fn, args_list, reps: int) -> float:
    """Mean ms per launch over ``reps`` launches cycling through
    ``args_list`` (copies whose bytes together exceed the L2 cache).  A
    sleep kernel runs first so the host enqueues every launch before the
    first one starts: the events then time the device, not Python."""
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for i in range(reps):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _csr_copies(mat: BlockSparseMatrix, copies: int,
                dtype: torch.dtype = torch.float32) -> list:
    """The matrix as torch sparse CSR tensors of ``dtype`` on the card,
    every stored entry kept (the library yardstick; the port never calls
    it)."""
    bm, bn = mat.block_shape
    lay = mat.tiled
    br = lay.block_rows.cpu().numpy().astype(np.int64)
    bc = lay.block_cols.cpu().numpy().astype(np.int64)
    rows = (br[:, None, None] * bm + np.arange(bm)[None, :, None]
            + np.zeros(bn, np.int64)[None, None, :]).ravel()
    cols = (bc[:, None, None] * bn + np.zeros(bm, np.int64)[None, :, None]
            + np.arange(bn)[None, None, :]).ravel()
    vals = lay.data.float().cpu().numpy().ravel()
    order = np.lexsort((cols, rows))
    indptr = np.zeros(mat.padded_shape[0] + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=mat.padded_shape[0]),
              out=indptr[1:])
    crow = torch.as_tensor(indptr, dtype=torch.int32, device="cuda")
    col = torch.as_tensor(cols[order], dtype=torch.int32, device="cuda")
    val = torch.as_tensor(vals[order], dtype=torch.float32,
                          device="cuda").to(dtype)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse")
        return [torch.sparse_csr_tensor(crow.clone(), col.clone(),
                                        val.clone(), size=mat.padded_shape,
                                        check_invariants=True)
                for _ in range(copies)]


def _bsr_product(mat: BlockSparseMatrix, x: torch.Tensor):
    """The exact product as a torch block-sparse (BSR) tensor with the
    layout's own blocks (a second library yardstick; the port never calls
    it): returns (a callable, None), or (None, why torch refuses it)."""
    lay = mat.tiled
    try:
        bsr = torch.sparse_bsr_tensor(
            lay.row_ptr.long(), lay.block_cols.long(), lay.data.float(),
            size=mat.padded_shape)
    except (RuntimeError, ValueError, TypeError) as e:
        return None, f"sparse_bsr_tensor: {e}"
    why = []
    for fn in (lambda v: bsr @ v, lambda v: (bsr @ v[:, None])[:, 0]):
        try:
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", message="Sparse")
                fn(x)
                torch.cuda.synchronize()
        except (RuntimeError, ValueError, TypeError,
                NotImplementedError) as e:
            why.append(str(e).splitlines()[0][:160])
            continue
        return fn, None
    return None, " / ".join(why)


def _bf16_csr(csrs: list, x: torch.Tensor, fast_ref: torch.Tensor) -> dict:
    """torch's bf16 sparse CSR product (bf16 values @ bf16 x), the nearest
    library call to the fast kernel: it returns y in bf16, where the fast
    kernel sums and returns f32, so it is not the same function.  Its time
    (L2-cold), its output's dtype and its distance from the fast kernel's
    plain version, or why torch refuses it."""
    xb = x.bfloat16()
    try:
        y = csrs[0] @ xb
        torch.cuda.synchronize()
    except (RuntimeError, ValueError, TypeError, NotImplementedError) as e:
        return dict(ms=None, refused=str(e).splitlines()[0][:160])
    err, scale = _rel_err(y, fast_ref)
    ms = time_launches(lambda a, v: a @ v, [(c, xb) for c in csrs], 200)
    return dict(ms=ms, dtype=str(y.dtype).replace("torch.", ""),
                max_abs_err=err, scale=scale)


def kernel_bound_ms(mat: BlockSparseMatrix, value_bytes: int,
                    vec_bytes: int = 4) -> tuple:
    """Least time for one product: each input read once, y written once,
    over the card's memory rate, against 2 flops per stored entry over the
    f32 rate; returns (ms, "bytes" | "operations", bytes)."""
    lay = mat.tiled
    nb = mat.num_blocks
    bm, bn = mat.block_shape
    m, n = mat.padded_shape
    nbytes = (nb * bm * bn * value_bytes + (n + m) * vec_bytes
              + (lay.num_block_rows + 1) * 4 + nb * 4)
    flops = 2 * nb * bm * bn
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", nbytes
    return t_ops * 1e3, "operations", nbytes


def _cold_copies(lay) -> list:
    """Copies of the layout, enough that even the smaller copy of the
    blocks (bf16 where there is one) cycled over exceeds L2 twice."""
    hi = lay.data_hi
    nbytes = (lay.data if hi is None else hi).nbytes
    return [lay._replace(data=lay.data.clone(),
                         data_hi=None if hi is None else hi.clone())
            for _ in range(1 + (2 * L2_BYTES) // nbytes)]


def _long_rows(lay) -> str:
    return f"{getattr(lay, 'num_long', '?')}/{lay.num_block_rows} long rows"


def launch_floor() -> None:
    """Each kernel on a one-block (8x128) matrix, and a one-element torch
    kernel: the fixed cost of a launch, which the bytes bound leaves out."""
    tiny = BlockSparseMatrix.from_scipy(
        sp.csr_matrix(np.ones((8, 128))), dtype=torch.float32,
        device="cuda").with_tiled(hi=True)
    x = torch.ones(tiny.padded_shape[1], device="cuda")
    one = torch.zeros(1, device="cuda")
    ms = time_launches(lambda t: t.zero_(), [(one,)], 400)
    print(f"launch floor: one-element torch kernel {ms:.4f} ms", end="")
    for name, spec in KERNELS.items():
        ms = time_launches(spec["wrapper"], [(tiny.tiled, x)], 400)
        print(f", {name} on one 8x128 block {ms:.4f} ms", end="")
    print()


# The other block sizes auto_block_shape picks (ops/block_sparse.py), at
# the bench matrix's bytes: 16384^2 with 1024 blocks of 32x128 and 256 of
# 128x128 (16.8 MB of f32 each, seed 0), with their transposes.
OTHER_SHAPES = (((32, 128), 1024), ((128, 128), 256))


def shape_times(prob) -> None:
    """The kernels' L2-cold time beside the bytes bound on the other block
    sizes they take: f64 bench A and A^T (8 KB blocks, exact kernel), and
    f32 OTHER_SHAPES (exact and fast)."""
    cases = []
    for orient, mat in (("A", prob.a), ("A^T", prob.at)):
        m64 = dataclasses.replace(mat, data=mat.data.double(),
                                  tiled=None).with_tiled()
        cases.append((f"f64 bench {orient}", m64, 8))
    for block_shape, nb in OTHER_SHAPES:
        qp = block_random_lp(16384, 16384, nb, block_shape, seed=0)
        mat = BlockSparseMatrix.from_scipy(
            qp.constraint_matrix, block_shape=block_shape,
            dtype=torch.float32, device="cuda")
        cases.append(("f32 A", mat.with_tiled(hi=True), 4))
        cases.append(("f32 A^T", mat.block_transpose().with_tiled(hi=True),
                      4))
    for label, mat, vbytes in cases:
        x = _x_for(mat, mat.data.dtype, 2)
        lays = _cold_copies(mat.tiled)
        for name, spec in KERNELS.items():
            fast = name == "block_spmv_fast"
            if fast and vbytes == 8:
                continue
            ms = time_launches(spec["wrapper"], [(t, x) for t in lays], 400)
            bound_ms, _, nbytes = kernel_bound_ms(mat, 2 if fast else vbytes,
                                                  vbytes)
            print(f"{name:17s} {label:11s} {mat.block_shape} "
                  f"({_long_rows(mat.tiled)}): kernel {ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({nbytes} bytes); {bound_ms / ms:.1%}"
                  f" of bound", flush=True)
        del lays


def kernel_times(prob) -> dict:
    """Each kernel at the bench shape, A and A^T: its time, its plain
    version's time, the CSR library product's time, and its bound."""
    out = {}
    for orient, mat in (("A", prob.a), ("A^T", prob.at)):
        lay = mat.tiled
        lays32 = _cold_copies(lay)
        x = _x_for(mat, torch.float32, 2)
        csrs = _csr_copies(mat, len(lays32))
        bsr, bsr_why = _bsr_product(mat, x)
        print(f"{orient} layout: {_long_rows(lay)}")
        for name, spec in KERNELS.items():
            fast = name == "block_spmv_fast"
            args = [(t, x) for t in lays32]
            ms = time_launches(spec["wrapper"], args, 400)
            warm_ms = time_launches(spec["wrapper"], args[:1], 400)
            plain_ms = time_launches(spec["plain"], args, 100)
            bf16_csr = None
            if fast:
                # No PyTorch call multiplies bf16 blocks by a bf16-rounded
                # x into an f32 result; the bf16 CSR product (y in bf16)
                # is timed beside it, not as its library call.
                library_ms = bsr_ms = None
                csrs16 = _csr_copies(mat, len(lays32), torch.bfloat16)
                bf16_csr = _bf16_csr(csrs16, x, spec["plain"](lays32[0], x))
                del csrs16
            else:
                library_ms = time_launches(lambda a, v: a @ v,
                                           [(c, x) for c in csrs], 200)
                bsr_ms = (time_launches(bsr, [(x,)], 200)
                          if bsr is not None else None)
            bound_ms, bound_by, nbytes = kernel_bound_ms(
                mat, 2 if fast else 4)
            lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
            bsr_txt = (f", bf16 CSR (y in bf16, not this function) "
                       f"{bf16_csr}" if fast
                       else f", BSR (L2-warm) {bsr_ms:.4f} ms"
                       if bsr_ms is not None else f", BSR refused: {bsr_why}")
            print(f"{name:17s} {orient:3s} {mat.block_shape}: kernel "
                  f"{ms:.4f} ms (L2-warm {warm_ms:.4f} ms), plain "
                  f"{plain_ms:.4f} ms, library (CSR) {lib}{bsr_txt}, bound "
                  f"{bound_ms:.4f} ms ({nbytes} bytes, {bound_by}); kernel "
                  f"at {bound_ms / ms:.1%} of bound")
            out[(name, orient)] = dict(ms=ms, warm_ms=warm_ms,
                                       plain_ms=plain_ms,
                                       library_ms=library_ms, bsr_ms=bsr_ms,
                                       bf16_csr=bf16_csr,
                                       bound_ms=bound_ms, bound_by=bound_by)
        del lays32, csrs, bsr
    return out


# ---------------------------------------------------------------------------
# 6. The rest of the single-device solve
# ---------------------------------------------------------------------------

REST = (
    ("ADAPTIVE_HEURISTIC",
     dict(restart_strategy=RestartStrategy.ADAPTIVE_HEURISTIC)),
    ("Malitsky-Pock", dict(linesearch_rule="malitsky_pock")),
    ("feasibility polishing", dict(use_feasibility_polishing=True)),
    ("presolve", dict(presolve=True)),
)
# The moderate LP seed whose solve opens polishing's gate (the objective
# gap of the average met at a doubling checkpoint) before it ends.
REST_SEED = 3


def _counted_solve(qp, params):
    """``solve`` with the launch counters and host syncs set to 0 just
    before and read just after.  Returns the result and the host syncs
    made beyond one a major of the main loop (the polishing majors, the
    final statistics at a limit)."""
    pdlp_solver.host_syncs = 0
    reset_counters()
    r = solve(qp, params)
    torch.cuda.synchronize()
    launches = _launches()
    streams = [rec["stream"] for rec in r.iteration_stats]
    extra = pdlp_solver.host_syncs - len(streams)
    print(f"  {r.termination_reason.name} in {r.iterations} iterations, "
          f"{r.solve_time_sec:.3f} s; majors fast {streams.count('fast')} "
          f"exact {streams.count('exact')}; host syncs "
          f"{pdlp_solver.host_syncs} ({extra} beyond one a major); "
          f"launches {launches}", flush=True)
    require(exact_spmvs(launches) > 0
            and (launches["block_spmv_fast"] > 0) == ("fast" in streams),
            f"a kernel was not launched: {launches}")
    return r, extra


def rest_of_solve(bench_qp, seed: int = REST_SEED) -> None:
    qp = block_random_lp(**MODERATE, seed=seed)
    ref = moderate_refs([seed])[seed]
    for label, kw in REST:
        print(f"moderate LP seed {seed}, {label}:")
        r, extra = _counted_solve(
            qp, PdhgParams(record_iteration_stats=True, **kw))
        rel = abs(r.primal_objective - ref) / (1 + abs(ref))
        print(f"  objective {r.primal_objective!r} HiGHS {ref!r} "
              f"(rel {rel:.2e})")
        require(r.termination_reason == TerminationReason.OPTIMAL,
                f"moderate LP under {label} did not reach OPTIMAL")
        require(rel <= 1e-4, f"moderate LP under {label} disagrees with "
                f"HiGHS")
        if kw.get("use_feasibility_polishing"):
            require(extra > 0, "no polishing major ran")
    print("bench LP, ADAPTIVE_HEURISTIC with Malitsky-Pock:")
    r, _ = _counted_solve(bench_qp, PdhgParams(
        iteration_limit=BENCH_ITERATION_LIMIT, record_iteration_stats=True,
        restart_strategy=RestartStrategy.ADAPTIVE_HEURISTIC,
        linesearch_rule="malitsky_pock", **BENCH_PARAMS))
    require(r.termination_reason == TerminationReason.ITERATION_LIMIT
            and r.iterations == BENCH_ITERATION_LIMIT,
            "bench solve under ADAPTIVE_HEURISTIC with Malitsky-Pock did not"
            " run to its iteration limit")
    require(bool(np.all(np.isfinite(r.primal_solution))
                 and np.all(np.isfinite(r.dual_solution)))
            and all(np.isfinite(rec["kkt_current"])
                    for rec in r.iteration_stats),
            "bench solve under ADAPTIVE_HEURISTIC with Malitsky-Pock is not "
            "finite")


# ---------------------------------------------------------------------------
# 7. The batched solve
# ---------------------------------------------------------------------------


def _batch_x(mat: BlockSparseMatrix, batch: int, dtype, seed: int):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(batch, mat.padded_shape[1], generator=g,
                    dtype=torch.float64)
    return x.to(dtype=dtype, device="cuda")


def check_spmm(label: str, mat: BlockSparseMatrix, batch: int,
               errs: dict) -> None:
    """The SpMM kernel against its plain version on ``mat`` (no layout)
    at ``batch`` instances, f32 and f64, each launched twice."""
    out = []
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        lay = dataclasses.replace(mat, data=mat.data.to(dtype),
                                  tiled=None).with_tiled().tiled
        x = _batch_x(mat, batch, dtype, 1)
        y, y2 = tiled_spmv.tiled_matmat(lay, x), tiled_spmv.tiled_matmat(lay,
                                                                         x)
        ref = tiled_spmv.tiled_matmat_plain(lay, x)
        torch.cuda.synchronize()
        err, scale = _rel_err(y, ref)
        out.append(f"{str(dtype)[6:]} {err:.3e} (<= {tol * scale:.3e})")
        require(err <= tol * scale, f"{label}: SpMM {dtype} disagrees")
        require(torch.equal(y, y2),
                f"{label}: a repeated SpMM launch is not bit-identical")
        if dtype == torch.float32:
            errs[SPMM["name"]] = max(errs.get(SPMM["name"], 0.0), err)
    print(f"{label:34s} B={batch:3d}: SpMM " + ", ".join(out))


def spmm_against_plain(bench_prob) -> dict:
    errs: dict = {}
    for name, mat in (("A", bench_prob.a), ("A^T", bench_prob.at)):
        bm, bn = mat.block_shape
        check_spmm(f"bench {name} ({bm}x{bn})", mat.without_tiled(), BATCH,
                   errs)
    for block_shape, nb in SMALL_SHAPES:
        qp = block_random_lp(2048, 2048, nb, block_shape, seed=1)
        mat = BlockSparseMatrix.from_scipy(
            qp.constraint_matrix, block_shape=block_shape,
            dtype=torch.float64, device="cuda")
        bm, bn = block_shape
        check_spmm(f"2048^2 A ({bm}x{bn})", mat, 8, errs)
        check_spmm(f"2048^2 A^T ({bn}x{bm})", mat.block_transpose(), 8, errs)
    skewed = skewed_matrix()
    check_spmm("skewed 2048x16384 (8x128)", skewed, 8, errs)
    check_spmm("skewed^T (128x8)", skewed.block_transpose(), 8, errs)
    empty = BlockSparseMatrix.from_scipy(sp.csr_matrix((50, 60)),
                                         device="cuda")
    check_spmm("empty 50x60 (8x128)", empty, 8, errs)
    return errs


def moderate_instances(seed: int = REST_SEED, batch: int = MODERATE_BATCH):
    """The moderate LP and ``batch`` sets of its variable bounds: in each
    instance a fifth of the variables boxed to within 1 of the generator's
    feasible point, so every instance stays feasible; drawn from a seed."""
    qp = block_random_lp(**MODERATE, seed=seed)
    bm, bn = MODERATE["block_shape"]
    m, n, nb = MODERATE["m"], MODERATE["n"], MODERATE["num_blocks"]
    # block_random_lp's draws: cells, values, then its feasible point x0
    g = np.random.default_rng(seed)
    g.choice((m // bm) * (n // bn), size=nb, replace=False)
    g.standard_normal(nb * bm * bn)
    x0 = g.uniform(0.0, 5.0, size=n)
    require(bool(np.all(qp.constraint_matrix @ x0 <= qp.constraint_upper)),
            "the generator's feasible point is not feasible")
    rng = np.random.default_rng(seed + 100)
    box = rng.random((batch, n)) < 0.2
    lbs = np.where(box, np.maximum(0.0, x0 - rng.uniform(0, 1, box.shape)),
                   qp.variable_lower)
    ubs = np.where(box, np.minimum(10.0, x0 + rng.uniform(0, 1, box.shape)),
                   qp.variable_upper)
    return qp, lbs, ubs


def highs_bounded(qp, lb, ub) -> float:
    res = linprog(qp.objective_vector, A_ub=qp.constraint_matrix,
                  b_ub=qp.constraint_upper, bounds=list(zip(lb, ub)),
                  method="highs")
    require(res.status == 0, f"HiGHS failed: {res.message}")
    return float(res.fun)


def batched_moderate() -> None:
    """``solve_batch`` on the moderate instances, f32 then f64: every
    instance OPTIMAL within 1e-4(1+|ref|) of HiGHS on its own bounds, its
    dual bound at most HiGHS + 1e-4(1+|ref|)."""
    qp, lbs, ubs = moderate_instances()
    refs = np.array(in_threads(highs_bounded, [(qp, lbs[i], ubs[i])
                                               for i in range(len(lbs))]))
    for dtype in (torch.float32, torch.float64):
        reset_counters()
        t0 = time.perf_counter()
        r = solve_batch(qp, lbs, ubs, PdhgParams(dtype=dtype))
        dt = time.perf_counter() - t0
        rel = np.abs(r.primal_objective - refs) / (1 + np.abs(refs))
        slack = r.dual_bound - refs - 1e-4 * (1 + np.abs(refs))
        print(f"solve_batch, moderate LP seed {REST_SEED}, {len(lbs)} "
              f"instances, {str(dtype)[6:]}: optimal {int(r.optimal.sum())}"
              f"/{len(lbs)} in {r.iterations} iterations, {dt:.3f} s; "
              f"largest objective rel. error {rel.max():.2e}; largest "
              f"dual bound - HiGHS {np.max(r.dual_bound - refs):.2e}; SpMM "
              f"launches {tiled_spmv.tiled_matmat.launches}", flush=True)
        require(bool(r.optimal.all()), "a batched instance is not OPTIMAL")
        require(bool(np.all(rel <= 1e-4)),
                "a batched objective disagrees with HiGHS")
        require(bool(np.all(slack <= 0)),
                "a batched dual bound lies above HiGHS's optimum")
        require(tiled_spmv.tiled_matmat.launches > 0,
                "the batched solve launched no SpMM")


def mip_pair() -> None:
    """tests/test_mip.py:183 on the card: x1 + x2 >= 4 with x in [0,1]^2
    (certified infeasible) and in [0,5]^2 (optimum 4)."""
    qp = QuadraticProgram(
        objective_vector=np.array([1.0, 1.0]),
        constraint_matrix=sp.csr_matrix(np.array([[1.0, 1.0]])),
        constraint_lower=np.array([4.0]),
        constraint_upper=np.array([np.inf]),
        variable_lower=np.zeros(2),
        variable_upper=np.ones(2),
    )
    res = solve_batch(qp, np.zeros((2, 2)), np.array([[1.0, 1.0],
                                                      [5.0, 5.0]]),
                      PdhgParams(iteration_limit=20_000))
    print(f"test_mip pair: primal_infeasible {res.primal_infeasible.tolist()}"
          f", optimal {res.optimal.tolist()}, objective "
          f"{res.primal_objective[1]!r}, dual bound {res.dual_bound[1]!r}, "
          f"{res.iterations} iterations")
    require(bool(res.primal_infeasible[0]) and not res.primal_infeasible[1]
            and bool(res.optimal[1]), "test_mip pair: wrong flags")
    require(abs(res.primal_objective[1] - 4.0) <= 1e-4
            and res.dual_bound[1] <= 4.0 + 1e-4,
            "test_mip pair: wrong objective or dual bound")


def _accepted(backend) -> int:
    """Iterations every instance of the backend's last call accepted."""
    return int(backend._solver.majors.state.num_accepted.min())


def batched_main_path(bench_qp) -> tuple:
    """The batched main path at full width: ``PdhgNodeBackend`` on the
    bench LP at B = 64, root bounds tiled, ``BATCH_MAJORS`` majors; the
    launch counters are zeroed just before the first call and read just
    after.  A second call must capture nothing; it is timed.  Returns the
    launches and the backend."""
    params = PdhgParams(iteration_limit=64 * BATCH_MAJORS, **BENCH_PARAMS)
    lbs = np.tile(bench_qp.variable_lower, (BATCH, 1))
    ubs = np.tile(bench_qp.variable_upper, (BATCH, 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    pdlp_solver.capture_seconds = 0.0
    pdlp_solver.host_syncs = 0
    reset_counters()
    t0 = time.perf_counter()
    backend = PdhgNodeBackend(bench_qp, params, BATCH)
    first = backend.solve(lbs, ubs)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    iters_first = _accepted(backend)
    launches = {k: v["wrapper"].launches for k, v in KERNELS.items()}
    launches[SPMM["name"]] = SPMM["wrapper"].launches
    launches[ROWS_SPMM["name"]] = ROWS_SPMM["wrapper"].launches
    peak = torch.cuda.max_memory_allocated()
    capture_first = pdlp_solver.capture_seconds
    syncs_first = pdlp_solver.host_syncs
    print(f"batched bench LP, B={BATCH}, {iters_first} iterations: "
          f"first call {t_first:.3f} s (set-up, capture and "
          f"{BATCH_MAJORS} majors), capture {capture_first:.3f} s, host "
          f"syncs {syncs_first}; launches {launches}; max_memory_allocated "
          f"{peak} bytes ({held} held before)", flush=True)
    pdlp_solver.capture_seconds = 0.0
    pdlp_solver.host_syncs = 0
    t0 = time.perf_counter()
    second = backend.solve(lbs, ubs)
    torch.cuda.synchronize()
    t_second = time.perf_counter() - t0
    iters_second = _accepted(backend)
    print(f"batched bench LP, second call: {t_second:.3f} s, capture "
          f"{pdlp_solver.capture_seconds:.3f} s, host syncs "
          f"{pdlp_solver.host_syncs} for {BATCH_MAJORS} majors; "
          f"{iters_second * BATCH / t_second:.1f} LP-iterations/s over "
          f"the whole call", flush=True)
    require(pdlp_solver.capture_seconds == 0.0,
            "the backend's second call captured graphs")
    for r, iters in ((first, iters_first), (second, iters_second)):
        require(iters == 64 * BATCH_MAJORS
                and r.primal_solution.shape == (BATCH,
                                                bench_qp.num_variables)
                and r.dual_solution.shape == (BATCH,
                                              bench_qp.num_constraints),
                "batched bench solve: wrong iterations or shapes")
        require(bool(np.all(np.isfinite(r.primal_solution))
                     and np.all(np.isfinite(r.dual_solution))
                     and np.all(np.isfinite(r.dual_bound))),
                "batched bench solve: not finite")
    require(np.array_equal(first.primal_solution, second.primal_solution),
            "the backend's second call differs from its first")
    # every instance has the root's bounds: the same solve B times
    require(bool(np.all(first.primal_solution == first.primal_solution[0])),
            "identical instances gave different iterates")
    require(launches[SPMM["name"]] > 0
            and launches["block_spmv_exact"] > 0,
            f"a kernel of the batched path was not launched: {launches}")
    # dense 8x128 blocks: the rule keeps the block SpMM
    require(launches[ROWS_SPMM["name"]] == 0,
            f"the bench LP's batched products took the row layout: "
            f"{launches}")
    # The branch-and-bound raises only the iteration limit (x4 a retry):
    # the backend keeps its solver, so the call captures nothing.
    solver = backend._solver
    pdlp_solver.capture_seconds = 0.0
    t0 = time.perf_counter()
    raised = backend.solve(lbs, ubs, lp_params=dataclasses.replace(
        params, iteration_limit=4 * params.iteration_limit))
    torch.cuda.synchronize()
    iters_raised = _accepted(backend)
    print(f"batched bench LP, a call with 4x the iteration limit: "
          f"{time.perf_counter() - t0:.3f} s for {iters_raised} iterations,"
          f" capture {pdlp_solver.capture_seconds:.3f} s, the same solver: "
          f"{backend._solver is solver}", flush=True)
    require(backend._solver is solver and pdlp_solver.capture_seconds == 0.0
            and iters_raised > 64 * BATCH_MAJORS
            and bool(np.all(np.isfinite(raised.primal_solution))),
            "a raised iteration limit rebuilt the backend's solver")
    return launches, backend


def batched_rates(backend) -> None:
    """The backend's majors (its captured graphs) timed over
    ``TIMED_MAJORS`` majors twice: aggregate LP-iterations/s, host syncs
    per major and the host's blocked share; then the device profile of a
    batched major: kernels per iteration, device time, busy share."""
    majors = backend._solver.majors
    freq = majors.freq
    total = [0.0, 0, 0.0]
    for _ in range(2):
        syncs0 = pdlp_solver.host_syncs
        blocked0 = pdlp_solver.host_sync_seconds
        t0 = time.perf_counter()
        for _ in range(TIMED_MAJORS):
            majors.major(False)
        torch.cuda.synchronize()
        total[0] += time.perf_counter() - t0
        total[1] += pdlp_solver.host_syncs - syncs0
        total[2] += pdlp_solver.host_sync_seconds - blocked0
    n_majors = 2 * TIMED_MAJORS
    major_s = total[0] / n_majors
    print(f"batched majors, B={BATCH}: {freq * BATCH / major_s:.1f} "
          f"LP-iterations/s in aggregate ({freq / major_s:.1f} iter/s per "
          f"instance, {major_s * 1e3:.3f} ms per {freq}-step major); host "
          f"syncs per major {total[1] / n_majors:.2f}, host blocked in them "
          f"{total[2] / total[0]:.1%} of the major's wall time")
    host_parts(majors, False, f"batched major, B={BATCH}")
    device_profile(majors, {"exact": major_s}, streams=(("exact", False),))


def spmm_spills(report: str) -> list:
    """The SpMM kernel instantiations that ``-Xptxas -v`` reports with
    spill stores (each entry line is followed by its spill line)."""
    spilled, entry = [], None
    for line in report.splitlines():
        if "block_spmm_kernel" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif entry and "spill stores" in line:
            if not line.strip().split()[4] == "0":
                spilled.append(entry)
            entry = None
    return spilled


def spmm_bound(mat: BlockSparseMatrix, value_bytes: int) -> tuple:
    """Least time of one SpMM at B = ``BATCH``: the blocks, X and Y once
    each over the memory rate, against 2 flops per stored entry per
    instance over the rate of the value type; returns (ms, "bytes" |
    "operations", bytes, flops, bytes gathered through L2).  The last is
    what a row-wise kernel reads of X: each block's x segment for every
    instance, nb * bn * B values."""
    lay = mat.tiled
    nb, (bm, bn) = mat.num_blocks, mat.block_shape
    m, n = mat.padded_shape
    nbytes = ((nb * bm * bn + (n + m) * BATCH) * value_bytes
              + (lay.num_block_rows + 1) * 4 + nb * 4)
    flops = 2 * nb * bm * bn * BATCH
    peak = PEAK_F32_FLOPS if value_bytes == 4 else PEAK_F64_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return (max(t_bytes, t_ops) * 1e3, bound_by, nbytes, flops,
            nb * bn * BATCH * value_bytes)


def spmm_times(prob) -> dict:
    """The SpMM at the bench shape and B = 64, A and A^T, f32 then f64: its
    time L2-cold and L2-warm beside its bound and the bytes it gathers
    through L2; in f32 also its plain version's time and cuSPARSE SpMM's
    (a torch sparse CSR matrix times a dense [N, B] matrix).  Keys "A",
    "A^T" (f32), "f64 A", "f64 A^T"."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        f32 = dtype == torch.float32
        for orient, mat in (("A", prob.a), ("A^T", prob.at)):
            if not f32:
                mat = dataclasses.replace(mat, data=mat.data.double(),
                                          tiled=None).with_tiled()
            lays = _cold_copies(mat.tiled)
            x = _batch_x(mat, BATCH, dtype, 2)
            args = [(t, x) for t in lays]
            ms = time_launches(SPMM["wrapper"], args, 200)
            warm_ms = time_launches(SPMM["wrapper"], args[:1], 200)
            plain_ms = library_ms = None
            if f32:
                plain_ms = time_launches(SPMM["plain"], args, 20)
                xt = x.t().contiguous()
                library_ms = time_launches(
                    lambda a, v: a @ v,
                    [(c, xt) for c in _csr_copies(mat, len(lays))], 100)
            bound_ms, bound_by, nbytes, flops, gathered = spmm_bound(
                mat, 4 if f32 else 8)
            label = orient if f32 else f"f64 {orient}"
            extra = ("" if plain_ms is None else
                     f", plain {plain_ms:.4f} ms, cuSPARSE SpMM (CSR @ "
                     f"dense) {library_ms:.4f} ms")
            print(f"{SPMM['name']} {label:7s} {mat.block_shape} B={BATCH}: "
                  f"kernel {ms:.4f} ms (L2-warm {warm_ms:.4f} ms){extra}, "
                  f"bound {bound_ms:.4f} ms ({nbytes} bytes, {flops} flops;"
                  f" {bound_by}), {gathered} bytes of x gathered through L2;"
                  f" kernel at {bound_ms / ms:.1%} of bound", flush=True)
            out[label] = dict(ms=ms, warm_ms=warm_ms, plain_ms=plain_ms,
                              library_ms=library_ms, bound_ms=bound_ms,
                              bound_by=bound_by, gathered_bytes=gathered)
            del lays, args
    return out


# ---------------------------------------------------------------------------
# 9. The MIP path
# ---------------------------------------------------------------------------

# The B&B root's own device-FJ call (branch_and_bound.py, the root gate)
FJ_CALL = dict(n_seeds=64, steps_per_round=128, max_rounds=40)
FJ_INSTANCES = ("edge_packing_300_s15", "set_cover_400x150_s3")
FJ_TIMED_ROUNDS = 5
# Battery instances (miplib_like_battery at the scale given) with their
# time limits: three that the JAX package solved to OPTIMAL at scale 1.0
# (MIPLIB_r02.json), among them the mixed-integer fixed_charge_60_s7
# (continuous flows, binary opens), which closes in 161 nodes after about
# 74 s of f32 PDHG node LPs on the card (PERF.md §6).
PDHG_MIPS = ((1.0, "gap_20x5_s10", 60.0), (1.0, "set_cover_150x60_s1", 90.0),
             (1.0, "fixed_charge_60_s7", 180.0))
# The instance that node_lp="auto" routes to the PDHG backend (m = 1,500)
DEFAULT_MIP = "edge_packing_300_s15"
# 35 s (60 s before phase 17 needed the room); the root's
# heuristics take a share of the limit, and the tree still sends node-LP
# batches to the card after the root.  HiGHS's reference limit beside the
# time-limited solves: 10 s (20 s before phase 17)
DEFAULT_MIP_LIMIT = 35.0
HIGHS_LIMIT = 10.0


def battery(scale: float = 1.0) -> dict:
    return {qp.name: qp for qp in miplib_like_battery(scale)}


def highs_mip(qp, time_limit=None):
    """HiGHS (scipy's milp) on the minimization form: (objective in the
    model's own sense, or None, and HiGHS's status message)."""
    qpm = qp.as_minimization()
    res = milp(qpm.objective_vector,
               constraints=LinearConstraint(qpm.constraint_matrix,
                                            qpm.constraint_lower,
                                            qpm.constraint_upper),
               bounds=Bounds(qpm.variable_lower, qpm.variable_upper),
               integrality=np.asarray(qpm.integrality, dtype=int),
               options={} if time_limit is None
               else {"time_limit": time_limit})
    obj = None if res.x is None else float(
        (-1.0 if qp.maximize else 1.0) * (qpm.objective_vector @ res.x))
    return obj, res.message


def mip_violations(qp, x) -> dict:
    """The largest violations of ``x`` in the model's space: of a row,
    absolute and relative to 1 + the row's largest finite bound (the B&B's
    own solution checker, ``branch_and_bound._check_feasible``), of a
    variable bound, and of integrality."""
    ax = qp.constraint_matrix @ x
    lo, hi = qp.constraint_lower, qp.constraint_upper
    row = np.maximum(np.maximum(lo - ax, ax - hi), 0.0)
    scale = 1.0 + np.maximum(np.abs(np.where(np.isfinite(lo), lo, 0.0)),
                             np.abs(np.where(np.isfinite(hi), hi, 0.0)))
    bound = np.maximum(np.maximum(qp.variable_lower - x,
                                  x - qp.variable_upper), 0.0)
    integ = np.asarray(qp.integrality, dtype=bool)
    frac = np.abs(x[integ] - np.round(x[integ]))
    return dict(row=float(row.max(initial=0.0)),
                row_rel=float((row / scale).max(initial=0.0)),
                bound=float(bound.max(initial=0.0)),
                integrality=float(frac.max(initial=0.0)))


def mip_feasible(qp, x, tol=1e-6) -> bool:
    """A numpy check of ``x`` against the B&B's feasibility contract
    (``MipParams.feasibility_tol``): every row within tol·(1 + its largest
    finite bound), every variable bound within tol, every integer variable
    within tol of an integer."""
    v = mip_violations(qp, x)
    return v["row_rel"] <= tol and v["bound"] <= tol and v["integrality"] <= tol


def fj_feasible_start(qp_min) -> np.ndarray:
    """The all-zeros or all-ones point, whichever is feasible (a packing's
    empty set, a cover's full set): the search starts from a verified
    incumbent, as the B&B's root call does."""
    for x0 in (np.zeros(qp_min.num_variables), np.ones(qp_min.num_variables)):
        if mip_feasible(qp_min, x0):
            return x0
    raise SmokeFailure(f"{qp_min.name}: no trivial feasible start")


def device_fj_rounds(qp) -> None:
    """The device FJ at the B&B root's call shape, in objective-descent
    mode from a feasible start: a round under the sync debug mode (a host
    read inside it raises), the device time of single rounds (CUDA
    events), the peak memory of a round and the size of its [S, m, n]
    temporaries; then the whole call, whose solutions must pass a numpy
    check of the rows, binarity and the cutoff."""
    qp_min = qp.as_minimization()
    c = qp_min.objective_vector
    x0 = fj_feasible_start(qp_min)
    obj0 = float(c @ x0)
    cutoff = obj0 - max(1e-6, 1e-4 * abs(obj0))
    a2, lb2, ub2 = fj_device.objective_descent_system(
        qp_min.constraint_matrix, qp_min.constraint_lower,
        qp_min.constraint_upper, c, cutoff)
    a_d = np.ascontiguousarray(a2.toarray(), dtype=np.float32)
    m, n = a_d.shape
    sys_ = fj_device.make_system(a_d, lb2, ub2, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    st = fj_device.initial_state(sys_, FJ_CALL["n_seeds"], gen, x0)
    steps = FJ_CALL["steps_per_round"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fj_device.run_round(sys_, st, gen, steps, 0.3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    ms = []
    for _ in range(FJ_TIMED_ROUNDS):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fj_device.run_round(sys_, st, gen, steps, 0.3)
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
    x = st.x.cpu().numpy()
    require(bool(np.allclose(st.act.cpu().numpy(), x @ a_d.T, rtol=1e-5,
                             atol=1e-3)),
            f"{qp.name}: device FJ activities drifted from A x")
    temp = FJ_CALL["n_seeds"] * m * n * 4
    del sys_, st
    res = fj_device.device_feasibility_jump(a2, lb2, ub2, x0=x0, **FJ_CALL)
    for xs in res.solutions:
        require(mip_feasible(qp_min, xs) and float(c @ xs) <= cutoff + 1e-6,
                f"{qp.name}: a device-FJ solution fails the numpy check")
    best = min((float(c @ xs) for xs in res.solutions), default=None)
    print(f"device FJ {qp.name} ({m} x {n} with the cutoff row, "
          f"S={FJ_CALL['n_seeds']}, {steps} steps a round): a round under "
          f"sync debug mode 'error' raised nothing; device ms per round "
          f"{', '.join(f'{v:.3f}' for v in ms)} (CUDA events); peak memory "
          f"of a round {peak} bytes, one [S, m, n] f32 temporary {temp} "
          f"bytes; the call: {res.rounds_run} rounds, "
          f"{res.moves_per_second:.1f} moves/s, {res.wall_time_sec:.3f} s, "
          f"{len(res.solutions)} verified solutions, start {obj0!r}, "
          f"cutoff {cutoff!r}, best {best!r} (minimization form)",
          flush=True)
    require(bool(res.solutions),
            f"{qp.name}: the device FJ found no improving solution")


class _CallLog:
    """For the length of a solve, wraps PdhgNodeBackend.solve and
    device_feasibility_jump to record each call's start and end (host
    clock) with the node LPs it held or the rounds it ran, the scaled
    problem of the first ``BatchSolver`` the solve used, and the class of
    each node backend that the B&B's ``choose_backend`` built; zeroes the
    launch, solver and capture counters on entry."""

    def __enter__(self):
        self.batches, self.fj = [], []  # (start, end, node LPs / rounds)
        self.backends = []
        self.prob = None
        self._solve = PdhgNodeBackend.solve
        self._fj = fj_device.device_feasibility_jump
        self._choose = bnb.choose_backend
        log = self

        def choose_(*a, **k):
            backend = log._choose(*a, **k)
            log.backends.append(type(backend).__name__)
            return backend

        def solve_(backend, lbs, *a, **k):
            t0 = time.perf_counter()
            res = log._solve(backend, lbs, *a, **k)
            log.batches.append((t0, time.perf_counter(), lbs.shape[0]))
            if log.prob is None:
                log.prob = backend._solver.prob
            return res

        def fj_(*a, **k):
            t0 = time.perf_counter()
            res = log._fj(*a, **k)
            log.fj.append((t0, time.perf_counter(), res.rounds_run))
            return res

        PdhgNodeBackend.solve = solve_
        fj_device.device_feasibility_jump = fj_
        bnb.choose_backend = choose_
        reset_counters()
        batched.solvers_built = 0
        pdlp_solver.capture_seconds = 0.0
        pdlp_solver.host_syncs = 0
        return self

    def __exit__(self, *exc):
        PdhgNodeBackend.solve = self._solve
        fj_device.device_feasibility_jump = self._fj
        bnb.choose_backend = self._choose

    def counts(self) -> dict:
        launches = _launches()
        node_lps = sum(n for _, _, n in self.batches)
        seconds = sum(t1 - t0 for t0, t1, _ in self.batches)
        return dict(
            launches=launches, batches=len(self.batches), node_lps=node_lps,
            largest_batch=max((n for _, _, n in self.batches), default=0),
            node_lps_per_s=node_lps / max(seconds, 1e-9),
            backend_seconds=seconds, solvers_built=batched.solvers_built,
            capture_seconds=pdlp_solver.capture_seconds,
            host_syncs=pdlp_solver.host_syncs, fj_calls=len(self.fj),
            fj_rounds=sum(r for _, _, r in self.fj),
            fj_seconds=sum(t1 - t0 for t0, t1, _ in self.fj))


def _root_share(log: _CallLog, t0: float, dt: float) -> tuple:
    """The root's seconds (until the first node-LP batch after the last
    device-FJ call, as ``default_mip`` reads it) and the device FJ's share
    of them."""
    fj_end = log.fj[-1][1] if log.fj else None
    tree = [b for b in log.batches if fj_end is not None and b[0] >= fj_end]
    root_s = (tree[0][0] if tree else t0 + dt) - t0
    fj_s = sum(t1 - s for s, t1, _ in log.fj)
    return root_s, fj_s / max(root_s, 1e-9)


def _add(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def node_lp_kernels(name: str, prob, errs: dict) -> None:
    """The kernels against their plain versions on the scaled matrices
    (A and Aᵀ, at the block shapes the solve picked) of the first
    ``BatchSolver`` a solve used: the SpMVs as in phase 3 and the SpMM at
    the node batch size, each in f32 and f64.  Run after the solve's
    counts are read."""
    require(prob is not None, f"{name}: no BatchSolver was used")
    for label, mat in (("A", prob.a), ("A^T", prob.at)):
        bm, bn = mat.block_shape
        plain = mat.without_tiled()
        tag = f"{name} {label} ({bm}x{bn})"
        check_built(tag, mat, errs, MipParams().node_batch_size)
        check_spmm(tag, plain, MipParams().node_batch_size, errs)


def pdhg_mip(scale: float, name: str, limit: float) -> dict:
    """``mip.solve`` with the PDHG node backend on a battery instance of
    ``miplib_like_battery(scale)`` under a ``limit``-second time limit,
    with HiGHS's optimum beside it; the counters are zeroed just before the
    solve and read just after.  Prints the run; returns the result, HiGHS's
    objective, the counts and the first BatchSolver's scaled problem."""
    qp = battery(scale)[name]
    ref, msg = highs_mip(qp)
    with _CallLog() as log:
        t0 = time.perf_counter()
        r = mip.solve(qp, MipParams(node_lp="pdhg", time_limit_sec=limit))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    cnt = log.counts()
    rel = (abs(r.objective_value - ref) / (1 + abs(ref))
           if ref is not None else float("nan"))
    viol = None if r.solution is None else mip_violations(qp, r.solution)
    print(f"mip.solve {name} ({qp.num_constraints} x "
          f"{qp.num_variables}, {int(np.sum(qp.integrality))} integer)"
          f", node_lp='pdhg', limit {limit} s: {r.status.name} "
          f"{r.objective_value!r}, HiGHS {ref!r} ({msg}; rel "
          f"{rel:.2e}), bound {r.best_bound!r}, {dt:.3f} s, violations "
          f"{viol}; {r.num_nodes} nodes, {cnt['batches']} node-LP batches "
          f"(largest "
          f"{cnt['largest_batch']} node LPs), {cnt['node_lps']} node LPs in "
          f"{cnt['backend_seconds']:.3f} s of backend calls "
          f"({cnt['node_lps_per_s']:.1f} node LPs/s), "
          f"{cnt['solvers_built']} BatchSolvers built, capture "
          f"{cnt['capture_seconds']:.3f} s, host syncs "
          f"{cnt['host_syncs']}; launches {cnt['launches']}", flush=True)
    return dict(qp=qp, result=r, ref=ref, rel=rel, counts=cnt,
                prob=log.prob)


def pdhg_mips(errs: dict, cases=PDHG_MIPS) -> dict:
    """``pdhg_mip`` on each case ((scale, name, time limit)), each to
    OPTIMAL within 1e-4(1+|ref|) of HiGHS with a solution that passes the
    numpy check, at least one of them with a node-LP batch of more than one
    node; then the kernels on each solve's node-LP matrices.  Returns the
    launches summed."""
    total, largest = {}, 0
    for scale, name, limit in cases:
        run = pdhg_mip(scale, name, limit)
        r, ref, cnt = run["result"], run["ref"], run["counts"]
        _add(total, cnt["launches"])
        require(r.status.name == "OPTIMAL",
                f"{name}: not OPTIMAL through the PDHG node backend")
        require(ref is not None and run["rel"] <= 1e-4,
                f"{name}: objective disagrees with HiGHS")
        require(mip_feasible(run["qp"], r.solution),
                f"{name}: the solution fails the numpy check: "
                f"{mip_violations(run['qp'], r.solution)}")
        require(cnt["batches"] > 0 and batched_products(cnt["launches"]) > 0,
                f"{name}: no node-LP batch went through an SpMM")
        largest = max(largest, cnt["largest_batch"])
        node_lp_kernels(name, run["prob"], errs)
    require(largest > 1, "no OPTIMAL solve sent a batch of several node LPs")
    return total


def default_mip(errs: dict, name=DEFAULT_MIP,
                limit=DEFAULT_MIP_LIMIT) -> dict:
    """``mip.solve`` under MipParams' defaults (node_lp and device_fj
    "auto") on the battery instance that the auto rule sends to the PDHG
    backend: a verified incumbent, a valid bound, the device FJ run; its
    root time and the device FJ's share of it; HiGHS under a time limit
    beside it; then the kernels on its node-LP matrices.  Returns the
    launches."""
    qp = battery()[name]
    with ThreadPoolExecutor(1) as pool, _CallLog() as log:
        highs = pool.submit(highs_mip, qp, HIGHS_LIMIT)
        t0 = time.perf_counter()
        r = mip.solve(qp, MipParams(time_limit_sec=limit))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ref, msg = highs.result()
    cnt = log.counts()
    root_s, fj_share = _root_share(log, t0, dt)
    obj = r.objective_value
    print(f"mip.solve {name} ({qp.num_constraints} x {qp.num_variables}) "
          f"under MipParams defaults, limit {limit} s: {r.status.name} "
          f"{obj!r}, bound {r.best_bound!r}, {r.num_nodes} nodes, {dt:.3f} "
          f"s ({dt - limit:+.3f} s past the limit); HiGHS with "
          f"{HIGHS_LIMIT} s: {ref!r} ({msg}); root {root_s:.3f} s, device "
          f"FJ {cnt['fj_calls']} calls, {cnt['fj_rounds']} rounds, "
          f"{cnt['fj_seconds']:.3f} s ({fj_share:.1%} of the root); {cnt['batches']} node-LP batches (largest "
          f"{cnt['largest_batch']}), {cnt['node_lps']} node LPs ({cnt['node_lps_per_s']:.1f}/s), "
          f"{cnt['solvers_built']} BatchSolvers built, capture "
          f"{cnt['capture_seconds']:.3f} s; launches {cnt['launches']}",
          flush=True)
    require(r.status.name in ("OPTIMAL", "FEASIBLE"),
            f"{name}: no incumbent under the defaults")
    require(mip_feasible(qp, r.solution)
            and abs(float(qp.objective_vector @ r.solution) - obj)
            <= 1e-9 * (1 + abs(obj)),
            f"{name}: the incumbent fails the numpy check: "
            f"{mip_violations(qp, r.solution)}")
    # the bound in the model's own sense: above the objective for a
    # maximization, below it for a minimization
    sense = -1.0 if qp.maximize else 1.0
    require(sense * r.best_bound <= sense * obj + 1e-6 * (1 + abs(obj)),
            f"{name}: the bound is not valid")
    require(cnt["fj_calls"] > 0, f"{name}: the device FJ did not run")
    require(cnt["batches"] > 0, f"{name}: no node-LP batch on the card")
    node_lp_kernels(name, log.prob, errs)
    return cnt["launches"]


def mip_path(errs: dict) -> dict:
    """Phase 9.  Returns the launches of the MIP path (the PDHG solves and
    the default path); the kernels' errors on its node-LP matrices go into
    ``errs``."""
    bat = battery()
    for name in FJ_INSTANCES:
        device_fj_rounds(bat[name])
    launches = pdhg_mips(errs)
    _add(launches, default_mip(errs))
    print(f"launches on the MIP path: {launches}", flush=True)
    require(exact_spmvs(launches) > 0 and batched_products(launches) > 0,
            f"a kernel of the MIP path was not launched: {launches}")
    return launches


# ---------------------------------------------------------------------------
# 10. The front end: MPS I/O, Model/Solver, the CLI, math_opt, knapsack and
#     set cover
# ---------------------------------------------------------------------------

FRONTEND_DIR = ROOT / "build" / "frontend"
# The CLI's moderate LP and battery MIP, and the glop route's LP: the
# host simplex (a copy of the JAX package's) ends ABNORMAL on the 2048^2
# moderate LPs, as on every LP of 256 rows or more tried
CLI_LP_SEED = 1
GLOP_LP = dict(m=128, n=256, num_blocks=8, block_shape=(8, 128), seed=1)
CLI_MIP = "gap_20x5_s10"
DP_ITEMS, DP_CAPACITY, DP_MAX = 1000, 1_000_000, 10_000
MULTI_KNAPSACK = dict(dims=3, items=40, seed=5)
COVER_MIP = "set_cover_150x60_s1"


class _Results:
    """For its length, wraps ``module.solve`` (a package attribute that the
    front end imports at call time) to keep each call's QP and result,
    and to hand the first QP to ``on_first`` before it is solved."""

    def __init__(self, module, on_first=None):
        self.module, self.on_first = module, on_first
        self.qps, self.results = [], []

    def __enter__(self):
        self._solve = inner = self.module.solve

        def solve_(qp, *a, **k):
            if not self.qps and self.on_first is not None:
                self.on_first(qp)
            self.qps.append(qp)
            r = inner(qp, *a, **k)
            self.results.append(r)
            return r
        self.module.solve = solve_
        return self

    def __exit__(self, *exc):
        self.module.solve = self._solve


def _same_qp(a: QuadraticProgram, b: QuadraticProgram) -> list:
    """The fields of two QPs that differ (names aside); the matrices must
    have the same CSR arrays."""
    bad = [f for f in ("objective_vector", "constraint_lower",
                       "constraint_upper", "variable_lower", "variable_upper")
           if not np.array_equal(getattr(a, f), getattr(b, f))]
    ma, mb = sp.csr_matrix(a.constraint_matrix), sp.csr_matrix(
        b.constraint_matrix)
    if not (ma.shape == mb.shape and all(
            np.array_equal(getattr(ma, f), getattr(mb, f))
            for f in ("indptr", "indices", "data"))):
        bad.append("constraint_matrix")
    if a.objective_constant != b.objective_constant or (
            a.maximize != b.maximize):
        bad.append("objective_constant/maximize")
    return bad


def mps_round_trip(bench_qp):
    """(a) The bench LP written with ``write_mps``, read back with
    ``Model.import_from_mps_file`` and ``to_qp``: equal to the generated QP
    exactly.  Returns the imported Model."""
    FRONTEND_DIR.mkdir(parents=True, exist_ok=True)
    path = FRONTEND_DIR / "bench.mps"
    t0 = time.perf_counter()
    write_mps(bench_qp, str(path))
    t_write = time.perf_counter() - t0
    size = path.stat().st_size
    t0 = time.perf_counter()
    model = Model.import_from_mps_file(str(path))
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    qp = model.to_qp()
    t_qp = time.perf_counter() - t0
    path.unlink()
    bad = _same_qp(bench_qp, qp)
    print(f"MPS round trip of the bench LP ({bench_qp.constraint_matrix.nnz}"
          f" nonzeros): {size} bytes; write_mps {t_write:.3f} s, "
          f"Model.import_from_mps_file {t_read:.3f} s, to_qp {t_qp:.3f} s; "
          f"fields that differ: {bad or 'none'}", flush=True)
    require(not bad, f"the MPS round trip changed the bench LP: {bad}")
    return model


def front_end_bench(model, bench_qp) -> dict:
    """(b) ``Solver("pdlp")`` on the imported bench model at the bench's
    parameters, against ``pdlp.solve`` on the generated QP: the same
    termination and iterations, the solutions bit for bit, and both SpMV
    kernels launched by the front end's solve.  Returns its launches."""
    kw = dict(iteration_limit=BENCH_ITERATION_LIMIT, block_shape=(8, 128))
    torch.cuda.synchronize()
    reset_counters()
    with _Results(pdlp_pkg) as log:
        t0 = time.perf_counter()
        s = Solver("pdlp")
        status = s.solve(model, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = _launches()
    r = log.results[-1]
    ref = solve(bench_qp, PdhgParams(dtype=torch.float32, **kw))
    same = (np.array_equal(r.primal_solution, ref.primal_solution)
            and np.array_equal(r.dual_solution, ref.dual_solution))
    print(f"Solver('pdlp') on the imported bench model: {status.name} "
          f"({r.termination_reason.name} after {r.iterations} iterations, "
          f"dtype {r.primal_solution.dtype}), {dt:.3f} s, objective "
          f"{s.objective_value!r}; pdlp.solve on the generated QP: "
          f"{ref.termination_reason.name} after {ref.iterations} "
          f"iterations, {ref.solve_time_sec:.3f} s, objective "
          f"{ref.primal_objective!r}; solutions bit "
          f"for bit: {same}; launches {launches}", flush=True)
    require(r.termination_reason == ref.termination_reason
            and r.iterations == ref.iterations == BENCH_ITERATION_LIMIT,
            "the front end's bench solve ended otherwise than pdlp.solve's")
    require(same, "the front end's bench solution differs from pdlp.solve's")
    require(s.objective_value == ref.primal_objective,
            "the front end's objective differs from pdlp.solve's")
    require(launches["block_spmv_exact"] > 0
            and launches["block_spmv_fast"] > 0,
            f"the front end's solve did not launch both SpMVs: {launches}")
    return launches


def _cli(label: str, path: Path, solver: str, sol: Path = None) -> tuple:
    """``python -m ortools_tpu_torch solve`` in a subprocess from the
    checkout; returns (status, objective, seconds)."""
    cmd = [sys.executable, "-m", "ortools_tpu_torch", "solve", "--input",
           str(path), "--solver", solver]
    if sol is not None:
        cmd += ["--sol_file", str(sol)]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=600)
    dt = time.perf_counter() - t0
    lines = dict(ln.split(":", 1) for ln in proc.stdout.splitlines()
                 if ":" in ln)
    status = lines.get("Status", "").strip()
    obj = float(lines["Objective"]) if "Objective" in lines else math.nan
    print(f"python -m ortools_tpu_torch solve --solver {solver} ({label}): "
          f"exit {proc.returncode} in {dt:.3f} s (a new process: torch "
          f"import, kernel load, MPS read, solve); Status {status}, "
          f"Objective {obj!r}; {lines.get('Parse time', '').strip()}",
          flush=True)
    require(proc.returncode == 0 and status == "OPTIMAL",
            f"the CLI's {solver} run failed: {proc.stderr[-2000:]}")
    return status, obj, dt


def cli_runs() -> None:
    """(c) The CLI as users run it, kernels built: moderate LP seed
    ``CLI_LP_SEED`` under pdlp (OPTIMAL against HiGHS, the .sol file's
    values checked against the rows and bounds), GLOP_LP under glop
    (OPTIMAL at HiGHS's objective), and ``CLI_MIP`` (INTORG markers) under
    mip, OPTIMAL at milp's objective."""
    FRONTEND_DIR.mkdir(parents=True, exist_ok=True)
    lp = block_random_lp(**MODERATE, seed=CLI_LP_SEED)
    lp_path = FRONTEND_DIR / "moderate.mps"
    write_mps(lp, str(lp_path))
    sol = FRONTEND_DIR / "moderate.sol"
    ref = moderate_refs([CLI_LP_SEED])[CLI_LP_SEED]
    _, obj, _ = _cli(f"moderate LP seed {CLI_LP_SEED}", lp_path, "pdlp", sol)
    rows = [ln.split() for ln in sol.read_text().splitlines()]
    names = [r[0] for r in rows[1:]]
    x = np.array([float(r[1]) for r in rows[1:]])
    require(rows[0][0] == "=obj=" and len(set(names)) == len(x)
            == lp.num_variables, "the .sol file does not hold every variable")
    ax = lp.constraint_matrix @ x
    row_viol = float(np.max(ax - lp.constraint_upper, initial=0.0))
    bound_viol = float(max(np.max(lp.variable_lower - x, initial=0.0),
                           np.max(x - lp.variable_upper, initial=0.0)))
    scale = 1.0 + float(np.max(np.abs(lp.constraint_upper)))
    # the f32 solve's values, unscaled: a bound holds to f32 rounding
    bscale = 1.0 + float(np.max(np.abs(lp.variable_upper)))
    rel = abs(obj - ref) / (1 + abs(ref))
    print(f"  pdlp: HiGHS {ref!r} (rel {rel:.2e}); .sol: {len(x)} values, "
          f"largest row violation {row_viol:.3e} (<= {1e-4 * scale:.3e}), "
          f"bound violation {bound_viol:.3e} (<= {1e-5 * bscale:.3e}), c.x "
          f"{float(lp.objective_vector @ x)!r}", flush=True)
    require(rel <= 1e-4, "the CLI's pdlp objective disagrees with HiGHS")
    require(row_viol <= 1e-4 * scale and bound_viol <= 1e-5 * bscale,
            "the CLI's pdlp solution violates the rows or bounds")
    glp = block_random_lp(**GLOP_LP)
    glp_path = FRONTEND_DIR / "glop.mps"
    write_mps(glp, str(glp_path))
    gref = highs_objective(glp)
    _, gobj, _ = _cli(f"block_random_lp {GLOP_LP}", glp_path, "glop")
    print(f"  glop: HiGHS {gref!r} (rel {abs(gobj - gref) / (1 + abs(gref)):.2e})")
    require(abs(gobj - gref) <= 1e-9 * (1 + abs(gref)),
            "the CLI's glop objective disagrees with HiGHS")
    mqp = battery()[CLI_MIP]
    mip_path_ = FRONTEND_DIR / f"{CLI_MIP}.mps"
    write_mps(mqp, str(mip_path_))
    require("'INTORG'" in mip_path_.read_text(),
            "the MIP's MPS file has no INTORG marker")
    mref, msg = highs_mip(mqp)
    _, mobj, _ = _cli(CLI_MIP, mip_path_, "mip")
    print(f"  mip: milp {mref!r} ({msg})")
    require(mref is not None and abs(mobj - mref) <= 1e-6 * (1 + abs(mref)),
            "the CLI's mip objective disagrees with milp")


def math_opt_pdlp() -> dict:
    """(d) ``math_opt.solve(..., PDLP)`` on moderate LP seed
    ``CLI_LP_SEED``, built through math_opt's API: OPTIMAL against HiGHS.
    Returns its launches."""
    lp = block_random_lp(**MODERATE, seed=CLI_LP_SEED)
    mo = math_opt.Model(name="moderate")
    xs = [mo.add_variable(lb=lo, ub=hi)
          for lo, hi in zip(lp.variable_lower, lp.variable_upper)]
    a = sp.csr_matrix(lp.constraint_matrix)
    for i in range(lp.num_constraints):
        k = slice(a.indptr[i], a.indptr[i + 1])
        mo.add_linear_constraint(
            LinearExpr(dict(zip(a.indices[k].tolist(), a.data[k].tolist()))),
            ub=float(lp.constraint_upper[i]))
    mo.minimize(LinearExpr(dict(enumerate(lp.objective_vector.tolist()))))
    ref = moderate_refs([CLI_LP_SEED])[CLI_LP_SEED]
    reset_counters()
    t0 = time.perf_counter()
    r = math_opt.solve(mo, math_opt.SolverType.PDLP)
    dt = time.perf_counter() - t0
    launches = _launches()
    rel = abs(r.objective_value() - ref) / (1 + abs(ref))
    print(f"math_opt.solve(PDLP) on moderate LP seed {CLI_LP_SEED}: "
          f"{r.termination.reason.name} {r.objective_value()!r}, HiGHS "
          f"{ref!r} (rel {rel:.2e}), {dt:.3f} s; value of x0 "
          f"{r.value(xs[0])!r}; launches {launches}", flush=True)
    require(r.termination.reason == math_opt.TerminationReason.OPTIMAL
            and rel <= 1e-4, "math_opt's PDLP solve disagrees with HiGHS")
    return launches


def numpy_knapsack(p, w, cap) -> int:
    """The value-only knapsack DP in numpy (int64), the reference."""
    dp = np.zeros(cap + 1, dtype=np.int64)
    cand = np.empty_like(dp)
    for wi, pi in zip(w, p):
        if wi <= cap:
            np.add(dp[:cap + 1 - wi], pi, out=cand[wi:])
            np.maximum(dp[wi:], cand[wi:], out=dp[wi:])
    return int(dp[cap])


def dp_knapsack_card() -> None:
    """(d) ``dp_knapsack_torch`` at DP_ITEMS items, capacity DP_CAPACITY:
    the table under ``torch.cuda.set_sync_debug_mode("error")`` (a host
    read inside raises), the value against numpy; then, warm, a whole
    call's time and peak memory, and under ``torch.profiler`` the table's
    device kernels per item and their summed device time.  (More than a
    thousand launches fill the launch queue, so events around the table
    time the host's enqueue, not the card.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(0)
    w = rng.integers(1, DP_MAX + 1, DP_ITEMS)
    p = rng.integers(1, DP_MAX + 1, DP_ITEMS)
    t0 = time.perf_counter()
    want = numpy_knapsack(p.tolist(), w.tolist(), DP_CAPACITY)
    t_np = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        table = dp_knapsack_table(p, w, DP_CAPACITY)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = int(table[-1])
    del table
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    again = dp_knapsack_torch(p, w, DP_CAPACITY)
    t_call = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dp_knapsack_table(p, w, DP_CAPACITY)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    seen = (f"device {device_ms:.3f} ms summed over {len(kernels)} kernels,"
            f" {len(kernels) / DP_ITEMS:.3f} an item (torch.profiler)"
            if kernels else "the profiler saw no device kernel: device time "
            "and kernels per item not measured")
    print(f"dp_knapsack_torch, {DP_ITEMS} items, capacity {DP_CAPACITY}, "
          f"weights and profits 1-{DP_MAX} (seed 0): {got} (numpy {want}, "
          f"{t_np:.3f} s); the table under sync debug mode 'error' raised "
          f"nothing; a whole warm call {t_call * 1e3:.3f} ms (host clock, "
          f"one read at the end), peak memory {peak} bytes; {seen}",
          flush=True)
    require(got == want == again, "dp_knapsack_torch disagrees with numpy")


def knapsack_and_cover() -> dict:
    """(d) ``KnapsackSolver``'s multi-dimensional MIP fallback and
    ``solve_set_cover_mip`` on COVER_MIP's matrix, each OPTIMAL at milp's
    objective.  Returns their launches."""
    total = {}
    spec = MULTI_KNAPSACK
    rng = np.random.default_rng(spec["seed"])
    p = rng.integers(1, 100, spec["items"])
    w = rng.integers(1, 50, (spec["dims"], spec["items"]))
    c = (w.sum(axis=1) * 3) // 10
    ref = milp(-p.astype(float), constraints=LinearConstraint(
        w.astype(float), -np.inf, c.astype(float)), bounds=Bounds(0, 1),
        integrality=np.ones(spec["items"]))
    reset_counters()
    ks = KnapsackSolver(KnapsackSolver.KNAPSACK_MULTIDIMENSION_CBC_MIP_SOLVER)
    ks.init(p.tolist(), w.tolist(), c.tolist())
    with _Results(mip) as log:
        t0 = time.perf_counter()
        value = ks.solve()
        dt = time.perf_counter() - t0
    _add(total, _launches())
    sel = np.array([ks.best_solution_contains(i)
                    for i in range(spec["items"])])
    r = log.results[-1]
    print(f"KnapsackSolver multi-dimensional ({spec}): {r.status.name} "
          f"{value}, milp {-ref.fun!r}, {r.num_nodes} nodes, {dt:.3f} s; "
          f"launches {_launches()}", flush=True)
    require(r.status.name == "OPTIMAL" and value == round(-ref.fun)
            and int(p[sel].sum()) == value
            and bool(np.all(w[:, sel].sum(axis=1) <= c)),
            "the multi-dimensional knapsack disagrees with milp")
    qp = battery()[COVER_MIP]
    a = sp.csc_matrix(qp.constraint_matrix)
    require(not qp.maximize and bool(np.all(a.data == 1.0))
            and bool(np.all(qp.constraint_lower == 1.0)),
            f"{COVER_MIP} is not a set cover")
    model = SetCoverModel()
    for j in range(a.shape[1]):
        model.add_empty_subset(float(qp.objective_vector[j]))
        for e in a.indices[a.indptr[j]:a.indptr[j + 1]]:
            model.add_element_to_last_subset(int(e))
    cref, msg = highs_mip(qp)
    reset_counters()
    with _Results(mip) as log:
        t0 = time.perf_counter()
        chosen = solve_set_cover_mip(model)
        dt = time.perf_counter() - t0
    _add(total, _launches())
    r = log.results[-1]
    cost = sum(model.costs[j] for j in chosen or [])
    covered = set().union(*(model.subsets[j] for j in chosen or []))
    print(f"solve_set_cover_mip on {COVER_MIP}'s matrix: {r.status.name}, "
          f"{len(chosen or [])} subsets, cost {cost!r}, milp {cref!r} "
          f"({msg}), {r.num_nodes} nodes, {dt:.3f} s; launches "
          f"{_launches()}", flush=True)
    require(r.status.name == "OPTIMAL" and cref is not None
            and abs(cost - cref) <= 1e-6 * (1 + abs(cref))
            and covered == set(range(model.num_elements)),
            "solve_set_cover_mip disagrees with milp")
    return total


def front_end(bench_qp) -> dict:
    """Phase 10.  Returns the launches of the front end's in-process
    solves (the CLI's subprocesses count their own)."""
    model = mps_round_trip(bench_qp)
    launches = front_end_bench(model, bench_qp)
    del model
    cli_runs()
    _add(launches, math_opt_pdlp())
    dp_knapsack_card()
    _add(launches, knapsack_and_cover())
    print(f"launches on the front end (in this process): {launches}",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# 11. The mesh: NCCL with one rank at full width, gloo ranks sharing the card
# ---------------------------------------------------------------------------


MESHES = (((1,), ("shards",)), ((1, 1), ("row", "col")))
GLOO_MESHES = (((2,), ("shards",)), ((2, 2), ("row", "col")))
MESH_SEED = 1  # the moderate LP of the gloo ranks


def _mesh_label(shape) -> str:
    return f"{len(shape)}-D {shape}"


def _same_result(r, ref) -> bool:
    return (r.termination_reason == ref.termination_reason
            and r.iterations == ref.iterations
            and r.primal_objective == ref.primal_objective
            and r.dual_objective == ref.dual_objective
            and np.array_equal(r.primal_solution, ref.primal_solution)
            and np.array_equal(r.dual_solution, ref.dual_solution))


def mesh_majors(prob, psum, params):
    """The solver's majors on one rank's ``prob`` under ``psum`` (None for
    the single path), loaded with the initial state from the seed-0
    power-iteration start."""
    g = torch.Generator(device="cpu").manual_seed(0)
    v0 = torch.randn(prob.c.shape[0], generator=g,
                     dtype=torch.float64).to(prob.c)
    sigma = pdlp_solver._make_power_iter(params, psum)(prob, v0)
    majors = pdlp_solver._Majors(prob, params, psum)
    majors.load(pdlp_solver._make_initial_state(params, psum)(prob, sigma))
    return majors


def collective_profile(majors) -> tuple:
    """Device time (ms) and count of the NCCL kernels in one replay of the
    major graph and the statistics graph, under torch.profiler, with the
    other kernels' time beside them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    nccl_ms, nccl_n, other_ms = 0.0, 0, 0.0
    for kind in ("main", "stats"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _graph(majors, kind, False).replay()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            ms = e.time_range.elapsed_us() / 1e3
            if "nccl" in e.name.lower():
                nccl_ms, nccl_n = nccl_ms + ms, nccl_n + 1
            else:
                other_ms += ms
    return nccl_ms, nccl_n, other_ms


def nccl_mesh(bench_qp) -> dict:
    """Phase 11a: a one-rank NCCL group on the card.  The bench LP through
    ``solve(mesh=...)``, 1-D and 2-D (1, 1), at phase 5's parameters, bit
    for bit the single path's exact stream; the launch counters set to 0
    just before each mesh solve and read just after.  Then the solver's
    majors on each: iter/s beside the single path's exact stream (turns),
    host syncs and host-side collective calls per replayed major, graphs
    captured, and the collectives' device time per major from the
    profiler.  Returns the mesh path's launches."""
    import torch.distributed as dist

    from ortools_tpu_torch.parallel import make_mesh

    params = PdhgParams(iteration_limit=BENCH_ITERATION_LIMIT,
                        record_iteration_stats=True, **BENCH_PARAMS)
    exact = dataclasses.replace(params, stream_precision="exact")
    store = Path(tempfile.mkdtemp(prefix="nccl-"))
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            world_size=1, rank=0)
    try:
        ref = solve(bench_qp, exact)
        print(f"single path, exact stream: {ref.termination_reason.name} "
              f"after {ref.iterations} iterations, objective "
              f"{ref.primal_objective!r}", flush=True)
        total = {k: 0 for k in _launches()}
        meshes = []
        for shape, names in MESHES:
            mesh = make_mesh(shape, names)
            pdlp_solver.host_syncs = 0
            reset_counters()
            r = solve(bench_qp, params, mesh=mesh)
            torch.cuda.synchronize()
            launches = _launches()
            _add(total, launches)
            streams = [rec["stream"] for rec in r.iteration_stats]
            same = _same_result(r, ref)
            print(f"mesh {_mesh_label(shape)} (NCCL, one rank): "
                  f"{r.termination_reason.name} after {r.iterations} "
                  f"iterations, objective {r.primal_objective!r}; bit for "
                  f"bit the single exact path: {same}; majors exact "
                  f"{streams.count('exact')} fast {streams.count('fast')}; "
                  f"host syncs {pdlp_solver.host_syncs}; launches "
                  f"{launches}", flush=True)
            require(same, f"mesh {shape}: the one-rank NCCL solve differs "
                    f"from the single path's exact stream")
            require(launches["block_spmv_exact"] > 0,
                    f"mesh {shape}: the exact SpMV was not launched")
            meshes.append((shape, mesh))
        mesh_rates(bench_qp, exact, meshes)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    print(f"launches on the mesh path (the NCCL solves): {total}",
          flush=True)
    return total


def mesh_rates(bench_qp, params, meshes) -> None:
    """Iter/s of the majors of the single exact path and of each one-rank
    mesh, in turns (single, meshes, meshes reversed, single), with host
    syncs and host-side collective calls per major; then each mesh's
    graphs and its collectives under the profiler."""
    runs = [("single", None, mesh_majors(
        pdlp_solver.build_device_problem(bench_qp, params, "cuda"), None,
        params))]
    for shape, mesh in meshes:
        prob, psum = pdlp_solver.build_mesh_problem(bench_qp, params, mesh)
        mesh.calls = 0
        majors = mesh_majors(prob, psum, params)
        majors.major()  # captures the graphs
        print(f"mesh {_mesh_label(shape)}: graphs captured "
              f"{len(majors._graphs)}, collective calls before the first "
              f"replay (power iteration, initial state, warm-up, capture) "
              f"{mesh.calls}", flush=True)
        runs.append((_mesh_label(shape), mesh, majors))
    runs[0][2].major()
    total = {label: [0.0, 0, 0] for label, _, _ in runs}
    for label, mesh, majors in runs + runs[::-1]:
        syncs0 = pdlp_solver.host_syncs
        calls0 = mesh.calls if mesh is not None else 0
        t0 = time.perf_counter()
        for _ in range(TIMED_MAJORS):
            majors.major()
        torch.cuda.synchronize()
        t = total[label]
        t[0] += time.perf_counter() - t0
        t[1] += pdlp_solver.host_syncs - syncs0
        t[2] += (mesh.calls - calls0) if mesh is not None else 0
        require(bool(torch.isfinite(majors.state.x).all()),
                f"{label} majors gave a non-finite iterate")
    freq = runs[0][2].freq
    for label, (dt, syncs, calls) in total.items():
        n = 2 * TIMED_MAJORS
        print(f"{label}: {n * freq / dt:.1f} PDHG iter/s (exact stream, "
              f"{dt / n * 1e3:.3f} ms per {freq}-step major); host syncs "
              f"per major {syncs / n:.2f}; host-side collective calls per "
              f"major {calls / n:.2f}", flush=True)
        if label != "single":
            require(syncs / n <= 1.0 + 1e-9 and calls == 0,
                    f"{label}: a replayed major read the host more than "
                    f"once or called a collective outside its graphs")
    for label, mesh, majors in runs[1:]:
        nccl_ms, nccl_n, other_ms = collective_profile(majors)
        print(f"{label}: collectives' device time per major (profiler, one "
              f"replay of the major and statistics graphs) {nccl_ms:.4f} ms"
              f" in {nccl_n} NCCL kernels, beside {other_ms:.3f} ms of the "
              f"other device work", flush=True)


# How far the f64 2-D mesh's iteration count may lie from the single exact
# path's, as a share of it.  Restarted PDHG's count in f64 moves by whole
# majors with the order of each product's sums, which every layout and
# mesh fixes in its own way: on moderate LP seed 1 the single path alone
# reads 4,288 to 4,480 iterations (4.5%) under the row kernel's team
# rules, 4,352 under the block kernel and 4,288 under the plain products
# on the CPU.  A tenth leaves twice that spread; the objective and the
# bit-for-bit match with the one-process solve are what hold the mesh's
# arithmetic.
F64_MESH_ITERATIONS = 0.1


def _gloo_rank(shape, names) -> dict:
    """One gloo rank of phase 11b, on the card it shares: the moderate LP
    in f32 through ``solve(mesh=...)`` (launch counters set to 0 just
    before, read just after), its shard's SpMVs against their plain
    versions as in phase 3, and on the 2-D mesh the same solve in f64."""
    from ortools_tpu_torch.parallel import make_mesh

    mesh = make_mesh(shape, names, device="cuda", backend="gloo")
    qp = block_random_lp(**MODERATE, seed=MESH_SEED)
    params = PdhgParams()
    reset_counters()
    r = solve(qp, params, mesh=mesh)
    torch.cuda.synchronize()
    launches = _launches()
    prob, _ = pdlp_solver.build_mesh_problem(qp, params, mesh)
    errs: dict = {}
    rank = tuple(mesh.coords)
    for label, mat in (("A", prob.a), ("A^T", prob.at)):
        check_built(f"rank {rank} shard {label}", mat, errs)
    r64 = (solve(qp, PdhgParams(dtype=torch.float64), mesh=mesh)
           if len(shape) == 2 else None)
    return dict(result=r, launches=launches, errs=errs, result64=r64)


class _Coords:
    """One rank's place on a mesh, without a process group: what
    ``build_mesh_problem`` reads to cut out that rank's part."""

    def __init__(self, shape, axis_names, coords):
        self.shape, self.axis_names, self.coords = shape, axis_names, coords
        self.size = math.prod(shape)

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]


def _sum_in_order(parts: list) -> torch.Tensor:
    # the gloo mesh's psum: the ranks' partials summed in the axis's order
    # (two partials: one rounding, alike on the host and on the card)
    return torch.stack(parts).sum(0)


def mesh_arithmetic_solve(qp, params, shape, names):
    """A one-process solve whose every product is the one the gloo mesh of
    ``shape`` computes: each rank's part of A (``build_mesh_problem`` at
    that rank's coordinates) times its piece of the vector by the kernel,
    the partials summed in the axis's order, the segments concatenated.
    Everything else is the single path's, so this solve differs from the
    single path only in the products' order of summation, and from the
    mesh's not at all: the mesh must give its result bit for bit."""
    qpm = qp.as_minimization()
    ranks = {c: pdlp_solver.build_mesh_problem(
        qpm, params, _Coords(shape, names, c), "cuda")[0]
        for c in np.ndindex(*shape)}
    if len(shape) == 1:
        def mv(x):
            return _sum_in_order([p.a.matvec(x) for p in ranks.values()])

        def rmv(y):
            return _sum_in_order([p.at.matvec(y) for p in ranks.values()])
    else:
        nr, nc = shape
        seg_m, seg_n = ranks[(0, 0)].a.padded_shape

        def mv(x):
            return torch.cat([_sum_in_order([
                ranks[(r, c)].a.matvec(x[c * seg_n:(c + 1) * seg_n])
                for c in range(nc)]) for r in range(nr)])

        def rmv(y):
            return torch.cat([_sum_in_order([
                ranks[(r, c)].at.matvec(y[r * seg_m:(r + 1) * seg_m])
                for r in range(nr)]) for c in range(nc)])

    make_matvecs = pdlp_solver._make_matvecs
    pdlp_solver._make_matvecs = lambda *a, **k: pdlp_solver._Matvecs(mv, rmv)
    try:
        single_shape = pdlp_solver.build_device_problem(
            qpm, params, "cpu").c.shape
        require(ranks[(0,) * len(shape)].c.shape == single_shape,
                f"mesh {shape}: the padded lengths are not the single "
                f"path's")
        return solve(qp, dataclasses.replace(params,
                                             stream_precision="exact"))
    finally:
        pdlp_solver._make_matvecs = make_matvecs


def gloo_ranks() -> dict:
    """Phase 11b: 1-D on 2 gloo ranks and 2-D (2, 2) on 4, both at once on
    the one card, on moderate LP seed 1.  In f32: OPTIMAL within
    1e-4 (1 + |ref|) of HiGHS, every rank's result bit for bit rank 0's
    and bit for bit ``mesh_arithmetic_solve``'s (one process, the mesh's
    order of summation in every product), every shard's SpMVs within
    phase 3's tolerances of their plain versions; the iteration count is
    printed beside the single exact path's.  In f64 (2-D): bit for bit
    its one-process solve too, its objective within 1e-6 of the single
    exact path's, and its count within ``F64_MESH_ITERATIONS`` of that
    path's.  Returns the kernels' largest shard errors."""
    from ortools_tpu_torch import graft_entry

    ref = moderate_refs([MESH_SEED])[MESH_SEED]
    qp = block_random_lp(**MODERATE, seed=MESH_SEED)
    t0 = time.perf_counter()
    jobs = [(shape, names, graft_entry.start_ranks(
        math.prod(shape), _gloo_rank, (shape, names), device="cuda",
        backend="gloo", timeout=400)) for shape, names in GLOO_MESHES]
    try:
        p64 = PdhgParams(dtype=torch.float64)
        single = solve(qp, PdhgParams(stream_precision="exact"))
        single64 = solve(qp, dataclasses.replace(p64,
                                                 stream_precision="exact"))
        same_sums = {shape: mesh_arithmetic_solve(qp, PdhgParams(), shape,
                                                  names)
                     for shape, names, _ in jobs}
        same_sums64 = {shape: mesh_arithmetic_solve(qp, p64, shape, names)
                       for shape, names, _ in jobs if len(shape) == 2}
        print(f"single path, exact stream: f32 {single.iterations} "
              f"iterations, f64 {single64.iterations}; one process with "
              f"each mesh's order of summation: f32 "
              f"{ {k: v.iterations for k, v in same_sums.items()} }, f64 "
              f"{ {k: v.iterations for k, v in same_sums64.items()} }",
              flush=True)
        results = [(shape, job.join()) for shape, _, job in jobs]
        print(f"both meshes done {time.perf_counter() - t0:.1f} s after "
              f"their ranks started", flush=True)
    finally:
        for _, _, job in jobs:
            job.kill()
    errs: dict = {}
    for shape, ranks in results:
        r0 = ranks[0]["result"]
        rel = abs(r0.primal_objective - ref) / (1 + abs(ref))
        alike = all(_same_result(k["result"], r0) for k in ranks[1:])
        same = _same_result(r0, same_sums[shape])
        ratio = r0.iterations / single.iterations
        print(f"mesh {_mesh_label(shape)} on {len(ranks)} gloo ranks sharing"
              f" the card, f32: {r0.termination_reason.name} after "
              f"{r0.iterations} iterations (single exact path "
              f"{single.iterations}, ratio {ratio:.3f}, within a quarter: "
              f"{abs(ratio - 1) <= 0.25}), objective {r0.primal_objective!r}"
              f" HiGHS {ref!r} (rel {rel:.2e}); ranks bit-identical: "
              f"{alike}; bit for bit the one-process solve with its order "
              f"of summation: {same}; launches by rank "
              f"{[k['launches'] for k in ranks]}", flush=True)
        require(r0.termination_reason == TerminationReason.OPTIMAL,
                f"mesh {shape}: not OPTIMAL")
        require(rel <= 1e-4, f"mesh {shape}: objective disagrees with HiGHS")
        require(alike, f"mesh {shape}: the ranks' results differ")
        require(same, f"mesh {shape}: the result differs from the one-"
                f"process solve with the mesh's order of summation")
        require(all(exact_spmvs(k["launches"]) > 0 for k in ranks),
                f"mesh {shape}: a rank launched no exact SpMV")
        r64 = ranks[0]["result64"]
        if r64 is not None:
            rel64 = abs(r64.primal_objective - single64.primal_objective) / (
                1 + abs(single64.primal_objective))
            alike64 = all(_same_result(k["result64"], r64) for k in ranks)
            same64 = _same_result(r64, same_sums64[shape])
            print(f"mesh {_mesh_label(shape)}, f64: "
                  f"{r64.termination_reason.name} after {r64.iterations} "
                  f"iterations (single exact path {single64.iterations}), "
                  f"objective rel to the single path {rel64:.2e}; ranks "
                  f"bit-identical: {alike64}; bit for bit the one-process "
                  f"solve with its order of summation: {same64}", flush=True)
            ratio64 = r64.iterations / single64.iterations
            require(r64.termination_reason == TerminationReason.OPTIMAL
                    and abs(ratio64 - 1) <= F64_MESH_ITERATIONS
                    and rel64 <= 1e-6,
                    f"mesh {shape}, f64: {r64.termination_reason.name} "
                    f"after {r64.iterations} iterations (ratio {ratio64:.3f}"
                    f" to the single path's {single64.iterations}, bound "
                    f"{F64_MESH_ITERATIONS}), objective rel {rel64:.2e}")
            require(alike64 and same64, f"mesh {shape}, f64: the ranks' "
                    f"results differ, or differ from the one-process solve")
        for k in ranks:
            for name, e in k["errs"].items():
                errs[name] = max(errs.get(name, 0.0), e)
    return errs


# ---------------------------------------------------------------------------
# 12. The host front ends that reach the card through mip.solve: bin
#     packing (assignment MIP, arc flow), BOP, MaxHS.  Matching is not on
#     the card: its blossom runs on the host, and its MIP fallback cannot
#     be reached on complete even graphs (CPU tests only).
# ---------------------------------------------------------------------------

# Falkenauer's "u" class: integer sizes uniform in [20, 100] from
# numpy.random.default_rng(seed), capacity 150
U_CAPACITY, U_LOW, U_HIGH, U_SEED = 150, 20, 100, 0
# u120's and the BOP portfolio's limits (U120, BOP_LIMIT): 10 s, as
# HiGHS's beside them, so that the whole run, phases 16 and 17 included,
# stays under 1,100 s (60 s, then 40 s for phase 16, 10 s for phase 17)
U120 = dict(items=120, lower_bound=49, ffd=50, limit=10.0)
# the arc-flow case of the same class (LB 24, FFD 25, 1,194 arcs); u120 is
# left out: solve_vector_bin_packing has no time limit (PERF.md §7)
U_ARC_FLOW = dict(items=60, nodes=120, arcs=1194, bins=24)
# tests/test_scheduling_packing.py's three arc-flow cases and their bins
ARC_FLOW_CASES = ((([10], [[6], [5], [4], [3], [2]], [1, 1, 1, 1, 1]), 2),
                  (([6], [[3]], [4]), 2),
                  (([5, 6], [[3, 1], [3, 5], [2, 4]], [1, 1, 1]), 2))
BOP_MIP, BOP_LIMIT = "edge_packing_300_s15", 10.0
INTEGRAL_MIP = "gap_20x5_s10"
# tests/test_max_hs.py::weighted_maxsat_model's size and two of its seeds
MAXSAT = dict(n=10, m=18, seeds=(0, 1))


def u_class(n: int, seed: int = U_SEED) -> list:
    return np.random.default_rng(seed).integers(
        U_LOW, U_HIGH + 1, size=n).tolist()


def check_packing(sizes: list, capacity: int, bins: list,
                  most: int) -> bool:
    """Every item in exactly one bin, no bin over its capacity, at most
    ``most`` bins."""
    items = sorted(i for b in bins for i in b)
    return (items == list(range(len(sizes))) and len(bins) <= most
            and all(sum(sizes[i] for i in b) <= capacity for b in bins))


def assignment_packing(errs: dict) -> dict:
    """(a) ``solve_bin_packing`` on u120 under U120's limit: the auto rule's
    backend, the SpMV and the SpMM launched and held to their plain
    versions on the first BatchSolver's scaled A and Aᵀ, the device FJ's
    calls and share of the root, the packing checked; HiGHS on the same
    assignment MIP (20 s, in a thread) beside it.  Returns the
    launches."""
    sizes = u_class(U120["items"])
    inst = BinPackingInstance(U_CAPACITY, sizes)
    lb, ffd = inst.lower_bound(), len(first_fit_decreasing(inst))
    require((lb, ffd) == (U120["lower_bound"], U120["ffd"]),
            f"u{U120['items']}: LB {lb}, FFD {ffd}")
    highs = []
    with ThreadPoolExecutor(1) as pool, _Results(
            mip, on_first=lambda qp: highs.append(
                pool.submit(highs_mip, qp, HIGHS_LIMIT))) as calls, \
            _CallLog() as log:
        t0 = time.perf_counter()
        packing = solve_bin_packing(inst, time_limit_sec=U120["limit"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ref, msg = highs[0].result()
    cnt = log.counts()
    qp, r = calls.qps[0], calls.results[-1]
    m, n = qp.num_constraints, qp.num_variables
    root_s, fj_share = _root_share(log, t0, dt)
    print(f"solve_bin_packing u{U120['items']} (capacity {U_CAPACITY}, "
          f"LB {lb}, FFD {ffd}; assignment MIP {m} x {n}, m(m+n) "
          f"{m * (m + n)}), limit {U120['limit']} s: "
          f"{None if packing is None else len(packing)} bins "
          f"({r.status.name}, bound {r.best_bound!r}, {r.num_nodes} nodes), "
          f"{dt:.3f} s; HiGHS with {HIGHS_LIMIT} s: {ref!r} ({msg}); "
          f"backends built {log.backends}; {cnt['batches']} node-LP batches "
          f"(largest {cnt['largest_batch']}), {cnt['node_lps']} node LPs "
          f"({cnt['node_lps_per_s']:.1f}/s), {cnt['solvers_built']} "
          f"BatchSolvers built, capture {cnt['capture_seconds']:.3f} s; "
          f"root {root_s:.3f} s, device FJ {cnt['fj_calls']} calls, "
          f"{cnt['fj_rounds']} rounds, {cnt['fj_seconds']:.3f} s "
          f"({fj_share:.1%} of the root); launches {cnt['launches']}",
          flush=True)
    require(log.backends[:1] == ["PdhgNodeBackend"],
            f"u{U120['items']}: the auto rule chose {log.backends[:1]}")
    require(exact_spmvs(cnt["launches"]) > 0
            and batched_products(cnt["launches"]) > 0,
            f"u{U120['items']}: a kernel was not launched: "
            f"{cnt['launches']}")
    if not cnt["fj_calls"]:
        # the root's device-FJ gate (branch_and_bound.py) needs an
        # incumbent to descend from; the assignment MIP does not start
        # from the FFD packing, and the JAX package finds none either
        print(f"u{U120['items']}: the device FJ did not run: the root had "
              f"no incumbent to descend from", flush=True)
    require(packing is None or check_packing(sizes, U_CAPACITY, packing,
                                             ffd),
            f"u{U120['items']}: the packing fails the check")
    node_lp_kernels(f"u{U120['items']}", log.prob, errs)
    return cnt["launches"]


def boolean_portfolio(errs: dict) -> dict:
    """(b) ``solve_boolean_lp`` on BOP_MIP under a BOP_LIMIT limit: the
    incumbent checked in numpy, the bound valid against HiGHS's HIGHS_LIMIT
    incumbent, the strategies' wins and the launches.  Returns them."""
    qp = battery()[BOP_MIP]
    with ThreadPoolExecutor(1) as pool, _CallLog() as log:
        highs = pool.submit(highs_mip, qp, HIGHS_LIMIT)
        t0 = time.perf_counter()
        r = solve_boolean_lp(qp, time_limit_sec=BOP_LIMIT)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ref, msg = highs.result()
    cnt = log.counts()
    x = r.solution
    print(f"solve_boolean_lp {BOP_MIP} ({qp.num_constraints} x "
          f"{qp.num_variables}, maximize), limit {BOP_LIMIT} s: "
          f"{r.status.name} {r.objective_value!r}, bound {r.best_bound!r}, "
          f"{dt:.3f} s; HiGHS with {HIGHS_LIMIT} s: {ref!r} ({msg}); "
          f"strategy_wins {r.strategy_wins}; backends built "
          f"{sorted(set(log.backends))}, {cnt['batches']} node-LP batches, "
          f"{cnt['node_lps']} node LPs, {cnt['solvers_built']} BatchSolvers "
          f"built, device FJ {cnt['fj_calls']} calls; launches "
          f"{cnt['launches']}", flush=True)
    require(x is not None and mip_feasible(qp, x)
            and abs(float(qp.objective_vector @ x) - r.objective_value)
            <= 1e-9 * (1 + abs(r.objective_value)),
            f"{BOP_MIP}: the portfolio's incumbent fails the numpy check")
    sense = -1.0 if qp.maximize else 1.0
    require(ref is not None
            and sense * r.best_bound <= sense * ref + 1e-6 * (1 + abs(ref)),
            f"{BOP_MIP}: the portfolio's bound {r.best_bound!r} cuts off "
            f"HiGHS's incumbent {ref!r}")
    node_lp_kernels(BOP_MIP, log.prob, errs)
    return cnt["launches"]


def integral_solver() -> dict:
    """(c) ``IntegralSolver`` on INTEGRAL_MIP, OPTIMAL at milp's objective.
    Returns its launches."""
    qp = battery()[INTEGRAL_MIP]
    ref, msg = highs_mip(qp)
    with _CallLog() as log:
        t0 = time.perf_counter()
        r = IntegralSolver(device="cuda").solve(qp)
        dt = time.perf_counter() - t0
    cnt = log.counts()
    x = None if r.solution is None else np.asarray(r.solution, float)
    print(f"IntegralSolver {INTEGRAL_MIP}: {r.status.name} "
          f"{r.objective_value!r}, milp {ref!r} ({msg}), {dt:.3f} s; "
          f"backends built {sorted(set(log.backends))}; device FJ "
          f"{cnt['fj_calls']} calls, {cnt['fj_seconds']:.3f} s; launches "
          f"{cnt['launches']}", flush=True)
    require(r.status.name == "OPTIMAL" and ref is not None
            and abs(r.objective_value - ref) <= 1e-4 * (1 + abs(ref))
            and mip_feasible(qp, x),
            f"{INTEGRAL_MIP}: IntegralSolver is not OPTIMAL at milp's "
            f"objective")
    return cnt["launches"]


def arc_flow_case(label: str, args: tuple, bins: int) -> dict:
    """``solve_vector_bin_packing`` on one case, equal to ``bins`` and to
    milp on the same arc-flow MIP.  Returns its launches."""
    with _Results(bnb) as calls, _CallLog() as log:
        t0 = time.perf_counter()
        got, g = solve_vector_bin_packing(*args)
        dt = time.perf_counter() - t0
    cnt = log.counts()
    qp, r = calls.qps[0], calls.results[-1]
    ref, msg = highs_mip(qp, 3 * HIGHS_LIMIT)
    print(f"solve_vector_bin_packing {label}: {got} bins ({r.status.name}, "
          f"{r.num_nodes} nodes), milp {ref!r} ({msg}), {dt:.3f} s; graph "
          f"{g.num_nodes} nodes, {len(g.arcs)} arcs; backends built "
          f"{sorted(set(log.backends))}; launches {cnt['launches']}",
          flush=True)
    require(r.status.name == "OPTIMAL" and got == bins and ref is not None
            and round(ref) == bins,
            f"arc flow {label}: {got} bins, milp {ref!r}, expected {bins}")
    return cnt["launches"]


def arc_flows() -> dict:
    """(d) tests/test_scheduling_packing.py's three cases and u60 (equal
    sizes merged, their count the demand).  Returns the launches."""
    total = {}
    for k, (args, bins) in enumerate(ARC_FLOW_CASES):
        _add(total, arc_flow_case(f"test case {k + 1}", args, bins))
    size, count = np.unique(u_class(U_ARC_FLOW["items"]), return_counts=True)
    args = ([U_CAPACITY], [[int(s)] for s in size], count.tolist())
    g = build_arc_flow_graph(*args)
    require((g.num_nodes, len(g.arcs))
            == (U_ARC_FLOW["nodes"], U_ARC_FLOW["arcs"]),
            f"u{U_ARC_FLOW['items']}: graph {g.num_nodes} x {len(g.arcs)}")
    _add(total, arc_flow_case(f"u{U_ARC_FLOW['items']}", args,
                              U_ARC_FLOW["bins"]))
    return total


def maxsat_model(seed: int, n: int = MAXSAT["n"], m: int = MAXSAT["m"]):
    """tests/test_max_hs.py::weighted_maxsat_model on the port's IR:
    random 3-clauses (bool_or) and unit soft weights in [1, 8]."""
    rng = np.random.default_rng(seed)
    clauses = []
    for _ in range(m):
        vs = rng.choice(n, 3, replace=False)
        signs = rng.integers(0, 2, 3)
        clauses.append([int(v) if s else -int(v) - 1
                        for v, s in zip(vs, signs)])
    w = rng.integers(1, 9, n)
    model = ir.CpModelIR(
        variables=[ir.IntegerVariableIR(f"x{i}", ir.Domain(0, 1))
                   for i in range(n)],
        constraints=[ir.ConstraintIR("bool_or", ir.BoolArgs(c))
                     for c in clauses],
        objective=ir.ObjectiveIR(vars=list(range(n)),
                                 coeffs=[int(v) for v in w]))
    return model, clauses, w


def maxsat_milp(clauses: list, w) -> tuple:
    """milp on the weighted max-SAT MIP: min w·x with each clause's
    positive literals plus its negated ones' complements at least 1."""
    a = np.zeros((len(clauses), len(w)))
    lo = np.ones(len(clauses))
    for r, c in enumerate(clauses):
        for lit in c:
            if lit >= 0:
                a[r, lit] += 1
            else:
                a[r, -lit - 1] -= 1
                lo[r] -= 1
    res = milp(np.asarray(w, float), constraints=LinearConstraint(
        a, lo, np.inf), bounds=Bounds(0, 1), integrality=np.ones(len(w)))
    return None if res.x is None else round(res.fun), res.message


def max_hs() -> dict:
    """(e) ``minimize_max_hs`` on MAXSAT's seeds: OPTIMAL with the bound
    equal to the objective and to milp's, or INFEASIBLE where milp finds
    none; each call's seconds and the device FJ's share.  Returns the
    launches."""
    total = {}
    for seed in MAXSAT["seeds"]:
        model, clauses, w = maxsat_model(seed)
        ref, msg = maxsat_milp(clauses, w)
        with _CallLog() as log:
            t0 = time.perf_counter()
            st, values, bound, conflicts = minimize_max_hs(model)
            dt = time.perf_counter() - t0
        cnt = log.counts()
        _add(total, cnt["launches"])
        obj = (None if values is None
               else int(np.asarray(w) @ np.asarray(values)))
        print(f"minimize_max_hs seed {seed} (n {MAXSAT['n']}, m "
              f"{MAXSAT['m']}): status {st}, objective {obj}, bound {bound}, "
              f"{conflicts} conflicts, milp {ref} ({msg}), {dt:.3f} s; "
              f"backends built {sorted(set(log.backends))}; device FJ "
              f"{cnt['fj_calls']} calls, {cnt['fj_seconds']:.3f} s "
              f"({cnt['fj_seconds'] / dt:.1%} of the call); launches "
              f"{cnt['launches']}", flush=True)
        require((st == 0 and ref is None)
                or (st == 1 and obj == bound == ref),
                f"MaxHS seed {seed}: status {st}, objective {obj}, bound "
                f"{bound}, milp {ref}")
    return total


def host_front_ends(errs: dict) -> dict:
    """Phase 12.  Returns the launches of its solves, each counted from 0
    just before the solve and read just after."""
    launches = assignment_packing(errs)
    _add(launches, boolean_portfolio(errs))
    _add(launches, integral_solver())
    _add(launches, arc_flows())
    _add(launches, max_hs())
    print(f"launches on the host front ends: {launches}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# 13. CP-SAT
# ---------------------------------------------------------------------------

FT10 = ROOT / "tests" / "data" / "ft10.jssp"
FT10_OPTIMUM = 930
FT10_LIMIT = 120.0
CP_MAXSAT_SEEDS = (1, 7)


def parse_jssp(text: str) -> list:
    """``num_jobs num_machines``, then one line of (machine, duration)
    pairs a job; '#' lines are comments."""
    rows = [[int(v) for v in ln.split()] for ln in text.splitlines()
            if ln.strip() and not ln.lstrip().startswith("#")]
    nj, nm = rows[0]
    return [[(r[2 * k], r[2 * k + 1]) for k in range(nm)]
            for r in rows[1:1 + nj]]


def jobshop_cp(jobs: list) -> tuple:
    """The interval + no_overlap job-shop model (scheduling/jobshop.py's CP
    route without the order booleans): a start and a fixed-size interval an
    operation, precedences within each job, one no_overlap a machine, and
    the makespan, the max of the jobs' last ends, minimized."""
    m = CpModel()
    horizon = sum(d for job in jobs for _, d in job)
    starts, machines, ends = [], {}, []
    for j, job in enumerate(jobs):
        row, prev = [], None
        for o, (mach, dur) in enumerate(job):
            s = m.new_int_var(0, horizon, f"s_{j}_{o}")
            machines.setdefault(mach, []).append(
                m.new_fixed_size_interval_var(s, dur, f"iv_{j}_{o}"))
            if prev is not None:
                m.add(s >= prev)
            prev = s + dur
            row.append(s)
        starts.append(row)
        ends.append(prev)
    for ivs in machines.values():
        m.add_no_overlap(ivs)
    makespan = m.new_int_var(0, horizon, "makespan")
    m.add_max_equality(makespan, ends)
    m.minimize(makespan)
    return m, starts, makespan


def check_schedule(jobs: list, starts: np.ndarray, makespan: int) -> None:
    """Every precedence and every machine checked in numpy, and the
    makespan the last end."""
    dur = np.array([[d for _, d in job] for job in jobs])
    mach = np.array([[mm for mm, _ in job] for job in jobs])
    ends = starts + dur
    require(bool((starts >= 0).all()), "a negative start")
    require(bool((starts[:, 1:] >= ends[:, :-1]).all()),
            "a job's operation starts before its predecessor ends")
    for k in np.unique(mach):
        s, e = starts[mach == k], ends[mach == k]
        order = np.argsort(s, kind="stable")
        require(bool((s[order][1:] >= e[order][:-1]).all()),
                f"machine {k} runs two operations at once")
    require(int(ends.max()) == makespan,
            f"makespan {makespan} is not the last end {int(ends.max())}")


class _Routes:
    """For the length of a CP-SAT solve, records which of ``solve_model``'s
    engines answered (returned something other than None): the pure-PB
    core, pure SAT, LCG, the integer encoding, the root LP, the node LP
    propagator, OLL, MaxHS and the DFS engine's search."""

    SPIES = (("pb", cp_pb_bridge, "try_pure_pb"),
             ("pure_sat", cp_pure_sat, "solve_pure_sat"),
             ("lcg", cp_lcg, "solve_lcg"),
             ("encoding", cp_encoding, "solve_integer_cdcl"),
             ("root_lp", cp_lp, "root_lp_relaxation"),
             ("node_lp", cp_lp, "NodeLpPropagator"),
             ("oll", cp_core_guided, "minimize_core_guided"),
             ("max_hs", cp_max_hs, "minimize_max_hs"),
             ("search", cp_engine.Engine, "search"))

    def __enter__(self):
        self.seen, self._orig = [], []
        for name, owner, attr in self.SPIES:
            orig = getattr(owner, attr)
            self._orig.append((owner, attr, orig))

            def spy(*a, _name=name, _orig=orig, **k):
                out = _orig(*a, **k)
                if out is not None and getattr(out, "ok", True):
                    self.seen.append(_name)
                return out

            setattr(owner, attr, spy)
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in self._orig:
            setattr(owner, attr, orig)


def cp_solve(label: str, model, params: dict, callback=None) -> dict:
    """One ``CpSolver(device="cuda")`` solve, the launch counters set to 0
    just before it and read just after: its status, objective, bound,
    conflicts, branches, seconds, peak device memory above what was held
    before it, the routes it took, the node backends that ``mip.solve``'s
    ``choose_backend`` built and the device FJ's calls.  Every solution is
    checked with the port's ``checker.solution_is_feasible``."""
    solver = CpSolver(device="cuda")
    for k, v in params.items():
        setattr(solver.parameters, k, v)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with _CallLog() as log, _Routes() as routes:
        t0 = time.perf_counter()
        status = solver.solve(model, callback)
        dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    cnt = log.counts()
    r = solver.response
    if r.solution is not None:
        require(solution_is_feasible(model.ir, r.solution),
                f"{label}: the solution fails the checker")
    out = dict(status=status.name, objective=r.objective_value,
               bound=r.best_objective_bound, conflicts=r.num_conflicts,
               branches=r.num_branches, seconds=dt, peak_bytes=peak,
               routes=sorted(set(routes.seen)), launches=cnt["launches"],
               backends=sorted(set(log.backends)), fj_calls=cnt["fj_calls"],
               solver=solver)
    print(f"{label}: {out['status']}, objective {out['objective']!r}, bound "
          f"{out['bound']!r}, {out['conflicts']} conflicts, "
          f"{out['branches']} branches, {dt:.3f} s; routes {out['routes']}; "
          f"peak device memory +{peak} bytes; launches {out['launches']}; "
          f"node backends built {out['backends']}; device FJ "
          f"{out['fj_calls']} calls", flush=True)
    return out


def ft10_solve() -> dict:
    """ft10 under CpSolver's defaults with a 120 s limit: OPTIMAL at 930
    with the bound at 930, and the schedule checked in numpy."""
    jobs = parse_jssp(FT10.read_text())
    model, starts, makespan = jobshop_cp(jobs)
    print(f"ft10: {len(jobs)} jobs x {len(jobs[0])} machines, "
          f"{len(model.ir.variables)} variables, "
          f"{len(model.ir.constraints)} constraints", flush=True)
    out = cp_solve("ft10", model, dict(max_time_in_seconds=FT10_LIMIT))
    require(out["status"] == "OPTIMAL"
            and out["objective"] == out["bound"] == FT10_OPTIMUM,
            f"ft10: {out['status']} {out['objective']} bound "
            f"{out['bound']}, not OPTIMAL at {FT10_OPTIMUM}")
    s = out["solver"]
    check_schedule(jobs, np.array([s.values(row) for row in starts]),
                   s.value(makespan))
    return out


def cp_maxsat(seed: int) -> tuple:
    """tests/test_max_hs.py::weighted_maxsat_model with the port's
    CpModel (the clauses of ``maxsat_model``), and milp's optimum."""
    _, clauses, w = maxsat_model(seed)
    m = CpModel()
    xs = [m.new_bool_var(f"x{i}") for i in range(len(w))]
    for c in clauses:
        m.add_bool_or([xs[v] if v >= 0 else ~xs[-v - 1] for v in c])
    m.minimize(sum(int(wi) * x for wi, x in zip(w, xs)))
    return m, maxsat_milp(clauses, w)


def cp_max_hs_solves() -> list:
    """core_algorithm="max_hs" on seeds 1 and 7: OPTIMAL at milp's
    objective (INFEASIBLE where milp finds none)."""
    outs = []
    for seed in CP_MAXSAT_SEEDS:
        model, (ref, msg) = cp_maxsat(seed)
        out = cp_solve(f"max_hs seed {seed} (milp {ref}, {msg})", model,
                       dict(core_algorithm="max_hs"))
        require("max_hs" in out["routes"], f"max_hs seed {seed}: routes "
                f"{out['routes']}")
        require((ref is None and out["status"] == "INFEASIBLE")
                or (out["status"] == "OPTIMAL"
                    and out["objective"] == out["bound"] == ref),
                f"max_hs seed {seed}: {out['status']} {out['objective']}, "
                f"milp {ref}")
        print(f"max_hs seed {seed}: {out['launches']} launches (none "
              f"expected: the hitting-set MIPs are small enough for the "
              f"host simplex), backends {out['backends']}", flush=True)
        outs.append(out)
    return outs


def planted_sat(n: int = 300, m: int = 1200, seed: int = 2) -> CpModel:
    """Random 3-clauses that a planted assignment satisfies."""
    rng = np.random.default_rng(seed)
    plant = rng.integers(0, 2, n)
    model = CpModel()
    xs = [model.new_bool_var(f"x{i}") for i in range(n)]
    while m:
        vs = rng.choice(n, 3, replace=False)
        signs = rng.integers(0, 2, 3)
        if not any(plant[v] == s for v, s in zip(vs, signs)):
            continue
        model.add_bool_or([xs[v] if s else ~xs[v] for v, s in zip(vs, signs)])
        m -= 1
    return model


def bins_pb(items: int = 8, bins: int = 5, capacity: int = 7) -> CpModel:
    """Each item in exactly one bin under a weighted capacity row a bin
    (weights 3 and 4): pseudo-Boolean rows that presolve keeps linear."""
    m = CpModel()
    g = [[m.new_bool_var(f"g{i}_{j}") for j in range(bins)]
         for i in range(items)]
    for row in g:
        m.add_exactly_one(row)
    for j in range(bins):
        m.add(sum((3 + (i + j) % 2) * g[i][j] for i in range(items))
              <= capacity)
    return m


def planted_integer(n: int = 10, rows: int = 8, hi: int = 100,
                    seed: int = 4) -> CpModel:
    """Integer rows around a planted point in [0, hi]^n."""
    rng = np.random.default_rng(seed)
    point = rng.integers(0, hi + 1, n)
    m = CpModel()
    xs = [m.new_int_var(0, hi, f"x{i}") for i in range(n)]
    for _ in range(rows):
        idx = rng.choice(n, 4, replace=False)
        coef = rng.integers(-5, 6, 4)
        val = int(coef @ point[idx])
        m.add(sum(int(c) * xs[int(i)] for c, i in zip(coef, idx))
              <= val + int(rng.integers(0, 4)))
        m.add(sum(int(c) * xs[int(i)] for c, i in zip(coef, idx))
              >= val - int(rng.integers(0, 4)))
    return m


def chain_lp_model() -> tuple:
    """tests/test_lp_propagator.py's chain: x_i + x_{i+1} <= 8, sum >= 12,
    minimize sum (i % 2 + 1) x_i over [0, 6]^6, and milp's optimum."""
    n = 6
    m = CpModel()
    xs = [m.new_int_var(0, 6, f"x{i}") for i in range(n)]
    for i in range(n - 1):
        m.add(xs[i] + xs[i + 1] <= 8)
    m.add(sum(xs) >= 12)
    c = np.array([i % 2 + 1 for i in range(n)], float)
    m.minimize(sum(int(ci) * x for ci, x in zip(c, xs)))
    a = np.vstack([np.eye(n)[:-1] + np.eye(n, k=1)[:-1], np.ones((1, n))])
    res = milp(c, constraints=LinearConstraint(
        a, np.r_[np.full(n - 1, -np.inf), 12], np.r_[np.full(n - 1, 8),
                                                    np.inf]),
        bounds=Bounds(0, 6), integrality=np.ones(n))
    return m, round(res.fun)


def queens_model(n: int) -> CpModel:
    m = CpModel()
    q = [m.new_int_var(0, n - 1, f"q{i}") for i in range(n)]
    m.add_all_different(q)
    m.add_all_different([q[i] + i for i in range(n)])
    m.add_all_different([q[i] - i for i in range(n)])
    return m


class _Collect(CpSolverSolutionCallback):
    def __init__(self):
        super().__init__()
        self.solutions = []

    def on_solution_callback(self):
        self.solutions.append(tuple(self._values))


def cp_routes() -> list:
    """One small solve on each other route: pure SAT (CDCL), the PB core,
    LCG, the integer encoding, the DFS engine with the node LP propagator,
    and 8-queens enumerated (92 solutions, each checked)."""
    outs = []
    cases = (
        ("pure SAT, planted 3-SAT (300 vars, 1200 clauses)", planted_sat(),
         {}, "pure_sat", "OPTIMAL"),
        ("pseudo-Boolean, 8 items in 5 bins", bins_pb(), {}, "pb",
         "OPTIMAL"),
        ("pseudo-Boolean, 6 items in 5 bins of one item (infeasible)",
         bins_pb(6, 5, 5), {}, "pb", "INFEASIBLE"),
        ("integer decision on LCG", planted_integer(), {}, "lcg",
         "OPTIMAL"),
        ("integer decision on the integer encoding", planted_integer(),
         dict(use_lcg=False), "encoding", "OPTIMAL"))
    for label, model, params, route, status in cases:
        out = cp_solve(label, model, params)
        require(route in out["routes"] and out["status"] == status,
                f"{label}: {out['status']}, routes {out['routes']}")
        outs.append(out)
    model, ref = chain_lp_model()
    out = cp_solve(f"optimization on the DFS engine with the node LP "
                   f"(milp {ref})", model,
                   dict(use_lcg=False, use_integer_cdcl=False))
    require({"root_lp", "node_lp", "search"} <= set(out["routes"])
            and out["status"] == "OPTIMAL"
            and out["objective"] == out["bound"] == ref,
            f"DFS with the node LP: {out['status']} {out['objective']}, "
            f"routes {out['routes']}, milp {ref}")
    outs.append(out)
    model, cb = queens_model(8), _Collect()
    out = cp_solve("8-queens, every solution", model,
                   dict(enumerate_all_solutions=True), cb)
    for sol in cb.solutions:
        require(solution_is_feasible(model.ir, list(sol)),
                "8-queens: a solution fails the checker")
    require(out["status"] == "OPTIMAL" and len(set(cb.solutions)) == 92
            == len(cb.solutions), f"8-queens: {out['status']}, "
            f"{len(cb.solutions)} solutions")
    print(f"8-queens: {len(cb.solutions)} distinct solutions", flush=True)
    outs.append(out)
    return outs


def cp_sat() -> dict:
    """Phase 13.  Returns the launches of its solves, each counted from 0
    just before the solve and read just after."""
    t0 = time.perf_counter()
    outs = [ft10_solve()] + cp_max_hs_solves() + cp_routes()
    launches = {}
    for out in outs:
        _add(launches, out["launches"])
    print(f"CP-SAT: {len(outs)} solves in {time.perf_counter() - t0:.1f} s; "
          f"largest peak device memory +"
          f"{max(o['peak_bytes'] for o in outs)} bytes; launches "
          f"{launches}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# 14. CP-SAT's portfolios and model I/O, the graph algorithms, routing
# ---------------------------------------------------------------------------

PORTFOLIO_WORKERS = 8
# The limits keep the whole run under 1,100 s (the instances stay whole).
# The interleaved portfolio keeps 20 s: it runs in this process, and when
# its deadline lands in a restart's root propagation the TimeoutError
# escapes solve_model, as in the JAX package (sat/solver.py's portfolio
# path; it did at 5 s).  The forked one (its workers' errors stay in the
# children) and routing were cut from 20 and 10 s to 5 s to make room for
# phase 17.
PORTFOLIO_LIMIT = {"interleaved": 20.0, "forked": 5.0}
FORK_GUARD = 150.0  # wall-clock guard on each forked solve
SHARED_TREE_KNAPSACK = dict(n=20, seed=5)
DRAT_PIGEONS = 7  # into 6 holes
MAX_FLOW = dict(nodes=100_000, arcs=1_000_000, seed=0)
ASSIGNMENT = dict(n=1000, seed=0)
TRANSPORT = dict(n=100, seed=0)
TSP_POINTS = dict(n=200, seed=0)
CVRP = dict(nodes=101, vehicles=12, capacity=100, seed=0)
VRPTW = dict(customers=100, vehicles=25, capacity=200, horizon=230,
             service=10, width=30, seed=0)
ROUTING_LIMIT = 5.0
CERT_TSP = dict(n=10, seed=3)


def counted(label: str, fn, *args, **kwargs) -> tuple:
    """``fn(*args, **kwargs)`` with the launch counters set to 0 just
    before it and read just after (``_CallLog``): prints its seconds, its
    peak device memory above what was held before it and its launches, and
    names any kernel that it launched.  Returns (result, launches)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with _CallLog() as log:
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    cnt = log.counts()
    launched = sorted(k for k, v in cnt["launches"].items() if v)
    print(f"  {label}: {dt:.3f} s; peak device memory +{peak} bytes; "
          f"launches {cnt['launches']}"
          + (f" (kernels launched: {launched})" if launched else ""),
          flush=True)
    return out, cnt["launches"]


class _ForkWatch:
    """For the length of a forked portfolio solve: counts the workers that
    ``ParallelPortfolio`` forks, and after its shutdown (a 2 s join each,
    then ``terminate``) how many exited on the stop message, how many ended
    by an exception (a worker whose slice outlives the deadline raises
    ``TimeoutError``, uncaught in ``_worker_main`` as in the JAX package),
    how many had to be terminated and how many are still alive; a SIGALRM
    after ``guard``
    seconds raises in the solve, so a hung portfolio fails the phase (its
    ``finally`` still shuts the workers down) instead of the run's limit."""

    def __init__(self, label: str, guard: float = FORK_GUARD):
        self.label, self.guard = label, guard
        self.forked = self.exited = self.raised = 0
        self.terminated = self.alive = 0

    def __enter__(self):
        self._shutdown = cp_parallel.ParallelPortfolio._shutdown
        watch = self

        def shutdown_(pf):
            procs = list(pf._procs)
            watch._shutdown(pf)
            for p in procs:
                watch.forked += 1
                if p.is_alive():
                    watch.alive += 1
                elif p.exitcode == -signal.SIGTERM:
                    watch.terminated += 1
                elif p.exitcode == 0:
                    watch.exited += 1
                else:
                    watch.raised += 1

        def alarm(signum, frame):
            raise SmokeFailure(f"{watch.label}: not done after "
                               f"{watch.guard:.0f} s (a hung worker?)")

        cp_parallel.ParallelPortfolio._shutdown = shutdown_
        self._handler = signal.signal(signal.SIGALRM, alarm)
        signal.setitimer(signal.ITIMER_REAL, self.guard)
        return self

    def __exit__(self, *exc):
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, self._handler)
        cp_parallel.ParallelPortfolio._shutdown = self._shutdown

    def report(self) -> None:
        left = multiprocessing.active_children()
        print(f"  {self.label}: {self.forked} tree workers forked (the "
              f"LNS workers run in this process); "
              f"{self.exited} exited on the stop message, {self.raised} "
              f"ended by an exception, {self.terminated} had to be "
              f"terminated, {self.alive} "
              f"still alive; {len(left)} children left", flush=True)
        require(self.forked > 0, f"{self.label}: no worker was forked")
        require(self.alive == 0 and not left,
                f"{self.label}: a forked worker outlived its shutdown")


def ft10_portfolio(interleave: bool) -> dict:
    """ft10 under ``num_workers=8`` and its PORTFOLIO_LIMIT: FEASIBLE or
    OPTIMAL, 930 <= makespan, bound <= 930, the schedule checked in
    numpy."""
    jobs = parse_jssp(FT10.read_text())
    model, starts, makespan = jobshop_cp(jobs)
    kind = "interleaved" if interleave else "forked"
    label = f"ft10, {PORTFOLIO_WORKERS} workers, {kind}"
    params = dict(num_workers=PORTFOLIO_WORKERS,
                  interleave_search=interleave,
                  max_time_in_seconds=PORTFOLIO_LIMIT[kind])
    if interleave:
        out = cp_solve(label, model, params)
    else:
        with _ForkWatch(label) as watch:
            out = cp_solve(label, model, params)
        watch.report()
    require(out["status"] in ("FEASIBLE", "OPTIMAL"),
            f"{label}: {out['status']}")
    require(out["objective"] >= FT10_OPTIMUM >= out["bound"],
            f"{label}: makespan {out['objective']}, bound {out['bound']}")
    s = out["solver"]
    check_schedule(jobs, np.array([s.values(row) for row in starts]),
                   s.value(makespan))
    print(f"{label}: makespan {out['objective']:.0f}, bound "
          f"{out['bound']:.0f}, {out['seconds']:.1f} s; schedule checked",
          flush=True)
    return out


def knapsack_cp(n: int, seed: int) -> tuple:
    """tests/test_portfolio.py::knapsack_model, and milp's optimum."""
    rng = np.random.default_rng(seed)
    m = CpModel()
    xs = [m.new_bool_var(f"x{i}") for i in range(n)]
    w = rng.integers(1, 20, n)
    v = rng.integers(1, 30, n)
    cap = int(w.sum() * 0.4)
    m.add(sum(int(wi) * x for wi, x in zip(w, xs)) <= cap)
    m.maximize(sum(int(vi) * x for vi, x in zip(v, xs)))
    res = milp(-v.astype(float), constraints=LinearConstraint(
        w[None, :].astype(float), -np.inf, cap), bounds=Bounds(0, 1),
        integrality=np.ones(n))
    return m, round(-res.fun)


def shared_tree() -> dict:
    """The shared-tree portfolio (forked workers splitting one tree) on
    tests/test_portfolio.py:223's kind of model, a 0/1 knapsack: OPTIMAL
    at milp's optimum."""
    model, ref = knapsack_cp(**SHARED_TREE_KNAPSACK)
    label = (f"shared tree, knapsack n {SHARED_TREE_KNAPSACK['n']} (milp "
             f"{ref}), 4 workers")
    with _ForkWatch(label) as watch:
        out = cp_solve(label, model, dict(
            num_workers=4, interleave_search=False,
            use_shared_tree_search=True, max_time_in_seconds=60.0))
    watch.report()
    require(out["status"] == "OPTIMAL" and out["objective"] == ref,
            f"{label}: {out['status']} {out['objective']}")
    return out


def after_fork() -> dict:
    """One matrix through the SpMV kernels against their plain versions,
    after the forks: the parent's CUDA context still works."""
    errs: dict = {}
    qp = block_random_lp(**MODERATE, seed=1)
    mat = BlockSparseMatrix.from_scipy(qp.constraint_matrix,
                                       dtype=torch.float64, device="cuda")
    check_matrix("after the forks: 2048^2 A (8x128)", mat, errs)
    return errs


def wcnf_text(clauses: list, w) -> str:
    """A max-SAT model as classic WCNF: the clauses hard (weight top), a
    soft unit clause (not x_i) of weight w_i for each variable."""
    top = int(np.sum(w)) + 1
    lines = [f"p wcnf {len(w)} {len(clauses) + len(w)} {top}"]
    lines += [f"{top} " + " ".join(str(v + 1 if v >= 0 else v) for v in c)
              + " 0" for c in clauses]
    lines += [f"{int(wi)} -{i + 1} 0" for i, wi in enumerate(w)]
    return "\n".join(lines) + "\n"


def wcnf_cp(clauses: list, w) -> CpModel:
    """The same max-SAT model built with ``CpModel`` as ``read_wcnf``
    encodes it: variables x1..xn, the hard clauses, then for each soft
    clause a relaxation literal ``_soft{k}`` beside it, minimized."""
    m = CpModel()
    xs = [m.new_bool_var(f"x{i + 1}") for i in range(len(w))]
    for c in clauses:
        m.add_bool_or([xs[v] if v >= 0 else ~xs[-v - 1] for v in c])
    soft = []
    for k in range(len(w)):
        s = m.new_bool_var(f"_soft{k}")
        m.add_bool_or([~xs[k], s])
        soft.append(s)
    m.minimize(sum(int(wi) * s for wi, s in zip(w, soft)))
    return m


def model_io(tmp: Path) -> tuple:
    """Phase 13's max-SAT models written as WCNF and read back through
    ``sat_io``: the IR equals the ``CpModel``'s, and solves to milp's
    optimum; one model through ``model_to_json`` / ``model_from_json``: the
    IR and the objective unchanged; the runner in a subprocess on a WCNF
    file: its Objective is milp's optimum.  Returns (launches, the WCNF
    path that the runner read)."""
    total = {}
    for seed in CP_MAXSAT_SEEDS:
        _, clauses, w = maxsat_model(seed)
        ref, _ = maxsat_milp(clauses, w)
        path = tmp / f"maxsat_{seed}.wcnf"
        path.write_text(wcnf_text(clauses, w))
        read = cp_sat_io.read_problem_file(str(path))
        require(read.name == str(path)
                and dataclasses.replace(read, name="")
                == wcnf_cp(clauses, w).ir,
                f"max-SAT seed {seed}: the WCNF IR is not the CpModel's")
        r, launches = counted(f"max-SAT seed {seed} read from WCNF",
                              solve_model, read)
        _add(total, launches)
        print(f"max-SAT seed {seed} from WCNF: {r.status.name}, objective "
              f"{r.objective_value}, milp {ref}", flush=True)
        require(r.status.name == "OPTIMAL" and r.objective_value == ref,
                f"max-SAT seed {seed} from WCNF: {r.status.name} "
                f"{r.objective_value}, milp {ref}")
    model, (ref, _) = cp_maxsat(CP_MAXSAT_SEEDS[0])
    text = cp_serialization.model_to_json(model.ir)
    back = cp_serialization.model_from_json(text)
    require(back == model.ir and cp_serialization.model_to_json(back) == text,
            "model_to_json / model_from_json does not round-trip")
    r0, l0 = counted("JSON: the model", solve_model, model.ir)
    r1, l1 = counted("JSON: the model read back", solve_model, back)
    _add(total, l0)
    _add(total, l1)
    print(f"JSON round trip ({len(text)} characters): objective "
          f"{r0.objective_value} and {r1.objective_value}, milp {ref}",
          flush=True)
    require(r0.status.name == r1.status.name == "OPTIMAL"
            and r0.objective_value == r1.objective_value == ref,
            "the JSON round trip changed the solve")
    # the runner, as a user runs it, on the card by default
    seed = CP_MAXSAT_SEEDS[-1]
    _, clauses, w = maxsat_model(seed)
    ref, _ = maxsat_milp(clauses, w)
    path = tmp / f"maxsat_{seed}.wcnf"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ortools_tpu_torch.sat.runner", str(path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    dt = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    print(f"runner on {path.name} ({dt:.1f} s, exit {proc.returncode}): "
          + " | ".join(lines[:5]), flush=True)
    objective = [ln.split(":", 1)[1].strip() for ln in lines
                 if ln.startswith("Objective:")]
    require(proc.returncode == 0 and objective
            and float(objective[0]) == ref,
            f"the runner: exit {proc.returncode}, {objective}, milp {ref}; "
            f"{proc.stderr[-2000:]}")
    return total


def pigeonhole(pigeons: int) -> list:
    """PHP(pigeons, pigeons - 1) as clauses of signed DIMACS literals."""
    holes = pigeons - 1

    def var(p, h):
        return p * holes + h + 1

    clauses = [[var(p, h) for h in range(holes)] for p in range(pigeons)]
    for h in range(holes):
        for p1 in range(pigeons):
            for p2 in range(p1 + 1, pigeons):
                clauses.append([-var(p1, h), -var(p2, h)])
    return clauses


def drat_proof(tmp: Path) -> None:
    """An UNSAT pure-SAT model (the pigeonhole principle) on the CDCL core
    with a proof, written by ``write_drat``, read by ``parse_drat`` and
    checked by ``check_drat``; a proof cut before its empty clause fails."""
    clauses = pigeonhole(DRAT_PIGEONS)
    n = DRAT_PIGEONS * (DRAT_PIGEONS - 1)
    s = cp_cdcl.CdclSolver(num_vars=n, proof=True)
    for c in clauses:
        s.add_clause(c)
    t0 = time.perf_counter()
    st = s.solve()
    solve_s = time.perf_counter() - t0
    path = tmp / "php.drat"
    s.write_drat(str(path))
    proof = cp_drat.parse_drat(str(path))
    t0 = time.perf_counter()
    ok = cp_drat.check_drat(clauses, proof)
    check_s = time.perf_counter() - t0
    cut = cp_drat.check_drat(clauses, [e for e in proof if e[1]])
    print(f"DRAT: PHP({DRAT_PIGEONS}, {DRAT_PIGEONS - 1}) status {st} in "
          f"{solve_s:.3f} s; {len(proof)} proof lines "
          f"({path.stat().st_size} bytes) checked {ok} in {check_s:.3f} s; "
          f"without its empty clause {cut}", flush=True)
    require(st == 0 and proof and ok and not cut,
            f"DRAT: status {st}, checked {ok}, cut proof {cut}")


def portfolios_and_io() -> dict:
    """Phase 14 (a): the portfolios, then the model I/O, the runner and
    DRAT.  Returns the launches."""
    total = {}
    outs = [ft10_portfolio(True), ft10_portfolio(False), shared_tree()]
    for out in outs:
        _add(total, out["launches"])
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        _add(total, model_io(Path(tmp)))
        drat_proof(Path(tmp))
    return total


def random_arcs(nodes: int, arcs: int, seed: int) -> tuple:
    """``arcs`` distinct random arcs without self-loops, capacities in
    [1, 100]."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, nodes, int(arcs * 1.05))
    h = rng.integers(0, nodes, t.size)
    keep = t != h
    key = t[keep].astype(np.int64) * nodes + h[keep]
    _, first = np.unique(key, return_index=True)
    first = np.sort(first)[:arcs]
    t, h = t[keep][first], h[keep][first]
    return t, h, rng.integers(1, 101, t.size)


def max_flow_and_paths() -> dict:
    """``SimpleMaxFlow`` and ``dijkstra_shortest_path`` on 100,000 nodes
    and 10^6 arcs against scipy."""
    total = {}
    t, h, cap = random_arcs(**MAX_FLOW)
    n = MAX_FLOW["nodes"]
    require(t.size == MAX_FLOW["arcs"], f"{t.size} arcs")
    mf = SimpleMaxFlow()
    t0 = time.perf_counter()
    for a, b, c in zip(t.tolist(), h.tolist(), cap.tolist()):
        mf.add_arc_with_capacity(a, b, c)
    add_s = time.perf_counter() - t0
    st, launches = counted("SimpleMaxFlow.solve", mf.solve, 0, n - 1)
    _add(total, launches)
    g = sp.csr_matrix((cap.astype(np.int32), (t, h)), shape=(n, n))
    t0 = time.perf_counter()
    ref = maximum_flow(g, 0, n - 1).flow_value
    ref_s = time.perf_counter() - t0
    flows = np.array([mf.flow(k) for k in range(mf.num_arcs)])
    net = np.bincount(t, flows, n) - np.bincount(h, flows, n)
    print(f"max flow, {n} nodes, {t.size} arcs: {st.name} "
          f"{mf.optimal_flow()}, scipy {ref} ({ref_s:.3f} s); adding the "
          f"arcs {add_s:.2f} s", flush=True)
    require(st.name == "OPTIMAL" and mf.optimal_flow() == ref,
            f"max flow {st.name} {mf.optimal_flow()}, scipy {ref}")
    require(bool((flows >= 0).all() and (flows <= cap).all())
            and net[0] == ref and net[n - 1] == -ref
            and not net[1:n - 1].any(), "max flow: the flows do not hold")
    lengths = cap.astype(np.float64)
    (dist, _, path), launches = counted(
        "dijkstra_shortest_path", dijkstra_shortest_path, n, t.tolist(),
        h.tolist(), lengths.tolist(), 0, n - 1)
    _add(total, launches)
    ref = scipy_dijkstra(sp.csr_matrix((lengths, (t, h)), shape=(n, n)),
                         indices=0)
    same = np.array_equal(np.isinf(dist), np.isinf(ref))
    err = float(np.abs(dist[np.isfinite(ref)] - ref[np.isfinite(ref)]).max())
    print(f"dijkstra: {int(np.isfinite(dist).sum())} nodes reached, max "
          f"|d - scipy| {err:.3e}, path of {len(path or [])} nodes",
          flush=True)
    require(same and err <= 1e-9 * max(1.0, float(ref[np.isfinite(ref)]
                                                  .max())),
            f"dijkstra disagrees with scipy: {err}")
    if path is not None:
        arc_len = {}
        for a, b, d in zip(t.tolist(), h.tolist(), lengths.tolist()):
            arc_len[a, b] = d
        require(abs(sum(arc_len[a, b] for a, b in zip(path, path[1:]))
                    - dist[n - 1]) <= 1e-6, "dijkstra: the path's length")
    return total


def assignment_and_transport() -> dict:
    """``LinearSumAssignment`` at 1,000 x 1,000 against scipy's
    ``linear_sum_assignment``, and ``SimpleMinCostFlow`` on a 100 x 100
    transportation problem against HiGHS."""
    total = {}
    n = ASSIGNMENT["n"]
    cost = np.random.default_rng(ASSIGNMENT["seed"]).integers(0, 1000,
                                                              (n, n))
    lsa = LinearSumAssignment()
    t0 = time.perf_counter()
    for i, row in enumerate(cost.tolist()):
        for k, c in enumerate(row):
            lsa.add_arc_with_cost(i, k, c)
    add_s = time.perf_counter() - t0
    st, launches = counted("LinearSumAssignment.solve", lsa.solve)
    _add(total, launches)
    r, c = linear_sum_assignment(cost)
    ref = int(cost[r, c].sum())
    mates = np.array([lsa.right_mate(i) for i in range(n)])
    print(f"assignment {n} x {n}: {st.name} {lsa.optimal_cost()}, scipy "
          f"{ref}; adding the arcs {add_s:.2f} s", flush=True)
    require(st.name == "OPTIMAL" and lsa.optimal_cost() == ref
            and sorted(mates.tolist()) == list(range(n))
            and int(cost[np.arange(n), mates].sum()) == ref,
            f"assignment {st.name} {lsa.optimal_cost()}, scipy {ref}")
    k = TRANSPORT["n"]
    rng = np.random.default_rng(TRANSPORT["seed"])
    supply = rng.integers(10, 100, k)
    demand = rng.multinomial(int(supply.sum()), np.full(k, 1.0 / k))
    unit = rng.integers(1, 100, (k, k))
    mcf = SimpleMinCostFlow()
    for i in range(k):
        for j in range(k):
            mcf.add_arc_with_capacity_and_unit_cost(i, k + j,
                                                    int(supply[i]),
                                                    int(unit[i, j]))
    for i in range(k):
        mcf.set_node_supply(i, int(supply[i]))
        mcf.set_node_supply(k + i, -int(demand[i]))
    st, launches = counted("SimpleMinCostFlow.solve", mcf.solve)
    _add(total, launches)
    a_eq = sp.vstack([sp.kron(sp.eye(k), np.ones((1, k))),
                      sp.kron(np.ones((1, k)), sp.eye(k))]).tocsr()
    res = linprog(unit.ravel().astype(float), A_eq=a_eq,
                  b_eq=np.r_[supply, demand].astype(float), bounds=(0, None),
                  method="highs")
    flows = np.array([mcf.flow(a) for a in range(mcf.num_arcs)]).reshape(k,
                                                                        k)
    print(f"min cost flow {k} x {k}: {st.name} {mcf.optimal_cost()}, HiGHS "
          f"{res.fun:.1f}", flush=True)
    require(st.name == "OPTIMAL" and mcf.optimal_cost() == round(res.fun)
            and (flows.sum(1) == supply).all()
            and (flows.sum(0) == demand).all()
            and int((flows * unit).sum()) == mcf.optimal_cost(),
            f"min cost flow {st.name} {mcf.optimal_cost()}, HiGHS {res.fun}")
    return total


def tour_cost(dist: np.ndarray, tour: list) -> float:
    return float(sum(dist[a, b] for a, b in zip(tour, tour[1:] + tour[:1])))


def christofides_200() -> dict:
    """``christofides_tsp`` (the card's default device) on 200 seeded
    points: a tour of every point, costing at most 1.5 x the 1-tree
    bound."""
    rng = np.random.default_rng(TSP_POINTS["seed"])
    pts = rng.uniform(0, 1000, (TSP_POINTS["n"], 2))
    d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    (cost, tour), launches = counted("christofides_tsp", christofides_tsp, d)
    t0 = time.perf_counter()
    lb = one_tree_lower_bound(d)
    lb_s = time.perf_counter() - t0
    print(f"christofides, {len(d)} points: {cost:.1f}, 1-tree bound "
          f"{lb:.1f} ({lb_s:.2f} s), ratio {cost / lb:.4f}", flush=True)
    require(sorted(tour) == list(range(len(d)))
            and abs(tour_cost(d, tour) - cost) <= 1e-6 * cost
            and lb > 0 and cost <= 1.5 * lb,
            f"christofides: {cost} against the bound {lb}")
    return launches


def graph_algorithms() -> dict:
    """Phase 14 (b).  Returns the launches."""
    total = max_flow_and_paths()
    _add(total, assignment_and_transport())
    _add(total, christofides_200())
    return total


def cvrp_instance() -> tuple:
    """CVRP on 101 nodes: uniform points in [0, 1000]^2 (node 0 the
    depot), demands in [1, 19], 12 vehicles of capacity 100."""
    rng = np.random.default_rng(CVRP["seed"])
    n = CVRP["nodes"]
    pts = rng.uniform(0, 1000, (n, 2))
    d = np.round(np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
                 ).astype(np.int64)
    demand = rng.integers(1, 20, n)
    demand[0] = 0
    return d, demand


def solomon_text() -> str:
    """A Solomon R1-shaped instance as Solomon text: 100 customers uniform
    in [0, 70]^2 around a central depot, demands in [1, 41], service time
    10, a time window of 30 a customer, placed so that the depot reaches it
    and returns by 230; 25 vehicles of capacity 200."""
    c = VRPTW
    rng = np.random.default_rng(c["seed"])
    n = c["customers"] + 1
    xy = np.round(rng.uniform(0, 70, (n, 2)))
    xy[0] = (35, 35)
    demand = rng.integers(1, 42, n)
    demand[0] = 0
    d0 = np.sqrt(((xy - xy[0]) ** 2).sum(-1))
    latest = c["horizon"] - np.ceil(d0) - c["service"] - c["width"]
    ready = np.floor(rng.uniform(np.ceil(d0), latest))
    due = ready + c["width"]
    ready[0], due[0] = 0, c["horizon"]
    rows = [f"{i:5d} {xy[i, 0]:10.0f} {xy[i, 1]:10.0f} {demand[i]:10d} "
            f"{ready[i]:10.0f} {due[i]:10.0f} "
            f"{0 if i == 0 else c['service']:10d}" for i in range(n)]
    return "\n".join([
        "R1_SEEDED", "", "VEHICLE", "NUMBER     CAPACITY",
        f"  {c['vehicles']}         {c['capacity']}", "", "CUSTOMER",
        "CUST NO.  XCOORD.   YCOORD.   DEMAND    READY TIME  DUE DATE   "
        "SERVICE TIME", ""] + rows) + "\n"


def _params(limit: float, gls: bool = True):
    p = default_routing_search_parameters()
    p.time_limit_seconds = limit
    if gls:
        p.local_search_metaheuristic = \
            LocalSearchMetaheuristic.GUIDED_LOCAL_SEARCH
    return p


def check_routes(label: str, mgr, routes: list, demand, capacity: int,
                 windows=None) -> None:
    """Every customer visited once, each route's load within capacity,
    and with ``windows`` = (travel, ready, due, service), each arrival
    (waiting allowed) within its window and the return by the depot's."""
    n = len(demand)
    seen = []
    for r in routes:
        nodes = [mgr.index_to_node(i) for i in r]
        require(nodes[0] == 0 and nodes[-1] == 0,
                f"{label}: a route leaves or ends away from the depot")
        seen += nodes[1:-1]
        require(int(np.asarray(demand)[nodes].sum()) <= capacity,
                f"{label}: a route over capacity")
        if windows is not None:
            travel, ready, due, service = windows
            t = 0.0
            for a, b in zip(nodes, nodes[1:]):
                t = max(float(ready[b]), t + service[a] + travel[a, b])
                require(t <= due[b], f"{label}: node {b} reached at {t}, "
                        f"after its window closes at {due[b]}")
    require(sorted(seen) == list(range(1, n)),
            f"{label}: customers not visited exactly once")


def routing_solve(label: str, build, limit: float) -> tuple:
    """The first solution (a solve whose limit has passed before the local
    search starts) and the GLS solve under ``limit``, each on its own
    model from ``build()``; prints both objectives."""
    model, mgr = build()
    first = model.solve_with_parameters(_params(0.0, gls=False))
    model, mgr = build()
    sol, launches = counted(f"{label}, GLS, {limit:.0f} s",
                            model.solve_with_parameters, _params(limit))
    require(first is not None and sol is not None, f"{label}: no solution")
    used = sum(len(r) > 2 for r in sol.routes())
    print(f"{label}: objective {sol.objective_value()}, first solution "
          f"{first.objective_value()}, {used} vehicles used", flush=True)
    require(sol.objective_value() <= first.objective_value(),
            f"{label}: worse than its first solution")
    return sol, mgr, launches


def cvrp_101() -> dict:
    d, demand = cvrp_instance()

    def build():
        mgr = RoutingIndexManager(CVRP["nodes"], CVRP["vehicles"], 0)
        model = RoutingModel(mgr)
        cb = model.register_transit_callback(
            lambda f, t: int(d[mgr.index_to_node(f), mgr.index_to_node(t)]))
        model.set_arc_cost_evaluator_of_all_vehicles(cb)
        dem = model.register_unary_transit_callback(
            lambda f: int(demand[mgr.index_to_node(f)]))
        model.add_dimension_with_vehicle_capacity(
            dem, 0, [CVRP["capacity"]] * CVRP["vehicles"], True, "load")
        return model, mgr

    sol, mgr, launches = routing_solve(
        f"CVRP {CVRP['nodes']} nodes, {CVRP['vehicles']} vehicles",
        build, ROUTING_LIMIT)
    check_routes("CVRP", mgr, sol.routes(), demand, CVRP["capacity"])
    return launches


def vrptw_101(tmp: Path) -> dict:
    path = tmp / "r1_seeded.txt"
    path.write_text(solomon_text())
    inst = parse_solomon(str(path))
    require(len(inst.demands) == VRPTW["customers"] + 1
            and inst.num_vehicles == VRPTW["vehicles"],
            "parse_solomon: the instance read back differs")
    travel = inst.distance_matrix(10)  # tenths, integral for the callbacks
    service = (inst.service_times * 10).astype(np.int64)
    ready = (inst.ready_times * 10).astype(np.int64)
    due = (inst.due_times * 10).astype(np.int64)
    n, nv = len(inst.demands), inst.num_vehicles

    def build():
        mgr = RoutingIndexManager(n, nv, 0)
        model = RoutingModel(mgr)
        node = mgr.index_to_node
        cb = model.register_transit_callback(
            lambda f, t: int(travel[node(f), node(t)]))
        model.set_arc_cost_evaluator_of_all_vehicles(cb)
        tcb = model.register_transit_callback(
            lambda f, t: int(service[node(f)] + travel[node(f), node(t)]))
        horizon = int(due[0])
        model.add_dimension(tcb, horizon, horizon, False, "Time")
        dim = model.get_dimension_or_die("Time")
        for i in range(1, n):
            dim.set_cumul_var_range(mgr.node_to_index(i), int(ready[i]),
                                    int(due[i]))
        for v in range(nv):
            dim.set_cumul_var_range(model.end(v), 0, horizon)
        dem = model.register_unary_transit_callback(
            lambda f: int(inst.demands[node(f)]))
        model.add_dimension_with_vehicle_capacity(
            dem, 0, [int(inst.capacity)] * nv, True, "load")
        return model, mgr

    sol, mgr, launches = routing_solve(
        f"VRPTW (Solomon R1 shape) {n} nodes, {nv} vehicles", build,
        ROUTING_LIMIT)
    check_routes("VRPTW", mgr, sol.routes(), inst.demands,
                 int(inst.capacity), (travel, ready, due, service))
    return launches


def certified_tsp() -> dict:
    """``cp_sat_certification_share=0.5`` on a 10-node single-vehicle TSP
    (sat_path.py's false OPTIMAL certificates come with more than one
    vehicle), and ``solve_with_cp_sat`` on it, whose ``CpSolver`` takes the
    model's device: both at the brute-force optimum."""
    total = {}
    rng = np.random.default_rng(CERT_TSP["seed"])
    n = CERT_TSP["n"]
    pts = rng.integers(0, 100, (n, 2))
    d = np.abs(pts[:, None] - pts[None, :]).sum(-1)
    perms = np.array(list(itertools.permutations(range(1, n))))
    tours = np.hstack([np.zeros((len(perms), 1), int), perms,
                       np.zeros((len(perms), 1), int)])
    best = int(d[tours[:, :-1], tours[:, 1:]].sum(1).min())

    def build():
        mgr = RoutingIndexManager(n, 1, 0)
        model = RoutingModel(mgr)
        model.set_arc_cost_evaluator_of_all_vehicles(
            model.register_transit_callback(
                lambda f, t: int(d[mgr.index_to_node(f),
                                   mgr.index_to_node(t)])))
        return model

    model = build()
    p = _params(10.0, gls=False)
    p.cp_sat_certification_share = 0.5
    sol, launches = counted("certification share 0.5",
                            model.solve_with_parameters, p)
    _add(total, launches)
    model2 = build()
    out, launches = counted("solve_with_cp_sat", sat_path.solve_with_cp_sat,
                            model2, 30.0)
    _add(total, launches)
    print(f"TSP {n} nodes: certified {sol.objective_value()}, "
          f"solve_with_cp_sat {out and out[0].objective_value()} (proven "
          f"{out and out[1]}) on {model2.device}, brute force {best}",
          flush=True)
    require(sol.objective_value() == best and out is not None
            and out[0].objective_value() == best and out[1],
            f"certified TSP: {sol.objective_value()}, {out}, brute {best}")
    return total


def breaks_case() -> dict:
    """tests/test_routing.py:318: a break of 3 in [4, 9] on a route of
    four arcs of 4."""
    mgr = RoutingIndexManager(4, 1, 0)
    model = RoutingModel(mgr)
    cb = model.register_transit_callback(lambda a, b: 4)
    model.add_dimension(cb, 100, 100, True, "Time")
    dim = model.get_dimension_or_die("Time")
    dim.set_break_intervals_of_vehicle([BreakInterval(duration=3, start_min=4, start_max=9)], 0)
    out, launches = counted("schedule_route_with_breaks",
                            schedule_route_with_breaks, model, [1, 2, 3],
                            "Time", dim.breaks_per_vehicle[0])
    print(f"breaks: {out}", flush=True)
    seq = [model.start(0), 1, 2, 3, model.end(0)]
    st, p = out["break_starts"][0], out["break_arcs"][0]
    c = out["cumuls"]
    require(c[model.end(0)] >= 19 and 4 <= st <= 9
            and c[seq[p]] <= st and st + 3 <= c[seq[p + 1]],
            f"breaks: {out}")
    return launches


def routing() -> dict:
    """Phase 14 (c).  Returns the launches."""
    total = cvrp_101()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        _add(total, vrptw_101(Path(tmp)))
    _add(total, certified_tsp())
    _add(total, breaks_case())
    return total


def slice12() -> tuple:
    """Phase 14.  Returns (launches, the after-fork kernel errors)."""
    t0 = time.perf_counter()
    launches = portfolios_and_io()
    errs = after_fork()
    _add(launches, graph_algorithms())
    _add(launches, routing())
    print(f"phase 14: {time.perf_counter() - t0:.1f} s; launches "
          f"{launches} (none expected: this slice is host code)",
          flush=True)
    return launches, errs


# ---------------------------------------------------------------------------
# 15. The last modules: LP files, the decomposer, scheduling, FlatZinc, the
#     classic CP facade and the examples
# ---------------------------------------------------------------------------

EXAMPLES_DIR = ROOT / "examples_torch"
JOBSHOP_LIMIT = 60.0
# tests/test_scheduling_packing.py's RCPSP instance (optimum 9)
RCPSP_SM = """\
jobs (incl. supersource/sink ):  5
RESOURCES
  - renewable                 :  1   R
PRECEDENCE RELATIONS:
jobnr.    #modes  #successors   successors
   1        1          2           2   3
   2        1          1           4
   3        1          1           4
   4        1          1           5
   5        1          0
************************************************************************
REQUESTS/DURATIONS:
jobnr. mode duration  R 1
------------------------------------------------------------------------
  1      1     0       0
  2      1     3       2
  3      1     4       2
  4      1     2       1
  5      1     0       0
************************************************************************
RESOURCEAVAILABILITIES:
  R 1
   2
************************************************************************
"""
RCPSP_OPTIMUM = 9


def lp_file_round_trip(bench_qp) -> QuadraticProgram:
    """(a) The bench LP written with ``write_lp`` and read back with
    ``read_lp``: every field equal to the generated QP's.  The LP format
    writes a row without entries as ``0 x0``, so those rows come back as
    explicit zeros, one a row; the fields are compared with them dropped.
    Returns the QP as read."""
    FRONTEND_DIR.mkdir(parents=True, exist_ok=True)
    path = FRONTEND_DIR / "bench.lp"
    t0 = time.perf_counter()
    write_lp(bench_qp, str(path))
    t_write = time.perf_counter() - t0
    size = path.stat().st_size
    t0 = time.perf_counter()
    read = read_lp(str(path))
    t_read = time.perf_counter() - t0
    path.unlink()
    zeros = int((read.constraint_matrix.data == 0).sum())
    empty_rows = int((np.diff(sp.csr_matrix(
        bench_qp.constraint_matrix).indptr) == 0).sum())
    compact = sp.csr_matrix(read.constraint_matrix, copy=True)
    compact.eliminate_zeros()
    bad = _same_qp(bench_qp, dataclasses.replace(
        read, constraint_matrix=compact))
    print(f"LP-file round trip of the bench LP ({bench_qp.constraint_matrix.nnz}"
          f" nonzeros): {size} bytes; write_lp {t_write:.3f} s, read_lp "
          f"{t_read:.3f} s (phase 10 prints the MPS figures); {zeros} "
          f"explicit zeros read back for {empty_rows} empty rows; fields "
          f"that differ: {bad or 'none'}", flush=True)
    require(not bad, f"the LP-file round trip changed the bench LP: {bad}")
    require(zeros == empty_rows,
            f"{zeros} explicit zeros for {empty_rows} empty rows")
    return read


def lp_file_solve(bench_qp, read_qp, errs: dict) -> dict:
    """(a) ``pdlp.solve`` at the bench's parameters on the QP as read, the
    launch counters set to 0 just before and read just after, bit for bit
    the same call on the generated QP; then the SpMVs against their plain
    versions on the read matrix, A and A^T (largest errors into
    ``errs``).  Returns the launches."""
    params = PdhgParams(**BENCH_PARAMS,
                        iteration_limit=BENCH_ITERATION_LIMIT)
    ref = solve(bench_qp, params)
    r, launches = counted("pdlp.solve of the bench LP as read from its LP "
                          "file", solve, read_qp, params)
    same = {f: (np.array_equal(getattr(r, f), getattr(ref, f))
                if isinstance(getattr(ref, f), np.ndarray)
                else getattr(r, f) == getattr(ref, f))
            for f in ("termination_reason", "iterations", "primal_objective",
                      "dual_objective", "primal_solution", "dual_solution")}
    print(f"  {r.termination_reason.name} after {r.iterations} iterations, "
          f"objective {r.primal_objective!r}; against the generated LP's "
          f"solve ({ref.termination_reason.name}, {ref.iterations}, "
          f"{ref.primal_objective!r}): fields that differ "
          f"{[f for f, ok in same.items() if not ok] or 'none'}", flush=True)
    require(all(same.values()),
            f"the LP file's solve differs from the LP's: {same}")
    require(all(launches[k] > 0 for k in KERNELS),
            f"an SpMV kernel was not launched by the LP file's solve: "
            f"{launches}")
    prob = pdlp_solver.build_device_problem(read_qp,
                                            PdhgParams(**BENCH_PARAMS), "cuda")
    for name, mat in (("A", prob.a), ("A^T", prob.at)):
        bm, bn = mat.block_shape
        check_built(f"LP file {name} ({bm}x{bn})", mat, errs)
    del prob
    torch.cuda.empty_cache()
    return launches


def stacked_moderate() -> QuadraticProgram:
    """Phase 4's four moderate LPs stacked block-diagonally."""
    parts = [block_random_lp(**MODERATE, seed=s) for s in MODERATE_SEEDS]
    cat = lambda f: np.concatenate([getattr(q, f) for q in parts])  # noqa: E731
    return QuadraticProgram(
        objective_vector=cat("objective_vector"),
        constraint_matrix=sp.block_diag(
            [q.constraint_matrix for q in parts], format="csr"),
        constraint_lower=cat("constraint_lower"),
        constraint_upper=cat("constraint_upper"),
        variable_lower=cat("variable_lower"),
        variable_upper=cat("variable_upper"), name="stacked_moderate")


def decomposed_stack(errs: dict) -> dict:
    """(b) ``decompose`` of the stack: four blocks, each solved by
    ``pdlp.solve`` on the card to OPTIMAL; the blocks' objectives summed
    against the sum of phase 4's HiGHS optima, and the assembled x held
    to the stack's rows and bounds within the solve's tolerance
    (eps_optimal_absolute + eps_optimal_relative times each block's bound
    norm; the f32 solution moves off a bound by its rounding).  The rows without entries are in no
    block (the reference's fault, copied): each has 0 in its bounds here,
    so dropping them changes nothing.  Then the SpMVs against their plain
    versions on block 0's scaled matrices (largest errors into ``errs``).
    Returns the launches."""
    qp = stacked_moderate()
    t0 = time.perf_counter()
    dec = decompose(qp)
    t_dec = time.perf_counter() - t0
    kept = np.concatenate(dec.row_maps)
    dropped = np.setdiff1d(np.arange(qp.num_constraints), kept)
    a = sp.csr_matrix(qp.constraint_matrix)
    print(f"decompose of the stacked moderate LPs ({qp.num_constraints}^2, "
          f"{a.nnz} nonzeros): {len(dec.blocks)} blocks in {t_dec:.3f} s, "
          f"{len(kept)} rows kept, {len(dropped)} empty rows dropped",
          flush=True)
    require(len(dec.blocks) == len(MODERATE_SEEDS),
            f"decompose gave {len(dec.blocks)} blocks")
    require(bool((np.diff(a.indptr)[dropped] == 0).all()),
            "decompose dropped a row that has entries")
    require(bool(((qp.constraint_lower[dropped] <= 0)
                  & (qp.constraint_upper[dropped] >= 0)).all()),
            "a dropped empty row excludes 0: the stack is infeasible")
    total: dict = {}
    results = []
    params = PdhgParams()
    for k, block in enumerate(dec.blocks):
        r, launches = counted(f"block {k} ({block.num_constraints} x "
                              f"{block.num_variables}) through pdlp.solve",
                              solve, block, params)
        require(r.termination_reason == TerminationReason.OPTIMAL,
                f"block {k}: {r.termination_reason.name}")
        require(exact_spmvs(launches) > 0,
                f"block {k}: the exact SpMV was not launched: {launches}")
        _add(total, launches)
        results.append(r)
    prob = pdlp_solver.build_device_problem(
        dec.blocks[0].as_minimization(), params, "cuda")
    for name, mat in (("A", prob.a), ("A^T", prob.at)):
        check_built(f"decomposed block 0 {name}", mat, errs)
    del prob
    ref = sum(moderate_refs(MODERATE_SEEDS).values())
    obj = sum(r.primal_objective for r in results)
    rel = abs(obj - ref) / (1 + abs(ref))
    x = dec.assemble_solution([r.primal_solution for r in results])
    y = dec.assemble_duals([r.dual_solution for r in results])
    ax = a @ x
    viol = np.maximum(qp.constraint_lower - ax, 0) + np.maximum(
        ax - qp.constraint_upper, 0)
    tol = [params.eps_optimal_absolute + params.eps_optimal_relative
           * pdlp_solver._combined_bounds_norm(b.constraint_lower,
                                               b.constraint_upper)
           for b in dec.blocks]
    worst = [float(np.abs(viol[rm]).max()) for rm in dec.row_maps]
    out_of_bounds = float(np.maximum(
        np.maximum(qp.variable_lower - x, 0),
        np.maximum(x - qp.variable_upper, 0)).max())
    print(f"  blocks' objectives summed {obj!r}, HiGHS's for seeds "
          f"{list(MODERATE_SEEDS)} summed {ref!r} (rel {rel:.2e}, <= 1e-4); "
          f"assembled x: largest row violation per block {worst} (<= "
          f"{[f'{v:.3e}' for v in tol]}), bounds {out_of_bounds:.1e}; "
          f"assembled y of length {len(y)}; launches {total}", flush=True)
    require(rel <= 1e-4, "the decomposed stack's objective disagrees with "
            "HiGHS's")
    require(all(w <= v for w, v in zip(worst, tol))
            and out_of_bounds <= min(tol),
            "the assembled x violates the stack's rows or bounds")
    return total


def fzn_knapsack(n: int, seed: int) -> tuple:
    """Phase 14's 0/1 knapsack (``knapsack_cp``'s weights and values) as
    FlatZinc text, and milp's optimum."""
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 20, n)
    v = rng.integers(1, 30, n)
    cap = int(w.sum() * 0.4)
    xs = ", ".join(f"x[{i + 1}]" for i in range(n))
    ints = lambda a: ", ".join(str(int(c)) for c in a)  # noqa: E731
    text = (f"array [1..{n}] of var 0..1: x :: output_array([1..{n}]);\n"
            f"var 0..{int(v.sum())}: value :: output_var;\n"
            f"constraint int_lin_le([{ints(w)}], [{xs}], {cap});\n"
            f"constraint int_lin_eq([{ints(v)}, -1], [{xs}, value], 0);\n"
            f"solve maximize value;\n")
    _, ref = knapsack_cp(n, seed)
    return text, ref


def jobshops() -> dict:
    """(c) ft10 through ``solve_jobshop`` on its default route (LCG), ft06
    through ``solve_jobshop_cdcl`` and the CP engine (``engine="cp"``,
    CpSolver on the card), and RCPSP, each schedule checked."""
    total: dict = {}
    ft10 = parse_jobshop(str(FT10))
    sol, launches = counted(f"ft10 through solve_jobshop (LCG, "
                            f"{JOBSHOP_LIMIT:.0f} s limit)", solve_jobshop,
                            ft10, JOBSHOP_LIMIT, device="cuda")
    _add(total, launches)
    require(sol is not None and sol.optimal
            and sol.makespan == FT10_OPTIMUM,
            f"ft10: {sol and (sol.makespan, sol.optimal)}, not OPTIMAL at "
            f"{FT10_OPTIMUM}")
    check_schedule(ft10.jobs, np.array(sol.starts), sol.makespan)
    print(f"    makespan {sol.makespan}, optimal", flush=True)
    ft06 = parse_jobshop(_example("jobshop_sat").FT06, is_text=True)
    for label, fn, kw in (
            ("ft06 through solve_jobshop_cdcl", solve_jobshop_cdcl, {}),
            ("ft06 through solve_jobshop(engine='cp')", solve_jobshop,
             dict(engine="cp", device="cuda"))):
        sol, launches = counted(label, fn, ft06, 30.0, **kw)
        _add(total, launches)
        require(sol is not None and sol.optimal and sol.makespan == 55,
                f"{label}: {sol and (sol.makespan, sol.optimal)}")
        check_schedule(ft06.jobs, np.array(sol.starts), sol.makespan)
        print(f"    makespan {sol.makespan}, optimal", flush=True)
    inst = parse_rcpsp(RCPSP_SM, is_text=True)
    sol, launches = counted("RCPSP (tests/test_scheduling_packing.py's)",
                            solve_rcpsp, inst, 20.0, device="cuda")
    _add(total, launches)
    require(sol is not None and sol.optimal
            and sol.makespan == RCPSP_OPTIMUM,
            f"RCPSP: {sol and (sol.makespan, sol.optimal)}")
    for i, succs in enumerate(inst.successors):
        for j in succs:
            require(sol.starts[j] >= sol.starts[i] + inst.durations[i],
                    "RCPSP: a precedence is broken")
    print(f"    RCPSP makespan {sol.makespan}, optimal", flush=True)
    return total


def flatzinc_knapsack(tmp: Path) -> dict:
    """(c) The knapsack as FlatZinc through ``solve_fzn_text`` on the card,
    and through ``python -m ortools_tpu_torch.flatzinc --device cuda`` in a
    subprocess: OPTIMAL at milp's optimum, ending with ``==========``."""
    n, seed = SHARED_TREE_KNAPSACK["n"], SHARED_TREE_KNAPSACK["seed"]
    text, ref = fzn_knapsack(n, seed)
    label = f"knapsack n {n} as FlatZinc through solve_fzn_text (milp {ref})"
    res, launches = counted(label, solve_fzn_text, text, device="cuda")
    print(f"    {res.status.name}, objective {res.objective!r}", flush=True)
    require(res.status.name == "OPTIMAL" and res.objective == ref
            and res.text.endswith("=========="),
            f"{label}: {res.status.name} {res.objective}")
    path = tmp / "knapsack.fzn"
    path.write_text(text)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ortools_tpu_torch.flatzinc", "--device",
         "cuda", str(path)], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    dt = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    value = [ln for ln in lines if ln.startswith("value = ")]
    print(f"  python -m ortools_tpu_torch.flatzinc --device cuda "
          f"{path.name}: exit {proc.returncode} in {dt:.1f} s; "
          f"{value} ... {lines[-1:] }", flush=True)
    require(proc.returncode == 0 and lines[-1:] == ["=========="]
            and value == [f"value = {ref};"],
            f"the FlatZinc command line: exit {proc.returncode}, "
            f"{lines[-3:]}; {proc.stderr[-2000:]}")
    return launches


def queens_classic(n: int) -> tuple:
    """n-queens through the classic facade, every solution collected."""
    s = pywrapcp.Solver(f"queens{n}", device="cuda")
    q = [s.IntVar(0, n - 1, f"q{i}") for i in range(n)]
    s.AllDifferent(q)
    s.AllDifferent([q[i] + i for i in range(n)])
    s.AllDifferent([q[i] - i for i in range(n)])
    collector = s.AllSolutionCollector()
    collector.Add(q)
    ok = s.Solve(s.Phase(q), [collector])
    sols = [[collector.Value(k, v) for v in q]
            for k in range(collector.SolutionCount())]
    return ok, sols


def minimize_classic() -> tuple:
    """A small integer model through ``Solver.Minimize``: 3a + 2b + 4c >= 17,
    a + b <= 6, 0 <= a, b, c <= 10, minimize 5a + 4b + 7c."""
    s = pywrapcp.Solver("minimize", device="cuda")
    a, b, c = (s.IntVar(0, 10, name) for name in "abc")
    s.Add(3 * a + 2 * b + 4 * c >= 17)
    s.Add(a + b <= 6)
    cost = 5 * a + 4 * b + 7 * c
    obj = s.Minimize(cost, 1)
    ok = s.Solve(s.Phase([a, b, c]), [obj])
    return ok, s.Value(cost)


def classic_cp() -> dict:
    """(c) ``pywrapcp.Solver`` on the card: 8-queens with an all-solutions
    collector (92, each checked), and one ``Solve`` with ``Minimize`` at
    milp's optimum."""
    total: dict = {}
    (ok, sols), launches = counted("8-queens through pywrapcp.Solver, all "
                                   "solutions", queens_classic, 8)
    _add(total, launches)
    valid = {tuple(sq) for sq in sols
             if len({v + i for i, v in enumerate(sq)}) == 8
             and len({v - i for i, v in enumerate(sq)}) == 8
             and len(set(sq)) == 8}
    print(f"    {len(sols)} solutions, {len(valid)} distinct and valid",
          flush=True)
    require(ok and len(sols) == 92 and len(valid) == 92,
            f"8-queens: {len(sols)} solutions, {len(valid)} valid")
    res = milp(np.array([5.0, 4.0, 7.0]), constraints=LinearConstraint(
        np.array([[3.0, 2.0, 4.0], [1.0, 1.0, 0.0]]), [17, -np.inf],
        [np.inf, 6]), bounds=Bounds(0, 10), integrality=np.ones(3))
    ref = round(res.fun)
    (ok, value), launches = counted(f"pywrapcp Solve with Minimize (milp "
                                    f"{ref})", minimize_classic)
    _add(total, launches)
    print(f"    objective {value}", flush=True)
    require(ok and value == ref, f"pywrapcp Minimize: {ok} {value}")
    return total


def _example(stem: str):
    path = EXAMPLES_DIR / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(f"examples_torch_{stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _DeviceSpy:
    """For its length, records the ``device`` that each call of
    ``max_hs.minimize_max_hs`` is given."""

    def __enter__(self):
        self.devices = []
        self._orig = inner = cp_max_hs.minimize_max_hs

        def spy(*a, **k):
            self.devices.append(str(k.get("device")))
            return inner(*a, **k)
        cp_max_hs.minimize_max_hs = spy
        return self

    def __exit__(self, *exc):
        cp_max_hs.minimize_max_hs = self._orig


def examples() -> dict:
    """(d) The nine ``examples_torch/`` scripts, each ``main(device=
    "cuda")`` at its defaults, passing its own asserts."""
    total: dict = {}
    stems = sorted(p.stem for p in EXAMPLES_DIR.glob("*.py"))
    require(len(stems) == 9, f"examples_torch has {stems}")
    for stem in stems:
        mod = _example(stem)
        with _DeviceSpy() as spy:
            out, launches = counted(f"examples_torch/{stem}.py", mod.main,
                                    device="cuda")
        _add(total, launches)
        if stem == "pdlp_large_lp":
            require(out.termination_reason == TerminationReason.OPTIMAL,
                    f"pdlp_large_lp: {out.termination_reason.name}")
            require(exact_spmvs(launches) > 0,
                    f"pdlp_large_lp launched no SpMV: {launches}")
        if stem == "maxsat_wcnf":
            print(f"    minimize_max_hs called on {spy.devices}", flush=True)
            require(spy.devices and all(d.startswith("cuda")
                                        for d in spy.devices),
                    f"maxsat_wcnf's MaxHS ran on {spy.devices}")
    return total


def slice13(errs: dict) -> dict:
    """Phase 15.  Returns the launches of its counted calls; the kernels'
    largest errors on its matrices go into ``errs``."""
    t0 = time.perf_counter()
    bench_qp = block_random_lp(**BENCH)
    read_qp = lp_file_round_trip(bench_qp)
    launches = lp_file_solve(bench_qp, read_qp, errs)
    del read_qp, bench_qp
    torch.cuda.empty_cache()
    _add(launches, decomposed_stack(errs))
    _add(launches, jobshops())
    with tempfile.TemporaryDirectory(dir=FRONTEND_DIR) as tmp:
        _add(launches, flatzinc_knapsack(Path(tmp)))
    _add(launches, classic_cp())
    _add(launches, examples())
    print(f"phase 15: {time.perf_counter() - t0:.1f} s; launches {launches}",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# 16. The bench port
# ---------------------------------------------------------------------------

# bench_miplib's defaults are scale 1.0 and 120 s an instance; scale 0.25
# and 1 s are cuts, so that the battery (20 instances, HiGHS under the same
# limit) fits the run (1.0 and 3 s until phase 17 needed the room).
MIPLIB_SCALE = 0.25
MIPLIB_LIMIT = 1.0
BENCH_RUNS = (
    ("python -m ortools_tpu_torch bench", ["-m", "ortools_tpu_torch",
                                           "bench"], 420),
    ("bench_large_torch.py", ["bench_large_torch.py"], 300),
    (f"bench_miplib_torch.py {MIPLIB_SCALE:g} {MIPLIB_LIMIT:g}",
     ["bench_miplib_torch.py", f"{MIPLIB_SCALE:g}", f"{MIPLIB_LIMIT:g}"],
     420),
)
# bench.py's _emit keys (bench.py:298-317) and the port's additions
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline",
              "baseline_cpu_iter_per_sec_pinned",
              "baseline_cpu_iter_per_sec_live", "problem", "device",
              "fast_stream_iter_per_sec", "spmv",
              "batched64_lp_iterations_per_sec", "power_limit_w",
              "attempts_per_iteration")
SPMV_KEYS = ("dispatch_fixed_ms", "exact_us", "exact_gbps", "fast_us",
             "fast_gbps", "device_stream_gbps", "launch_floor_us")
LARGE_KEYS = ("metric", "value", "unit", "vs_baseline",
              "baseline_cpu_iter_per_sec", "problem", "device",
              "power_limit_w")


def _positive(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v) and v > 0


def bench_script(label: str, args: list, timeout: float) -> tuple:
    """One bench script in a subprocess from the checkout (the kernels
    built in phase 2 are reused): exit 0 and a JSON last line required.
    Prints its seconds and its stderr lines that start with ``#``; returns
    (the JSON object, its launches, seconds, those lines)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    notes = [ln for ln in proc.stderr.splitlines() if ln.startswith("#")]
    print(f"{label}: exit {proc.returncode} in {dt:.1f} s", flush=True)
    for ln in notes:
        print(f"  {ln}")
    require(proc.returncode == 0,
            f"{label} failed: {proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    require(bool(lines), f"{label} printed nothing")
    try:
        out = json.loads(lines[-1])
    except json.JSONDecodeError:
        raise SmokeFailure(f"{label}'s last line is not JSON: "
                           f"{lines[-1][:500]}") from None
    launches = [json.loads(ln.split(":", 1)[1]) for ln in notes
                if ln.startswith("# launches:")]
    require(len(launches) == 1, f"{label} printed no launch line")
    return out, launches[0], dt, notes


def slice14(stream_s: dict) -> tuple:
    """Phase 16.  ``stream_s``: phase 5's seconds per major of each stream.
    Returns the summed launches of the three scripts and the bench's
    ``device_stream_gbps``."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    name = torch.cuda.get_device_name(0)
    results, total = [], {}
    for label, args, timeout in BENCH_RUNS:
        out, launches, _, _ = bench_script(label, args, timeout)
        results.append(out)
        _add(total, launches)
    bench, large, miplib = results

    missing = [k for k in BENCH_KEYS if k not in bench] + [
        f"spmv.{k}" for k in SPMV_KEYS if k not in bench.get("spmv", {})]
    require(not missing, f"the bench's JSON lacks {missing}")
    rates = dict(value=bench["value"],
                 fast_stream_iter_per_sec=bench["fast_stream_iter_per_sec"],
                 exact_us=bench["spmv"]["exact_us"],
                 fast_us=bench["spmv"]["fast_us"],
                 device_stream_gbps=bench["spmv"]["device_stream_gbps"],
                 batched64=bench["batched64_lp_iterations_per_sec"])
    require(all(_positive(v) for v in rates.values()),
            f"a bench rate is not finite and positive: {rates}")
    require(bench["device"] == name and large["device"] == name,
            f"the benches name another device: {bench['device']}, "
            f"{large['device']}")
    print(f"bench: {json.dumps(bench)}")
    freq = PdhgParams().termination_check_frequency
    for stream, key in (("exact", "value"),
                        ("fast", "fast_stream_iter_per_sec")):
        p5 = freq / stream_s[stream]
        print(f"{stream} stream: bench {bench[key]} iter/s (main graphs "
              f"only), phase 5 {p5:.1f} iter/s (majors with statistics and "
              f"the host's read): ratio {bench[key] / p5:.3f}; attempts per "
              f"iteration {bench['attempts_per_iteration'][stream]}")

    missing = [k for k in LARGE_KEYS if k not in large]
    require(not missing, f"bench_large's JSON lacks {missing}")
    require(_positive(large["value"]),
            f"bench_large's rate is {large['value']}")
    print(f"bench_large: {json.dumps(large)}")

    records = miplib.get("instances", [])
    require(len(records) == 20, f"bench_miplib gave {len(records)} records")
    solved = [r for r in records if r["status"] in ("OPTIMAL", "FEASIBLE")]
    require(all((r.get("feasible") in (True, False))
                == (r["status"] in ("OPTIMAL", "FEASIBLE"))
                for r in records),
            "a bench_miplib record lacks its feasibility check")
    print(f"bench_miplib at scale {MIPLIB_SCALE:g}, {MIPLIB_LIMIT:g} s an "
          f"instance: matched "
          f"{miplib['value']} ({sum(r['matched'] for r in records)}/20), "
          f"{len(solved)} with a solution, "
          f"{sum(r['feasible'] is True for r in solved)} of them feasible; "
          f"{miplib['total_nodes']} nodes")
    for r in records:
        print(f"  {r}")
    # The benches' LPs are dense 8x128 blocks: every block kernel runs,
    # and the layout rule leaves the row kernel out.
    require(all(total[k] > 0 for k in list(KERNELS) + [SPMM["name"]])
            and total[ROWS["name"]] == total.get(ROWS_SPMM["name"], 0) == 0,
            f"a kernel was not launched by the benches: {total}")
    print(f"phase 16: {time.perf_counter() - t0:.1f} s; launches {total}",
          flush=True)
    return total, rates["device_stream_gbps"]


# ---------------------------------------------------------------------------
# 17. The JAX package's last scripts
# ---------------------------------------------------------------------------

# bench_onchip_search's host baselines take 120 s each; 5 s is a cut, so
# that phase 17 fits the run (the JAX script's host simplex ran 1 node in
# its 120 s, its host FJ found no cover; at 10 s the port's ran 1 node and
# found none either).
ONCHIP_HOST_LIMIT = 5.0
# The mesh of bench_multichip_large_torch.py's mesh solve: 2x2 on 4 gloo
# ranks, a cut (the script's default is 2x4 on 8 ranks, 124 s on one card
# against 104 s for 2x2: the ranks exchange the vectors' segments through
# the host at every product); the census is taken at 2x4 whatever the mesh.
MULTICHIP_MESH = "2x2"
SCRIPT_RUNS = (
    ("bench_roofline_torch.py", ["scripts/bench_roofline_torch.py"], 300),
    ("bench_lp_suite_batch_torch.py",
     ["scripts/bench_lp_suite_batch_torch.py"], 400),
    (f"bench_onchip_search_torch.py --host-limit {ONCHIP_HOST_LIMIT:g}",
     ["scripts/bench_onchip_search_torch.py", "--host-limit",
      f"{ONCHIP_HOST_LIMIT:g}"], 600),
    (f"bench_multichip_large_torch.py --mesh {MULTICHIP_MESH}",
     ["scripts/bench_multichip_large_torch.py", "--mesh", MULTICHIP_MESH],
     900),
)
# Each script's keys: the JAX script's (a key that names the TPU renamed)
# and the port's two
CARD_KEYS = ("device", "power_limit_w")
ROOFLINE_KEYS = ("metric", "array_mib", "bytes_per_iteration", "samples",
                 "fixed_overhead_ms", "per_iteration_us",
                 "in_dispatch_gb_per_s", "single_dispatch_gb_per_s",
                 "h100_peak_gb_per_s", "fraction_of_paper_peak",
                 "devices") + CARD_KEYS
LP_SUITE_KEYS = ("metric", "devices", "n_instances", "stacked_shape",
                 "stacked_nnz", "status", "iterations", "batch_solve_sec",
                 "verified_ok") + CARD_KEYS
ONCHIP_KEYS = ("metric", "devices", "node_lp_pdhg",
               "feasibility_jump") + CARD_KEYS
NODE_LP_KEYS = ("instance", "n_vars", "n_rows", "n_nodes", "batch",
                "root_solve_sec", "device_nodes_per_sec", "device_wall_sec",
                "device_optimal", "device_infeasible", "host_backend",
                "host_nodes_per_sec", "host_nodes_run", "host_optimal",
                "speedup_vs_host")
FJ_KEYS = ("instance", "greedy_cost", "cutoff", "device_found",
           "device_cost", "device_sec", "device_moves_per_sec",
           "device_seeds", "host_found", "host_cost", "host_sec",
           "device_beats_host")
MULTICHIP_KEYS = ("metric", "instance", "m", "n", "nnz", "mesh",
                  "block_shape", "blocks_per_cell", "cell_padding_ratio",
                  "single_device", "mesh_2d",
                  "objective_rel_diff") + CARD_KEYS
SOLVE_KEYS = ("status", "iterations", "objective", "sec")
# The 2x4 cell census of the 1.04M-nonzero LP: it depends only on the
# sparsity pattern and the padding (the JAX package's
# artifacts/MULTICHIP_r05_large.json)
CENSUS_2X4 = [17526, 17526, 3858, 0, 11153, 11153, 24821, 28679]
ROOFLINE_SLACK = 1.05  # above 1.05 x the HBM rate a step did not stream
ONCHIP_LP = dict(num_nodes=120, num_arcs=800, num_commodities=32, seed=1)
MULTICHIP_LP = dict(num_nodes=200, num_arcs=2700, num_commodities=128,
                    seed=3)


def _lacks(obj: dict, keys) -> list:
    return [k for k in keys if k not in obj]


def _non_finite(obj, path: str = "") -> list:
    """The paths of the numbers in ``obj`` that are not finite (None and
    booleans are no numbers)."""
    if isinstance(obj, dict):
        return [p for k, v in obj.items()
                for p in _non_finite(v, f"{path}.{k}")]
    if isinstance(obj, list):
        return [p for i, v in enumerate(obj)
                for p in _non_finite(v, f"{path}[{i}]")]
    if isinstance(obj, float) and not math.isfinite(obj):
        return [path]
    return []


def script_run(label: str, args: list, timeout: float, keys) -> tuple:
    """``bench_script`` and the JSON's keys and numbers checked."""
    out, launches, dt, notes = bench_script(label, args, timeout)
    require(not _lacks(out, keys), f"{label}'s JSON lacks {_lacks(out, keys)}")
    require(not _non_finite(out), f"{label}: numbers not finite: "
            f"{_non_finite(out)}")
    require(out["device"] == torch.cuda.get_device_name(0),
            f"{label} names another device: {out['device']}")
    return out, launches, dt, notes


def roofline(stream_gbps: float) -> dict:
    out, launches, dt, _ = script_run(*SCRIPT_RUNS[0], ROOFLINE_KEYS)
    rate = out["in_dispatch_gb_per_s"]
    peak = out["h100_peak_gb_per_s"]
    print(f"roofline: in-graph {rate} GB/s ({out['fraction_of_paper_peak']}"
          f" of {peak}), {out['per_iteration_us']} us a step, fixed "
          f"{out['fixed_overhead_ms']} ms, one step alone "
          f"{out['single_dispatch_gb_per_s']} GB/s; phase 16's "
          f"device_stream_gbps {stream_gbps} (one 64-step graph, fixed "
          f"cost included); samples {out['samples']}", flush=True)
    require(peak == PEAK_BYTES_PER_S / 1e9,
            f"the roofline's peak is {peak}, not the data sheet's")
    require(0 < rate <= ROOFLINE_SLACK * peak,
            f"the roofline's slope is {rate} GB/s: a step did not stream "
            f"from HBM")
    return launches


def lp_suite(errs: dict) -> dict:
    out, launches, dt, notes = script_run(*SCRIPT_RUNS[1], LP_SUITE_KEYS)
    checked = [ln for ln in notes if "HiGHS status" in ln]
    print(f"LP suite {out['stacked_shape']}, {out['stacked_nnz']} nonzeros:"
          f" {out['status']} after {out['iterations']} iterations in "
          f"{out['batch_solve_sec']} s; verified {out['verified_ok']}; "
          f"{len(checked)} blocks checked against HiGHS", flush=True)
    require(out["status"] == "PRIMAL_INFEASIBLE",
            f"the LP suite ended {out['status']}, not PRIMAL_INFEASIBLE "
            f"(blocks 10 and 11 are infeasible)")
    require(len(checked) == out["n_instances"] == 12,
            "a block of the LP suite was not checked against HiGHS")
    require(exact_spmvs(launches) > 0,
            "the LP suite launched no exact SpMV")
    spec = importlib.util.spec_from_file_location(
        "bench_lp_suite_batch_torch",
        ROOT / "scripts" / "bench_lp_suite_batch_torch.py")
    suite_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(suite_mod)
    stack = suite_mod.stack([qp.as_minimization()
                             for qp in suite_mod.build_suite()])
    prob = pdlp_solver.build_device_problem(stack, suite_mod.params(),
                                            "cuda")
    for name, mat in (("A", prob.a), ("A^T", prob.at)):
        check_built(f"LP suite stack {name}", mat, errs)
    return launches


def onchip_search(errs: dict) -> dict:
    out, launches, dt, notes = script_run(*SCRIPT_RUNS[2], ONCHIP_KEYS)
    node, fj = out["node_lp_pdhg"], out["feasibility_jump"]
    require(not _lacks(node, NODE_LP_KEYS) and not _lacks(fj, FJ_KEYS),
            f"the on-chip search's JSON lacks {_lacks(node, NODE_LP_KEYS)}"
            f" {_lacks(fj, FJ_KEYS)}")
    print(f"node LPs ({node['n_rows']} x {node['n_vars']}): root "
          f"{node['root_solve_sec']} s, {node['device_optimal']}/"
          f"{node['n_nodes']} OPTIMAL at {node['device_nodes_per_sec']} "
          f"nodes/s ({node['device_wall_sec']} s); host simplex "
          f"{node['host_nodes_per_sec']} nodes/s ({node['host_nodes_run']} "
          f"run, {node['host_optimal']} optimal, {ONCHIP_HOST_LIMIT:g} s)",
          flush=True)
    print(f"device FJ on {fj['instance']}: found {fj['device_found']}, cost "
          f"{fj['device_cost']} (cutoff {fj['cutoff']}, greedy "
          f"{fj['greedy_cost']}) in {fj['device_sec']} s, "
          f"{fj['device_moves_per_sec']} moves/s; host FJ found "
          f"{fj['host_found']} in {fj['host_sec']} s", flush=True)
    require(node["device_optimal"] == node["n_nodes"] == 128,
            f"{node['device_optimal']} of 128 node LPs OPTIMAL")
    require(fj["device_found"] and fj["device_cost"] <= fj["cutoff"],
            "the device FJ found no cover at or below the cutoff")
    require(any(ln.startswith("# cover check: passed") for ln in notes),
            "the device FJ's cover did not pass the numpy check")
    require(batched_products(launches) > 0, "the node LPs launched no SpMM")
    qp = multicommodity_flow_lp(**ONCHIP_LP)
    prob = pdlp_solver.build_device_problem(
        qp, PdhgParams(dtype=torch.float32, stream_precision="exact"),
        "cuda")
    for name, mat in (("A", prob.a), ("A^T", prob.at)):
        check_spmm(f"on-chip search {name}", mat.without_tiled(), BATCH,
                   errs)
    return launches


def multichip(errs: dict) -> dict:
    out, launches, dt, notes = script_run(*SCRIPT_RUNS[3], MULTICHIP_KEYS)
    one, mesh = out["single_device"], out["mesh_2d"]
    require(not _lacks(one, SOLVE_KEYS) and not _lacks(mesh, SOLVE_KEYS),
            "the multichip JSON lacks a solve's key")
    print(f"multichip {out['instance']} ({out['m']} x {out['n']}, "
          f"{out['nnz']} nonzeros): census {out['blocks_per_cell']} at "
          f"{out['block_shape']}; single {one['status']} "
          f"{one['iterations']} iterations {one['sec']} s; {out['mesh']} "
          f"{mesh['status']} {mesh['iterations']} iterations {mesh['sec']} "
          f"s; objectives {one['objective']!r} / {mesh['objective']!r} "
          f"(rel {out['objective_rel_diff']:.2e})", flush=True)
    require(out["blocks_per_cell"] == CENSUS_2X4,
            f"the 2x4 census {out['blocks_per_cell']} is not {CENSUS_2X4}")
    require(one["status"] == mesh["status"] == "OPTIMAL",
            "a multichip solve did not end OPTIMAL")
    require(out["objective_rel_diff"] <= 1e-6,
            "the single and mesh objectives differ by more than 1e-6")
    require(exact_spmvs(launches) > 0,
            "the single f64 solve launched no exact SpMV")
    require(any(ln.startswith("# single solve:") and "peak device memory"
                in ln for ln in notes),
            "the single solve printed no peak device memory")
    t0 = time.perf_counter()
    prob = pdlp_solver.build_device_problem(
        multicommodity_flow_lp(**MULTICHIP_LP),
        PdhgParams(dtype=torch.float64), "cuda")
    print(f"the f64 problem built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, mat in (("A", prob.a), ("A^T", prob.at)):
        check_built(f"multichip {name}", mat, errs)
    return launches


def slice15(stream_gbps: float, largest: dict) -> dict:
    """Phase 17: the four device scripts of scripts/ in subprocesses, each
    checked; their kernels against the plain versions on the scripts'
    matrices (the largest errors printed, and folded into ``largest``).
    Returns the launches summed from the scripts' ``# launches`` lines."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    errs: dict = {}
    total: dict = {}
    _add(total, roofline(stream_gbps))
    _add(total, lp_suite(errs))
    _add(total, onchip_search(errs))
    torch.cuda.empty_cache()
    _add(total, multichip(errs))
    torch.cuda.empty_cache()
    print(f"phase 17: {time.perf_counter() - t0:.1f} s; launches {total}; "
          f"largest errors {errs}", flush=True)
    _fold(largest, errs)
    return total


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    package_root = Path(ortools_tpu_torch.__file__).resolve().parents[1]
    if package_root != ROOT:
        print(f"chip_smoke: ortools_tpu_torch comes from {package_root}, "
              f"not from this checkout ({ROOT})", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    phase("1. environment")
    smi_line = environment()

    phase("2. build the kernels (nvcc -Xptxas -v) and the native cores (g++)")
    t0 = time.perf_counter()
    native = build_native()
    report = _build.build()
    for name in _build.SOURCES:
        _build.library(name)
    native.join()
    require(native.error is None, f"the native build failed: {native.error}")
    print(report.strip())
    print("native cores:", ", ".join(native_build.library_path(name).name
                                     for name in NATIVE))
    print(f"build and load: {time.perf_counter() - t0:.1f} s")
    spilled = spmm_spills(report)
    require(not spilled, f"SpMM instantiations spill registers: {spilled}")

    phase("3. kernels against their plain versions on the card")
    bench_qp = block_random_lp(**BENCH)
    bench_params = PdhgParams(**BENCH_PARAMS)
    bench_prob = pdlp_solver.build_device_problem(bench_qp, bench_params,
                                                  "cuda")
    errs = kernels_against_plain(bench_prob)
    # freed so that the main path's peak memory is its own
    del bench_prob
    torch.cuda.empty_cache()

    phase("4. moderate LPs to OPTIMAL against HiGHS")
    moderate_solve(errs=errs)

    phase("5. full width: the bench LP through pdlp.solve")
    launches = main_path(bench_qp)
    bench_prob = pdlp_solver.build_device_problem(bench_qp, bench_params,
                                                  "cuda")
    major_s, majors = stream_rates(bench_prob)
    device_profile(majors, major_s)
    del majors
    stats_times(bench_prob)
    times = kernel_times(bench_prob)
    launch_floor()
    shape_times(bench_prob)
    del bench_prob
    torch.cuda.empty_cache()
    row_ms = row_times()
    rows_spmm_ms = rows_spmm_times()
    boundary = boundary_times()

    phase("6. the rest of the solve: ADAPTIVE_HEURISTIC, Malitsky-Pock, "
          "polishing, presolve")
    rest_of_solve(bench_qp)

    phase("7. the batched solve: SpMM kernel, solve_batch, PdhgNodeBackend")
    bench_prob = pdlp_solver.build_device_problem(
        bench_qp, dataclasses.replace(bench_params, stream_precision="exact"),
        "cuda")
    errs.update(spmm_against_plain(bench_prob))
    batched_moderate()
    mip_pair()
    del bench_prob
    torch.cuda.empty_cache()
    batch_launches, backend = batched_main_path(bench_qp)
    batched_rates(backend)
    spmm = spmm_times(backend._solver.prob)
    del backend
    torch.cuda.empty_cache()

    phase("9. the MIP path: the device FJ, mip.solve with PDHG node LPs, "
          "mip.solve under the defaults")
    mip_launches = mip_path(errs)

    phase("10. the front end: MPS round trip at full width, Solver('pdlp') "
          "on the imported bench LP, the CLI, math_opt, knapsack, set cover")
    front_launches = front_end(bench_qp)

    phase("11. the mesh: NCCL with one rank at full width, gloo ranks "
          "sharing the card")
    mesh_launches = nccl_mesh(bench_qp)
    shard_errs = gloo_ranks()

    phase("12. the host front ends: bin packing (assignment MIP, arc "
          "flow), BOP, IntegralSolver, MaxHS; matching runs on the host "
          "(CPU tests only)")
    host_launches = host_front_ends(errs)

    phase("13. CP-SAT: ft10 at full width, MaxHS through CpSolver, pure "
          "SAT, PB, LCG, the integer encoding, the DFS engine with the node "
          "LP, 8-queens enumerated")
    cp_launches = cp_sat()

    phase("14. CP-SAT's portfolios (ft10 interleaved and forked, the shared "
          "tree), model I/O, the runner, DRAT; the graph algorithms at full "
          "size; routing (CVRP and VRPTW on 101 nodes, certification, "
          "breaks)")
    slice12_launches, fork_errs = slice12()

    phase("15. the last modules: the bench LP through an LP file, the "
          "decomposer, scheduling (ft10 on LCG), FlatZinc, pywrapcp, the "
          "nine examples")
    slice13_launches = slice13(errs)

    phase("16. the bench port: python -m ortools_tpu_torch bench, "
          "bench_large_torch.py, bench_miplib_torch.py "
          f"{MIPLIB_SCALE:g} {MIPLIB_LIMIT:g}")
    slice14_launches, stream_gbps = slice14(major_s)

    phase("17. the JAX package's last scripts: the HBM roofline, the LP "
          "suite as one LP, on-chip search, the 1.04M-nonzero LP on one "
          f"card and on a {MULTICHIP_MESH} mesh")
    slice15_launches = slice15(stream_gbps, errs)

    phase("8. kernels")
    kernels = []
    for name, spec in KERNELS.items():
        a, at = times[(name, "A")], times[(name, "A^T")]
        kernels.append(dict(
            name=name, route=spec["route"], source=spec["source"],
            replaces=spec["replaces"], launches=launches[name],
            max_abs_err=errs[name], ms=a["ms"], plain_ms=a["plain_ms"],
            bound_ms=a["bound_ms"], bound_by=a["bound_by"],
            library_ms=a["library_ms"], warm_ms=a["warm_ms"],
            bsr_ms=a["bsr_ms"], bf16_csr=a["bf16_csr"], transpose=at,
            mip_path_launches=mip_launches[name],
            frontend_launches=front_launches[name],
            mesh_path_launches=mesh_launches[name],
            mesh_shard_max_abs_err=shard_errs[name],
            host_front_ends_launches=host_launches[name],
            cp_sat_launches=cp_launches[name],
            slice12_launches=slice12_launches[name],
            after_fork_max_abs_err=fork_errs[name],
            slice13_launches=slice13_launches[name],
            phase16_launches=slice14_launches[name],
            phase17_launches=slice15_launches[name], ok=True))
    a = spmm["A"]
    kernels.append(dict(
        name=SPMM["name"], route=SPMM["route"], source=SPMM["source"],
        replaces=SPMM["replaces"], launches=batch_launches[SPMM["name"]],
        max_abs_err=errs[SPMM["name"]], ms=a["ms"], plain_ms=a["plain_ms"],
        bound_ms=a["bound_ms"], bound_by=a["bound_by"],
        library_ms=a["library_ms"], warm_ms=a["warm_ms"], batch=BATCH,
        gathered_bytes=a["gathered_bytes"], transpose=spmm["A^T"],
        f64=[spmm["f64 A"], spmm["f64 A^T"]],
        mip_path_launches=mip_launches[SPMM["name"]],
        frontend_launches=front_launches[SPMM["name"]],
        mesh_path_launches=mesh_launches[SPMM["name"]],
        host_front_ends_launches=host_launches[SPMM["name"]],
        cp_sat_launches=cp_launches[SPMM["name"]],
        slice12_launches=slice12_launches[SPMM["name"]],
        slice13_launches=slice13_launches[SPMM["name"]],
        phase16_launches=slice14_launches[SPMM["name"]],
        phase17_launches=slice15_launches[SPMM["name"]], ok=True))
    name = ROWS["name"]
    kernels.append(dict(
        name=name, route=ROWS["route"], source=ROWS["source"],
        replaces=ROWS["replaces"], max_abs_err=errs[name],
        mesh_shard_max_abs_err=shard_errs.get(name, 0.0), times=row_ms,
        boundary={k: v for k, v in boundary.items() if " B=" not in k},
        mip_path_launches=mip_launches.get(name, 0),
        frontend_launches=front_launches.get(name, 0),
        mesh_path_launches=mesh_launches.get(name, 0),
        host_front_ends_launches=host_launches.get(name, 0),
        cp_sat_launches=cp_launches.get(name, 0),
        slice12_launches=slice12_launches.get(name, 0),
        slice13_launches=slice13_launches.get(name, 0),
        phase16_launches=slice14_launches.get(name, 0),
        phase17_launches=slice15_launches.get(name, 0), ok=True))
    name = ROWS_SPMM["name"]
    kernels.append(dict(
        name=name, route=ROWS_SPMM["route"], source=ROWS_SPMM["source"],
        replaces=ROWS_SPMM["replaces"], max_abs_err=errs[name],
        times=rows_spmm_ms, batch=BATCH,
        boundary={k: v for k, v in boundary.items() if " B=" in k},
        batched_path_launches=batch_launches.get(name, 0),
        mip_path_launches=mip_launches.get(name, 0),
        frontend_launches=front_launches.get(name, 0),
        mesh_path_launches=mesh_launches.get(name, 0),
        host_front_ends_launches=host_launches.get(name, 0),
        cp_sat_launches=cp_launches.get(name, 0),
        slice12_launches=slice12_launches.get(name, 0),
        slice13_launches=slice13_launches.get(name, 0),
        phase16_launches=slice14_launches.get(name, 0),
        phase17_launches=slice15_launches.get(name, 0), ok=True))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
