"""Drive the PyTorch/CUDA port on one card and check it.

    python3 chip_smoke.py [--seed S] [--budget committed|planned] [--json PATH]
                          [--six-month SIGMA_N,STARTS,ITERS,SCAN[,MONTHS]]
                          [--nd] [--stochastic] [--distributed] [--dense]
                          [--nested]

Run from the root of a checkout on a machine with an NVIDIA GPU.  It builds
the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per source, all
started together) and then:

  1. kernel phase: each kernel of the six paths (B1 tile_matvec, B2
     tile_tangent, B4 tile_matrix; B5 ski_gram, B6 ski_tangent; B7
     ski_bank; B8 tile_matvec_nd, B9 tile_tangent_nd, B10 ski_gram_2d,
     B11 ski_tangent_2d; B12 tile_rows, B13 tile_rows_nd; B3 tile_jvp) at
     the shapes
     its workflow gives it, held
     against its plain PyTorch version on the same inputs (float64, and
     one float32 case of B5, B6, B7, B10 and B11), and timed (CUDA
     events, median of repeats) beside the plain version and the least
     time the card could take (the roofline bound below); B5 is also
     timed against its plain version at n ~ 600, 2000 and 7080 (where the
     card's own crossover lies), and B7 at B = 1 is held against B5 on
     the same inputs; every B5, B6 and B7 case prints its plan
     (ski_gram_plan: the four-step split L1 x L2, the directions, launches
     per call, scratch bytes), and B5 and B7 also run on the
     sequential-vs-bank check's
     record (L = 2048, case "record": B5 at b = 9 in float64 and float32,
     B7 at B = 4, c = 9); B1 also at "se" (no
     Wendland window), k2 with T0 = 2000 h, k2 on unsorted points and
     k2 at b = 16 and 17 (either side of its register / tensor-core
     switch), each B1 case with the share of
     entries inside the window (support_share) and the (stripe, tile) pairs
     its kernel skips (tiles_skipped); B2 at k1 and k2 with b = 9, 1, 8,
     16 and 17, k2 with T0 = 2000 h, k2 on unsorted points with random
     dense pdots of m = 1 .. 5 rows, and at the stochastic 1-D stage's
     shape ("se", n = 65536, b = 9, m = 1; also under --stochastic), each
     with support_share and tiles_skipped on its own stripes; B9 at m = 2
     ("se*matern32") and m = 6 ("k2*se") on the irregular (n, 2) stage's
     4096 points, and at the stochastic (n, 2) stage's shape, where it
     launches most ("se*matern32", n1 = n2 = 65536, b = 9, m = 2; also
     under --stochastic; the kernels line's case), each against its
     plain version on every row; B10 at the
     product-SKI cell (b = 9,
     8, 1, 256, float32) and on a field whose time axis is longer than its
     float64 line cap (L1 = 8192: axis 0 on the global passes), each case
     with its plan (line cap, branches, launches per call, scratch bytes);
     B11 at the product-SKI cell (m = 2, b = 9, float32; m = 6, "k2*se")
     and on the long field (B10's gram once per direction), each case
     with the same plan; B4 at the predict cross block (8760 x 512) for
     k1, k2 and "se" and at an odd n2 = 511 (k2), each with its
     support_share;
     B12 and B13 at b = 2048 rows of n2 =
     65536 with k = 1, 9 and 256 columns, a ragged b = 1000 of n2 = 65537,
     b = 8, and one float32 case, and B13 on "k2*se" at k = 9; B3 at B2's
     shape (n = 8760, k2, b = 9,
     beside B2's time over its m = 5 directions), at the distributed
     gradient's b = 1, 8 and 16 and at b = 17, on a ragged 1000 x 1001
     block, for all six kinds at n = 1000, b = 8, and one float32 case,
     each with support_share and tiles_skipped;
  2. irregular phase: the paper's workflow through the front door on one
     year of hourly-scale irregular sampling (n = 8760, the tile
     operator): GP.bind -> fit -> log_evidence -> predict at n* = 512 with
     variance;
  3. SKI phase: a gappy tide-gauge record (two years of the two-hour
     cadence, n_full = 7869, 10% of the samples dropped, n ~ 7080: a near
     grid, the SKI operator with B5 and B6, the circulant preconditioner
     and CG cut at SKI_CG_MAX_ITER): GP.bind(k2) -> fit -> log_evidence
     -> compare (ln B of k2 vs k1 with the default batch="auto": the
     batched bank, one B7
     launch per CG or Lanczos iteration, never B5) -> predict at 512
     points with variance and the SKI-interpolated cross covariance; the
     compare stage prints the bank's structure, fused, preconditioner, B,
     its B7 launches and how its CG solves ended; then, at the fitted
     peak, the
     phase's answers against the exact GP (a dense Cholesky of the same
     K, which the one-hot W makes exact): a cut CG solve whose K-norm
     error exceeds the zero start's fails the run, and the errors of
     ln P, the mean and the variance are reported;
     in phases 2 and 3 the launch counts are set to 0 just before and read
     just after, and each stage prints how its CG solves ended (tolerance
     or cg_max_iter) and the eigenvalues of every Laplace Hessian it
     formed;
  4. sequential vs bank: a 3-month gappy record (n ~ 885, the iterative
     backend pinned, sigma_n = 0.03; 6 months, n ~ 1770, until the N-D
     phase needed its time) through compare(batch="off") and
     compare(batch="auto") on the same data and key; both must give
     finite ln Z and pick the same model; ln B of both and their
     difference are printed;
  5. N-D phase: a gappy spatio-temporal field (the recipe of
     examples/spatiotemporal.py on a 128 x 64 time x space grid, spacings
     (0.5, 0.25), 15% of the records dropped, sigma_n = 0.05, n ~ 6960),
     "se*matern32", the default policy (iterative at n > 2048, the
     per-axis data-dependent box, precond "auto", no scan) with 2 starts
     of 25 steps, in three stages, the launch counts set to 0 before each
     and read after:
       - product SKI (fused, B10/B11; plain SLQ, and the exceptions
         below): bind -> fit -> log_evidence -> compare(["se*se",
         "se*matern32"]) with the default batch="auto" (the multi-axis
         bank, the unfused Kronecker cycle on torch.fft) -> predict at
         512 off-grid points with variance and cross="interp";
       - Kronecker: the same field with no drops (n = 8192): bind -> fit
         (one start, ND_SHORT_ITERS steps) -> predict (the mean is B8, the cross
         block B4 per factor);
       - irregular (n, 2): 4096 uniform points in the same box, the
         product tiles (CG on B8, gradients on B9): bind -> fit (one
         start, ND_SHORT_ITERS steps) -> predict;
     each stage prints its wall-clock, CG stops, Laplace Hessian
     eigenvalues and peak allocation (from bind to predict), and the
     phase fails unless B10 and B11 ran in the
     first stage and B8 and B9 in the third; after the product-SKI stage
     its answers at the fitted peak are held against the exact GP as in
     phase 3 (`nd_at_peak`: a diverging cut solve fails the run), and the
     same solves run behind the product-SKI circulant CG
     preconditioner (the JAX package's: no noise in its spectrum) and
     none, cut at 400 and 4000 iterations.  The product-SKI session's own
     solves (fit, log_evidence, predict) run with no CG preconditioner
     and a cap of 2000 iterations, so that they end on their tolerance,
     and its fit takes one start: behind that preconditioner the fit cut
     1115 of 1135 solves and ended where the Laplace Hessian has a
     negative eigenvalue, a nan ln Z, and behind none cut at 400 it did
     the same (PERF.md); its compare keeps "auto" (the bank's own
     circulant preconditioner, with the noise) and 2 starts;
  6. stochastic phase: structure-free data at n = 65536 through
     backend="auto", which must bind the stochastic backend (EigenPro
     mini-batches on the row slabs B12/B13, gradients on B2/B9), in two
     stages with the launch counts, host syncs, epoch tally and the peak
     allocation reset before each:
       - 1-D: the repository's recipe for this backend (run_stochastic in
         examples/large_scale_gp.py): sorted uniform times on [0, 100],
         y = sin 2.1x + 0.3 sin 0.37x + 0.1 noise, "se", sigma_n 0.1,
         SolverOpts(n_probes=8) with the default 1024 MB budget;
       - (n, 2): make_scattered_field at n = 65536, "se*matern32",
         sigma_n 0.05;
     each bind -> fit (one start, pinned at theta = 0 as run_stochastic
     pins it, STOCHASTIC_ITERS steps; from a uniform start the (n, 2)
     fit runs to the box's edge, as the JAX package's does on the same
     recipe at n = 1024) -> log_evidence -> predict at 256 points with
     variance; each prints the plan (batch, rank,
     adaptive), the epochs each solve used, the launches, host syncs,
     stage times, Laplace Hessian eigenvalues and the peak allocation,
     and fails unless B12 (B13) launched, ln P and ln Z are finite, the
     variance lies in [0, sigma_f^2 (1 + sigma_n^2)] and the peak
     allocation stayed under 2 x mem_budget_mb; at the fitted peak one
     exact B1 (B8) matvec gives the true relative residual
     ||(K + sigma^2 I) alpha - y|| / ||y|| of the stochastic alpha, which
     must not exceed 1 (the zero start's); and at the start and the peak
     the slope probe (stochastic_slope_probe: the Hutchinson gradient's
     slope along itself against central differences of the value, split
     into the quadratic and the log-det parts), printed, not checked;
  7. distributed phase: the row-sharded GP step
     (core/distributed.distributed_profiled_loglik) on a world-size-1
     NCCL group (launch/mesh.make_local_group), in three stages, the
     launch counts and host syncs set to 0 before each and read after:
       - distributed_tile: the irregular cell's data (n = 8760, k2,
         sigma_n 0.1) at the reference tests' theta, 16 probes, 64
         Lanczos steps, CG cut at 600: the tile branch, B1 for K v and
         B3 for the gradient (2 x 5 launches, B2 none);
       - distributed_example: examples/large_scale_gp.py's own call (the
         paper's synthetic k2 draw at t = 1..4096, its theta, 8 probes,
         48 Lanczos steps, CG cut at 300): the Toeplitz branch; prints
         its ln P_max as the example does;
       - distributed_ski: the SKI cell's tide record (n ~ 7063, sigma_n
         0.01): the SKI branch (its tangents B6), CG to its tolerance
         (cap DIST_SKI_CG_MAX_ITER) and DIST_SKI_LANCZOS_K Lanczos
         steps; the same at the default 64 steps (CG cut at 3000) is
         printed as distributed_ski_k64 and not checked (its SLQ
         log-det is far off at this noise);
     each fails unless its result is finite and, against the exact
     ln P_max and gradient at the same theta from a dense Cholesky on the
     card (K from B4, dK from the plain tangent blocks), |d ln P / ln P|
     <= 0.08 and the gradient's cosine >= 0.99 (the JAX package's own
     bounds; a cut CG is printed); then the card against the CPU (gloo,
     plain versions) at n = 1024 on all three branches with the same
     probes, sigma_n 0.5 and CG to its tolerance (<= 1e-8), and one
     StochasticSolver(group=) solve against group=None at n = 4096
     (<= 1e-12, equal row-slab launches);
  8. small-input checks: ln P_max and its gradient on the card against
     the port's CPU path (plain PyTorch) with the same probes, on an
     irregular input, a gappy record (SKI) and its un-dropped grid
     (Toeplitz), a gappy 2-D field (product SKI), its full grid
     (Kronecker) and scattered (n, 2) points (the product tiles); the
     bank objective's values and gradients on a gappy record (B7), on
     its grid (the Toeplitz bank) and on the gappy 2-D field (the
     multi-axis bank); the product-SKI preconditioned path in pieces that
     need no converged CG (product_ski_precond_checks: its CG and SLQ
     preconditioners on fixed vectors to 1e-12, the objective with every
     CG solve cut at PSKI_CUT_ITERS, and the stalled solves' gap
     printed); and the stochastic objective (backend pinned, the same
     probes and epoch permutations) at n = 1024, 1-D and (n, 2);
  9. dense phase (the paper's own regime, n <= 2048, where
     backend="auto" binds the dense backend: one Cholesky per likelihood
     evaluation on torch.linalg, no hand kernel), on the two records of
     the paper's examples, built by the port's data modules from --seed:
       - quickstart: synthetic(key 42 + seed, 100, "k2") (sigma_n 0.1),
         compare(["k1", "k2"]) at the example's budget (10 restarts, 80
         steps, 256 scan points per hyperparameter), then predict at 7
         points and sample 3 joint draws at the winner's peak;
       - tide: woods_hole_like(key seed, months=6) (n = 1968, the largest
         record under the cutoff, sigma_n 0.01), compare(["k1", "k2"]) at
         the budget of benchmarks/tidal.analyse (12 restarts, 100 steps,
         DENSE_TIDAL_SCAN scan points, single-mode evidence), then
         predict at 512 points at the k2 peak;
     each prints its stage times, the likelihood evaluations, T1 and T2
     with their error bars, ln P_max, ln Z and ln B, the hand-kernel
     launches (none) and the peak allocation; and fails unless ln P_max,
     ln Z and ln B are finite, 0 <= var <= sigma_f^2 (1 + sigma_n^2), at
     each tide peak the jvp gradient agrees with five-point central
     differences of the dense value to 1e-6 and the analytic Hessian
     (eq. 2.19) is symmetric and agrees with five-point central
     differences of the gradient to 1e-5 (dense_derivative_checks:
     steps of 1/200 of each error bar; gradient entries relative to the
     larger of |g_i| and sqrt|H_ii|, the gradient one error bar away;
     Hessian entries relative to sqrt|H_ii H_jj|), and on the 1-month
     record (n = 328) at the tide k2 peak ln P_max, the gradient and the
     Hessian on the card agree with the CPU to 1e-10 relative;
 10. nested phase (the paper's baseline, core/nested.py):
       (a) compare(["k1", "k2"], run_nested=True, batch="off") on the
           quickstart record (synthetic(key 42 + seed, 100, "k2")) at the
           example's fit budget, NESTED_N_LIVE live points, 8 chains x 16
           steps, at most NESTED_MAX_ITER iterations: prints, per model,
           ln Z_laplace, ln Z_nested +- err, their difference in units of
           err, the nested evaluations, the speed-up in evaluations, the
           iterations, the host reads and the nested run's seconds; fails
           unless both ln Z are finite for both models, n_evals = n_live
           + iterations x 128, no hand kernel launched and each model's
           chain steps ran as one CUDA graph (nested.GRAPHS);
       (b) the nested evidence of k2 on synthetic(key 7 + seed, 30, "k2")
           (40 live points, 60 iterations, key 11, NESTED_SMALL_BOX) on the
           card and on the CPU: the draws come from the same CPU
           generators, so ln Z and H must agree to 1e-8 relative with
           equal iterations;
       (c) the matrix-free integrand: k2 on make_data's irregular recipe
           at n = 4096 (backend "auto" binds the iterative tile
           operator), 16 live points, 4 chains x 2 steps, 2 iterations;
           fails unless B1 (tile_matvec) launched, n_evals = 16 + 2 x 8
           and ln Z > -1e289 (some point's ln L above the -1e290 of a
           failed evaluation).

After the build, five lines give the registers, stack frame and spills
from nvcc's -Xptxas -v of every instantiation of the value sweep (B1,
B12, and kinds 6 and 7, the product entry of B8 and B13 for d <= 2 and
d <= 4: ptxas_value_sweep), of B2's and B3's kernels (the value sweep's
on their gradient entries: ptxas_tangent_sweep), of B9's (the value
sweep's on the product gradient entry, per axes D <= 2 or 4, slots per
axis and width: ptxas_product_tangent), of B10's line kernels
(ptxas_ski_lines) and of the line kernels that B5, B6 and B7 share
(ptxas_ski_lines_1d).

Phase 1 runs alone.  Phases 2-10 then run in five worker processes side by
side on the card (WORKERS: the SKI phase; the N-D phase; check 4 and the
small-input checks; the irregular, stochastic, distributed and dense
phases; the nested phase),
each worker its phases in turn with a share of the host's cores, since
their CG loops are host-bound; the script waits for all of them (the
first failure stops the others) and prints each worker's output in that
order.  So their stage times are taken beside each other's host work.
Each phase prints its wall clock as it ends ({"phase_s": {...}}), and a
line before the kernels line gives all of them and the workers' wall
clock together.

Every phase fails loudly: a build failure, a launch error, a mismatch or a
non-finite result exits nonzero.  The line before the last gives the
script's own seconds (script_s); the last line of standard output is the
JSON object {"ok": true, "device": {...}}.

Roofline bound per call: the larger of bytes / 3.35 TB/s (each input read
once, each output written once) and the operations over the fp64 peaks of
an H100 SXM (NVIDIA data sheet): the covariance evaluation at 34 TFLOP/s
(outside the tensor cores), the contraction with V at 67 TFLOP/s (fp64
tensor cores).  Each arithmetic operation, comparison and each sin, cos,
exp or division counts as one operation (a lower count than the hardware
spends, so the bound stays a lower bound).  Per covariance entry: B1 and
B4 count the value (EVAL_OPS), B1 adds 2 b multiply-adds with V, and B1
and B4 count only the entries that their inputs need: for k1 and k2 those
inside the Wendland window (kernel_matvec.support_entries; B4 writes the
others as 0 and moves all n1 n2 of them), and so do B2 and B3.  B2
counts the value and its closed-form gradient over the kind's
natural slots (GRAD_OPS) and 2 NS b for contracting the NS gradient tiles
with V, since the m directions can be applied afterwards to the (NS, n1,
b) result at a cost independent of n2.  B3 counts the value and gradient
(GRAD_OPS) and the cheaper of B2's contraction (2 NS b, the tensor
cores) and projecting the NS gradients on its one direction first (2 NS,
outside them) with 2 b for the one tile.  B8 counts the d factor values and
d - 1 products, and 2 b with V; B12 and B13 count as B1 and B8 on
their (b, n2) entries (float32 cases: every operation at 67 TFLOP/s),
and move rows_x, x2, V and the output once; B9 each factor's value and
gradient, the
(d - 1) products of each of the sum_a NS_a gradient tiles with the other
factors, and 2 (sum_a NS_a) b with V.  B5 and B6 move v and the output
once, the E/2 + 1 distinct values of each spectrum (real and even), the
n s stencil weights of the sampled points and their n cell indices, and
do the transforms, the spectrum multiply and the two stencils (2 s per
entry each), at the fp64 (34 TFLOP/s) or fp32 (67 TFLOP/s) rate outside
the tensor cores.  The transforms count at the least circulant embedding
E = 2 m - 2 of the m-cell grid (the kernels' power-of-two L is their
layout), 5 E log2 E per complex column and transform, a complex column
carrying two real ones: one forward and one inverse per b / 2 for B5,
one forward and m inverse for B6; the zero half an odd b pads is not
counted.  B7 counts the same per member: V and the output (n B c each),
the B distinct half-spectra, the stencil, and the transform pair of
B c / 2 complex columns.  B10 and B11 count the same on the m1 x m2
cells: v and the output, the E_a / 2 + 1 distinct values of each axis
spectrum per direction, the n s joint weights and n cell indices; per
complex plane, a forward 2-D transform that runs its first axis over the
occupied lines alone and its second over the E of the first, and an
inverse that yields only the m1 m2 cells (the same count, mirrored;
fft_plane_ops, the cheaper axis order), the outer-product multiply (3
per point of the E1 x E2 plane), the stencils and the noise.  In 1-D
that rule is the plain count: B5-B7 and B10/B11 count the same way.

The SKI cell follows the repository's ``woods_hole_like`` recipe (five
tidal constituents with their periods and amplitudes, random phases, a
spring/neap envelope, noise 0.01, mean removed) and ``drop_random_hours``,
in numpy from ``--seed``.

``--six-month SIGMA_N,STARTS,ITERS,SCAN[,MONTHS]`` builds the kernels and
runs only check 4 at that budget (model noise, restarts per model, NCG
steps, scan points of the sequential fit, 0 for none; the record's
length, SEQ_VS_BANK_MONTHS by default): how its budget was chosen.

``--nd`` builds the kernels and runs only the kernel cases of B8-B11 and
check 5.  ``--stochastic`` builds the kernels and runs only the kernel
cases of B12/B13 and the stochastic shapes of B2 and B9, check 6 and the
stochastic small-input checks.
``--distributed`` builds the kernels and runs only the cases of B3 and
check 7.  ``--dense`` runs only phase 9 (it builds no kernel).
``--nested`` builds the kernels and runs only phase 10.

``--budget planned`` runs the irregular phase with the budget first planned
for it (the data-dependent box, max_iters=5, no scan) instead of the
committed one; on this data it is expected to end with a nan evidence,
and the phase's line shows why (Hessian eigenvalues, CG stops).
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import pathlib
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch import _sync  # noqa: E402
from repro_torch import gp  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import iterative as it  # noqa: E402
from repro_torch.core import hyperlik  # noqa: E402
from repro_torch.core import laplace  # noqa: E402
from repro_torch.core import nested  # noqa: E402
from repro_torch.core import predict  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core import stochastic  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import kernel_matvec as km  # noqa: E402
from repro_torch.kernels import kernel_tile as kt  # noqa: E402
from repro_torch.core.reparam import FlatBox, from_box, to_box  # noqa: E402
from repro_torch.data.synthetic import synthetic  # noqa: E402
from repro_torch.data.tidal import (CONSTITUENTS, LUNAR_MONTH_H,  # noqa: E402
                                     woods_hole_like)
from repro_torch.gp import batch  # noqa: E402
from repro_torch.kernels import operators as opers  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ski_fused as sf  # noqa: E402
from repro_torch.kernels.ref import matrix_ref  # noqa: E402
from repro_torch.kernels.ref import tangent_matrices_ref  # noqa: E402
from repro_torch.launch.mesh import make_local_group  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
FP64_PEAK = 34e12          # fp64 outside the tensor cores
FP64_TC_PEAK = 67e12       # fp64 on the tensor cores
FP32_PEAK = 67e12          # fp32 outside the tensor cores

# operations per covariance entry (value), and for B2 the value plus the
# closed-form gradient over the kind's natural slots
EVAL_OPS = {"k1": 22, "k2": 29, "se": 5, "matern12": 4, "matern32": 7,
            "matern52": 10}
GRAD_OPS = {"k1": 45, "k2": 68, "se": 9, "matern12": 8, "matern32": 11,
            "matern52": 15}
N_SLOTS = {"k1": 3, "k2": 5}   # natural slots each kind's tile depends on

N = 8760                    # one year of hourly-scale sampling
N_STAR = 512
SIGMA_N = 0.1
# NCG budgets of the workflow phase, 2 restarts each.  committed: 15 steps
# (25 until the N-D phase needed the time) from the best of a 64-point
# scan inside the tidal-band boxes; with 16 scan points, starts of the
# compare stage landed outside the comb peaks at n = 8760 and never
# reached a positive definite Hessian.  planned: 5 steps from uniform
# starts in the data-dependent box.
BUDGETS = {"committed": dict(max_iters=15, scan_points=64, tidal_boxes=True),
           "planned": dict(max_iters=5, scan_points=None, tidal_boxes=False)}
# max-abs error over max-abs against the plain version
TOL = {"tile_matvec": 1e-12, "tile_tangent": 1e-11, "tile_matrix": 1e-12,
       "ski_gram": 1e-12, "ski_tangent": 1e-12, "ski_bank": 1e-12,
       "tile_matvec_nd": 1e-12, "tile_tangent_nd": 1e-12,
       "ski_gram_2d": 1e-12, "ski_tangent_2d": 1e-12, "tile_rows": 1e-12,
       "tile_rows_nd": 1e-12, "tile_jvp": 1e-11}
TOL_F32 = 1e-5
SOURCES = {
    "tile_matvec": ("src/repro_torch/csrc/tile_matvec.cu",
                    "src/repro/kernels/kernel_matvec.py:270"),
    "tile_tangent": ("src/repro_torch/csrc/tile_tangent.cu",
                     "src/repro/kernels/kernel_matvec.py:209"),
    "tile_matrix": ("src/repro_torch/csrc/tile_matrix.cu",
                    "src/repro/kernels/kernel_tile.py:29"),
    "ski_gram": ("src/repro_torch/csrc/ski_gram.cu",
                 "src/repro/kernels/ski_fused.py:667"),
    "ski_tangent": ("src/repro_torch/csrc/ski_tangent.cu",
                    "src/repro/kernels/ski_fused.py:712"),
    "ski_bank": ("src/repro_torch/csrc/ski_bank.cu",
                 "src/repro/kernels/ski_fused.py:789"),
    "tile_matvec_nd": ("src/repro_torch/csrc/tile_matvec_nd.cu",
                       "src/repro/kernels/kernel_matvec.py:368"),
    "tile_tangent_nd": ("src/repro_torch/csrc/tile_tangent_nd.cu",
                        "src/repro/kernels/kernel_matvec.py:402"),
    "ski_gram_2d": ("src/repro_torch/csrc/ski_gram_2d.cu",
                    "src/repro/kernels/ski_fused.py:1053"),
    "ski_tangent_2d": ("src/repro_torch/csrc/ski_tangent_2d.cu",
                       "src/repro/kernels/ski_fused.py:1096"),
    "tile_rows": ("src/repro_torch/csrc/tile_matvec.cu",
                  "src/repro/kernels/kernel_matvec.py:308"),
    "tile_rows_nd": ("src/repro_torch/csrc/tile_matvec_nd.cu",
                     "src/repro/kernels/kernel_matvec.py:342"),
    "tile_jvp": ("src/repro_torch/csrc/tile_jvp.cu",
                 "src/repro/kernels/kernel_matvec.py:243"),
}
TILE_KERNELS = ("tile_matvec", "tile_tangent", "tile_matrix")
SKI_KERNELS = ("ski_gram", "ski_tangent", "ski_bank")
ND_KERNELS = ("tile_matvec_nd", "tile_tangent_nd", "ski_gram_2d",
              "ski_tangent_2d", "tile_matrix")
ROWS_KERNELS = ("tile_rows", "tile_rows_nd")
STOCHASTIC_KERNELS = ROWS_KERNELS + ("tile_matvec", "tile_tangent",
                                     "tile_matvec_nd", "tile_tangent_nd",
                                     "tile_matrix")
DIST_KERNELS = ("tile_jvp", "tile_matvec", "tile_tangent", "tile_matrix",
                "ski_gram", "ski_tangent", "tile_rows")

# the distributed cell: the row-sharded GP step at world size 1 (NCCL).
# distributed_tile runs the irregular cell's data at the reference tests'
# theta (tests/test_distributed_gp.py) with their probe and Lanczos
# counts; distributed_example is examples/large_scale_gp.py's own call
# (the paper's synthetic k2 draw at t = 1..4096: a Toeplitz grid);
# distributed_ski the SKI cell's record at its sigma_n = 0.01, where this
# path (no preconditioner) needs 7581 CG iterations to its tolerance and
# more Lanczos steps than the default 64: at 64 its SLQ log-det came out
# 14% above the exact one (ln P 22% under; PERF.md), so the checked run
# takes DIST_SKI_LANCZOS_K steps and a second run at 64, printed as
# distributed_ski_k64, is not checked
DIST_THETA = [3.2, 1.5, 0.05, 2.8, -0.1]
DIST_EXAMPLE_N = 4096
DIST_EXAMPLE_THETA = [3.4, 1.4, 0.05, 2.9, -0.05]
K2_TRUE = [3.5, 1.5, 0.0, 3.0, 0.0]      # repro.data.synthetic's k2 point
DIST_SKI_CG_MAX_ITER = 10000
DIST_SKI_LANCZOS_K = 256
# the JAX package's own bounds on the step against the dense answer
DIST_LP_REL = 0.08
DIST_GRAD_COS = 0.99
DIST_SMALL_N = 1024
DIST_SMALL_SIGMA_N = 0.5      # CG to 1e-10 in ~70 iterations on the CPU side
DIST_STOCHASTIC_N = 4096

# the stochastic cell: run_stochastic's recipe (examples/large_scale_gp.py)
# at n = STOCHASTIC_N, the threshold of backend="auto"'s escalation, and
# make_scattered_field at the same n; predict at STOCHASTIC_N_STAR points
STOCHASTIC_N = 65536
STOCHASTIC_N_STAR = 256
STOCHASTIC_SIGMA_N = 0.1
# NCG steps of each stochastic fit (one pinned start); 15 steps ended at
# the same peak as 8 on the card (PERF.md): the line search stalls
# sooner; 4 since the distributed phase needed the time (the whole script
# took ~1160 s of its 1200 on an H100 80GB HBM3 at 700 W, PERF.md)
STOCHASTIC_ITERS = 4
# the fit's one start, as run_stochastic pins it: theta = 0 (every
# lengthscale 1); from a uniform start in the data-dependent box the
# (n, 2) fit ran to the edge of the box, where the Laplace Hessian has a
# negative eigenvalue (a nan ln Z), and the JAX package's fit does the
# same on this recipe at n = 1024 (tests/test_torch_stochastic_workflow.py
# ::test_scattered_field_fit_from_a_uniform_start_matches_the_jax_package)
STOCHASTIC_THETA0 = {"se": [0.0], "se*matern32": [0.0, 0.0]}
# a point inside each stage's box, where the row-slab cases run
ROWS_THETA = {"se": [math.log(0.5)],
              "se*matern32": [math.log(1.5), math.log(0.8)],
              "k2*se": [math.log(20.0), math.log(7.9), 0.0,
                        math.log(15.7), 0.0, math.log(0.8)]}

# the N-D cell: examples/spatiotemporal.py's make_field on a 128 x 64 time x
# space grid, spacings (0.5, 0.25), 15% of the records dropped, sigma_n
# 0.05 (n / sigma_n^2 ~ 2.8e6 >= 1e6, so precond="auto" takes the
# circulant preconditioner); the irregular stage draws N_ND_IRREGULAR
# uniform points in the same box
FIELD_SHAPE = (128, 64)
# a field whose time axis is longer than B10's float64 line cap: its
# product-SKI grid is 2106 x 9 cells, L = 8192 x 32
LONG_FIELD_SHAPE = (2100, 3)
FIELD_SPACING = (0.5, 0.25)
FIELD_DROP = 0.15
FIELD_SIGMA_N = 0.05
N_ND_IRREGULAR = 4096
ND_KIND = "se*matern32"
ND_MODELS = ("se*se", "se*matern32")
# a point inside the field's box: time lengthscale 1.5, space 0.8
ND_THETA = {"se*matern32": [math.log(1.5), math.log(0.8)],
            "k2*se": [math.log(20.0), math.log(7.9), 0.0, math.log(15.7),
                      0.0, math.log(0.8)]}
# NCG budgets of the N-D stages: the product-SKI stage 25 steps under the
# default policy (no scan: a 64-point scan cost 35 s there on the card),
# its compare (the bank) 2 starts, its own session 1 start (2 until the
# stochastic phase needed the time) with no CG preconditioner and CG run
# to its tolerance (ND_SEQ_CG_MAX_ITER: 1537 iterations at the peak);
# the Kronecker and irregular stages, which exist to put their operators
# and kernels on the workflow's path, one start of ND_SHORT_ITERS steps
# (15 until the distributed phase needed the time; they compute no ln Z)
ND_SHORT_ITERS = 5
ND_SEQ_CG_MAX_ITER = 2000

# the SKI cell: the woods_hole_like recipe on two years of the 2 h cadence
CADENCE_H = 2.0
TIDAL_MONTHS = 24
DROP = 0.1
TIDAL_SIGMA_N = 0.01
# its CG cap.  At 400 nearly every solve of the fit and all of the Laplace
# stage's were cut, and the smallest eigenvalue of the Laplace Hessian
# (central differences of those gradients) was their noise: under five
# matvecs that differ by rounding alone it ranged from -59165 to +22428,
# and ln Z was nan for three of them (PERF.md §6)
SKI_CG_MAX_ITER = 1200
# the sequential-vs-bank check: NCG steps, scan points (the sequential
# path's; the bank starts from uniform draws) and the model's noise, chosen
# on a 6-month record.  At the record's own sigma_n = 0.01 it took 580 s
# on the card (CG cut in most solves), and the bank's two uniform starts
# per model leave k1 far below the sequential path's ln P of 1285: with
# the port's draws at 331 on the card (no positive definite Hessian, nan
# ln Z) and 242 on the CPU; with the JAX package's draws at 735, in JAX
# and in the port alike (scripts/six_month_bank_reference.py).  At 0.03,
# 25 steps and 64 scan points both paths give finite ln Z in about 190 s
# (PERF.md).
SIX_MONTH_ITERS = 25
SIX_MONTH_SCAN = 64
SIX_MONTH_SIGMA_N = 0.03
# the record of check 4: 3 months since the N-D phase (6 months took 201 s
# on the card, 3 months 169 s; at 2 months the bank's k1 ended where its
# Hessian is not positive definite, a nan ln Z)
SEQ_VS_BANK_MONTHS = 3
# points the SKI kernel cases run at (flat coordinates, inside the boxes)
SKI_THETA = {"k1": [math.log(300.0), math.log(12.42), 0.0],
             "k2": [math.log(300.0), math.log(12.42), 0.0, math.log(23.93),
                    0.0]}
# the k2 point the data is drawn from (flat coordinates, hours)
TRUTH = [math.log(200.0), math.log(12.42), -0.19, math.log(24.0), -0.1]
# points the kernel phase runs at
THETA = {"k1": TRUTH[:3], "k2": TRUTH}

# the dense phase (the paper's regime, n <= dense_cutoff): the quickstart
# example's record and budget, and the six-month tide record at
# benchmarks/tidal.analyse's budget
DENSE_QUICK_N = 100
DENSE_QUICK_BUDGET = dict(n_starts=10, max_iters=80)   # scan: 256 m
DENSE_QUICK_N_STAR = 7
DENSE_DRAWS = 3
DENSE_TIDAL_MONTHS = 6
DENSE_TIDAL_SCAN = 2048
DENSE_TIDAL_BUDGET = dict(n_starts=12, max_iters=100, multimodal=False)
DENSE_SMALL_MONTHS = 1
DENSE_FD_STEP = 0.005      # five-point stencils, in error bars
DENSE_GRAD_TOL = 1e-6
DENSE_HESS_TOL = 1e-5
DENSE_CPU_TOL = 1e-10
NESTED_N_LIVE = 400          # the paper's live points (benchmarks/speedup.py)
NESTED_MAX_ITER = 20000      # compare()'s default nested_max_iter
NESTED_SMALL = dict(n=30, n_live=40, max_iter=60)
# k2's box for the card-vs-CPU run on t = 1..30: windows over a neighbour
# (T0 >= 3), smoothness l >= 0.7 (xi >= -0.25).  Where a short window or a
# small l zeroes K's off-diagonal, ln P is one value over a region and its
# neighbours differ from it by an ulp, rounded otherwise by cuSOLVER and
# LAPACK; a chain step there (L > L*, L* that value) turns on those bits
NESTED_SMALL_BOX = ([math.log(3.0), math.log(2.0), -0.25, math.log(2.0),
                     -0.25],
                    [math.log(29.0), math.log(30.0), 0.45, math.log(30.0),
                     0.45])
NESTED_CPU_TOL = 1e-8
NESTED_MF = dict(n=4096, n_live=16, n_chains=4, n_steps=2, max_iter=2)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, repeats: int) -> float:
    """Median of per-call CUDA-event times after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def errors(got, want):
    err = float((got - want).abs().max())
    return err, err / float(want.abs().max())


def bound(n_bytes: float, eval_ops: float, mma_flops: float,
          peak: float = FP64_PEAK):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = eval_ops / peak + mma_flops / FP64_TC_PEAK
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def embed_len(m: int) -> int:
    """The least circulant embedding of an m x m symmetric Toeplitz
    block: 2 m - 2 points (the port's L, a power of two >= 2 m - 1, is a
    layout choice, not part of the function)."""
    return max(2 * m - 2, 1)


def fft_ops(E: int) -> float:
    """Operations of one complex transform of length E, 5 E log2 E."""
    return 5.0 * E * math.log2(E) if E > 1 else 0.0


def fft_plane_ops(ms) -> float:
    """Operations of one forward transform of an m_1 (x) ... cell block
    embedded in the (E_1, ...) plane, counting only the lines that hold
    data: the first axis transformed runs over the occupied lines alone,
    each later one over the lines the earlier ones filled; the cheaper
    axis order.  The inverse that yields only the m cells costs the same
    (the mirrored order).  In 1-D this is fft_ops(E)."""
    Es = [embed_len(m) for m in ms]
    best = None
    for order in itertools.permutations(range(len(ms))):
        done, ops_ = set(), 0.0
        for a in order:
            lines = 1
            for b in range(len(ms)):
                if b != a:
                    lines *= Es[b] if b in done else ms[b]
            ops_ += lines * fft_ops(Es[a])
            done.add(a)
        best = ops_ if best is None else min(best, ops_)
    return best


def ski_bound(geom, b: int, m_dirs: int, dtype, members: int = 1):
    """Roofline bound (ms, what bounds it) of B5 (m_dirs = 0), B6 or B7
    (m_dirs = 0, ``members`` = B, b = c columns each): the bytes of v,
    the output, the distinct half of each real even spectrum, the n s
    weights and the n cell indices (the kernels' (m, s) weight table and
    m-long cell map are a layout, not part of the function); the
    operations of the transforms at the least embedding (fft_plane_ops),
    the spectrum multiply, the stencils and the noise."""
    return _ski_bound(geom, (geom.m_grid,), b, m_dirs, dtype, members)


def ski_bound_2d(geom, b: int, m_dirs: int, dtype):
    """ski_bound of B10 (m_dirs = 0) or B11 on the m1 x m2 cells: the
    per-direction spectra are the two real even axis spectra, and the
    transforms count only the lines that hold data or output
    (fft_plane_ops), as B5-B7's do."""
    return _ski_bound(geom, geom.shape, b, m_dirs, dtype, 1)


def _ski_bound(geom, ms, b, m_dirs, dtype, members):
    n, s = geom.n, len(geom.offs)
    item = torch.finfo(dtype).bits // 8
    outs = max(m_dirs, 1)
    nb = n * b * members
    Es = [embed_len(m) for m in ms]
    spectra = sum(E // 2 + 1 for E in Es)
    n_bytes = item * (nb + outs * nb + n * s + outs * members * spectra) \
        + 4 * n
    # a complex transform carries two real columns: b / 2 per member (the
    # zero half that an odd b pads is layout, not work)
    planes = members * b / 2.0
    points = math.prod(Es)
    # the spectrum multiply: complex by real, times the outer product's
    # d - 1 products
    mul = 2.0 + (len(ms) - 1)
    ops_ = (fft_plane_ops(ms) * planes * (1 + outs)
            + mul * points * planes * outs
            + 2.0 * s * nb * (1 + outs) + (2.0 * nb if not m_dirs else 0.0))
    peak = FP64_PEAK if dtype == torch.float64 else FP32_PEAK
    return bound(n_bytes, ops_, 0.0, peak)


def tile_nd_bound(kinds, n1, n2, b, m=0):
    """Roofline bound (ms, what bounds it) of B8 (m = 0) or B9 (m
    directions) on (n, d) coordinates, float64."""
    d = len(kinds)
    entries = n1 * n2
    n_bytes = 8.0 * (d * (n1 + n2) + n2 * b + max(m, 1) * n1 * b
                     + 8 * d * (1 + m))
    if not m:
        return bound(n_bytes, entries * (sum(EVAL_OPS[k] for k in kinds)
                                         + d - 1), 2.0 * entries * b)
    ns = sum(N_SLOTS.get(k, 1) for k in kinds)
    return bound(n_bytes, entries * (sum(GRAD_OPS[k] for k in kinds)
                                     + ns * (d - 1)), 2.0 * entries * ns * b)


def make_data(seed: int, dev, n: int = N):
    """n sorted uniform sampling times over 8760 h (irregular: classify_grid
    says so) and one draw of a quasi-periodic GP: k2 with a 200 h window,
    periods 12.42 h and 24 h, unit scale and sigma_n noise.  The draw is
    L z with L the Cholesky factor of the dense covariance on the card and
    z from numpy's generator."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 8760.0, n))
    xstar = np.sort(rng.uniform(0.0, 8760.0, N_STAR))
    z = rng.standard_normal(n)
    p = ops.natural_params("k2", torch.tensor(TRUTH, dtype=torch.float64))
    xt = torch.tensor(x, device=dev)
    K = matrix_ref("k2", p.to(dev), xt, xt)
    K.diagonal().add_(SIGMA_N ** 2)
    y = torch.linalg.cholesky(K) @ torch.tensor(z, device=dev)
    return x, y.cpu().numpy(), xstar


def make_tidal_data(seed: int, months: int = TIDAL_MONTHS, drop=DROP):
    """The woods_hole_like recipe with drop_random_hours, in numpy: five
    tidal constituents with random phases, the spring/neap envelope,
    noise 0.01, the mean removed; then each sample dropped with
    probability ``drop``.  Returns (x, y, xstar) with 512 sorted test
    points inside the record, and n_full."""
    rng = np.random.default_rng(seed)
    n_full = int(round(months * LUNAR_MONTH_H / CADENCE_H))
    t = np.arange(n_full, dtype=np.float64) * CADENCE_H
    y = np.zeros(n_full)
    for _, period, amp in CONSTITUENTS:
        y += amp * np.sin(2 * np.pi * t / period
                          + rng.uniform() * 2 * np.pi)
    y *= 1.0 + 0.25 * np.sin(2 * np.pi * t / (LUNAR_MONTH_H / 2))
    y += TIDAL_SIGMA_N * rng.standard_normal(n_full)
    y -= y.mean()
    keep = rng.uniform(size=n_full) >= drop
    x, y = t[keep], y[keep]
    xstar = np.sort(rng.uniform(x[0], x[-1], N_STAR))
    return x, y, xstar, n_full


def tidal_boxes():
    """Flat-prior boxes from what is known of such a record (tidal
    constituents): a window of 4 h to ~3 months, a semidiurnal period in
    the M2 band 12.2-12.7 h, a diurnal one in the K1 band 23.5-24.5 h, and
    smoothness xi in (-0.45, 0.45).
    The data-dependent default (ln dt_min .. ln span for every timescale)
    leaves a short NCG run no chance of finding a comb peak 0.02 wide in
    ln T, and lets unused periods drift past the window into flat ridges
    where the Laplace Hessian is not positive definite."""
    w = (math.log(4.0), math.log(2000.0))
    p1 = (math.log(12.2), math.log(12.7))
    p2 = (math.log(23.5), math.log(24.5))
    s = (-0.45, 0.45)
    return {"k1": FlatBox(np.array([w[0], p1[0], s[0]]),
                          np.array([w[1], p1[1], s[1]])),
            "k2": FlatBox(np.array([w[0], p1[0], s[0], p2[0], s[0]]),
                          np.array([w[1], p1[1], s[1], p2[1], s[1]]))}


def make_field(seed: int, shape=FIELD_SHAPE, drop=FIELD_DROP):
    """``make_field`` of examples/spatiotemporal.py in numpy: a smooth-in-
    time, rougher-in-space field sin(0.8 t) cos(1.6 s) on the product grid
    of spacings (0.5, 0.25), each record dropped with probability
    ``drop``, noise FIELD_SIGMA_N.  Returns (x (n, 2), y, xstar (512, 2)
    off-grid test points inside the field)."""
    t = FIELD_SPACING[0] * np.arange(shape[0])
    s = FIELD_SPACING[1] * np.arange(shape[1])
    X = np.stack(np.meshgrid(t, s, indexing="ij"), -1).reshape(-1, 2)
    rng = np.random.default_rng(seed)
    keep = rng.uniform(size=X.shape[0]) > drop
    X = X[keep]
    f = np.sin(0.8 * X[:, 0]) * np.cos(1.6 * X[:, 1])
    y = f + FIELD_SIGMA_N * rng.standard_normal(X.shape[0])
    xstar = np.stack([rng.uniform(t[0], t[-1], N_STAR),
                      rng.uniform(s[0], s[-1], N_STAR)], -1)
    return X, y, xstar


def make_scattered_field(seed: int, n: int = N_ND_IRREGULAR):
    """n uniform points in the field's box with the same function and
    noise: scattered (n, 2) data (classify_grid_nd says "irregular")."""
    rng = np.random.default_rng(seed + 7)
    hi = [FIELD_SPACING[a] * (FIELD_SHAPE[a] - 1) for a in range(2)]
    X = rng.uniform([0.0, 0.0], hi, (n, 2))
    y = np.sin(0.8 * X[:, 0]) * np.cos(1.6 * X[:, 1]) \
        + FIELD_SIGMA_N * rng.standard_normal(n)
    xstar = rng.uniform([0.0, 0.0], hi, (N_STAR, 2))
    return X, y, xstar


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def kernel_phase(x, xstar, dev, rng, seed):
    cases = {name: [] for name in SOURCES}
    for kind in ("k1", "k2"):
        theta = torch.tensor(THETA[kind], dtype=torch.float64)
        p = ops.natural_params(kind, theta).to(dev)
        pd = ops.natural_tangents(kind, theta).to(dev)
        # B1: training CG (b = 1 + n_probes = 9), value-only CG (b = 1),
        # Lanczos (b = 8), predict variance CG (b = n* = 512), predict
        # mean (n1 = n*, b = 1)
        for n1, b in ((N, 1), (N, 8), (N, 9), (N, N_STAR), (N_STAR, 1)):
            x1 = x if n1 == N else xstar
            v = torch.tensor(rng.standard_normal((N, b)), device=dev)
            cases["tile_matvec"].append(b1_case(kind, p, x1, x, v, "theta"))
        # B2: all m tangents of [alpha | 8 probes], m = 3 (k1) or 5 (k2),
        # and b = 1, 8 and 16, 17 (either side of the register switch)
        for b in (9, 1, 8, 16, 17):
            v = torch.tensor(rng.standard_normal((N, b)), device=dev)
            cases["tile_tangent"].append(b2_case(kind, p, pd, x, x, v,
                                                 "theta"))
        # B4: the predict cross block K(x, x*), (8760, 512); k2 also at
        # an odd n2 = 511 (every other row's 16-byte stores misaligned)
        cases["tile_matrix"].append(b4_case(kind, p, x, xstar, "predict"))
        if kind == "k2":
            cases["tile_matrix"].append(b4_case(
                kind, p, x, xstar[:N_STAR - 1].contiguous(), "odd_n2"))
    # B4 on a family without a window: every entry evaluated
    p = ops.natural_params("se", torch.tensor([math.log(40.0)],
                                              dtype=torch.float64)).to(dev)
    cases["tile_matrix"].append(b4_case("se", p, x, xstar, "predict"))
    b1_extra_cases(cases, x, dev, rng)
    b2_extra_cases(cases, x, dev, rng)
    b2_stochastic_case(cases, dev, rng, seed)
    b9_stochastic_case(cases, dev, rng, seed)
    jvp_kernel_cases(cases, x, dev, rng)
    crossover = ski_kernel_cases(cases, dev, rng, seed)
    nd_kernel_cases(cases, dev, rng, seed)
    rows_kernel_cases(cases, dev, rng, seed)
    check_cases(cases, SOURCES)
    return cases, crossover


def b4_case(kind, p, x1, x2, case):
    """One B4 case against its plain version, timed, with the share of
    entries inside the Wendland window (support_share; 1 for the kinds
    without one): the kernel stores the others as 0 before any sin or
    exp.  The bound writes the block once and evaluates the in-support
    entries alone."""
    n1, n2 = x1.shape[0], x2.shape[0]
    got = kt.tile_matrix(kind, p, x1, x2)
    want = kt.tile_matrix_plain(kind, p, x1, x2)
    torch.cuda.synchronize()
    err, rel = errors(got, want)
    del got, want
    sup = km.support_entries(kind, p, x1, x2)
    bms, by = bound(8.0 * (n1 + n2 + n1 * n2 + 8), sup * EVAL_OPS[kind], 0.0)
    return dict(kind=kind, case=case, n1=n1, n2=n2, max_abs_err=err,
                max_rel_err=rel, support_share=sup / (n1 * n2),
                ms=time_ms(lambda: kt.tile_matrix(kind, p, x1, x2), 10),
                plain_ms=time_ms(lambda: kt.tile_matrix_plain(kind, p, x1,
                                                              x2), 3),
                bound_ms=bms, bound_by=by)


def b1_case(kind, p, x1, x2, v, case):
    """One B1 case against its plain version, timed, with the share of
    entries inside the Wendland window (support_share; 1 for the kinds
    without one) and the (stripe, tile) pairs the kernel skips.  The
    bound counts the in-support entries alone: the value and 2 b
    multiply-adds with V each."""
    n1, n2, b = x1.shape[0], x2.shape[0], v.shape[1]
    got = km.tile_matvec(kind, p, x1, x2, v)
    want = km.tile_matvec_plain(kind, p, x1, x2, v)
    torch.cuda.synchronize()
    err, rel = errors(got, want)
    sup = km.support_entries(kind, p, x1, x2)
    pairs = -(-n1 // km.VALUE_ROWS) * -(-n2 // km.VALUE_COLS)
    kept = int(km.support_tiles(kind, p, x1, x2).shape[0])
    bms, by = bound(8.0 * (n1 + n2 + n2 * b + n1 * b + 8),
                    sup * EVAL_OPS[kind], 2.0 * sup * b)
    return dict(kind=kind, case=case, n1=n1, n2=n2, b=b, t0=float(p[0]),
                max_abs_err=err, max_rel_err=rel,
                support_share=sup / (n1 * n2), tiles_skipped=pairs - kept,
                tiles=pairs,
                ms=time_ms(lambda: km.tile_matvec(kind, p, x1, x2, v), 10),
                plain_ms=time_ms(
                    lambda: km.tile_matvec_plain(kind, p, x1, x2, v), 3),
                bound_ms=bms, bound_by=by)


def b1_extra_cases(cases, x, dev, rng):
    """B1 beyond the workflow's shapes: "se" at n = 8760, b = 9 (no
    window: the fused body alone); k2 with its window at the fit box's
    edge, T0 = 2000 h (40% of the entries in support); k2 on the same
    points unsorted (nearly no tile skipped); k2 at b = 16 and 17, one on
    each side of the register / tensor-core switch."""
    def params(kind, theta):
        return ops.natural_params(
            kind, torch.tensor(theta, dtype=torch.float64)).to(dev)

    def rhs(b):
        return torch.tensor(rng.standard_normal((N, b)), device=dev)

    p2 = params("k2", THETA["k2"])
    wide = list(THETA["k2"])
    wide[0] = math.log(2000.0)
    perm = torch.tensor(rng.permutation(N), device=dev)
    rows = [b1_case("se", params("se", [math.log(50.0)]), x, x, rhs(9),
                    "se"),
            b1_case("k2", params("k2", wide), x, x, rhs(9), "t0_2000"),
            b1_case("k2", p2, x[perm], x[perm], rhs(9), "unsorted"),
            b1_case("k2", p2, x, x, rhs(16), "theta"),
            b1_case("k2", p2, x, x, rhs(17), "theta")]
    cases["tile_matvec"].extend(rows)


def b2_case(kind, p, pd, x1, x2, v, case, plain_repeats=3):
    """One B2 case against its plain version, timed, with the share of
    entries inside the Wendland window (support_share; 1 for the kinds
    without one) and the (stripe, tile) pairs its kernel skips on its own
    grid (km.tangent_grid).  The bound counts the in-support entries
    alone: the value and gradient (GRAD_OPS) and 2 NS b multiply-adds
    with V each, the m directions applied to the (NS, n1, b) sums at a
    cost independent of n2."""
    n1, n2, b = x1.shape[0], x2.shape[0], v.shape[1]
    m = pd.shape[0]
    got = km.tile_stacked_tangent_matvec(kind, p, pd, x1, x2, v)
    want = km.tile_stacked_tangent_matvec_plain(kind, p, pd, x1, x2, v)
    torch.cuda.synchronize()
    err, rel = errors(got, want)
    del got, want
    sup = km.support_entries(kind, p, x1, x2)
    rows, cols = km.tangent_grid(kind, b)[:2]
    pairs = -(-n1 // rows) * -(-n2 // cols)
    kept = int(km.support_tiles(kind, p, x1, x2, rows, cols).shape[0])
    bms, by = bound(8.0 * (n1 + n2 + n2 * b + m * n1 * b + 8 + 8 * m),
                    sup * GRAD_OPS[kind],
                    2.0 * sup * N_SLOTS.get(kind, 1) * b)
    return dict(kind=kind, case=case, n1=n1, n2=n2, b=b, m=m,
                t0=float(p[0]), max_abs_err=err, max_rel_err=rel,
                support_share=sup / (n1 * n2), tiles_skipped=pairs - kept,
                tiles=pairs, stripe_rows=rows,
                ms=time_ms(lambda: km.tile_stacked_tangent_matvec(
                    kind, p, pd, x1, x2, v), 10),
                plain_ms=time_ms(
                    lambda: km.tile_stacked_tangent_matvec_plain(
                        kind, p, pd, x1, x2, v), plain_repeats),
                bound_ms=bms, bound_by=by)


def b2_extra_cases(cases, x, dev, rng):
    """B2 beyond the workflow's directions: k2 with its window at the fit
    box's edge, T0 = 2000 h (40% of the entries in support), b = 9; and
    k2 on the same points unsorted with random dense pdots of m = 1 .. 5
    rows (the kernel's projection is exact for any pdots)."""
    wide = list(THETA["k2"])
    wide[0] = math.log(2000.0)
    th = torch.tensor(wide, dtype=torch.float64)
    v = torch.tensor(rng.standard_normal((N, 9)), device=dev)
    cases["tile_tangent"].append(b2_case(
        "k2", ops.natural_params("k2", th).to(dev),
        ops.natural_tangents("k2", th).to(dev), x, x, v, "t0_2000"))
    p = ops.natural_params(
        "k2", torch.tensor(THETA["k2"], dtype=torch.float64)).to(dev)
    xu = x[torch.tensor(rng.permutation(N), device=dev)]
    for m in range(1, 6):
        pd = torch.tensor(rng.standard_normal((m, 8)), device=dev)
        cases["tile_tangent"].append(b2_case("k2", p, pd, xu, xu, v,
                                             "unsorted"))


def b2_stochastic_case(cases, dev, rng, seed):
    """B2 at the stochastic 1-D stage's shape: StochasticSolver's
    tangent_matvecs on the whole record ("se", n = 65536, b = 9 =
    [alpha | 8 probes], m = 1), against its plain version (one timed
    repeat: each call of it evaluates 4.3e9 entries in 1024-row blocks)."""
    x_np, _, _ = make_stochastic_data(seed, STOCHASTIC_N)
    x = torch.tensor(x_np, device=dev)
    th = torch.tensor(ROWS_THETA["se"], dtype=torch.float64)
    v = torch.tensor(rng.standard_normal((STOCHASTIC_N, 9)), device=dev)
    cases["tile_tangent"].append(b2_case(
        "se", ops.natural_params("se", th).to(dev),
        ops.natural_tangents("se", th).to(dev), x, x, v, "stochastic",
        plain_repeats=1))


def b9_stochastic_case(cases, dev, rng, seed):
    """B9 at the stochastic (n, 2) stage's shape, where it launches most:
    StochasticSolver's tangent_matvecs on the whole field ("se*matern32",
    n1 = n2 = 65536, b = 9 = [alpha | 8 probes], m = 2), against its plain
    version on every row (one timed repeat: each call of it evaluates
    4.3e9 entries in 1024-row blocks)."""
    x_np, _, _ = make_scattered_field(seed, STOCHASTIC_N)
    x = torch.tensor(x_np, device=dev)
    kinds = ops.split_kind(ND_KIND)
    th = torch.tensor(ROWS_THETA[ND_KIND], dtype=torch.float64)
    p = ops.natural_params_nd(ND_KIND, th).to(dev)
    pd = ops.natural_tangents_nd(ND_KIND, th).to(dev)
    v = torch.tensor(rng.standard_normal((STOCHASTIC_N, 9)), device=dev)

    def kern():
        return km.tile_stacked_tangent_matvec_nd(kinds, p, pd, x, x, v)

    def plain():
        return km.tile_stacked_tangent_matvec_nd_plain(kinds, p, pd, x, x,
                                                       v)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err, rel = errors(got, want)
    del got, want
    n = STOCHASTIC_N
    bms, by = tile_nd_bound(kinds, n, n, 9, pd.shape[0])
    cases["tile_tangent_nd"].append(dict(
        kind=ND_KIND, case="stochastic", n1=n, n2=n, b=9, m=pd.shape[0],
        max_abs_err=err, max_rel_err=rel, ms=time_ms(kern, 3),
        plain_ms=time_ms(plain, 1), bound_ms=bms, bound_by=by))


def value_ptxas(log: str):
    """Registers, stack frame and spills of each value-sweep kernel from
    the -Xptxas -v build log: (dtype, kind id, B or NB); kinds 6 and 7
    are the product entry (B8, B13) for d <= 2 and d <= 4."""
    return ptxas_rows(
        log, r"value_(narrow|wide)_kernelI([df])NS_\d+ValueEntryI[df]"
        r"Li(\d+)EEELi(\d+)E",
        lambda m: dict(path=m.group(1), dtype="float64" if m.group(2) == "d"
                       else "float32", kind=int(m.group(3)),
                       width=int(m.group(4))))


def tangent_ptxas(log: str):
    """The same for B2 and B3: the value sweep's kernels on their
    gradient entries (GradEntry, B2; JvpEntry, B3), (dtype, kind id, B or
    NB)."""
    return ptxas_rows(
        log, r"value_(narrow|wide)_kernelI([df])NS_\d+(Grad|Jvp)EntryI"
        r"[df]Li(\d+)EEELi(\d+)E",
        lambda m: dict(kernel="B2" if m.group(3) == "Grad" else "B3",
                       path=m.group(1), dtype="float64" if m.group(2) == "d"
                       else "float32", kind=int(m.group(4)),
                       width=int(m.group(5))))


def product_tangent_ptxas(log: str):
    """The same for B9: the value sweep's narrow kernel on
    ProductGradEntry, (dtype, axes D, slots per axis SA, width B)."""
    return ptxas_rows(
        log, r"value_narrow_kernelI([df])NS_\d+ProductGradEntryI[df]"
        r"Li(\d+)ELi(\d+)EEELi(\d+)E",
        lambda m: dict(dtype="float64" if m.group(1) == "d" else "float32",
                       axes=int(m.group(2)), slots_per_axis=int(m.group(3)),
                       width=int(m.group(4))))


def ski_lines_ptxas(log: str, kernels=("rows_conv_2d", "cols_conv_2d")):
    """The same for B10's line kernels (ski_lines_2d.cuh), or B5's and
    B7's (SKI_LINES_1D, ski_lines_1d.cuh), per dtype."""
    return ptxas_rows(
        log, rf"({'|'.join(kernels)})I([df])E",
        lambda m: dict(kernel=m.group(1), dtype="float64"
                       if m.group(2) == "d" else "float32"))


SKI_LINES_1D = ("fs_columns_fwd", "fs_rows_conv", "fs_columns_inv",
                "w_apply_lines_1d")


def ptxas_rows(log: str, pattern: str, describe):
    """Registers, stack frame and spills from the -Xptxas -v build log of
    each kernel whose mangled name matches ``pattern``; ``describe`` turns
    the match into the row's keys."""
    pat = re.compile(pattern)
    rows, cur = {}, None
    for line in log.splitlines():
        m = pat.search(line)
        if m and ("Compiling entry function" in line
                  or "Function properties for" in line):
            cur = m.group(0)
            rows.setdefault(cur, describe(m))
            continue
        if cur is None:
            continue
        st = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                       r"stores, (\d+) bytes spill loads", line)
        if st:
            rows[cur].update(stack=int(st.group(1)),
                             spill_stores=int(st.group(2)),
                             spill_loads=int(st.group(3)))
        reg = re.search(r"Used (\d+) registers", line)
        if reg:
            rows[cur]["registers"] = int(reg.group(1))
            cur = None
    return list(rows.values())


def jvp_bound(kind, n1, n2, b, dtype, entries):
    """Roofline bound (ms, what bounds it) of B3: x1, x2, V, the output,
    params and pdot moved once; per needed entry (``entries``: for k1 and
    k2 those inside the Wendland window) the value and gradient
    (GRAD_OPS) and the cheaper of contracting the NS gradient tiles with
    V (2 NS b, tensor cores) and projecting on pdot first (2 NS, outside
    them) with 2 b for the one tile; float32 every operation at 67
    TFLOP/s."""
    item = torch.finfo(dtype).bits // 8
    ns = N_SLOTS.get(kind, 1)
    n_bytes = item * (n1 + n2 + n2 * b + n1 * b + 16)
    grad = entries * GRAD_OPS[kind]
    if dtype == torch.float32:
        return bound(n_bytes, grad + entries * min(2.0 * ns * b,
                                                   2.0 * ns + 2.0 * b),
                     0.0, FP32_PEAK)
    stacked = (grad, 2.0 * entries * ns * b)
    projected = (grad + 2.0 * entries * ns, 2.0 * entries * b)
    best = min((stacked, projected), key=lambda c: c[0] / FP64_PEAK
               + c[1] / FP64_TC_PEAK)
    return bound(n_bytes, *best)


def jvp_kernel_cases(cases, x, dev, rng):
    """B3 (one tangent direction, a random one in flat coordinates) at
    B2's shape (n = 8760, k2, b = 9), beside B2's time over its m
    directions; at the distributed gradient's b = 1 (alpha), 8 and 16
    (the probes), and at b = 17 (the tensor-core path); on a ragged
    1000 x 1001 block; all six kinds at n = 1000, b = 8; one float32
    case.  Each case gives its support_share and the (stripe, tile)
    pairs its kernel skips (the value sweep's grid)."""
    b2 = next(r for r in cases["tile_tangent"] if r["kind"] == "k2")
    f64, f32 = torch.float64, torch.float32
    shapes = ([("k2", N, N, b, f64) for b in (9, 1, 8, 16, 17)]
              + [("k2", 1000, 1001, 9, f64)]
              + [(k, 1000, 1000, 8, f64) for k in sorted(GRAD_OPS)]
              + [("k2", N, N, 9, f32)])
    for kind, n1, n2, b, dtype in shapes:
        th = torch.tensor(THETA.get(kind, [math.log(50.0)]),
                          dtype=torch.float64)
        dth = torch.tensor(rng.standard_normal(th.shape[0]))
        p = ops.natural_params(kind, th).to(dev, dtype)
        pdot = (dth @ ops.natural_tangents(kind, th)).to(dev, dtype)
        x1, x2 = x[:n1].to(dtype), x[:n2].to(dtype)
        v = torch.tensor(rng.standard_normal((n2, b)), device=dev,
                         dtype=dtype)

        def kern():
            return km.tile_jvp(kind, p, pdot, x1, x2, v)

        def plain():
            return km.tile_jvp_plain(kind, p, pdot, x1, x2, v)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        err, rel = errors(got, want)
        sup = km.support_entries(kind, p, x1, x2)
        pairs = -(-n1 // km.VALUE_ROWS) * -(-n2 // km.VALUE_COLS)
        kept = int(km.support_tiles(kind, p, x1, x2).shape[0])
        bms, by = jvp_bound(kind, n1, n2, b, dtype, sup)
        row = dict(kind=kind, n1=n1, n2=n2, b=b,
                   dtype=str(dtype).split(".")[-1], max_abs_err=err,
                   max_rel_err=rel, support_share=sup / (n1 * n2),
                   tiles_skipped=pairs - kept, tiles=pairs,
                   ms=time_ms(kern, 10),
                   plain_ms=time_ms(plain, 3), bound_ms=bms, bound_by=by)
        if (kind, n1, b, dtype) == ("k2", N, 9, f64):
            row["b2_ms_over_m"] = b2["ms"] / b2["m"]
        cases["tile_jvp"].append(row)


def ski_kernel_cases(cases, dev, rng, seed):
    """B5 at b = 1 (value CG), 8 (Lanczos), 9 (training CG) and 256 (the
    predict variance chunk), B6 at m = 3 (k1) and 5 (k2) with b = 9, on
    the SKI cell's geometry; one float32 case of each; then B5 timed and
    held against its plain version at n ~ 600, 2000 and 7080 (the
    crossover rows), and B7's cases (:func:`bank_kernel_cases`) and both
    on the sequential-vs-bank record (:func:`record_cases`)."""
    x, _, _, _ = make_tidal_data(seed)
    xt = torch.tensor(x, device=dev)
    for dtype, shapes in ((torch.float64, (1, 8, 9, 256)),
                          (torch.float32, (9,))):
        op = opers.select_operator("k2", xt, TIDAL_SIGMA_N, 1e-8)
        geom = op.fused_geom
        grid = opers.ToeplitzOperator("k2", op.grid)
        theta = torch.tensor(SKI_THETA["k2"], dtype=torch.float64,
                             device=dev)
        lam = sf.spectrum(grid.first_column(theta), geom).to(dtype)
        for b in shapes:
            v = torch.tensor(rng.standard_normal((geom.n, b)), device=dev,
                             dtype=dtype)
            got = sf.fused_gram_matvec(geom, lam, op.noise2, v)
            want = sf.fused_gram_matvec_plain(geom, lam, op.noise2, v)
            torch.cuda.synchronize()
            err, rel = errors(got, want)
            bms, by = ski_bound(geom, b, 0, dtype)
            cases["ski_gram"].append(dict(
                kind="k2", case="cell", n=geom.n, m_grid=geom.m_grid,
                L=geom.L, b=b, dtype=str(dtype).split(".")[-1],
                **gram_1d_plan_keys("ski_gram", geom, (b + 1) // 2, dtype),
                max_abs_err=err, max_rel_err=rel,
                ms=time_ms(lambda: sf.fused_gram_matvec(
                    geom, lam, op.noise2, v), 20),
                plain_ms=time_ms(lambda: sf.fused_gram_matvec_plain(
                    geom, lam, op.noise2, v), 10),
                bound_ms=bms, bound_by=by))
        for kind in ("k1", "k2"):
            if dtype == torch.float32 and kind == "k1":
                continue
            theta = torch.tensor(SKI_THETA[kind], dtype=torch.float64,
                                 device=dev)
            lams = sf.spectrum(opers.ToeplitzOperator(
                kind, op.grid).first_column_jacobian(theta),
                geom).to(dtype)
            v = torch.tensor(rng.standard_normal((geom.n, 9)), device=dev,
                             dtype=dtype)
            got = sf.fused_tangent_matvecs(geom, lams, v)
            want = sf.fused_tangent_matvecs_plain(geom, lams, v)
            torch.cuda.synchronize()
            err, rel = errors(got, want)
            m = int(lams.shape[0])
            bms, by = ski_bound(geom, 9, m, dtype)
            cases["ski_tangent"].append(dict(
                kind=kind, n=geom.n, m_grid=geom.m_grid, L=geom.L, b=9, m=m,
                dtype=str(dtype).split(".")[-1],
                **gram_1d_plan_keys("ski_tangent", geom, (9 + 1) // 2, dtype,
                                    m),
                max_abs_err=err, max_rel_err=rel,
                ms=time_ms(lambda: sf.fused_tangent_matvecs(geom, lams, v),
                           20),
                plain_ms=time_ms(lambda: sf.fused_tangent_matvecs_plain(
                    geom, lams, v), 10),
                bound_ms=bms, bound_by=by))
    crossover = []
    for months in (2, 6, TIDAL_MONTHS):
        xs, _, _, _ = make_tidal_data(seed, months=months)
        op = opers.select_operator("k2", torch.tensor(xs, device=dev),
                                   TIDAL_SIGMA_N, 1e-8)
        geom = op.fused_geom
        theta = torch.tensor(SKI_THETA["k2"], dtype=torch.float64,
                             device=dev)
        lam = sf.spectrum(opers.ToeplitzOperator("k2", op.grid)
                          .first_column(theta), geom)
        v = torch.tensor(rng.standard_normal((geom.n, 9)), device=dev)
        plan = sf.gram_1d_plan(geom.L, 5, 8)
        got = sf.fused_gram_matvec(geom, lam, op.noise2, v)
        want = sf.fused_gram_matvec_plain(geom, lam, op.noise2, v)
        torch.cuda.synchronize()
        err, rel = errors(got, want)
        row = dict(n=geom.n, m_grid=geom.m_grid, L=geom.L, b=9,
                   split=list(plan.split), kernel_launches=plan.launches,
                   max_abs_err=err, max_rel_err=rel,
                   ms=time_ms(lambda: sf.fused_gram_matvec(
                       geom, lam, op.noise2, v), 20),
                   plain_ms=time_ms(lambda: sf.fused_gram_matvec_plain(
                       geom, lam, op.noise2, v), 20))
        crossover.append(row)
        emit({"ski_gram_crossover": row})
        if not rel <= TOL["ski_gram"]:
            raise AssertionError(f"B5 disagrees with its plain version at "
                                 f"{months} months: {row}")
    bank_kernel_cases(cases, dev, rng, seed)
    record_cases(cases, dev, rng, seed)
    return crossover


def gram_1d_plan_keys(name, geom, lines, dtype, dirs=1):
    """The plan of one B5, B6 (``dirs`` tangent spectra) or B7 call
    (ski_fused.gram_1d_plan) on ``lines`` packed columns, printed as a
    ski_gram_plan line; returns its keys for the case's row."""
    item = torch.finfo(dtype).bits // 8
    plan = sf.gram_1d_plan(geom.L, lines, item, geom.split, dirs)
    keys = dict(split=list(plan.split), line_cap=plan.cap,
                kernel_launches=plan.launches,
                scratch_bytes=2 * item * plan.scratch)
    emit({"ski_gram_plan": dict(kernel=name, L=geom.L, lines=lines,
                                dirs=dirs, dtype=str(dtype).split(".")[-1],
                                **keys)})
    return keys


def record_cases(cases, dev, rng, seed):
    """B5 (b = 9, float64 and float32) and B7 (B = 4, c = 9) on the
    sequential-vs-bank check's record (SEQ_VS_BANK_MONTHS, L = 2048), the
    shapes that phase launches most, through the wrappers it calls."""
    xs, _, _, _ = make_tidal_data(seed, months=SEQ_VS_BANK_MONTHS)
    op = opers.select_operator("k2", torch.tensor(xs, device=dev),
                               TIDAL_SIGMA_N, 1e-8)
    geom = op.fused_geom
    for name, B, c, dtype in (("ski_gram", 1, 9, torch.float64),
                              ("ski_gram", 1, 9, torch.float32),
                              ("ski_bank", 4, 9, torch.float64)):
        lams = bank_spectra(op, B, dtype)
        shape = (geom.n, c) if name == "ski_gram" else (geom.n, B, c)
        v = torch.tensor(rng.standard_normal(shape), device=dev, dtype=dtype)
        if name == "ski_gram":
            def kern():
                return sf.fused_gram_matvec(geom, lams[0], op.noise2, v)

            def plain():
                return sf.fused_gram_matvec_plain(geom, lams[0], op.noise2, v)
        else:
            def kern():
                return sf.fused_bank_matvec(geom, lams, op.noise2, v)

            def plain():
                return sf.fused_bank_matvec_plain(geom, lams, op.noise2, v)

        keys = gram_1d_plan_keys(name, geom, B * ((c + 1) // 2), dtype)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err, rel = errors(got, want)
        bms, by = ski_bound(geom, c, 0, dtype, members=B)
        cases[name].append(dict(
            kind="k1" if B == 1 else "k1/k2", case="record",
            n=geom.n, m_grid=geom.m_grid, L=geom.L, B=B, b=c, c=c,
            dtype=str(dtype).split(".")[-1], **keys, max_abs_err=err,
            max_rel_err=rel, ms=time_ms(kern, 20),
            plain_ms=time_ms(plain, 10), bound_ms=bms, bound_by=by))


def bank_spectra(op, B: int, dtype):
    """(B, L) spectra of a bank that alternates k1 and k2, each repeat
    of a family moved 0.05 in its window (restart r of model k)."""
    rows = []
    for q in range(B):
        kind = ("k1", "k2")[q % 2]
        theta = torch.tensor(SKI_THETA[kind], dtype=torch.float64,
                             device=op.x.device)
        theta[0] += 0.05 * (q // 2)
        rows.append(sf.spectrum(opers.ToeplitzOperator(kind, op.grid)
                                .first_column(theta), op.fused_geom))
    return torch.stack(rows).to(dtype)


def bank_kernel_cases(cases, dev, rng, seed):
    """B7 on the SKI cell's geometry: B = 4 (two models x two restarts,
    as the SKI phase runs) at c = 1 (value CG), 8 (Lanczos) and 9
    (training CG), B = 20 at c = 9 (the reference's default of 10
    restarts), one float32 case; then B7 at B = 1 against B5."""
    x, _, _, _ = make_tidal_data(seed)
    op = opers.select_operator("k2", torch.tensor(x, device=dev),
                               TIDAL_SIGMA_N, 1e-8)
    geom = op.fused_geom
    for dtype, shapes in ((torch.float64, ((4, 1), (4, 8), (4, 9),
                                           (20, 9))),
                          (torch.float32, ((4, 9),))):
        for B, c in shapes:
            lams = bank_spectra(op, B, dtype)
            V = torch.tensor(rng.standard_normal((geom.n, B, c)), device=dev,
                             dtype=dtype)
            got = sf.fused_bank_matvec(geom, lams, op.noise2, V)
            want = sf.fused_bank_matvec_plain(geom, lams, op.noise2, V)
            torch.cuda.synchronize()
            err, rel = errors(got, want)
            bms, by = ski_bound(geom, c, 0, dtype, members=B)
            cases["ski_bank"].append(dict(
                kind="k1/k2", case="cell", n=geom.n, m_grid=geom.m_grid,
                L=geom.L, B=B, c=c, dtype=str(dtype).split(".")[-1],
                **gram_1d_plan_keys("ski_bank", geom, B * ((c + 1) // 2),
                                    dtype),
                max_abs_err=err, max_rel_err=rel,
                ms=time_ms(lambda: sf.fused_bank_matvec(
                    geom, lams, op.noise2, V), 20),
                plain_ms=time_ms(lambda: sf.fused_bank_matvec_plain(
                    geom, lams, op.noise2, V), 10),
                bound_ms=bms, bound_by=by))
    lam = bank_spectra(op, 1, torch.float64)
    V = torch.tensor(rng.standard_normal((geom.n, 1, 9)), device=dev)
    b7 = sf.fused_bank_matvec(geom, lam, op.noise2, V)[:, 0]
    b5 = sf.fused_gram_matvec(geom, lam[0], op.noise2,
                              V[:, 0].contiguous())
    torch.cuda.synchronize()
    err, rel = errors(b7, b5)
    emit({"ski_bank_vs_ski_gram": dict(n=geom.n, B=1, c=9, max_abs_err=err,
                                       max_rel_err=rel)})
    if not rel <= TOL["ski_bank"]:
        raise AssertionError(f"B7 at B = 1 disagrees with B5: {rel}")


def nd_kernel_cases(cases, dev, rng, seed):
    """B8 on the irregular (n, 2) stage's points (n = 4096: training CG
    b = 9, value CG b = 1, predict's mean n1 = 512 b = 1), B9 at m = 2
    (se*matern32) and m = 6 (k2*se) with b = 9; B10 on the product-SKI
    cell at b = 9 (training CG), 8 (Lanczos), 1 (value CG), 256 (the
    predict variance chunk) and a float32 case, and at b = 9 on a long
    field (LONG_FIELD_SHAPE: L1 = 8192, beyond the float64 line cap, so
    axis 0 takes the global passes); B11 with b = 9 at m = 2 on the cell
    (and float32), at m = 6 ("k2*se") on the cell and at m = 2 on the
    long field (B10's gram once per direction).  Each B10 and B11 case
    carries its plan: the line cap, the branch of each axis, the kernel
    launches per call and the scratch bytes (b11_case)."""
    x_np, _, xstar_np = make_scattered_field(seed)
    x = torch.tensor(x_np, device=dev)
    xstar = torch.tensor(xstar_np, device=dev)
    n = x.shape[0]
    for kind in ("se*matern32", "k2*se"):
        kinds = ops.split_kind(kind)
        theta = torch.tensor(ND_THETA[kind], dtype=torch.float64)
        p = ops.natural_params_nd(kind, theta).to(dev)
        pd = ops.natural_tangents_nd(kind, theta).to(dev)
        shapes = ((n, 9), (n, 1), (N_STAR, 1)) if kind == ND_KIND else ()
        for n1, b in shapes:
            x1 = x if n1 == n else xstar
            v = torch.tensor(rng.standard_normal((n, b)), device=dev)
            got = km.tile_matvec_nd(kinds, p, x1, x, v)
            want = km.tile_matvec_nd_plain(kinds, p, x1, x, v)
            torch.cuda.synchronize()
            err, rel = errors(got, want)
            bms, by = tile_nd_bound(kinds, n1, n, b)
            cases["tile_matvec_nd"].append(dict(
                kind=kind, n1=n1, n2=n, b=b, max_abs_err=err,
                max_rel_err=rel,
                ms=time_ms(lambda: km.tile_matvec_nd(kinds, p, x1, x, v), 10),
                plain_ms=time_ms(lambda: km.tile_matvec_nd_plain(
                    kinds, p, x1, x, v), 3),
                bound_ms=bms, bound_by=by))
        m = pd.shape[0]
        v = torch.tensor(rng.standard_normal((n, 9)), device=dev)
        got = km.tile_stacked_tangent_matvec_nd(kinds, p, pd, x, x, v)
        want = km.tile_stacked_tangent_matvec_nd_plain(kinds, p, pd, x, x, v)
        torch.cuda.synchronize()
        err, rel = errors(got, want)
        bms, by = tile_nd_bound(kinds, n, n, 9, m)
        cases["tile_tangent_nd"].append(dict(
            kind=kind, case="irregular", n1=n, n2=n, b=9, m=m,
            max_abs_err=err, max_rel_err=rel,
            ms=time_ms(lambda: km.tile_stacked_tangent_matvec_nd(
                kinds, p, pd, x, x, v), 10),
            plain_ms=time_ms(lambda: km.tile_stacked_tangent_matvec_nd_plain(
                kinds, p, pd, x, x, v), 3),
            bound_ms=bms, bound_by=by))
    theta = torch.tensor(ND_THETA[ND_KIND], dtype=torch.float64, device=dev)
    for case, shape, runs in (
            ("cell", FIELD_SHAPE, ((torch.float64, (9, 8, 1, 256)),
                                   (torch.float32, (9,)))),
            ("beyond_cap", LONG_FIELD_SHAPE, ((torch.float64, (9,)),))):
        xf, _, _ = make_field(seed, shape=shape)
        op = opers.select_operator(ND_KIND, torch.tensor(xf, device=dev),
                                   FIELD_SIGMA_N, 1e-8)
        geom = op.fused_geom
        for dtype, shapes in runs:
            lams = tuple(lam.to(dtype) for lam in sf.spectrum_nd(
                op._kron.first_columns(theta), geom))
            item = torch.finfo(dtype).bits // 8
            for b in shapes:
                plan = sf.gram_2d_plan(geom.shape, geom.Ls, b, item)
                v = torch.tensor(rng.standard_normal((geom.n, b)),
                                 device=dev, dtype=dtype)
                got = sf.fused_gram_matvec_nd(geom, lams, op.noise2, v)
                want = sf.fused_gram_matvec_nd_plain(geom, lams, op.noise2,
                                                     v)
                torch.cuda.synchronize()
                err, rel = errors(got, want)
                bms, by = ski_bound_2d(geom, b, 0, dtype)
                cases["ski_gram_2d"].append(dict(
                    kind=ND_KIND, case=case, n=geom.n, m_grid=geom.m_grid,
                    shape=list(geom.shape), L=list(geom.Ls), b=b,
                    dtype=str(dtype).split(".")[-1], line_cap=plan.cap,
                    shared_lines=[L <= plan.cap for L in geom.Ls],
                    kernel_launches=plan.launches,
                    scratch_bytes=2 * item * sum(plan.scratch),
                    max_abs_err=err, max_rel_err=rel,
                    ms=time_ms(lambda: sf.fused_gram_matvec_nd(
                        geom, lams, op.noise2, v), 20),
                    plain_ms=time_ms(lambda: sf.fused_gram_matvec_nd_plain(
                        geom, lams, op.noise2, v), 10),
                    bound_ms=bms, bound_by=by))
                del got, want
    for kind, case, shape, dtypes in (
            (ND_KIND, "cell", FIELD_SHAPE, (torch.float64, torch.float32)),
            ("k2*se", "cell", FIELD_SHAPE, (torch.float64,)),
            (ND_KIND, "beyond_cap", LONG_FIELD_SHAPE, (torch.float64,))):
        xf, _, _ = make_field(seed, shape=shape)
        op = opers.select_operator(kind, torch.tensor(xf, device=dev),
                                   FIELD_SIGMA_N, 1e-8)
        geom = op.fused_geom
        th = torch.tensor(ND_THETA[kind], dtype=torch.float64, device=dev)
        for dtype in dtypes:
            cases["ski_tangent_2d"].append(b11_case(kind, case, op, th,
                                                    dtype, rng))


def b11_case(kind, case, op, theta, dtype, rng, b=9):
    """One B11 case against its plain version, timed, with its plan
    (gram_2d_plan with the directions): the line cap, the branch of each
    axis (the shared-memory line kernels or the global passes), whether
    it runs B10's gram once per direction, the launches per call and the
    scratch bytes."""
    geom = op.fused_geom
    pairs = tuple(pr.to(dtype) for pr in sf.tangent_spectra_nd(
        op._kron, theta, geom, torch.float64))
    m = int(pairs[0].shape[0])
    item = torch.finfo(dtype).bits // 8
    plan = sf.gram_2d_plan(geom.shape, geom.Ls, b, item, None, m)
    v = torch.tensor(rng.standard_normal((geom.n, b)), device=theta.device,
                     dtype=dtype)
    got = sf.fused_tangent_matvecs_nd(geom, pairs, v)
    want = sf.fused_tangent_matvecs_nd_plain(geom, pairs, v)
    torch.cuda.synchronize()
    err, rel = errors(got, want)
    del got, want
    bms, by = ski_bound_2d(geom, b, m, dtype)
    return dict(
        kind=kind, case=case, n=geom.n, m_grid=geom.m_grid,
        shape=list(geom.shape), L=list(geom.Ls), b=b, m=m,
        dtype=str(dtype).split(".")[-1], line_cap=plan.cap,
        shared_lines=[L <= plan.cap for L in geom.Ls],
        per_direction=plan.per_direction, kernel_launches=plan.launches,
        scratch_bytes=2 * item * sum(plan.scratch), max_abs_err=err,
        max_rel_err=rel,
        ms=time_ms(lambda: sf.fused_tangent_matvecs_nd(geom, pairs, v), 20),
        plain_ms=time_ms(lambda: sf.fused_tangent_matvecs_nd_plain(
            geom, pairs, v), 10),
        bound_ms=bms, bound_by=by)


def rows_bound(kinds, b, n2, k, dtype):
    """Roofline bound (ms, what bounds it) of B12 (one kind) or B13 on
    (b, n2) entries: B1's count (B8's for a product), rows_x, x2, V and
    the output moved once; float32 counts every operation at 67 TFLOP/s."""
    d = len(kinds)
    item = torch.finfo(dtype).bits // 8
    entries = b * n2
    n_bytes = item * (d * (b + n2) + n2 * k + b * k + 8 * d)
    eval_ops = entries * (sum(EVAL_OPS[kd] for kd in kinds) + d - 1)
    mma = 2.0 * entries * k
    if dtype == torch.float32:
        return bound(n_bytes, eval_ops + mma, 0.0, FP32_PEAK)
    return bound(n_bytes, eval_ops, mma)


def make_stochastic_data(seed: int, n: int = STOCHASTIC_N):
    """run_stochastic's recipe (examples/large_scale_gp.py) in numpy:
    sorted uniform times on [0, 100], y = sin 2.1x + 0.3 sin 0.37x +
    0.1 noise; 256 sorted test points on [0, 100]."""
    rng = np.random.default_rng(seed + 5000)
    x = np.sort(rng.uniform(0.0, 100.0, n))
    y = np.sin(2.1 * x) + 0.3 * np.sin(0.37 * x) \
        + STOCHASTIC_SIGMA_N * rng.standard_normal(n)
    xstar = np.sort(rng.uniform(0.0, 100.0, STOCHASTIC_N_STAR))
    return x, y, xstar


def rows_kernel_cases(cases, dev, rng, seed):
    """B12 ("se", the 1-D stochastic stage's points) and B13
    ("se*matern32", d = 2, the (n, 2) stage's points) at the stage's
    shapes: b = 2048 rows of n2 = 65536 with k = 1 (value-only solves),
    9 ([y | 8 probes]) and 256 (a predict variance chunk); a ragged
    b = 1000 of n2 = 65537; b = 8; one float32 case at b = 2048, k = 9;
    and B13 on "k2*se" (a Wendland factor) at b = 2048, k = 9.  The rows
    are a random batch of distinct points, as an epoch draws."""
    x1, _, _ = make_stochastic_data(seed, STOCHASTIC_N + 1)
    x2, _, _ = make_scattered_field(seed, STOCHASTIC_N + 1)
    shapes = ((2048, STOCHASTIC_N, 1, torch.float64),
              (2048, STOCHASTIC_N, 9, torch.float64),
              (2048, STOCHASTIC_N, 256, torch.float64),
              (1000, STOCHASTIC_N + 1, 9, torch.float64),
              (8, STOCHASTIC_N, 9, torch.float64),
              (2048, STOCHASTIC_N, 9, torch.float32))
    for name, kind, x_np, runs in (
            ("tile_rows", "se", x1, shapes),
            ("tile_rows_nd", "se*matern32", x2, shapes),
            ("tile_rows_nd", "k2*se", x2,
             ((2048, STOCHASTIC_N, 9, torch.float64),))):
        kinds = ops.split_kind(kind)
        theta = torch.tensor(ROWS_THETA[kind], dtype=torch.float64)
        for b, n2, k, dtype in runs:
            x = torch.tensor(x_np[:n2], device=dev, dtype=dtype)
            rows = torch.tensor(rng.permutation(n2)[:b], device=dev)
            xb = x[rows]
            v = torch.tensor(rng.standard_normal((n2, k)), device=dev,
                             dtype=dtype)
            if len(kinds) > 1:
                p = ops.natural_params_nd(kind, theta).to(dev, dtype)

                def kern():
                    return km.tile_matvec_rows_nd(kinds, p, xb, x, v)

                def plain():
                    return km.tile_matvec_nd_plain(kinds, p, xb, x, v)
            else:
                p = ops.natural_params(kind, theta).to(dev, dtype)

                def kern():
                    return km.tile_matvec_rows(kind, p, xb, x, v)

                def plain():
                    return km.tile_matvec_plain(kind, p, xb, x, v)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err, rel = errors(got, want)
            bms, by = rows_bound(kinds, b, n2, k, dtype)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            cases[name].append(dict(
                kind=kind, b=b, n2=n2, k=k,
                segments=km.row_segments(b, n2, sms, km.VALUE_GRID)[0],
                dtype=str(dtype).split(".")[-1], max_abs_err=err,
                max_rel_err=rel, ms=time_ms(kern, 10),
                plain_ms=time_ms(plain, 3), bound_ms=bms, bound_by=by))
            del got, want


def stochastic_phase(seed):
    """Structure-free data at n = 65536 through backend="auto" (the
    stochastic backend) in two stages, 1-D ("se") and (n, 2)
    ("se*matern32"); see the module docstring."""
    opts = eng.SolverOpts(n_probes=8)
    policy = gp.SolverPolicy(backend="auto", n_starts=1,
                             max_iters=STOCHASTIC_ITERS, opts=opts)
    kfit, kev, k2fit, k2ev = rnd.split(rnd.key(seed + 4000), 4)
    out = {}
    x2, y2, xs2 = make_scattered_field(seed, STOCHASTIC_N)
    for name, kind, sigma_n, (x_np, y_np, xs_np), kf, ke, rows_kernel in (
            ("1d", "se", STOCHASTIC_SIGMA_N, make_stochastic_data(seed),
             kfit, kev, "tile_rows"),
            ("2d", ND_KIND, FIELD_SIGMA_N, (x2, y2, xs2[:STOCHASTIC_N_STAR]),
             k2fit, k2ev, "tile_rows_nd")):
        spec = gp.GPSpec(kind, noise=gp.NoiseModel(sigma_n=sigma_n),
                         solver=policy)
        stage = Stages(f"stochastic_{name}", STOCHASTIC_KERNELS)
        _cuda.reset_launches()
        _sync.reset()
        stochastic.reset_epoch_counts()
        torch.cuda.reset_peak_memory_stats()
        session = stage("bind", lambda: gp.GP.bind(spec, x_np, y_np))
        if (session.backend, session.operator_name) != ("stochastic",
                                                        "pallas"):
            raise AssertionError(f"bound {session!r}, expected the "
                                 "stochastic backend on the tile operator")
        plan = eng.select_stochastic(session.op, opts)
        z0 = from_box(torch.tensor(STOCHASTIC_THETA0[kind],
                                   dtype=session.x.dtype,
                                   device=session.x.device), session.box)
        fitted = stage("fit", lambda: session.fit(kf, z0s=z0[None, :]))
        evidence = stage("log_evidence", lambda: fitted.log_evidence(key=ke))
        post = stage("predict", lambda: fitted.predict(xs_np))
        peak_bytes = torch.cuda.max_memory_allocated()
        launches = dict(_cuda.LAUNCHES)
        syncs = dict(_sync.COUNT)
        epochs = dict(stochastic.EPOCH_COUNTS)
        res = fitted.result
        sf2 = float(res.sigma_f_hat) ** 2
        # at the peak: the stochastic alpha's true residual, one exact
        # B1 (B8) matvec
        t0 = time.perf_counter()
        th = res.theta_hat.to(fitted.x.device)
        solver = eng.make_solver("stochastic", fitted.cov, th, fitted.x,
                                 fitted.y, sigma_n, key=rnd.key(seed),
                                 jitter=fitted.jitter, opts=opts,
                                 op=fitted.op)
        solver.sigma2_hat()
        alpha = solver.alpha
        resid = (ops.matvec(fitted.kind, th, fitted.x, fitted.x, alpha)
                 + fitted.op.noise2 * alpha - fitted.y)
        rel_resid = float(torch.linalg.vector_norm(resid)
                          / torch.linalg.vector_norm(fitted.y))
        at_peak_s = time.perf_counter() - t0
        # why the line search stalls: the gradient's slope against the
        # value's, at the start and at the end of the fit
        t0 = time.perf_counter()
        slopes = [stochastic_slope_probe(fitted, t, sigma_n, rnd.key(seed),
                                         opts)
                  for t in (to_box(z0, session.box), th)]
        slope_s = time.perf_counter() - t0
        out[name] = dict(
            kind=kind, n=session.n, sigma_n=sigma_n,
            plan=dict(batch=plan.batch, rank=plan.rank,
                      adaptive=plan.adaptive, epochs=plan.epochs,
                      tol=plan.tol),
            stage_s=stage.s, epochs_per_solve=epochs,
            launches=launches, stage_launches=stage.launches,
            host_syncs=sum(syncs.values()), host_syncs_by_loop=syncs,
            peak_allocated_bytes=peak_bytes,
            log_p_max=float(res.log_p_max), theta_hat=res.theta_hat.tolist(),
            n_evals=res.n_evals, log_z=float(evidence.log_z),
            var_min=float(post.var.min()), var_max=float(post.var.max()),
            sigma_f_hat_sq=sf2, hessian_eigenvalues=stage.hessians,
            residual_at_peak=rel_resid, residual_at_peak_epochs=int(
                solver.last_epochs), at_peak_s=at_peak_s,
            slope_probe=slopes, slope_probe_s=slope_s)
        emit({f"stochastic_{name}": out[name]})
        check_launched(launches, (rows_kernel,), f"stochastic {name}")
        check_finite((("ln P_max", res.log_p_max),
                      ("ln Z", evidence.log_z)))
        check_posterior(post, sf2, sigma_n, out[name],
                        n_star=STOCHASTIC_N_STAR)
        limit = 2 * opts.mem_budget_mb * (1 << 20)
        if not peak_bytes < limit:
            raise AssertionError(f"the stochastic {name} stage allocated "
                                 f"{peak_bytes} bytes at its peak, over "
                                 f"2 x mem_budget_mb = {limit}")
        if not rel_resid <= 1.0:
            raise AssertionError(f"the stochastic alpha at the {name} peak "
                                 f"has a relative residual {rel_resid} > 1, "
                                 "worse than the zero start")
    out["launches"] = {k: sum(out[st]["launches"].get(k, 0)
                              for st in ("1d", "2d"))
                       for k in STOCHASTIC_KERNELS}
    return out


# step lengths of the slope probe, in theta along the unit gradient
SLOPE_STEPS = (1e-2, 1e-3)


def stochastic_slope_probe(fitted, theta, sigma_n, key, opts):
    """Why the NCG line search stalls on the stochastic backend, measured
    at theta: the slope that the Hutchinson gradient claims along its own
    unit direction d = g / |g| against central differences of the value
    that the Armijo test compares, ln P_max = -n/2 ln sigma2_hat (the
    quadratic part, from the solve of y) - 1/2 ln det (the log-det part,
    the pivoted-Cholesky spectrum's matched trace), each part beside its
    term of the gradient (1/2 alpha^T dK alpha / sigma2_hat and
    -1/2 tr(K^-1 dK) by Hutchinson).  The probes and permutations are
    the same at every point, as in the fit."""
    n = fitted.n

    def solver(th):
        return eng.make_solver("stochastic", fitted.cov, th, fitted.x,
                               fitted.y, sigma_n, key=key,
                               jitter=fitted.jitter, opts=opts, op=fitted.op)

    def parts(th):
        s = solver(th)
        return (float(-0.5 * n * torch.log(s.sigma2_hat())),
                float(-0.5 * s.logdet()))

    s0 = solver(theta)
    quad, tr = s0.grad_terms()
    g_quad = 0.5 * quad / s0.sigma2_hat()
    g_logdet = -0.5 * tr
    g = g_quad + g_logdet
    d = g / torch.linalg.vector_norm(g)
    out = dict(theta=theta.tolist(), grad=g.tolist(),
               grad_slope=float(g @ d), grad_slope_quad=float(g_quad @ d),
               grad_slope_logdet=float(g_logdet @ d), fd=[])
    for h in SLOPE_STEPS:
        qp, lp = parts(theta + h * d)
        qm, lm = parts(theta - h * d)
        out["fd"].append(dict(h=h, slope=(qp + lp - qm - lm) / (2 * h),
                              slope_quad=(qp - qm) / (2 * h),
                              slope_logdet=(lp - lm) / (2 * h)))
    return out


def stochastic_small_input_checks(dev):
    """The stochastic objective (backend pinned, n = 1024, 1-D "se" and
    (n, 2) "se*matern32") card against CPU, the same probes and epoch
    permutations (drawn on the host from the same keys)."""
    checks = []
    opts = eng.SolverOpts(n_probes=4)
    for kind, (x, y, _), sigma_n in (
            ("se", make_stochastic_data(2, 1024), STOCHASTIC_SIGMA_N),
            (ND_KIND, make_scattered_field(2, 1024), FIELD_SIGMA_N)):
        spec = gp.GPSpec(kind, noise=gp.NoiseModel(sigma_n=sigma_n),
                         solver=gp.SolverPolicy(backend="stochastic",
                                                opts=opts))
        _cuda.reset_launches()
        checks.append((len(x), "pallas", card_vs_cpu(
            spec, x, y, ROWS_THETA[kind], sigma_n, dev,
            backend="stochastic")))
        # the card's side went through its row-slab kernel
        rows = ROWS_KERNELS[1] if "*" in kind else ROWS_KERNELS[0]
        emit({"stochastic_small_input_launches": {
            "kind": kind, rows: _cuda.LAUNCHES[rows]}})
        if dev.type == "cuda" and not _cuda.LAUNCHES[rows]:
            raise AssertionError(f"the card's side of the {kind} small "
                                 f"input never launched {rows}")
    return checks


# ---------------------------------------------------------------------------
# distributed phase
# ---------------------------------------------------------------------------

def make_synthetic(seed: int, n: int, dev):
    """repro.data.synthetic's k2 recipe in numpy: x = 1..n, one draw of
    the k2 GP at K2_TRUE with unit scale, L z with L the Cholesky factor
    of K + (0.1^2 + 1e-10) I on the card and z from numpy's generator."""
    x = torch.arange(1, n + 1, dtype=torch.float64, device=dev)
    K = ops.matrix("k2", torch.tensor(K2_TRUE, device=dev), x, x)
    K.diagonal().add_(SIGMA_N ** 2 + 1e-10)
    z = np.random.default_rng(seed + 6000).standard_normal(n)
    y = torch.linalg.cholesky(K) @ torch.tensor(z, device=dev)
    return x.cpu().numpy(), y.cpu().numpy()


def dense_step(kind, theta, x, y, sigma_n, jitter=1e-8):
    """The exact ln P_max (eq. 2.16) and gradient (eq. 2.17) at theta from
    a dense Cholesky on the card: K from B4 (ops.matrix), each dK_i from
    the plain tangent block, tr(K^-1 dK_i) against the explicit inverse."""
    n = x.shape[0]
    th = torch.tensor(theta, dtype=x.dtype, device=x.device)
    K = ops.matrix(kind, th, x, x)
    K.diagonal().add_(sigma_n ** 2 + jitter)
    chol, info = torch.linalg.cholesky_ex(K)
    if int(info) != 0:
        raise AssertionError(f"K is not positive definite at {theta} "
                             f"(cholesky info {int(info)})")
    del K
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    s2 = float(y @ alpha) / n
    logdet = 2.0 * float(torch.sum(torch.log(torch.diagonal(chol))))
    lp = -0.5 * n * (math.log(2.0 * math.pi) + 1.0 + math.log(s2)) \
        - 0.5 * logdet
    kinv = torch.cholesky_inverse(chol)
    p = ops.natural_params(kind, th)
    pdots = ops.natural_tangents(kind, th)
    grad = []
    for i in range(pdots.shape[0]):
        dK = tangent_matrices_ref(kind, p, pdots[i:i + 1], x, x)[0]
        grad.append(0.5 * float(alpha @ (dK @ alpha)) / s2
                    - 0.5 * float(torch.sum(kinv * dK)))
        del dK
    return lp, np.asarray(grad), s2, logdet


def distributed_stage(name, kind, theta, x_np, y_np, sigma_n, group, key,
                      want_op, dev, check=True, **kw):
    """One run of the distributed step on ``dev`` with its launches and
    host syncs, held against the dense answer at the same theta (with
    ``check`` False the errors are printed, not limited)."""
    op_name = opers.select_operator(
        kind, torch.tensor(x_np, device=dev), 0.0, 0.0).name
    if op_name != want_op:
        raise AssertionError(f"{name} takes the {op_name!r} branch, "
                             f"expected {want_op!r}")
    _cuda.reset_launches()
    _sync.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = distributed.distributed_profiled_loglik(kind, theta, x_np, y_np,
                                                  sigma_n, group, key,
                                                  device=dev, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    syncs = dict(_sync.COUNT)
    lp = float(res.log_p_max)
    g = res.grad.cpu().numpy()
    t0 = time.perf_counter()
    lp_ex, g_ex, s2_ex, logdet_ex = dense_step(
        kind, theta, torch.tensor(x_np, device=dev),
        torch.tensor(y_np, device=dev), sigma_n)
    n = len(x_np)
    s2 = float(res.sigma2_hat)
    # the step's SLQ log-det, from ln P and sigma2_hat
    logdet = -2.0 * (lp + 0.5 * n * (math.log(2.0 * math.pi) + 1.0
                                     + math.log(s2)))
    dense_s = time.perf_counter() - t0
    lp_rel = abs(lp - lp_ex) / abs(lp_ex)
    cos = float(g @ g_ex / (np.linalg.norm(g) * np.linalg.norm(g_ex)))
    cap = kw.get("cg_max_iter", 600)
    row = dict(stage=name, phase="distributed", operator=op_name,
               n=n, kind=kind, theta=list(theta), s=sec,
               cg_iters=res.cg_iters, cg_max_iter=cap,
               cg_cut=res.cg_iters >= cap,
               host_syncs=sum(syncs.values()), host_syncs_by_loop=syncs,
               launches=launches, log_p_max=lp, log_p_exact=lp_ex,
               log_p_rel_err=lp_rel, sigma2_hat=s2, sigma2_exact=s2_ex,
               logdet=logdet, logdet_exact=logdet_ex,
               grad=g.tolist(), grad_exact=g_ex.tolist(), grad_cos=cos,
               dense_s=dense_s)
    emit(row)
    check_finite((("distributed ln P_max", lp), ("its gradient",
                                                 float(np.sum(g)))))
    if check and not (lp_rel <= DIST_LP_REL and cos >= DIST_GRAD_COS):
        raise AssertionError(f"{name} disagrees with the dense answer: "
                             f"|d ln P / ln P| = {lp_rel} (limit "
                             f"{DIST_LP_REL}), gradient cosine {cos} "
                             f"(limit {DIST_GRAD_COS})")
    return row


def distributed_small_inputs(n=DIST_SMALL_N):
    """The card-vs-CPU inputs: per branch (x, theta); y and the probes
    shared."""
    rng = np.random.default_rng(10)
    full = 2.0 * np.arange(n + n // 7 + 2)
    inputs = {"pallas": (np.sort(rng.uniform(0.0, float(n), n)),
                         DIST_THETA),
              "toeplitz": (np.arange(1.0, n + 1.0), DIST_THETA),
              "ski": (np.delete(full, np.arange(3, full.size, 8))[:n],
                      SKI_THETA["k2"])}
    y = np.sin(np.arange(n) / 9.0) + SIGMA_N * rng.standard_normal(n)
    z = rng.choice([-1.0, 1.0], (n, 8))
    return inputs, y, z


def distributed_small_runs(group, device):
    inputs, y, z = distributed_small_inputs()
    out = {}
    for br, (x, theta) in inputs.items():
        r = distributed.distributed_profiled_loglik(
            "k2", theta, x, y, DIST_SMALL_SIGMA_N, group, None, n_probes=8,
            lanczos_k=32, cg_tol=1e-10, cg_max_iter=3000, probes=z,
            device=device)
        out[br] = (float(r.log_p_max), r.grad.cpu().numpy(), r.cg_iters)
    return out


def stochastic_group_check(group, seed, dev):
    """One StochasticSolver solve of [y | probes] with its row slabs on
    the group (sharded_rows_matvec) against group=None, n = 4096."""
    x, y, _ = make_stochastic_data(seed, DIST_STOCHASTIC_N)
    xt = torch.tensor(x, device=dev)
    yt = torch.tensor(y, device=dev)
    th = torch.tensor(ROWS_THETA["se"], device=dev)
    opts = eng.SolverOpts(n_probes=8)
    got = []
    for g in (group, None):
        _cuda.reset_launches()
        s = stochastic.StochasticSolver("se", th, xt, yt, STOCHASTIC_SIGMA_N,
                                        rnd.key(seed), opts=opts, group=g)
        sol = s.solve(torch.cat([yt[:, None], s.z], dim=1))
        torch.cuda.synchronize()
        got.append((sol, _cuda.LAUNCHES["tile_rows"]))
    (sharded, n_sharded), (plain, n_plain) = got
    err, rel = errors(sharded, plain)
    row = dict(n=DIST_STOCHASTIC_N, max_abs_err=err, max_rel_err=rel,
               tile_rows_sharded=n_sharded, tile_rows_plain=n_plain)
    emit({"stochastic_group_check": row})
    if not (rel <= 1e-12 and n_sharded == n_plain > 0):
        raise AssertionError(f"StochasticSolver(group=) disagrees with "
                             f"group=None: {row}")
    return row


def distributed_phase(seed, dev):
    """The row-sharded GP step at world size 1 on the card (NCCL), three
    stages and its checks; see the module docstring."""
    out = {}
    group = make_local_group(dev)
    try:
        x_np, y_np, _ = make_data(seed, dev)
        out["tile"] = distributed_stage(
            "distributed_tile", "k2", DIST_THETA, x_np, y_np, SIGMA_N, group,
            rnd.key(seed + 6000), "pallas", dev, n_probes=16, lanczos_k=64,
            cg_max_iter=600)
        launches = out["tile"]["launches"]
        if not (launches.get("tile_jvp", 0) == 10
                and launches.get("tile_tangent", 0) == 0
                and launches.get("tile_matvec", 0) > 0):
            raise AssertionError(f"the tile branch's gradient must be 2 x 5 "
                                 f"B3 launches and no B2: {launches}")
        x_ex, y_ex = make_synthetic(seed, DIST_EXAMPLE_N, dev)
        out["example"] = distributed_stage(
            "distributed_example", "k2", DIST_EXAMPLE_THETA, x_ex, y_ex,
            SIGMA_N, group, rnd.key(9), "toeplitz", dev, n_probes=8,
            lanczos_k=48, cg_max_iter=300)
        print(f"distributed (torch.distributed, "
              f"{dist.get_backend(group)}) ln P_max @ "
              f"n={DIST_EXAMPLE_N} = {out['example']['log_p_max']:.1f} "
              f"({out['example']['s']:.0f}s)", flush=True)
        xs, ys, _, _ = make_tidal_data(seed)
        out["ski"] = distributed_stage(
            "distributed_ski", "k2", SKI_THETA["k2"], xs, ys, TIDAL_SIGMA_N,
            group, rnd.key(seed + 6001), "ski", dev,
            cg_max_iter=DIST_SKI_CG_MAX_ITER, lanczos_k=DIST_SKI_LANCZOS_K)
        out["ski_k64"] = distributed_stage(
            "distributed_ski_k64", "k2", SKI_THETA["k2"], xs, ys,
            TIDAL_SIGMA_N, group, rnd.key(seed + 6001), "ski", dev,
            check=False, cg_max_iter=3000)
        card = distributed_small_runs(group, dev)
        out["stochastic_group"] = stochastic_group_check(group, seed, dev)
    finally:
        dist.destroy_process_group()
    group = make_local_group("cpu")
    try:
        cpu = distributed_small_runs(group, torch.device("cpu"))
    finally:
        dist.destroy_process_group()
    out["small_inputs"] = {}
    for br in card:
        (lp, g, it_card), (lp_cpu, g_cpu, it_cpu) = card[br], cpu[br]
        row = dict(n=DIST_SMALL_N, operator=br,
                   log_p_max_rel_err=abs(lp - lp_cpu) / abs(lp_cpu),
                   grad_rel_err=float(np.max(np.abs(g - g_cpu))
                                      / np.max(np.abs(g_cpu))),
                   cg_iters_card=it_card, cg_iters_cpu=it_cpu)
        out["small_inputs"][br] = row
        emit({"distributed_small_input_check": row})
        if not (row["log_p_max_rel_err"] <= 1e-8
                and row["grad_rel_err"] <= 1e-8):
            raise AssertionError(f"the distributed step on the card and on "
                                 f"the CPU disagree ({br}): {row}")
    return out


def check_cases(cases, names):
    for name in names:
        for row in cases[name]:
            emit({"kernel_case": name, **row})
            tol = TOL[name] if row.get("dtype", "float64") == "float64" \
                else TOL_F32
            if not row["max_rel_err"] <= tol:
                raise AssertionError(
                    f"{name} disagrees with its plain version: {row}")


# the case that stands for each kernel in the summary line: the shape the
# workflow launches most (k2, training CG / gradient, predict cross block)
HEADLINE = {"tile_matvec": dict(kind="k2", case="theta", n1=N, b=9),
            "tile_tangent": dict(kind="k2", case="theta", b=9),
            "tile_matrix": dict(kind="k2", case="predict"),
            "ski_gram": dict(case="cell", b=9, dtype="float64"),
            "ski_tangent": dict(kind="k2", dtype="float64"),
            "ski_bank": dict(case="cell", B=4, c=9, dtype="float64"),
            "tile_matvec_nd": dict(n1=N_ND_IRREGULAR, b=9),
            "tile_tangent_nd": dict(kind=ND_KIND, case="stochastic"),
            "ski_gram_2d": dict(case="cell", b=9, dtype="float64"),
            "ski_tangent_2d": dict(kind=ND_KIND, case="cell",
                                   dtype="float64"),
            "tile_rows": dict(b=2048, n2=STOCHASTIC_N, k=9,
                              dtype="float64"),
            "tile_rows_nd": dict(kind="se*matern32", b=2048,
                                 n2=STOCHASTIC_N, k=9, dtype="float64"),
            "tile_jvp": dict(kind="k2", n1=N, b=9, dtype="float64")}


def headline(name, rows):
    want = HEADLINE[name]
    return next(r for r in rows if all(r[k] == v for k, v in want.items()))


# ---------------------------------------------------------------------------
# workflow phases
# ---------------------------------------------------------------------------

class Stages:
    """Times the stages of one phase; keeps, per stage, how its CG solves
    ended, the eigenvalues of each Laplace Hessian it formed and, given
    ``kernels``, the launches of those kernels during the stage."""

    def __init__(self, phase, kernels=(), info=None):
        self.phase = phase
        self.kernels = kernels
        self.info = info or (lambda: {})
        self.s, self.cg_stops, self.hessians, self.launches = {}, {}, {}, {}

    def __call__(self, name, fn):
        it.reset_cg_stops()
        laplace.HESSIAN_EIGENVALUES.clear()
        before = {k: _cuda.LAUNCHES[k] for k in self.kernels}
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.s[name] = time.perf_counter() - t0
        self.cg_stops[name] = dict(
            tol=it.CG_STOPS["tol"], max_iter=it.CG_STOPS["max_iter"],
            worst_residual_at_max_iter=it.CG_WORST_RESIDUAL[0])
        self.hessians[name] = [lam.tolist()
                               for lam in laplace.HESSIAN_EIGENVALUES]
        self.launches[name] = {k: _cuda.LAUNCHES[k] - before[k]
                               for k in self.kernels}
        line = {"stage": name, "phase": self.phase, "s": self.s[name],
                "cg_stops": self.cg_stops[name],
                "hessian_eigenvalues": self.hessians[name]}
        if self.kernels:
            line.update(self.info(), launches=self.launches[name])
        emit(line)
        return out


def check_posterior(post, sf2, sigma_n, summary, n_star=N_STAR):
    var = post.var
    if post.mean.shape != (n_star,) or var.shape != (n_star,):
        raise AssertionError("posterior has the wrong shape")
    if not bool(torch.isfinite(post.mean).all()):
        raise AssertionError("posterior mean is not finite")
    if not (float(var.min()) >= 0.0
            and float(var.max()) <= sf2 * (1.0 + sigma_n ** 2)):
        raise AssertionError(f"variance outside [0, sigma_f^2 (1 + "
                             f"sigma_n^2)]: {summary}")


def check_finite(pairs):
    for label, val in pairs:
        if not math.isfinite(float(val)):
            raise AssertionError(f"{label} is not finite: {val}")


def check_launched(launches, names, phase):
    for name in names:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"{phase} phase: {launches}")


def workflow_phase(x_np, y_np, xstar_np, seed, budget):
    """The irregular path (tile operator): bind -> fit -> log_evidence ->
    predict.  (Its compare stage runs the same sequential compare as the
    SKI phase and was left out to keep the script inside its limit.)"""
    opts = eng.SolverOpts(n_probes=8, lanczos_k=48, cg_tol=1e-6,
                          cg_max_iter=400)
    plan = BUDGETS[budget]
    policy = gp.SolverPolicy(backend="auto", n_starts=2,
                             max_iters=plan["max_iters"],
                             scan_points=plan["scan_points"], opts=opts)
    spec = gp.GPSpec("k2", noise=gp.NoiseModel(sigma_n=SIGMA_N),
                     solver=policy)
    if plan["tidal_boxes"]:
        spec = spec.with_box(tidal_boxes()["k2"])
    key = rnd.key(seed)
    kfit, kev, _ = rnd.split(key, 3)
    stage = Stages("irregular")

    _cuda.reset_launches()
    _sync.reset()
    session = stage("bind", lambda: gp.GP.bind(spec, x_np, y_np))
    if (session.backend, session.operator_name) != ("iterative", "pallas"):
        raise AssertionError(f"bound {session!r}, expected the iterative "
                             "backend on the tile operator")
    fitted = stage("fit", lambda: session.fit(kfit))
    evidence = stage("log_evidence", lambda: fitted.log_evidence(key=kev))
    post = stage("predict", lambda: fitted.predict(xstar_np))
    launches = dict(_cuda.LAUNCHES)
    syncs = dict(_sync.COUNT)

    res = fitted.result
    sf2 = float(res.sigma_f_hat) ** 2
    summary = dict(
        n=N, n_star=N_STAR, seed=seed, budget=budget, stage_s=stage.s,
        log_p_max=float(res.log_p_max), theta_hat=res.theta_hat.tolist(),
        log_p_all=res.log_p_all.tolist(), n_evals=res.n_evals,
        log_z=float(evidence.log_z), n_modes=evidence.n_modes,
        host_syncs=sum(syncs.values()), host_syncs_by_loop=syncs,
        launches=launches, var_min=float(post.var.min()),
        var_max=float(post.var.max()), sigma_f_hat_sq=sf2,
        cg_stops=stage.cg_stops, hessian_eigenvalues=stage.hessians)
    emit({"workflow": summary})
    check_launched(launches, TILE_KERNELS, "irregular")
    check_finite((("ln P_max", res.log_p_max), ("ln Z", evidence.log_z)))
    check_posterior(post, sf2, SIGMA_N, summary)
    return summary


class BankCapture:
    """Keeps the BankTrainResult of every ``train_bank`` call made inside
    the ``with`` block (the bank that a compare trained), for reports."""

    def __enter__(self):
        self.fits = []
        self._train = batch.train_bank

        def keep(*args, **kwargs):
            self.fits.append(self._train(*args, **kwargs))
            return self.fits[-1]

        batch.train_bank = keep
        return self

    def __exit__(self, *exc):
        batch.train_bank = self._train


def describe_bank(tr, opts):
    bank = tr.bank
    thetas = tr.theta_all.reshape(-1, tr.theta_all.shape[-1])
    return dict(structure=bank.structure, fused=bank.fused, B=bank.B,
                m_grid=bank.m_grid,
                L=bank.fused_geom.L if bank.fused_geom else bank.L,
                precond=bank.resolve_precond(opts),
                slq_precond=bank.bind_slq_precond(
                    thetas, thetas.dtype) is not None)


def ski_policy(cg_max_iter=SKI_CG_MAX_ITER, max_iters=25, fused="auto"):
    """The SKI cell's solver policy (``scripts/ski_fit_variants.py`` fits
    the cell under it with another CG cap, step count or ``fused``)."""
    opts = eng.SolverOpts(n_probes=8, lanczos_k=48, cg_tol=1e-6,
                          cg_max_iter=cg_max_iter, precond="auto",
                          fused=fused)
    return gp.SolverPolicy(backend="auto", n_starts=2, max_iters=max_iters,
                           scan_points=64, opts=opts)


def ski_phase(seed):
    """The near-grid path: a gappy tide record through the SKI operator
    (B5 and B6) with the circulant preconditioner: bind(k2) -> fit ->
    log_evidence -> compare([k1, k2]) (the batched bank, B7) ->
    predict."""
    x_np, y_np, xstar_np, n_full = make_tidal_data(seed)
    policy = ski_policy()
    opts = policy.opts
    boxes = tidal_boxes()
    specs = [gp.GPSpec(k, box=boxes[k],
                       noise=gp.NoiseModel(sigma_n=TIDAL_SIGMA_N),
                       solver=policy) for k in ("k1", "k2")]
    key = rnd.key(seed + 1000)
    kfit, kev, kcmp = rnd.split(key, 3)
    bound_op = {}

    def info():
        op = bound_op["op"]
        pc = it.make_preconditioner(
            op, torch.tensor(SKI_THETA["k2"], device=op.x.device),
            opts.precond, opts.precond_rank)
        return dict(operator=op.name, m_grid=op.m_grid,
                    L=op.fused_geom.L if op.fused_geom else None,
                    fused=op.fused,
                    precond=eng.select_precond(op, opts),
                    slq_precond=pc is not None and pc.slq is not None)

    stage = Stages("ski", SKI_KERNELS, info)
    _cuda.reset_launches()
    _sync.reset()

    def bind():
        s = gp.GP.bind(specs[1], x_np, y_np)
        bound_op["op"] = s.op
        return s

    session = stage("bind", bind)
    op = session.op
    desc = info()
    if (session.backend, op.name, desc["fused"]) != ("iterative", "ski",
                                                     True):
        raise AssertionError(f"bound {session!r} (fused {desc['fused']}), "
                             "expected the iterative backend on the fused "
                             "SKI operator")
    if (desc["precond"], desc["slq_precond"]) != ("circulant", True):
        raise AssertionError(f"precond resolved to {desc}, expected "
                             "'circulant' with the masked-circulant SLQ")
    fitted = stage("fit", lambda: session.fit(kfit))
    evidence = stage("log_evidence", lambda: fitted.log_evidence(key=kev))
    with BankCapture() as cap:
        reports = stage("compare", lambda: gp.compare(specs, x_np, y_np,
                                                      key=kcmp))
    if len(cap.fits) != 1:
        raise AssertionError("the compare stage did not train one bank")
    bank = dict(describe_bank(cap.fits[0], opts),
                launches=stage.launches["compare"],
                cg_stops=stage.cg_stops["compare"],
                iters_all=cap.fits[0].iters_all.tolist())
    emit({"bank": bank})
    if (bank["structure"], bank["fused"], bank["precond"],
            bank["slq_precond"]) != ("near", True, "circulant", True):
        raise AssertionError(f"the compare stage's bank is {bank}, expected "
                             "the fused near-grid bank with the circulant "
                             "preconditioner and the masked-circulant SLQ")
    if bank["launches"]["ski_bank"] <= 0 or bank["launches"]["ski_gram"]:
        raise AssertionError(f"the compare stage must launch ski_bank and "
                             f"not ski_gram: {bank['launches']}")
    post = stage("predict", lambda: fitted.predict(xstar_np,
                                                   cross="interp"))
    var_before_clamp_min = predict.VAR_BEFORE_CLAMP_MIN[0]
    launches = dict(_cuda.LAUNCHES)
    syncs = dict(_sync.COUNT)

    lnb = float(gp.log_bayes_factors(reports)[1, 0])
    res = fitted.result
    sf2 = float(res.sigma_f_hat) ** 2
    summary = dict(
        n=session.n, n_full=n_full, n_star=N_STAR, seed=seed, **desc,
        stage_s=stage.s, log_p_max=float(res.log_p_max),
        theta_hat=res.theta_hat.tolist(), log_p_all=res.log_p_all.tolist(),
        n_evals=res.n_evals, log_z=float(evidence.log_z),
        n_modes=evidence.n_modes,
        compare={r.name: dict(log_z=r.log_z_laplace, log_p_max=r.log_p_max,
                              theta_hat=r.theta_hat.tolist(),
                              n_modes=r.n_modes, n_evals=r.n_evals_train)
                 for r in reports},
        ln_b_k2_vs_k1=lnb, bank=bank, host_syncs=sum(syncs.values()),
        host_syncs_by_loop=syncs, launches=launches,
        stage_launches=stage.launches, var_min=float(post.var.min()),
        var_max=float(post.var.max()),
        var_before_clamp_min=var_before_clamp_min, sigma_f_hat_sq=sf2,
        cg_stops=stage.cg_stops, hessian_eigenvalues=stage.hessians)
    emit({"ski_workflow": summary})
    summary["at_peak"] = check_at_peak(fitted, post, xstar_np, seed)
    check_launched(launches, SKI_KERNELS, "SKI")
    check_finite((("ln P_max", res.log_p_max), ("ln Z", evidence.log_z),
                  ("ln B", lnb))
                 + tuple((f"compare ln Z ({r.name})", r.log_z_laplace)
                         for r in reports))
    check_posterior(post, sf2, TIDAL_SIGMA_N, summary)
    return summary


def sequential_vs_bank(seed, sigma_n=SIX_MONTH_SIGMA_N, n_starts=2,
                       iters=SIX_MONTH_ITERS, scan=SIX_MONTH_SCAN,
                       months=SEQ_VS_BANK_MONTHS):
    """A gappy record of ``months`` (3: n ~ 885; at n <= 2048 the "auto"
    backend would be dense, so the iterative backend is pinned) through
    compare(batch="off") and compare(batch="auto") on the same data and
    key.  Both must give finite ln Z and pick the same model; the two
    ln B differ by the estimators' noise (the paths draw different
    probes and starts).  ``--six-month`` runs it alone at another
    budget."""
    x_np, y_np, _, n_full = make_tidal_data(seed, months=months)
    opts = eng.SolverOpts(n_probes=8, lanczos_k=48, cg_tol=1e-6,
                          cg_max_iter=400, precond="circulant")
    policy = gp.SolverPolicy(backend="iterative", n_starts=n_starts,
                             max_iters=iters, scan_points=scan or None,
                             opts=opts)
    boxes = tidal_boxes()
    specs = [gp.GPSpec(k, box=boxes[k],
                       noise=gp.NoiseModel(sigma_n=sigma_n),
                       solver=policy) for k in ("k1", "k2")]
    key = rnd.key(seed + 2000)
    out = dict(n=len(x_np), n_full=n_full, months=months, sigma_n=sigma_n,
               n_starts=n_starts, iters=iters, scan=scan)
    for mode in ("off", "auto"):
        _cuda.reset_launches()
        it.reset_cg_stops()
        t0 = time.perf_counter()
        reports = gp.compare(specs, x_np, y_np, key=key, batch=mode)
        torch.cuda.synchronize()
        lz = {r.name: r.log_z_laplace for r in reports}
        out[mode] = dict(
            s=time.perf_counter() - t0, log_z=lz,
            log_p_max={r.name: r.log_p_max for r in reports},
            ln_b_k2_vs_k1=lz["k2"] - lz["k1"],
            winner=max(lz, key=lambda k: lz[k]),
            n_modes={r.name: r.n_modes for r in reports},
            launches={k: _cuda.LAUNCHES[k] for k in SKI_KERNELS},
            cg_stops=dict(tol=it.CG_STOPS["tol"],
                          max_iter=it.CG_STOPS["max_iter"]))
    out["ln_b_diff"] = out["auto"]["ln_b_k2_vs_k1"] \
        - out["off"]["ln_b_k2_vs_k1"]
    emit({"sequential_vs_bank": out})
    check_finite(tuple((f"ln Z ({mode}, {k})", v) for mode in ("off", "auto")
                       for k, v in out[mode]["log_z"].items()))
    if out["off"]["winner"] != out["auto"]["winner"]:
        raise AssertionError(f"compare(batch='off') and compare(batch="
                             f"'auto') pick different models: {out}")
    if out["auto"]["launches"]["ski_bank"] <= 0 \
            or out["off"]["launches"]["ski_bank"]:
        raise AssertionError(f"only the batched compare may launch "
                             f"ski_bank: {out}")
    return out


def nd_phase(seed):
    """The N-D grid path in three stages (see the module docstring): the
    gappy field on product SKI, the full field on the Kronecker operator,
    scattered (n, 2) points on the product tiles.  Launch counts are set
    to 0 before each stage group and read after it."""
    opts = eng.SolverOpts(n_probes=8, lanczos_k=48, cg_tol=1e-6,
                          cg_max_iter=400, precond="auto")
    policy = gp.SolverPolicy(backend="auto", n_starts=2, max_iters=25,
                             opts=opts)
    short = policy._replace(n_starts=1, max_iters=ND_SHORT_ITERS)
    noise = gp.NoiseModel(sigma_n=FIELD_SIGMA_N)
    specs = [gp.GPSpec(k, noise=noise, solver=policy) for k in ND_MODELS]
    # the product-SKI session's own solves run unpreconditioned and to
    # their tolerance: behind the product-SKI circulant preconditioner (no
    # noise in its spectrum, as in the JAX package) its fit ends at a nan
    # ln Z, and so it does behind none with CG cut at 400 (PERF.md); the
    # compare keeps "auto" (the bank's preconditioner has the noise)
    seq_spec = gp.GPSpec(ND_KIND, noise=noise, solver=policy._replace(
        n_starts=1, opts=opts._replace(precond=None,
                                       cg_max_iter=ND_SEQ_CG_MAX_ITER)))
    kfit, kev, kcmp, kkron, kirr = rnd.split(rnd.key(seed + 3000), 5)
    theta0 = torch.tensor(ND_THETA[ND_KIND], dtype=torch.float64)
    bound_op = {}

    def info():
        op, sopts = bound_op["op"], bound_op["opts"]
        pc = it.make_preconditioner(op, theta0.to(op.x.device),
                                    sopts.precond, sopts.precond_rank)
        geom = getattr(op, "fused_geom", None)
        return dict(operator=op.name, n=op.n,
                    shape=list(getattr(op, "shape", ()) or ()),
                    L=list(geom.Ls) if geom is not None else None,
                    fused=bool(getattr(op, "fused", False)),
                    precond=eng.select_precond(op, sopts),
                    slq_precond=pc is not None and pc.slq is not None)

    def bind(spec, x, y):
        def run():
            s = gp.GP.bind(spec, x, y)
            bound_op["op"] = s.op
            bound_op["opts"] = spec.solver.opts
            return s
        return run

    out = {}
    # stage 1: the gappy field on product SKI, the whole workflow
    x_np, y_np, xstar_np = make_field(seed)
    stage = Stages("nd_product_ski", ND_KERNELS, info)
    _cuda.reset_launches()
    _sync.reset()
    torch.cuda.reset_peak_memory_stats()
    session = stage("bind", bind(seq_spec, x_np, y_np))
    desc = info()
    if (session.backend, desc["operator"], desc["fused"], desc["precond"],
            desc["slq_precond"]) != ("iterative", "product_ski", True, None,
                                     False):
        raise AssertionError(f"bound {session!r} ({desc}), expected the "
                             "iterative backend on the fused product-SKI "
                             "operator with no preconditioner")
    fitted = stage("fit", lambda: session.fit(kfit))
    evidence = stage("log_evidence", lambda: fitted.log_evidence(key=kev))
    with BankCapture() as cap:
        reports = stage("compare", lambda: gp.compare(specs, x_np, y_np,
                                                      key=kcmp))
    if len(cap.fits) != 1:
        raise AssertionError("the compare stage did not train one bank")
    bank = dict(describe_bank(cap.fits[0], opts),
                launches=stage.launches["compare"],
                cg_stops=stage.cg_stops["compare"],
                iters_all=cap.fits[0].iters_all.tolist())
    emit({"nd_bank": bank})
    if (bank["structure"], bank["fused"], bank["precond"],
            bank["slq_precond"]) != ("product", False, "circulant", True):
        raise AssertionError(f"the compare stage's bank is {bank}, expected "
                             "the unfused product bank with the circulant "
                             "preconditioner and the masked-circulant SLQ")
    post = stage("predict", lambda: fitted.predict(xstar_np,
                                                   cross="interp"))
    peak_bytes = torch.cuda.max_memory_allocated()
    launches = dict(_cuda.LAUNCHES)
    syncs = dict(_sync.COUNT)
    res = fitted.result
    sf2 = float(res.sigma_f_hat) ** 2
    lnb = float(gp.log_bayes_factors(reports)[1, 0])
    out["product_ski"] = dict(
        field_shape=list(FIELD_SHAPE), drop=FIELD_DROP, seed=seed,
        **desc, stage_s=stage.s, log_p_max=float(res.log_p_max),
        theta_hat=res.theta_hat.tolist(), log_p_all=res.log_p_all.tolist(),
        n_evals=res.n_evals, log_z=float(evidence.log_z),
        n_modes=evidence.n_modes,
        compare={r.name: dict(log_z=r.log_z_laplace, log_p_max=r.log_p_max,
                              theta_hat=r.theta_hat.tolist(),
                              n_modes=r.n_modes, n_evals=r.n_evals_train)
                 for r in reports},
        ln_b_matern32_vs_se=lnb, bank=bank, host_syncs=sum(syncs.values()),
        peak_allocated_bytes=peak_bytes,
        launches=launches, stage_launches=stage.launches,
        var_min=float(post.var.min()), var_max=float(post.var.max()),
        sigma_f_hat_sq=sf2, cg_stops=stage.cg_stops,
        hessian_eigenvalues=stage.hessians)
    emit({"nd_product_ski": out["product_ski"]})
    check_launched(stage.launches["fit"], ("ski_gram_2d", "ski_tangent_2d"),
                   "product-SKI fit")
    check_finite((("ln P_max", res.log_p_max), ("ln Z", evidence.log_z),
                  ("ln B", lnb))
                 + tuple((f"compare ln Z ({r.name})", r.log_z_laplace)
                         for r in reports))
    check_posterior(post, sf2, FIELD_SIGMA_N, out["product_ski"])
    # at the peak: against the exact GP, and the product-SKI circulant CG
    # preconditioner (the JAX package's: no noise in its spectrum) beside
    # none
    op, th = fitted.op, res.theta_hat.to(fitted.x.device)
    t0 = time.perf_counter()
    out["product_ski"]["at_peak"] = check_at_peak(
        fitted, post, xstar_np, seed, label="nd_at_peak",
        variants={"circulant": op.circulant_precond(th), "none": None},
        caps=(opts.cg_max_iter, 10 * opts.cg_max_iter))
    out["product_ski"]["at_peak_s"] = time.perf_counter() - t0

    # stages 2 and 3: the Kronecker grid and scattered points
    for name, data, kfit_s, want in (
            ("kron", make_field(seed, drop=0.0), kkron, "kron"),
            ("irregular", make_scattered_field(seed), kirr, "pallas")):
        x_s, y_s, xs_s = data
        spec = gp.GPSpec(ND_KIND, noise=noise, solver=short)
        stage = Stages(f"nd_{name}", ND_KERNELS, info)
        _cuda.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        session = stage("bind", bind(spec, x_s, y_s))
        if (session.backend, session.operator_name) != ("iterative", want):
            raise AssertionError(f"bound {session!r}, expected the iterative "
                                 f"backend on the {want} operator")
        fitted = stage("fit", lambda: session.fit(kfit_s))
        post = stage("predict", lambda: fitted.predict(xs_s))
        res = fitted.result
        sf2 = float(res.sigma_f_hat) ** 2
        out[name] = dict(
            **info(), stage_s=stage.s,
            log_p_max=float(res.log_p_max), theta_hat=res.theta_hat.tolist(),
            n_evals=res.n_evals, launches=dict(_cuda.LAUNCHES),
            peak_allocated_bytes=torch.cuda.max_memory_allocated(),
            stage_launches=stage.launches, var_min=float(post.var.min()),
            var_max=float(post.var.max()), sigma_f_hat_sq=sf2,
            cg_stops=stage.cg_stops)
        emit({f"nd_{name}": out[name]})
        check_launched(stage.launches["predict"], ("tile_matvec_nd",),
                       f"{name} predict")
        if name == "irregular":
            check_launched(stage.launches["fit"],
                           ("tile_matvec_nd", "tile_tangent_nd"),
                           "irregular (n, 2) fit")
        check_finite((("ln P_max", res.log_p_max),))
        check_posterior(post, sf2, FIELD_SIGMA_N, out[name])
    out["launches"] = {k: sum(out[st]["launches"].get(k, 0) for st in
                              ("product_ski", "kron", "irregular"))
                       for k in ND_KERNELS}
    return out


def check_at_peak(fitted, post, xstar_np, seed, label="at_peak",
                  variants=None, caps=None):
    """A SKI cell's answers at its fitted peak against the exact GP.

    The cell's CG solves stop at cg_max_iter behind the policy's
    circulant preconditioner, its ln P carries the SLQ log-det, and its
    variance the interpolated cross covariance.  On a gappy record or
    field W is a one-hot selection, so the (product-)SKI gram is the dense
    K(x, x) + noise2 I: at theta_hat this builds it (B4, once per factor
    of a composite kind), factors it (Cholesky on the card) and
      - fails if a cut solve of [y | 8 probes], made as the cell makes
        it, has a larger K-norm error than the zero start in any column
        (preconditioned CG never increases it in exact arithmetic, so a
        larger one is divergence, whatever the residual says);
      - reports the cell's errors against the exact values: ln P at the
        peak, the posterior mean and the variance (as returned, and its
        least value before predict's clamp at 0), with the errors of the
        interpolated cross covariance alone (solved exactly);
      - with ``variants`` (name -> preconditioner apply or None), solves
        the same right-hand sides behind each, cut at each of ``caps``
        (default: the cell's cap and 10 times it), and reports their
        iterations, largest relative residual and K-norm error (nothing
        fails on them).
    """
    op, kind = fitted.op, fitted.kind
    opts = fitted.spec.solver.opts
    x, y = fitted.x, fitted.y
    n = op.n
    theta = fitted.result.theta_hat.to(x.device)
    xs = torch.as_tensor(xstar_np, device=x.device, dtype=x.dtype)
    K = ops.matrix(kind, theta, x, x)
    K.diagonal().add_(op.noise2)
    chol, info = torch.linalg.cholesky_ex(K)
    if int(info) != 0:
        raise AssertionError(f"K at the peak is not positive definite "
                             f"(cholesky info {int(info)})")
    rhs = torch.cat([y[:, None], rnd.rademacher(
        rnd.key(seed), (n, 8), device=x.device, dtype=x.dtype)], dim=1)
    exact = torch.cholesky_solve(rhs, chol)
    mv = opers.bound_gram_matvec(op, theta, x.dtype)

    def solve(precond, max_iter):
        cut = it.cg_solve(mv, rhs, tol=opts.cg_tol, max_iter=max_iter,
                          precond=precond)
        err = cut.x - exact
        knorm = torch.sqrt(torch.sum(err * (K @ err), dim=0)
                           / torch.sum(exact * rhs, dim=0))
        return cut, knorm

    pc = it.make_preconditioner(op, theta, opts.precond, opts.precond_rank)
    cut, knorm_err = solve(pc.apply if pc is not None else None,
                           opts.cg_max_iter)
    s2 = float(y @ exact[:, 0]) / n
    ln_p = (-0.5 * n * (math.log(2.0 * math.pi) + 1.0 + math.log(s2))
            - float(torch.sum(torch.log(torch.diagonal(chol)))))
    s2_cut = float(y @ cut.x[:, 0]) / n
    noise_var = (fitted.spec.noise.sigma_n ** 2
                 if fitted.spec.noise.include_noise else 0.0)

    def posterior(ks):
        quad = torch.sum(torch.linalg.solve_triangular(
            chol, ks, upper=False) ** 2, dim=0)
        return ks.T @ exact[:, 0], s2 * (1.0 - quad + noise_var)

    mean, var = posterior(ops.matrix(kind, theta, x, xs))
    mean_interp, var_interp = posterior(
        op.cross_columns(theta, op.cross_interp(xs)))
    out = dict(
        cut_iters=cut.iters, cut_resnorm_max=float(cut.resnorm.max()),
        knorm_rel_err=knorm_err.tolist(), ln_p_exact=ln_p,
        ln_p_phase=float(fitted.result.log_p_max),
        ln_p_datafit_err_cut=0.5 * n * abs(math.log(s2_cut / s2)),
        mean_err_max=float((post.mean - mean).abs().max()),
        mean_interp_err_max=float((mean_interp - mean).abs().max()),
        var_exact_min=float(var.min()), var_exact_max=float(var.max()),
        var_err_max=float((post.var - var).abs().max()),
        var_interp_err_max=float((var_interp - var).abs().max()))
    for name, apply in (variants or {}).items():
        row = {}
        for cap in caps or (opts.cg_max_iter, 10 * opts.cg_max_iter):
            t0 = time.perf_counter()
            got, knorm = solve(apply, cap)
            row[f"cap_{cap}"] = dict(
                iters=got.iters, resnorm_max=float(got.resnorm.max()),
                knorm_rel_err_max=float(knorm.max()),
                s=time.perf_counter() - t0)
        out.setdefault("precond_variants", {})[name] = row
    emit({label: out})
    check_finite((("exact ln P at the peak", ln_p),
                  ("K-norm error of the cut solve", knorm_err.max())))
    if not float(knorm_err.max()) <= 1.0:
        raise AssertionError(f"the cell's CG diverges at the peak ({label}): "
                             f"its K-norm error exceeds the zero start's: "
                             f"{out}")
    return out


def timescales(rep):
    """T1 (and for k2 T2, ordered) in hours with their error bars
    (dT = T dphi) from a compare report."""
    th = rep.theta_hat.cpu().numpy()
    err = rep.errors.cpu().numpy()
    if rep.name == "k1":
        return {"T1_h": float(np.exp(th[1])),
                "T1_err": float(np.exp(th[1]) * err[1])}
    (t1, e1), (t2, e2) = sorted((float(np.exp(th[i])),
                                 float(np.exp(th[i]) * err[i]))
                                for i in (1, 3))
    return {"T1_h": t1, "T1_err": e1, "T2_h": t2, "T2_err": e2}


def five_point(fn, theta, i, h):
    """d fn / d theta_i by the five-point central difference."""
    e = torch.zeros_like(theta)
    e[i] = h
    return (fn(theta - 2 * e) - 8 * fn(theta - e) + 8 * fn(theta + e)
            - fn(theta + 2 * e)) / (12 * h)


def dense_derivative_checks(cov, theta, x, y, sigma_n, jitter=1e-10):
    """At theta: the jvp gradient (eq. 2.17) against five-point central
    differences of the dense ln P_max, and the analytic Hessian (eq. 2.19)
    against its own transpose and five-point central differences of the
    gradient.  The step along theta_i is DENSE_FD_STEP error bars,
    1 / sqrt|H_ii|.  Gradient entries are relative to the larger of |g_i|
    and sqrt|H_ii| (the gradient one error bar from a peak), Hessian
    entries to sqrt|H_ii H_jj|."""
    def value(t):
        return hyperlik.profiled_loglik(cov, t, x, y, sigma_n, jitter)[0]

    def grad(t):
        _, cache = hyperlik.profiled_loglik(cov, t, x, y, sigma_n, jitter)
        return hyperlik.profiled_grad(cov, t, x, y, sigma_n, cache, jitter)

    _, cache = hyperlik.profiled_loglik(cov, theta, x, y, sigma_n, jitter)
    g = hyperlik.profiled_grad(cov, theta, x, y, sigma_n, cache, jitter)
    H = hyperlik.profiled_hessian(cov, theta, x, y, sigma_n, cache, jitter)
    scale = torch.sqrt(torch.abs(torch.diagonal(H)))
    m = theta.shape[0]
    g_fd = torch.stack([five_point(value, theta, i,
                                   DENSE_FD_STEP / float(scale[i]))
                        for i in range(m)])
    H_fd = torch.stack([five_point(grad, theta, j,
                                   DENSE_FD_STEP / float(scale[j]))
                        for j in range(m)], dim=1)
    grad_rel = float(torch.max(torch.abs(g_fd - g)
                               / torch.maximum(torch.abs(g), scale)))
    hess_rel = float(torch.max(torch.abs(H_fd - H)
                               / (scale[:, None] * scale[None, :])))
    sym = float(torch.max(torch.abs(H - H.T)) / torch.max(torch.abs(H)))
    return dict(grad_rel_err=grad_rel, hess_rel_err=hess_rel,
                hess_asym=sym, grad=g.tolist(),
                hess_diag=torch.diagonal(H).tolist())


def dense_card_vs_cpu(theta, seed, dev):
    """ln P_max, its gradient and its Hessian for k2 on the 1-month tide
    record (n = 328), the same inputs on the card and on the CPU:
    relative errors (the gradient's and Hessian's over their max-abs)."""
    ds = woods_hole_like(rnd.key(seed), months=DENSE_SMALL_MONTHS,
                         device="cpu")
    out = {}
    for where in ("cpu", dev):
        x, y = ds.x.to(where), ds.y.to(where)
        th = torch.as_tensor(theta, dtype=torch.float64, device=where)
        cov = gp.GPSpec("k2").cov
        val, cache = hyperlik.profiled_loglik(cov, th, x, y, ds.sigma_n)
        out[str(where)] = [
            t.cpu() for t in (val, hyperlik.profiled_grad(
                cov, th, x, y, ds.sigma_n, cache), hyperlik.profiled_hessian(
                    cov, th, x, y, ds.sigma_n, cache))]
    (v0, g0, h0), (v1, g1, h1) = out["cpu"], out[str(dev)]
    return dict(
        n=int(ds.x.shape[0]),
        log_p_max_rel_err=float(abs(v1 - v0) / abs(v0)),
        grad_rel_err=float(torch.max(torch.abs(g1 - g0))
                           / torch.max(torch.abs(g0))),
        hess_rel_err=float(torch.max(torch.abs(h1 - h0))
                           / torch.max(torch.abs(h0))))


def dense_record(stage, label, ds, policy, xstar, dev, draws=0):
    """compare(["k1", "k2"]) on one record through backend="auto" (it
    must bind the dense backend), then predict (and sample) at the
    peak of the model with the larger ln Z."""
    specs = gp.spec_bank(["k1", "k2"], noise=gp.NoiseModel(ds.sigma_n),
                         solver=policy)
    bound = gp.GP.bind(specs[1], ds.x, ds.y)
    if (bound.backend, bound.operator_name) != ("dense", "dense"):
        raise AssertionError(f"{label}: bound {bound!r}, expected the "
                             f"dense backend")
    reports = stage(f"{label}_compare", lambda: gp.compare(
        specs, ds.x, ds.y, key=rnd.key(0)))
    lnb = reports[1].log_z_laplace - reports[0].log_z_laplace
    best = max(reports, key=lambda r: r.log_z_laplace)
    sess = gp.GP.bind(gp.as_spec(best.name, noise=gp.NoiseModel(ds.sigma_n),
                                 solver=policy), ds.x, ds.y)
    post = stage(f"{label}_predict", lambda: sess.predict(
        xstar, theta=best.theta_hat))
    out = dict(n=int(ds.x.shape[0]), sigma_n=ds.sigma_n, ln_b=lnb,
               winner=best.name, models={})
    for r in reports:
        out["models"][r.name] = dict(
            log_p_max=r.log_p_max, log_z=r.log_z_laplace,
            n_evals=r.n_evals_train, n_modes=r.n_modes,
            theta_hat=r.theta_hat.tolist(), errors=r.errors.tolist(),
            sigma_f_hat=r.sigma_f_hat, **timescales(r))
    check_finite([(f"{label} {r.name} ln P_max", r.log_p_max)
                  for r in reports]
                 + [(f"{label} {r.name} ln Z", r.log_z_laplace)
                    for r in reports] + [(f"{label} ln B", lnb)])
    check_posterior(post, best.sigma_f_hat ** 2, ds.sigma_n, out,
                    n_star=int(xstar.shape[0]))
    out.update(var_min=float(post.var.min()), var_max=float(post.var.max()))
    if draws:
        s = stage(f"{label}_sample", lambda: sess.sample(
            rnd.key(5), xstar, n_draws=draws, theta=best.theta_hat))
        if s.shape != (draws, xstar.shape[0]) or not bool(
                torch.isfinite(s).all()):
            raise AssertionError(f"{label}: bad joint draws {s.shape}")
        out["draws_shape"] = list(s.shape)
    return reports, out


def dense_phase(seed, dev):
    """The dense backend on the paper's two example records (phase 9):
    compare, predict and sample through the front door, the jvp gradient
    and analytic Hessian against central differences at the tide peaks,
    and the card against the CPU at n = 328."""
    stage = Stages("dense")
    _cuda.reset_launches()
    _sync.reset()
    torch.cuda.reset_peak_memory_stats()
    quick = synthetic(rnd.key(42 + seed), DENSE_QUICK_N, "k2")
    _, q_out = dense_record(
        stage, "quickstart", quick,
        gp.SolverPolicy(backend="auto", **DENSE_QUICK_BUDGET),
        torch.linspace(float(quick.x[0]), float(quick.x[-1]),
                       DENSE_QUICK_N_STAR, dtype=torch.float64, device=dev),
        dev, draws=DENSE_DRAWS)
    tide = woods_hole_like(rnd.key(seed), months=DENSE_TIDAL_MONTHS)
    xstar = torch.sort(rnd.uniform(rnd.key(seed + 1), (N_STAR,),
                                   float(tide.x[0]), float(tide.x[-1]),
                                   device=dev)).values
    reports, t_out = dense_record(
        stage, "tide", tide,
        gp.SolverPolicy(backend="auto", scan_points=DENSE_TIDAL_SCAN,
                        **DENSE_TIDAL_BUDGET), xstar, dev)
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    syncs = dict(_sync.COUNT)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    checks = {}
    t0 = time.perf_counter()
    for r in reports:
        checks[r.name] = dense_derivative_checks(
            gp.GPSpec(r.name).cov, r.theta_hat, tide.x, tide.y,
            tide.sigma_n)
    checks["card_vs_cpu"] = dense_card_vs_cpu(reports[1].theta_hat.cpu(),
                                              seed, dev)
    torch.cuda.synchronize()
    checks_s = time.perf_counter() - t0
    summary = dict(seed=seed, stage_s=stage.s, checks_s=checks_s,
                   quickstart=q_out, tide=t_out, checks=checks,
                   hand_kernel_launches=launches, host_syncs=sum(
                       syncs.values()), host_syncs_by_loop=syncs,
                   peak_allocated_gb=peak_gb,
                   hessian_eigenvalues=stage.hessians)
    emit({"dense": summary})
    if launches:
        raise AssertionError(f"the dense path launched hand kernels: "
                             f"{launches}")
    for name in ("k1", "k2"):
        c = checks[name]
        if not c["grad_rel_err"] <= DENSE_GRAD_TOL:
            raise AssertionError(f"dense {name}: the jvp gradient and "
                                 f"central differences disagree: {c}")
        if not (c["hess_asym"] <= 1e-12
                and c["hess_rel_err"] <= DENSE_HESS_TOL):
            raise AssertionError(f"dense {name}: the analytic Hessian is "
                                 f"not symmetric or disagrees with central "
                                 f"differences of the gradient: {c}")
    c = checks["card_vs_cpu"]
    if not max(c["log_p_max_rel_err"], c["grad_rel_err"],
               c["hess_rel_err"]) <= DENSE_CPU_TOL:
        raise AssertionError(f"dense: the card and the CPU disagree at "
                             f"n = {c['n']}: {c}")
    return summary


def nested_identity(n_evals, n_live, per_iter, n_iters):
    """n_evals = n_live + n_iters x per_iter (the JAX package's count)."""
    return n_evals == n_live + n_iters * per_iter


def nested_phase(seed, dev):
    """The nested-sampling baseline through the front door (phase 10):
    (a) compare(run_nested=True) on the quickstart record, (b) the card
    against the CPU on a small record, (c) the matrix-free integrand."""
    stage = Stages("nested")
    _cuda.reset_launches()
    _sync.reset()
    runs = []
    impl = nested._evidence_nested_impl

    def timed(*a, **kw):
        reads = _sync.COUNT["nested_iter"]
        t0 = time.perf_counter()
        res = impl(*a, **kw)
        torch.cuda.synchronize()
        runs.append(dict(s=time.perf_counter() - t0, n_iters=res.n_iters,
                         n_evals=res.n_evals, h_info=float(res.h_info),
                         host_reads=_sync.COUNT["nested_iter"] - reads))
        return res

    nested._evidence_nested_impl = timed
    nested.GRAPHS.clear()
    try:
        quick = synthetic(rnd.key(42 + seed), DENSE_QUICK_N, "k2")
        specs = gp.spec_bank(["k1", "k2"],
                             noise=gp.NoiseModel(quick.sigma_n),
                             solver=gp.SolverPolicy(backend="auto",
                                                    **DENSE_QUICK_BUDGET))
        reports = stage("quickstart_compare_nested", lambda: gp.compare(
            specs, quick.x, quick.y, key=rnd.key(0), run_nested=True,
            n_live=NESTED_N_LIVE, nested_max_iter=NESTED_MAX_ITER,
            batch="off"))
    finally:
        nested._evidence_nested_impl = impl
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    out = dict(seed=seed, n=DENSE_QUICK_N, n_live=NESTED_N_LIVE,
               max_iter=NESTED_MAX_ITER, stage_s=stage.s, models={},
               hand_kernel_launches=launches,
               host_syncs_by_loop=dict(_sync.COUNT),
               step_graphs=dict(nested.GRAPHS))
    for r, run in zip(reports, runs):
        err = r.log_z_nested_err
        out["models"][r.name] = dict(
            log_z_laplace=r.log_z_laplace, log_z_nested=r.log_z_nested,
            log_z_nested_err=err,
            diff_in_err=(r.log_z_nested - r.log_z_laplace) / err,
            n_evals_train=r.n_evals_train, n_evals_nested=r.n_evals_nested,
            speedup=r.speedup, n_modes=r.n_modes, **run)
    out["ln_b_laplace"] = reports[1].log_z_laplace - reports[0].log_z_laplace
    out["ln_b_nested"] = reports[1].log_z_nested - reports[0].log_z_nested
    emit({"nested": out})
    check_finite([(f"nested {r.name} {what}", v) for r in reports
                  for what, v in (("ln Z_laplace", r.log_z_laplace),
                                  ("ln Z_nested", r.log_z_nested))])
    if len(runs) != len(reports) or not all(
            nested_identity(r.n_evals_nested, NESTED_N_LIVE, 8 * 16,
                            run["n_iters"]) for r, run in zip(reports, runs)):
        raise AssertionError(f"nested: n_evals is not n_live + iterations "
                             f"x 128: {out['models']}")
    if launches:
        raise AssertionError(f"the dense nested path launched hand "
                             f"kernels: {launches}")
    if nested.GRAPHS["captured"] != len(reports):
        raise AssertionError(f"the dense chain steps were not captured as "
                             f"one CUDA graph a model: {dict(nested.GRAPHS)}")

    # (b) the card against the CPU: the same key, the same CPU draws.  The
    # box keeps K off the diagonal plateau (see NESTED_SMALL_BOX)
    small = synthetic(rnd.key(7 + seed), NESTED_SMALL["n"], "k2",
                      device="cpu")
    got = {}
    for where in ("cpu", dev):
        sess = gp.GP.bind(gp.GPSpec("k2", box=FlatBox(*(
            torch.tensor(b, dtype=torch.float64) for b in NESTED_SMALL_BOX)),
            noise=gp.NoiseModel(small.sigma_n)), small.x, small.y,
            device=where)
        got[str(where)] = stage(f"small_{torch.device(where).type}",
                                lambda: sess.log_evidence(
                                    method="nested", key=rnd.key(11),
                                    n_live=NESTED_SMALL["n_live"],
                                    max_iter=NESTED_SMALL["max_iter"]))
    c, g = got["cpu"], got[str(dev)]
    small_out = dict(
        n=NESTED_SMALL["n"], n_iters=[c.n_iters, g.n_iters],
        log_z=[float(c.log_z), float(g.log_z)],
        log_z_rel_err=abs(float(g.log_z) - float(c.log_z))
        / abs(float(c.log_z)),
        h_rel_err=abs(float(g.h_info) - float(c.h_info))
        / abs(float(c.h_info)))
    emit({"nested_card_vs_cpu": small_out})
    if not (c.n_iters == g.n_iters and max(
            small_out["log_z_rel_err"], small_out["h_rel_err"])
            <= NESTED_CPU_TOL):
        raise AssertionError(f"nested: the card and the CPU disagree: "
                             f"{small_out}")

    # (c) the matrix-free integrand on the irregular recipe (B1)
    mf = NESTED_MF
    x_np, y_np, _ = make_data(seed, dev, n=mf["n"])
    sess = gp.GP.bind(gp.GPSpec("k2", noise=gp.NoiseModel(SIGMA_N)),
                      x_np, y_np)
    before = _cuda.LAUNCHES["tile_matvec"]
    res = stage("matrix_free", lambda: sess.log_evidence(
        method="nested", key=rnd.key(3), n_live=mf["n_live"],
        n_chains=mf["n_chains"], n_steps=mf["n_steps"],
        max_iter=mf["max_iter"]))
    b1 = _cuda.LAUNCHES["tile_matvec"] - before
    mf_out = dict(n=mf["n"], backend=sess.backend,
                  operator=sess.operator_name, n_iters=res.n_iters,
                  n_evals=res.n_evals, log_z=float(res.log_z),
                  tile_matvec_launches=b1, s=stage.s["matrix_free"],
                  s_per_eval=stage.s["matrix_free"] / res.n_evals,
                  cg_stops=stage.cg_stops["matrix_free"])
    emit({"nested_matrix_free": mf_out})
    if not (b1 > 0 and nested_identity(
            res.n_evals, mf["n_live"], mf["n_chains"] * mf["n_steps"],
            res.n_iters) and res.n_iters == mf["max_iter"]
            and float(res.log_z) > -1e289):
        raise AssertionError(f"nested: the matrix-free integrand failed: "
                             f"{mf_out}")
    out.update(card_vs_cpu=small_out, matrix_free=mf_out,
               host_reads=_sync.COUNT["nested_iter"])
    return out


def card_vs_cpu(spec, x, y, theta, sigma_n, dev, backend="iterative"):
    """ln P_max and gradient at theta on the card and on the CPU path,
    with the same probes; returns (relative errors, operator name)."""
    out = []
    for device in (dev, torch.device("cpu")):
        s = gp.GP.bind(spec, x, y, device=device)
        solver = eng.make_solver(backend, s.cov,
                                 torch.tensor(theta, device=device), s.x, s.y,
                                 sigma_n, key=rnd.key(4), jitter=s.jitter,
                                 opts=spec.solver.opts, op=s.op)
        out.append((float(eng.profiled_loglik(solver)),
                    eng.profiled_grad(solver).cpu().numpy()))
    (lp_card, g_card), (lp_cpu, g_cpu) = out
    lp_rel = abs(lp_card - lp_cpu) / abs(lp_cpu)
    g_rel = float(np.max(np.abs(g_card - g_cpu)) / np.max(np.abs(g_cpu)))
    return lp_rel, g_rel, s.op.name


def bank_card_vs_cpu(x, y, opts, dev, kinds=("k1", "k2", "k1", "k2"),
                     thetas=None, sigma_n=TIDAL_SIGMA_N):
    """The bank objective's values and gradients on the card and on the
    CPU path with the same probes and its circulant preconditioner;
    returns (relative errors, "bank_" + structure).  By default k1 and k2
    at two points each on a tide record; ``thetas`` (B, m_max)."""
    if thetas is None:
        thetas = np.zeros((4, 5))
        for q in range(4):
            th = SKI_THETA[("k1", "k2")[q % 2]]
            thetas[q, :len(th)] = th
            thetas[q, 0] += 0.05 * (q // 2)
    out = []
    for device in (dev, torch.device("cpu")):
        xt = torch.tensor(x, device=device)
        bank = batch.BankOperator(kinds, xt, sigma_n, 1e-8)
        th = torch.tensor(thetas, device=device)
        obj = batch.make_bank_objective(
            bank, FlatBox(th - 1.0, th + 1.0), torch.tensor(y, device=device),
            rnd.key(4), opts._replace(precond="circulant"))
        lp, g = obj.value_and_grad_theta(th)
        out.append((lp.cpu().numpy(), g.cpu().numpy()))
    (lp_card, g_card), (lp_cpu, g_cpu) = out
    lp_rel = float(np.max(np.abs(lp_card - lp_cpu) / np.abs(lp_cpu)))
    g_rel = float(np.max(np.abs(g_card - g_cpu)) / np.max(np.abs(g_cpu)))
    return lp_rel, g_rel, "bank_" + bank.structure


# CG iterations of the product-SKI preconditioned small-input check: few
# enough that every solve stops there, before the stalled solves' rounding
# differences grow
PSKI_CUT_ITERS = 10


def product_ski_precond_checks(dev, opts):
    """The product-SKI preconditioned path (CG behind W (x_a Strang_a)^-1
    W^T, SLQ behind the masked circulant on the occupied cells), card
    against CPU on the small gappy field, in pieces that need no CG to
    converge:
      * its preconditioners on fixed vectors: the CG apply, and the SLQ
        preconditioner's apply, samples and log-det (relative error
        <= 1e-12, else the run fails);
      * ln P_max and its gradient behind both with every CG solve cut at
        PSKI_CUT_ITERS iterations (checked as the other small inputs);
      * the same with CG to cg_max_iter, where the solves stall (printed
        with how they ended, not checked), beside the multi-axis bank on
        the same input, whose CG preconditioner has the noise and whose
        solves converge (checked).
    Returns the checks for report_small_input_checks."""
    x, y, _ = make_field(2, (24, 16))
    theta = ND_THETA[ND_KIND]
    r_np = np.random.default_rng(8).standard_normal((len(x), 3))

    def spec(max_iter):
        return gp.GPSpec(ND_KIND,
                         noise=gp.NoiseModel(sigma_n=FIELD_SIGMA_N),
                         solver=gp.SolverPolicy(
                             backend="iterative",
                             opts=opts._replace(precond="circulant",
                                                cg_max_iter=max_iter)))

    got = []
    for device in (dev, torch.device("cpu")):
        s = gp.GP.bind(spec(opts.cg_max_iter), x, y, device=device)
        if s.op.name != "product_ski":
            raise AssertionError(f"the small field bound {s.op.name}, "
                                 "expected product_ski")
        th = torch.tensor(theta, device=device)
        r = torch.tensor(r_np, device=device)
        pre = s.op.slq_precond(th)
        got.append(dict(cg_apply=s.op.circulant_precond(th)(r),
                        slq_apply=pre.apply_inv(r),
                        slq_sample=pre.sample(rnd.key(6), 3),
                        slq_logdet=pre.logdet.reshape(1)))
    parts = {k: float(torch.max(torch.abs(got[0][k].cpu() - got[1][k]))
                      / torch.max(torch.abs(got[1][k]))) for k in got[1]}
    it.reset_cg_stops()
    stall = card_vs_cpu(spec(opts.cg_max_iter), x, y, theta, FIELD_SIGMA_N,
                        dev)
    emit({"product_ski_precond": dict(
        n=len(x), parts_rel_err=parts, stalled=dict(
            cg_max_iter=opts.cg_max_iter, log_p_max_rel_err=stall[0],
            grad_rel_err=stall[1], cg_stops=dict(it.CG_STOPS),
            worst_cut_residual=it.CG_WORST_RESIDUAL[0]))})
    bad = {k: v for k, v in parts.items() if not v <= 1e-12}
    if bad:
        raise AssertionError(f"the product-SKI preconditioners differ "
                             f"between card and CPU: {bad}")
    cut = card_vs_cpu(spec(PSKI_CUT_ITERS), x, y, theta, FIELD_SIGMA_N, dev)
    return [(len(x), "product_ski", cut),
            (len(x), "bank_product", bank_card_vs_cpu(
                x, y, opts, dev, kinds=(ND_KIND,),
                thetas=np.asarray([theta]), sigma_n=FIELD_SIGMA_N))]


def nd_small_input_checks(dev, opts):
    """The N-D operators on small inputs: a gappy field (product SKI,
    B10/B11), its full grid (Kronecker) and scattered (n, 2) points (the
    product tiles, B8/B9), card against CPU."""
    checks = []
    # product SKI with no CG preconditioner, as its session in the N-D
    # phase; behind its preconditioners in product_ski_precond_checks
    for want, (x, y, _), precond in (
            ("product_ski", make_field(2, (24, 16)), None),
            ("kron", make_field(2, (24, 16), drop=0.0), "circulant"),
            ("pallas", make_scattered_field(2, 300), "circulant")):
        spec = gp.GPSpec(ND_KIND,
                         noise=gp.NoiseModel(sigma_n=FIELD_SIGMA_N),
                         solver=gp.SolverPolicy(
                             backend="iterative",
                             opts=opts._replace(precond=precond)))
        checks.append((len(x), want, card_vs_cpu(
            spec, x, y, ND_THETA[ND_KIND], FIELD_SIGMA_N, dev)))
    return checks + product_ski_precond_checks(dev, opts)


def small_input_check(dev):
    """ln P_max and its gradient on the card against the CPU path: an
    irregular input (tiles), a gappy record (SKI, B5/B6, circulant
    preconditioner with the masked-circulant SLQ) and its un-dropped grid
    (Toeplitz)."""
    rng = np.random.default_rng(1)
    x = np.sort(rng.uniform(0.0, 600.0, 300))
    y = np.sin(2.0 * np.pi * x / 12.42) + SIGMA_N * rng.standard_normal(300)
    opts = eng.SolverOpts(n_probes=4, lanczos_k=24, cg_tol=1e-10,
                          cg_max_iter=2000)
    spec = gp.GPSpec("k2", noise=gp.NoiseModel(sigma_n=SIGMA_N),
                     solver=gp.SolverPolicy(backend="iterative", opts=opts))
    checks = [(300, "pallas", card_vs_cpu(spec, x, y, THETA["k2"], SIGMA_N,
                                          dev))]
    # a gappy record (n ~ 600) and its full grid
    xg, yg, _, n_full = make_tidal_data(2, months=2)
    tspec = gp.GPSpec("k2", noise=gp.NoiseModel(sigma_n=TIDAL_SIGMA_N),
                      solver=gp.SolverPolicy(
                          backend="iterative",
                          opts=opts._replace(precond="circulant")))
    checks.append((len(xg), "ski", card_vs_cpu(tspec, xg, yg,
                                               SKI_THETA["k2"],
                                               TIDAL_SIGMA_N, dev)))
    xf, yf, _, _ = make_tidal_data(2, months=2, drop=0.0)
    checks.append((n_full, "toeplitz", card_vs_cpu(
        tspec, xf, yf, SKI_THETA["k2"], TIDAL_SIGMA_N, dev)))
    checks += [(len(xg), "bank_near", bank_card_vs_cpu(xg, yg, opts, dev)),
               (n_full, "bank_exact", bank_card_vs_cpu(xf, yf, opts, dev))]
    checks += nd_small_input_checks(dev, opts)
    checks += stochastic_small_input_checks(dev)
    report_small_input_checks(checks)


def report_small_input_checks(checks):
    for n, want_op, (lp_rel, g_rel, got_op) in checks:
        emit({"small_input_check": dict(n=n, operator=got_op,
                                        log_p_max_rel_err=lp_rel,
                                        grad_rel_err=g_rel)})
        if got_op != want_op:
            raise AssertionError(f"small input bound {got_op}, expected "
                                 f"{want_op}")
        if not (lp_rel < 1e-8 and g_rel < 1e-8):
            raise AssertionError(f"the card and the CPU path disagree on a "
                                 f"small input ({got_op})")


# the phases of the full run after the kernel phase, by name
PHASES = {
    "irregular": lambda a, dev: workflow_phase(*make_data(a.seed, dev),
                                               a.seed, a.budget),
    "ski": lambda a, dev: ski_phase(a.seed),
    "nd": lambda a, dev: nd_phase(a.seed),
    "stochastic": lambda a, dev: stochastic_phase(a.seed),
    "distributed": lambda a, dev: distributed_phase(a.seed, dev),
    "sequential_vs_bank": lambda a, dev: sequential_vs_bank(a.seed),
    "small_input": lambda a, dev: small_input_check(dev),
    "dense": lambda a, dev: dense_phase(a.seed, dev),
    "nested": lambda a, dev: nested_phase(a.seed, dev),
}
# the worker processes that run those phases side by side on the one card,
# each its phases in turn.  Their CG loops are host-bound (PERF.md §5): run
# one after another they took 815-934 s of the script's 1200 on a fast host
# and ran past it on a slower one, so each worker takes a share of the
# host's cores; the kernel phase, which times kernels, runs alone before
# them.  Grouped by their one-after-another times (PERF.md §5); the nested
# phase's host loop (one iteration per removed live point) has its own.
WORKERS = (("ski",), ("nd",), ("sequential_vs_bank", "small_input"),
           ("irregular", "stochastic", "distributed", "dense"), ("nested",))


def run_worker(args, dev) -> int:
    """``--worker``: run the named phases in turn, each timed, and write
    their results and times as JSON to ``--out``."""
    cores = len(os.sched_getaffinity(0))
    torch.set_num_threads(max(1, cores // len(WORKERS)))
    _cuda.build()
    out = {"phase_s": {}}
    for name in args.worker.split(","):
        t0 = time.perf_counter()
        out[name] = PHASES[name](args, dev)
        torch.cuda.synchronize()
        out["phase_s"][name] = time.perf_counter() - t0
        emit({"phase_s": {name: out["phase_s"][name]}})
    pathlib.Path(args.out).write_text(json.dumps(out))
    return 0


def run_workers(args, tmp: pathlib.Path) -> dict:
    """Start one process per entry of WORKERS, wait for all of them (on
    the first failure, stop the others), then print each one's output in
    WORKERS' order and return the phases' results; raise if any failed."""
    procs = []
    # a SIGTERM (a time limit) still runs the finally below: no worker
    # outlives the script
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        for i, names in enumerate(WORKERS):
            files = [tmp / f"worker{i}.{ext}" for ext in ("out", "err",
                                                          "json")]
            cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
                   "--seed", str(args.seed), "--budget", args.budget,
                   "--worker", ",".join(names), "--out", str(files[2])]
            with open(files[0], "w") as fo, open(files[1], "w") as fe:
                procs.append((names, subprocess.Popen(
                    cmd, stdout=fo, stderr=fe, stdin=subprocess.DEVNULL),
                    files))
        while any(p.poll() is None for _, p, _ in procs):
            if any(p.poll() not in (None, 0) for _, p, _ in procs):
                break
            time.sleep(0.5)
    finally:
        for _, p, _ in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results, failed = {"phase_s": {}}, []
    for names, p, (out, err, res) in procs:
        sys.stdout.write(out.read_text())
        sys.stdout.flush()
        sys.stderr.write(err.read_text())
        if p.returncode != 0:
            failed.append((names, p.returncode))
        else:
            got = json.loads(res.read_text())
            results["phase_s"].update(got.pop("phase_s"))
            results.update(got)
    sys.stderr.flush()
    if failed:
        raise RuntimeError(f"worker phases failed (names, exit code): "
                           f"{failed}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget", choices=sorted(BUDGETS), default="committed",
                    help="NCG budget of the irregular phase")
    ap.add_argument("--json", default=None,
                    help="also write every result to this JSON file")
    ap.add_argument("--six-month", default=None,
                    metavar="SIGMA_N,STARTS,ITERS,SCAN[,MONTHS]",
                    help="run only the sequential-vs-bank check, at this "
                         "budget")
    ap.add_argument("--nd", action="store_true",
                    help="run only the kernel cases of B8-B11 and the N-D "
                         "phase")
    ap.add_argument("--stochastic", action="store_true",
                    help="run only the kernel cases of B12/B13 and the "
                         "stochastic shapes of B2 and B9, the stochastic "
                         "phase and its small-input checks")
    ap.add_argument("--distributed", action="store_true",
                    help="run only the kernel cases of B3 and the "
                         "distributed phase with its checks")
    ap.add_argument("--dense", action="store_true",
                    help="run only the dense phase (no kernel is built)")
    ap.add_argument("--nested", action="store_true",
                    help="build the kernels and run only the nested phase")
    ap.add_argument("--worker", default=None, metavar="PHASE[,PHASE...]",
                    help="(used by the full run) run only these phases of "
                         f"{sorted(PHASES)} and write their results to "
                         "--out")
    ap.add_argument("--out", default=None, help="the --worker's JSON file")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    if args.worker:
        return run_worker(args, dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    if args.dense:
        dense = dense_phase(args.seed, dev)
        if args.json:
            path = pathlib.Path(args.json)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(dict(device=smi, dense=dense),
                                       indent=1))
        emit({"script_s": time.perf_counter() - t_start})
        return 0

    build_s = _cuda.build()
    emit({"build_s": build_s, "sources": list(_cuda.SOURCES)})
    emit({"ptxas_value_sweep": value_ptxas(_cuda.KERNELS.ptxas_log)})
    emit({"ptxas_tangent_sweep": tangent_ptxas(_cuda.KERNELS.ptxas_log)})
    emit({"ptxas_product_tangent": product_tangent_ptxas(
        _cuda.KERNELS.ptxas_log)})
    emit({"ptxas_ski_lines": ski_lines_ptxas(_cuda.KERNELS.ptxas_log)})
    emit({"ptxas_ski_lines_1d": ski_lines_ptxas(_cuda.KERNELS.ptxas_log,
                                                SKI_LINES_1D)})
    if args.nested:
        ns = nested_phase(args.seed, dev)
        if args.json:
            path = pathlib.Path(args.json)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(dict(device=smi, nested=ns),
                                       indent=1))
        emit({"script_s": time.perf_counter() - t_start})
        return 0
    if args.six_month:
        sig, starts, iters, scan, *months = args.six_month.split(",")
        sequential_vs_bank(args.seed, float(sig), int(starts), int(iters),
                           int(scan), *(int(m) for m in months))
        return 0
    if args.stochastic:
        cases = {name: [] for name in SOURCES}
        rng = np.random.default_rng(args.seed + 2)
        rows_kernel_cases(cases, dev, rng, args.seed)
        b2_stochastic_case(cases, dev, rng, args.seed)
        b9_stochastic_case(cases, dev, rng, args.seed)
        check_cases(cases, ROWS_KERNELS + ("tile_tangent",
                                           "tile_tangent_nd"))
        st = stochastic_phase(args.seed)
        report_small_input_checks(stochastic_small_input_checks(dev))
        if args.json:
            path = pathlib.Path(args.json)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(dict(device=smi, cases=cases,
                                            stochastic=st), indent=1))
        emit({"script_s": time.perf_counter() - t_start})
        return 0
    if args.distributed:
        cases = {name: [] for name in SOURCES}
        x_np, _, _ = make_data(args.seed, dev)
        rng = np.random.default_rng(args.seed + 1)
        # B2's k2 case first: B3's headline case stands beside it
        theta = torch.tensor(THETA["k2"], dtype=torch.float64)
        p = ops.natural_params("k2", theta).to(dev)
        pd = ops.natural_tangents("k2", theta).to(dev)
        x = torch.tensor(x_np, device=dev)
        v = torch.tensor(rng.standard_normal((N, 9)), device=dev)
        cases["tile_tangent"].append(dict(
            kind="k2", m=pd.shape[0], b=9,
            ms=time_ms(lambda: km.tile_stacked_tangent_matvec(
                "k2", p, pd, x, x, v), 10)))
        jvp_kernel_cases(cases, x, dev, rng)
        check_cases(cases, ("tile_jvp",))
        dist_out = distributed_phase(args.seed, dev)
        if args.json:
            path = pathlib.Path(args.json)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(dict(device=smi, cases=cases,
                                            distributed=dist_out), indent=1))
        emit({"script_s": time.perf_counter() - t_start})
        return 0
    if args.nd:
        cases = {name: [] for name in SOURCES}
        nd_kernel_cases(cases, dev, np.random.default_rng(args.seed + 1),
                        args.seed)
        check_cases(cases, ND_KERNELS[:4])
        nd = nd_phase(args.seed)
        for n, want_op, (lp_rel, g_rel, got_op) in nd_small_input_checks(
                dev, eng.SolverOpts(n_probes=4, lanczos_k=24, cg_tol=1e-10,
                                    cg_max_iter=2000)):
            emit({"small_input_check": dict(n=n, operator=got_op,
                                            log_p_max_rel_err=lp_rel,
                                            grad_rel_err=g_rel)})
        if args.json:
            path = pathlib.Path(args.json)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(dict(device=smi, cases=cases, nd=nd),
                                       indent=1))
        return 0

    x_np, y_np, xstar_np = make_data(args.seed, dev)
    x = torch.tensor(x_np, device=dev)
    xstar = torch.tensor(xstar_np, device=dev)
    rng = np.random.default_rng(args.seed + 1)
    t0 = time.perf_counter()
    cases, crossover = kernel_phase(x, xstar, dev, rng, args.seed)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    emit({"phase_s": {"kernel": kernel_s}})
    del x, xstar
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = run_workers(args, pathlib.Path(tmp))
    phase_s = dict(kernel=kernel_s, **res["phase_s"],
                   workers=time.perf_counter() - t0)
    summary, ski, nd, st, dist_out, seq_vs_bank, dense, ns = (
        res[k] for k in ("irregular", "ski", "nd", "stochastic",
                         "distributed", "sequential_vs_bank", "dense",
                         "nested"))

    launches = {**{k: summary["launches"].get(k, 0) for k in TILE_KERNELS},
                **{k: ski["launches"].get(k, 0) for k in SKI_KERNELS},
                **{k: nd["launches"][k] for k in ND_KERNELS[:4]},
                **{k: st["launches"][k] for k in ROWS_KERNELS},
                "tile_jvp": dist_out["tile"]["launches"]["tile_jvp"]}
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        h = headline(name, cases[name])
        f64 = [r for r in cases[name] if r.get("dtype", "float64")
               == "float64"]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in f64),
            max_rel_err=max(r["max_rel_err"] for r in f64),
            ms=h["ms"], plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
            bound_by=h["bound_by"], library_ms=None,
            shape={k: v for k, v in h.items()
                   if k in ("kind", "n", "n1", "n2", "m_grid", "L", "b",
                            "m", "B", "c", "k", "dtype")}))
    emit({"phase_s": phase_s})
    emit({"kernels": kernels})
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(dict(
            device=smi, build_s=build_s, cases=cases, crossover=crossover,
            workflow=summary, ski_workflow=ski, nd=nd, stochastic=st,
            distributed=dist_out, phase_s=phase_s,
            sequential_vs_bank=seq_vs_bank, dense=dense, nested=ns,
            kernels=kernels,
            ptxas=_cuda.KERNELS.ptxas_log), indent=1))
    emit({"script_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
