"""Drive the PyTorch/CUDA port on one card and check it.

    python3 chip_smoke.py [--seed S] [--budget committed|planned] [--json PATH]

Run from the root of a checkout on a machine with an NVIDIA GPU.  It builds
the CUDA kernels from ``src/repro_torch/csrc`` and then:

  1. kernel phase: each kernel of the path (B1 tile_matvec, B2
     tile_tangent, B4 tile_matrix) at the shapes the workflow gives it,
     held against its plain PyTorch version on the same inputs in float64,
     and timed (CUDA events, median of repeats) beside the plain version
     and the least time the card could take (the roofline bound below);
  2. workflow phase: the paper's workflow through the front door on one
     year of hourly-scale irregular sampling (n = 8760): GP.bind -> fit ->
     log_evidence -> compare (ln B of k2 vs k1) -> predict at n* = 512 with
     variance, with every kernel's launch count read around it, and for
     each stage how its CG solves ended (tolerance or cg_max_iter) and
     the eigenvalues of every Laplace Hessian it formed;
  3. a small-input check: ln P_max and its gradient on the card against
     the port's CPU path (plain PyTorch) with the same probes.

Every phase fails loudly: a build failure, a launch error, a mismatch or a
non-finite result exits nonzero.  The last line of standard output is the
JSON object {"ok": true, "device": {...}}.

Roofline bound per call: the larger of bytes / 3.35 TB/s (each input read
once, each output written once) and the operations over the fp64 peaks of
an H100 SXM (NVIDIA data sheet): the covariance evaluation at 34 TFLOP/s
(outside the tensor cores), the contraction with V at 67 TFLOP/s (fp64
tensor cores).  Each arithmetic operation, comparison and each sin, cos,
exp or division counts as one operation (a lower count than the hardware
spends, so the bound stays a lower bound).  Per covariance entry: B1 and
B4 count the value (EVAL_OPS), B1 adds 2 b multiply-adds with V; B2
counts the value and its closed-form gradient over the kind's natural
slots (GRAD_OPS) and 2 NS b for contracting the NS gradient tiles with V,
since the m directions can be applied afterwards to the (NS, n1, b)
result at a cost independent of n2.

``--budget planned`` runs the workflow phase with the budget first planned
for it (the data-dependent box, max_iters=5, no scan) instead of the
committed one; on this data it is expected to end with a nan evidence,
and the phase's line shows why (Hessian eigenvalues, CG stops).
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch import _sync  # noqa: E402
from repro_torch import gp  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import iterative as it  # noqa: E402
from repro_torch.core import laplace  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import kernel_matvec as km  # noqa: E402
from repro_torch.kernels import kernel_tile as kt  # noqa: E402
from repro_torch.core.reparam import FlatBox  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import matrix_ref  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
FP64_PEAK = 34e12          # fp64 outside the tensor cores
FP64_TC_PEAK = 67e12       # fp64 on the tensor cores

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
# NCG budgets of the workflow phase, 2 restarts each.  committed: 25 steps
# from the best of a 64-point scan inside the tidal-band boxes; with 16
# scan points, starts of the compare stage landed outside the comb peaks at
# n = 8760 and never reached a positive definite Hessian.  planned: 5
# steps from uniform starts in the data-dependent box.
BUDGETS = {"committed": dict(max_iters=25, scan_points=64, tidal_boxes=True),
           "planned": dict(max_iters=5, scan_points=None, tidal_boxes=False)}
TOL = {"tile_matvec": 1e-12, "tile_tangent": 1e-11, "tile_matrix": 1e-12}
SOURCES = {
    "tile_matvec": ("src/repro_torch/csrc/tile_matvec.cu",
                    "src/repro/kernels/kernel_matvec.py:270"),
    "tile_tangent": ("src/repro_torch/csrc/tile_tangent.cu",
                     "src/repro/kernels/kernel_matvec.py:209"),
    "tile_matrix": ("src/repro_torch/csrc/tile_matrix.cu",
                    "src/repro/kernels/kernel_tile.py:29"),
}
# the k2 point the data is drawn from (flat coordinates, hours)
TRUTH = [math.log(200.0), math.log(12.42), -0.19, math.log(24.0), -0.1]
# points the kernel phase runs at
THETA = {"k1": TRUTH[:3], "k2": TRUTH}


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


def bound(n_bytes: float, eval_ops: float, mma_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = eval_ops / FP64_PEAK + mma_flops / FP64_TC_PEAK
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def make_data(seed: int, dev):
    """Sorted uniform sampling times over 8760 h (irregular: classify_grid
    says so) and one draw of a quasi-periodic GP: k2 with a 200 h window,
    periods 12.42 h and 24 h, unit scale and sigma_n noise.  The draw is
    L z with L the Cholesky factor of the dense covariance on the card and
    z from numpy's generator."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 8760.0, N))
    xstar = np.sort(rng.uniform(0.0, 8760.0, N_STAR))
    z = rng.standard_normal(N)
    p = ops.natural_params("k2", torch.tensor(TRUTH, dtype=torch.float64))
    xt = torch.tensor(x, device=dev)
    K = matrix_ref("k2", p.to(dev), xt, xt)
    K.diagonal().add_(SIGMA_N ** 2)
    y = torch.linalg.cholesky(K) @ torch.tensor(z, device=dev)
    return x, y.cpu().numpy(), xstar


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


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def kernel_phase(x, xstar, dev, rng):
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
            got = km.tile_matvec(kind, p, x1, x, v)
            want = km.tile_matvec_plain(kind, p, x1, x, v)
            torch.cuda.synchronize()
            err, rel = errors(got, want)
            entries = n1 * N
            bms, by = bound(8.0 * (n1 + N + N * b + n1 * b + 8),
                            entries * EVAL_OPS[kind], 2.0 * entries * b)
            cases["tile_matvec"].append(dict(
                kind=kind, n1=n1, n2=N, b=b, max_abs_err=err,
                max_rel_err=rel,
                ms=time_ms(lambda: km.tile_matvec(kind, p, x1, x, v), 10),
                plain_ms=time_ms(
                    lambda: km.tile_matvec_plain(kind, p, x1, x, v), 3),
                bound_ms=bms, bound_by=by))
        # B2: all m tangents of [alpha | 8 probes], m = 3 (k1) or 5 (k2)
        m = pd.shape[0]
        v = torch.tensor(rng.standard_normal((N, 9)), device=dev)
        got = km.tile_stacked_tangent_matvec(kind, p, pd, x, x, v)
        want = km.tile_stacked_tangent_matvec_plain(kind, p, pd, x, x, v)
        torch.cuda.synchronize()
        err, rel = errors(got, want)
        entries = N * N
        bms, by = bound(8.0 * (2 * N + N * 9 + m * N * 9 + 8 + 8 * m),
                        entries * GRAD_OPS[kind],
                        2.0 * entries * N_SLOTS[kind] * 9)
        cases["tile_tangent"].append(dict(
            kind=kind, n1=N, n2=N, b=9, m=m, max_abs_err=err,
            max_rel_err=rel,
            ms=time_ms(lambda: km.tile_stacked_tangent_matvec(
                kind, p, pd, x, x, v), 10),
            plain_ms=time_ms(lambda: km.tile_stacked_tangent_matvec_plain(
                kind, p, pd, x, x, v), 3),
            bound_ms=bms, bound_by=by))
        # B4: the predict cross block K(x, x*), (8760, 512)
        got = kt.tile_matrix(kind, p, x, xstar)
        want = kt.tile_matrix_plain(kind, p, x, xstar)
        torch.cuda.synchronize()
        err, rel = errors(got, want)
        entries = N * N_STAR
        bms, by = bound(8.0 * (N + N_STAR + entries + 8),
                        entries * EVAL_OPS[kind], 0.0)
        cases["tile_matrix"].append(dict(
            kind=kind, n1=N, n2=N_STAR, max_abs_err=err, max_rel_err=rel,
            ms=time_ms(lambda: kt.tile_matrix(kind, p, x, xstar), 10),
            plain_ms=time_ms(lambda: kt.tile_matrix_plain(kind, p, x, xstar),
                             3),
            bound_ms=bms, bound_by=by))
    for name, rows in cases.items():
        for row in rows:
            emit({"kernel_case": name, **row})
            if not row["max_rel_err"] <= TOL[name]:
                raise AssertionError(
                    f"{name} disagrees with its plain version: {row}")
    return cases


# the case that stands for each kernel in the summary line: the shape the
# workflow launches most (k2, training CG / gradient, predict cross block)
HEADLINE = {"tile_matvec": dict(kind="k2", n1=N, b=9),
            "tile_tangent": dict(kind="k2"),
            "tile_matrix": dict(kind="k2")}


def headline(name, rows):
    want = HEADLINE[name]
    return next(r for r in rows if all(r[k] == v for k, v in want.items()))


# ---------------------------------------------------------------------------
# workflow phase
# ---------------------------------------------------------------------------

def workflow_phase(x_np, y_np, xstar_np, seed, budget):
    opts = eng.SolverOpts(n_probes=8, lanczos_k=48, cg_tol=1e-6,
                          cg_max_iter=400)
    plan = BUDGETS[budget]
    policy = gp.SolverPolicy(backend="auto", n_starts=2,
                             max_iters=plan["max_iters"],
                             scan_points=plan["scan_points"], opts=opts)
    specs = gp.spec_bank(["k1", "k2"], noise=gp.NoiseModel(sigma_n=SIGMA_N),
                         solver=policy)
    if plan["tidal_boxes"]:
        boxes = tidal_boxes()
        specs = [s.with_box(boxes[s.name]) for s in specs]
    key = rnd.key(seed)
    kfit, kev, kcmp = rnd.split(key, 3)
    stages, cg_stops, hessians = {}, {}, {}

    def stage(name, fn):
        """Time one stage; keep how its CG solves ended and the
        eigenvalues of each Laplace Hessian it formed."""
        it.reset_cg_stops()
        laplace.HESSIAN_EIGENVALUES.clear()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        cg_stops[name] = dict(
            tol=it.CG_STOPS["tol"], max_iter=it.CG_STOPS["max_iter"],
            worst_residual_at_max_iter=it.CG_WORST_RESIDUAL[0])
        hessians[name] = [lam.tolist()
                          for lam in laplace.HESSIAN_EIGENVALUES]
        emit({"stage": name, "s": stages[name], "cg_stops": cg_stops[name],
              "hessian_eigenvalues": hessians[name]})
        return out

    _cuda.reset_launches()
    _sync.reset()
    session = stage("bind", lambda: gp.GP.bind(specs[1], x_np, y_np))
    if (session.backend, session.operator_name) != ("iterative", "pallas"):
        raise AssertionError(f"bound {session!r}, expected the iterative "
                             "backend on the tile operator")
    fitted = stage("fit", lambda: session.fit(kfit))
    evidence = stage("log_evidence", lambda: fitted.log_evidence(key=kev))
    reports = stage("compare", lambda: gp.compare(specs, x_np, y_np,
                                                  key=kcmp))
    post = stage("predict", lambda: fitted.predict(xstar_np))
    launches = dict(_cuda.LAUNCHES)
    syncs = dict(_sync.COUNT)

    lnb = float(gp.log_bayes_factors(reports)[1, 0])
    res = fitted.result
    sf2 = float(res.sigma_f_hat) ** 2
    var = post.var
    summary = dict(
        n=N, n_star=N_STAR, seed=seed, budget=budget, stage_s=stages,
        log_p_max=float(res.log_p_max), theta_hat=res.theta_hat.tolist(),
        log_p_all=res.log_p_all.tolist(), n_evals=res.n_evals,
        log_z=float(evidence.log_z), n_modes=evidence.n_modes,
        compare={r.name: dict(log_z=r.log_z_laplace, log_p_max=r.log_p_max,
                              n_modes=r.n_modes, n_evals=r.n_evals_train)
                 for r in reports},
        ln_b_k2_vs_k1=lnb, host_syncs=sum(syncs.values()),
        host_syncs_by_loop=syncs, launches=launches,
        var_min=float(var.min()), var_max=float(var.max()),
        sigma_f_hat_sq=sf2, cg_stops=cg_stops,
        hessian_eigenvalues=hessians)
    emit({"workflow": summary})

    for name in SOURCES:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"workflow: {launches}")
    for label, val in (("ln P_max", res.log_p_max), ("ln Z", evidence.log_z),
                       ("ln B", lnb)):
        if not math.isfinite(float(val)):
            raise AssertionError(f"{label} is not finite: {val}")
    if post.mean.shape != (N_STAR,) or var.shape != (N_STAR,):
        raise AssertionError("posterior has the wrong shape")
    if not bool(torch.isfinite(post.mean).all()):
        raise AssertionError("posterior mean is not finite")
    if not (float(var.min()) >= 0.0
            and float(var.max()) <= sf2 * (1.0 + SIGMA_N ** 2)):
        raise AssertionError(f"variance outside [0, sigma_f^2 (1 + "
                             f"sigma_n^2)]: {summary}")
    return summary


def small_input_check(dev):
    """ln P_max and its gradient on the card against the CPU path."""
    rng = np.random.default_rng(1)
    x = np.sort(rng.uniform(0.0, 600.0, 300))
    y = np.sin(2.0 * np.pi * x / 12.42) + SIGMA_N * rng.standard_normal(300)
    opts = eng.SolverOpts(n_probes=4, lanczos_k=24, cg_tol=1e-10,
                          cg_max_iter=2000)
    spec = gp.GPSpec("k2", noise=gp.NoiseModel(sigma_n=SIGMA_N),
                     solver=gp.SolverPolicy(backend="iterative", opts=opts))
    theta = np.asarray(THETA["k2"])
    out = {}
    for device in (dev, torch.device("cpu")):
        s = gp.GP.bind(spec, x, y, device=device)
        solver = eng.make_solver("iterative", s.cov,
                                 torch.tensor(theta, device=device), s.x, s.y,
                                 SIGMA_N, key=rnd.key(4), jitter=s.jitter,
                                 opts=opts, op=s.op)
        out[device.type] = (float(eng.profiled_loglik(solver)),
                            eng.profiled_grad(solver).cpu().numpy())
    lp_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    g_rel = float(np.max(np.abs(out["cuda"][1] - out["cpu"][1]))
                  / np.max(np.abs(out["cpu"][1])))
    emit({"small_input_check": dict(n=300, log_p_max_rel_err=lp_rel,
                                    grad_rel_err=g_rel)})
    if not (lp_rel < 1e-8 and g_rel < 1e-8):
        raise AssertionError("the card and the CPU path disagree on a "
                             "small input")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget", choices=sorted(BUDGETS), default="committed",
                    help="NCG budget of the workflow phase")
    ap.add_argument("--json", default=None,
                    help="also write every result to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)

    build_s = _cuda.build()
    emit({"build_s": build_s, "sources": list(_cuda.SOURCES)})

    x_np, y_np, xstar_np = make_data(args.seed, dev)
    x = torch.tensor(x_np, device=dev)
    xstar = torch.tensor(xstar_np, device=dev)
    rng = np.random.default_rng(args.seed + 1)
    cases = kernel_phase(x, xstar, dev, rng)
    summary = workflow_phase(x_np, y_np, xstar_np, args.seed, args.budget)
    small_input_check(dev)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        h = headline(name, cases[name])
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=summary["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in cases[name]),
            max_rel_err=max(r["max_rel_err"] for r in cases[name]),
            ms=h["ms"], plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
            bound_by=h["bound_by"], library_ms=None,
            shape={k: v for k, v in h.items()
                   if k in ("kind", "n1", "n2", "b", "m")}))
    emit({"kernels": kernels})
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(dict(
            device=smi, build_s=build_s, cases=cases, workflow=summary,
            kernels=kernels, ptxas=_cuda.KERNELS.ptxas_log), indent=1))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
