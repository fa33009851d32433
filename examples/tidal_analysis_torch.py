"""Paper Sec. 3(b) on the PyTorch/CUDA port: tidal model comparison on
Woods-Hole-like data (the twin of examples/tidal_analysis.py).

Recovers the semidiurnal (~12.4 h) and diurnal (~24 h) tidal constituents
with inverse-Hessian error bars, and the k2-vs-k1 Bayes factor, on the
dense backend (one Cholesky per likelihood evaluation).  ``--csv`` reads a
real NOAA export instead; ``--gappy FRAC`` drops that fraction of the
samples first (tide-gauge outages, the paper's footnote 7): the record is
then a near grid, and the iterative engine's SKI operator and circulant
preconditioner show a posterior on it before the dense analysis.

    python examples/tidal_analysis_torch.py [--csv file.csv] [--months 1]
                                            [--gappy 0.1] [--device cpu]

``analyse`` is this file's own (benchmarks/tidal.py imports JAX): the
budget of that benchmark, 12 restarts x 100 NCG steps x 2048 scan points,
single-mode Laplace evidence.  Everything runs on the card unless
``--device cpu``; the port's random draws are torch's, so the numbers
differ from the JAX example's.
"""

import argparse
import math
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

from repro_torch import gp  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.core.engine import SolverOpts  # noqa: E402
from repro_torch.data.grid import classify_grid  # noqa: E402
from repro_torch.data.tidal import (drop_random_hours,  # noqa: E402
                                    load_noaa_csv, woods_hole_like)
from repro_torch.kernels.operators import select_operator  # noqa: E402

_OP_COST = {"toeplitz": "O(n log n) FFT matvec",
            "ski": "O(n + m log m) SKI gather-FFT-scatter",
            "pallas": "O(n^2) tiles"}


def analyse(ds, n_starts=12, scan_points=2048, max_iters=100, device=None,
            verbose=True):
    """k1 and k2 on the dense backend, each fitted under its own key
    (1, 2) and its single-mode Laplace evidence: timescales with error
    bars (dT = T dphi) and ln B (k2 vs k1)."""
    out = {}
    for name, s in (("k1", 1), ("k2", 2)):
        spec = gp.GPSpec(kernel=name,
                         noise=gp.NoiseModel(sigma_n=ds.sigma_n),
                         solver=gp.SolverPolicy(backend="dense",
                                                n_starts=n_starts,
                                                max_iters=max_iters,
                                                scan_points=scan_points,
                                                multimodal=False))
        t0 = time.time()
        sess = gp.GP.bind(spec, ds.x, ds.y, device=device).fit(rnd.key(s))
        tr = sess.result
        lap = sess.log_evidence()
        t_train = time.time() - t0
        th = tr.theta_hat.cpu().numpy()
        err = lap.errors.cpu().numpy()
        rec = {"lnZ": float(lap.log_z), "t_train_s": t_train,
               "evals": int(tr.n_evals) + 1, "lnPmax": float(tr.log_p_max)}
        if name == "k1":
            rec["T1_h"] = float(np.exp(th[1]))
            rec["T1_err"] = rec["T1_h"] * float(err[1])
        else:
            t_a, t_b = float(np.exp(th[1])), float(np.exp(th[3]))
            (rec["T1_h"], rec["T1_err"]), (rec["T2_h"], rec["T2_err"]) = \
                sorted([(t_a, t_a * float(err[1])), (t_b, t_b * float(err[3]))])
        out[name] = rec
        if verbose:
            ts = {k: v for k, v in rec.items() if k.startswith("T")}
            print(f"  {name}: lnZ={rec['lnZ']:.1f} evals={rec['evals']} "
                  f"t={t_train:.0f}s {ts}", flush=True)
    out["lnB"] = out["k2"]["lnZ"] - out["k1"]["lnZ"]
    if verbose:
        print(f"  ln B (k2 vs k1) = {out['lnB']:.1f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csv", default="")
    ap.add_argument("--months", type=int, default=1)
    ap.add_argument("--gappy", type=float, default=0.0, metavar="FRAC",
                    help="randomly drop this fraction of the samples "
                         "(demonstrates the SKI near-grid path)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.csv:
        ds = load_noaa_csv(args.csv, device=args.device)
        print(f"loaded {ds.x.shape[0]} samples from {args.csv}")
    else:
        ds = woods_hole_like(rnd.key(0), months=args.months,
                             device=args.device)
        print(f"synthetic Woods-Hole-like series: n={ds.x.shape[0]} "
              f"({args.months} lunar month(s), 2 h cadence)")
    if args.gappy > 0.0:
        n_full = ds.x.shape[0]
        ds = drop_random_hours(ds, args.gappy, rnd.key(11))
        print(f"dropped {n_full - ds.x.shape[0]} of {n_full} samples "
              f"at random (outage fraction {args.gappy:g})")
    info = classify_grid(ds.x)
    op = select_operator("k2", ds.x, ds.sigma_n)
    desc = {"exact": f"regular grid, h={info.h:.3g} h",
            "near": f"NEAR-grid (underlying h={info.h:.3g} h)",
            "irregular": "irregular sampling"}[info.kind]
    print(f"structure probe: {desc} -> the iterative engine would bind the "
          f"{op.name!r} operator ({_OP_COST[op.name]})")
    if op.name == "ski":
        print(f"  inducing grid: m={op.m_grid} nodes; circulant "
              f"preconditioner available (SolverOpts(precond='circulant'))")
        # the SKI pipeline through the front door: CG behind the circulant
        # preconditioner, the test points interpolated onto the same grid
        sess = gp.GP.bind(
            gp.GPSpec(kernel="k1", noise=gp.NoiseModel(sigma_n=ds.sigma_n),
                      solver=gp.SolverPolicy(
                          backend="iterative",
                          opts=SolverOpts(precond="circulant"))),
            ds.x, ds.y, device=ds.x.device)
        theta0 = [5.0, math.log(12.4), 0.05]
        xs = torch.linspace(float(ds.x[0]), float(ds.x[-1]), 96,
                            dtype=torch.float64)
        post = sess.predict(xs, theta=theta0)
        print(f"  SKI posterior mean over {xs.shape[0]} test points "
              f"(cross-covariance via W*, no (n, n*) block): "
              f"range [{float(post.mean.min()):+.3f}, "
              f"{float(post.mean.max()):+.3f}], "
              f"sigma_f_hat={float(post.sigma_f_hat):.3f}")
    out = analyse(ds, device=ds.x.device)
    print(f"\nk1: T1 = {out['k1']['T1_h']:.2f} +- "
          f"{out['k1']['T1_err']:.2f} h (paper: 12.8 +- 0.2 h)")
    print(f"k2: T1 = {out['k2']['T1_h']:.2f} h, "
          f"T2 = {out['k2']['T2_h']:.2f} h (paper: 12.44, 24.3 h)")
    print(f"ln B = {out['lnB']:.1f} (paper small set: 57.8)")


if __name__ == "__main__":
    main()
