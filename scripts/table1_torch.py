"""Paper Table 1 on the PyTorch/CUDA port (the twin of
``benchmarks/table1_synthetic.py``): synthetic k2 data analysed with k1
and k2.

    python3 scripts/table1_torch.py [--device cpu] [--ns 30,100,300]
                                    [--json PATH]

For n in {30, 100, 300}, through the session API: the peak of the
profiled hyperlikelihood (``GP.bind(...).fit``, multi-start NCG), the
multimodal Laplace hyperevidence ln Z_est (eq. 2.13 + eq. 2.19, summed
over the restart peaks: nested sampling counts every alias mode), the
nested-sampling ln Z_num (``log_evidence(method="nested")``, the budget of
``NS_BUDGET``), and ln B = ln Z^{k2} - ln Z^{k1} both ways, with the
likelihood evaluations (the paper's runtime metric) and the wall time of
each (host clock; float() of the results waits for the device).

Everything runs on the card unless ``--device cpu``.  The port draws its
data and its nested sampler's steps with torch (``repro_torch.random``),
so the numbers differ from the JAX script's draws.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

from repro_torch import gp  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.data.synthetic import synthetic  # noqa: E402

# nested-sampling budget per n, (n_live, n_steps, max_iter), as the JAX
# script's: fewer live points at n = 300
NS_BUDGET = {30: (400, 16, 20000), 100: (400, 16, 20000),
             300: (150, 12, 9000)}


def run(ns=(30, 100, 300), n_starts=12, max_iters=100, scan_points=2048,
        n_live=400, seed=42, budget=NS_BUDGET, device=None, verbose=True):
    rows = []
    for n in ns:
        ds = synthetic(rnd.key(seed), n, "k2", device=device)
        rec = {"n": n}
        for name, s in (("k1", 1), ("k2", 2)):
            spec = gp.GPSpec(name, noise=gp.NoiseModel(ds.sigma_n),
                             solver=gp.SolverPolicy(
                                 backend="dense", n_starts=n_starts,
                                 max_iters=max_iters,
                                 scan_points=scan_points))
            sess = gp.GP.bind(spec, ds.x, ds.y, device=ds.x.device)
            t0 = time.perf_counter()
            fitted = sess.fit(rnd.key(s))
            mm = fitted.log_evidence(multimodal=True)
            lnz_est = float(mm.log_z)
            t_est = time.perf_counter() - t0
            nl, nstep, mx = budget.get(n, (n_live, 16, 20000))
            t0 = time.perf_counter()
            nres = sess.log_evidence(method="nested", key=rnd.key(s + 10),
                                     n_live=nl, n_steps=nstep, max_iter=mx)
            lnz_num = float(nres.log_z)
            t_num = time.perf_counter() - t0
            rec[name] = {
                "lnZ_est": lnz_est,
                "n_modes": int(mm.n_modes),
                "lnZ_num": lnz_num,
                "lnZ_num_err": float(nres.log_z_err),
                "H": float(nres.h_info),
                "n_live": nl, "n_steps": nstep,
                "n_iters": nres.n_iters,
                "evals_est": int(fitted.result.n_evals) + int(mm.n_modes),
                "evals_num": nres.n_evals,
                "t_est_s": t_est, "t_num_s": t_num,
                "theta_hat": fitted.result.theta_hat.tolist(),
                "lnPmax": float(fitted.result.log_p_max),
            }
        rec["lnB_est"] = rec["k2"]["lnZ_est"] - rec["k1"]["lnZ_est"]
        rec["lnB_num"] = rec["k2"]["lnZ_num"] - rec["k1"]["lnZ_num"]
        rec["lnB_num_err"] = float(np.hypot(rec["k1"]["lnZ_num_err"],
                                            rec["k2"]["lnZ_num_err"]))
        rows.append(rec)
        if verbose:
            print(f"n={n:4d}  lnZ_est(k1)={rec['k1']['lnZ_est']:8.2f}  "
                  f"lnZ_num(k1)={rec['k1']['lnZ_num']:8.2f}+-"
                  f"{rec['k1']['lnZ_num_err']:.2f}  "
                  f"lnZ_est(k2)={rec['k2']['lnZ_est']:8.2f}  "
                  f"lnZ_num(k2)={rec['k2']['lnZ_num']:8.2f}+-"
                  f"{rec['k2']['lnZ_num_err']:.2f}  "
                  f"lnB_est={rec['lnB_est']:7.2f}  "
                  f"lnB_num={rec['lnB_num']:7.2f}+-{rec['lnB_num_err']:.2f}",
                  flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--ns", default="30,100,300",
                    help="comma-separated record lengths")
    ap.add_argument("--json", default=None,
                    help="also write every row to this JSON file")
    args = ap.parse_args(argv)
    rows = run(ns=tuple(int(n) for n in args.ns.split(",")),
               device=args.device)
    print("name,us_per_call,derived")
    for r in rows:
        for k in ("k1", "k2"):
            evs = r[k]["evals_est"]
            us = r[k]["t_est_s"] / max(evs, 1) * 1e6
            print(f"table1_{k}_n{r['n']},{us:.1f},"
                  f"lnZ_est={r[k]['lnZ_est']:.2f};"
                  f"lnZ_num={r[k]['lnZ_num']:.2f}"
                  f"+-{r[k]['lnZ_num_err']:.2f};"
                  f"speedup_evals={r[k]['evals_num'] / evs:.1f}x;"
                  f"speedup_wall={r[k]['t_num_s'] / r[k]['t_est_s']:.2f}x")
    print(json.dumps({"table1": rows}))
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
