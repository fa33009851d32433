"""The paper's headline claim on the PyTorch/CUDA port (the twin of
``benchmarks/speedup.py``): the speed-up of Laplace model comparison over
numerically integrated evidences (Sec. 3a reports 20-50x in likelihood
evaluations after accounting for ~10 duplicate maximisation runs).

    python3 scripts/speedup_torch.py [--device cpu] [--json PATH]

At n = 100 synthetic points, for k1 and k2, through the session API:

  * likelihood evaluations: multi-start NCG (``fit``) + 1 Hessian
    evaluation (``log_evidence()`` at the peak) against the nested
    sampler's (``log_evidence(method="nested")``, 400 live points);
  * wall time of each on the device it runs on (host clock; float() of
    the results waits for the device).  The nested sampler advances its
    8 chains in lock-step, one batched evaluation per step, where
    MULTINEST was serial: the evaluation counts are the like-for-like
    number.

Everything runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

from repro_torch import gp  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.data.synthetic import synthetic  # noqa: E402


def run(n=100, seed=42, n_starts=12, max_iters=100, scan_points=2048,
        n_live=400, max_iter=30000, device=None, verbose=True):
    ds = synthetic(rnd.key(seed), n, "k2", device=device)
    rows = []
    for name, s in (("k1", 1), ("k2", 2)):
        spec = gp.GPSpec(name, noise=gp.NoiseModel(ds.sigma_n),
                         solver=gp.SolverPolicy(backend="dense",
                                                n_starts=n_starts,
                                                max_iters=max_iters,
                                                scan_points=scan_points))
        sess = gp.GP.bind(spec, ds.x, ds.y, device=ds.x.device)
        t0 = time.perf_counter()
        fitted = sess.fit(rnd.key(s))
        lnz_est = float(fitted.log_evidence(multimodal=False).log_z)
        t_est = time.perf_counter() - t0
        t0 = time.perf_counter()
        nres = sess.log_evidence(method="nested", key=rnd.key(s + 10),
                                 n_live=n_live, max_iter=max_iter)
        lnz_num = float(nres.log_z)
        t_num = time.perf_counter() - t0
        evals_est = int(fitted.result.n_evals) + 1
        evals_num = nres.n_evals
        rows.append({
            "cov": name, "lnZ_est": lnz_est, "lnZ_num": lnz_num,
            "lnZ_num_err": float(nres.log_z_err), "n_iters": nres.n_iters,
            "evals_est": evals_est, "evals_num": evals_num,
            "speedup_evals": evals_num / evals_est,
            "t_est_s": t_est, "t_num_s": t_num,
            "speedup_wall": t_num / t_est,
        })
        if verbose:
            r = rows[-1]
            print(f"{name}: evals {evals_est} vs {evals_num} "
                  f"(x{r['speedup_evals']:.0f}); wall {t_est:.1f}s vs "
                  f"{t_num:.1f}s (x{r['speedup_wall']:.1f})", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--json", default=None,
                    help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    rows = run(device=args.device)
    print("name,us_per_call,derived")
    for r in rows:
        print(f"speedup_{r['cov']},{r['t_est_s'] * 1e6 / r['evals_est']:.0f},"
              f"eval_speedup={r['speedup_evals']:.0f}x;"
              f"wall_speedup={r['speedup_wall']:.1f}x;paper_range=20-50x")
    print(json.dumps({"speedup": rows}))
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
