"""The JAX reference's model comparison on the smoke's kind of data, on a CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_evidence.py \
        [--n 4380] [--seed 0] [--budget planned|committed] [--json PATH]

It runs the JAX package's dense backend (exact Cholesky likelihood and
analytic Laplace Hessian) through the sequential comparison of k1 and k2
(bind -> fit -> multimodal Laplace evidence per model, with the key
threading of ``gp.compare``) on the data ``chip_smoke.py`` makes, at a
size a CPU can take: n sorted uniform times over n hours (one sample an
hour on average, as at n = 8760) and one draw of a k2 GP with a 200 h
window, periods 12.42 h and 24 h and sigma_n = 0.1.  The budget is one of
the two that ``chip_smoke.py`` has run:

  planned    the data-dependent box, n_starts=2, max_iters=5, no scan
  committed  the tidal-band boxes, n_starts=2, max_iters=25, 64 scan points

For each model it prints ln P_max per restart and, at each mode, ln Z and
the eigenvalues of the Laplace Hessian.  ln Z is nan exactly when one of
them is not positive: the reference's own verdict that the fit stopped
short of a peak.  Keep n small: n = 800 runs both models, while at
n = 2190 the dense k2 fit asked for 98 GB (k1 still ran there).
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import time

import numpy as np

from repro.core import enable_x64

enable_x64()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import gp  # noqa: E402
from repro.core.covariances import build_K, resolve  # noqa: E402
from repro.core.engine import SolverOpts  # noqa: E402
from repro.core.reparam import FlatBox  # noqa: E402

SIGMA_N = 0.1
# the k2 point the data is drawn from (flat coordinates, hours), as in
# chip_smoke.py
TRUTH = [math.log(200.0), math.log(12.42), -0.19, math.log(24.0), -0.1]
OPTS = SolverOpts(n_probes=8, lanczos_k=48, cg_tol=1e-6, cg_max_iter=400)
BUDGETS = {"planned": dict(n_starts=2, max_iters=5, scan_points=None),
           "committed": dict(n_starts=2, max_iters=25, scan_points=64)}


def make_data(n: int, seed: int):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, float(n), n))
    rng.uniform(0.0, float(n), 512)         # the smoke's x* draw
    z = rng.standard_normal(n)
    K = build_K(resolve("k2"), jnp.asarray(TRUTH), jnp.asarray(x), SIGMA_N,
                jitter=0.0)
    return x, np.asarray(jnp.linalg.cholesky(K) @ jnp.asarray(z))


def tidal_boxes():
    """The boxes of chip_smoke.py's committed budget: window 4 h - 2000 h,
    periods in 12.2-12.7 h and 23.5-24.5 h, smoothness in (-0.45, 0.45)."""
    w = (math.log(4.0), math.log(2000.0))
    p1 = (math.log(12.2), math.log(12.7))
    p2 = (math.log(23.5), math.log(24.5))
    s = (-0.45, 0.45)
    return {"k1": FlatBox(jnp.array([w[0], p1[0], s[0]]),
                          jnp.array([w[1], p1[1], s[1]])),
            "k2": FlatBox(jnp.array([w[0], p1[0], s[0], p2[0], s[0]]),
                          jnp.array([w[1], p1[1], s[1], p2[1], s[1]]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4380)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget", choices=sorted(BUDGETS), default="planned")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    x, y = make_data(args.n, args.seed)
    policy = gp.SolverPolicy(backend="dense", opts=OPTS,
                             **BUDGETS[args.budget])
    specs = gp.spec_bank(["k1", "k2"], noise=gp.NoiseModel(sigma_n=SIGMA_N),
                         solver=policy)
    if args.budget == "committed":
        boxes = tidal_boxes()
        specs = [gp.GPSpec(s.kernel, box=boxes[s.name], noise=s.noise,
                           solver=s.solver) for s in specs]
    # chip_smoke.py splits its key into (fit, evidence, compare)
    key = jax.random.split(jax.random.key(args.seed), 3)[2]
    models = []
    for spec in specs:
        t0 = time.perf_counter()
        key, kt, kl, _ = jax.random.split(key, 4)
        g = gp.GP.bind(spec, x, y).fit(kt)
        mm = g.log_evidence(key=kl, multimodal=True)
        modes = []
        for theta, log_z in zip(np.asarray(mm.modes), mm.log_z_modes):
            lap = g.log_evidence(theta=jnp.asarray(theta), key=kl)
            modes.append(dict(
                theta=theta.tolist(), log_z=float(log_z),
                hessian_eigenvalues=np.linalg.eigvalsh(
                    np.asarray(lap.hessian)).tolist()))
        models.append(dict(
            name=spec.name, log_p_all=np.asarray(g.result.log_p_all).tolist(),
            theta_all=np.asarray(g.result.theta_all).tolist(),
            n_evals=int(g.result.n_evals), log_z=float(mm.log_z),
            modes=modes, seconds=time.perf_counter() - t0))
        print(json.dumps(models[-1]), flush=True)
    out = dict(n=args.n, seed=args.seed, budget=args.budget, backend="dense",
               models=models,
               ln_b_k2_vs_k1=models[1]["log_z"] - models[0]["log_z"])
    print(json.dumps({k: v for k, v in out.items() if k != "models"}))
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
