"""The 6-month sequential-vs-bank record of ``chip_smoke.py`` through the
batched compare of the JAX package and of the port, on a CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/six_month_bank_reference.py \
        [--sigma-n 0.01] [--starts 2] [--iters 25] [--json PATH]

The data are ``chip_smoke.make_tidal_data(0, months=6)`` (n = 1770, a
near grid), the models k1 and k2 in the tidal-band boxes, the solver
options of ``chip_smoke.sequential_vs_bank`` with the iterative backend
and the circulant preconditioner, and the key ``key(2000)`` that the
smoke gives that check.  Three runs of compare(batch="on"):

  jax         the JAX package (at n < 2048 its bank is unfused: no Pallas)
  port_seam   the port on the CPU with every random draw replayed by
              ``jax.random`` on the key's path (the tests' random seam):
              the same probes and starts as ``jax``
  port_own    the port on the CPU with its own draws, which are the
              draws the card run makes (the port seeds them on the host)

For each model it prints ln P_max and the NCG steps of every restart, the
chosen theta_hat, ln P_max and ln Z.  ``jax`` against ``port_seam`` says
whether the port computes the reference's answer on these data;
``port_own`` says what the card's draws lead to.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from repro.core import enable_x64  # noqa: E402

enable_x64()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro import gp as jgp  # noqa: E402
from repro.core.engine import SolverOpts as JSolverOpts  # noqa: E402
from repro.core.reparam import FlatBox as JFlatBox  # noqa: E402
from repro.gp import batch as jbatch  # noqa: E402
import repro_torch.random as rnd  # noqa: E402
from repro_torch import gp as tgp  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.gp import batch as tbatch  # noqa: E402

OPTS = dict(n_probes=8, lanczos_k=48, cg_tol=1e-6, cg_max_iter=400,
            precond="circulant")
KEY = 2000
NAMES = ("k1", "k2")


def _jax_key(k: rnd.Key):
    jk = jax.random.key(k.seed)
    for step in k.path:
        if step[0] == "split":
            jk = jax.random.split(jk, step[1])[step[2]]
        else:
            jk = jax.random.fold_in(jk, step[1])
    return jk


@contextlib.contextmanager
def jax_draws():
    """Replay the port's rademacher/uniform/normal with jax.random."""
    saved = rnd.rademacher, rnd.uniform, rnd.normal

    def rademacher(k, shape, *, device, dtype=torch.float64):
        z = np.asarray(jax.random.rademacher(_jax_key(k), tuple(shape)))
        return torch.tensor(z, device=device, dtype=dtype)

    def uniform(k, shape, lo=0.0, hi=1.0, *, device, dtype=torch.float64):
        u = np.asarray(jax.random.uniform(_jax_key(k), tuple(shape),
                                          minval=lo, maxval=hi,
                                          dtype=jnp.float64))
        return torch.tensor(u, device=device, dtype=dtype)

    def normal(k, shape, *, device, dtype=torch.float64):
        g = np.asarray(jax.random.normal(_jax_key(k), tuple(shape),
                                         dtype=jnp.float64))
        return torch.tensor(g, device=device, dtype=dtype)

    rnd.rademacher, rnd.uniform, rnd.normal = rademacher, uniform, normal
    try:
        yield
    finally:
        rnd.rademacher, rnd.uniform, rnd.normal = saved


@contextlib.contextmanager
def capture(module):
    """Keep the result of every ``module.train_bank`` call."""
    fits, train = [], module.train_bank

    def keep(*args, **kwargs):
        fits.append(train(*args, **kwargs))
        return fits[-1]

    module.train_bank = keep
    try:
        yield fits
    finally:
        module.train_bank = train


def _finite(v):
    v = float(v)
    return v if math.isfinite(v) else None


def summarise(reports, fit, seconds):
    """Per model: restarts' ln P_max and steps (flat index r K + k), the
    chosen theta_hat, ln P_max, ln Z (None where not finite)."""
    lp = np.asarray(fit.log_p_all, dtype=float)
    its = np.asarray(fit.iters_all)
    out = dict(s=seconds)
    for k, r in enumerate(reports):
        out[r.name] = dict(
            log_p_restarts=[_finite(v) for v in lp[:, k]],
            iters_restarts=[int(v) for v in its[:, k]],
            theta_hat=[float(v) for v in np.asarray(r.theta_hat)],
            log_p_max=_finite(r.log_p_max), log_z=_finite(r.log_z_laplace),
            n_modes=int(r.n_modes))
    return out


def run_jax(x, y, sigma_n, policy):
    pol = jgp.SolverPolicy(opts=JSolverOpts(**OPTS), **policy)
    boxes = cs.tidal_boxes()
    specs = [jgp.GPSpec(k, box=JFlatBox(np.asarray(boxes[k].lo),
                                        np.asarray(boxes[k].hi)),
                        noise=jgp.NoiseModel(sigma_n=sigma_n), solver=pol)
             for k in NAMES]
    t0 = time.perf_counter()
    with capture(jbatch) as fits:
        reports = jgp.compare(specs, x, y, key=jax.random.key(KEY),
                              batch="on")
    return summarise(reports, fits[0], time.perf_counter() - t0)


def run_port(x, y, sigma_n, policy, seam: bool):
    pol = tgp.SolverPolicy(opts=teng.SolverOpts(**OPTS), **policy)
    boxes = cs.tidal_boxes()
    specs = [tgp.GPSpec(k, box=boxes[k],
                        noise=tgp.NoiseModel(sigma_n=sigma_n), solver=pol)
             for k in NAMES]
    draws = jax_draws() if seam else contextlib.nullcontext()
    t0 = time.perf_counter()
    with draws, capture(tbatch) as fits:
        reports = tgp.compare(specs, x, y, key=rnd.key(KEY), batch="on",
                              device="cpu")
    return summarise(reports, fits[0], time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sigma-n", type=float, default=0.01)
    ap.add_argument("--starts", type=int, default=2)
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--runs", default="jax,port_seam,port_own")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    x, y, _, n_full = cs.make_tidal_data(0, months=6)
    policy = dict(backend="iterative", n_starts=args.starts,
                  max_iters=args.iters, scan_points=None)
    out = dict(n=len(x), n_full=n_full, sigma_n=args.sigma_n,
               starts=args.starts, iters=args.iters)
    for run in args.runs.split(","):
        if run == "jax":
            out[run] = run_jax(x, y, args.sigma_n, policy)
        else:
            out[run] = run_port(x, y, args.sigma_n, policy,
                                seam=run == "port_seam")
        print(json.dumps({run: out[run]}), flush=True)
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
