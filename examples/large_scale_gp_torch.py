"""Matrix-free and distributed GP training at large n, on the PyTorch/CUDA
port (the twin of examples/large_scale_gp.py, with its flags and
defaults).

The paper caps at n ~ 2000 (dense Cholesky).  This example binds the same
front-door session at n = 20,000: ``GP.bind`` resolves backend="auto" to
the iterative engine (CG + SLQ over the matrix-free operator; the paper's
synthetic data sit on the grid t = 1..n, so the operator is Toeplitz on
``torch.fft``) and a short ``fit`` drives real NCG steps through it.  The
row-sharded distributed step then runs on a world-size-1 process group
(NCCL on the card) at n = 4096.

    PYTHONPATH=src python examples/large_scale_gp_torch.py [--n 20000]
    PYTHONPATH=src python examples/large_scale_gp_torch.py --backend stochastic

``--backend stochastic`` runs the third backend on irregular data: the
EigenPro-style mini-batch solver on the row-slab kernel (B12) under a
declared memory budget.  Everything runs on the card; the data are drawn
with numpy from fixed seeds (the JAX example draws them with jax.random,
so the two print different numbers).
"""

import argparse
import pathlib
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

from repro_torch import gp  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.engine import SolverOpts  # noqa: E402
from repro_torch.core.reparam import from_box  # noqa: E402
from repro_torch.core.stochastic import resolve_stochastic  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_local_group  # noqa: E402

# the paper's Fig. 1 point for k2 (flat coordinates) and its noise
K2_TRUE = [3.5, 1.5, 0.0, 3.0, 0.0]
SIGMA_N = 0.1


def synthetic(n: int, seed: int = 0, device=None):
    """The paper's synthetic data (repro.data.synthetic's recipe): one
    draw of the k2 GP at t = 1..n with unit scale and sigma_n noise,
    L z with L the Cholesky factor of K + (sigma_n^2 + 1e-10) I and z
    from numpy's generator."""
    dev = resolve_device(device)
    x = torch.arange(1, n + 1, dtype=torch.float64, device=dev)
    K = ops.matrix("k2", torch.tensor(K2_TRUE, device=dev), x, x)
    K.diagonal().add_(SIGMA_N ** 2 + 1e-10)
    z = np.random.default_rng(seed).standard_normal(n)
    y = torch.linalg.cholesky(K) @ torch.tensor(z, device=dev)
    del K
    return x.cpu().numpy(), y.cpu().numpy()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--backend", choices=["auto", "stochastic"],
                    default="auto")
    ap.add_argument("--mem-budget-mb", type=int, default=1024)
    args = ap.parse_args()

    if args.backend == "stochastic":
        return run_stochastic(args)

    x, y = synthetic(args.n)
    theta = [3.4, 1.4, 0.05, 2.9, -0.05]
    print(f"n = {args.n}: dense K would need "
          f"{args.n**2*8/1e9:.1f} GB; matrix-free matvec uses "
          f"{args.n*20*8/1e6:.1f} MB")

    spec = gp.GPSpec(
        kernel="k2", noise=gp.NoiseModel(sigma_n=SIGMA_N),
        solver=gp.SolverPolicy(
            backend="auto",            # n > 2048 -> iterative engine
            opts=SolverOpts(n_probes=8, lanczos_k=48, cg_tol=1e-6,
                            cg_max_iter=400)))
    sess = gp.GP.bind(spec, x, y)
    print(f"bound: {sess!r}")

    t0 = time.time()
    lp = sess.log_likelihood(theta, key=rnd.key(1))
    torch.cuda.synchronize()
    print(f"iterative ln P_max = {float(lp):.1f} ({time.time()-t0:.0f}s)")

    # a short real NCG run, matrix-free end to end, seeded at theta
    t0 = time.time()
    th0 = torch.tensor(theta, dtype=sess.x.dtype, device=sess.x.device)
    fitted = sess.fit(rnd.key(2), n_starts=1, max_iters=args.steps,
                      z0s=from_box(th0, sess.box)[None, :])
    print(f"NCG x{args.steps} from theta0: ln P_max = "
          f"{float(fitted.result.log_p_max):.1f} "
          f"({int(fitted.result.n_evals)} evals, {time.time()-t0:.0f}s)")
    print(f"theta_hat = {fitted.theta_hat.cpu().numpy().round(2)}")

    group = make_local_group()
    try:
        t0 = time.time()
        dres = distributed.distributed_profiled_loglik(
            "k2", theta, x[:4096], y[:4096], SIGMA_N, group, rnd.key(9),
            n_probes=8, lanczos_k=48, cg_max_iter=300)
        print(f"distributed (torch.distributed, "
              f"{dist.get_backend(group)}) ln P_max @ n=4096 = "
              f"{float(dres.log_p_max):.1f} ({time.time()-t0:.0f}s); "
              f"{dist.get_world_size(group)} rank(s)")
    finally:
        dist.destroy_process_group()


def run_stochastic(args):
    """Structure-free path: irregular x (no grid to exploit), mini-batch
    solver under a memory budget; batch and rank resolve from the budget,
    never an (n, n) or even an (n, big-batch) buffer."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0.0, 1.0, args.n) * 100.0)
    y = np.sin(2.1 * x) + 0.3 * np.sin(0.37 * x) \
        + 0.1 * rng.standard_normal(args.n)
    theta = [0.0]

    spec = gp.GPSpec(
        kernel="se", noise=gp.NoiseModel(sigma_n=0.1),
        solver=gp.SolverPolicy(
            backend="stochastic",
            opts=SolverOpts(n_probes=8,
                            mem_budget_mb=args.mem_budget_mb)))
    sess = gp.GP.bind(spec, x, y)
    plan = resolve_stochastic(spec.solver.opts, args.n, 0.01)
    print(f"bound: {sess!r}")
    print(f"plan under {args.mem_budget_mb} MB: batch={plan.batch} "
          f"rank={plan.rank} epochs={plan.epochs} — row slab "
          f"{plan.batch*args.n*8/1e6:.0f} MB vs dense K "
          f"{args.n**2*8/1e9:.1f} GB")

    t0 = time.time()
    lp = sess.log_likelihood(theta, key=rnd.key(1))
    print(f"stochastic ln P_max = {float(lp):.1f} "
          f"({time.time()-t0:.0f}s)")

    t0 = time.time()
    th0 = torch.tensor(theta, dtype=sess.x.dtype, device=sess.x.device)
    fitted = sess.fit(rnd.key(2), n_starts=1, max_iters=args.steps,
                      z0s=from_box(th0, sess.box)[None, :])
    print(f"NCG x{args.steps}: ln P_max = "
          f"{float(fitted.result.log_p_max):.1f} "
          f"({int(fitted.result.n_evals)} evals, {time.time()-t0:.0f}s)")
    print(f"theta_hat = {fitted.theta_hat.cpu().numpy().round(3)}")

    xstar = np.linspace(0.0, 100.0, 256)
    post = fitted.predict(xstar, compute_var=False)
    print(f"posterior mean at {xstar.shape[0]} test points: "
          f"range [{float(post.mean.min()):.2f}, "
          f"{float(post.mean.max()):.2f}] — matrix-free end to end")


if __name__ == "__main__":
    main()
