"""Nested-sampling baseline (the paper's MULTINEST comparison point).

Counterpart of ``repro/core/nested.py``, the same algorithm with the same
key splits, recurrences and evaluation counts:

  * N live points drawn from the flat prior (box + ordering constraint);
  * at step i the worst point L* is removed, ln X_i = -i/N shrinkage,
    Z accumulated as  Z += (X_{i-1} - X_i) * L*   [Skilling 2006];
  * replacement by constrained random-walk MCMC: B chains start from
    random live points and take ``n_steps`` Metropolis steps with the
    uniform-on-{L > L*} target; proposals use the live-set standard
    deviation with a scale adapted toward ~40% acceptance.  The B chains
    advance in lock-step, so each MCMC step is one batched likelihood
    evaluation (``log_l`` maps a (B, m) batch to (B,));
  * termination when max(L_live) * X_i < dlogz_stop * Z, then the live set
    is swept in; the information H follows dynesty's incremental
    recurrence, giving the ln Z error sqrt(H/N).

The loop runs on the host, one iteration per removed point; its state
stays on the device.  The termination test reads one device value per
iteration once the first N have run (``_sync.COUNT["nested_iter"]``); the
chains' steps read none.  Each iteration's draws (the chain starts and the
B x m proposal normals of every step) are made on the CPU, from keys split
where the JAX package splits them, and copied to the device in one
transfer that does not wait for it.  With ``graph=True`` on the card (the
dense integrand, which reads nothing back) the n_steps chain steps are
captured once as a CUDA graph and replayed each iteration, since launching
their few hundred small kernels one by one costs the host ~25 ms an
iteration (:data:`GRAPHS` counts captures, replays and refusals).
"""

from __future__ import annotations

import collections
import math
from typing import Callable, NamedTuple

import torch

from .. import _sync
from .. import random as rnd
from . import engine as eng
from . import hyperlik as hl
from .covariances import Covariance
from .reparam import FlatBox, in_box, sample_uniform

# CUDA graphs of the chain steps: "captured", "replays", and "refused"
# (a capture that raised; that run took the eager steps)
GRAPHS: collections.Counter = collections.Counter()


class NestedResult(NamedTuple):
    log_z: torch.Tensor
    log_z_err: torch.Tensor   # sqrt(H / n_live), Skilling's information error
    n_evals: int              # total likelihood evaluations
    n_iters: int
    h_info: torch.Tensor


def _log_sub_exp(a, b):
    """log(e^a - e^b) for a > b, stable (host floats)."""
    return a + math.log1p(-math.exp(min(b - a, -1e-12)))


def _add_weight(log_z, h, log_wt, ll):
    """Z += e^log_wt for a point of ln L ``ll``, and dynesty's incremental
    information update: (ln Z, H)."""
    log_z_new = torch.logaddexp(log_z, log_wt)
    h = (torch.exp(log_wt - log_z_new) * ll
         + torch.exp(log_z - log_z_new) * (h + log_z) - log_z_new)
    return log_z_new, h


def _iteration_draws(key, n_chains: int, n_live: int, n_steps: int, m: int,
                     dtype, device):
    """The next loop key, the chain starts (n_chains,) and the proposal
    normals (n_steps, n_chains, m) of one iteration, drawn on the CPU
    from the JAX package's splits and moved to ``device`` together."""
    key, kp, ks = rnd.split(key, 3)
    starts = rnd.randint(kp, (n_chains,), 0, n_live, device="cpu")
    noise = torch.stack([rnd.normal(rnd.split(k)[0], (n_chains, m),
                                    device="cpu", dtype=dtype)
                         for k in rnd.split(ks, n_steps)])
    return (key, starts.to(device, non_blocking=True),
            noise.to(device, non_blocking=True))


def _support_fn(cov: Covariance, box: FlatBox) -> Callable:
    """theta (B, m) -> in the box and every ordering group non-decreasing
    (``in_box & ordering_ok``, with the groups' indices on the device, so
    that a CUDA graph can hold it)."""
    groups = [torch.tensor(g, device=box.lo.device)
              for g in cov.ordering_groups]

    def support(theta):
        ok = in_box(box, theta)
        for idx in groups:
            vals = theta.index_select(-1, idx)
            ok = ok & torch.all(torch.diff(vals, dim=-1) >= 0, dim=-1)
        return ok

    return support


def _chain_steps(log_l: Callable, support: Callable, n_steps: int):
    """(chain, chain_ll, l_star, scale, noise) -> (chain, chain_ll,
    accepted): the B chains' constrained Metropolis steps in lock-step,
    one batched evaluation each, no host read."""

    def run(chain, chain_ll, l_star, scale, noise):
        n_acc = torch.zeros((), dtype=torch.int32, device=chain.device)
        for j in range(n_steps):
            prop = chain + scale * noise[j]
            ok = support(prop)
            pl = log_l(torch.where(ok[:, None], prop, chain))
            acc = ok & (pl > l_star)
            chain = torch.where(acc[:, None], prop, chain)
            chain_ll = torch.where(acc, pl, chain_ll)
            n_acc = n_acc + torch.sum(acc, dtype=torch.int32)
        return chain, chain_ll, n_acc

    return run


class _GraphedSteps:
    """``run`` captured once as a CUDA graph on static copies of its
    arguments; a call copies its arguments in, replays, and returns the
    static outputs (read them before the next call).  The object holds
    ``run``: the graph reads the device tensors its closure holds (the
    ordering groups' indices), which must outlive it."""

    def __init__(self, run: Callable, args):
        self.run = run
        self.inputs = [a.clone() for a in args]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):          # library handles, workspaces
            for _ in range(2):
                run(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = run(*self.inputs)
        GRAPHS["captured"] += 1

    def __call__(self, *args):
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        self.graph.replay()
        GRAPHS["replays"] += 1
        return self.outputs


def _graphed_or_eager(run: Callable, args) -> Callable:
    try:
        return _GraphedSteps(run, args)
    except RuntimeError:
        GRAPHS["refused"] += 1
        torch.cuda.synchronize()
        return run


def nested_sample(key, log_l: Callable, cov: Covariance, box: FlatBox,
                  n_live: int = 400, n_chains: int = 8, n_steps: int = 16,
                  max_iter: int = 30000, dlogz_stop: float = 0.05,
                  graph: bool = False) -> NestedResult:
    """ln Z of ``log_l`` (batched: (B, m) -> (B,)) under the flat prior of
    ``box`` and ``cov``'s ordering constraint.  ``graph``: replay the
    chain steps as a CUDA graph on the card (``log_l`` must read nothing
    back to the host); the answers are the eager steps' to the bit."""
    m = cov.n_params
    dtype, dev = box.lo.dtype, box.lo.device
    k0, key = rnd.split(key)
    live = sample_uniform(k0, cov, box, (n_live,))
    logl = log_l(live)
    ln_shrink = -1.0 / n_live                  # ln X_i = i * ln_shrink
    log_dlogz = math.log(dlogz_stop)
    per_iter = n_chains * n_steps

    log_z = torch.full((), -1e300, dtype=dtype, device=dev)
    h = torch.zeros((), dtype=dtype, device=dev)
    log_scale = torch.full((), math.log(0.5), dtype=dtype, device=dev)
    i, n_evals = 0, n_live
    steps = _chain_steps(log_l, _support_fn(cov, box), n_steps)
    graph = graph and dev.type == "cuda"

    def not_done():
        remain = torch.max(logl) + i * ln_shrink
        return _sync.host(remain > log_z + log_dlogz, "nested_iter")

    while i < max_iter and (i < n_live or not_done()):
        worst = torch.argmin(logl).view(1)
        l_star = logl.index_select(0, worst)[0]
        log_wt = _log_sub_exp(i * ln_shrink, (i + 1) * ln_shrink) + l_star
        log_z, h = _add_weight(log_z, h, log_wt, l_star)

        # constrained random-walk MCMC replacement (B chains in lock-step)
        key, starts, noise = _iteration_draws(key, n_chains, n_live,
                                              n_steps, m, dtype, dev)
        scale = torch.exp(log_scale) * (torch.std(live, dim=0, correction=0)
                                        + 1e-12)
        args = (live.index_select(0, starts), logl.index_select(0, starts),
                l_star, scale, noise)
        if graph:
            steps, graph = _graphed_or_eager(steps, args), False
        chain, chain_ll, n_acc = steps(*args)

        # adapt the proposal scale toward ~40% acceptance; the JAX package
        # forms the step in float32 (an int32 count over a Python int)
        acc_rate = n_acc.to(torch.float32) / float(per_iter)
        log_scale = torch.clamp(log_scale + 0.3 * (acc_rate - 0.4), -8.0,
                                2.0)

        # the worst point takes the end of the first chain above L*, or of
        # chain 0 if none is (jnp.argmax of a bool vector)
        pick = torch.argmax((chain_ll > l_star).to(torch.int32)).view(1)
        live = live.index_copy(0, worst, chain.index_select(0, pick))
        logl = logl.index_copy(0, worst, chain_ll.index_select(0, pick))
        i += 1
        n_evals += per_iter

    # sweep in the remaining live points, each with weight X_final / N
    ln_w_live = i * ln_shrink - math.log(n_live)
    for ll in torch.sort(logl, stable=True).values:
        log_z, h = _add_weight(log_z, h, ln_w_live + ll, ll)

    err = torch.sqrt(torch.clamp(h, min=1e-6) / n_live)
    return NestedResult(log_z=log_z, log_z_err=err, n_evals=n_evals,
                        n_iters=i, h_info=h)


def _fixed_probes(backend: str, op, key, opts, y):
    """The probe blocks a matrix-free evaluation at ``key`` draws, drawn
    once: (z_hutch, z_slq) for unpreconditioned CG, z for the stochastic
    backend, None where the SLQ probes depend on theta (N(0, P) probes of
    a preconditioned SLQ, drawn by each evaluation)."""
    n, p = int(y.shape[0]), opts.n_probes
    z = rnd.rademacher(key, (n, p), device=y.device, dtype=y.dtype)
    if backend == "stochastic":
        return z
    if op is not None and eng.select_precond(op, opts) is None:
        return z, rnd.rademacher(rnd.fold_in(key, 1), (n, p),
                                 device=y.device, dtype=y.dtype)
    return None


def make_gp_marg_loglik(cov: Covariance, x, y, sigma_n: float,
                        jeffreys_norm: float = 1.0, jitter: float = 1e-10,
                        backend: str = "dense", key=None,
                        solver_opts=None, op=None) -> Callable:
    """thetas (B, m) -> ln P_marg(y|x,theta) (eq. 2.18) per row: the
    integrand whose prior-weighted integral nested sampling evaluates, the
    quantity the profiled Laplace evidence approximates (eq. 2.13).  A
    nan value (a failed factorisation) gives -1e290.

    ``backend="dense"`` evaluates the batch with one batched Cholesky
    (:func:`~repro_torch.core.hyperlik.profiled_loglik_batch`); the
    matrix-free backends run one CG + SLQ pass per row with the fixed probe
    key ``key`` (a deterministic integrand), on the bound operator ``op``.
    """
    n = int(y.shape[0])
    const = hl.marginal_const(n, jeffreys_norm)

    def finish(val):
        return torch.where(torch.isnan(val), -1e290, val + const)

    if backend == "dense":
        def log_l(thetas):
            return finish(hl.profiled_loglik_batch(cov, thetas, x, y,
                                                   sigma_n, jitter))

        return log_l

    opts = solver_opts or eng.SolverOpts()
    if key is None:
        key = rnd.key(0)
    val_fn = eng.value_fn(backend, cov, x, y, sigma_n, key=key,
                          jitter=jitter, opts=opts, op=op,
                          probes=_fixed_probes(backend, op, key, opts, y))

    def log_l(thetas):
        return finish(torch.stack([val_fn(t) for t in thetas]))

    return log_l


def _evidence_nested_impl(key, cov: Covariance, x, y, sigma_n: float,
                          box: FlatBox, n_live: int = 400, n_chains: int = 8,
                          n_steps: int = 16, max_iter: int = 30000,
                          jeffreys_norm: float = 1.0,
                          jitter: float = 1e-10, backend: str = "dense",
                          solver_opts=None, op=None) -> NestedResult:
    """Numerical hyperevidence ln Z_num for a GP model (paper Table 1)."""
    key, kp = rnd.split(key)
    log_l = make_gp_marg_loglik(cov, x, y, sigma_n, jeffreys_norm, jitter,
                                backend=backend, key=kp,
                                solver_opts=solver_opts, op=op)
    return nested_sample(key, log_l, cov, box, n_live=n_live,
                         n_chains=n_chains, n_steps=n_steps,
                         max_iter=max_iter, graph=backend == "dense")
