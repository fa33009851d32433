"""Multi-start NCG maximisation of the profiled hyperlikelihood (Sec. 3a).

Counterpart of ``repro/core/train.py``: Polak-Ribiere+ nonlinear CG with
Armijo backtracking, in the unconstrained coordinate z with
theta = box-sigmoid(z).  The JAX package runs the loops as ``while_loop``s,
the dense restarts under ``vmap`` (each lane frozen once its own condition
fails, so each lane is a run of its own) and the matrix-free ones under
``lax.map``; here every restart is a Python loop with the same acceptance
logic, one after another, reading the loop conditions back to the host
(counted in :mod:`repro_torch._sync`).  The dense scan evaluates its
points in chunks of batched Cholesky factorisations.  Every likelihood
evaluation is counted, as in the paper.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import _sync
from .. import random as rnd
from . import engine as eng
from . import hyperlik as hl
from .covariances import Covariance
from .reparam import (FlatBox, apply_ordering, flat_box, from_box,
                      sample_uniform, to_box)

SCAN_KEY = 0x5eed  # fold-in constant of the probe key (as the JAX package)


class NCGState(NamedTuple):
    z: torch.Tensor
    f: torch.Tensor        # objective (= -ln P_max)
    g: torch.Tensor        # gradient in z coordinates
    d: torch.Tensor        # search direction
    step: torch.Tensor     # current initial step size
    n_evals: int
    k: int


class TrainResult(NamedTuple):
    theta_hat: torch.Tensor    # best peak, flat coordinates (ordering applied)
    log_p_max: torch.Tensor    # ln P_max at the peak (eq. 2.16)
    sigma_f_hat: torch.Tensor  # analytic scale at the peak (eq. 2.15)
    n_evals: int               # likelihood evaluations, all restarts
    theta_all: torch.Tensor    # (n_starts, m) per-restart peaks
    log_p_all: torch.Tensor    # (n_starts,) per-restart peak values
    iters_all: torch.Tensor    # (n_starts,) NCG iterations per restart


def make_objective(cov: Covariance, x, y, sigma_n: float, box: FlatBox,
                   jitter: float = 1e-10, backend: str = "dense",
                   key=None, solver_opts: eng.SolverOpts = eng.SolverOpts(),
                   op=None):
    """(value, grad) and value-only callables of z, each one likelihood
    evaluation through the engine's solver: one Cholesky on the dense
    backend, one fixed probe key on the others."""
    lo, hi = box.lo, box.hi
    widths = box.widths
    vag_t = eng.value_and_grad_fn(backend, cov, x, y, sigma_n, key=key,
                                  jitter=jitter, opts=solver_opts, op=op)
    val_t = eng.value_fn(backend, cov, x, y, sigma_n, key=key,
                         jitter=jitter, opts=solver_opts, op=op)

    def value_and_grad(z):
        theta = to_box(z, box)
        val, g_theta = vag_t(theta)
        dtheta_dz = (theta - lo) * (hi - theta) / widths
        return -val, -(g_theta * dtheta_dz)

    def value(z):
        return -val_t(to_box(z, box))

    return value_and_grad, value


def _nan_to_inf(f):
    return torch.where(torch.isnan(f), torch.full_like(f, torch.inf), f)


def _ncg_minimize(value_and_grad: Callable, value: Callable, z0,
                  max_iters: int = 80, grad_tol: float = 1e-5,
                  c1: float = 1e-4, shrink: float = 0.5,
                  max_backtracks: int = 25):
    """Polak-Ribiere+ NCG with Armijo backtracking; returns (z, f, evals, k)."""
    f0, g0 = value_and_grad(z0)
    f0 = torch.where(torch.isfinite(f0), f0, torch.full_like(f0, torch.inf))
    s = NCGState(z=z0, f=f0, g=g0, d=-g0,
                 step=torch.ones((), dtype=f0.dtype, device=f0.device),
                 n_evals=1, k=0)
    while s.k < max_iters and _sync.host(
            (torch.max(torch.abs(s.g)) > grad_tol) & torch.isfinite(s.f),
            "ncg"):
        gd = s.g @ s.d
        bad = gd >= 0.0             # not a descent direction: restart
        d = torch.where(bad, -s.g, s.d)
        gd = torch.where(bad, -(s.g @ s.g), gd)

        alpha = s.step
        f_new = _nan_to_inf(value(s.z + alpha * d))
        n_bt, ev = 0, 1
        while n_bt < max_backtracks and not _sync.host(
                f_new <= s.f + c1 * alpha * gd, "armijo"):
            alpha = alpha * shrink
            f_new = _nan_to_inf(value(s.z + alpha * d))
            n_bt += 1
            ev += 1

        accepted = f_new <= s.f + c1 * alpha * gd
        z_new = torch.where(accepted, s.z + alpha * d, s.z)
        f_new2, g_new = value_and_grad(z_new)
        yk = g_new - s.g
        beta = torch.clamp((g_new @ yk) / torch.clamp(s.g @ s.g, min=1e-300),
                           min=0.0)
        d_new = -g_new + beta * d
        step_new = alpha * 2.0 if n_bt == 0 else alpha
        step_new = torch.clamp(step_new, 1e-12, 1e3)
        s = NCGState(z=z_new, f=torch.where(accepted, f_new2, s.f), g=g_new,
                     d=d_new, step=step_new, n_evals=s.n_evals + ev + 1,
                     k=s.k + 1)
    return s.z, s.f, s.n_evals, s.k


def _train_impl(cov: Covariance, x, y, sigma_n: float, key,
                n_starts: int = 10, max_iters: int = 80,
                grad_tol: float = 1e-5, jitter: float = 1e-10,
                box: FlatBox | None = None, z0s=None, scan_points: int = 0,
                backend: str = "dense",
                solver_opts: eng.SolverOpts = eng.SolverOpts(),
                op=None) -> TrainResult:
    """Paper Sec. 3a: multi-start NCG on ln P_max.

    ``scan_points > 0`` seeds the restarts with the best points of a
    uniform scan of the box (each scan evaluation counted; on the dense
    backend in chunks of batched Cholesky factorisations,
    :func:`~repro_torch.core.hyperlik.profiled_loglik_batch`); otherwise
    the starts are uniform over the central 90% of the box in z.  ``z0s``
    pins the start points.
    """
    if box is None:
        box = flat_box(cov, x)
    scan_evals = 0
    if z0s is None:
        if scan_points > 0:
            ks, key = rnd.split(key, 2)
            cand = sample_uniform(ks, cov, box, (scan_points,)).to(x.dtype)
            if backend == "dense":
                vals = hl.profiled_loglik_batch(cov, cand, x, y, sigma_n,
                                                jitter)
            else:
                val_t = eng.value_fn(backend, cov, x, y, sigma_n,
                                     key=rnd.fold_in(key, SCAN_KEY),
                                     jitter=jitter, opts=solver_opts, op=op)
                vals = torch.stack([val_t(c) for c in cand])
            top = torch.argsort(torch.where(torch.isnan(vals),
                                            torch.full_like(vals, -torch.inf),
                                            vals), stable=True)
            top = top[-n_starts:]
            z0s = from_box(cand[top], box, eps=1e-3)
            scan_evals = scan_points
        else:
            u = rnd.uniform(key, (n_starts, cov.n_params), 0.05, 0.95,
                            device=x.device, dtype=x.dtype)
            z0s = torch.log(u) - torch.log1p(-u)
    z0s = torch.as_tensor(z0s, dtype=x.dtype, device=x.device)
    probe_key = rnd.fold_in(key, SCAN_KEY)
    vag, val = make_objective(cov, x, y, sigma_n, box, jitter,
                              backend=backend, key=probe_key,
                              solver_opts=solver_opts, op=op)
    runs = [_ncg_minimize(vag, val, z0, max_iters=max_iters,
                          grad_tol=grad_tol) for z0 in z0s]
    zs = torch.stack([r[0] for r in runs])
    fs = torch.stack([r[1] for r in runs])
    evals = sum(r[2] for r in runs)
    iters = torch.tensor([r[3] for r in runs])
    thetas = apply_ordering(cov, to_box(zs, box))
    best = int(torch.argmin(torch.where(torch.isnan(fs),
                                        torch.full_like(fs, torch.inf), fs)))
    theta_hat = thetas[best]
    solver = eng.make_solver(backend, cov, theta_hat, x, y, sigma_n,
                             key=probe_key, jitter=jitter, opts=solver_opts,
                             op=op)
    lp = eng.profiled_loglik(solver)
    sf_hat = torch.sqrt(solver.sigma2_hat())
    return TrainResult(theta_hat=theta_hat, log_p_max=lp, sigma_f_hat=sf_hat,
                       n_evals=evals + scan_evals, theta_all=thetas,
                       log_p_all=-fs, iters_all=iters)
