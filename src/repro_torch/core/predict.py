"""GP prediction (paper eq. 2.1, sigma_f profiled) and GP draws (Fig. 1).

Counterpart of ``repro/core/predict.py``: mean = k*^T K^-1 y,
var = sigma_f_hat^2 (k** - k*^T K^-1 k*).  On the dense backend one
Cholesky of K serves both, with the cross covariance from the covariance's
``fn``; :func:`predict_full_cov`, :func:`draw_prior` and
:func:`draw_posterior` are dense whatever the backend.  The iterative and
stochastic backends share one body, the backend's solver, with unit-scale
stationary kernels (k** = 1).  With the exact cross
covariance the mean is one B1 launch with n1 = n*, b = 1, and the variance
builds the (n, n*) cross block with B4 and solves it with one batched CG.
With ``cross="interp"`` on an SKI or product-SKI operator the test points
are interpolated onto the same inducing grid: the mean is
W* K_grid W^T alpha, and the variance builds its right-hand sides chunk by
chunk through the W sandwich (no (n, n*) block), each chunk one batched
CG (a B5 or B10 launch per iteration when fused).  Composite kinds take
(n*, d) test points; their exact cross covariance is B8 for the mean and
B4 once per factor for the variance's block.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import _sync
from .. import random as rnd
from . import engine as eng
from . import hyperlik as hl
from ..kernels import ops as kops
from ..kernels.operators import ProductSKIOperator, SKIOperator
from .covariances import Covariance, build_K


# the smallest predictive variance of the last prediction before the clamp
# at 0, for run reports (negative where the solve or the interpolated
# cross covariance overshoots)
VAR_BEFORE_CLAMP_MIN = [math.nan]


class Posterior(NamedTuple):
    mean: torch.Tensor
    var: Optional[torch.Tensor]   # pointwise predictive variance, or None
    sigma_f_hat: torch.Tensor


def _predict_impl(cov: Covariance, theta, x, y, xstar, sigma_n: float,
                  include_noise: bool = False, jitter: float = 1e-10,
                  backend: str = "dense", key=None,
                  solver_opts: eng.SolverOpts = eng.SolverOpts(),
                  compute_var: bool = True, op=None, var_chunk: int = 256,
                  cross: str = "exact") -> Posterior:
    """Posterior mean and variance at xstar (``compute_var=False``: the
    mean only, var None).  Off the dense backend, ``cross="interp"`` takes
    the SKI-interpolated cross covariance where the operator is SKI and
    every test stencil fits the grid; otherwise the cross covariance is
    exact."""
    if cross not in ("exact", "interp"):
        raise ValueError(f"unknown cross mode {cross!r}; choose "
                         f"'exact' or 'interp'")
    if backend == "dense":
        return _predict_dense(cov, theta, x, y, xstar, sigma_n,
                              include_noise, jitter, compute_var)
    return _predict_iterative(cov, theta, x, y, xstar, sigma_n,
                              include_noise, jitter, solver_opts,
                              compute_var, key=key, op=op,
                              var_chunk=var_chunk, cross=cross,
                              backend=backend)


def _predict_dense(cov, theta, x, y, xstar, sigma_n, include_noise, jitter,
                   compute_var) -> Posterior:
    cache = hl.factorize(build_K(cov, theta, x, sigma_n, jitter), y)
    ks = cov(theta, x, xstar)                    # (n, n*)
    mean = ks.T @ cache.alpha
    sf_hat = hl.sigma_f_hat(cache)
    if not compute_var:
        return Posterior(mean=mean, var=None, sigma_f_hat=sf_hat)
    kss = cov(theta, xstar, xstar)
    v = torch.linalg.solve_triangular(cache.L, ks, upper=False)
    var_unit = torch.diagonal(kss) - torch.sum(v * v, dim=0)
    if include_noise:
        var_unit = var_unit + sigma_n ** 2
    var = cache.sigma2_hat * var_unit
    if xstar.shape[0] > 0:
        VAR_BEFORE_CLAMP_MIN[0] = _sync.host(var.min(), "predict")
    return Posterior(mean=mean, var=torch.clamp(var, min=0.0),
                     sigma_f_hat=sf_hat)


def _predict_iterative(cov: Covariance, theta, x, y, xstar, sigma_n: float,
                       include_noise: bool, jitter: float,
                       opts: eng.SolverOpts, compute_var: bool, key=None,
                       op=None, var_chunk: int = 256,
                       cross: str = "exact",
                       backend: str = "iterative") -> Posterior:
    kind = eng.resolve_kind(cov)
    theta = torch.as_tensor(theta, dtype=x.dtype, device=x.device)
    xstar = torch.as_tensor(xstar, dtype=x.dtype, device=x.device)
    solver = eng.make_solver(backend, cov, theta, x, y, sigma_n,
                             key=key, jitter=jitter, opts=opts, op=op)
    s2 = solver.sigma2_hat()                     # the K^-1 y solve
    star = None
    if cross == "interp" and isinstance(solver.op, (SKIOperator,
                                                    ProductSKIOperator)):
        star = solver.op.cross_interp(xstar)     # None: x* off the grid
    if star is not None:
        mean = solver.op.cross_matvec(theta, star, solver.alpha)
    else:
        mean = kops.matvec(kind, theta, xstar, x, solver.alpha)
    if not compute_var:
        return Posterior(mean=mean, var=None, sigma_f_hat=torch.sqrt(s2))
    n_star = int(xstar.shape[0])
    if star is not None and n_star > 0:
        # chunked SKI variance: per chunk, the right-hand sides W K_grid
        # W*^T, then one batched CG; working set O(n chunk)
        idx_s, w_s = star
        step = max(int(var_chunk), 1)
        chunks = []
        for lo in range(0, n_star, step):
            sl = slice(lo, min(lo + step, n_star))
            ks_c = solver.op.cross_columns(theta, (idx_s[sl], w_s[sl]))
            w_c = solver.solve(ks_c)             # K^-1 k*, batched CG
            chunks.append(torch.sum(ks_c * w_c, dim=0))
        quad = torch.cat(chunks)
    else:
        ks = kops.matrix(kind, theta, x, xstar)  # (n, n*) cross block
        w = solver.solve(ks)                     # K^-1 k*, batched CG
        quad = torch.sum(ks * w, dim=0)
    var_unit = 1.0 - quad        # unit-scale stationary kernels: k(0) = 1
    if include_noise:
        var_unit = var_unit + sigma_n ** 2
    var = s2 * var_unit
    if n_star > 0:
        VAR_BEFORE_CLAMP_MIN[0] = _sync.host(var.min(), "predict")
    return Posterior(mean=mean, var=torch.clamp(var, min=0.0),
                     sigma_f_hat=torch.sqrt(s2))


def predict_full_cov(cov: Covariance, theta, x, y, xstar, sigma_n: float,
                     jitter: float = 1e-10):
    """(mean, full predictive covariance) at xstar, for joint draws."""
    cache = hl.factorize(build_K(cov, theta, x, sigma_n, jitter), y)
    ks = cov(theta, x, xstar)
    kss = cov(theta, xstar, xstar)
    mean = ks.T @ cache.alpha
    v = torch.linalg.solve_triangular(cache.L, ks, upper=False)
    return mean, cache.sigma2_hat * (kss - v.T @ v)


def draw_prior(key, cov: Covariance, theta, x, sigma_f: float,
               sigma_n: float, jitter: float = 1e-10):
    """One realisation of the GP prior at x (paper Fig. 1, the synthetic
    data): L z with L the Cholesky factor of sigma_f^2 K."""
    K = sigma_f ** 2 * build_K(cov, theta, x, sigma_n, jitter)
    z = rnd.normal(key, (x.shape[0],), device=K.device, dtype=K.dtype)
    return hl.cholesky(K) @ z


def draw_posterior(key, cov: Covariance, theta, x, y, xstar, sigma_n: float,
                   n_draws: int = 1, jitter: float = 1e-8):
    """``n_draws`` joint posterior draws at xstar, (n_draws, n*)."""
    mean, pc = predict_full_cov(cov, theta, x, y, xstar, sigma_n)
    L = hl.cholesky(pc + jitter * torch.eye(pc.shape[0], dtype=pc.dtype,
                                            device=pc.device))
    z = rnd.normal(key, (n_draws, pc.shape[0]), device=pc.device,
                   dtype=pc.dtype)
    return mean[None, :] + z @ L.T
