"""GP prediction, paper eq. (2.1), sigma_f profiled.

Counterpart of the iterative path of ``repro/core/predict.py`` with the
exact cross covariance: mean = k*^T K^-1 y, var = sigma_f_hat^2 (1 - k*^T
K^-1 k*).  The mean is one B1 launch with n1 = n*, b = 1; the variance
builds the (n, n*) cross block with B4 and solves it with one batched CG
(B1 with b = n* per iteration).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import _pending
from . import engine as eng
from ..kernels import ops as kops
from .covariances import Covariance


class Posterior(NamedTuple):
    mean: torch.Tensor
    var: Optional[torch.Tensor]   # pointwise predictive variance, or None
    sigma_f_hat: torch.Tensor


def _predict_impl(cov: Covariance, theta, x, y, xstar, sigma_n: float,
                  include_noise: bool = False, jitter: float = 1e-10,
                  backend: str = "iterative", key=None,
                  solver_opts: eng.SolverOpts = eng.SolverOpts(),
                  compute_var: bool = True, op=None) -> Posterior:
    """Posterior mean and variance at xstar with the exact cross covariance
    (the JAX package's SKI-interpolated cross path comes with the SKI
    operator; on the tile operator both of its modes take this path)."""
    if backend != "iterative":
        raise _pending.pending(f"prediction on backend {backend!r}",
                               _pending.DENSE if backend == "dense"
                               else _pending.STOCHASTIC)
    return _predict_iterative(cov, theta, x, y, xstar, sigma_n,
                              include_noise, jitter, solver_opts,
                              compute_var, key=key, op=op)


def _predict_iterative(cov: Covariance, theta, x, y, xstar, sigma_n: float,
                       include_noise: bool, jitter: float,
                       opts: eng.SolverOpts, compute_var: bool, key=None,
                       op=None) -> Posterior:
    kind = eng.resolve_kind(cov)
    theta = torch.as_tensor(theta, dtype=x.dtype, device=x.device)
    xstar = torch.as_tensor(xstar, dtype=x.dtype, device=x.device)
    solver = eng.make_solver("iterative", cov, theta, x, y, sigma_n,
                             key=key, jitter=jitter, opts=opts, op=op)
    s2 = solver.sigma2_hat()                     # the K^-1 y solve
    mean = kops.matvec(kind, theta, xstar, x, solver.alpha)
    if not compute_var:
        return Posterior(mean=mean, var=None, sigma_f_hat=torch.sqrt(s2))
    ks = kops.matrix(kind, theta, x, xstar)      # (n, n*) cross block
    w = solver.solve(ks)                         # K^-1 k*, batched CG
    quad = torch.sum(ks * w, dim=0)
    var_unit = 1.0 - quad        # unit-scale stationary kernels: k(0) = 1
    if include_noise:
        var_unit = var_unit + sigma_n ** 2
    return Posterior(mean=mean, var=s2 * torch.clamp(var_unit, min=0.0),
                     sigma_f_hat=torch.sqrt(s2))
