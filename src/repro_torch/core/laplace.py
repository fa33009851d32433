"""Laplace hyperevidence and Bayes factors (paper Sec. 2a, eq. 2.13).

Counterpart of the profiled engine path of ``repro/core/laplace.py``
(the iterative and stochastic backends):
ln Z = ln P_marg(theta_hat) - ln V + (m/2) ln 2 pi - (1/2) ln det H, with
sigma_f marginalised analytically (eqs. 2.18-2.19) and H the central
difference Hessian of the engine gradient.  The multimodal variant sums
the per-mode evidences over the distinct restart peaks.
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _pending
from .. import _sync
from . import engine as eng
from . import hyperlik as hl
from .covariances import Covariance
from .reparam import FlatBox, log_prior_volume


class LaplaceResult(NamedTuple):
    log_z: torch.Tensor        # ln Z_est of eq. (2.13)
    log_peak: torch.Tensor     # ln P_marg at the peak
    theta_hat: torch.Tensor    # peak hyperparameters (flat coordinates)
    hessian: torch.Tensor      # H = -dd ln P at the peak
    errors: torch.Tensor       # sqrt(diag(H^-1))
    log_volume: torch.Tensor   # ln V (Occam factor)
    log_det_h: torch.Tensor
    sigma_f_hat: torch.Tensor  # profiled scale (eq. 2.15)


# the eigenvalues of the latest Laplace Hessians, in call order, as device
# tensors (nan where H is not finite), for run reports
HESSIAN_EIGENVALUES: collections.deque = collections.deque(maxlen=256)


def _laplace_log_z(log_peak, log_volume, H):
    """(ln Z, ln det H); nan unless every eigenvalue of H is positive (a
    saddle with an even number of negative directions has det H > 0)."""
    m = H.shape[0]
    nan = torch.full((), torch.nan, dtype=H.dtype, device=H.device)
    if not _sync.host(torch.all(torch.isfinite(H)), "laplace"):
        # a non-finite Hessian (failed solves at the peak): the eigenvalues
        # are nan, as jnp.linalg.eigvalsh gives them; torch would raise
        HESSIAN_EIGENVALUES.append(nan.expand(m))
        return nan, nan
    lam = torch.linalg.eigvalsh(H)
    HESSIAN_EIGENVALUES.append(lam)
    logdet = torch.where(torch.all(lam > 0),
                         torch.sum(torch.log(torch.clamp(lam, min=1e-300))),
                         nan)
    return (log_peak - log_volume + 0.5 * m * math.log(2.0 * math.pi)
            - 0.5 * logdet), logdet


def _evidence_profiled_impl(cov: Covariance, theta_hat, x, y, sigma_n: float,
                            box: FlatBox, jeffreys_norm: float = 1.0,
                            jitter: float = 1e-10, backend: str = "iterative",
                            key=None,
                            solver_opts: eng.SolverOpts = eng.SolverOpts(),
                            op=None) -> LaplaceResult:
    """Laplace evidence with sigma_f marginalised analytically."""
    if backend == "dense":
        raise _pending.pending(f"evidence on backend {backend!r}",
                               _pending.DENSE)
    n = int(y.shape[0])
    theta_hat = torch.as_tensor(theta_hat, dtype=x.dtype, device=x.device)
    solver = eng.make_solver(backend, cov, theta_hat, x, y, sigma_n, key=key,
                             jitter=jitter, opts=solver_opts, op=op)
    lp_max = eng.profiled_loglik(solver)
    grad = eng.grad_fn(backend, cov, x, y, sigma_n, key=key, jitter=jitter,
                       opts=solver_opts, op=op)
    ddlp = eng.fd_hessian(grad, theta_hat, step=solver_opts.fd_step)
    sf_hat = torch.sqrt(solver.sigma2_hat())
    lp_marg = lp_max + hl.marginal_const(n, jeffreys_norm)
    H = -ddlp
    log_v = log_prior_volume(cov, box)
    log_z, logdet = _laplace_log_z(lp_marg, log_v, H)
    H_inv, info = torch.linalg.inv_ex(H)     # singular H: nan, no raise
    errors = torch.where(info == 0, torch.sqrt(torch.clamp(
        torch.diagonal(H_inv), min=0.0)), torch.full_like(theta_hat,
                                                          torch.nan))
    return LaplaceResult(log_z, lp_marg, theta_hat, H, errors, log_v, logdet,
                         sf_hat)


class MultimodalResult(NamedTuple):
    log_z: float              # ln sum_k Z_k over distinct modes
    n_modes: int
    modes: np.ndarray         # (k, m) deduplicated mode locations
    log_z_modes: np.ndarray   # (k,) per-mode ln Z (nan where H not PD)
    best: Optional[LaplaceResult]  # result at the highest-evidence mode


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def dedupe_modes(theta_all, log_p_all, dedupe_tol: float = 0.05,
                 lp_window: float = 15.0) -> list[np.ndarray]:
    """Distinct restart peaks: best first, L_inf-deduplicated, and within
    ``lp_window`` nats of the best (host side)."""
    thetas = _host(theta_all)
    lps = _host(log_p_all)
    best_lp = np.nanmax(lps)
    order = np.argsort(-np.where(np.isnan(lps), -np.inf, lps),
                       kind="stable")
    modes: list[np.ndarray] = []
    for i in order:
        if not np.isfinite(lps[i]) or lps[i] < best_lp - lp_window:
            continue
        if any(np.max(np.abs(thetas[i] - m)) < dedupe_tol for m in modes):
            continue
        modes.append(thetas[i])
    return modes


def logsumexp_modes(log_zs: np.ndarray) -> float:
    """ln sum_k Z_k over finite per-mode evidences (nan if none finite)."""
    finite = np.isfinite(log_zs)
    if not finite.any():
        return float("nan")
    zmax = log_zs[finite].max()
    return float(zmax + np.log(np.sum(np.exp(log_zs[finite] - zmax))))


def _evidence_multimodal_impl(cov: Covariance, theta_all, log_p_all, x, y,
                              sigma_n: float, box: FlatBox,
                              jeffreys_norm: float = 1.0,
                              jitter: float = 1e-10,
                              dedupe_tol: float = 0.05,
                              lp_window: float = 15.0,
                              backend: str = "iterative", key=None,
                              solver_opts: eng.SolverOpts = eng.SolverOpts(),
                              op=None) -> MultimodalResult:
    """ln Z ~= ln sum_k Z_k over the distinct restart peaks; modes whose
    Hessian is not positive definite contribute nothing."""
    modes = dedupe_modes(theta_all, log_p_all, dedupe_tol, lp_window)
    results = [_evidence_profiled_impl(cov, m, x, y, sigma_n, box,
                                       jeffreys_norm, jitter,
                                       backend=backend, key=key,
                                       solver_opts=solver_opts, op=op)
               for m in modes]
    log_zs = np.asarray([float(r.log_z) for r in results])
    finite = np.isfinite(log_zs)
    if finite.any():
        log_z = logsumexp_modes(log_zs)
        best = results[int(np.flatnonzero(finite)[
            np.argmax(log_zs[finite])])]
    else:
        log_z = float("nan")
        best = results[0] if results else None
    return MultimodalResult(log_z=log_z, n_modes=len(modes),
                            modes=np.asarray(modes), log_z_modes=log_zs,
                            best=best)


def log_bayes_factor(za: LaplaceResult, zb: LaplaceResult):
    """ln B = ln Z_a - ln Z_b; > 0 favours model a (paper Table 1)."""
    return za.log_z - zb.log_z
