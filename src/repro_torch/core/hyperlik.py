"""Hyperlikelihood, analytic gradient and Hessian (paper Sec. 2).

Counterpart of ``repro/core/hyperlik.py``: after one O(n^3) Cholesky
factorisation of K (a :class:`FactorCache`), the hyperlikelihood (eq. 2.5),
its gradient (eq. 2.7), its Hessian (eq. 2.9) and the sigma_f-profiled
variants (eqs. 2.14-2.19) cost O(m n^2) / O(m^2 n^2) more.  Derivatives of
K are forward-mode directional derivatives of the covariance builder
(``torch.func.jvp``; all m directions at once under ``torch.func.vmap``),
never derivatives through the Cholesky.

A Cholesky that fails (K not positive definite in floating point) gives a
factor of nan, as ``jnp.linalg.cholesky`` does, and not an exception: the
value is then nan, which the trainer's line search reads as +inf.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jvp, vmap

from .covariances import Covariance, build_K

LOG2PI = math.log(2.0 * math.pi)


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of K, or of each matrix of a batch; a matrix
    whose factorisation fails gets a factor of nan."""
    L, info = torch.linalg.cholesky_ex(K)
    bad = (info > 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, math.nan), L)


class FactorCache(NamedTuple):
    """Everything derivable from one Cholesky factorisation of K.

    L: lower factor of the unit-scale K (eq. 2.14); alpha: K^-1 y;
    Kinv: K^-1 (None until :func:`with_inverse`: value-only evaluations
    never pay for it); logdet: ln det K; yKy: y^T K^-1 y; sigma2_hat: the
    profiled scale yKy / n (eq. 2.15).
    """

    L: torch.Tensor
    alpha: torch.Tensor
    Kinv: Optional[torch.Tensor]
    logdet: torch.Tensor
    yKy: torch.Tensor
    sigma2_hat: torch.Tensor


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K^-1 b from K's lower factor, for (n,) or (n, k) b."""
    if b.ndim == 1:
        return torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.cholesky_solve(b, L)


def factorize(K: torch.Tensor, y: torch.Tensor) -> FactorCache:
    """One O(n^3) factorisation; the rate-determining step (Sec. 2a)."""
    L = cholesky(K)
    alpha = cho_solve(L, y)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    yKy = y @ alpha
    return FactorCache(L, alpha, None, logdet, yKy, yKy / y.shape[0])


def with_inverse(cache: FactorCache) -> FactorCache:
    """Attach the explicit inverse (one extra O(n^3) solve) if missing."""
    if cache.Kinv is not None:
        return cache
    L = cache.L
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return cache._replace(Kinv=torch.cholesky_solve(eye, L))


def _kbuilder(cov: Covariance, x, sigma_n: float,
              jitter: float = 1e-10) -> Callable:
    """theta -> unit-scale K(theta).  The noise term does not depend on
    theta, so the builder's tangents are those of the bare covariance."""

    def kfun(theta):
        return build_K(cov, theta, x, sigma_n, jitter)

    return kfun


def _basis(theta: torch.Tensor, i: int) -> torch.Tensor:
    e = torch.zeros_like(theta)
    e[i] = 1.0
    return e


def _dK(kfun: Callable, theta: torch.Tensor, i: int) -> torch.Tensor:
    """dK/dtheta_i by one forward-mode pass (O(n^2))."""
    return jvp(kfun, (theta,), (_basis(theta, i),))[1]


def _dK_stacked(kfun: Callable, theta: torch.Tensor) -> torch.Tensor:
    """(m, n, n) stack of dK/dtheta_i for every basis direction: one
    forward-mode pass vmapped over the m tangents (the primal work runs
    once)."""
    eye = torch.eye(theta.shape[0], dtype=theta.dtype, device=theta.device)
    return vmap(lambda e: jvp(kfun, (theta,), (e,))[1])(eye)


def _d2K(kfun: Callable, theta: torch.Tensor, i: int,
         j: int) -> torch.Tensor:
    """d^2K/dtheta_i dtheta_j by forward mode nested in forward mode."""
    return jvp(lambda t: _dK(kfun, t, i), (theta,),
               (_basis(theta, j),))[1]


# ---------------------------------------------------------------------------
# Full hyperlikelihood (sigma_f explicit): eqs. 2.5, 2.7, 2.9
# ---------------------------------------------------------------------------

def loglik(cov: Covariance, theta, x, y, sigma_n: float,
           jitter: float = 1e-10):
    """ln P(y | x, theta) of eq. (2.5) with sigma_f = 1; returns
    (value, cache)."""
    cache = factorize(build_K(cov, theta, x, sigma_n, jitter), y)
    n = y.shape[0]
    return -0.5 * (cache.yKy + cache.logdet + n * LOG2PI), cache


def loglik_scaled(cov: Covariance, theta, log_sigma_f, x, y, sigma_n: float,
                  jitter: float = 1e-10):
    """Eq. (2.14): the hyperlikelihood with an explicit scale,
    -yKy / (2 sf^2) - ln det K / 2 - n/2 ln(2 pi sf^2)."""
    cache = factorize(build_K(cov, theta, x, sigma_n, jitter), y)
    n = y.shape[0]
    log_sigma_f = torch.as_tensor(log_sigma_f, dtype=cache.yKy.dtype,
                                  device=cache.yKy.device)
    sf2 = torch.exp(2.0 * log_sigma_f)
    val = (-0.5 * cache.yKy / sf2 - 0.5 * cache.logdet
           - 0.5 * n * (LOG2PI + 2.0 * log_sigma_f))
    return val, cache


def loglik_grad(cov: Covariance, theta, x, y, sigma_n: float,
                cache: FactorCache, jitter: float = 1e-10):
    """Eq. (2.7): g_i = a^T dK_i a / 2 - tr(K^-1 dK_i) / 2, the trace as
    the elementwise sum of K^-1 * dK_i (both symmetric)."""
    cache = with_inverse(cache)
    dKs = _dK_stacked(_kbuilder(cov, x, sigma_n, jitter), theta)
    a = cache.alpha
    return (0.5 * torch.einsum("i,mij,j->m", a, dKs, a)
            - 0.5 * torch.einsum("ij,mij->m", cache.Kinv, dKs))


def _hessian(cov, theta, x, sigma_n, cache, jitter, profiled: bool, n: int):
    """Eqs. (2.9) and (2.19) from one dK stack, K^-1 dK_i once per
    direction and d2K_ij once per pair (the matrix is filled
    symmetrically)."""
    cache = with_inverse(cache)
    kfun = _kbuilder(cov, x, sigma_n, jitter)
    m = cov.n_params
    a = cache.alpha
    Kinv = cache.Kinv
    s2 = cache.sigma2_hat if profiled else 1.0
    dKs = _dK_stacked(kfun, theta)                     # (m, n, n)
    dKa = torch.einsum("mij,j->mi", dKs, a)            # dK_i a
    KidKa = torch.einsum("ij,mj->mi", Kinv, dKa)       # K^-1 dK_i a
    quadv = torch.einsum("i,mi->m", a, dKa)            # a^T dK_i a
    S = torch.einsum("ij,mjk->mik", Kinv, dKs)         # K^-1 dK_i
    H = torch.zeros((m, m), dtype=a.dtype, device=a.device)
    for i in range(m):
        for j in range(i, m):
            d2 = _d2K(kfun, theta, i, j)
            quad = -0.5 * (2.0 * (dKa[i] @ KidKa[j]) - a @ (d2 @ a)) / s2
            tr = 0.5 * (torch.sum(S[i].T * S[j]) - torch.sum(Kinv * d2))
            if profiled:
                v = 0.5 * quadv[i] * quadv[j] / (n * s2 * s2) + quad + tr
            else:
                v = quad + tr
            H[i, j] = v
            H[j, i] = v
    return H


def loglik_hessian(cov: Covariance, theta, x, y, sigma_n: float,
                   cache: FactorCache, jitter: float = 1e-10):
    """Eq. (2.9): the Hessian of ln P at theta (dd ln P, i.e. -H):
    -1/2 [2 a^T dK_i K^-1 dK_j a - a^T d2K_ij a]
    + 1/2 [tr(S_i S_j) - tr(K^-1 d2K_ij)], S_i = K^-1 dK_i."""
    return _hessian(cov, theta, x, sigma_n, cache, jitter, False,
                    y.shape[0])


# ---------------------------------------------------------------------------
# sigma_f profiled out analytically: eqs. 2.14-2.19
# ---------------------------------------------------------------------------

def profiled_loglik(cov: Covariance, theta, x, y, sigma_n: float,
                    jitter: float = 1e-10):
    """ln P_max of eq. (2.16): -n/2 ln(2 pi e sigma_hat^2) - ln det K / 2;
    returns (value, cache)."""
    cache = factorize(build_K(cov, theta, x, sigma_n, jitter), y)
    n = y.shape[0]
    val = (-0.5 * n * (LOG2PI + 1.0 + torch.log(cache.sigma2_hat))
           - 0.5 * cache.logdet)
    return val, cache


def profiled_grad(cov: Covariance, theta, x, y, sigma_n: float,
                  cache: FactorCache, jitter: float = 1e-10):
    """Eq. (2.17): the gradient of ln P_max (not eq. 2.7)."""
    cache = with_inverse(cache)
    dKs = _dK_stacked(_kbuilder(cov, x, sigma_n, jitter), theta)
    a = cache.alpha
    return (0.5 * torch.einsum("i,mij,j->m", a, dKs, a) / cache.sigma2_hat
            - 0.5 * torch.einsum("ij,mij->m", cache.Kinv, dKs))


def profiled_hessian(cov: Covariance, theta, x, y, sigma_n: float,
                     cache: FactorCache, jitter: float = 1e-10):
    """Eq. (2.19): the Hessian of ln P_marg (= ln P_max + const), i.e.
    dd ln P_max, the negative of eq. (2.13)'s H."""
    return _hessian(cov, theta, x, sigma_n, cache, jitter, True, y.shape[0])


# the most bytes of K that the scan builds at once: 1 GB on the card; on the
# CPU 8 MB, since larger chunks spill the caches (3x slower at n = 328)
SCAN_CHUNK_BYTES = {"cuda": 1 << 30, "cpu": 8 << 20}


def profiled_loglik_batch(cov: Covariance, thetas, x, y, sigma_n: float,
                          jitter: float = 1e-10) -> torch.Tensor:
    """ln P_max at each row of ``thetas`` (the trainer's scan, the nested
    sampler's chain steps): K for a chunk of rows at once, at most
    :data:`SCAN_CHUNK_BYTES` of K a chunk on y's device, one batched
    Cholesky each; a row whose factorisation fails gives nan.

    y^T K^-1 y is |L^-1 y|^2, one batched triangular solve (cuBLAS on the
    card): ``cholesky_solve`` on a batch goes to MAGMA there, which
    allocates device memory inside the call, so no CUDA graph could hold
    it."""
    n = y.shape[0]
    max_bytes = SCAN_CHUNK_BYTES.get(y.device.type, 1 << 30)
    step = max(1, max_bytes // (n * n * y.element_size()))
    kb = vmap(_kbuilder(cov, x, sigma_n, jitter))
    vals = []
    for lo in range(0, thetas.shape[0], step):
        L = cholesky(kb(thetas[lo:lo + step]))
        z = torch.linalg.solve_triangular(
            L, y[None, :, None].expand(L.shape[0], n, 1), upper=False)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(
            L, dim1=-2, dim2=-1)), dim=-1)
        s2 = torch.sum(z[..., 0] ** 2, dim=-1) / n
        vals.append(-0.5 * n * (LOG2PI + 1.0 + torch.log(s2))
                    - 0.5 * logdet)
    return torch.cat(vals)


def marginal_const(n: int, jeffreys_norm: float = 1.0) -> float:
    """ln of the constant relating P_marg to P_max, eq. (2.18):
    P_marg = c/2 (2e/n)^{n/2} Gamma(n/2) P_max, c the Jeffreys
    normalisation.  Model-independent (cancels in Bayes factors)."""
    n = float(n)
    return (math.log(jeffreys_norm / 2.0)
            + 0.5 * n * (math.log(2.0) + 1.0 - math.log(n))
            + math.lgamma(0.5 * n))


def sigma_f_hat(cache: FactorCache):
    """Eq. (2.15): the closed-form maximising scale."""
    return torch.sqrt(cache.sigma2_hat)
