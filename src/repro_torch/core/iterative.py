"""Matrix-free solves and log-determinants: batched CG and SLQ.

Counterpart of the plain (unpreconditioned) half of
``repro/core/iterative.py``: every iteration is one multi-vector gram
matvec through the bound operator (on the tile operator, one B1 launch).
The loops are Python loops; where the JAX package's ``while_loop`` tests a
device value, the port reads it back once per iteration (counted in
:mod:`repro_torch._sync`).
"""

from __future__ import annotations

import collections
from typing import Callable, NamedTuple, Optional

import torch

from .. import _pending
from .. import _sync
from .. import random as rnd


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorm: torch.Tensor


# how each CG solve ended ("tol" or "max_iter"), for run reports; a solve
# that reaches max_iter is read back on the host, through _sync, and its
# worst relative residual kept
CG_STOPS: collections.Counter = collections.Counter()
CG_WORST_RESIDUAL = [0.0]


def reset_cg_stops() -> None:
    CG_STOPS.clear()
    CG_WORST_RESIDUAL[0] = 0.0


def cg_solve(matvec: Callable, b, tol: float = 1e-8, max_iter: int = 500,
             precond: Optional[Callable] = None) -> CGResult:
    """Batched CG for SPD systems; b (n,) or (n, k), all columns together.

    Iterates while any column's residual norm exceeds tol * ||b||, at most
    ``max_iter`` times (the JAX package's stopping rule).
    """
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    M = precond or (lambda r: r)
    x = torch.zeros_like(b)
    r = b
    z = M(r)
    p = z
    rz = torch.sum(r * z, dim=0)
    bnorm = torch.linalg.vector_norm(b, dim=0)
    thresh = tol * torch.clamp(bnorm, min=1e-30)
    i = 0
    while i < max_iter and _sync.host(
            torch.any(torch.linalg.vector_norm(r, dim=0) > thresh), "cg"):
        Ap = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap, dim=0), min=1e-300)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.sum(r * z, dim=0)
        beta = rz_new / torch.clamp(rz, min=1e-300)
        p = z + beta * p
        rz = rz_new
        i += 1
    res = torch.linalg.vector_norm(r, dim=0) / torch.clamp(bnorm, min=1e-30)
    if i == max_iter:
        CG_STOPS["max_iter"] += 1
        CG_WORST_RESIDUAL[0] = max(CG_WORST_RESIDUAL[0],
                                   _sync.host(res.max(), "cg_max_iter"))
    else:
        CG_STOPS["tol"] += 1
    if squeeze:
        x = x[:, 0]
        res = res[0]
    return CGResult(x=x, iters=i, resnorm=res)


def lanczos(matvec: Callable, v0, k: int):
    """k-step Lanczos with full reorthogonalisation against the basis.

    v0: (n, p) start vectors.  Returns (alphas (k, p), betas (max(k-1,1), p)).
    """
    n, pb = v0.shape
    Q = torch.zeros((k, n, pb), dtype=v0.dtype, device=v0.device)
    Q[0] = v0 / torch.linalg.vector_norm(v0, dim=0)
    alphas = torch.zeros((k, pb), dtype=v0.dtype, device=v0.device)
    betas = torch.zeros((max(k - 1, 1), pb), dtype=v0.dtype,
                        device=v0.device)
    for i in range(k):
        qi = Q[i]
        w = matvec(qi)
        a = torch.sum(qi * w, dim=0)
        w = w - a * qi
        if i > 0:
            w = w - betas[i - 1] * Q[i - 1]
        proj = torch.einsum("knp,np->kp", Q[: i + 1], w)
        w = w - torch.einsum("kp,knp->np", proj, Q[: i + 1])
        bnorm = torch.linalg.vector_norm(w, dim=0)
        if i + 1 < k:
            Q[i + 1] = w / torch.clamp(bnorm, min=1e-30)
            betas[i] = bnorm
        alphas[i] = a
    return alphas, betas


def slq_logdet(matvec: Callable, n: int, key, n_probes: int = 16,
               k: int = 64, dtype=torch.float64, device=None):
    """ln det K by stochastic Lanczos quadrature with Rademacher probes:
    z^T ln(K) z ~= ||z||^2 sum_i U[0, i]^2 ln(lambda_i) of each tridiagonal.
    """
    z = rnd.rademacher(key, (n, n_probes), device=device, dtype=dtype)
    alphas, betas = lanczos(matvec, z, k)
    return slq_quadrature(alphas, betas, n)


def slq_quadrature(alphas, betas, n: int):
    """n * mean over probes of sum_i U[0, i]^2 ln(lambda_i) of each probe's
    Lanczos tridiagonal (alphas (k, p), betas (k-1, p))."""
    k = alphas.shape[0]
    T = torch.diag_embed(alphas.T)
    if k > 1:
        T = T + torch.diag_embed(betas.T, 1) + torch.diag_embed(betas.T, -1)
    if not _sync.host(torch.all(torch.isfinite(T)), "slq"):
        # a non-finite matvec (e.g. a smoothness at the box edge): the
        # log-det is nan, as jnp.linalg.eigh gives it; torch would raise
        return torch.full((), torch.nan, dtype=T.dtype, device=T.device)
    lam, U = torch.linalg.eigh(T)
    lam = torch.clamp(lam, min=1e-30)
    vals = torch.sum(U[:, 0, :] ** 2 * torch.log(lam), dim=-1)
    return n * torch.mean(vals)


# ---------------------------------------------------------------------------
# Preconditioner selection (only "no preconditioner" is ported)
# ---------------------------------------------------------------------------

PRECONDITIONERS = ("pivchol", "circulant")
PRECOND_CHOICES = PRECONDITIONERS + ("auto",)
PRECOND_AUTO_MIN_N = 2048
PRECOND_AUTO_MIN_COND = 1e6


class Preconditioner(NamedTuple):
    apply: Callable
    slq: Optional[object]
    choice: str


def resolve_precond(precond: Optional[str], op,
                    precond_rank: int = 0) -> Optional[str]:
    """``SolverOpts(precond=...)`` -> concrete choice for one operator.

    "auto" gives the circulant preconditioner only to FFT-structured
    operators at n >= PRECOND_AUTO_MIN_N and n / noise2 >=
    PRECOND_AUTO_MIN_COND; the scattered-data tile operator stays
    unpreconditioned.
    """
    if precond is None:
        return "pivchol" if precond_rank > 0 else None
    if precond == "auto":
        noise2 = float(getattr(op, "noise2", 0.0))
        cond_probe = float(op.n) / max(noise2, 1e-300)
        if getattr(op, "name", None) in ("toeplitz", "ski", "kron",
                                         "product_ski") \
                and int(op.n) >= PRECOND_AUTO_MIN_N \
                and cond_probe >= PRECOND_AUTO_MIN_COND:
            return "circulant"
        return None
    if precond in PRECONDITIONERS:
        return precond
    raise ValueError(f"unknown preconditioner {precond!r}; choose from "
                     f"{PRECOND_CHOICES} or None")


def make_preconditioner(op, theta, precond: Optional[str] = None,
                        precond_rank: int = 0) -> Optional[Preconditioner]:
    """The resolved preconditioner, or None for unpreconditioned CG."""
    choice = resolve_precond(precond, op, precond_rank)
    if choice is None:
        return None
    if choice == "pivchol":
        raise _pending.pending("the pivoted-Cholesky preconditioner",
                               _pending.PIVCHOL)
    raise _pending.pending("the circulant preconditioner", _pending.GRID)
