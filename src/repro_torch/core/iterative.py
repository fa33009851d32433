"""Matrix-free solves and log-determinants: batched CG, SLQ and their
preconditioned forms.

Counterpart of ``repro/core/iterative.py`` (the pivoted-Cholesky
preconditioner excepted): every iteration is one multi-vector gram matvec
through the bound operator (on the tile operator one B1 launch, on a fused
SKI operator one B5 launch).  The loops are Python loops; where the JAX
package's ``while_loop`` tests a device value, the port reads it back once
per iteration (counted in :mod:`repro_torch._sync`).
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
    return slq_plain_logdet(alphas, betas, n)


def slq_plain_logdet(alphas, betas, n: int):
    """The plain SLQ estimate from Rademacher-probe Lanczos tridiagonals
    (alphas (k, p), betas (k-1, p)): n * mean over probes of
    sum_i U[0, i]^2 ln(lambda_i)."""
    ones = alphas.new_ones(alphas.shape[1])
    return n * torch.mean(slq_quadrature(alphas, betas, ones))


def slq_quadrature(alphas, betas, unorm2):
    """Per-probe Gauss quadrature of the (preconditioned) Lanczos
    tridiagonals: vals_p = unorm2_p sum_i U[0, i]^2 ln(lambda_i(T_p)).

    A probe whose tridiagonal is not finite (a non-finite matvec, e.g. a
    smoothness at the box edge) gets nan, as ``jnp.linalg.eigh`` gives it
    probe by probe; torch's ``eigh`` would raise, so such a T is replaced
    by the identity before the decomposition and its value set to nan
    after it.  The other probes (in a bank, the other members) keep
    theirs."""
    k = alphas.shape[0]
    T = torch.diag_embed(alphas.T)
    if k > 1:
        T = T + torch.diag_embed(betas.T, 1) + torch.diag_embed(betas.T, -1)
    finite = torch.all(torch.isfinite(T).flatten(1), dim=1)      # (p,)
    eye = torch.eye(k, dtype=T.dtype, device=T.device)
    lam, U = torch.linalg.eigh(torch.where(finite[:, None, None], T, eye))
    lam = torch.clamp(lam, min=1e-30)
    vals = unorm2 * torch.sum(U[:, 0, :] ** 2 * torch.log(lam), dim=-1)
    return torch.where(finite, vals, torch.full_like(vals, torch.nan))


def preconditioned_lanczos(matvec: Callable, pinv: Callable, z0, k: int):
    """k-step Lanczos on M = P^{-1/2} K P^{-1/2} without square roots.

    In the basis z_j = P^{1/2} u_j, s_j = P^{-1} z_j every step needs one K
    matvec and one P^{-1} apply:

        alpha_j = s_j^T K s_j,
        beta_j z_{j+1} = K s_j - alpha_j z_j - beta_{j-1} z_{j-1},

    normalised by z_j^T s_j = 1, fully reorthogonalised in the P^{-1}
    inner product against the stored s-basis.  z0: (n, p) start block
    with E[z z^T] = P.  Returns (alphas (k, p), betas (k-1, p), unorm2
    (p,)), unorm2 = z0^T P^{-1} z0.
    """
    n, pb = z0.shape
    s_raw = pinv(z0)
    unorm2 = torch.sum(z0 * s_raw, dim=0)
    beta0 = torch.sqrt(torch.clamp(unorm2, min=1e-300))
    Z = z0.new_zeros((k, n, pb))
    S = z0.new_zeros((k, n, pb))
    Z[0] = z0 / beta0
    S[0] = s_raw / beta0
    alphas = z0.new_zeros((k, pb))
    betas = z0.new_zeros((max(k - 1, 1), pb))
    for i in range(k):
        zi, si = Z[i], S[i]
        w = matvec(si)
        a = torch.sum(si * w, dim=0)
        w = w - a * zi
        if i > 0:
            w = w - betas[i - 1] * Z[i - 1]
        proj = torch.einsum("knp,np->kp", S[: i + 1], w)
        w = w - torch.einsum("kp,knp->np", proj, Z[: i + 1])
        alphas[i] = a
        if i + 1 < k:
            wp = pinv(w)
            b = torch.sqrt(torch.clamp(torch.sum(w * wp, dim=0), min=1e-300))
            Z[i + 1] = w / b
            S[i + 1] = wp / b
            betas[i] = b
    return alphas, betas, unorm2


def slq_logdet_precond(matvec: Callable, slq_pre, key, n_probes: int = 16,
                       k: int = 16, dtype=torch.float64):
    """ln det K = ln det P + tr ln(P^{-1/2} K P^{-1/2}), estimated.

    Probes z ~ N(0, P) (``slq_pre.sample``); the estimate is
    mean_z[(z^T P^{-1} z) sum_i U[0, i]^2 ln lambda_i(T)] with T the
    preconditioned-Lanczos tridiagonal.  ``slq_pre`` is an
    :class:`~repro_torch.kernels.operators.SLQPrecond`.
    """
    z = slq_pre.sample(key, n_probes).to(dtype)
    alphas, betas, unorm2 = preconditioned_lanczos(
        matvec, lambda r: slq_pre.apply_inv(r).to(dtype), z, k)
    vals = slq_quadrature(alphas, betas, unorm2)
    return slq_pre.logdet.to(dtype) + torch.mean(vals)


# ---------------------------------------------------------------------------
# Preconditioners (the circulant one is ported, pivoted Cholesky is not)
# ---------------------------------------------------------------------------

def circulant_precond_for_operator(op, theta, floor: float = 1e-12
                                   ) -> Callable:
    """Circulant preconditioner via the operator's own
    ``circulant_precond(theta)`` hook."""
    return op.circulant_precond(theta, floor)


PRECONDITIONERS = ("pivchol", "circulant")
PRECOND_CHOICES = PRECONDITIONERS + ("auto",)
# The "auto" policy's thresholds are the JAX package's, verbatim: they
# decide which log-det estimator runs, so parity needs them.  They are the
# reference's policy, not measurements on the card.
PRECOND_AUTO_MIN_N = 2048
PRECOND_AUTO_MIN_COND = 1e6


class Preconditioner(NamedTuple):
    """apply: r -> P_cg^{-1} r for CG; slq: the SLQPrecond accessors when
    the structure has them (else plain SLQ); choice: the resolved name."""

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
    """The resolved preconditioner, or None for unpreconditioned CG.

    "circulant": the structure's own Strang-type FFT apply, with the SLQ
    accessors where the operator has ``slq_precond`` (Toeplitz; SKI on a
    gappy record).
    """
    choice = resolve_precond(precond, op, precond_rank)
    if choice is None:
        return None
    if choice == "pivchol":
        raise _pending.pending("the pivoted-Cholesky preconditioner",
                               _pending.PIVCHOL)
    apply = circulant_precond_for_operator(op, theta)
    slq_hook = getattr(op, "slq_precond", None)
    return Preconditioner(apply,
                          slq_hook(theta) if slq_hook is not None else None,
                          "circulant")
