"""The matrix-free GP solver engine.

Counterpart of ``repro/core/engine.py``: :class:`IterativeSolver` serves
every quantity of the paper's workflow — solves, ln det K, sigma_f_hat^2
(eq. 2.15) and the stacked gradient terms of eq. (2.17) — from batched CG,
SLQ (plain or preconditioned) and Hutchinson probes over the bound linear
operator.  On the tile operator every matrix access is a B1 or B2 launch;
on a fused SKI operator (a gappy record) a B5 or B6 launch; on a fused
product-SKI operator (a gappy 2-D field) a B10 or B11 launch; on
scattered (n, d) data a B8 or B9 launch; K is never stored.  The
stochastic backend (:mod:`.stochastic`) serves the same quantities from
mini-batch row slabs (B12, B13).  Backends and options that the port
does not run yet raise and name the slice that brings them.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Union

import torch

from .. import _pending
from .. import random as rnd
from . import iterative as it
from . import stochastic as _stochastic
from ..kernels import operators as kopers
from ..kernels import ops as kops
from .covariances import Covariance

LOG2PI = math.log(2.0 * math.pi)

BACKENDS = ("dense", "iterative", "stochastic")


class SolverOpts(NamedTuple):
    """Matrix-free backend knobs; the same fields and defaults as the JAX
    package.  Ported: operator None/"pallas"/"toeplitz"/"ski", precond
    None/"auto"/"circulant" with precond_rank 0, fused, and the stochastic
    backend's batch_size, n_epochs, nystrom_rank, mem_budget_mb (the
    card's memory) and momentum.  fused_tile_mb is checked and carried for
    parity, not read (the JAX package's VMEM budget has no counterpart)."""

    n_probes: int = 16
    lanczos_k: int = 64
    cg_tol: float = 1e-8
    cg_max_iter: int = 800
    precond_rank: int = 0
    fd_step: float = 1e-4
    operator: Optional[str] = None
    precond: Optional[str] = None
    fused: Union[bool, str] = "auto"
    batch_size: int = 0
    n_epochs: int = 0
    nystrom_rank: int = 0
    mem_budget_mb: int = 1024
    momentum: float = 0.0
    fused_tile_mb: int = 0


class IterativeSolver:
    """Matrix-free path: bound operator + batched CG + SLQ + Hutchinson.

    One batched CG solves [y | z_1..z_p] together; the probes serve both
    the SLQ log-det and the Hutchinson traces, and one stacked tangent
    launch gives all m directions of eq. (2.17).  Solves are lazy: a
    value-only evaluation pays one 1-RHS CG.

    ``probes=(z_hutch, z_slq)`` replaces the two probe blocks drawn from
    ``key`` (for unit tests).
    """

    backend = "iterative"

    def __init__(self, kind: str, theta, x, y, sigma_n: float, key,
                 jitter: float = 1e-8, opts: SolverOpts = SolverOpts(),
                 op=None, probes=None):
        self.kind = kind
        self.theta = theta
        self.x = x
        self.y = y
        self.sigma_n = sigma_n
        self.jitter = jitter
        self.key = key
        self.opts = opts
        self.n = int(y.shape[0])
        self.op = op if op is not None else kopers.select_operator(
            kind, x, sigma_n, jitter, operator=opts.operator,
            fused=opts.fused)
        self._mv_bound = kopers.bound_gram_matvec(self.op, theta, y.dtype)
        self._precond = it.make_preconditioner(self.op, theta, opts.precond,
                                               opts.precond_rank)
        if probes is not None:
            self.z, self._z_slq = probes
        else:
            self.z = rnd.rademacher(key, (self.n, opts.n_probes),
                                    device=y.device, dtype=y.dtype)
            self._z_slq = None
        self.alpha = None
        self.Kinv_z = None
        self.cg_iters = None
        self.cg_resnorm = None
        self._logdet = None

    def _cg(self, rhs):
        sol = it.cg_solve(self._mv_bound, rhs, tol=self.opts.cg_tol,
                          max_iter=self.opts.cg_max_iter,
                          precond=self._precond.apply
                          if self._precond is not None else None)
        self.cg_iters = sol.iters
        self.cg_resnorm = torch.max(torch.atleast_1d(sol.resnorm))
        return sol.x

    def _ensure_alpha(self):
        if self.alpha is None:
            self.alpha = self._cg(self.y)
        return self.alpha

    def _ensure_probes(self):
        if self.Kinv_z is None:
            if self.alpha is None:
                sol = self._cg(torch.cat([self.y[:, None], self.z], dim=1))
                self.alpha = sol[:, 0]
                self.Kinv_z = sol[:, 1:]
            else:
                self.Kinv_z = self._cg(self.z)
        return self.Kinv_z

    def solve(self, rhs):
        return self._cg(rhs)

    def logdet(self):
        if self._logdet is None:
            pc = self._precond
            if self._z_slq is not None:
                alphas, betas = it.lanczos(self._mv_bound, self._z_slq,
                                           self.opts.lanczos_k)
                self._logdet = it.slq_plain_logdet(alphas, betas, self.n)
            elif pc is not None and pc.slq is not None:
                # preconditioned SLQ: Lanczos on P^{-1/2} K P^{-1/2}
                self._logdet = it.slq_logdet_precond(
                    self._mv_bound, pc.slq, rnd.fold_in(self.key, 1),
                    n_probes=self.opts.n_probes, k=self.opts.lanczos_k,
                    dtype=self.y.dtype)
            else:
                self._logdet = it.slq_logdet(
                    self._mv_bound, self.n, rnd.fold_in(self.key, 1),
                    n_probes=self.opts.n_probes, k=self.opts.lanczos_k,
                    dtype=self.y.dtype, device=self.y.device)
        return self._logdet

    def quad(self, y):
        return y @ self.solve(y)

    def sigma2_hat(self):
        return (self.y @ self._ensure_alpha()) / self.n

    def grad_terms(self):
        Kinv_z = self._ensure_probes()
        alpha = self.alpha
        V = torch.cat([alpha[:, None], self.z], dim=1)
        dkv = self.op.tangent_matvecs(self.theta, V)        # (m, n, 1+p)
        quad = torch.einsum("j,mj->m", alpha, dkv[:, :, 0])
        tr = torch.mean(torch.einsum("jp,mjp->mp", Kinv_z, dkv[:, :, 1:]),
                        dim=-1)
        return quad, tr


def select_precond(op, opts: SolverOpts = SolverOpts()) -> Optional[str]:
    """Resolved preconditioner choice for one bound operator (the
    ``precond="auto"`` policy, :func:`iterative.resolve_precond`)."""
    return it.resolve_precond(opts.precond, op, opts.precond_rank)


def select_stochastic(op, opts: SolverOpts = SolverOpts()):
    """Resolved stochastic batch/rank/epoch plan for one bound operator
    (:func:`repro_torch.core.stochastic.resolve_stochastic`)."""
    return _stochastic.resolve_stochastic(opts, int(op.n),
                                          float(getattr(op, "noise2", 0.0)))


def select_fused(op) -> bool:
    """Resolved fused-kernel decision for one bound operator (operators
    resolve ``fused`` at construction; this reads it back)."""
    return bool(getattr(op, "fused", False))


def resolve_kind(cov: Covariance) -> str:
    """Covariance-tile registry key for the iterative backend ("a*b"
    composite names when every factor has a tile)."""
    name = cov.name if isinstance(cov, Covariance) else str(cov)
    if "*" in name:
        try:
            kops.split_kind(name)
        except ValueError:
            raise ValueError(
                f"composite covariance {name!r} has a factor with no "
                f"registered tile, so the iterative backend cannot "
                f"evaluate it matrix-free; registered kinds: "
                f"{sorted(kops._FLAT_TO_NATURAL)}") from None
        return name
    if name not in kops._FLAT_TO_NATURAL:
        raise ValueError(
            f"covariance {name!r} has no registered tile, so the iterative "
            f"backend cannot evaluate it matrix-free; registered kinds: "
            f"{sorted(kops._FLAT_TO_NATURAL)}")
    return name


def make_solver(backend: str, cov: Covariance, theta, x, y, sigma_n: float,
                key=None, jitter: Optional[float] = None,
                opts: SolverOpts = SolverOpts(), op=None, probes=None):
    """The solver for one evaluation point (the iterative and stochastic
    backends; ``probes`` as each solver's own argument)."""
    if backend in ("iterative", "stochastic"):
        if key is None:
            key = rnd.key(0)
        cls = IterativeSolver if backend == "iterative" else \
            _stochastic.StochasticSolver
        return cls(resolve_kind(cov), theta, x, y, sigma_n, key,
                   1e-8 if jitter is None else jitter, opts, op=op,
                   probes=probes)
    if backend == "dense":
        raise _pending.pending("backend 'dense'", _pending.DENSE)
    raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")


def profiled_loglik(solver) -> torch.Tensor:
    """ln P_max of eq. (2.16)."""
    n = solver.n
    return (-0.5 * n * (LOG2PI + 1.0 + torch.log(solver.sigma2_hat()))
            - 0.5 * solver.logdet())


def profiled_grad(solver) -> torch.Tensor:
    """Gradient of ln P_max, eq. (2.17), all m directions stacked."""
    quad, tr = solver.grad_terms()
    return 0.5 * quad / solver.sigma2_hat() - 0.5 * tr


def value_and_grad_fn(backend: str, cov: Covariance, x, y, sigma_n: float,
                      key=None, jitter: Optional[float] = None,
                      opts: SolverOpts = SolverOpts(), op=None) -> Callable:
    """theta -> (ln P_max, gradient), with one fixed probe key so the
    stochastic objective is a smooth function of theta."""

    def vag(theta):
        s = make_solver(backend, cov, theta, x, y, sigma_n, key=key,
                        jitter=jitter, opts=opts, op=op)
        g = profiled_grad(s)       # the batched [y | probes] CG first
        return profiled_loglik(s), g

    return vag


def grad_fn(backend: str, cov: Covariance, x, y, sigma_n: float, key=None,
            jitter: Optional[float] = None, opts: SolverOpts = SolverOpts(),
            op=None) -> Callable:
    """theta -> gradient only (no SLQ)."""

    def grad(theta):
        s = make_solver(backend, cov, theta, x, y, sigma_n, key=key,
                        jitter=jitter, opts=opts, op=op)
        return profiled_grad(s)

    return grad


def value_fn(backend: str, cov: Covariance, x, y, sigma_n: float, key=None,
             jitter: Optional[float] = None, opts: SolverOpts = SolverOpts(),
             op=None) -> Callable:
    """theta -> ln P_max (value only: one 1-RHS CG + SLQ)."""

    def val(theta):
        s = make_solver(backend, cov, theta, x, y, sigma_n, key=key,
                        jitter=jitter, opts=opts, op=op)
        return profiled_loglik(s)

    return val


def fd_hessian(grad_fn: Callable, theta, step: float = 1e-4) -> torch.Tensor:
    """Central-difference Hessian of ln P_max from gradients, symmetrised."""
    m = theta.shape[0]
    eye = torch.eye(m, dtype=theta.dtype, device=theta.device)
    cols = []
    for i in range(m):
        gp = grad_fn(theta + step * eye[i])
        gm = grad_fn(theta - step * eye[i])
        cols.append((gp - gm) / (2.0 * step))
    H = torch.stack(cols, dim=0)
    return 0.5 * (H + H.T)
