"""EigenPro-style stochastic solver backend.

Counterpart of ``repro/core/stochastic.py``: the third solver backend, for
structure-free data at large n.  Irregular inputs have no Toeplitz, SKI or
Kronecker structure, so a CG iteration costs a full O(n^2) tile sweep;
this backend replaces CG by mini-batch preconditioned-gradient iteration
on (K + sigma^2 I) A = RHS:

  * one update samples b rows m and computes the batch gradient
    g = K[m, :] A + sigma^2 A[m] - RHS[m] through the row-slab kernel
    (:func:`repro_torch.kernels.ops.matvec_rows`, B12; B13 for a
    composite kind): b n kernel entries per step, an epoch of n / b
    steps costs one full matvec;
  * the preconditioner deflates the top q eigendirections of the
    pivoted-Cholesky (Nystrom) factor K ~ L L^T: eigh(L^T L) = W S^2 W^T
    gives the orthonormal basis U = L W S^-1 and the eigenvalue estimates
    lambda = S^2; the step shrinks the top of the spectrum to lambda_q
    (arXiv:1703.10622);
  * each solve is warm-started at the Woodbury apply (L L^T + sigma^2 I)^-1
    RHS, column by column only where one exact row sweep shows that the
    warm start beats the zero start;
  * ln det is the deflation spectrum plus a matched-trace tail, and the
    gradient traces are the Hutchinson probes of the iterative backend:
    [y | probes] are solved together, then one stacked tangent launch (B2;
    B9 for a composite kind).

The loops are Python loops over kernel launches.  The fixed-epoch loop
reads nothing back; the adaptive loop reads one scalar per epoch to
decide whether to stop (counted in :mod:`repro_torch._sync`).
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from .. import _sync
from .. import random as rnd
from . import iterative as it
from ..kernels import operators as kopers
from ..kernels import ops as kops

# backend="auto" escalation point: an irregular ("pallas" operator) fit at
# n >= STOCHASTIC_AUTO_MIN_N binds this backend (gp.GP.bind); the JAX
# package's threshold, verbatim
STOCHASTIC_AUTO_MIN_N = 65536

_DEFAULT_EPOCHS = 12
_MIN_BATCH = 8
_MAX_BATCH = 4096
PERM_KEY = 0x57ec    # fold-in constant of the epoch permutations

# epochs -> how many solves used that many, for run reports
EPOCH_COUNTS: collections.Counter = collections.Counter()


def reset_epoch_counts() -> None:
    EPOCH_COUNTS.clear()


class StochasticPlan(NamedTuple):
    """What :func:`resolve_stochastic` decides for one (n, noise2, budget)."""

    batch: int          # rows per mini-batch update
    rank: int           # Nystrom / pivoted-Cholesky factor size q
    epochs: int         # sweeps per solve (the cap when adaptive)
    adaptive: bool = False   # residual-driven early stop (n_epochs = 0)
    tol: float = 0.01        # relative-residual stop of the adaptive loop


def resolve_stochastic(opts, n: int, noise2: float) -> StochasticPlan:
    """The memory-budgeted batch, rank and epoch policy (host side), the
    JAX package's: ``mem_budget_mb`` bounds the card's memory here.

    * rank: ``nystrom_rank`` if set, else the noise-to-signal ladder
      (:func:`repro_torch.core.iterative.resolve_rank`), capped so that
      three (n, q) float64 buffers fit the budget;
    * batch: ``batch_size`` if set, else the largest power of two whose
      (b, n) float64 slab fits the budget, in [8, 4096] and at most n / 8
      (at least 8 steps per epoch);
    * epochs: ``n_epochs`` sweeps if set, else up to 12 with the
      adaptive stop at ``max(cg_tol, 1e-2)``.
    """
    n = max(int(n), 1)
    budget = max(int(opts.mem_budget_mb), 1) * (1 << 20)
    rank_cap = max(2, budget // (3 * 8 * n))
    rank = (int(opts.nystrom_rank) if opts.nystrom_rank > 0
            else it.resolve_rank(noise2, n))
    rank = max(2, min(rank, rank_cap, n))
    if opts.batch_size > 0:
        batch = int(opts.batch_size)
    else:
        cap = max(_MIN_BATCH, budget // (8 * n))
        batch = min(1 << (cap.bit_length() - 1), _MAX_BATCH)
        batch = min(batch, max(_MIN_BATCH, n // 8))
    batch = max(1, min(batch, n))
    if opts.n_epochs > 0:
        return StochasticPlan(batch, rank, int(opts.n_epochs))
    return StochasticPlan(batch, rank, _DEFAULT_EPOCHS, adaptive=True,
                          tol=max(float(opts.cg_tol), 1e-2))


class StochasticSolver:
    """Mini-batch EigenPro iteration behind the solver contract
    (``solve``, ``logdet``, ``sigma2_hat``, ``grad_terms``).

    Bound to one (theta, x, y) like the other backends; the deflation
    eigensystem is built once here and shared by every solve, the log-det
    and the gradient traces.  ``probes`` ((n, p)) replaces the Rademacher
    block drawn from ``key`` (for unit tests).  ``group`` (a
    ``torch.distributed`` process group) splits each row slab's column
    axis over the group's ranks
    (:func:`repro_torch.core.distributed.sharded_rows_matvec`: every rank
    runs the row-slab kernel on its column shard and the (b, k) partials
    are summed); A and the batch coordinates stay replicated.
    """

    backend = "stochastic"

    def __init__(self, kind: str, theta, x, y, sigma_n: float, key,
                 jitter: float = 1e-8, opts=None, op=None, probes=None,
                 group=None):
        from .engine import SolverOpts

        self.kind = kind
        self.theta = theta
        self.x = x
        self.y = y
        self.sigma_n = sigma_n
        self.jitter = jitter
        self.key = key if key is not None else rnd.key(0)
        self.opts = opts if opts is not None else SolverOpts()
        self.n = int(y.shape[0])
        # the operator supplies the diag/matcol oracles and the stacked
        # tangent launch; the row slabs go through kops.matvec_rows on the
        # exact kernel whatever the operator
        self.op = op if op is not None else kopers.PallasTileOperator(
            kind, x, sigma_n, jitter)
        self.noise2 = float(self.op.noise2)
        self.plan = resolve_stochastic(self.opts, self.n, self.noise2)
        self._sharded_rows = None
        if group is not None:
            from .distributed import sharded_rows_matvec
            self._sharded_rows = sharded_rows_matvec(kind, group)

        # the deflation eigensystem, once per theta
        diag = self.op.diag(theta)
        L = it.pivoted_cholesky(diag, lambda i: self.op.matcol(theta, i),
                                self.plan.rank)
        self._warm = it._woodbury_apply(
            L, it._woodbury_factor(L, self.noise2), self.noise2)
        S2, W = torch.linalg.eigh(L.T @ L)
        lam = torch.clamp(torch.flip(S2, (0,)), min=1e-30)   # descending
        W = torch.flip(W, (1,))
        self.lam = lam
        self.U = L @ (W / torch.sqrt(lam)[None, :])          # (n, q)
        tail = lam[-1]
        # shrink factors 1 - (lambda_q + s2) / (lambda_j + s2); the q-th
        # direction is the new top and keeps 0
        self._dvec = torch.clamp(
            1.0 - (tail + self.noise2) / (lam + self.noise2), min=0.0)
        self._trK = torch.sum(diag)

        # the trace-bounded EigenPro step (arXiv:1703.10622 eq. 12, in K/n
        # units): with E = K - L L^T (positive semi-definite), the deflated
        # top is at most tail + tr E + s2, and tr E = tr K - sum lambda
        resid_tr = torch.clamp(self._trK - torch.sum(lam), min=0.0)
        b = float(self.plan.batch)
        beta = 1.0 + self.noise2
        mu_t = (tail + resid_tr + self.noise2) / self.n
        self.eta = torch.where(b < beta / mu_t + 1.0,
                               torch.full_like(mu_t, b / beta),
                               0.95 * 2.0 * b / (beta + (b - 1.0) * mu_t))

        self.z = probes if probes is not None else rnd.rademacher(
            self.key, (self.n, self.opts.n_probes), device=y.device,
            dtype=y.dtype)
        self.alpha = None
        self.Kinv_z = None
        self._logdet = None
        self.last_epochs = None   # sweeps used by the most recent solve

    # ---- the mini-batch iteration -------------------------------------

    def _rows_mv(self, xb, A):
        if self._sharded_rows is not None:
            return self._sharded_rows(self.theta, xb, self.x, A)
        return kops.matvec_rows(self.kind, self.theta, xb, self.x, A)

    def _grad(self, A, RHS, rows):
        """The batch gradient K[m, :] A + s2 A[m] - RHS[m]."""
        xb = self.x.index_select(0, rows)
        return (self._rows_mv(xb, A) + self.noise2 * A[rows]) - RHS[rows]

    def _iterate(self, RHS):
        """Epochs of deflated-preconditioned SGD on (K + s2 I) A = RHS,
        RHS (n, k).

        ``SolverOpts(momentum=mu)`` with 0 < mu < 1 takes heavy-ball
        steps: a velocity V accumulates the preconditioned directions with
        decay mu and the step is scaled by (1 - mu), so the steady-state
        step mass matches the plain loop's.  mu = 0 takes the plain loop,
        a code path of its own, as in the JAX package.

        Every epoch walks ``perm[: steps * b]`` of a fresh permutation
        (key ``fold_in(fold_in(key, PERM_KEY), e)``) and leaves out the
        n mod b remainder rows.  The rows of one step are distinct, so
        the in-place ``index_add_`` on A (and V) adds each once, like the
        JAX package's scatter-add.
        """
        n, b = self.n, self.plan.batch
        steps = max(n // b, 1)
        dtype = RHS.dtype
        eta_b = (self.eta / b).to(dtype)
        U = self.U.to(dtype)
        Ud = U * self._dvec.to(dtype)[None, :]
        kb = rnd.fold_in(self.key, PERM_KEY)
        mu = float(self.opts.momentum)
        eta_mu = (eta_b * (1.0 - mu)).to(dtype)

        def epoch(e, A, V, acc):
            perm = rnd.permutation(rnd.fold_in(kb, e), n, device=RHS.device)
            batches = perm[: steps * b].reshape(steps, b)
            for s in range(steps):
                rows = batches[s]
                g = self._grad(A, RHS, rows)
                if mu == 0.0:
                    # A[m] -= (eta/b) g;  A += (eta/b) U (d * (U[m]^T g))
                    A.index_add_(0, rows, -eta_b * g)
                    A.add_(eta_b * (Ud @ (U[rows].T @ g)))
                else:
                    # V <- mu V - scatter(g) + U (d * (U[m]^T g));
                    # A += eta (1 - mu) V
                    V.mul_(mu).index_add_(0, rows, -g)
                    V.add_(Ud @ (U[rows].T @ g))
                    A.add_(eta_mu * V)
                if acc is not None:
                    acc.add_(torch.sum(g * g, dim=0))

        # the guarded Woodbury(L L^T + s2 I) warm start: its true residual
        # is E A0, which an imperfect factor amplifies by 1 / s2; one
        # exact row sweep checks each column against the zero start's
        # residual ||RHS|| and drops the columns it would make worse
        A0 = self._warm(RHS)
        r0 = self._full_matvec(A0) - RHS
        rhs_norm = torch.clamp(torch.linalg.vector_norm(RHS, dim=0),
                               min=1e-30)
        r0_norm = torch.linalg.vector_norm(r0, dim=0)
        worse = r0_norm >= rhs_norm
        A = torch.where(worse[None, :], torch.zeros_like(A0), A0)
        V = torch.zeros_like(A) if mu != 0.0 else None
        if not self.plan.adaptive:
            for e in range(self.plan.epochs):
                epoch(e, A, V, None)
            self.last_epochs = self.plan.epochs
            EPOCH_COUNTS[self.last_epochs] += 1
            return A

        # the adaptive stop: an epoch touches every row once, so the sum
        # of ||g||^2 over its steps (each at the then-current iterate) is
        # a whole-vector residual estimate, stale by at most one epoch; it
        # stops once max_col sqrt(acc) / ||RHS_col|| <= tol.  The entry
        # residual is the warm-start check's: ||r0|| where the warm start
        # survived, ||RHS|| where it was dropped.  The velocity persists
        # across epochs.
        rel = torch.max(torch.where(worse, rhs_norm, r0_norm) / rhs_norm)
        e = 0
        while e < self.plan.epochs and _sync.host(rel > self.plan.tol,
                                                  "stochastic_epoch"):
            acc = torch.zeros(RHS.shape[1], dtype=dtype, device=RHS.device)
            epoch(e, A, V, acc)
            rel = torch.max(torch.sqrt(acc) / rhs_norm)
            e += 1
        self.last_epochs = e
        EPOCH_COUNTS[e] += 1
        return A

    def _full_matvec(self, A):
        """(K + s2 I) A exactly, one row-slab sweep over ceil(n / b)
        batches; the last batch's rows past n are clipped to n - 1 (the
        launch keeps its b rows) and only its first rows are kept."""
        n, b = self.n, self.plan.batch
        steps = -(-n // b)
        rows_all = torch.clamp(torch.arange(steps * b, device=A.device),
                               max=n - 1).reshape(steps, b)
        out = torch.empty_like(A)
        for s in range(steps):
            rows = rows_all[s]
            vals = (self._rows_mv(self.x.index_select(0, rows), A)
                    + self.noise2 * A[rows])
            lo = s * b
            hi = min(lo + b, n)
            out[lo:hi] = vals[: hi - lo]
        return out

    def _ensure_alpha(self):
        if self.alpha is None:
            self.alpha = self._iterate(self.y[:, None])[:, 0]
        return self.alpha

    def _ensure_probes(self):
        if self.Kinv_z is None:
            if self.alpha is None:      # one stacked run for [y | probes]
                sol = self._iterate(torch.cat([self.y[:, None], self.z],
                                              dim=1))
                self.alpha = sol[:, 0]
                self.Kinv_z = sol[:, 1:]
            else:
                self.Kinv_z = self._iterate(self.z)
        return self.Kinv_z

    # ---- solver contract ----------------------------------------------

    def solve(self, rhs):
        squeeze = rhs.ndim == 1
        out = self._iterate(rhs[:, None] if squeeze else rhs)
        return out[:, 0] if squeeze else out

    def logdet(self):
        """The deflation spectrum's sum of ln(lambda_j + s2) over the q
        estimates, plus the n - q unseen eigenvalues sharing the residual
        trace tr K - sum lambda equally."""
        if self._logdet is None:
            n, q = self.n, self.plan.rank
            head = torch.sum(torch.log(self.lam + self.noise2))
            if n > q:
                resid = torch.clamp(self._trK - torch.sum(self.lam),
                                    min=0.0)
                self._logdet = head + (n - q) * torch.log(
                    self.noise2 + resid / (n - q))
            else:
                self._logdet = head
        return self._logdet

    def quad(self, y):
        return y @ self.solve(y)

    def sigma2_hat(self):
        return (self.y @ self._ensure_alpha()) / self.n

    def grad_terms(self):
        Kinv_z = self._ensure_probes()
        alpha = self.alpha
        # one stacked launch: dK_i @ [alpha | z] for every direction i
        V = torch.cat([alpha[:, None], self.z], dim=1)
        dkv = self.op.tangent_matvecs(self.theta, V)        # (m, n, 1+p)
        quad = torch.einsum("j,mj->m", alpha, dkv[:, :, 0])
        tr = torch.mean(torch.einsum("jp,mjp->mp", Kinv_z, dkv[:, :, 1:]),
                        dim=-1)
        return quad, tr
