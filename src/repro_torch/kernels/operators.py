"""Linear operators for the training covariance.

Counterpart of ``repro/kernels/operators.py``.  Each operator binds one
(kind, x, sigma_n, jitter) training geometry; theta is a per-call
argument.  Five structures, picked by :func:`select_operator` with
``data.grid.classify_grid`` (1-D x) or ``classify_grid_nd`` ((n, d) x and
a composite kind) as in the JAX package:

  * :class:`PallasTileOperator` (the JAX package's name, kept so the two
    packages report the same operator): irregular x; its gram matvec is
    the B1 kernel plus the noise diagonal, its stacked tangents B2 (B8
    and B9 for a composite kind on (n, d) x).
  * :class:`ToeplitzOperator`: an exact grid; K is symmetric Toeplitz,
    applied by circulant embedding on ``torch.fft`` (the JAX package
    computes these FFTs outside any kernel too).
  * :class:`SKIOperator`: a near grid (a gappy record); K = W K_grid W^T
    on the recovered inducing grid.  With ``fused`` on, its bound gram
    matvec is one B5 launch and its stacked tangents one B6 launch
    (:mod:`.ski_fused`); otherwise the gather -> FFT -> scatter
    composition.
  * :class:`KroneckerOperator`: a full product grid; K = K_1 (x) ... (x)
    K_d of per-axis Toeplitz factors, applied axis by axis on
    ``torch.fft``.
  * :class:`ProductSKIOperator`: gappy or jittered product data;
    K = W K_kron W^T with outer-product stencils.  On 2-D grids with
    ``fused`` on, its bound gram matvec is one B10 launch and its stacked
    tangents one B11 launch; otherwise the unfused composition.

Each operator also carries the preconditioner hooks that
``core.iterative.make_preconditioner`` reads: ``circulant_precond`` (the
structure's Strang-type FFT apply) and, where the structure has one,
``slq_precond`` (the accessors of preconditioned SLQ).
"""

from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from .. import _pending
from .. import random as rnd
from ..data.grid import (GRID_RTOL, build_inducing_grid, classify_grid,
                         classify_grid_nd, interp_weights, is_regular_grid)
from . import ops as kops
from . import ski_fused
from .ref import tile, tile_grad
from .ski_fused import interp_gather

@runtime_checkable
class LinearOperator(Protocol):
    """Matrix-access contract consumed by the iterative solver engine."""

    name: str
    kind: str
    n: int

    def matvec(self, theta, v) -> torch.Tensor:
        """Noise-free K(x, x) @ v;  v is (n,) or (n, b)."""
        ...

    def gram_matvec(self, theta, v) -> torch.Tensor:
        """(K + (sigma_n^2 + jitter) I) @ v."""
        ...

    def tangent_matvecs(self, theta, V) -> torch.Tensor:
        """dK/dtheta_i @ V stacked over all m flat directions: (m, n, b)."""
        ...


def bound_gram_matvec(op, theta, dtype):
    """``v -> (K + noise2 I) v`` with per-theta work hoisted where the
    operator offers it (``op.bound_gram_matvec``)."""
    bind = getattr(op, "bound_gram_matvec", None)
    if bind is not None:
        return bind(theta, dtype)
    return lambda v: op.gram_matvec(theta, v)


def _column(kind: str, theta, dt):
    """k(dt) for a separation vector dt, one closed-form evaluation.

    Composite kinds ("a*b") take (n, d) separations and return the product
    of the per-axis factors on dt[..., a]."""
    kinds = kops.split_kind(kind)
    if len(kinds) > 1:
        out = None
        for a, (k, tb) in enumerate(zip(kinds, kops.theta_blocks(kind,
                                                                 theta))):
            ka = tile(k, dt[..., a], kops.natural_params(k, tb).to(dt.dtype))
            out = ka if out is None else out * ka
        return out
    p = kops.natural_params(kind, theta).to(dt.dtype)
    return tile(kind, dt, p)


def _column_jacobian(kind: str, theta, dt):
    """(m, len(dt)): row i is d k(dt) / d theta_i.

    The closed form of the forward-mode Jacobian of :func:`_column`: the
    natural-slot gradients of the tile contracted with the natural
    tangents of the flat coordinates (the same Jacobian feeds B6).
    """
    p = kops.natural_params(kind, theta).to(dt.dtype)
    _, g = tile_grad(kind, dt, p)                     # (len(dt), ns)
    pdots = kops.natural_tangents(kind, theta).to(dt.dtype)
    return torch.einsum("ns,ms->mn", g, pdots[:, :g.shape[-1]])


def _mean_spacing_column(kind: str, theta, x, n: int):
    """Stand-in Toeplitz first column k(hbar * arange(n)) at the mean data
    spacing: the circulant preconditioner's model of near-uniform
    sampling (exact on grids, an approximation off them)."""
    hbar = (x[-1] - x[0]) / max(n - 1, 1)
    return _column(kind, theta, hbar * torch.arange(n, dtype=x.dtype,
                                                     device=x.device))


class _StationaryColumnAccess:
    """The diag and column oracles of an operator whose exact matrix is
    the stationary kernel on its own ``self.x`` (tiles, Toeplitz): one
    closed-form evaluation per call.  ``i`` may be a 0-d index tensor on
    the card; it is never read back to the host."""

    def diag(self, theta):
        """Noise-free diagonal k(x, x) (unit-scale kernels: all ones)."""
        return _column(self.kind, theta, torch.zeros_like(self.x))

    def matcol(self, theta, i):
        """Column k(x, x_i), O(n)."""
        idx = torch.as_tensor(i, device=self.x.device).reshape(1)
        return _column(self.kind, theta,
                       self.x - self.x.index_select(0, idx))


# ---------------------------------------------------------------------------
# General path: tiles
# ---------------------------------------------------------------------------

class PallasTileOperator(_StationaryColumnAccess):
    """The general path: K generated tile by tile, never stored; any 1-D x."""

    name = "pallas"

    def __init__(self, kind: str, x, sigma_n: float = 0.0,
                 jitter: float = 0.0):
        kinds = kops.split_kind(kind)
        if len(kinds) > 1:
            kops.check_nd_coords(kind, kinds, x)
        elif x.ndim != 1:
            raise ValueError(
                f"plain kind {kind!r} needs 1-D coordinates; got shape "
                f"{tuple(x.shape)}: use a composite 'a*b' kind with one "
                f"factor per axis for multi-axis inputs")
        self.kind = kind
        self.kinds = kinds
        self.x = x
        self.n = int(x.shape[0])
        self.sigma_n = float(sigma_n)
        self.jitter = float(jitter)
        self.noise2 = float(sigma_n) ** 2 + float(jitter)

    def matvec(self, theta, v):
        return kops.matvec(self.kind, theta, self.x, self.x, v)

    def gram_matvec(self, theta, v):
        return kops.gram_matvec(self.kind, theta, self.x, v, self.sigma_n,
                                self.jitter)

    def tangent_matvecs(self, theta, V):
        return kops.matvec_tangents(self.kind, theta, self.x, self.x, V)

    def circulant_precond(self, theta, floor: float = 1e-12):
        """Circulant apply from the mean-spacing stand-in column: a model
        of near-uniform sampling, of little use on scattered x.  Scattered
        multi-axis data has no 1-D stand-in grid: there it is the Jacobi
        apply (unit-scale kernels have k(0) = 1), as in the JAX package."""
        if len(self.kinds) > 1:
            scale = 1.0 + self.noise2
            return lambda r: r / scale
        return _circulant_inverse_apply(
            _mean_spacing_column(self.kind, theta, self.x, self.n),
            self.noise2, floor)


# ---------------------------------------------------------------------------
# Gridded path: symmetric Toeplitz via circulant embedding + real FFT
# ---------------------------------------------------------------------------

def _embed(t):
    """First column (..., n) -> circulant generator (..., 2n-2):
    [t_0 .. t_{n-1}, t_{n-2} .. t_1]."""
    return torch.cat([t, torch.flip(t[..., 1:t.shape[-1] - 1], dims=(-1,))],
                     dim=-1)


def _pad_rows(v, L: int):
    """(n, b) -> (L, b), zero rows below."""
    return torch.cat([v, v.new_zeros((L - v.shape[0],) + tuple(v.shape[1:]))])


def _toeplitz_matvec(t, v):
    """Symmetric-Toeplitz matvec: t (n,) first column, v (n, b) -> (n, b)."""
    n = t.shape[0]
    L = 2 * n - 2
    w = torch.fft.irfft(torch.fft.rfft(_embed(t))[:, None]
                        * torch.fft.rfft(_pad_rows(v, L), dim=0), n=L, dim=0)
    return w[:n].to(v.dtype)


def _toeplitz_matvec_stacked(T, v):
    """m first columns at once: T (m, n), v (n, b) -> (m, n, b); one rfft
    of v serves all m spectra."""
    n = v.shape[0]
    L = 2 * n - 2
    vhat = torch.fft.rfft(_pad_rows(v, L), dim=0)            # (Lf, b)
    chat = torch.fft.rfft(_embed(T), dim=-1)                 # (m, Lf)
    w = torch.fft.irfft(chat[:, :, None] * vhat[None], n=L, dim=1)
    return w[:, :n].to(v.dtype)


def _circulant_inverse_apply(t, noise2: float, floor: float = 1e-12):
    """r -> E^T (C_+ + noise2 I)^{-1} E r from the 2n-2 embedding of t.

    The Strang-type circulant-preconditioner apply shared by every
    operator's ``circulant_precond``: the real embedding spectrum clipped
    positive at ``floor * max|lambda|`` plus the noise, applied by padding
    to 2n-2, one rfft, a divide, irfft and truncation.
    """
    n = t.shape[0]
    if n < 2:
        return lambda r: r / (t[0] + noise2)
    L = 2 * n - 2
    lam = torch.fft.rfft(_embed(t)).real
    lam = torch.maximum(lam, floor * torch.max(torch.abs(lam))) + noise2

    def apply(r):
        squeeze = r.ndim == 1
        if squeeze:
            r = r[:, None]
        u = torch.fft.irfft(torch.fft.rfft(_pad_rows(r, L), dim=0)
                            / lam[:, None], n=L, dim=0)[:n].to(r.dtype)
        return u[:, 0] if squeeze else u

    return apply


class SLQPrecond:
    """What preconditioned SLQ needs from its P ~ K: ``apply_inv``
    (r -> P^{-1} r), ``sample`` ((key, p) -> (n, p) probes with
    E[z z^T] = P) and the exact ``logdet`` of P."""

    def __init__(self, apply_inv, sample, logdet):
        self.apply_inv = apply_inv
        self.sample = sample
        self.logdet = logdet


def _strang_spectrum(t, noise2: float, floor: float = 1e-12):
    """Real eigenvalues of the n x n Strang circulant of first column t
    (c[j] = t[j] for j <= n/2, t[n-j] beyond), clipped positive like the
    embedding preconditioner, plus the noise."""
    n = t.shape[0]
    j = torch.arange(n, device=t.device)
    c = torch.where(j <= n // 2, t[torch.clamp(j, max=n - 1)],
                    t[(n - j) % n])
    lam = torch.fft.fft(c).real
    lam = torch.maximum(lam, floor * torch.max(torch.abs(lam)))
    return lam + noise2


def strang_slq_precond(t, noise2: float, floor: float = 1e-12
                       ) -> SLQPrecond:
    """:class:`SLQPrecond` of the n x n Strang circulant of ``t``: every
    access is one length-n FFT pair; ln det P = sum ln lambda exactly."""
    lam = _strang_spectrum(t, noise2, floor)
    n = lam.shape[0]
    sq = torch.sqrt(lam)

    def apply_inv(r):
        return torch.fft.ifft(torch.fft.fft(r, dim=0) / lam[:, None],
                              dim=0).real.to(r.dtype)

    def sample(key, p):
        g = rnd.normal(key, (n, p), device=lam.device, dtype=lam.dtype)
        return torch.fft.ifft(torch.fft.fft(g, dim=0) * sq[:, None],
                              dim=0).real

    return SLQPrecond(apply_inv, sample, torch.sum(torch.log(lam)))


# Cap on the missing-cell block of the gappy SLQ preconditioner: the
# correction is a g x g Cholesky (g = dropped cells), cubic in g.
_GAPPY_SLQ_MAX_MISS = 4096


def masked_circulant_slq_precond(lam, occ,
                                 max_miss: int = _GAPPY_SLQ_MAX_MISS
                                 ) -> Optional[SLQPrecond]:
    """Determinant-corrected SLQ preconditioner P = M[occ, occ] for gappy
    grids: M the (multi-level) circulant-plus-noise of spectrum ``lam``
    (shape (m_1, ..., m_d), noise folded in) over the full grid of
    m = prod m_a cells, ``occ`` the flat indices of the n occupied cells
    (None: the full grid, a pure multi-level Strang preconditioner).

    All three accessors are exact through the g = m - n missing cells:
    with G = M^{-1}[miss, miss], P^{-1} r = (M^{-1} r~)[occ] minus
    (M^{-1} [0; G^{-1} (M^{-1} r~)[miss]])[occ]; a sample of M^{1/2} g
    restricted to occ has covariance P; ln det P = sum ln lambda +
    2 sum ln diag chol(G).  Returns None when g exceeds ``max_miss`` or
    occ has duplicates.
    """
    shape = tuple(int(m) for m in lam.shape)
    m = int(np.prod(shape))
    dims = tuple(range(len(shape)))
    dev = lam.device

    def conv_inv(R):
        """M^{-1} on the full grid: (m, b) -> (m, b), a d-D FFT solve."""
        U = R.reshape(shape + (R.shape[1],))
        out = torch.fft.ifftn(torch.fft.fftn(U, dim=dims) / lam[..., None],
                              dim=dims).real
        return out.reshape(m, -1)

    sq = torch.sqrt(lam)
    logdet = torch.sum(torch.log(lam))
    g = 0
    occ_t = None
    if occ is not None:
        occ_np = np.asarray(occ, np.int64).ravel()
        if np.unique(occ_np).size != occ_np.size:
            return None
        miss_np = np.setdiff1d(np.arange(m, dtype=np.int64), occ_np)
        g = int(miss_np.size)
        if g > max_miss:
            return None
        occ_t = torch.as_tensor(occ_np, device=dev)
    if g:
        # G[i, j] = q[(miss_i - miss_j) mod shape], q the first column of
        # M^{-1} (a circulant inverse is circulant)
        midx = np.unravel_index(miss_np, shape)
        diff = tuple((mi[:, None] - mi[None, :]) % sa
                     for mi, sa in zip(midx, shape))
        flat_diff = np.ravel_multi_index(diff, shape)
        q = torch.fft.ifftn(1.0 / lam, dim=dims).real.reshape(-1)
        G = q[torch.as_tensor(flat_diff, device=dev)]
        Lg, info = torch.linalg.cholesky_ex(G)
        # jnp.linalg.cholesky gives nan where torch's raises: let it flow
        Lg = torch.where(info == 0, Lg, torch.full_like(Lg, torch.nan))
        logdet = logdet + 2.0 * torch.sum(torch.log(torch.diagonal(Lg)))
        miss_t = torch.as_tensor(miss_np, device=dev)

    def apply_inv(r):
        squeeze = r.ndim == 1
        rb = r[:, None] if squeeze else r
        if occ_t is None:
            u = conv_inv(rb.to(lam.dtype))
        else:
            rt = lam.new_zeros((m, rb.shape[1]))
            rt[occ_t] = rb.to(lam.dtype)
            u = conv_inv(rt)
            if g:
                tcor = torch.cholesky_solve(u[miss_t], Lg, upper=False)
                tt = lam.new_zeros((m, rb.shape[1]))
                tt[miss_t] = tcor
                u = u - conv_inv(tt)
            u = u[occ_t]
        out = u.to(r.dtype)
        return out[:, 0] if squeeze else out

    def sample(key, p):
        gg = rnd.normal(key, shape + (p,), device=dev, dtype=lam.dtype)
        z = torch.fft.ifftn(torch.fft.fftn(gg, dim=dims) * sq[..., None],
                            dim=dims).real.reshape(m, p)
        return z if occ_t is None else z[occ_t]

    return SLQPrecond(apply_inv, sample, logdet)


def masked_circulant_slq_precond_bank(lams, occ,
                                      max_miss: int = _GAPPY_SLQ_MAX_MISS
                                      ) -> Optional[SLQPrecond]:
    """Bank form of :func:`masked_circulant_slq_precond`: B members that
    share one occupancy pattern, P_b = M_b[occ, occ] with per-member
    spectra ``lams`` (B, m_1, ..., m_d) (noise folded in).

    The occ/miss index work is geometry, the same for every member, and is
    done once on the host; the d-D FFT applies, the g x g correction
    Cholesky of G_b = M_b^{-1}[miss, miss] and ln det P_b batch over the
    members.  The accessors act on bank blocks: ``apply_inv`` (n, B, p) ->
    (n, B, p), ``sample`` gives (n, B, p), ``logdet`` is (B,).  Returns
    None when g exceeds ``max_miss`` or occ has duplicates.
    """
    B = int(lams.shape[0])
    shape = tuple(int(m) for m in lams.shape[1:])
    d = len(shape)
    m = int(np.prod(shape))
    dims = tuple(range(d))
    dev = lams.device
    LamT = torch.movedim(lams, 0, -1)[..., None]           # (m1..md, B, 1)
    sq = torch.sqrt(LamT)
    logdet = torch.sum(torch.log(lams.reshape(B, -1)), dim=1)   # (B,)

    def conv_inv(R):
        """Every member's M_b^{-1} on the full grid, (m, B, p) blocks."""
        U = R.reshape(shape + tuple(R.shape[1:]))
        out = torch.fft.ifftn(torch.fft.fftn(U, dim=dims) / LamT,
                              dim=dims).real
        return out.reshape(R.shape)

    occ_np = np.asarray(occ, np.int64).ravel()
    if np.unique(occ_np).size != occ_np.size:
        return None
    miss_np = np.setdiff1d(np.arange(m, dtype=np.int64), occ_np)
    g = int(miss_np.size)
    if g > max_miss:
        return None
    if g:
        midx = np.unravel_index(miss_np, shape)
        diff = tuple((mi[:, None] - mi[None, :]) % sa
                     for mi, sa in zip(midx, shape))
        flat_diff = np.ravel_multi_index(diff, shape)
        qs = torch.fft.ifftn(1.0 / lams, dim=tuple(range(1, d + 1))
                             ).real.reshape(B, m)
        G = qs[:, torch.as_tensor(flat_diff, device=dev)]  # (B, g, g)
        Lg, info = torch.linalg.cholesky_ex(G)
        # jnp.linalg.cholesky gives nan where torch's raises: let it flow
        Lg = torch.where((info == 0)[:, None, None], Lg,
                         torch.full_like(Lg, torch.nan))
        logdet = logdet + 2.0 * torch.sum(torch.log(
            torch.diagonal(Lg, dim1=1, dim2=2)), dim=1)
        miss_t = torch.as_tensor(miss_np, device=dev)
    occ_t = torch.as_tensor(occ_np, device=dev)

    def apply_inv(r):                                      # (n, B, p)
        rt = lams.new_zeros((m,) + tuple(r.shape[1:]))
        rt[occ_t] = r.to(lams.dtype)
        u = conv_inv(rt)
        if g:
            s = u[miss_t].transpose(0, 1)                  # (B, g, p)
            tcor = torch.cholesky_solve(s, Lg, upper=False)
            tt = lams.new_zeros((m,) + tuple(r.shape[1:]))
            tt[miss_t] = tcor.transpose(0, 1)
            u = u - conv_inv(tt)
        return u[occ_t].to(r.dtype)

    def sample(key, p):
        gg = rnd.normal(key, shape + (B, p), device=dev, dtype=lams.dtype)
        z = torch.fft.ifftn(torch.fft.fftn(gg, dim=dims) * sq,
                            dim=dims).real.reshape(m, B, p)
        return z[occ_t]

    return SLQPrecond(apply_inv, sample, logdet)


class ToeplitzOperator(_StationaryColumnAccess):
    """O(n log n) gram/tangent matvecs for stationary kernels on a grid.

    x must be strictly ascending and uniformly spaced; the whole matrix is
    its first column k(x - x[0]).
    """

    name = "toeplitz"

    def __init__(self, kind: str, x, sigma_n: float = 0.0,
                 jitter: float = 0.0, rtol: float = GRID_RTOL):
        kops.check_kind(kind)
        if not is_regular_grid(x, rtol=rtol):
            raise ValueError(
                "ToeplitzOperator needs a strictly ascending, uniformly "
                "spaced 1-D x (data.grid.is_regular_grid); use the "
                "'pallas' operator for irregular inputs")
        self.kind = kind
        self.x = x
        self.n = int(x.shape[0])
        self.sigma_n = float(sigma_n)
        self.jitter = float(jitter)
        self.noise2 = float(sigma_n) ** 2 + float(jitter)
        self._dt0 = x - x[0]                 # separations of column 0

    def first_column(self, theta, dtype=None):
        """k(x - x[0]): the n numbers that define the whole matrix."""
        dtype = self._dt0.dtype if dtype is None else dtype
        return _column(self.kind, theta, self._dt0.to(dtype))

    def first_column_jacobian(self, theta, dtype=None):
        """(m, n): row i is d first_column / d theta_i."""
        dtype = self._dt0.dtype if dtype is None else dtype
        return _column_jacobian(self.kind, theta, self._dt0.to(dtype))

    def matvec(self, theta, v):
        squeeze = v.ndim == 1
        if squeeze:
            v = v[:, None]
        out = _toeplitz_matvec(self.first_column(theta, v.dtype), v)
        return out[:, 0] if squeeze else out

    def gram_matvec(self, theta, v):
        return self.matvec(theta, v) + self.noise2 * v

    def tangent_matvecs(self, theta, V):
        squeeze = V.ndim == 1
        if squeeze:
            V = V[:, None]
        rows = self.first_column_jacobian(theta, V.dtype)     # (m, n)
        out = _toeplitz_matvec_stacked(rows, V)               # (m, n, b)
        return out[:, :, 0] if squeeze else out

    def circulant_precond(self, theta, floor: float = 1e-12):
        """Circulant apply from the exact first column."""
        return _circulant_inverse_apply(self.first_column(theta),
                                        self.noise2, floor)

    def bound_gram_matvec(self, theta, dtype):
        """Per-theta bound apply: the embedding spectrum is computed here,
        once; each call is then one rfft/irfft pair."""
        lam = torch.fft.rfft(_embed(self.first_column(theta, dtype)))
        n, L = self.n, 2 * self.n - 2
        noise2 = self.noise2

        def mv(v):
            squeeze = v.ndim == 1
            if squeeze:
                v = v[:, None]
            out = torch.fft.irfft(lam[:, None]
                                  * torch.fft.rfft(_pad_rows(v, L), dim=0),
                                  n=L, dim=0)[:n].to(v.dtype)
            out = out + noise2 * v
            return out[:, 0] if squeeze else out

        return mv

    def slq_precond(self, theta, floor: float = 1e-12) -> SLQPrecond:
        """Preconditioned-SLQ accessors from the n x n Strang circulant of
        the exact first column."""
        return strang_slq_precond(self.first_column(theta), self.noise2,
                                  floor)


# ---------------------------------------------------------------------------
# Near-grid path: structured kernel interpolation (SKI)
# ---------------------------------------------------------------------------

def _selection_cells(idx, w) -> Optional[np.ndarray]:
    """Grid cells of a selection-matrix W, or None if W is not one: every
    row has exactly one nonzero weight, equal to 1 (interp_weights snaps
    on-node rows), on distinct cells."""
    w_np = np.asarray(w)
    idx_np = np.asarray(idx)
    hot = w_np == 1.0
    if not (np.count_nonzero(hot, axis=1) == 1).all():
        return None
    if not (np.count_nonzero(w_np, axis=1) == 1).all():
        return None
    cells = idx_np[np.arange(idx_np.shape[0]), np.argmax(hot, axis=1)]
    if np.unique(cells).size != cells.size:
        return None
    return cells.astype(np.int64)


class SKIOperator:
    """K ~ W K_grid W^T: the Toeplitz/FFT path for near-grid inputs.

    A regular inducing grid spans the data (``data.grid.
    build_inducing_grid``) and each point interpolates from its s = 4
    (cubic) or 2 (linear) nearest nodes (``data.grid.interp_weights``);
    W is stored as (n, s) index/weight arrays.  A point on a node gets a
    one-hot row, so a gappy record makes W a selection matrix and the
    surrogate exact.

    ``fused`` ("auto", True or False; :func:`ski_fused.resolve_fused`):
    on, the bound gram matvec is one B5 launch and the stacked tangents
    one B6 launch; off, the gather -> FFT -> scatter composition.
    """

    name = "ski"

    def __init__(self, kind: str, x, sigma_n: float = 0.0,
                 jitter: float = 0.0, spacing: Optional[float] = None,
                 order: str = "cubic", fused="auto"):
        kops.check_kind(kind)
        grid = build_inducing_grid(x, spacing=spacing)
        idx, w = interp_weights(x, grid, order=order)
        self.kind = kind
        self.x = x
        self.n = int(x.shape[0])
        self.order = order
        self.sigma_n = float(sigma_n)
        self.jitter = float(jitter)
        self.noise2 = float(sigma_n) ** 2 + float(jitter)
        # the grid stays float64 (a float32 round trip could push it past
        # the regularity tolerance); per-call dtypes follow v
        self._toep = ToeplitzOperator(
            kind, torch.as_tensor(np.asarray(grid, np.float64),
                                  dtype=torch.float64, device=x.device))
        self.grid = self._toep.x
        self.m_grid = int(self.grid.shape[0])
        self.idx = torch.as_tensor(idx, dtype=torch.int64, device=x.device)
        self.w = torch.as_tensor(w, dtype=x.dtype, device=x.device)
        self.fused_geom = ski_fused.build_fused_geometry(idx, w, self.m_grid)
        self.fused = ski_fused.resolve_fused(fused, self.fused_geom)
        # a gappy record (W a selection matrix) unlocks the
        # determinant-corrected SLQ preconditioner; jitter leaves None
        self._sel_cells = _selection_cells(idx, w)
        self._interp = ski_fused.Interpolation(self.idx, self.w, self.m_grid,
                                               self._sel_cells)

    def _W(self, u):
        """(m_grid, b) -> (n, b): gather s nodes per row, weight, sum."""
        return self._interp.gather(u)

    def _Wt(self, v):
        """(n, b) -> (m_grid, b): scatter-add each point into its nodes."""
        return self._interp.scatter(v)

    def matvec(self, theta, v):
        squeeze = v.ndim == 1
        if squeeze:
            v = v[:, None]
        out = self._W(self._toep.matvec(theta, self._Wt(v)))
        return out[:, 0] if squeeze else out

    def gram_matvec(self, theta, v):
        if self.fused:
            squeeze = v.ndim == 1
            if squeeze:
                v = v[:, None]
            out = self.bound_gram_matvec(theta, v.dtype)(v.contiguous())
            return out[:, 0] if squeeze else out
        return self.matvec(theta, v) + self.noise2 * v

    def bound_gram_matvec(self, theta, dtype):
        """Per-theta bound training matvec, the CG/Lanczos hot-loop apply.

        Fused: the spectrum is built here, once, and every call is one B5
        launch.  Unfused: the inner Toeplitz spectrum is hoisted and each
        call is the gather -> FFT pair -> scatter composition.
        """
        if self.fused:
            lam = ski_fused.spectrum(self._toep.first_column(theta, dtype),
                                     self.fused_geom)
            geom, noise2 = self.fused_geom, self.noise2

            def mv(v):
                squeeze = v.ndim == 1
                if squeeze:
                    v = v[:, None]
                out = ski_fused.fused_gram_matvec(geom, lam, noise2,
                                                  v.contiguous())
                return out[:, 0] if squeeze else out

            return mv
        inner = self._toep.bound_gram_matvec(theta, dtype)
        noise2 = self.noise2       # the grid operator carries no noise

        def mv(v):
            return self._W(inner(self._Wt(v))) + noise2 * v

        return mv

    def tangent_matvecs(self, theta, V):
        """dK/dtheta_i @ V = W (dK_grid/dtheta_i) W^T V: one B6 launch when
        fused (shared W^T and forward FFT), else the stacked Toeplitz
        tangents between the W applications."""
        squeeze = V.ndim == 1
        if squeeze:
            V = V[:, None]
        if self.fused:
            rows = self._toep.first_column_jacobian(theta, V.dtype)
            lams = ski_fused.spectrum(rows, self.fused_geom)  # (m, L)
            out = ski_fused.fused_tangent_matvecs(self.fused_geom, lams,
                                                  V.contiguous())
        else:
            T = self._toep.tangent_matvecs(theta, self._Wt(V))
            out = torch.stack([self._W(Ti) for Ti in T])      # (m, n, b)
        return out[:, :, 0] if squeeze else out

    # -- cross-covariance on the same inducing grid (predict)

    def cross_interp(self, xstar):
        """``(idx*, w*)``, the sparse rows of W* with k(x*, x) ~ W* K_grid
        W^T, or None when a stencil of ``xstar`` leaves the grid (callers
        then take the exact cross covariance)."""
        try:
            idx, w = interp_weights(xstar, self.grid, order=self.order)
        except ValueError:
            return None
        return (torch.as_tensor(idx, dtype=torch.int64, device=self.x.device),
                torch.as_tensor(w, dtype=self.x.dtype, device=self.x.device))

    def cross_matvec(self, theta, xstar_interp, v):
        """k(x*, x) @ v ~ W* K_grid (W^T v): two sparse applications around
        one grid Toeplitz FFT."""
        idx_s, w_s = xstar_interp
        squeeze = v.ndim == 1
        if squeeze:
            v = v[:, None]
        u = self._toep.matvec(theta, self._Wt(v))           # (m_grid, b)
        out = interp_gather(idx_s, w_s, u)
        return out[:, 0] if squeeze else out

    def cross_columns(self, theta, xstar_interp):
        """Cross block k(x, x*) ~ W K_grid W*^T for a chunk of test
        points, (n, c), by scatter -> stacked grid FFT -> gather."""
        idx_s, w_s = xstar_interp                           # (c, s)
        c = idx_s.shape[0]
        cols = torch.arange(c, device=idx_s.device)[:, None].expand_as(idx_s)
        wst = self.w.new_zeros((self.m_grid, c))
        wst.index_put_((idx_s, cols), w_s.to(wst.dtype), accumulate=True)
        return self._W(self._toep.matvec(theta, wst))       # (n, c)

    # -- preconditioner hooks

    def diag(self, theta):
        """Surrogate diagonal w_i^T K_grid[idx_i, idx_i] w_i, O(n s^2),
        from the grid's first column (entries t[|d idx|])."""
        t = self._toep.first_column(theta, self.x.dtype)
        G = t[torch.abs(self.idx[:, :, None] - self.idx[:, None, :])]
        return torch.einsum("ns,nst,nt->n", self.w, G, self.w)

    def matcol(self, theta, i):
        """Surrogate column W K_grid (W^T e_i), O(m_grid s): the s
        relevant K_grid columns from the first column.  ``i`` may be a
        0-d index tensor on the card; it is never read back."""
        t = self._toep.first_column(theta, self.x.dtype)
        row = torch.as_tensor(i, device=self.idx.device).reshape(1)
        idx_i = self.idx.index_select(0, row)                 # (1, s)
        grid = torch.arange(self.m_grid, device=self.idx.device)
        cols = t[torch.abs(grid[:, None] - idx_i)]           # (m_grid, s)
        cu = cols @ self.w.index_select(0, row)[0].to(t.dtype)
        return self._W(cu[:, None])[:, 0]

    def circulant_precond(self, theta, floor: float = 1e-12):
        """Grid-space circulant sandwich W E^T (C_+ + noise2)^{-1} E W^T:
        scatter, divide by the exact K_grid embedding spectrum, gather."""
        Q = _circulant_inverse_apply(
            self._toep.first_column(theta, self.x.dtype), self.noise2,
            floor)

        def apply(r):
            squeeze = r.ndim == 1
            if squeeze:
                r = r[:, None]
            out = self._W(Q(self._Wt(r)))
            return out[:, 0] if squeeze else out

        return apply

    def slq_precond(self, theta,
                    floor: float = 1e-12) -> Optional[SLQPrecond]:
        """Determinant-corrected SLQ preconditioner for gappy records (W a
        selection matrix): P = M[occ, occ] with M the m-cell Strang
        circulant plus noise.  Jittered samplings return None and take
        plain SLQ."""
        if self._sel_cells is None:
            return None
        lam = _strang_spectrum(self._toep.first_column(theta), self.noise2,
                               floor)
        return masked_circulant_slq_precond(lam, self._sel_cells)


# ---------------------------------------------------------------------------
# Multi-axis paths: Kronecker product grids and product SKI
# ---------------------------------------------------------------------------

def _axis_toeplitz_apply(lam, m: int, U, axis: int):
    """Apply one symmetric Toeplitz factor along ``axis`` of a grid tensor:
    ``lam`` is the rfft of the factor's 2m - 2 circulant embedding, and
    every other axis (the trailing batch axis too) rides the FFT's batch.
    One Kronecker matvec is d of these sweeps."""
    U = torch.movedim(U, axis, 0)
    sh = U.shape
    L = 2 * m - 2
    V = U.reshape(m, -1)
    out = torch.fft.irfft(lam[:, None] * torch.fft.rfft(_pad_rows(V, L),
                                                        dim=0),
                          n=L, dim=0)[:m]
    return torch.movedim(out.to(U.dtype).reshape(sh), 0, axis)


def _strang_outer(ts, noise2: float, floor: float):
    """d-D spectrum of (x)_a Strang(K_a) + noise2: the outer product of
    the per-axis Strang spectra, shape (m_1, ..., m_d)."""
    lams = [_strang_spectrum(t, 0.0, floor) for t in ts]
    Lam = lams[0]
    for lb in lams[1:]:
        Lam = Lam[..., None] * lb
    return Lam + noise2


class KroneckerOperator:
    """K = K_1 (x) ... (x) K_d for a separable kernel on a full product
    grid in canonical row-major order (last axis fastest).

    The gram matvec views v as an (m_1, ..., m_d, b) tensor and applies
    each axis's Toeplitz factor along its axis (:func:`_axis_toeplitz_apply`,
    ``torch.fft``): O(n log n), never an (n, n) or (m_a, m_a) block.  The
    tangent of a direction on axis a is dK_a (x) (the other factors), the
    product rule at operator level; its first-column Jacobian is the
    closed form of the axis Toeplitz operator.  The SLQ preconditioner is
    the Kronecker product of per-axis Strang circulants plus noise.
    """

    name = "kron"

    def __init__(self, kind: str, x=None, sigma_n: float = 0.0,
                 jitter: float = 0.0, rtol: float = GRID_RTOL, grids=None,
                 device=None):
        kinds = kops.split_kind(kind)
        if len(kinds) < 2:
            raise ValueError(
                f"KroneckerOperator needs a composite kind 'a*b' with one "
                f"factor per grid axis, got plain kind {kind!r}")
        if grids is None:
            info = classify_grid_nd(x, rtol=rtol)
            if info.kind != "kron":
                raise ValueError(
                    "KroneckerOperator needs x to enumerate a FULL product "
                    "grid in canonical row-major order (last axis fastest; "
                    f"classify_grid_nd kind 'kron'), got {info.kind!r}; "
                    "gappy/permuted/jittered product data rides "
                    "ProductSKIOperator, scattered data the tiles")
            grids = info.grids
        if len(grids) != len(kinds):
            raise ValueError(
                f"kind {kind!r} has {len(kinds)} axis factors but "
                f"{len(grids)} per-axis grids were given")
        if device is None:
            device = x.device if x is not None else torch.device("cpu")
        self.kind = kind
        self.kinds = kinds
        # the axis operators are noise-free: the white noise lives on the
        # joint data axis, not inside any single factor
        self.axes_ops = tuple(ToeplitzOperator(
            k, torch.as_tensor(np.asarray(g, np.float64),
                               dtype=torch.float64, device=device))
            for k, g in zip(kinds, grids))
        self.shape = tuple(t.n for t in self.axes_ops)
        self.d = len(kinds)
        self.n = int(np.prod(self.shape))
        self.x = x
        self.sigma_n = float(sigma_n)
        self.jitter = float(jitter)
        self.noise2 = float(sigma_n) ** 2 + float(jitter)
        offs = np.concatenate([[0], np.cumsum(
            [kops.FLAT_NPARAMS[k] for k in kinds])])
        self.slices = tuple(slice(int(offs[a]), int(offs[a + 1]))
                            for a in range(self.d))

    def first_columns(self, theta, dtype=None):
        """Per-axis first columns: the sum_a m_a numbers of the matrix."""
        return tuple(t.first_column(theta[s], dtype)
                     for t, s in zip(self.axes_ops, self.slices))

    def _lams(self, theta, dtype):
        return [torch.fft.rfft(_embed(t))
                for t in self.first_columns(theta, dtype)]

    def _cycle(self, lams, v):
        """(n, b) -> (n, b): the per-axis FFT sweep of the matvec."""
        b = v.shape[1]
        U = v.reshape(self.shape + (b,))
        for a, lam in enumerate(lams):
            U = _axis_toeplitz_apply(lam, self.shape[a], U, a)
        return U.reshape(self.n, b)

    def matvec(self, theta, v):
        squeeze = v.ndim == 1
        if squeeze:
            v = v[:, None]
        out = self._cycle(self._lams(theta, v.dtype), v)
        return out[:, 0] if squeeze else out

    def gram_matvec(self, theta, v):
        return self.matvec(theta, v) + self.noise2 * v

    def bound_gram_matvec(self, theta, dtype):
        """Per-theta bound apply: the d axis spectra are built here; each
        call is d rfft/irfft pairs and the noise diagonal."""
        lams = self._lams(theta, dtype)
        noise2 = self.noise2

        def mv(v):
            squeeze = v.ndim == 1
            if squeeze:
                v = v[:, None]
            out = self._cycle(lams, v) + noise2 * v
            return out[:, 0] if squeeze else out

        return mv

    def tangent_matvecs(self, theta, V):
        """Stacked dK/dtheta @ V: axis a's parameter block gets
        (dK_a/dtheta) (x) (the other factors): the other axes' base
        sweeps, then one stacked Toeplitz tangent apply along axis a."""
        squeeze = V.ndim == 1
        if squeeze:
            V = V[:, None]
        dtype = V.dtype
        lams = self._lams(theta, dtype)
        b = V.shape[1]
        outs = []
        for a in range(self.d):
            rows = self.axes_ops[a].first_column_jacobian(
                theta[self.slices[a]], dtype)                # (p_a, m_a)
            U = V.reshape(self.shape + (b,))
            for c in range(self.d):
                if c != a:
                    U = _axis_toeplitz_apply(lams[c], self.shape[c], U, c)
            U = torch.movedim(U, a, 0)
            sh = U.shape
            T = _toeplitz_matvec_stacked(rows, U.reshape(sh[0], -1))
            T = torch.movedim(T.reshape((T.shape[0],) + tuple(sh)), 1,
                              a + 1)
            outs.append(T.reshape(T.shape[0], self.n, b))
        out = torch.cat(outs, dim=0)
        return out[:, :, 0] if squeeze else out

    def diag(self, theta):
        raise _pending.pending("KroneckerOperator.diag (pivoted Cholesky)",
                               _pending.PIVCHOL)

    def matcol(self, theta, i):
        raise _pending.pending("KroneckerOperator.matcol (pivoted "
                               "Cholesky)", _pending.PIVCHOL)

    def _strang_lam(self, theta, floor: float = 1e-12):
        """Spectrum of (x)_a Strang(K_a) + noise2, shape ``self.shape``."""
        return _strang_outer(self.first_columns(theta), self.noise2, floor)

    def circulant_precond(self, theta, floor: float = 1e-12):
        """CG preconditioner: the Kronecker-Strang spectral solve."""
        return self.slq_precond(theta, floor).apply_inv

    def slq_precond(self, theta, floor: float = 1e-12) -> SLQPrecond:
        """Preconditioned-SLQ accessors of the Kronecker Strang circulant:
        d-D FFT pairs, ln det P = sum ln Lambda exactly."""
        return masked_circulant_slq_precond(self._strang_lam(theta, floor),
                                            None)


def _outer_taps(axis_idx, axis_w, strides):
    """Joint (n, prod s_a) flat indices and weights of outer-product
    stencils from per-axis (idx, w) rows."""
    n = axis_idx[0].shape[0]
    IDX = np.zeros((n, 1), np.int64)
    WW = np.ones((n, 1), np.float64)
    for ia, wa, st in zip(axis_idx, axis_w, strides):
        IDX = (IDX[:, :, None]
               + np.asarray(ia, np.int64)[:, None, :] * int(st)
               ).reshape(n, -1)
        WW = (WW[:, :, None] * np.asarray(wa, np.float64)[:, None, :]
              ).reshape(n, -1)
    return IDX, WW


class ProductSKIOperator:
    """K ~ W K_kron W^T: product SKI for gappy or jittered multi-axis data.

    Each axis gets its own 1-D inducing grid and cubic (or linear)
    stencil; a point's joint row is the outer product of its per-axis
    rows (s^d taps on flat row-major cells).  Points on grid nodes (a
    gappy but unjittered field) make W a selection matrix: the surrogate
    is exact and the determinant-corrected SLQ preconditioner applies on
    the d-D grid.  At d = 2 with ``fused`` on (distinct flat cells), the
    bound gram matvec is one B10 launch and the stacked tangents one B11
    launch; d > 2, or ``fused`` off, takes the unfused composition.
    """

    name = "product_ski"

    def __init__(self, kind: str, x, sigma_n: float = 0.0,
                 jitter: float = 0.0, spacings=None, n_grid=None,
                 order: str = "cubic", fused="auto",
                 rtol: float = GRID_RTOL):
        kinds = kops.split_kind(kind)
        if len(kinds) < 2:
            raise ValueError(
                f"ProductSKIOperator needs a composite kind 'a*b' with one "
                f"factor per axis, got plain kind {kind!r}")
        d = len(kinds)
        kops.check_nd_coords(kind, kinds, x)
        xc = x.detach().cpu().numpy().astype(np.float64)
        n = xc.shape[0]
        spacings = (None,) * d if spacings is None else spacings
        n_grid = (None,) * d if n_grid is None else n_grid
        grids, axis_idx, axis_w = [], [], []
        for a in range(d):
            spacing_a = spacings[a]
            if spacing_a is None and n_grid[a] is None:
                # the axis's own recovered grid (its distinct values), so
                # the joint grid scales like n, not n^d
                spacing_a = classify_grid(np.unique(xc[:, a]), rtol=rtol).h
            g = build_inducing_grid(xc[:, a], spacing=spacing_a,
                                    n_grid=n_grid[a])
            ia, wa = interp_weights(xc[:, a], g, order=order)
            grids.append(g)
            axis_idx.append(ia)
            axis_w.append(wa)
        self.kind = kind
        self.kinds = kinds
        self.d = d
        self.x = x
        self.n = n
        self.order = order
        self.sigma_n = float(sigma_n)
        self.jitter = float(jitter)
        self.noise2 = float(sigma_n) ** 2 + float(jitter)
        self._kron = KroneckerOperator(kind, grids=tuple(grids),
                                       device=x.device)
        self.grids = tuple(t.x for t in self._kron.axes_ops)
        self.shape = self._kron.shape
        self.m_grid = self._kron.n
        strides = np.ones(d, np.int64)
        for a in range(d - 2, -1, -1):
            strides[a] = strides[a + 1] * self.shape[a + 1]
        self._strides = strides
        IDX, WW = _outer_taps(axis_idx, axis_w, strides)
        self.idx = torch.as_tensor(IDX, dtype=torch.int64, device=x.device)
        self.w = torch.as_tensor(WW, dtype=x.dtype, device=x.device)
        self._sel_cells = _selection_cells(IDX, WW)
        self._interp = ski_fused.Interpolation(self.idx, self.w, self.m_grid,
                                               self._sel_cells)
        self.fused_geom = ski_fused.build_fused_geometry_nd(
            axis_idx, axis_w, self.shape)
        self.fused = ski_fused.resolve_fused(fused, self.fused_geom)

    def _W(self, u):
        return self._interp.gather(u)

    def _Wt(self, v):
        return self._interp.scatter(v)

    def matvec(self, theta, v):
        squeeze = v.ndim == 1
        if squeeze:
            v = v[:, None]
        out = self._W(self._kron.matvec(theta, self._Wt(v)))
        return out[:, 0] if squeeze else out

    def gram_matvec(self, theta, v):
        if self.fused:
            squeeze = v.ndim == 1
            if squeeze:
                v = v[:, None]
            out = self.bound_gram_matvec(theta, v.dtype)(v.contiguous())
            return out[:, 0] if squeeze else out
        return self.matvec(theta, v) + self.noise2 * v

    def bound_gram_matvec(self, theta, dtype):
        """Per-theta bound training matvec.  Fused: the two axis spectra
        are built here and every call is one B10 launch; unfused: the
        hoisted Kronecker cycle between the W applications."""
        if self.fused:
            lams = ski_fused.spectrum_nd(
                self._kron.first_columns(theta, dtype), self.fused_geom)
            geom, noise2 = self.fused_geom, self.noise2

            def mv(v):
                squeeze = v.ndim == 1
                if squeeze:
                    v = v[:, None]
                out = ski_fused.fused_gram_matvec_nd(geom, lams, noise2,
                                                     v.contiguous())
                return out[:, 0] if squeeze else out

            return mv
        inner = self._kron.bound_gram_matvec(theta, dtype)
        noise2 = self.noise2

        def mv(v):
            squeeze = v.ndim == 1
            if squeeze:
                v = v[:, None]
            out = self._W(inner(self._Wt(v))) + noise2 * v
            return out[:, 0] if squeeze else out

        return mv

    def tangent_matvecs(self, theta, V):
        """dK/dtheta_i @ V = W (dK_kron/dtheta_i) W^T V: one B11 launch when
        fused, else the Kronecker tangents between the W applications."""
        squeeze = V.ndim == 1
        if squeeze:
            V = V[:, None]
        if self.fused:
            pairs = ski_fused.tangent_spectra_nd(
                self._kron, theta.to(V.dtype), self.fused_geom, V.dtype)
            out = ski_fused.fused_tangent_matvecs_nd(self.fused_geom, pairs,
                                                     V.contiguous())
        else:
            T = self._kron.tangent_matvecs(theta, self._Wt(V))
            out = torch.stack([self._W(Ti) for Ti in T])      # (m, n, b)
        return out[:, :, 0] if squeeze else out

    # -- cross-covariance on the same product grid (predict)

    def cross_interp(self, xstar):
        """Joint ``(idx*, w*)`` of test points on the same product grid,
        or None when a stencil leaves a grid or xstar is not (n*, d)."""
        if xstar.ndim != 2 or xstar.shape[1] != self.d:
            return None
        xs = xstar.detach().cpu().numpy().astype(np.float64)
        try:
            parts = [interp_weights(xs[:, a], self.grids[a],
                                    order=self.order)
                     for a in range(self.d)]
        except ValueError:
            return None
        IDX, WW = _outer_taps([p[0] for p in parts], [p[1] for p in parts],
                              self._strides)
        return (torch.as_tensor(IDX, dtype=torch.int64, device=self.x.device),
                torch.as_tensor(WW, dtype=self.x.dtype, device=self.x.device))

    def cross_matvec(self, theta, xstar_interp, v):
        """k(x*, x) @ v ~ W* K_kron (W^T v): two sparse applications around
        one Kronecker cycle (predict's mean)."""
        idx_s, w_s = xstar_interp
        squeeze = v.ndim == 1
        if squeeze:
            v = v[:, None]
        u = self._kron.matvec(theta, self._Wt(v))           # (m_grid, b)
        out = interp_gather(idx_s, w_s, u)
        return out[:, 0] if squeeze else out

    def cross_columns(self, theta, xstar_interp):
        """Cross block k(x, x*) ~ W K_kron W*^T for a chunk of test
        points, (n, c): scatter, Kronecker cycle, gather."""
        idx_s, w_s = xstar_interp                           # (c, taps)
        c = idx_s.shape[0]
        cols = torch.arange(c, device=idx_s.device)[:, None].expand_as(idx_s)
        wst = self.w.new_zeros((self.m_grid, c))
        wst.index_put_((idx_s, cols), w_s.to(wst.dtype), accumulate=True)
        return self._W(self._kron.matvec(theta, wst))       # (n, c)

    # -- preconditioner hooks

    def diag(self, theta):
        raise _pending.pending("ProductSKIOperator.diag (pivoted Cholesky)",
                               _pending.PIVCHOL)

    def matcol(self, theta, i):
        raise _pending.pending("ProductSKIOperator.matcol (pivoted "
                               "Cholesky)", _pending.PIVCHOL)

    def circulant_precond(self, theta, floor: float = 1e-12):
        """Grid-space Kronecker-Strang sandwich W (x_a Strang_a)^{-1} W^T,
        the d-D analogue of the SKI grid-space circulant, built from the
        noise-free inner Kronecker operator as in the JAX package."""
        pc = self._kron.slq_precond(theta, floor)

        def apply(r):
            squeeze = r.ndim == 1
            if squeeze:
                r = r[:, None]
            out = self._W(pc.apply_inv(self._Wt(r)))
            return out[:, 0] if squeeze else out

        return apply

    def slq_precond(self, theta,
                    floor: float = 1e-12) -> Optional[SLQPrecond]:
        """Determinant-corrected SLQ preconditioner for gappy product
        grids: P = M[occ, occ], M the d-D Kronecker Strang + noise.  None
        for a jittered W (plain SLQ)."""
        if self._sel_cells is None:
            return None
        return masked_circulant_slq_precond(
            _strang_outer(self._kron.first_columns(theta), self.noise2,
                          floor), self._sel_cells)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

OPERATORS = {
    PallasTileOperator.name: PallasTileOperator,
    ToeplitzOperator.name: ToeplitzOperator,
    SKIOperator.name: SKIOperator,
    KroneckerOperator.name: KroneckerOperator,
    ProductSKIOperator.name: ProductSKIOperator,
}


def make_operator(name: str, kind: str, x, sigma_n: float = 0.0,
                  jitter: float = 0.0, **kwargs):
    """Construct a registered operator by name (no structure detection)."""
    if name == "lowrank":
        raise _pending.pending(f"operator {name!r}", _pending.PIVCHOL)
    try:
        cls = OPERATORS[name]
    except KeyError:
        raise ValueError(f"unknown operator {name!r}; registered: "
                         f"{sorted(OPERATORS) + ['lowrank']}") from None
    return cls(kind, x, sigma_n, jitter, **kwargs)


def select_operator(kind: str, x, sigma_n: float = 0.0, jitter: float = 0.0,
                    operator: Optional[str] = None,
                    rtol: float = GRID_RTOL, fused="auto"):
    """Structure-aware dispatch, as in the JAX package.

    An explicit ``operator`` name wins.  Otherwise, for a plain kind on
    1-D x, ``classify_grid`` decides: "exact" -> :class:`ToeplitzOperator`,
    "near" -> :class:`SKIOperator` on the recovered grid, "irregular" ->
    :class:`PallasTileOperator`.  A composite kind on (n, d) x goes by
    ``classify_grid_nd``: "kron" -> :class:`KroneckerOperator`, "product"
    -> :class:`ProductSKIOperator`, "irregular" -> the product tiles.
    """
    kinds = kops.split_kind(kind)
    if operator is not None:
        kwargs = ({"fused": fused}
                  if operator in (SKIOperator.name, ProductSKIOperator.name)
                  else {})
        return make_operator(operator, kind, x, sigma_n, jitter, **kwargs)
    if len(kinds) > 1:
        info = classify_grid_nd(x, rtol=rtol)
        if info.kind == "kron":
            return KroneckerOperator(kind, x, sigma_n, jitter,
                                     grids=info.grids)
        if info.kind == "product":
            return ProductSKIOperator(
                kind, x, sigma_n, jitter,
                spacings=tuple(a.h for a in info.axes), fused=fused)
        return PallasTileOperator(kind, x, sigma_n, jitter)
    if x.ndim >= 2 and x.shape[-1] >= 2:
        raise ValueError(
            f"plain kind {kind!r} cannot cover (n, d>=2) coordinates of "
            f"shape {tuple(x.shape)}; join one factor per axis with '*' "
            "(e.g. 'se*matern32') for separable multi-axis products, or "
            "flatten to a 1-D (n,) series")
    if x.ndim != 1:
        raise ValueError(f"plain kind {kind!r} needs 1-D coordinates, got "
                         f"shape {tuple(x.shape)}")
    info = classify_grid(x, rtol=rtol)
    if info.kind == "exact":
        return ToeplitzOperator(kind, x, sigma_n, jitter, rtol=rtol)
    if info.kind == "near":
        return SKIOperator(kind, x, sigma_n, jitter, spacing=info.h,
                           fused=fused)
    return PallasTileOperator(kind, x, sigma_n, jitter)
