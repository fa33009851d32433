"""The batched candidate bank: every model x restart as one program.

Counterpart of ``repro/gp/batch.py``.  On exact or near grids each
candidate's training matrix is (a W-sandwich of) a symmetric Toeplitz
matrix, fixed by its first column, so K models differ only in the B
spectra that multiply one shared FFT; on (n, d) product grids ("kron" or
"product") each is a Kronecker product of per-axis Toeplitz factors, and
the members differ in their per-axis spectra:

  * :class:`BankOperator`: B matrices K_b + noise2 I on one geometry (the
    exact grid, or the shared inducing grid and sparse W of a gappy
    record).  ``bind_matvec`` builds the B spectra once per theta bank;
    each call is then one B7 launch on a near grid
    (:func:`~repro_torch.kernels.ski_fused.fused_bank_matvec`), or one
    rfft/irfft pair over the stacked (n, B, c) block.
  * :func:`bank_cg`: batched CG over (n, B, c) right-hand sides; a
    converged column freezes while the shared loop drives the others.
  * :func:`bank_slq_logdet` and :func:`bank_slq_logdet_precond`: all B
    log-determinants through the same shared matvec.
  * :func:`make_bank_objective`: the profiled hyperlikelihood of every
    member on a padded theta bank.
  * :func:`_ncg_minimize_bank`: the multi-start NCG of ``core.train``
    over a member axis, with per-member Armijo masks.
  * :func:`train_bank` and :func:`bank_fd_hessians`: training the whole
    bank, and the Laplace Hessians of a whole bank.

The JAX package's ``while_loop``s are Python loops here; each reads its
condition back to the host once per iteration (:mod:`repro_torch._sync`).
The pivoted-Cholesky bank preconditioner raises and names its slice.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import _pending
from .. import _sync
from .. import random as rnd
from ..core import engine as eng
from ..core import iterative as it
from ..core.covariances import Covariance
from ..core.engine import LOG2PI, SolverOpts
from ..core.reparam import FlatBox, apply_ordering, flat_box, to_box
from ..core.train import SCAN_KEY as PROBE_KEY
from ..core.train import _nan_to_inf
from ..data.grid import (build_inducing_grid, classify_grid, classify_grid_nd,
                         interp_weights)
from ..kernels import ops as kops
from ..kernels import ski_fused
from ..kernels.operators import (SLQPrecond, _column, _column_jacobian,
                                 _embed, _outer_taps, _selection_cells,
                                 _strang_spectrum,
                                 masked_circulant_slq_precond_bank)
from .spec import pad_boxes


def _axis_conv_bank(U, axis: int, lam, m: int, L: int):
    """Per-member circulant-embedded Toeplitz apply along one grid axis of
    a stacked multi-axis bank block: U (m_1..m_d, <batch>, c) with
    <batch> the member (and direction) dims, lam (<batch>, L_f) their
    spectra, broadcast over the other grid axes, so one rfft/irfft pair
    serves the whole bank."""
    U = torch.movedim(U, axis, 0)
    uhat = torch.fft.rfft(U, n=L, dim=0)
    nb = lam.ndim - 1
    lamb = torch.movedim(lam, -1, 0)
    lamb = lamb.reshape((lamb.shape[0],) + (1,) * (U.ndim - nb - 2)
                        + tuple(lam.shape[:-1]) + (1,))
    out = torch.fft.irfft(uhat * lamb, n=L, dim=0)[:m]
    return torch.movedim(out.to(U.dtype), 0, axis)


class BankOperator:
    """B training matrices K_b + noise2 I sharing one FFT-ready geometry.

    1-D inputs must classify "exact" (Toeplitz on the data grid) or
    "near" (SKI on the recovered grid: one inducing grid and one sparse W
    for every member, since all members see the same x); (n, d) inputs
    with composite kinds "kron" (a full product grid) or "product" (per-
    axis inducing grids and one outer-product W); irregular inputs raise
    ``ValueError``.  ``like=`` reuses another bank's geometry (same x)
    and, with ``fused="auto"``, its resolved fused decision.  A 1-D near
    grid whose points sit in distinct cells takes B7 under "auto"; a
    multi-axis bank takes the unfused Kronecker cycle, as in the JAX
    package (the members' per-axis spectra differ).
    """

    def __init__(self, kinds: Sequence[str], x, sigma_n: float = 0.0,
                 jitter: float = 0.0, like: "BankOperator" = None,
                 fused="auto"):
        splits = [kops.split_kind(k) for k in kinds]
        ds = {len(f) for f in splits}
        if len(ds) != 1:
            raise ValueError(
                "every bank member must cover the same coordinate axes; "
                f"got factor counts {sorted(len(f) for f in splits)} for "
                f"kinds {tuple(kinds)}")
        self.d = ds.pop()
        self.kinds = tuple(kinds)
        self.kinds_split = tuple(splits)
        self.B = len(self.kinds)
        self.x = x
        self.n = int(x.shape[0])
        if like is not None:
            self.idx, self.w = like.idx, like.w
            self._interp = like._interp
            self.structure = like.structure
            self.fused_geom = like.fused_geom
            self._sel_cells = like._sel_cells
            self.shape = like.shape
            self.axis_grids = like.axis_grids
            grid = like.grid
        elif self.d > 1:
            grid = self._init_nd(x)
        else:
            self.shape = self.axis_grids = None
            info = classify_grid(x)
            if info.kind == "exact":
                grid = x
                self.idx = self.w = None
                idx_np = w_np = None
            elif info.kind == "near":
                g = build_inducing_grid(x, spacing=info.h)
                idx_np, w_np = interp_weights(x, g)
                grid = torch.as_tensor(g, dtype=x.dtype, device=x.device)
                self.idx = torch.as_tensor(idx_np, dtype=torch.int64,
                                           device=x.device)
                self.w = torch.as_tensor(w_np, dtype=x.dtype,
                                         device=x.device)
            else:
                raise ValueError(
                    "BankOperator needs 'exact' or 'near' grid structure "
                    "(data.grid.classify_grid); irregular inputs have no "
                    "shared FFT geometry: use sequential sessions")
            self.structure = info.kind
            # a gappy record (W a selection matrix) unlocks the
            # determinant-corrected bank SLQ preconditioner
            self._sel_cells = None if idx_np is None else \
                _selection_cells(idx_np, w_np)
            self.fused_geom = None if idx_np is None else \
                ski_fused.build_fused_geometry(idx_np, w_np,
                                               int(grid.shape[0]))
            self._interp = None if idx_np is None else \
                ski_fused.Interpolation(self.idx, self.w,
                                        int(grid.shape[0]), self._sel_cells)
        if like is not None and fused == "auto":
            self.fused = like.fused
        elif self.idx is None or self.d > 1:
            # an exact grid has no W to fuse around; a multi-axis bank
            # takes the unfused Kronecker cycle
            self.fused = False
        else:
            self.fused = ski_fused.resolve_fused(fused, self.fused_geom)
        self.grid = grid
        if self.d == 1:
            self.m_grid = int(grid.shape[0])
            self.L = 2 * self.m_grid - 2
            self._dt0 = grid - grid[0]
        else:
            self.m_grid = int(np.prod(self.shape))
            self.L = self._dt0 = None
        self.sigma_n = float(sigma_n)
        self.jitter = float(jitter)
        self.noise2 = float(sigma_n) ** 2 + float(jitter)

    def _init_nd(self, x):
        """Multi-axis geometry: full product grids ("kron") share the
        per-axis data grids; gappy or jittered product data ("product")
        per-axis inducing grids and one outer-product W.  Anything else
        has no shared FFT geometry."""
        xc = x.detach().cpu().numpy().astype(np.float64)
        info = classify_grid_nd(xc)
        if info.kind not in ("kron", "product"):
            raise ValueError(
                "multi-axis BankOperator needs 'kron' or 'product' "
                "structure (data.grid.classify_grid_nd): a full product "
                "grid in canonical row-major order, or gappy/jittered "
                "points over per-axis grids; irregular (n, d) inputs have "
                "no shared FFT geometry: use sequential sessions")
        self.structure = info.kind
        self.fused_geom = None
        dev = x.device
        if info.kind == "kron":
            self.shape = tuple(int(m) for m in info.shape)
            self.axis_grids = tuple(torch.as_tensor(g, dtype=x.dtype,
                                                    device=dev)
                                    for g in info.grids)
            self.idx = self.w = None
            self._sel_cells = None
            self._interp = None
            return x
        grids, axis_idx, axis_w = [], [], []
        for a in range(self.d):
            g = build_inducing_grid(xc[:, a], spacing=info.axes[a].h)
            ia, wa = interp_weights(xc[:, a], g)
            grids.append(g)
            axis_idx.append(ia)
            axis_w.append(wa)
        self.shape = tuple(int(g.shape[0]) for g in grids)
        self.axis_grids = tuple(torch.as_tensor(g, dtype=x.dtype, device=dev)
                                for g in grids)
        strides = np.ones(self.d, np.int64)
        for a in range(self.d - 2, -1, -1):
            strides[a] = strides[a + 1] * self.shape[a + 1]
        IDX, WW = _outer_taps(axis_idx, axis_w, strides)
        self.idx = torch.as_tensor(IDX, dtype=torch.int64, device=dev)
        self.w = torch.as_tensor(WW, dtype=x.dtype, device=dev)
        self._sel_cells = _selection_cells(IDX, WW)
        self._interp = ski_fused.Interpolation(
            self.idx, self.w, int(np.prod(self.shape)), self._sel_cells)
        return x

    # -- per-member first columns (the only per-family computation)

    def first_columns(self, thetas, dtype):
        """k_b(grid - grid[0]) for every member: (B, m_grid), built on
        the device of the grid, once per theta bank.  theta rows are
        padded to m_max; each kind reads its own leading entries."""
        dt = self._dt0.to(dtype)
        return torch.stack([_column(k, thetas[i], dt)
                            for i, k in enumerate(self.kinds)])

    def tangent_columns(self, thetas, dtype):
        """d first_column_b / d theta_b for every member: (B, m_max,
        m_grid), the closed-form Jacobian; padded directions are zero."""
        dt = self._dt0.to(dtype)
        m_max = int(thetas.shape[1])
        out = dt.new_zeros((self.B, m_max, self.m_grid))
        for i, k in enumerate(self.kinds):
            J = _column_jacobian(k, thetas[i], dt)
            out[i, :J.shape[0]] = J
        return out

    def axis_first_columns(self, thetas, dtype):
        """Multi-axis banks: per axis, (B, m_a), member b's axis-a factor
        on that axis's grid offsets (theta split as ``ops.theta_blocks``)."""
        cols = [[] for _ in range(self.d)]
        for i, kind in enumerate(self.kinds):
            tbs = kops.theta_blocks(kind, thetas[i])
            for a, (k, tb) in enumerate(zip(self.kinds_split[i], tbs)):
                dt = (self.axis_grids[a] - self.axis_grids[a][0]).to(dtype)
                cols[a].append(_column(k, tb, dt))
        return [torch.stack(c) for c in cols]

    def _axis_direction_spectra(self, thetas, dtype, m_max: int):
        """Multi-axis bank tangents: per axis, (B, m_max, L_f) spectra.
        Direction j of member b multiplies, on axis a, the tangent
        spectrum (j in axis a's parameter block: the Kronecker product
        rule) or the axis's base spectrum; padded directions j >= m_b
        carry zeros on axis 0, so their product vanishes.  The tangent
        columns are the closed-form Jacobians (no jacfwd)."""
        out = [[] for _ in range(self.d)]
        for i, kind in enumerate(self.kinds):
            tbs = kops.theta_blocks(kind, thetas[i])
            sizes = [kops.FLAT_NPARAMS[k] for k in self.kinds_split[i]]
            offs = np.concatenate([[0], np.cumsum(sizes)])
            m_b = int(offs[-1])
            for a, (k, tb) in enumerate(zip(self.kinds_split[i], tbs)):
                dt = (self.axis_grids[a] - self.axis_grids[a][0]).to(dtype)
                base = torch.fft.rfft(_embed(_column(k, tb, dt)))
                tang = torch.fft.rfft(_embed(_column_jacobian(k, tb, dt)),
                                      dim=-1)
                lam = base[None].repeat(m_max, 1)
                lam[int(offs[a]):int(offs[a + 1])] = tang
                if a == 0 and m_b < m_max:
                    lam[m_b:] = 0.0
                out[a].append(lam)
        return [torch.stack(o) for o in out]

    def _grid_block(self, U):
        """(m_grid, B, ...) flat grid block -> (m_1, ..., m_d, B, ...)."""
        return U.reshape(self.shape + tuple(U.shape[1:]))

    def _strang_lam_nd(self, thetas, dtype, floor: float = 1e-12):
        """(B, m_1, ..., m_d): each member's Kronecker Strang spectrum
        (the outer product of its per-axis Strang spectra) plus noise."""
        lams = [torch.stack([_strang_spectrum(t, 0.0, floor) for t in c])
                for c in self.axis_first_columns(thetas, dtype)]
        Lam = lams[0]
        for lb in lams[1:]:
            Lam = Lam[..., None] * lb.reshape(
                (self.B,) + (1,) * (Lam.ndim - 1) + (lb.shape[1],))
        return Lam + self.noise2

    # -- the shared sparse interpolation (identity on exact grids)

    def _W(self, U):
        """(m_grid, ...) -> (n, ...)."""
        return U if self._interp is None else self._interp.gather(U)

    def _Wt(self, V):
        """(n, ...) -> (m_grid, ...)."""
        return V if self._interp is None else self._interp.scatter(V)

    def _conv(self, lamT, U, divide: bool = False):
        """irfft(lamT * rfft(pad_L(U))) (or the quotient by lamT) over
        axis 0, rows < m_grid."""
        uhat = torch.fft.rfft(U, n=self.L, dim=0)
        uhat = uhat / lamT if divide else uhat * lamT
        return torch.fft.irfft(uhat, n=self.L, dim=0)[:self.m_grid]

    # -- bound applies: spectra once, one launch or FFT pair per call

    def bind_matvec(self, thetas, dtype) -> Callable:
        """(n, B, c) -> (n, B, c) bank gram matvec.  Fused: the B
        spectra are built here and every call is one B7 launch; unfused:
        one rfft/irfft pair over the whole block (L = 2 m_grid - 2)."""
        noise2 = self.noise2
        if self.d > 1:
            lams = [torch.fft.rfft(_embed(c), dim=-1)
                    for c in self.axis_first_columns(thetas, dtype)]

            def mv_nd(V):
                U = self._grid_block(self._Wt(V))
                for a in range(self.d):
                    U = _axis_conv_bank(U, a, lams[a], self.shape[a],
                                        2 * self.shape[a] - 2)
                return self._W(U.reshape((self.m_grid,) + tuple(V.shape[1:]))
                               ) + noise2 * V

            return mv_nd
        T = self.first_columns(thetas, dtype)
        if self.fused:
            geom = self.fused_geom
            lams = ski_fused.spectrum(T, geom)                 # (B, L)

            def mv(V):
                return ski_fused.fused_bank_matvec(geom, lams, noise2,
                                                   V.contiguous())

            return mv
        lamT = torch.fft.rfft(_embed(T), dim=-1).T[:, :, None]  # (Lf, B, 1)

        def mv(V):
            KU = self._conv(lamT, self._Wt(V)).to(V.dtype)
            return self._W(KU) + noise2 * V

        return mv

    def bind_tangent_matvecs(self, thetas, dtype) -> Callable:
        """(n, B, c) -> (n, B, m_max, c): dK_b/dtheta_i V_b for every
        member and direction through one widened rfft/irfft pair (unfused,
        as in the JAX package)."""
        if self.d > 1:
            lams = self._axis_direction_spectra(thetas, dtype,
                                                int(thetas.shape[1]))

            def tmv_nd(V):
                U = self._grid_block(self._Wt(V))[..., None, :]
                for a in range(self.d):
                    U = _axis_conv_bank(U, a, lams[a], self.shape[a],
                                        2 * self.shape[a] - 2)
                return self._W(U.reshape((self.m_grid,)
                                         + tuple(U.shape[self.d:])))

            return tmv_nd
        R = self.tangent_columns(thetas, dtype)              # (B, mm, m)
        lamT = torch.fft.rfft(_embed(R), dim=-1).permute(2, 0, 1)

        def tmv(V):
            uhat = torch.fft.rfft(self._Wt(V), n=self.L, dim=0)  # (Lf,B,c)
            KU = torch.fft.irfft(uhat[:, :, None, :] * lamT[..., None],
                                 n=self.L, dim=0)[:self.m_grid]
            return self._W(KU.to(V.dtype))

        return tmv

    def bind_precond(self, thetas, dtype, floor: float = 1e-12
                     ) -> Callable:
        """Bank circulant CG preconditioner: each member's clipped
        embedding spectrum plus the noise, applied in grid space and
        sandwiched through the shared W.  Multi-axis banks: each member's
        Kronecker Strang spectrum and a d-D FFT pair."""
        if self.d > 1:
            LamT = torch.movedim(self._strang_lam_nd(thetas, dtype, floor),
                                 0, -1)[..., None]         # (m1..md, B, 1)
            dims = tuple(range(self.d))

            def apply_nd(r):
                U = self._grid_block(self._Wt(r))
                out = torch.fft.ifftn(torch.fft.fftn(U, dim=dims) / LamT,
                                      dim=dims).real.to(r.dtype)
                return self._W(out.reshape((self.m_grid,)
                                           + tuple(r.shape[1:])))

            return apply_nd
        T = self.first_columns(thetas, dtype)
        lam = torch.fft.rfft(_embed(T), dim=-1).real          # (B, Lf)
        lam = torch.maximum(lam, floor * torch.amax(torch.abs(lam), dim=-1,
                                                    keepdim=True))
        lamT = (lam + self.noise2).T[:, :, None]

        def apply(r):
            return self._W(self._conv(lamT, self._Wt(r), divide=True)
                           .to(r.dtype))

        return apply

    def bind_slq_precond(self, thetas, dtype, floor: float = 1e-12
                         ) -> Optional[SLQPrecond]:
        """Per-member SLQ accessors: the n-point Strang circulant on an
        exact grid; on a gappy record (W a selection matrix) the
        determinant-corrected masked circulant over the inducing grid,
        with the occ/miss geometry shared.  Multi-axis banks: the d-D
        analogues (per-member Kronecker Strang spectra).  A jittered W
        returns None (plain bank SLQ)."""
        if self.idx is not None and self._sel_cells is None:
            return None
        if self.d > 1:
            Lam = self._strang_lam_nd(thetas, dtype, floor)  # (B, m1..md)
            if self.structure == "product":
                return masked_circulant_slq_precond_bank(Lam,
                                                         self._sel_cells)
            LamT = torch.movedim(Lam, 0, -1)[..., None]
            sq = torch.sqrt(LamT)
            dims = tuple(range(self.d))
            shape, n, B = self.shape, self.n, self.B

            def apply_inv_nd(r):                             # (n, B, p)
                U = r.reshape(shape + tuple(r.shape[1:]))
                out = torch.fft.ifftn(torch.fft.fftn(U, dim=dims) / LamT,
                                      dim=dims).real.to(r.dtype)
                return out.reshape(r.shape)

            def sample_nd(key, p):
                g = rnd.normal(key, shape + (B, p), device=Lam.device,
                               dtype=Lam.dtype)
                z = torch.fft.ifftn(torch.fft.fftn(g, dim=dims) * sq,
                                    dim=dims).real
                return z.reshape(n, B, p)

            return SLQPrecond(apply_inv_nd, sample_nd,
                              torch.sum(torch.log(Lam.reshape(B, -1)),
                                        dim=1))
        T = self.first_columns(thetas, dtype)
        lam = torch.stack([_strang_spectrum(t, self.noise2, floor)
                           for t in T])                       # (B, m)
        if self.idx is not None:
            return masked_circulant_slq_precond_bank(lam, self._sel_cells)
        lamT = lam.T[:, :, None]                              # (n, B, 1)
        sq = torch.sqrt(lamT)
        n, B = self.n, self.B

        def apply_inv(r):                                     # (n, B, p)
            return torch.fft.ifft(torch.fft.fft(r, dim=0) / lamT,
                                  dim=0).real.to(r.dtype)

        def sample(key, p):
            g = rnd.normal(key, (n, B, p), device=lam.device,
                           dtype=lam.dtype)
            return torch.fft.ifft(torch.fft.fft(g, dim=0) * sq, dim=0).real

        return SLQPrecond(apply_inv, sample, torch.sum(torch.log(lam), dim=1))

    def resolve_precond(self, opts: SolverOpts) -> Optional[str]:
        """``SolverOpts(precond=...)`` -> the bank's choice, through the
        single-operator policy with the bank as a Toeplitz ("exact") or
        SKI ("near") operator of its n and noise."""
        proxy = SimpleNamespace(
            name={"exact": "toeplitz", "near": "ski", "kron": "kron",
                  "product": "product_ski"}[self.structure],
            n=self.n, noise2=self.noise2)
        return it.resolve_precond(opts.precond, proxy, opts.precond_rank)


# ---------------------------------------------------------------------------
# Batched CG and SLQ over the bank
# ---------------------------------------------------------------------------

class BankCGResult(NamedTuple):
    x: torch.Tensor        # (n, B, c)
    iters: int
    resnorm: torch.Tensor  # (B, c)


def bank_cg(matvec: Callable, b, tol: float = 1e-8, max_iter: int = 800,
            precond: Optional[Callable] = None) -> BankCGResult:
    """Batched CG over B independent SPD systems, b (n, B, c).

    A column whose residual has met the tolerance freezes (alpha = 0, its
    direction and rz held) while the shared loop, one bank matvec per
    iteration, drives the others.  The loop reads ``any(active)`` back
    once per iteration.  ``iterative.CG_STOPS`` counts one solve per
    member, as ``cg_solve`` counts one per call: at max_iter when any of
    the member's c columns is still above the tolerance, else at it.
    """
    M = precond or (lambda r: r)
    x = torch.zeros_like(b)
    r = b
    z = M(r)
    p = z
    rz = torch.sum(r * z, dim=0)                            # (B, c)
    bnorm = torch.clamp(torch.linalg.vector_norm(b, dim=0), min=1e-30)
    thresh = tol * bnorm
    i = 0
    while i < max_iter:
        act = torch.linalg.vector_norm(r, dim=0) > thresh
        if not _sync.host(torch.any(act), "cg"):
            break
        Ap = matvec(p)
        alpha = torch.where(act, rz / torch.clamp(torch.sum(p * Ap, dim=0),
                                                  min=1e-300), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.where(act, torch.sum(r * z, dim=0), rz)
        beta = torch.where(act, rz_new / torch.clamp(rz, min=1e-300), 0.0)
        p = torch.where(act, z + beta * p, p)
        rz = rz_new
        i += 1
    res = torch.linalg.vector_norm(r, dim=0) / bnorm
    B = b.shape[1]
    cut = 0
    if i == max_iter:
        cut = _sync.host(torch.sum(torch.any(res > tol, dim=-1)),
                         "cg_max_iter")
        it.CG_WORST_RESIDUAL[0] = max(it.CG_WORST_RESIDUAL[0],
                                      _sync.host(res.max(), "cg_max_iter"))
    it.CG_STOPS["max_iter"] += cut
    it.CG_STOPS["tol"] += B - cut
    return BankCGResult(x=x, iters=i, resnorm=res)


def bank_slq_logdet(matvec: Callable, n: int, B: int, key,
                    n_probes: int = 16, k: int = 64, dtype=torch.float64,
                    device=None):
    """(B,) SLQ log-determinants through the shared bank matvec: all
    B x n_probes Rademacher probes in one Lanczos recursion, averaged
    within each member."""
    z = rnd.rademacher(key, (n, B * n_probes), device=device, dtype=dtype)

    def mv2(v):
        return matvec(v.reshape(n, B, n_probes)).reshape(n, B * n_probes)

    alphas, betas = it.lanczos(mv2, z, k)
    vals = it.slq_quadrature(alphas, betas, alphas.new_ones(B * n_probes))
    return n * torch.mean(vals.reshape(B, n_probes), dim=1)


def bank_slq_logdet_precond(matvec: Callable, slq_pre, n: int, B: int, key,
                            n_probes: int = 16, k: int = 16,
                            dtype=torch.float64):
    """(B,) preconditioned-SLQ log-determinants, ln det K_b = ln det P_b
    + tr ln(P_b^{-1/2} K_b P_b^{-1/2}): the B x n_probes columns run one
    preconditioned Lanczos recurrence, probes from each member's
    N(0, P_b).  ``slq_pre`` acts on (n, B, p) blocks, its logdet (B,)."""
    z = slq_pre.sample(key, n_probes).to(dtype)               # (n, B, p)

    def flat(f):
        return lambda v: f(v.reshape(n, B, n_probes)).reshape(n, -1)

    alphas, betas, unorm2 = it.preconditioned_lanczos(
        flat(matvec), flat(slq_pre.apply_inv), z.reshape(n, -1), k)
    vals = it.slq_quadrature(alphas, betas, unorm2)
    return slq_pre.logdet.to(dtype) \
        + torch.mean(vals.reshape(B, n_probes), dim=1)


# ---------------------------------------------------------------------------
# The padded-bank profiled hyperlikelihood
# ---------------------------------------------------------------------------

class BankObjective(NamedTuple):
    """Callables over padded theta/z banks, batched over members:
    value_and_grad_z / value_z drive the NCG (negated, z coordinates);
    value_and_grad_theta serves the Laplace Hessians; stats_theta gives
    (ln P, sigma2_hat); sigma2_theta one 1-column CG, no SLQ."""

    value_and_grad_z: Callable
    value_z: Callable
    value_and_grad_theta: Callable
    stats_theta: Callable
    sigma2_theta: Callable


def make_bank_objective(bank: BankOperator, box: FlatBox, y, key,
                        opts: SolverOpts = SolverOpts()) -> BankObjective:
    """Profiled hyperlikelihood of every bank member.

    ``box`` is the padded (B, m_max) box.  One Rademacher probe block is
    fixed per objective and shared by all members; padded directions have
    exactly zero gradient and never move.
    """
    n = int(y.shape[0])
    B = bank.B
    dtype = y.dtype
    p = opts.n_probes
    lo, hi = box.lo, box.hi
    widths = hi - lo
    zp = rnd.rademacher(rnd.fold_in(key, PROBE_KEY), (n, p), device=y.device,
                        dtype=dtype)
    slq_key = rnd.fold_in(key, 1)
    choice = bank.resolve_precond(opts)
    if choice == "pivchol":
        raise _pending.pending("the bank's pivoted-Cholesky preconditioner",
                               _pending.PIVCHOL)

    def _bind(thetas):
        mv = bank.bind_matvec(thetas, dtype)
        if choice == "circulant":
            return (mv, bank.bind_precond(thetas, dtype),
                    bank.bind_slq_precond(thetas, dtype))
        return mv, None, None

    def _logdet(mv, slq_pre):
        if slq_pre is not None:
            return bank_slq_logdet_precond(mv, slq_pre, n, B, slq_key,
                                           n_probes=p, k=opts.lanczos_k,
                                           dtype=dtype)
        return bank_slq_logdet(mv, n, B, slq_key, n_probes=p,
                               k=opts.lanczos_k, dtype=dtype,
                               device=y.device)

    def _solve(mv, cg_apply, rhs):
        return bank_cg(mv, rhs.contiguous(), tol=opts.cg_tol,
                       max_iter=opts.cg_max_iter, precond=cg_apply).x

    def _lp(s2, logdet):
        return -0.5 * n * (LOG2PI + 1.0 + torch.log(s2)) - 0.5 * logdet

    def sigma2_theta(thetas):
        mv, cg_apply, _ = _bind(thetas)
        alpha = _solve(mv, cg_apply, y[:, None, None].expand(n, B, 1))
        return (y @ alpha[:, :, 0]) / n                      # (B,)

    def stats_theta(thetas):
        mv, cg_apply, slq_pre = _bind(thetas)
        alpha = _solve(mv, cg_apply, y[:, None, None].expand(n, B, 1))
        s2 = (y @ alpha[:, :, 0]) / n
        return _lp(s2, _logdet(mv, slq_pre)), s2

    def value_and_grad_theta(thetas):
        mv, cg_apply, slq_pre = _bind(thetas)
        rhs = torch.cat([y[:, None], zp], dim=1)[:, None, :].expand(
            n, B, 1 + p)
        sol = _solve(mv, cg_apply, rhs)
        alpha = sol[:, :, 0]                                  # (n, B)
        Kinv_z = sol[:, :, 1:]                                # (n, B, p)
        s2 = (y @ alpha) / n
        lp = _lp(s2, _logdet(mv, slq_pre))
        V = torch.cat([alpha[:, :, None],
                       zp[:, None, :].expand(n, B, p)], dim=-1)
        dkv = bank.bind_tangent_matvecs(thetas, dtype)(V)     # (n,B,mm,1+p)
        quad = torch.einsum("nb,nbm->bm", alpha, dkv[..., 0])
        tr = torch.mean(torch.einsum("nbp,nbmp->bmp", Kinv_z,
                                     dkv[..., 1:]), dim=-1)
        return lp, 0.5 * quad / s2[:, None] - 0.5 * tr      # (B, m_max)

    def value_and_grad_z(Z):
        theta = lo + widths * torch.sigmoid(Z)
        lp, g_theta = value_and_grad_theta(theta)
        dtheta_dz = (theta - lo) * (hi - theta) / widths
        return -lp, -(g_theta * dtheta_dz)

    def value_z(Z):
        return -stats_theta(lo + widths * torch.sigmoid(Z))[0]

    return BankObjective(value_and_grad_z, value_z, value_and_grad_theta,
                         stats_theta, sigma2_theta)


# ---------------------------------------------------------------------------
# Batched multi-start NCG with per-member line-search masks
# ---------------------------------------------------------------------------

def _ncg_minimize_bank(value_and_grad: Callable, value: Callable, Z0,
                       max_iters: int = 80, grad_tol: float = 1e-5,
                       c1: float = 1e-4, shrink: float = 0.5,
                       max_backtracks: int = 25):
    """Polak-Ribiere+ NCG over a member axis (``core.train``'s loop).

    Every objective call evaluates all members together; per-member masks
    carry the Armijo backtracking, acceptance, restart to steepest descent
    and convergence freeze.  Returns (Z, f, n_evals, iters (B,)): n_evals
    counts batched objective calls.
    """
    f, g = value_and_grad(Z0)
    f = torch.where(torch.isfinite(f), f, torch.full_like(f, torch.inf))
    Z, d = Z0, -g
    B = Z0.shape[0]
    step = torch.ones((B,), dtype=f.dtype, device=f.device)
    n_evals = 1
    iters = torch.zeros((B,), dtype=torch.int64, device=f.device)
    k = 0
    while k < max_iters:
        act = (torch.amax(torch.abs(g), dim=-1) > grad_tol) \
            & torch.isfinite(f)
        if not _sync.host(torch.any(act), "ncg"):
            break
        gd = torch.sum(g * d, dim=-1)
        bad = gd >= 0.0
        d = torch.where(bad[:, None], -g, d)
        gd = torch.where(bad, -torch.sum(g * g, dim=-1), gd)

        alpha = step
        f_new = _nan_to_inf(value(Z + alpha[:, None] * d))
        n_bt = torch.zeros((B,), dtype=torch.int64, device=f.device)
        j, ev = 0, 1
        while j < max_backtracks:
            searching = ~(f_new <= f + c1 * alpha * gd) & act
            if not _sync.host(torch.any(searching), "armijo"):
                break
            alpha = torch.where(searching, alpha * shrink, alpha)
            f_eval = _nan_to_inf(value(Z + alpha[:, None] * d))
            f_new = torch.where(searching, f_eval, f_new)
            n_bt = n_bt + searching.to(torch.int64)
            j += 1
            ev += 1

        accepted = (f_new <= f + c1 * alpha * gd) & act
        Z_new = torch.where(accepted[:, None], Z + alpha[:, None] * d, Z)
        f2, g_new = value_and_grad(Z_new)
        yk = g_new - g
        beta = torch.clamp(torch.sum(g_new * yk, dim=-1)
                           / torch.clamp(torch.sum(g * g, dim=-1),
                                         min=1e-300), min=0.0)
        d_new = -g_new + beta[:, None] * d
        step_new = torch.clamp(torch.where(n_bt == 0, alpha * 2.0, alpha),
                               1e-12, 1e3)
        Z = Z_new
        f = torch.where(accepted, f2, f)
        g = torch.where(act[:, None], g_new, g)
        d = torch.where(act[:, None], d_new, d)
        step = torch.where(act, step_new, step)
        n_evals += ev + 1
        iters = iters + act.to(torch.int64)
        k += 1
    return Z, f, n_evals, iters


# ---------------------------------------------------------------------------
# Training: (models x restarts) -> one batched NCG program
# ---------------------------------------------------------------------------

class BankTrainResult(NamedTuple):
    names: tuple                  # model names, length K
    theta_hat: torch.Tensor       # (K, m_max) best peak per model (padded)
    log_p_max: torch.Tensor       # (K,)
    sigma_f_hat: torch.Tensor     # (K,)
    n_evals: torch.Tensor         # (K,) likelihood evaluations per model
    theta_all: torch.Tensor       # (R, K, m_max) per-restart peaks
    log_p_all: torch.Tensor       # (R, K)
    iters_all: torch.Tensor       # (R, K)
    m_params: tuple               # per-model hyperparameter counts
    bank: BankOperator            # the training bank (reuse with like=)


def train_bank(covs: Sequence[Covariance], x, y, sigma_n: float, key,
               boxes: Optional[Sequence[FlatBox]] = None,
               n_starts: int = 10, max_iters: int = 80,
               grad_tol: float = 1e-5, jitter: float = 1e-8,
               opts: SolverOpts = SolverOpts()) -> BankTrainResult:
    """Train the whole candidate bank as one batched program.

    B = n_starts * K members, restart r of model k at flat index
    r * K + k; starts are uniform over the central 90% of the box in z,
    drawn per model from ``fold_in(key, k)``.
    """
    covs = list(covs)
    K = len(covs)
    kinds = [eng.resolve_kind(c) for c in covs]
    ms = tuple(c.n_params for c in covs)
    m_max = max(ms)
    if boxes is None:
        boxes = [flat_box(c, x) for c in covs]
    pbox = pad_boxes(boxes, m_max)
    pbox = FlatBox(pbox.lo.to(x.device, x.dtype),
                   pbox.hi.to(x.device, x.dtype))              # (K, m_max)
    R = n_starts
    box_full = FlatBox(pbox.lo.repeat(R, 1), pbox.hi.repeat(R, 1))

    z0s = []
    for k_i, c in enumerate(covs):
        u = rnd.uniform(rnd.fold_in(key, k_i), (R, c.n_params), 0.05, 0.95,
                        device=x.device, dtype=x.dtype)
        z = torch.log(u) - torch.log1p(-u)
        z0s.append(torch.cat([z, z.new_zeros((R, m_max - c.n_params))],
                             dim=1))
    Z0 = torch.stack(z0s, dim=1).reshape(R * K, m_max)

    bank = BankOperator(tuple(kinds) * R, x, sigma_n, jitter,
                        fused=opts.fused)
    probe_key = rnd.fold_in(key, PROBE_KEY)
    obj = make_bank_objective(bank, box_full, y, probe_key, opts)
    Z, f, n_eval_calls, iters = _ncg_minimize_bank(
        obj.value_and_grad_z, obj.value_z, Z0, max_iters=max_iters,
        grad_tol=grad_tol)

    thetas = to_box(Z, box_full)
    thetas = torch.stack([apply_ordering(covs[b % K], thetas[b])
                          for b in range(R * K)])
    theta_all = thetas.reshape(R, K, m_max)
    log_p_all = -f.reshape(R, K)
    iters_all = iters.reshape(R, K)
    fK = f.reshape(R, K)
    best = torch.argmin(torch.where(torch.isnan(fK),
                                    torch.full_like(fK, torch.inf), fK),
                        dim=0)
    cols = torch.arange(K, device=best.device)
    theta_hat = theta_all[best, cols]
    lp_hat = log_p_all[best, cols]
    # sigma_f_hat needs K^{-1} y at the peaks: one light K-member CG
    bank_k = BankOperator(tuple(kinds), x, sigma_n, jitter, like=bank)
    obj_k = make_bank_objective(bank_k, pbox, y, probe_key, opts)
    s2_hat = obj_k.sigma2_theta(theta_hat)
    n_evals = torch.full((K,), n_eval_calls * R + 1, dtype=torch.int64)
    return BankTrainResult(
        names=tuple(c.name for c in covs), theta_hat=theta_hat,
        log_p_max=lp_hat, sigma_f_hat=torch.sqrt(s2_hat), n_evals=n_evals,
        theta_all=theta_all, log_p_all=log_p_all, iters_all=iters_all,
        m_params=ms, bank=bank)


def bank_fd_hessians(value_and_grad_theta: Callable, thetas,
                     step: float = 1e-4):
    """(M, m_max, m_max) central-difference Hessians of a whole bank in
    2 m_max batched gradient evaluations, symmetrised; padded rows and
    columns are zero."""
    m_max = thetas.shape[1]
    eye = torch.eye(m_max, dtype=thetas.dtype, device=thetas.device)
    cols = []
    for i in range(m_max):
        _, gp_ = value_and_grad_theta(thetas + step * eye[i][None])
        _, gm_ = value_and_grad_theta(thetas - step * eye[i][None])
        cols.append((gp_ - gm_) / (2.0 * step))
    H = torch.stack(cols, dim=1)
    return 0.5 * (H + H.transpose(1, 2))


__all__ = ["BankOperator", "BankCGResult", "BankObjective",
           "BankTrainResult", "bank_cg", "bank_slq_logdet",
           "bank_slq_logdet_precond", "make_bank_objective", "train_bank",
           "bank_fd_hessians", "pad_boxes"]
