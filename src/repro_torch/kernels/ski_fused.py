"""The fused SKI sandwich: B5 (gram), B6 (stacked tangents), B7 (the gram
of a bank of members that share one geometry), and on 2-D product grids
B10 (gram) and B11 (stacked tangents).

Counterparts of ``fused_gram_matvec``, ``fused_tangent_matvecs``,
``fused_bank_matvec``, ``fused_gram_matvec_nd`` and
``fused_tangent_matvecs_nd`` in ``repro/kernels/ski_fused.py``.  On near-grid
data every point sits in a distinct cell of the inducing grid, so W and
W^T are banded maps around one row gather (``occ``: cell -> point row,
``cell``: point -> cell):

    (W K_grid W^T + noise2 I) v = W irfft(lam * rfft(pad(W^T v))) + noise2 v

with lam the real spectrum of the grid covariance's circulant embedding
(length L, a power of two >= 2 m_grid - 1; the filler between the two
mirrored halves is don't-care).  The CUDA kernels do the whole sandwich
with a hand-written FFT.  B5, B6 and B7 (``csrc/ski_gram.cu``,
``csrc/ski_tangent.cu``, ``csrc/ski_bank.cu``) run it on line transforms
in shared memory (``csrc/ski_lines_1d.cuh``): a four-step split
L = L1 L2, 4 launches and one scratch whatever the members or
directions (:func:`gram_1d_plan`; B6 runs W^T and the forward transforms
once for all its tangent spectra); :func:`fused_sandwich_four_step` and
:func:`fused_tangent_four_step` are that order on ``torch.fft``, for the
tests.  The spectrum is built outside the kernel (:func:`spectrum`), once
per theta and solve, on ``torch.fft``; natural frequency order, so
nothing is permuted.

On a 2-D product grid (m1 x m2 cells, flat row-major) the same sandwich
runs with the outer product of two axis spectra, lam1 (L1,) and lam2
(L2,), each a power-of-two embedding of its axis's first column; the
joint stencil's s1 s2 flat offsets d1 m2 + d2 travel as an explicit
list.  B10 and B11 (``csrc/ski_gram_2d.cu``, ``csrc/ski_tangent_2d.cu``,
both on ``csrc/ski_lines_2d.cuh``) use that the outer-product spectrum
makes the 2-D circulant a product of two axis circulants: W^T with the
axis-1 convolution of the m1 occupied rows, then the axis-0 convolution
of the m2 columns, each line transformed in shared memory, then W: three
launches, one compact scratch (:func:`gram_2d_plan`).  B11 runs W^T and
the forward row transforms once for all its tangent directions, each
direction's row inverse and columns by its own pair of axis spectra.  An
axis longer than the shared-memory line cap takes the global passes (B11:
B10's gram once per direction).  :func:`fused_gram_matvec_nd_pruned` and
:func:`fused_tangent_matvecs_nd_pruned` are that order on ``torch.fft``,
for the tests.

Each wrapper takes its plain PyTorch version when, and only when, the
tensors lie on the CPU; on CUDA tensors it launches its kernel or raises.
The plain versions are the unfused composition on ``torch.fft``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _cuda

# Accepted SolverOpts(fused=...) values.
FUSED_CHOICES = (True, False, "auto")


# ---------------------------------------------------------------------------
# The sparse interpolation applications (shared with the operators)
# ---------------------------------------------------------------------------

def interp_gather(idx, w, U):
    """W u: (m_grid, ...) -> (n, ...); idx/w the (n, s) rows of W."""
    w = w.to(U.dtype).reshape(w.shape + (1,) * (U.ndim - 1))
    return torch.sum(w * U[idx], dim=1)


def interp_scatter(idx, w, m_grid: int, V):
    """W^T v: (n, ...) -> (m_grid, ...), a scatter-add of each point's s
    weighted nodes (``index_add_``)."""
    w = w.to(V.dtype).reshape(w.shape + (1,) * (V.ndim - 1))
    contrib = (w * V[:, None]).reshape((-1,) + tuple(V.shape[1:]))
    out = V.new_zeros((m_grid,) + tuple(V.shape[1:]))
    return out.index_add_(0, idx.reshape(-1), contrib)


class Interpolation:
    """W as its (n, s) index/weight rows over m_grid cells, applied by
    :func:`interp_gather` / :func:`interp_scatter`.  When W is a selection
    (``cells``: one weight 1 per row, on distinct cells, as on a gappy
    record) the applies are a plain gather and scatter: the same numbers
    (the other weights are exact zeros) in a few operations, which the
    preconditioners and the unfused bank run once per CG iteration."""

    def __init__(self, idx, w, m_grid: int, cells=None):
        self.idx = idx
        self.w = w
        self.m_grid = int(m_grid)
        self.cells = None if cells is None else torch.as_tensor(
            cells, dtype=torch.int64, device=idx.device)

    def gather(self, U):
        """W u: (m_grid, ...) -> (n, ...)."""
        if self.cells is not None:
            return U[self.cells]
        return interp_gather(self.idx, self.w, U)

    def scatter(self, V):
        """W^T v: (n, ...) -> (m_grid, ...)."""
        if self.cells is not None:
            out = V.new_zeros((self.m_grid,) + tuple(V.shape[1:]))
            out[self.cells] = V
            return out
        return interp_scatter(self.idx, self.w, self.m_grid, V)


# ---------------------------------------------------------------------------
# Geometry, built host-side once per operator
# ---------------------------------------------------------------------------

def embed_length(m: int) -> int:
    """The FFT length: the smallest power of two >= 2 m - 1."""
    return 1 << max(2 * int(m) - 2, 1).bit_length()


class FusedSKIGeometry:
    """Constants of the fused sandwich for one (x, grid, W).

    occ:   (m_grid,) int32, cell -> data row (n marks an empty cell).
    wcell: (m_grid, s) float64, the occupying point's stencil weights
           (zero rows for empty cells).
    cell:  (n,) int32, data row -> its distinct grid cell.
    offs:  the stencil offsets d (consecutive): nodes touched are cell + d.
    L:     the FFT length (power of two >= 2 m_grid - 1).
    idx, w: the (n, s) rows of W, for the plain versions.
    split: the four-step split (L1, L2) that B5 and B7 run on this
           geometry; None (the default) takes :func:`gram_1d_plan`'s.
    """

    def __init__(self, n, m_grid, occ, wcell, cell, offs, L, idx, w):
        self.n = int(n)
        self.m_grid = int(m_grid)
        self.occ = occ
        self.wcell = wcell
        self.cell = cell
        self.offs = tuple(int(d) for d in offs)
        self.L = int(L)
        self.idx = idx
        self.w = w
        self.split = None
        self._tensors = {}
        self._calls = {}

    def tensors(self, device, dtype) -> dict:
        """The constants as tensors on ``device`` (weights in ``dtype``),
        made once per (device, dtype)."""
        key = (torch.device(device), dtype)
        if key not in self._tensors:
            dev = key[0]
            self._tensors[key] = dict(
                occ=torch.as_tensor(self.occ, dtype=torch.int32, device=dev),
                wcell=torch.as_tensor(self.wcell, dtype=dtype, device=dev),
                cell=torch.as_tensor(self.cell, dtype=torch.int32,
                                     device=dev),
                offs=torch.as_tensor(self.offs, dtype=torch.int32,
                                     device=dev),
                idx=torch.as_tensor(self.idx, dtype=torch.int64, device=dev),
                w=torch.as_tensor(self.w, dtype=dtype, device=dev))
        return self._tensors[key]


def _axis_band(idx_a: np.ndarray):
    """(cell_a, offs_a) of one axis's stencil rows, or None when the rows
    are not one uniform band."""
    s = idx_a.shape[1]
    center = 1 if s == 4 else 0            # cubic taps -1..2, linear 0..1
    cell = idx_a[:, center].astype(np.int64)
    offs = idx_a[0] - cell[0]
    if not np.all(idx_a == cell[:, None] + offs[None, :]):
        return None
    return cell, offs


def build_fused_geometry(idx, w, m_grid: int) -> Optional[FusedSKIGeometry]:
    """Fused-kernel constants from the (idx, w) of ``interp_weights``, or
    None when the geometry is not distinct-cell banded (then only the
    unfused composition applies)."""
    idx = np.asarray(idx)
    w = np.asarray(w, np.float64)
    n, s = idx.shape
    band = _axis_band(idx)
    if band is None:
        return None                        # non-stencil rows
    cell, offs = band
    if not np.array_equal(offs, offs[0] + np.arange(s)):
        return None                        # the kernels take d0 .. d0+s-1
    if np.unique(cell).shape[0] != n:
        return None                        # duplicate cells (not near-grid)
    occ = np.full(m_grid, n, np.int32)
    occ[cell] = np.arange(n, dtype=np.int32)
    wcell = np.zeros((m_grid, s), np.float64)
    wcell[cell] = w
    return FusedSKIGeometry(n, m_grid, occ, wcell, cell.astype(np.int32),
                            offs, embed_length(m_grid), idx, w)


def resolve_fused(fused, geom: Optional[FusedSKIGeometry]) -> bool:
    """SolverOpts(fused=...) -> bool for one bound operator.

    ``True`` demands the kernel (ValueError if the geometry cannot take
    it); ``False`` takes the unfused composition; ``"auto"`` takes the
    kernel whenever the geometry is distinct-cell.  The JAX package's
    interpret-mode size crossover and VMEM budget were measured for
    another machine and are not carried over.
    """
    if fused not in FUSED_CHOICES:
        raise ValueError(f"unknown fused mode {fused!r}; choose from "
                         f"{FUSED_CHOICES}")
    if fused is False:
        return False
    if geom is None:
        if fused is True:
            raise ValueError(
                "fused=True but the SKI interpolation geometry is not "
                "distinct-cell banded (points share inducing cells: an "
                "operator='ski' override on scattered data?); use "
                "fused='auto' or False to take the unfused composition")
        return False
    return True


def spectrum(first_column, geom: FusedSKIGeometry):
    """1/L-normalised real circulant spectrum of grid first column(s).

    ``first_column`` (..., m_grid) -> (..., L): the symmetric embedding
    [t_0 .. t_{m-1}, 0 .., t_{m-1} .. t_1] padded to L, its FFT's real
    part over L (the kernels' inverse transform is un-normalised).
    """
    return _axis_spectrum(first_column, geom.m_grid, geom.L)


def _axis_spectrum(t, m: int, L: int):
    """:func:`spectrum` of first column(s) t (..., m) at length L."""
    c = t.new_zeros(t.shape[:-1] + (L,))
    c[..., :m] = t
    c[..., L - m + 1:] = torch.flip(t[..., 1:], dims=(-1,))
    return torch.fft.fft(c, dim=-1).real / L


# ---------------------------------------------------------------------------
# Plain versions: the unfused composition
# ---------------------------------------------------------------------------

def _grid_conv_plain(geom, lam, u):
    """irfft(lam * rfft(pad(u))) rows < m_grid, u (m_grid, b)."""
    L, m = geom.L, geom.m_grid
    uh = torch.fft.rfft(u, n=L, dim=0)
    return torch.fft.irfft(lam[: L // 2 + 1, None] * uh, n=L, dim=0,
                           norm="forward")[:m]


def fused_gram_matvec_plain(geom: FusedSKIGeometry, lam, noise2: float, v):
    """W irfft(lam * rfft(pad(W^T v))) + noise2 v on ``torch.fft``."""
    t = geom.tensors(v.device, v.dtype)
    u = interp_scatter(t["idx"], t["w"], geom.m_grid, v)
    ku = _grid_conv_plain(geom, lam, u)
    return interp_gather(t["idx"], t["w"], ku) + noise2 * v


def fused_tangent_matvecs_plain(geom: FusedSKIGeometry, lams, v):
    """W irfft(lams[i] * rfft(pad(W^T v))) for every direction i."""
    t = geom.tensors(v.device, v.dtype)
    L, m = geom.L, geom.m_grid
    uh = torch.fft.rfft(interp_scatter(t["idx"], t["w"], m, v), n=L, dim=0)
    out = [interp_gather(t["idx"], t["w"], torch.fft.irfft(
        lam[: L // 2 + 1, None] * uh, n=L, dim=0, norm="forward")[:m])
        for lam in lams]
    return torch.stack(out) if out else v.new_zeros((0,) + tuple(v.shape))


def fused_bank_matvec_plain(geom: FusedSKIGeometry, lams, noise2: float,
                            V):
    """Member q of V (n, B, c): W irfft(lams[q] * rfft(pad(W^T V[:, q])))
    + noise2 V[:, q], every member through its own spectrum."""
    t = geom.tensors(V.device, V.dtype)
    L, m = geom.L, geom.m_grid
    uh = torch.fft.rfft(interp_scatter(t["idx"], t["w"], m, V), n=L, dim=0)
    ku = torch.fft.irfft(lams[:, : L // 2 + 1].T[:, :, None] * uh, n=L,
                         dim=0, norm="forward")[:m]
    return interp_gather(t["idx"], t["w"], ku) + noise2 * V


# ---------------------------------------------------------------------------
# B5 / B6 / B7 wrappers
# ---------------------------------------------------------------------------

def _check(geom: FusedSKIGeometry, lams, v, layout: str = "(n, b)"):
    """Validate a wrapper's inputs; returns the device they lie on."""
    if v.ndim != layout.count(",") + 1 or v.shape[0] != geom.n:
        raise ValueError(f"v must be {layout} with n = {geom.n}, got "
                         f"{tuple(v.shape)}")
    if lams.ndim != 2 or lams.shape[1] != geom.L:
        raise ValueError(f"spectra must be (rows, {geom.L}), got "
                         f"{tuple(lams.shape)}")
    if v.device != lams.device:
        raise ValueError(f"v and the spectrum must be on one device, got "
                         f"{v.device} and {lams.device}")
    if v.dtype != lams.dtype:
        raise TypeError(f"v and the spectrum must share one dtype, got "
                        f"{v.dtype} and {lams.dtype}")
    if not (v.is_contiguous() and lams.is_contiguous()):
        raise ValueError("v and the spectrum must be contiguous")
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {v.device}")
    return v.device


def fused_gram_matvec(geom: FusedSKIGeometry, lam, noise2: float, v):
    """B5: (W K_grid W^T + noise2 I) v, v (n, b) -> (n, b), one call (4
    launches: :func:`gram_1d_plan`).

    ``lam`` is the (L,) spectrum from :func:`spectrum`.
    """
    dev = _check(geom, lam[None], v)
    if dev.type == "cpu":
        return fused_gram_matvec_plain(geom, lam, noise2, v)
    return _launch_gram_1d("ski_gram", geom, lam[None], noise2, v)


def fused_tangent_matvecs(geom: FusedSKIGeometry, lams, v):
    """B6: W (dK_grid/dtheta_i) W^T v for all m_dirs directions, one call
    (4 launches: :func:`gram_1d_plan` with the directions): (m_dirs, n,
    b).  ``lams`` (m_dirs, L) tangent spectra (the :func:`spectrum` of
    each first-column Jacobian row).  No noise: the diagonal does not
    depend on theta."""
    dev = _check(geom, lams, v)
    if dev.type == "cpu":
        return fused_tangent_matvecs_plain(geom, lams, v)
    m_dirs = int(lams.shape[0])
    out = v.new_empty((m_dirs,) + tuple(v.shape))
    if out.numel() == 0:
        return out
    c = int(v.shape[1])
    return _launch_lines_1d("ski_tangent", geom, lams, v, out,
                            (m_dirs, v.data_ptr(), c), (c + 1) // 2, m_dirs)


def fused_bank_matvec(geom: FusedSKIGeometry, lams, noise2: float, V):
    """B7: the bank gram, member q of V (n, B, c) times
    (W K_q W^T + noise2 I), one call (4 launches: :func:`gram_1d_plan`):
    (n, B, c).  ``lams`` (B, L) are the members' spectra from
    :func:`spectrum`; all share the geometry."""
    dev = _check(geom, lams, V, "(n, B, c)")
    if lams.shape[0] != V.shape[1]:
        raise ValueError(f"one spectrum per member: {lams.shape[0]} "
                         f"spectra for B = {V.shape[1]}")
    if dev.type == "cpu":
        return fused_bank_matvec_plain(geom, lams, noise2, V)
    return _launch_gram_1d("ski_bank", geom, lams, noise2, V)


# ---------------------------------------------------------------------------
# B5's, B6's and B7's plan: four steps of shared-memory line transforms
# ---------------------------------------------------------------------------

class Gram1DPlan(NamedTuple):
    """How B5, B6 and B7 run one call (csrc/ski_lines_1d.cuh).

    cap:      the longest line transformed in shared memory.
    split:    (L1, L2), L = L1 L2 with L1 <= cap and 2 <= L2 <= cap.
    cols:     (tpl, lpb) of steps 1 and 3 (lines of L2 points).
    rows:     (tpl, lpb) of step 2 (lines of L1 points; three buffers a
              line where B6's directions keep the forward line).
    launches: kernel launches per call.
    scratch:  complex values of the one scratch buffer, dirs * lines * L.
    """
    cap: int
    split: tuple
    cols: tuple
    rows: tuple
    launches: int
    scratch: int


@functools.lru_cache(maxsize=256)
def gram_1d_plan(L: int, lines: int, itemsize: int,
                 split: Optional[tuple] = None, dirs: int = 1) -> Gram1DPlan:
    """The plan of B5 and B7 (``dirs`` = 1) and of B6 (``dirs`` tangent
    spectra) for ``lines`` packed columns (B ceil(c / 2)) of length L:
    the columns forward, the rows with each direction's spectrum, every
    direction's columns back and W (four launches) on the split (L1, L2),
    by default L2 = min(cap, 2^ceil(log2 L / 2)) and L1 = L / L2.  L >
    cap^2, a row line that does not fit a block (at dirs > 1 three
    buffers of L1 + 1: L1 <= 2048 in float64), or a split that does not
    multiply to L or has a factor out of range, is refused.  There is no
    one-line branch where L <= cap: one block per packed column lost to
    the four-step on the card (PERF.md §6)."""
    L, lines, dirs = int(L), int(lines), int(dirs)
    cap = line_cap(itemsize)
    if split is None:
        L2 = min(cap, 1 << (L.bit_length() // 2))
        L1 = L // L2
        if L1 > cap:
            raise ValueError(f"the SKI embedding L = {L} is longer than the "
                             f"four-step limit cap^2 = {cap * cap} (line "
                             f"cap {cap})")
    else:
        L1, L2 = (int(f) for f in split)
        if L1 * L2 != L or not (1 <= L1 <= cap and 2 <= L2 <= cap):
            raise ValueError(f"split {split} is not L1 x L2 = {L} with "
                             f"L1 <= {cap} and 2 <= L2 <= {cap}")
    bufs = 3 if dirs > 1 else 2
    if line_smem_bytes(L1, 1, itemsize, bufs) > LINE_SMEM_LIMIT:
        raise ValueError(f"the rows of L1 = {L1} do not fit a block with "
                         f"{dirs} directions (three buffers a line)")
    return Gram1DPlan(cap, (L1, L2), line_kernel_plan(L2, L1, itemsize),
                      line_kernel_plan(L1, L2, itemsize, bufs), 4,
                      dirs * lines * L)


def _launch_gram_1d(name, geom, lams, noise2, v):
    """B5 (v (n, b), lams (1, L)) or B7 (v (n, B, c), lams (B, L)) on the
    card: :func:`_launch_lines_1d` with the noise."""
    B, c = (1, int(v.shape[1])) if v.ndim == 2 else (int(v.shape[1]),
                                                       int(v.shape[2]))
    out = torch.empty_like(v)
    if out.numel() == 0:
        return out
    return _launch_lines_1d(name, geom, lams, v, out,
                            (float(noise2), v.data_ptr(), B, c),
                            B * ((c + 1) // 2))


def _launch_lines_1d(name, geom, lams, v, out, args, lines, dirs=1):
    """One call of the four-step pipeline (B5, B6 or B7) on the card: one
    scratch allocation, one C call ``name``_<dtype>(n, m, L, s, offs,
    occ, wcell, cell, lams, *args, out, scratch, L1, plan..., stream),
    counted in LAUNCHES[name].  Every CG and Lanczos iteration on
    near-grid data makes such a call, so what depends only on the
    geometry, the shape and the dtype (the plan on ``geom.split``, the
    constants' pointers) is kept on the geometry."""
    key = (name, v.device, v.dtype, tuple(v.shape[1:]), geom.split, dirs)
    call = geom._calls.get(key)
    if call is None:
        t = geom.tensors(v.device, v.dtype)
        plan = gram_1d_plan(geom.L, lines, v.element_size(), geom.split,
                            dirs)
        call = geom._calls[key] = (
            f"{name}_{_cuda.dtype_suffix(v.dtype)}", plan.scratch,
            (geom.n, geom.m_grid, geom.L, len(geom.offs),
             t["offs"].data_ptr(), t["occ"].data_ptr(),
             t["wcell"].data_ptr(), t["cell"].data_ptr()),
            (plan.split[0], *plan.cols, *plan.rows))
    fn, n_scratch, head, tail = call
    scratch = torch.empty((n_scratch, 2), dtype=v.dtype, device=v.device)
    _cuda.call(fn, *head, lams.data_ptr(), *args, out.data_ptr(),
               scratch.data_ptr(), *tail, _cuda.stream_ptr(v.device))
    _cuda.LAUNCHES[name] += 1
    return out


def _grid_conv_four_step(geom, lams, u, split):
    """The convolutions of :func:`_grid_conv_plain` on u (m, B, c), member
    q of direction i through lams[i, q] (lams (dirs, B, L)), in the
    kernels' order (csrc/ski_lines_1d.cuh): two real columns of one
    member packed in one complex line (a zero half for an odd c), then
    the four steps of split (L1, L2): the transforms over n2 of the cells
    n1 + L1 n2 times w_L^{n1 k2} and over n1, once for every direction;
    then per direction lam[k2 + L2 k1], back over k1 times w_L^{-n1 k2},
    back over k2, cropped to m.  Returns (dirs, m, B, c)."""
    L, m = geom.L, geom.m_grid
    B, c = u.shape[1], u.shape[2]
    if c % 2:
        u = torch.cat([u, u.new_zeros((m, B, 1))], dim=2)
    Z = torch.complex(u[..., 0::2], u[..., 1::2])             # (m, B, P)
    x = torch.cat([Z, Z.new_zeros((L - m,) + Z.shape[1:])])
    L1, L2 = split
    X = x.reshape((L2, L1) + x.shape[1:])                      # [n2, n1]
    e = (torch.arange(L2)[:, None] * torch.arange(L1)[None, :]) % L
    tw = torch.polar(torch.ones((L2, L1), dtype=u.dtype),
                     -2.0 * torch.pi * e.to(u.dtype) / L)[:, :, None, None]
    F = torch.fft.fft(torch.fft.fft(X, dim=0) * tw, dim=1)     # [k2, k1]
    out = []
    for lam in lams:                                           # (B, L)
        lam2 = lam.T.reshape(L1, L2, B, 1).transpose(0, 1)     # [k2, k1]
        Y = torch.fft.ifft(lam2 * F, dim=1, norm="forward") * tw.conj()
        z = torch.fft.ifft(Y, dim=0, norm="forward").reshape(x.shape)[:m]
        out.append(torch.stack([z.real, z.imag], dim=-1)
                   .reshape(m, B, -1)[..., :c])
    return torch.stack(out)


def fused_sandwich_four_step(geom: FusedSKIGeometry, lams, noise2: float, V,
                             split=None):
    """B5's and B7's function in their order (:func:`_grid_conv_four_step`)
    on V (n, b) with lams (L,), or V (n, B, c) with lams (B, L), on
    ``split`` (None: the geometry's, as the kernels take it): the CPU twin
    of the kernels' arithmetic, used by the tests; the plain versions the
    card holds them against stay :func:`fused_gram_matvec_plain` and
    :func:`fused_bank_matvec_plain`."""
    split = gram_1d_plan(geom.L, 1, V.element_size(),
                         geom.split if split is None else tuple(split)).split
    t = geom.tensors(V.device, V.dtype)
    U = V[:, None] if V.ndim == 2 else V
    lams = lams[None] if lams.ndim == 1 else lams
    u = interp_scatter(t["idx"], t["w"], geom.m_grid, U)
    ku = _grid_conv_four_step(geom, lams[None], u, split)[0]
    out = interp_gather(t["idx"], t["w"], ku) + noise2 * U
    return out[:, 0] if V.ndim == 2 else out


def fused_tangent_four_step(geom: FusedSKIGeometry, lams, v, split=None):
    """B6's function in its order on v (n, b) with lams (m_dirs, L): W^T
    and the forward transforms once, then each direction's spectrum, its
    inverse transforms and W (:func:`_grid_conv_four_step`), on ``split``
    (None: the geometry's, as the kernel takes it): (m_dirs, n, b).  The
    CPU twin of the kernel's arithmetic, used by the tests; the card
    holds the kernel against :func:`fused_tangent_matvecs_plain`."""
    dirs = int(lams.shape[0])
    split = gram_1d_plan(geom.L, 1, v.element_size(),
                         geom.split if split is None else tuple(split),
                         max(dirs, 1)).split
    t = geom.tensors(v.device, v.dtype)
    u = interp_scatter(t["idx"], t["w"], geom.m_grid, v[:, None])
    ku = _grid_conv_four_step(geom, lams[:, None], u, split)  # (dirs,m,1,b)
    out = [interp_gather(t["idx"], t["w"], k[:, 0]) for k in ku]
    return torch.stack(out) if out else v.new_zeros((0,) + tuple(v.shape))


# ---------------------------------------------------------------------------
# 2-D product grids: B10 / B11
# ---------------------------------------------------------------------------

class FusedSKIGeometry2D(FusedSKIGeometry):
    """Constants of the fused 2-D product-SKI sandwich for one (x, grids,
    W).  The flat-cell analogue of :class:`FusedSKIGeometry`:

    shape: (m1, m2) inducing cells per axis; cells are c = r1 m2 + r2.
    occ:   (m1 m2,) int32, cell -> data row (n marks an empty cell).
    wcell: (m1 m2, s1 s2) the occupant's outer-product stencil weights.
    cell:  (n,) int32, data row -> its distinct flat cell.
    offs:  the s1 s2 flat offsets d1 m2 + d2 of the joint stencil.
    Ls:    (L1, L2), per axis a power of two >= 2 m_a - 1.
    idx, w: the joint (n, s1 s2) rows of W, for the plain versions.
    """

    def __init__(self, n, shape, occ, wcell, cell, offs, Ls, idx, w):
        self.n = int(n)
        self.shape = tuple(int(m) for m in shape)
        self.m_grid = self.shape[0] * self.shape[1]
        self.occ = occ
        self.wcell = wcell
        self.cell = cell
        self.offs = tuple(int(d) for d in offs)
        self.Ls = tuple(int(L) for L in Ls)
        self.idx = idx
        self.w = w
        self._tensors = {}


def build_fused_geometry_nd(axis_idx, axis_w,
                            shape) -> Optional[FusedSKIGeometry2D]:
    """Fused 2-D constants from the per-axis (idx, w) of
    ``interp_weights``, or None when d != 2, an axis is not one uniform
    band, or two points share a flat cell (then only the unfused
    composition applies).  A uniform band keeps every stencil inside both
    axes' ranges, so the flat shifts d1 m2 + d2 never wrap across a row."""
    if len(shape) != 2:
        return None
    bands = [_axis_band(np.asarray(ia)) for ia in axis_idx]
    if any(b is None for b in bands):
        return None
    m1, m2 = int(shape[0]), int(shape[1])
    (c1, o1), (c2, o2) = bands
    n = c1.shape[0]
    cell = c1 * m2 + c2
    if np.unique(cell).shape[0] != n:
        return None
    offs = [int(d1) * m2 + int(d2) for d1 in o1 for d2 in o2]
    w1 = np.asarray(axis_w[0], np.float64)
    w2 = np.asarray(axis_w[1], np.float64)
    wjoint = (w1[:, :, None] * w2[:, None, :]).reshape(n, -1)
    idx = (np.asarray(axis_idx[0], np.int64)[:, :, None] * m2
           + np.asarray(axis_idx[1], np.int64)[:, None, :]).reshape(n, -1)
    occ = np.full(m1 * m2, n, np.int32)
    occ[cell] = np.arange(n, dtype=np.int32)
    wcell = np.zeros((m1 * m2, wjoint.shape[1]), np.float64)
    wcell[cell] = wjoint
    return FusedSKIGeometry2D(n, (m1, m2), occ, wcell, cell.astype(np.int32),
                              offs, (embed_length(m1), embed_length(m2)),
                              idx, wjoint)


def spectrum_nd(first_columns, geom: FusedSKIGeometry2D):
    """Per-axis 1/L_a-normalised spectra (lam1 (..., L1), lam2 (..., L2));
    the kernels multiply by their outer product."""
    return tuple(_axis_spectrum(t, geom.shape[a], geom.Ls[a])
                 for a, t in enumerate(first_columns))


def tangent_spectra_nd(kron, theta, geom: FusedSKIGeometry2D, dtype):
    """The spectrum pairs of the m flat directions, ((m, L1), (m, L2)).

    Direction i in axis a's parameter block multiplies by (dlam_a^i)
    (x) (the other axis's base spectrum): the product rule at operator
    level.  The tangent first columns are the closed-form Jacobians of
    the axis Toeplitz operators (no jacfwd)."""
    bases = spectrum_nd(kron.first_columns(theta, dtype), geom)
    pairs = ([], [])
    for a in range(2):
        rows = kron.axes_ops[a].first_column_jacobian(
            theta[kron.slices[a]], dtype)                 # (p_a, m_a)
        lam_t = _axis_spectrum(rows, geom.shape[a], geom.Ls[a])
        other = bases[1 - a][None].expand(rows.shape[0], -1)
        pairs[a].append(lam_t)
        pairs[1 - a].append(other)
    return (torch.cat(pairs[0]).contiguous(),
            torch.cat(pairs[1]).contiguous())


def _grid_conv_2d_plain(geom, lam1, lam2, u):
    """irfft2((lam1 (x) lam2) * rfft2(pad(u))) cells < (m1, m2), u
    (m1 m2, b) flat."""
    (m1, m2), (L1, L2) = geom.shape, geom.Ls
    U = u.reshape((m1, m2) + tuple(u.shape[1:]))
    Uh = torch.fft.rfftn(U, s=(L1, L2), dim=(0, 1))
    lam = lam1[:, None] * lam2[None, : L2 // 2 + 1]
    lam = lam.reshape(lam.shape + (1,) * (U.ndim - 2))
    ku = torch.fft.irfftn(lam * Uh, s=(L1, L2), dim=(0, 1), norm="forward")
    return ku[:m1, :m2].reshape(u.shape)


def fused_gram_matvec_nd_plain(geom: FusedSKIGeometry2D, lams, noise2: float,
                               v):
    """W irfft2((lam1 (x) lam2) rfft2(pad(W^T v))) + noise2 v on
    ``torch.fft``."""
    t = geom.tensors(v.device, v.dtype)
    u = interp_scatter(t["idx"], t["w"], geom.m_grid, v)
    ku = _grid_conv_2d_plain(geom, lams[0], lams[1], u)
    return interp_gather(t["idx"], t["w"], ku) + noise2 * v


def fused_tangent_matvecs_nd_plain(geom: FusedSKIGeometry2D, lam_pairs, v):
    """W irfft2((lam1[i] (x) lam2[i]) rfft2(pad(W^T v))) for every
    direction i: (m, n, b)."""
    t = geom.tensors(v.device, v.dtype)
    u = interp_scatter(t["idx"], t["w"], geom.m_grid, v)
    out = [interp_gather(t["idx"], t["w"],
                         _grid_conv_2d_plain(geom, l1, l2, u))
           for l1, l2 in zip(*lam_pairs)]
    return torch.stack(out) if out else v.new_zeros((0,) + tuple(v.shape))


def _check_2d(geom: FusedSKIGeometry2D, lams, v):
    """Validate a 2-D wrapper's inputs; returns the device they lie on."""
    if v.ndim != 2 or v.shape[0] != geom.n:
        raise ValueError(f"v must be (n, b) with n = {geom.n}, got "
                         f"{tuple(v.shape)}")
    lam1, lam2 = lams
    if (lam1.ndim != 2 or lam2.ndim != 2 or lam1.shape[0] != lam2.shape[0]
            or lam1.shape[1] != geom.Ls[0] or lam2.shape[1] != geom.Ls[1]):
        raise ValueError(f"spectra must be (rows, {geom.Ls[0]}) and (rows, "
                         f"{geom.Ls[1]}), got {tuple(lam1.shape)} and "
                         f"{tuple(lam2.shape)}")
    for lam in lams:
        if v.device != lam.device:
            raise ValueError(f"v and the spectra must be on one device, "
                             f"got {v.device} and {lam.device}")
        if v.dtype != lam.dtype:
            raise TypeError(f"v and the spectra must share one dtype, got "
                            f"{v.dtype} and {lam.dtype}")
        if not lam.is_contiguous():
            raise ValueError("the spectra must be contiguous")
    if not v.is_contiguous():
        raise ValueError("v must be contiguous")
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {v.device}")
    return v.device


def fused_gram_matvec_nd(geom: FusedSKIGeometry2D, lams, noise2: float, v):
    """B10: (W K_kron W^T + noise2 I) v on a 2-D product grid, v (n, b)
    -> (n, b), one call (three launches at the cell's shape: see
    :func:`gram_2d_plan`).  ``lams`` = (lam1 (L1,), lam2 (L2,)) from
    :func:`spectrum_nd`."""
    lams2 = (lams[0][None], lams[1][None])
    dev = _check_2d(geom, lams2, v)
    if dev.type == "cpu":
        return fused_gram_matvec_nd_plain(geom, lams, noise2, v)
    return _launch_gram_2d(geom, lams, noise2, v)


def fused_tangent_matvecs_nd(geom: FusedSKIGeometry2D, lam_pairs, v):
    """B11: W (dK_kron/dtheta_i) W^T v for all m directions on a 2-D
    product grid, one call (three launches at the cell's shape whatever m
    is: see :func:`gram_2d_plan` with ``dirs``): (m, n, b).
    ``lam_pairs`` = ((m, L1), (m, L2)) from :func:`tangent_spectra_nd`.
    No noise."""
    dev = _check_2d(geom, lam_pairs, v)
    if dev.type == "cpu":
        return fused_tangent_matvecs_nd_plain(geom, lam_pairs, v)
    return _launch_tangent_2d(geom, lam_pairs, v)


# ---------------------------------------------------------------------------
# B10's plan: shared-memory line transforms over the occupied lines
# ---------------------------------------------------------------------------

# csrc/ski_lines_2d.cuh: a line kernel's block takes lpb lines of tpl
# threads each; LINE_THREADS threads per block when the lines allow, at
# most LINE_TPL threads per line, and lpb cut until the block's shared
# memory is at most LINE_SMEM_TARGET (two blocks per SM) unless one line
# alone needs more (up to LINE_SMEM_LIMIT, the opt-in limit per block)
LINE_THREADS = 256
LINE_TPL = 128
LINE_SMEM_TARGET = 96 * 1024
LINE_SMEM_LIMIT = 232448


class Gram2DPlan(NamedTuple):
    """How B10 or B11 runs one call (csrc/ski_lines_2d.cuh).

    cap:     the longest line transformed in shared memory; an axis with
             L_a <= cap takes its line kernel, a longer one the global
             Stockham passes.
    rows:    (tpl, lpb) of the axis-1 line kernel (W^T + the row
             convolutions over the m1 occupied rows; three buffers a line
             where B11's directions keep the forward line).
    cols:    (tpl, lpb) of the axis-0 line kernel (the m2 columns).
    scratch: complex values of each of the two scratch buffers (the second
             0 when both axes take their line kernels).
    launches: kernel launches per call.
    per_direction: B11 runs B10's gram once per direction (an axis beyond
             the cap, or a row line of three buffers that does not fit a
             block); False for B10 and for B11 on its line kernels.
    """
    cap: int
    rows: tuple
    cols: tuple
    scratch: tuple
    launches: int
    per_direction: bool = False


def line_smem_bytes(L: int, lines: int, itemsize: int, bufs: int = 2) -> int:
    """Shared bytes of a line kernel: the L twiddles and ``bufs`` buffers
    of L + 1 complex values per line (two; three in B6's rows)."""
    return 2 * itemsize * (L + bufs * lines * (L + 1))


def line_cap(itemsize: int) -> int:
    """The longest power-of-two line one block holds (4096 in float64,
    8192 in float32): the C side's ``ski_gram_2d_line_cap``, which
    refuses a plan whose lines do not fit."""
    L = 2
    while line_smem_bytes(2 * L, 1, itemsize) <= LINE_SMEM_LIMIT:
        L *= 2
    return L


def line_kernel_plan(L: int, lines: int, itemsize: int,
                     bufs: int = 2) -> tuple:
    """(tpl, lpb) of a line kernel on ``lines`` lines of length L with
    ``bufs`` buffers a line: L / 4 threads per line (one radix-4
    butterfly each) up to LINE_TPL, as many lines per block as make
    LINE_THREADS threads, no more than the lines (rounded up to a power of
    two), and halved until the block fits LINE_SMEM_TARGET."""
    tpl = min(max(L // 4, 1), LINE_TPL)
    lpb = max(LINE_THREADS // tpl, 1)
    lpb = min(lpb, 1 << max(int(lines) - 1, 0).bit_length())
    while lpb > 1 and line_smem_bytes(L, lpb, itemsize,
                                      bufs) > LINE_SMEM_TARGET:
        lpb //= 2
    return tpl, lpb


@functools.lru_cache(maxsize=256)
def gram_2d_plan(shape, Ls, b: int, itemsize: int,
                 cap: Optional[int] = None, dirs: int = 1) -> Gram2DPlan:
    """The plan of B10 (``dirs`` = 1) or B11 (``dirs`` tangent directions)
    for b columns on the (m1, m2) cells in (L1, L2) planes.

    B10: stage 1 writes the (P, m1, ld) rows (P = ceil(b / 2) packed
    columns): ld = m2 from the line kernel; ld = L2 from the global
    passes, which ping-pong between two (P, m1, L2) buffers.  Stage 2 works
    in place from its line kernel; its global passes pad the rows into
    (P, L1, m2) and ping-pong between the two buffers.  Each buffer is
    sized for the largest of these that the call takes.  B11 writes the
    (dirs, P, m1, m2) rows and works on them in place (three launches, one
    buffer of dirs P m1 m2 complex values) while both axes fit the cap
    and, with several directions, a row line of three buffers fits a block
    (L2 <= 2048 in float64, 4096 in float32); otherwise it runs B10's gram
    once per direction on B10's plan and scratch."""
    (m1, m2), (L1, L2) = shape, Ls
    P = (int(b) + 1) // 2
    dirs = int(dirs)
    cap = line_cap(itemsize) if cap is None else min(int(cap),
                                                    line_cap(itemsize))
    rows_shared, cols_shared = L2 <= cap, L1 <= cap
    if (dirs > 1 and rows_shared and cols_shared
            and line_smem_bytes(L2, 1, itemsize, 3) <= LINE_SMEM_LIMIT):
        return Gram2DPlan(cap, line_kernel_plan(L2, m1, itemsize, 3),
                          line_kernel_plan(L1, m2, itemsize),
                          (dirs * P * m1 * m2, 0), 3)
    if rows_shared:
        buf = [P * m1 * m2, 0]
    else:
        buf = [P * m1 * L2, P * m1 * L2]
    if not cols_shared:
        buf = [max(x, P * L1 * m2) for x in buf]
    launches = ((1 if rows_shared else 1 + 2 * _passes(L2))
                + (1 if cols_shared else 1 + 2 * _passes(L1)) + 1)
    return Gram2DPlan(cap, line_kernel_plan(L2, m1, itemsize),
                      line_kernel_plan(L1, m2, itemsize), tuple(buf),
                      dirs * launches, dirs > 1)


def _passes(L: int) -> int:
    """Stockham passes of one global-memory transform of length L (radix
    4, one radix-2 pass first when log2 L is odd)."""
    lg = int(L).bit_length() - 1
    return lg // 2 + (lg & 1)


def _launch_gram_2d(geom, lams, noise2, v, line_cap_arg=None):
    """B10 on the card (:func:`_launch_2d`).  ``line_cap_arg`` lowers the
    card's line cap (the card tests put a small geometry on the
    global-pass branch with it)."""
    return _launch_2d("ski_gram_2d", geom, lams, v, torch.empty_like(v),
                      float(noise2), 1, line_cap_arg)


def _launch_tangent_2d(geom, lam_pairs, v, line_cap_arg=None):
    """B11 on the card (:func:`_launch_2d`), ``line_cap_arg`` as for
    :func:`_launch_gram_2d`."""
    m = int(lam_pairs[0].shape[0])
    return _launch_2d("ski_tangent_2d", geom, lam_pairs, v,
                      v.new_empty((m,) + tuple(v.shape)), m, m, line_cap_arg)


def _launch_2d(name, geom, lams, v, out, mid, dirs, line_cap_arg):
    """One C call ``name``_<dtype>(n, m1, m2, L1, L2, s, offs, occ, wcell,
    cell, lam1, lam2, mid, v, c, out, scratch0, scratch1, cap, plan...,
    stream) into ``out``, counted in LAUNCHES[name]: B10 (mid the noise)
    or B11 (mid the directions).  Every CG and Lanczos iteration on a gappy
    field makes such a call, so the host work is kept to a cached plan and
    one scratch allocation."""
    if out.numel() == 0:
        return out
    t = geom.tensors(v.device, v.dtype)
    c = int(v.shape[1])
    itemsize = v.element_size()
    plan = gram_2d_plan(geom.shape, geom.Ls, c, itemsize, line_cap_arg, dirs)
    s0, s1 = plan.scratch
    scratch = torch.empty((s0 + max(s1, 1), 2), dtype=v.dtype,
                          device=v.device)
    base = scratch.data_ptr()
    _cuda.call(f"{name}_{_cuda.dtype_suffix(v.dtype)}",
               int(v.shape[0]), geom.shape[0], geom.shape[1], *geom.Ls,
               len(geom.offs), t["offs"].data_ptr(), t["occ"].data_ptr(),
               t["wcell"].data_ptr(), t["cell"].data_ptr(),
               lams[0].data_ptr(), lams[1].data_ptr(), mid, v.data_ptr(), c,
               out.data_ptr(), base, base + 2 * itemsize * s0, plan.cap,
               *plan.rows, *plan.cols, _cuda.stream_ptr(v.device))
    _cuda.LAUNCHES[name] += 1
    return out


def _grid_conv_2d_pruned(geom, lam1s, lam2s, u):
    """The 2-D convolutions of :func:`_grid_conv_2d_plain` on u (m1 m2, b)
    in B10's and B11's order (csrc/ski_lines_2d.cuh), direction i through
    lam1s[i] (x) lam2s[i] (lam1s (dirs, L1), lam2s (dirs, L2)): two real
    columns packed in one complex column (a zero half for an odd b), the
    forward axis-1 transform of the m1 occupied rows once for every
    direction; then per direction its lam2, the inverse cropped to m2, and
    the axis-0 convolution of the m2 columns by its lam1 cropped to m1.
    The spectrum is an outer product, so the 2-D circulant is the product
    of the two axis circulants and the crops commute with it.  Returns
    (dirs, m1 m2, b)."""
    (m1, m2), (L1, L2) = geom.shape, geom.Ls
    b = u.shape[1]
    U = u.reshape(m1, m2, b)
    if b % 2:
        U = torch.cat([U, U.new_zeros((m1, m2, 1))], dim=2)
    F = torch.fft.fft(torch.complex(U[..., 0::2], U[..., 1::2]), n=L2, dim=1)
    out = []
    for lam1, lam2 in zip(lam1s, lam2s):
        Z = torch.fft.ifft(lam2[None, :, None] * F, dim=1,
                           norm="forward")[:, :m2]
        Z = torch.fft.ifft(lam1[:, None, None] * torch.fft.fft(Z, n=L1, dim=0),
                           dim=0, norm="forward")[:m1]
        out.append(torch.stack([Z.real, Z.imag], dim=-1)
                   .reshape(m1, m2, -1)[..., :b].reshape(m1 * m2, b))
    return torch.stack(out) if out else u.new_zeros((0,) + tuple(u.shape))


def fused_gram_matvec_nd_pruned(geom: FusedSKIGeometry2D, lams,
                                noise2: float, v):
    """B10's function in B10's order (:func:`_grid_conv_2d_pruned`): the
    CPU twin of the kernel's arithmetic, used by the tests; the plain
    version the card holds B10 against stays
    :func:`fused_gram_matvec_nd_plain`."""
    t = geom.tensors(v.device, v.dtype)
    u = interp_scatter(t["idx"], t["w"], geom.m_grid, v)
    ku = _grid_conv_2d_pruned(geom, lams[0][None], lams[1][None], u)[0]
    return interp_gather(t["idx"], t["w"], ku) + noise2 * v


def fused_tangent_matvecs_nd_pruned(geom: FusedSKIGeometry2D, lam_pairs, v):
    """B11's function in B11's order: W^T and the forward row transforms
    once, then each direction's row inverse, columns and W
    (:func:`_grid_conv_2d_pruned`): (m, n, b).  The CPU twin of the
    kernel's arithmetic, used by the tests; the card holds B11 against
    :func:`fused_tangent_matvecs_nd_plain`."""
    t = geom.tensors(v.device, v.dtype)
    u = interp_scatter(t["idx"], t["w"], geom.m_grid, v)
    ku = _grid_conv_2d_pruned(geom, lam_pairs[0], lam_pairs[1], u)
    return torch.stack([interp_gather(t["idx"], t["w"], k) for k in ku]) \
        if ku.shape[0] else v.new_zeros((0,) + tuple(v.shape))
