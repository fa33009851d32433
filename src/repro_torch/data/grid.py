"""Grid-structure probes and SKI inducing grids (host side, numpy).

Copies of ``repro/data/grid.py`` with the same arithmetic:
``classify_grid`` says "exact" (a regular grid: Toeplitz), "near" (gaps or
small jitter around one regular grid: SKI) or "irregular" (tiles);
``classify_grid_nd`` says "kron" (a full product grid in row-major order:
Kronecker), "product" (gappy, permuted or jittered product data: product
SKI) or "irregular" for (n, d) coordinates;
``build_inducing_grid`` and ``interp_weights`` build the SKI inducing grid
and the sparse cubic/linear interpolation weights W with K ~ W K_grid W^T.
A point on a grid node gets a one-hot row, so a gappy record makes W an
exact selection matrix.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

# Relative spacing tolerance for an exact grid.
GRID_RTOL = 1e-6
# Max |x_i - k_i h| / h for a point to lie on an underlying grid of spacing h.
NEAR_GRID_RTOL = 0.05
# Give up on an underlying grid that needs more cells per data point.
NEAR_GRID_EXPAND = 8.0


def grid_spacing(xc: np.ndarray, rtol: float = GRID_RTOL) -> Optional[float]:
    """Spacing h of a regular ascending grid, or None if xc is not one."""
    if xc.ndim != 1 or xc.shape[0] < 2 or not np.all(np.isfinite(xc)):
        return None
    d = np.diff(xc)
    h = float(xc[-1] - xc[0]) / (xc.shape[0] - 1)
    if h <= 0.0 or np.any(d <= 0.0):
        return None
    if float(np.max(np.abs(d - h))) > rtol * abs(h):
        return None
    return h


def is_regular_grid(x, rtol: float = GRID_RTOL) -> bool:
    """True iff x is a strictly ascending, uniform 1-D grid."""
    return grid_spacing(_host(x), rtol=rtol) is not None


def _host(x) -> np.ndarray:
    """numpy array, sequence or (CPU or CUDA) tensor -> numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


class GridInfo(NamedTuple):
    kind: str            # "exact" | "near" | "irregular"
    h: Optional[float]   # underlying spacing for "exact"/"near"


def classify_grid(x, rtol: float = GRID_RTOL,
                  near_rtol: float = NEAR_GRID_RTOL,
                  max_expand: float = NEAR_GRID_EXPAND) -> GridInfo:
    """Classify concrete 1-D coordinates (numpy array or CPU/CUDA tensor).

    Spacing recovery for "near": seed h with the median step, round each
    step to a multiple of h, refit h by least squares on the cumulative
    cell offsets, re-snap, and accept when every point lies within
    ``near_rtol * h`` of a distinct cell.
    """
    xc = _host(x)
    if xc.ndim != 1 or xc.shape[0] < 2 or not np.all(np.isfinite(xc)):
        return GridInfo("irregular", None)
    xc = xc.astype(np.float64)
    h_exact = grid_spacing(xc, rtol=rtol)
    if h_exact is not None:
        return GridInfo("exact", h_exact)
    d = np.diff(xc)
    if np.any(d <= 0.0):
        return GridInfo("irregular", None)
    h0 = float(np.median(d))
    if h0 <= 0.0:
        return GridInfo("irregular", None)
    q = np.rint(d / h0)
    if np.any(q < 1.0):
        return GridInfo("irregular", None)
    k = np.concatenate([[0.0], np.cumsum(q)])
    if k[-1] + 1.0 > max_expand * xc.shape[0]:
        return GridInfo("irregular", None)
    off = xc - xc[0]
    h = float(np.dot(k, off) / np.dot(k, k))
    if h <= 0.0:
        return GridInfo("irregular", None)
    k = np.rint(off / h)
    if np.any(np.diff(k) < 1.0):
        return GridInfo("irregular", None)
    if float(np.max(np.abs(off - k * h))) > near_rtol * h:
        return GridInfo("irregular", None)
    return GridInfo("near", h)


# ---------------------------------------------------------------------------
# Multi-axis (product-grid) classification
# ---------------------------------------------------------------------------

# A full product grid is worth expanding only while prod(m_a) <=
# KRON_EXPAND * n (guards the collinear case: n points on a diagonal would
# need an n^d grid).
KRON_EXPAND = NEAR_GRID_EXPAND


class ProductGridInfo(NamedTuple):
    """Result of :func:`classify_grid_nd`: kind "kron" | "product" |
    "irregular", the per-axis :class:`GridInfo` (empty when unavailable),
    and for "kron" the per-axis sorted coordinates and cell counts."""

    kind: str
    axes: tuple = ()
    grids: Optional[tuple] = None
    shape: Optional[tuple] = None


def classify_grid_nd(x, rtol: float = GRID_RTOL,
                     near_rtol: float = NEAR_GRID_RTOL,
                     max_expand: float = KRON_EXPAND) -> ProductGridInfo:
    """Classify concrete (n, d >= 2) coordinates for product structure.

    Each axis's distinct values go through :func:`classify_grid`; then
    "kron" when every axis is exact and the points enumerate the full
    product grid in canonical row-major order (last axis fastest),
    "product" when every axis is exact or near and the expanded grid
    holds at most ``max_expand`` cells per point, "irregular" otherwise.
    Raises ValueError for an array that is not (n, d >= 2).
    """
    xc = _host(x)
    if xc.ndim != 2 or xc.shape[1] < 2:
        raise ValueError(
            f"classify_grid_nd needs (n, d>=2) coordinates, got shape "
            f"{xc.shape}; supported input layouts are (n,) / (n, 1) series "
            "(1-D classify_grid) and (n, d) multi-axis points")
    if not np.all(np.isfinite(xc)):
        return ProductGridInfo("irregular")
    xc = np.asarray(xc, np.float64)
    n, d = xc.shape
    uniques, invs, axes = [], [], []
    for a in range(d):
        u, inv = np.unique(xc[:, a], return_inverse=True)
        uniques.append(u)
        invs.append(inv)
        if u.shape[0] < 2:
            axes.append(GridInfo("irregular", None))
        else:
            axes.append(classify_grid(u, rtol=rtol, near_rtol=near_rtol,
                                      max_expand=max_expand))
    axes = tuple(axes)
    if any(info.kind == "irregular" for info in axes):
        return ProductGridInfo("irregular", axes)
    cells = []
    for a, info in enumerate(axes):
        span = float(uniques[a][-1] - uniques[a][0])
        cells.append(int(round(span / info.h)) + 1)
    if float(np.prod([float(c) for c in cells])) > max_expand * n:
        return ProductGridInfo("irregular", axes)
    if all(info.kind == "exact" for info in axes):
        shape = tuple(u.shape[0] for u in uniques)
        flat = np.ravel_multi_index(tuple(invs), shape)
        if np.unique(flat).shape[0] < n:       # duplicate points
            return ProductGridInfo("irregular", axes)
        if int(np.prod(shape)) == n and np.array_equal(
                flat, np.arange(n, dtype=flat.dtype)):
            return ProductGridInfo("kron", axes, tuple(uniques), shape)
        return ProductGridInfo("product", axes)
    return ProductGridInfo("product", axes)


# ---------------------------------------------------------------------------
# SKI inducing grids + sparse interpolation weights
# ---------------------------------------------------------------------------

# Pad cells on each side of the data range so every cubic stencil
# (j0-1 .. j0+2) stays inside the grid without clamping.
GRID_MARGIN = 3

# Free-grid (scattered input) density: cells per data point.
GRID_OVERSAMPLE = 2.0


def build_inducing_grid(x, spacing: Optional[float] = None,
                        n_grid: Optional[int] = None,
                        margin: int = GRID_MARGIN) -> np.ndarray:
    """Regular inducing grid covering the range of ``x`` (float64 numpy).

    Spacing: explicit ``spacing``, else ``n_grid`` interior cells, else the
    :func:`classify_grid` spacing ("exact"/"near" inputs ride their own
    grid), else span / (GRID_OVERSAMPLE (n - 1)) for scattered data.
    ``margin`` cells pad each side.
    """
    xc = _host(x)
    if xc.ndim != 1 or xc.shape[0] < 1:
        raise ValueError("build_inducing_grid needs 1-D x")
    xc = xc.astype(np.float64)
    lo, hi = float(np.min(xc)), float(np.max(xc))
    span = hi - lo
    n = xc.shape[0]
    if spacing is None:
        if n_grid is not None:
            if n_grid < 2:
                raise ValueError("n_grid must be >= 2")
            spacing = (span if span > 0.0 else 1.0) / (n_grid - 1)
        else:
            info = classify_grid(xc)
            if info.h is not None:
                spacing = info.h
            elif span > 0.0 and n > 1:
                spacing = span / (GRID_OVERSAMPLE * (n - 1))
            else:
                spacing = 1.0
    spacing = float(spacing)
    if spacing <= 0.0:
        raise ValueError(f"inducing grid spacing must be > 0, got {spacing}")
    n_interior = int(np.ceil(span / spacing - 1e-9)) + 1
    m = n_interior + 2 * margin
    u0 = lo - margin * spacing
    return u0 + spacing * np.arange(m, dtype=np.float64)


def _cubic_weights(s: np.ndarray) -> np.ndarray:
    """Keys cubic-convolution weights (a = -1/2) for taps at offsets
    (-1, 0, 1, 2) around the cell fraction s in [0, 1); rows sum to 1."""
    w = np.empty(s.shape + (4,), np.float64)
    d = s + 1.0
    w[..., 0] = ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0
    d = s
    w[..., 1] = (1.5 * d - 2.5) * d * d + 1.0
    d = 1.0 - s
    w[..., 2] = (1.5 * d - 2.5) * d * d + 1.0
    d = 2.0 - s
    w[..., 3] = ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0
    return w


def interp_weights(x, grid, order: str = "cubic"):
    """Sparse interpolation weights W with k(x) ~ W k(grid), row by row.

    Returns ``(idx, w)``: int32 (n, s) grid indices and float64 (n, s)
    weights, s = 4 (cubic) or 2 (linear).  Rows sum to 1, and a point on a
    grid node gets the one-hot row (the snap below), so gappy-grid data
    makes W a selection matrix.  Raises if a stencil leaves ``grid``.
    """
    xc = _host(x).astype(np.float64)
    gc = _host(grid).astype(np.float64)
    if gc.ndim != 1 or gc.shape[0] < 4:
        raise ValueError("inducing grid must be 1-D with >= 4 points")
    h = grid_spacing(gc)
    if h is None:
        raise ValueError("inducing grid must be a regular ascending grid")
    t = (xc - gc[0]) / h
    m = gc.shape[0]
    # every cubic stencil needs t in [1, m-2]; reject before the clip
    if t.size and (float(np.min(t)) < 1.0 - 1e-9
                   or float(np.max(t)) > m - 2.0 + 1e-9):
        raise ValueError("interpolation stencil leaves the inducing grid; "
                         "build the grid with build_inducing_grid margins")
    j0 = np.floor(t).astype(np.int64)
    j0 = np.clip(j0, 1, m - 3)
    s = t - j0
    if order == "cubic":
        offs = np.arange(-1, 3, dtype=np.int64)
        w = _cubic_weights(s)
    elif order == "linear":
        offs = np.arange(0, 2, dtype=np.int64)
        w = np.stack([1.0 - s, s], axis=-1)
    else:
        raise ValueError(f"unknown interpolation order {order!r}; "
                         "choose 'cubic' or 'linear'")
    idx = j0[:, None] + offs[None, :]
    # snap node hits to one-hot rows: gappy-grid W is exactly a selection
    on_node = np.abs(s) < 1e-9
    if np.any(on_node):
        w = np.where(on_node[:, None],
                     (offs[None, :] == 0).astype(np.float64), w)
    return idx.astype(np.int32), w
