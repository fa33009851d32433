"""Matrix-free covariance matvecs: B1 (K @ V), B2 (stacked tangents),
B3 (the tangent of one direction), their separable-product forms on (n, d)
coordinates, B8 and B9, and the row slabs of the stochastic solver, B12
and B13.

Counterparts of ``matvec_pallas``, ``matvec_stacked_tangent_pallas``,
``matvec_tangent_pallas``, ``matvec_pallas_nd``,
``matvec_stacked_tangent_pallas_nd``, ``matvec_rows_pallas`` and
``matvec_rows_pallas_nd`` in ``repro/kernels/kernel_matvec.py``.  K is
never stored.  B1 and B12 (``csrc/tile_matvec.cu``), and on (n, d)
coordinates B8 and B13 (``csrc/tile_matvec_nd.cu``, the product entry),
run the value sweep of ``csrc/value_sweep.cuh``: k evaluated and
contracted in registers for b <= 16, on the fp64 tensor cores above, and,
for k1 and k2 alone, every tile outside the Wendland window skipped
(:func:`support_tiles` is the rule's twin here).  B2 and B3
(``csrc/tile_tangent.cu``, ``csrc/tile_jvp.cu``) run the same kernels on
the closed-form gradient of k (``csrc/tangent_sweep.cuh``), with the same
skip, and B9 (``csrc/tile_tangent_nd.cu``) on the product rule's gradient
slots, projected on its directions once per output row.  All run on a
grid of row stripes x column segments.  A row slab is the value sweep on
a pre-gathered batch of rows, counted under its own name.

Each wrapper takes its plain PyTorch version when, and only when, the
tensors lie on the CPU; on CUDA tensors it launches its kernel or raises.
The plain versions build the dense tile from :mod:`.ref` and multiply; they
chunk rows so that the (m, rows, n2) tangent block stays small on the card.
"""

from __future__ import annotations

import torch

from . import _cuda
from .ref import (N_PARAM_SLOTS, N_SLOTS, matrix_ref, product_matrix_ref,
                  product_tangent_matrices_ref, tangent_matrices_ref)

ROW_CHUNK = 1024  # rows per dense block in the plain versions
# the value sweep's grid (csrc/value_sweep.cuh, B1, B3, B8, B12 and B13,
# and B2 and B9 on stripes of tile_tangent_rows and tile_tangent_nd_rows):
# 64-row stripes, 32-column tiles, VALUE_BLOCKS_PER_SM blocks on each SM
# (two are resident; more segments spread the few tiles a Wendland window
# keeps over more blocks), and at least one tile for each of a block's
# VALUE_WARPS warps per segment (a slab of a few rows would otherwise
# take a thousand one-tile segments, which the ordered reduce then sums
# one by one)
VALUE_ROWS = 64
VALUE_COLS = 32
VALUE_BLOCKS_PER_SM = 8
VALUE_WARPS = 8
VALUE_GRID = (VALUE_ROWS, VALUE_COLS, VALUE_BLOCKS_PER_SM, VALUE_WARPS)
MAX_GRID_Y = 65535
# |x| <= VALUE_BIG[dtype] keeps every difference finite (value_big)
VALUE_BIG = {torch.float64: 8.0e307, torch.float32: 1.7e38}
# the product kernels take up to MAX_AXES factors and MAX_DIRS_ND tangent
# directions (csrc/tile_fns.cuh)
MAX_AXES = 4
MAX_DIRS_ND = 10


def _check(kind, params, x1, x2, v=None, pdots=None):
    """Validate a wrapper's inputs; returns the one device they lie on."""
    if kind not in N_SLOTS:
        raise ValueError(f"unknown tile kind {kind!r}; registered: "
                         f"{sorted(N_SLOTS)}")
    if x1.ndim != 1 or x2.ndim != 1:
        raise ValueError(f"x1 and x2 must be 1-D, got {tuple(x1.shape)} "
                         f"and {tuple(x2.shape)}")
    if v is not None and (v.ndim != 2 or v.shape[0] != x2.shape[0]):
        raise ValueError(f"v must be (n2, b) with n2 = {x2.shape[0]}, got "
                         f"{tuple(v.shape)}")
    if params.shape != (N_PARAM_SLOTS,):
        raise ValueError(f"params must be ({N_PARAM_SLOTS},), got "
                         f"{tuple(params.shape)}")
    if pdots is not None and (pdots.ndim != 2
                              or pdots.shape[1] != N_PARAM_SLOTS):
        raise ValueError(f"pdots must be (m, {N_PARAM_SLOTS}), got "
                         f"{tuple(pdots.shape)}")
    return _one_device(params, x1, x2, v, pdots)


def _one_device(*tensors):
    """The one device (cpu or cuda) that the given tensors share, all of
    one dtype; None entries are skipped."""
    tensors = [t for t in tensors if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"all inputs must share one dtype, got {dtypes}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# B1: K(x1, x2) @ V
# ---------------------------------------------------------------------------

def tile_matvec_plain(kind: str, params, x1, x2, v,
                      row_chunk: int = ROW_CHUNK):
    """K(x1, x2) @ v from dense row blocks of the reference tile."""
    out = [matrix_ref(kind, params, x1[r:r + row_chunk], x2) @ v
           for r in range(0, x1.shape[0], row_chunk)]
    return torch.cat(out) if out else v.new_zeros((0, v.shape[1]))


def tile_matvec(kind: str, params, x1, x2, v):
    """B1: K(x1, x2) @ v, v (n2, b) -> (n1, b), K never stored.

    ``params`` is the (N_PARAM_SLOTS,) natural-parameter block.
    """
    dev = _check(kind, params, x1, x2, v)
    if dev.type == "cpu":
        return tile_matvec_plain(kind, params, x1, x2, v)
    return _launch_sweep("tile_matvec", (_cuda.KIND_IDS[kind],),
                         ("tile_matvec_max_cols",), params, None, x1, x2, v,
                         grid=VALUE_GRID)


def support_tiles(kind: str, params, x1, x2, rows: int = VALUE_ROWS,
                  cols: int = VALUE_COLS):
    """The (stripe, tile) pairs that the value sweep's kernels evaluate
    (B1, B2, B3 and B12), as a (P, 2) long tensor in row-major order: stripes of ``rows`` rows of x1, tiles of
    ``cols`` columns of x2 (csrc/value_sweep.cuh, kept_tiles; B2 may take
    32-row stripes, :func:`tangent_grid`).  For k1 and k2 a pair is
    dropped when the [min, max] of its rows and of its columns both lie
    within +-VALUE_BIG and their gap is >= T0 = params[0]; every entry of
    a dropped pair is exactly 0, in K and in each of its derivatives.
    The other kinds keep every pair."""
    s1 = -(-x1.shape[0] // rows)
    s2 = -(-x2.shape[0] // cols)
    keep = torch.ones((s1, s2), dtype=torch.bool, device=x1.device)
    if kind in ("k1", "k2") and s1 and s2:
        lo1, hi1, fin1 = _tile_ranges(x1, rows)
        lo2, hi2, fin2 = _tile_ranges(x2, cols)
        t0 = params[0]
        drop = ((lo1[:, None] - hi2[None, :] >= t0)
                | (lo2[None, :] - hi1[:, None] >= t0))
        keep = ~(drop & fin1[:, None] & fin2[None, :])
    return keep.nonzero()


def _tile_ranges(x, width):
    """Per tile of ``width`` entries of x: min, max and whether every
    entry lies within +-VALUE_BIG (a nan does not)."""
    pad = -x.shape[0] % width
    big = VALUE_BIG[x.dtype]
    inf = torch.full((pad,), float("inf"), dtype=x.dtype, device=x.device)
    lo = torch.cat([x, inf]).view(-1, width).amin(1)
    hi = torch.cat([x, -inf]).view(-1, width).amax(1)
    fin = torch.cat([x.abs() <= big, torch.ones(pad, dtype=torch.bool,
                                                 device=x.device)])
    return lo, hi, fin.view(-1, width).all(1)


def support_entries(kind: str, params, x1, x2,
                    row_chunk: int = ROW_CHUNK) -> int:
    """The entries of K(x1, x2) that the covariance needs: for k1 and k2
    those inside the Wendland window, |dt / T0| < 1 as the tile
    evaluates it; every entry for the other kinds."""
    if kind not in ("k1", "k2"):
        return int(x1.shape[0]) * int(x2.shape[0])
    return sum(int(((x1[r:r + row_chunk, None] - x2[None, :]) / params[0])
                   .abs().lt(1.0).sum())
               for r in range(0, x1.shape[0], row_chunk))


# ---------------------------------------------------------------------------
# B2: dK/dp[pdots_i] @ V for all m directions
# ---------------------------------------------------------------------------

def tile_stacked_tangent_matvec_plain(kind: str, params, pdots, x1, x2, v,
                                      row_chunk: int = ROW_CHUNK):
    """(m, n1, b) tangents from dense closed-form derivative blocks."""
    out = [torch.einsum("mrc,cb->mrb", tangent_matrices_ref(
        kind, params, pdots, x1[r:r + row_chunk], x2), v)
        for r in range(0, x1.shape[0], row_chunk)]
    if not out:
        return v.new_zeros((pdots.shape[0], 0, v.shape[1]))
    return torch.cat(out, dim=1)


def tile_stacked_tangent_matvec(kind: str, params, pdots, x1, x2, v):
    """B2: (sum_s pdots[i, s] dK/dp[s]) @ v for every row i of pdots.

    pdots (m, N_PARAM_SLOTS) natural-parameter directions, m <= 5;
    returns (m, n1, b).  K and dK are never stored.
    """
    dev = _check(kind, params, x1, x2, v, pdots)
    if dev.type == "cpu":
        return tile_stacked_tangent_matvec_plain(kind, params, pdots, x1,
                                                 x2, v)
    return _launch_sweep("tile_tangent", (_cuda.KIND_IDS[kind],),
                         ("tile_matvec_max_cols",), params, pdots, x1, x2, v,
                         grid=tangent_grid(kind, int(v.shape[1])))


def tangent_grid(kind: str, b: int):
    """B2's grid (rows, cols, per_sm, min_tiles) at width b, for
    :func:`row_segments`: the value sweep's 32-column tiles on stripes of
    ``tile_tangent_rows`` rows (64, or 32 where a row's gradient slots
    times b, at most 16 per launch, exceed 16 accumulators).  Asks the
    built library (card only)."""
    rows = _cuda.KERNELS.get("tile_tangent_rows")(_cuda.KIND_IDS[kind], b)
    return (rows, VALUE_COLS, VALUE_BLOCKS_PER_SM, VALUE_WARPS)


# ---------------------------------------------------------------------------
# B3: dK/dp[pdot] @ V for one direction
# ---------------------------------------------------------------------------

def tile_jvp_plain(kind: str, params, pdot, x1, x2, v,
                   row_chunk: int = ROW_CHUNK):
    """(n1, b): B2's plain version with the one direction pdot."""
    return tile_stacked_tangent_matvec_plain(kind, params, pdot[None], x1,
                                             x2, v, row_chunk)[0]


def tile_jvp(kind: str, params, pdot, x1, x2, v):
    """B3: (sum_s pdot[s] dK/dp[s])(x1, x2) @ v for one (N_PARAM_SLOTS,)
    natural-parameter direction pdot; v (n2, b) -> (n1, b).  K and dK are
    never stored."""
    if pdot.shape != (N_PARAM_SLOTS,):
        raise ValueError(f"pdot must be ({N_PARAM_SLOTS},), got "
                         f"{tuple(pdot.shape)}")
    dev = _check(kind, params, x1, x2, v, pdot[None])
    if dev.type == "cpu":
        return tile_jvp_plain(kind, params, pdot, x1, x2, v)
    return _launch_sweep("tile_jvp", (_cuda.KIND_IDS[kind],),
                         ("tile_matvec_max_cols",), params, pdot[None], x1,
                         x2, v, grid=VALUE_GRID)[0]


def _launch_sweep(name, lead, limit, params, pdots, x1, x2, v, count=None,
                  grid=VALUE_GRID):
    """B1, B2, B3, B8, B9 or a row slab (B12, B13) on the card: one call of
    the C symbol ``name``_<dtype> per chunk of columns of v, (m, n1, b)
    out (n1, b for a value sweep, ``pdots`` None), each added to
    ``LAUNCHES[count or name]``.  ``lead``: the symbol's leading arguments
    (B1-B3 the kind's id; B8/B9 d and the packed per-axis ids); ``limit``:
    the max-cols symbol and its leading arguments (the element size is
    appended).  The column segments come from :func:`row_segments` on the
    kernel's ``grid`` (VALUE_GRID, or B2's :func:`tangent_grid` and B9's
    :func:`tangent_nd_grid`); with two or more, the
    (segments, m, n1, w) scratch of the partial stripes is allocated
    here."""
    sfx = _cuda.dtype_suffix(v.dtype)
    elem = v.element_size()
    m = 1 if pdots is None else int(pdots.shape[0])
    n1, n2 = int(x1.shape[0]), int(x2.shape[0])
    b = int(v.shape[1])
    out = torch.empty((m, n1, b), dtype=v.dtype, device=v.device)
    if n1 == 0 or b == 0 or n2 == 0:
        out.zero_()
        return out[0] if pdots is None else out
    params = params.contiguous()
    x1 = x1.contiguous()
    x2 = x2.contiguous()
    v = v.contiguous()
    if pdots is not None:
        pdots = pdots.contiguous()
    dirs = () if pdots is None else (pdots.data_ptr(), m)
    stream = _cuda.stream_ptr(v.device)
    max_cols = _cuda.KERNELS.get(limit[0])(*limit[1:], elem)
    sms = torch.cuda.get_device_properties(v.device).multi_processor_count
    segs, seg_cols = row_segments(n1, n2, sms, grid)
    part = (torch.empty((segs, m, n1, min(b, max_cols)), dtype=v.dtype,
                        device=v.device) if segs > 1 else None)
    for j0 in range(0, b, max_cols):
        w = min(max_cols, b - j0)
        _cuda.call(f"{name}_{sfx}", *lead, params.data_ptr(), *dirs,
                   x1.data_ptr(), n1, x2.data_ptr(), n2,
                   v.data_ptr() + j0 * elem, b, w, seg_cols, segs,
                   None if part is None else part.data_ptr(),
                   out.data_ptr() + j0 * elem, b, stream)
        _cuda.LAUNCHES[count or name] += 1
    return out[0] if pdots is None else out


# ---------------------------------------------------------------------------
# B8 / B9: separable products over (n, d) coordinates
# ---------------------------------------------------------------------------

def _check_nd(kinds, params, x1, x2, v, pdots=None):
    """Validate a product wrapper's inputs; returns their one device."""
    d = len(kinds)
    bad = [k for k in kinds if k not in N_SLOTS]
    if bad:
        raise ValueError(f"unknown tile kind(s) {bad}; registered: "
                         f"{sorted(N_SLOTS)}")
    if not 1 <= d <= MAX_AXES:
        raise ValueError(f"the product kernels take 1 to {MAX_AXES} "
                         f"factors, got {d}")
    for name, x in (("x1", x1), ("x2", x2)):
        if x.ndim != 2 or x.shape[1] != d:
            raise ValueError(f"{name} must be (n, {d}), got "
                             f"{tuple(x.shape)}")
    if v.ndim != 2 or v.shape[0] != x2.shape[0]:
        raise ValueError(f"v must be (n2, b) with n2 = {x2.shape[0]}, got "
                         f"{tuple(v.shape)}")
    if params.shape != (d, N_PARAM_SLOTS):
        raise ValueError(f"params must be ({d}, {N_PARAM_SLOTS}), got "
                         f"{tuple(params.shape)}")
    if pdots is not None and (pdots.ndim != 3
                              or pdots.shape[1:] != (d, N_PARAM_SLOTS)
                              or not 1 <= pdots.shape[0] <= MAX_DIRS_ND):
        raise ValueError(f"pdots must be (m, {d}, {N_PARAM_SLOTS}) with "
                         f"1 <= m <= {MAX_DIRS_ND}, got "
                         f"{tuple(pdots.shape)}")
    return _one_device(params, x1, x2, v, pdots)


def tile_matvec_nd_plain(kinds, params, x1, x2, v,
                         row_chunk: int = ROW_CHUNK):
    """prod_a K_a(x1, x2) @ v from dense row blocks of the product tile."""
    out = [product_matrix_ref(kinds, params, x1[r:r + row_chunk], x2) @ v
           for r in range(0, x1.shape[0], row_chunk)]
    return torch.cat(out) if out else v.new_zeros((0, v.shape[1]))


def tile_matvec_nd(kinds, params, x1, x2, v):
    """B8: the separable product K(x1, x2) @ v on (n, d) coordinates,
    v (n2, b) -> (n1, b), K never stored.  ``kinds`` one tile family per
    axis, ``params`` the (d, N_PARAM_SLOTS) natural-parameter blocks."""
    kinds = tuple(kinds)
    dev = _check_nd(kinds, params, x1, x2, v)
    if dev.type == "cpu":
        return tile_matvec_nd_plain(kinds, params, x1, x2, v)
    return _launch_sweep("tile_matvec_nd", (len(kinds), _kinds_code(kinds)),
                         ("tile_matvec_max_cols",), params, None, x1, x2, v,
                         grid=VALUE_GRID)


def tile_stacked_tangent_matvec_nd_plain(kinds, params, pdots, x1, x2, v,
                                         row_chunk: int = ROW_CHUNK):
    """(m, n1, b) product-rule tangents from dense row blocks."""
    out = [torch.einsum("mrc,cb->mrb", product_tangent_matrices_ref(
        kinds, params, pdots, x1[r:r + row_chunk], x2), v)
        for r in range(0, x1.shape[0], row_chunk)]
    if not out:
        return v.new_zeros((pdots.shape[0], 0, v.shape[1]))
    return torch.cat(out, dim=1)


def tile_stacked_tangent_matvec_nd(kinds, params, pdots, x1, x2, v):
    """B9: the m product-kernel tangents, row i of pdots (m, d,
    N_PARAM_SLOTS) giving sum_a (sum_s pdots[i, a, s] dk_a/dp[s])
    prod_{b != a} k_b, times v: (m, n1, b), one launch."""
    kinds = tuple(kinds)
    dev = _check_nd(kinds, params, x1, x2, v, pdots)
    if dev.type == "cpu":
        return tile_stacked_tangent_matvec_nd_plain(kinds, params, pdots,
                                                    x1, x2, v)
    return _launch_sweep("tile_tangent_nd", (len(kinds), _kinds_code(kinds)),
                         ("tile_matvec_max_cols",), params, pdots, x1, x2, v,
                         grid=tangent_nd_grid(kinds, int(v.shape[1])))


def tangent_nd_grid(kinds, b: int):
    """B9's grid (rows, cols, per_sm, min_tiles) at width b, for
    :func:`row_segments`: the value sweep's 32-column tiles on stripes of
    ``tile_tangent_nd_rows`` rows (64, or 32 where a row's gradient slots
    times the launch's width exceed 16 accumulators).  Asks the built
    library (card only)."""
    rows = _cuda.KERNELS.get("tile_tangent_nd_rows")(
        len(kinds), _kinds_code(kinds), b)
    return (rows, VALUE_COLS, VALUE_BLOCKS_PER_SM, VALUE_WARPS)


def _kinds_code(kinds) -> int:
    """Per-axis family ids packed four bits each (axis a at bits 4a)."""
    code = 0
    for a, k in enumerate(kinds):
        code |= _cuda.KIND_IDS[k] << (4 * a)
    return code


# ---------------------------------------------------------------------------
# B12 / B13: row slabs K(rows_x, x2) @ V of the stochastic solver
# ---------------------------------------------------------------------------

def row_segments(n1: int, n2: int, sms: int, grid=VALUE_GRID):
    """(segments, columns per segment) of a sweep's grid (rows, cols,
    per_sm, min_tiles): the column axis of n2 >= 1 is cut into segments of
    whole ``cols`` tiles, as many as bring the ceil(n1 / rows) row stripes
    to ``per_sm`` blocks per SM (never more than the tiles / ``min_tiles``;
    one when the stripes alone do), covering n2 exactly.  B1, B3, B8, B12
    and B13 take VALUE_GRID, B2 :func:`tangent_grid` and B9
    :func:`tangent_nd_grid`."""
    rows, cols, per_sm, min_tiles = grid
    stripes = -(-n1 // rows)
    tiles = -(-n2 // cols)
    want = -(-per_sm * sms // stripes)
    want = max(1, min(want, tiles // min_tiles, MAX_GRID_Y))
    per = -(-tiles // want)
    return -(-tiles // per), per * cols


def tile_matvec_rows(kind: str, params, rows_x, x2, v):
    """B12: the row slab K(rows_x, x2) @ v for a pre-gathered batch of
    rows, rows_x (b,), v (n2, k) -> (b, k), K never stored.  The plain
    version is :func:`tile_matvec_plain`."""
    dev = _check(kind, params, rows_x, x2, v)
    if dev.type == "cpu":
        return tile_matvec_plain(kind, params, rows_x, x2, v)
    return _launch_sweep("tile_matvec", (_cuda.KIND_IDS[kind],),
                         ("tile_matvec_max_cols",), params, None, rows_x,
                         x2, v, count="tile_rows", grid=VALUE_GRID)


def tile_matvec_rows_nd(kinds, params, rows_x, x2, v):
    """B13: the separable product row slab on (n, d) coordinates,
    rows_x (b, d), x2 (n2, d), v (n2, k) -> (b, k).  The plain version is
    :func:`tile_matvec_nd_plain`."""
    kinds = tuple(kinds)
    dev = _check_nd(kinds, params, rows_x, x2, v)
    if dev.type == "cpu":
        return tile_matvec_nd_plain(kinds, params, rows_x, x2, v)
    return _launch_sweep("tile_matvec_nd", (len(kinds), _kinds_code(kinds)),
                         ("tile_matvec_max_cols",), params, None, rows_x, x2,
                         v, count="tile_rows_nd", grid=VALUE_GRID)
