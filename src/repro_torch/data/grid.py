"""Grid-structure probe for 1-D input coordinates (host side, numpy).

A copy of ``classify_grid`` and its helpers from ``repro/data/grid.py``:
"exact" (a regular grid), "near" (gaps or small jitter around one regular
grid) or "irregular".  The operator dispatch uses it to pick the structure;
this slice runs only the "irregular" one and refuses the other two.
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
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    xc = np.asarray(x)
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
