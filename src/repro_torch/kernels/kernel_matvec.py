"""Matrix-free covariance matvecs: B1 (K @ V) and B2 (stacked tangents).

Counterparts of ``matvec_pallas`` and ``matvec_stacked_tangent_pallas`` in
``repro/kernels/kernel_matvec.py``.  K is never stored: the CUDA kernels
(``csrc/tile_matvec.cu``, ``csrc/tile_tangent.cu``) evaluate each tile in
shared memory and contract it with V there; see ``csrc/tile_sweep.cuh`` for
the design and what bounds it on an H100.

Each wrapper takes its plain PyTorch version when, and only when, the
tensors lie on the CPU; on CUDA tensors it launches its kernel or raises.
The plain versions build the dense tile from :mod:`.ref` and multiply; they
chunk rows so that the (m, rows, n2) tangent block stays small on the card.
"""

from __future__ import annotations

import torch

from . import _cuda
from .ref import N_PARAM_SLOTS, N_SLOTS, matrix_ref, tangent_matrices_ref

ROW_CHUNK = 1024  # rows per dense block in the plain versions


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
    tensors = [t for t in (params, x1, x2, v, pdots) if t is not None]
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
    return _launch_sweep("tile_matvec", kind, params, None, x1, x2, v)


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
    return _launch_sweep("tile_tangent", kind, params, pdots, x1, x2, v)


def _launch_sweep(name, kind, params, pdots, x1, x2, v):
    sfx = _cuda.dtype_suffix(v.dtype)
    elem = v.element_size()
    m = 1 if pdots is None else int(pdots.shape[0])
    n1, n2 = int(x1.shape[0]), int(x2.shape[0])
    b = int(v.shape[1])
    out = torch.empty((m, n1, b), dtype=v.dtype, device=v.device)
    if n1 == 0 or b == 0:
        return out[0] if pdots is None else out
    params = params.contiguous()
    x1 = x1.contiguous()
    x2 = x2.contiguous()
    v = v.contiguous()
    stream = _cuda.stream_ptr(v.device)
    if pdots is None:
        max_cols = _cuda.KERNELS.get("tile_matvec_max_cols")(elem)
    else:
        pdots = pdots.contiguous()
        max_cols = _cuda.KERNELS.get("tile_tangent_max_cols")(m, elem)
    for j0 in range(0, b, max_cols):
        w = min(max_cols, b - j0)
        vp = v.data_ptr() + j0 * elem
        op = out.data_ptr() + j0 * elem
        if pdots is None:
            _cuda.call(f"tile_matvec_{sfx}", _cuda.KIND_IDS[kind],
                       params.data_ptr(), x1.data_ptr(), n1, x2.data_ptr(),
                       n2, vp, b, w, op, b, stream)
        else:
            _cuda.call(f"tile_tangent_{sfx}", _cuda.KIND_IDS[kind],
                       params.data_ptr(), pdots.data_ptr(), m,
                       x1.data_ptr(), n1, x2.data_ptr(), n2, vp, b, w, op, b,
                       stream)
        _cuda.LAUNCHES[name] += 1
    return out[0] if pdots is None else out
