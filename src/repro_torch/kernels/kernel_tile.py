"""Dense covariance block K(x1, x2): B4.

Counterpart of ``matrix_pallas`` in ``repro/kernels/kernel_tile.py``.  The
CUDA kernel (``csrc/tile_matrix.cu``) writes the block straight from the
coordinates in tiles of rows x columns, a warp's stores 32 consecutive
entries of a row, on the value sweep's entry (an entry outside k1's or
k2's Wendland window stored as 0 before any sin or exp), so no (n1, n2)
separation matrix is ever built.  The wrapper takes the plain PyTorch
version only for CPU tensors; on CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _cuda
from .kernel_matvec import _check
from .ref import matrix_ref


def tile_matrix_plain(kind: str, params, x1, x2):
    """K(x1, x2) from the reference tile (builds the separation matrix)."""
    return matrix_ref(kind, params, x1, x2)


def tile_matrix(kind: str, params, x1, x2):
    """B4: dense K(x1, x2), (n1, n2), on natural parameters, no noise."""
    dev = _check(kind, params, x1, x2)
    if dev.type == "cpu":
        return tile_matrix_plain(kind, params, x1, x2)
    n1, n2 = int(x1.shape[0]), int(x2.shape[0])
    out = torch.empty((n1, n2), dtype=x1.dtype, device=dev)
    if n1 == 0 or n2 == 0:
        return out
    params = params.contiguous()
    x1 = x1.contiguous()
    x2 = x2.contiguous()
    _cuda.call(f"tile_matrix_{_cuda.dtype_suffix(x1.dtype)}",
               _cuda.KIND_IDS[kind], params.data_ptr(), x1.data_ptr(), n1,
               x2.data_ptr(), n2, out.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.LAUNCHES["tile_matrix"] += 1
    return out
