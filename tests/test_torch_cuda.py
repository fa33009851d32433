"""The CUDA kernels B1, B2 and B4 against their plain PyTorch versions.

These tests need a card and skip without one.  They import neither JAX nor
the JAX package, so they also run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels import kernel_matvec as tkm
from repro_torch.kernels import kernel_tile as tkt
from repro_torch.kernels import ops as tops

THETAS = {
    ("k1", "mid"): [np.log(300.0), np.log(12.4), 0.1],
    ("k1", "edge"): [np.log(500.0), np.log(3e-5), -0.2],
    ("k2", "mid"): [np.log(400.0), np.log(12.4), 0.05, np.log(24.0), -0.1],
    ("k2", "edge"): [np.log(600.0), np.log(2e-5), 0.2, np.log(7e-5), -0.3],
    ("se", "mid"): [np.log(40.0)],
    ("matern12", "mid"): [np.log(40.0)],
    ("matern32", "mid"): [np.log(40.0)],
    ("matern52", "mid"): [np.log(40.0)],
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _relerr(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-4)])
@pytest.mark.parametrize("kind,case", sorted(THETAS))
def test_cuda_kernels_match_plain(cuda_device, kind, case, dtype, tol):
    if dtype == torch.float32 and case == "edge":
        pytest.skip("float32 cannot resolve pi * dt / T near 1e9")
    rng = np.random.default_rng(7)
    # ragged sizes: no multiple of the 32-row / 64-column tiles
    x1 = np.sort(rng.uniform(0.0, 8760.0, 333))
    x2 = np.sort(rng.uniform(0.0, 8760.0, 301))
    v = rng.standard_normal((301, 70))
    theta = torch.tensor(THETAS[(kind, case)], dtype=torch.float64)
    p = tops.natural_params(kind, theta).to(cuda_device, dtype)
    pd = tops.natural_tangents(kind, theta).to(cuda_device, dtype)
    a, b, vv = (torch.tensor(z, device=cuda_device, dtype=dtype)
                for z in (x1, x2, v))
    _cuda.reset_launches()
    out = tkm.tile_matvec(kind, p, a, b, vv)
    tan = tkm.tile_stacked_tangent_matvec(kind, p, pd, a, b, vv)
    mat = tkt.tile_matrix(kind, p, a, b)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["tile_matvec"] >= 1
    assert _cuda.LAUNCHES["tile_tangent"] >= 1
    assert _cuda.LAUNCHES["tile_matrix"] == 1
    assert _relerr(out, tkm.tile_matvec_plain(kind, p, a, b, vv)) < tol
    want = tkm.tile_stacked_tangent_matvec_plain(kind, p, pd, a, b, vv)
    assert _relerr(tan, want) < 10 * tol
    assert _relerr(mat, tkt.tile_matrix_plain(kind, p, a, b)) < tol


@pytest.mark.cuda
def test_cuda_matvec_splits_wide_right_hand_sides(cuda_device):
    """b above one launch's column limit runs as several launches."""
    rng = np.random.default_rng(8)
    x = torch.tensor(np.sort(rng.uniform(0.0, 500.0, 200)),
                     device=cuda_device)
    v = torch.tensor(rng.standard_normal((200, 1100)), device=cuda_device)
    p = tops.natural_params("se", torch.tensor([np.log(5.0)])).to(
        cuda_device)
    _cuda.reset_launches()
    out = tkm.tile_matvec("se", p, x, x, v)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["tile_matvec"] == 3
    assert _relerr(out, tkm.tile_matvec_plain("se", p, x, x, v)) < 1e-12
