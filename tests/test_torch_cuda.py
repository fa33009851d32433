"""The CUDA kernels B1, B2, B4, B5, B6, B7, B8, B9, B10, B11, B12 and B13
against their plain PyTorch versions.

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
from repro_torch.kernels import operators as topers
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ski_fused as tsf

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


def _ski_geometry(n_full=3001, drop=0.1, seed=9):
    """A gappy two-hour record's SKI operator (W a selection matrix)."""
    rng = np.random.default_rng(seed)
    x = 2.0 * np.arange(n_full)
    x = x[rng.uniform(size=n_full) >= drop]
    return topers.select_operator("k2", torch.tensor(x), 0.01, 1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("b", [1, 8, 9, 70])
def test_cuda_ski_kernels_match_plain(cuda_device, dtype, tol, b):
    """B5 and B6 against their plain (torch.fft) versions."""
    op = _ski_geometry()
    assert op.name == "ski" and op.fused
    geom = op.fused_geom
    theta = torch.tensor(THETAS[("k2", "mid")], dtype=torch.float64)
    grid = topers.ToeplitzOperator("k2", op.grid)
    lam = tsf.spectrum(grid.first_column(theta), geom)
    lams = tsf.spectrum(grid.first_column_jacobian(theta), geom)
    rng = np.random.default_rng(b)
    v = torch.tensor(rng.standard_normal((geom.n, b)), device=cuda_device,
                     dtype=dtype)
    lam, lams = lam.to(cuda_device, dtype), lams.to(cuda_device, dtype)
    _cuda.reset_launches()
    got = tsf.fused_gram_matvec(geom, lam, 1e-4, v)
    tan = tsf.fused_tangent_matvecs(geom, lams, v)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["ski_gram"] == 1
    assert _cuda.LAUNCHES["ski_tangent"] == 1
    assert got.shape == (geom.n, b) and tan.shape == (5, geom.n, b)
    assert _relerr(got, tsf.fused_gram_matvec_plain(geom, lam, 1e-4, v)) \
        < tol
    assert _relerr(tan, tsf.fused_tangent_matvecs_plain(geom, lams, v)) < tol


@pytest.mark.cuda
def test_cuda_ski_wrappers_refuse_what_the_kernels_cannot_take(cuda_device):
    op = _ski_geometry(601)
    geom = op.fused_geom
    lam = torch.zeros(geom.L, device=cuda_device, dtype=torch.float64)
    v = torch.zeros((geom.n, 4), device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        tsf.fused_gram_matvec(geom, lam, 0.0, v[:, ::2])
    with pytest.raises(TypeError):
        tsf.fused_gram_matvec(geom, lam, 0.0, v.to(torch.float16))
    with pytest.raises(ValueError, match="one device"):
        tsf.fused_gram_matvec(geom, lam.cpu(), 0.0, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("B,c", [(1, 1), (4, 1), (4, 8), (4, 9), (20, 9)])
def test_cuda_bank_kernel_matches_plain(cuda_device, dtype, tol, B, c):
    """B7 against its plain (torch.fft) version, one launch per call; at
    B = 1 against B5 on the same inputs."""
    op = _ski_geometry()
    geom = op.fused_geom
    grid = topers.ToeplitzOperator("k2", op.grid)
    base = torch.tensor(THETAS[("k2", "mid")], dtype=torch.float64)
    step = torch.zeros_like(base)
    step[0] = 0.05                     # member q: the window moved 0.05 q
    lams = torch.stack([tsf.spectrum(grid.first_column(
        base + q * step), geom) for q in range(B)])
    rng = np.random.default_rng(B * 100 + c)
    V = torch.tensor(rng.standard_normal((geom.n, B, c)), device=cuda_device,
                     dtype=dtype)
    lams = lams.to(cuda_device, dtype)
    _cuda.reset_launches()
    got = tsf.fused_bank_matvec(geom, lams, 1e-4, V)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["ski_bank"] == 1 and got.shape == V.shape
    assert _relerr(got, tsf.fused_bank_matvec_plain(geom, lams, 1e-4, V)) \
        < tol
    if B == 1:
        one = tsf.fused_gram_matvec(geom, lams[0], 1e-4, V[:, 0].contiguous())
        assert _relerr(got[:, 0], one) < tol


@pytest.mark.cuda
def test_cuda_bank_wrapper_refuses_what_the_kernel_cannot_take(cuda_device):
    op = _ski_geometry(101)
    geom = op.fused_geom
    lams = torch.zeros((2, geom.L), device=cuda_device, dtype=torch.float64)
    V = torch.zeros((geom.n, 2, 4), device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        tsf.fused_bank_matvec(geom, lams, 0.0, V[:, :, ::2])
    with pytest.raises(ValueError, match="one device"):
        tsf.fused_bank_matvec(geom, lams.cpu(), 0.0, V)
    # 65536 packed columns, one more than gridDim.y holds: every index
    # space is on gridDim.x, so this is one launch like any other
    theta = torch.tensor(THETAS[("k2", "mid")], dtype=torch.float64)
    grid = topers.ToeplitzOperator("k2", op.grid)
    lam = tsf.spectrum(grid.first_column(theta), geom).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    wide = torch.randn((geom.n, 1, 2 * 65536), generator=gen,
                       device=cuda_device, dtype=torch.float64)
    _cuda.reset_launches()
    got = tsf.fused_bank_matvec(geom, lam[None], 1e-4, wide)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["ski_bank"] == 1
    assert _relerr(got, tsf.fused_bank_matvec_plain(geom, lam[None], 1e-4,
                                                    wide)) < 1e-12


ND_THETAS = {
    "se*matern32": [np.log(1.3), np.log(0.7)],
    "k2*se": [np.log(3.0), np.log(1.1), 0.1, np.log(1.9), -0.2,
              np.log(0.8)],
    "se*matern32*matern12": [np.log(1.6), np.log(0.9), np.log(0.5)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("kind", sorted(ND_THETAS))
def test_cuda_product_tile_kernels_match_plain(cuda_device, kind, dtype,
                                               tol):
    """B8 and B9 against their plain versions, ragged sizes, d = 2 and 3."""
    d = kind.count("*") + 1
    kinds = tops.split_kind(kind)
    rng = np.random.default_rng(d)
    x1 = rng.uniform(0.0, 8.0, (333, d))
    x2 = rng.uniform(0.0, 8.0, (301, d))
    v = rng.standard_normal((301, 9))
    theta = torch.tensor(ND_THETAS[kind], dtype=torch.float64)
    p = tops.natural_params_nd(kind, theta).to(cuda_device, dtype)
    pd = tops.natural_tangents_nd(kind, theta).to(cuda_device, dtype)
    a, b, vv = (torch.tensor(z, device=cuda_device, dtype=dtype)
                for z in (x1, x2, v))
    _cuda.reset_launches()
    out = tkm.tile_matvec_nd(kinds, p, a, b, vv)
    tan = tkm.tile_stacked_tangent_matvec_nd(kinds, p, pd, a, b, vv)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["tile_matvec_nd"] == 1
    assert _cuda.LAUNCHES["tile_tangent_nd"] == 1
    assert tan.shape == (pd.shape[0], 333, 9)
    assert _relerr(out, tkm.tile_matvec_nd_plain(kinds, p, a, b, vv)) < tol
    want = tkm.tile_stacked_tangent_matvec_nd_plain(kinds, p, pd, a, b, vv)
    assert _relerr(tan, want) < tol


def _field_geometry(shape=(40, 24), drop=0.15, seed=10):
    """A gappy 2-D field's product-SKI operator (W a selection matrix)."""
    axes = [h * np.arange(m) for m, h in zip(shape, (0.5, 0.25))]
    x = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 2)
    x = x[np.random.default_rng(seed).uniform(size=x.shape[0]) >= drop]
    return topers.select_operator("se*matern32", torch.tensor(x), 0.05,
                                  1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("b", [1, 8, 9, 70])
def test_cuda_ski_2d_kernels_match_plain(cuda_device, dtype, tol, b):
    """B10 and B11 against their plain (torch.fft) versions."""
    op = _field_geometry()
    assert op.name == "product_ski" and op.fused
    geom = op.fused_geom
    theta = torch.tensor(ND_THETAS["se*matern32"], dtype=torch.float64)
    lams = tsf.spectrum_nd(op._kron.first_columns(theta), geom)
    pairs = tsf.tangent_spectra_nd(op._kron, theta, geom, torch.float64)
    rng = np.random.default_rng(b)
    v = torch.tensor(rng.standard_normal((geom.n, b)), device=cuda_device,
                     dtype=dtype)
    lams = tuple(lam.to(cuda_device, dtype) for lam in lams)
    pairs = tuple(pr.to(cuda_device, dtype) for pr in pairs)
    _cuda.reset_launches()
    got = tsf.fused_gram_matvec_nd(geom, lams, 1e-3, v)
    tan = tsf.fused_tangent_matvecs_nd(geom, pairs, v)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["ski_gram_2d"] == 1
    assert _cuda.LAUNCHES["ski_tangent_2d"] == 1
    assert got.shape == (geom.n, b) and tan.shape == (2, geom.n, b)
    assert _relerr(got, tsf.fused_gram_matvec_nd_plain(geom, lams, 1e-3,
                                                       v)) < tol
    assert _relerr(tan, tsf.fused_tangent_matvecs_nd_plain(geom, pairs,
                                                           v)) < tol


@pytest.mark.cuda
def test_cuda_ski_2d_wrappers_refuse_what_the_kernels_cannot_take(
        cuda_device):
    geom = _field_geometry((12, 9)).fused_geom
    lams = (torch.zeros(geom.Ls[0], device=cuda_device, dtype=torch.float64),
            torch.zeros(geom.Ls[1], device=cuda_device, dtype=torch.float64))
    v = torch.zeros((geom.n, 4), device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        tsf.fused_gram_matvec_nd(geom, lams, 0.0, v[:, ::2])
    with pytest.raises(ValueError, match="one device"):
        tsf.fused_gram_matvec_nd(geom, (lams[0].cpu(), lams[1]), 0.0, v)
    with pytest.raises(TypeError):
        tsf.fused_gram_matvec_nd(geom, lams, 0.0, v.to(torch.float32))


ROW_SLAB_THETAS = {"se": [np.log(1.3)], "k2": THETAS[("k2", "mid")],
                   "se*matern32": ND_THETAS["se*matern32"],
                   "k2*se": ND_THETAS["k2*se"]}


def _row_slab_inputs(kind, b, n2, k, seed):
    """A batch of b distinct rows of n2 scattered points (1-D over a
    year of hours for k2, [0, 80] for se; (n2, 2) points in [0, 8]^2 for
    composite kinds) and a (n2, k) right-hand side."""
    rng = np.random.default_rng(seed)
    d = kind.count("*") + 1
    if d > 1:
        x = rng.uniform(0.0, 8.0, (n2, d))
    else:
        x = np.sort(rng.uniform(0.0, 8760.0 if kind == "k2" else 80.0, n2))
    rows = rng.permutation(n2)[:b]
    return x, rows, rng.standard_normal((n2, k))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", sorted(ROW_SLAB_THETAS))
@pytest.mark.parametrize("b,n2,k", [(37, 3001, 9), (8, 65537, 1),
                                    (1000, 4097, 70), (2048, 20000, 256),
                                    (40, 50, 3)])
def test_cuda_row_slab_kernels_match_plain(cuda_device, kind, dtype, b, n2,
                                           k):
    """B12 (1-D kinds) and B13 (composite kinds) against their plain
    versions on ragged shapes: one column segment (n2 = 50) up to a
    thousand (b = 8, n2 = 65537), k above one launch's column limit."""
    if dtype == torch.float32 and kind.startswith("k2"):
        pytest.skip("float32 cannot resolve the periodic factor's phase "
                    "at 1e-5 over a year of hours")
    x, rows, v = _row_slab_inputs(kind, b, n2, k, b + n2)
    theta = torch.tensor(ROW_SLAB_THETAS[kind], dtype=torch.float64)
    xt = torch.tensor(x, device=cuda_device, dtype=dtype)
    vt = torch.tensor(v, device=cuda_device, dtype=dtype)
    xb = xt[torch.tensor(rows, device=cuda_device)]
    kinds = tops.split_kind(kind)
    nd = len(kinds) > 1
    _cuda.reset_launches()
    if nd:
        p = tops.natural_params_nd(kind, theta).to(cuda_device, dtype)
        got = tkm.tile_matvec_rows_nd(kinds, p, xb, xt, vt)
        want = tkm.tile_matvec_nd_plain(kinds, p, xb, xt, vt)
    else:
        p = tops.natural_params(kind, theta).to(cuda_device, dtype)
        got = tkm.tile_matvec_rows(kind, p, xb, xt, vt)
        want = tkm.tile_matvec_plain(kind, p, xb, xt, vt)
    torch.cuda.synchronize()
    name = "tile_rows_nd" if nd else "tile_rows"
    limit = (_cuda.KERNELS.get("tile_nd_max_cols")(1, len(kinds),
                                                   vt.element_size())
             if nd else _cuda.KERNELS.get("tile_matvec_max_cols")(
                 vt.element_size()))
    assert _cuda.LAUNCHES[name] == -(-k // limit)
    # a row slab runs B1's (B8's) sweep but counts under its own name
    assert _cuda.LAUNCHES["tile_matvec_nd" if nd else "tile_matvec"] == 0
    assert got.shape == (b, k)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert _relerr(got, want) < tol
    assert _relerr(tops.matvec_rows(kind, theta.to(cuda_device), xb, xt,
                                    vt), want) < tol


@pytest.mark.cuda
def test_cuda_row_slab_wrappers_refuse_what_the_kernels_cannot_take(
        cuda_device):
    x, rows, v = _row_slab_inputs("se", 40, 500, 3, 1)
    xt = torch.tensor(x, device=cuda_device)
    vt = torch.tensor(v, device=cuda_device)
    xb = xt[:40]
    p = tops.natural_params("se", torch.zeros(1, dtype=torch.float64)).to(
        cuda_device)
    with pytest.raises(ValueError, match="one device"):
        tkm.tile_matvec_rows("se", p, xb.cpu(), xt, vt)
    with pytest.raises(TypeError):
        tkm.tile_matvec_rows("se", p, xb, xt, vt.to(torch.float32))
    with pytest.raises(TypeError, match="float64 or float32"):
        tkm.tile_matvec_rows("se", p.half(), xb.half(), xt.half(),
                             vt.half())
    with pytest.raises(ValueError, match="v must be"):
        tkm.tile_matvec_rows("se", p, xb, xt, vt[:-1])
    x2, _, v2 = _row_slab_inputs("se*matern32", 40, 500, 3, 2)
    x2t = torch.tensor(x2, device=cuda_device)
    p2 = tops.natural_params_nd("se*matern32",
                                torch.zeros(2, dtype=torch.float64)).to(
        cuda_device)
    with pytest.raises(ValueError, match=r"x1 must be \(n, 2\)"):
        tkm.tile_matvec_rows_nd(("se", "matern32"), p2, x2t[:40, :1], x2t,
                                torch.tensor(v2, device=cuda_device))
    empty = tkm.tile_matvec_rows("se", p, xb, xt[:0], vt[:0])
    assert empty.shape == (40, 3) and not bool(empty.any())
