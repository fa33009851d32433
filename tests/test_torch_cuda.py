"""The CUDA kernels B1-B13 against their plain PyTorch versions, and the
distributed GP step on a world-size-1 NCCL group against the same call on
the CPU (gloo, plain versions).

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
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("n2", [512, 511, 1, 3])
@pytest.mark.parametrize("kind", sorted(k for k, case in THETAS
                                        if case == "mid"))
def test_cuda_tile_matrix_matches_plain(cuda_device, kind, n2, dtype, tol):
    """B4 against its plain version in all six families on 333 rows (no
    multiple of the 8-row tile) and n2 = 512, 511, 1, 3 columns (ragged
    against the 128-column tile, odd rows unaligned), one launch each.  x2
    lies in [0, 1000] h, so the rows beyond ~1400 h lie wholly outside
    k1's and k2's window (T0 = 300, 400 h): exactly 0 in both versions.
    Row 5 holds a nan (a nan row in both); row 70 lies beyond
    +-VALUE_BIG: the kernel zeroes a k1 or k2 entry outside the window
    before its sine, where the plain version's overflowed sine gives a
    nan; the other families give the plain version's row."""
    rng = np.random.default_rng(n2)
    x1 = np.sort(rng.uniform(0.0, 8760.0, 333))
    x2 = rng.uniform(0.0, 1000.0, n2)
    x1[5] = np.nan
    x1[70] = 1.25 * tkm.VALUE_BIG[dtype]
    theta = torch.tensor(THETAS[(kind, "mid")], dtype=torch.float64)
    p = tops.natural_params(kind, theta).to(cuda_device, dtype)
    a, b = (torch.tensor(z, device=cuda_device, dtype=dtype)
            for z in (x1, x2))
    _cuda.reset_launches()
    got = tkt.tile_matrix(kind, p, a, b)
    torch.cuda.synchronize()
    assert dict(_cuda.LAUNCHES) == {"tile_matrix": 1}
    want = tkt.tile_matrix_plain(kind, p, a, b)
    assert got.shape == want.shape == (333, n2)
    keep = torch.ones(333, dtype=torch.bool, device=cuda_device)
    keep[[5, 70]] = False
    assert _relerr(got[keep], want[keep]) < tol
    assert torch.isnan(got[5]).all() and torch.isnan(want[5]).all()
    if kind in ("k1", "k2"):
        assert not bool(got[70].any()) and torch.isnan(want[70]).all()
        outside = keep & (a > 1400.0)
        assert bool(outside.any())
        assert not bool(got[outside].any()) and not bool(want[outside].any())
    else:
        assert torch.equal(got[70].isnan(), want[70].isnan())
        assert torch.equal(got[70].nan_to_num(), want[70].nan_to_num())


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


# the value sweep (B1, B12): k1 and k2 with the Wendland window at the fit
# box's edges, T0 = 4 h and 2000 h; se has no window
VALUE_THETAS = {
    ("k1", "t0_4"): [np.log(4.0), np.log(12.4), 0.1],
    ("k1", "t0_2000"): [np.log(2000.0), np.log(12.4), 0.1],
    ("k2", "t0_4"): [np.log(4.0), np.log(12.4), 0.05, np.log(24.0), -0.1],
    ("k2", "t0_2000"): [np.log(2000.0), np.log(12.4), 0.05, np.log(24.0),
                        -0.1],
    ("se", "no_window"): [np.log(40.0)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("b", [1, 8, 9, 16, 17, 256, 512])
@pytest.mark.parametrize("kind,case", sorted(VALUE_THETAS))
def test_cuda_value_sweep_matches_plain(cuda_device, kind, case, b, order,
                                        dtype, tol):
    """B1 on a ragged 333 x 1001 block and B12 on a batch of 100 gathered
    rows of the same 1001 points, against their plain versions, on both
    sides of the register / tensor-core switch (b = 16 | 17), sorted and
    unsorted; one launch each."""
    rng = np.random.default_rng(b + 7)
    x1 = rng.uniform(0.0, 8760.0, 333)
    x2 = rng.uniform(0.0, 8760.0, 1001)
    if order == "sorted":
        x1, x2 = np.sort(x1), np.sort(x2)
    v = rng.standard_normal((1001, b))
    rows = torch.tensor(rng.permutation(1001)[:100], device=cuda_device)
    theta = torch.tensor(VALUE_THETAS[(kind, case)], dtype=torch.float64)
    p = tops.natural_params(kind, theta).to(cuda_device, dtype)
    a, c, vv = (torch.tensor(z, device=cuda_device, dtype=dtype)
                for z in (x1, x2, v))
    _cuda.reset_launches()
    got = tkm.tile_matvec(kind, p, a, c, vv)
    slab = tkm.tile_matvec_rows(kind, p, c[rows], c, vv)
    torch.cuda.synchronize()
    assert dict(_cuda.LAUNCHES) == {"tile_matvec": 1, "tile_rows": 1}
    assert _relerr(got, tkm.tile_matvec_plain(kind, p, a, c, vv)) < tol
    assert _relerr(slab, tkm.tile_matvec_plain(kind, p, c[rows], c,
                                               vv)) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("kind,case", [("se", "no_window"),
                                       ("k2", "t0_2000")])
@pytest.mark.parametrize("b", [1, 9, 64])
def test_cuda_value_sweep_walks_long_segments(cuda_device, kind, case, b):
    """Enough stripes to fill the card leave one column segment of more
    than 256 tiles (the kernel's kept-tile list takes them 256 at a
    time); sorted k2 also skips most of them."""
    rng = np.random.default_rng(b)
    n1, n2 = 70000, 9000
    x1 = np.sort(rng.uniform(0.0, 8760.0, n1))
    x2 = np.sort(rng.uniform(0.0, 8760.0, n2))
    v = rng.standard_normal((n2, b))
    sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    segs, seg_cols = tkm.row_segments(n1, n2, sms, tkm.VALUE_GRID)
    assert seg_cols // tkm.VALUE_COLS > 256
    theta = torch.tensor(VALUE_THETAS[(kind, case)], dtype=torch.float64)
    p = tops.natural_params(kind, theta).to(cuda_device)
    a, c, vv = (torch.tensor(z, device=cuda_device) for z in (x1, x2, v))
    got = tkm.tile_matvec(kind, p, a, c, vv)
    torch.cuda.synchronize()
    assert _relerr(got, tkm.tile_matvec_plain(kind, p, a, c, vv)) < 1e-12


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


# gappy records (_ski_geometry's n_full) whose SKI embedding L is 2048, 8192
# and 16384 (four steps of 32 x 64, 64 x 128 and 128 x 128)
SKI_RECORDS = {2048: 601, 8192: 3001, 16384: 6000}
# B5's and B7's splits: the plan's own (None), a non-square one, and one
# line of L points (L1 = 1: step 2 a multiply by the spectrum)
SKI_SPLITS = [(2048, None), (2048, (64, 32)), (2048, (1, 2048)),
              (8192, None), (16384, None)]


def _ski_spectra(op, B):
    """(B, L) k2 spectra on op's grid, member q's window moved 0.05 q."""
    grid = topers.ToeplitzOperator("k2", op.grid)
    base = torch.tensor(THETAS[("k2", "mid")], dtype=torch.float64)
    step = torch.zeros_like(base)
    step[0] = 0.05
    return torch.stack([tsf.spectrum(grid.first_column(base + q * step),
                                     op.fused_geom) for q in range(B)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("L,split", SKI_SPLITS)
@pytest.mark.parametrize("b", [1, 9, 256])
def test_cuda_ski_gram_four_step_matches_plain(cuda_device, dtype, tol, L,
                                               split, b):
    """B5 against its plain version on the four steps of its plan and on
    the splits of SKI_SPLITS set on the geometry; one call, counted
    once."""
    op = _ski_geometry(SKI_RECORDS[L])
    geom = op.fused_geom
    assert geom.L == L
    geom.split = split
    lam = _ski_spectra(op, 1)[0].to(cuda_device, dtype)
    v = torch.tensor(np.random.default_rng(b).standard_normal((geom.n, b)),
                     device=cuda_device, dtype=dtype)
    _cuda.reset_launches()
    got = tsf.fused_gram_matvec(geom, lam, 1e-4, v)
    torch.cuda.synchronize()
    assert dict(_cuda.LAUNCHES) == {"ski_gram": 1}
    assert _relerr(got, tsf.fused_gram_matvec_plain(geom, lam, 1e-4, v)) \
        < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("L,split", SKI_SPLITS)
def test_cuda_bank_four_step_matches_plain(cuda_device, dtype, tol, L,
                                           split):
    """B7 at B = 20, c = 9 (the reference's ten restarts of two models)
    against its plain version on the splits of SKI_SPLITS, one call
    counted once; at B = 1 against B5 on the same split."""
    op = _ski_geometry(SKI_RECORDS[L])
    geom = op.fused_geom
    geom.split = split
    lams = _ski_spectra(op, 20).to(cuda_device, dtype)
    rng = np.random.default_rng(L)
    V = torch.tensor(rng.standard_normal((geom.n, 20, 9)),
                     device=cuda_device, dtype=dtype)
    _cuda.reset_launches()
    got = tsf.fused_bank_matvec(geom, lams, 1e-4, V)
    torch.cuda.synchronize()
    assert dict(_cuda.LAUNCHES) == {"ski_bank": 1}
    assert _relerr(got, tsf.fused_bank_matvec_plain(geom, lams, 1e-4, V)) \
        < tol
    one = tsf.fused_bank_matvec(geom, lams[:1], 1e-4, V[:, :1].contiguous())
    b5 = tsf.fused_gram_matvec(geom, lams[0], 1e-4, V[:, 0].contiguous())
    assert _relerr(one[:, 0], b5) < tol


SKI_LINE_KERNELS = ("fs_columns_fwd", "fs_rows_conv", "fs_columns_inv",
                    "w_apply_lines_1d")


def _kernel_names(fn, tries=3):
    """The names of the kernels that one call of fn launches on the card,
    from torch.profiler's device events: the longest list of ``tries``
    profiled calls (on the card the profiler has dropped one kernel of a
    call; it never adds one)."""
    from torch.profiler import ProfilerActivity, profile
    lists = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        lists.append([e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA])
    return max(lists, key=len)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("L,split", SKI_SPLITS)
@pytest.mark.parametrize("b", [1, 8, 9, 17])
@pytest.mark.parametrize("kind", ["k1", "k2"])
def test_cuda_ski_tangent_four_step_matches_plain(cuda_device, kind, b, L,
                                                  split, dtype, tol):
    """B6 (3 directions for k1, 5 for k2) against its plain version on the
    four steps of its plan and on the splits of SKI_SPLITS set on the
    geometry; one call, counted once, launching the pipeline's four
    kernels once each whatever the directions."""
    op = _ski_geometry(SKI_RECORDS[L])
    geom = op.fused_geom
    assert geom.L == L
    geom.split = split
    theta = torch.tensor(THETAS[(kind, "mid")], dtype=torch.float64)
    lams = tsf.spectrum(topers.ToeplitzOperator(kind, op.grid)
                        .first_column_jacobian(theta), geom)
    lams = lams.to(cuda_device, dtype)
    v = torch.tensor(np.random.default_rng(b).standard_normal((geom.n, b)),
                     device=cuda_device, dtype=dtype)
    _cuda.reset_launches()
    got = tsf.fused_tangent_matvecs(geom, lams, v)
    torch.cuda.synchronize()
    assert dict(_cuda.LAUNCHES) == {"ski_tangent": 1}
    assert got.shape == (lams.shape[0], geom.n, b)
    assert _relerr(got, tsf.fused_tangent_matvecs_plain(geom, lams, v)) \
        < tol
    names = _kernel_names(lambda: tsf.fused_tangent_matvecs(geom, lams, v))
    assert len(names) == 4
    assert sorted(k for k in SKI_LINE_KERNELS for n in names if k in n) == \
        sorted(SKI_LINE_KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [2048, 16384])
def test_cuda_ski_gram_and_bank_replay_in_a_cuda_graph(cuda_device, L):
    """B5 and B7 captured in one CUDA graph (four steps of 32 x 64 at
    L = 2048, 128 x 128 at 16384) and replayed on new inputs: the plain
    versions' answers on those inputs.  Relaxed capture: a plan whose
    blocks take more than 48 KB of shared memory sets its kernels'
    attribute (not a stream operation)."""
    op = _ski_geometry(SKI_RECORDS[L])
    geom = op.fused_geom
    lams = _ski_spectra(op, 4).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(L)
    v = torch.empty((geom.n, 9), device=cuda_device, dtype=torch.float64)
    V = torch.empty((geom.n, 4, 9), device=cuda_device, dtype=torch.float64)

    def calls():
        return (tsf.fused_gram_matvec(geom, lams[0], 1e-4, v),
                tsf.fused_bank_matvec(geom, lams, 1e-4, V))

    v.normal_(generator=gen)
    V.normal_(generator=gen)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    _cuda.reset_launches()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        out5, out7 = calls()
    assert dict(_cuda.LAUNCHES) == {"ski_gram": 1, "ski_bank": 1}
    v.normal_(generator=gen)
    V.normal_(generator=gen)
    graph.replay()
    torch.cuda.synchronize()
    assert _relerr(out5, tsf.fused_gram_matvec_plain(
        geom, lams[0], 1e-4, v)) < 1e-12
    assert _relerr(out7, tsf.fused_bank_matvec_plain(
        geom, lams, 1e-4, V)) < 1e-12


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


def _field_geometry(shape=(40, 24), drop=0.15, seed=10, kind="se*matern32"):
    """A gappy 2-D field's product-SKI operator (W a selection matrix)."""
    axes = [h * np.arange(m) for m, h in zip(shape, (0.5, 0.25))]
    x = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 2)
    x = x[np.random.default_rng(seed).uniform(size=x.shape[0]) >= drop]
    return topers.select_operator(kind, torch.tensor(x), 0.05, 1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("cap", [None, 64, 32])
@pytest.mark.parametrize("b", [1, 2, 8, 9, 17, 70, 256])
@pytest.mark.parametrize("kind", ["se*matern32", "k2*se"])
def test_cuda_ski_2d_kernels_match_plain(cuda_device, kind, b, cap, dtype,
                                         tol):
    """B10 and B11 against their plain (torch.fft) versions, B11 at m = 2
    ("se*matern32") and m = 6 ("k2*se"), odd and even b: on the line
    kernels (cap None: L = 128 x 64 both fit; B11's rows with three
    buffers) and, with the line cap lowered, B11 as B10's gram once per
    direction on the global passes of axis 0 (cap 64) and of both axes
    (cap 32); one call, counted once, each."""
    op = _field_geometry(kind=kind)
    assert op.name == "product_ski" and op.fused
    geom = op.fused_geom
    assert geom.Ls == (128, 64)
    theta = torch.tensor(ND_THETAS[kind], dtype=torch.float64)
    lams = tsf.spectrum_nd(op._kron.first_columns(theta), geom)
    pairs = tsf.tangent_spectra_nd(op._kron, theta, geom, torch.float64)
    m = 2 if kind == "se*matern32" else 6
    rng = np.random.default_rng(b)
    v = torch.tensor(rng.standard_normal((geom.n, b)), device=cuda_device,
                     dtype=dtype)
    lams = tuple(lam.to(cuda_device, dtype) for lam in lams)
    pairs = tuple(pr.to(cuda_device, dtype) for pr in pairs)
    _cuda.reset_launches()
    if cap is None:
        got = tsf.fused_gram_matvec_nd(geom, lams, 1e-3, v)
        tan = tsf.fused_tangent_matvecs_nd(geom, pairs, v)
    else:
        got = tsf._launch_gram_2d(geom, lams, 1e-3, v, cap)
        tan = tsf._launch_tangent_2d(geom, pairs, v, cap)
    torch.cuda.synchronize()
    assert dict(_cuda.LAUNCHES) == {"ski_gram_2d": 1, "ski_tangent_2d": 1}
    plan = tsf.gram_2d_plan(geom.shape, geom.Ls, b, v.element_size(), cap,
                            m)
    assert plan.per_direction == (cap is not None)
    assert got.shape == (geom.n, b) and tan.shape == (m, geom.n, b)
    assert _relerr(got, tsf.fused_gram_matvec_nd_plain(geom, lams, 1e-3,
                                                       v)) < tol
    want = tsf.fused_tangent_matvecs_nd_plain(geom, pairs, v)
    for i in range(m):
        assert _relerr(tan[i], want[i]) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("cap", [None, 64, 32])
@pytest.mark.parametrize("b", [1, 2, 9, 17, 256])
def test_cuda_ski_2d_gram_line_branches_match_plain(cuda_device, dtype, tol,
                                                    cap, b):
    """B10 against its plain version at b = 1, 2, 9, an odd 17 and 256, on
    its shared-memory line kernels (cap None: L = 128 x 64 both fit) and,
    with the line cap lowered, on the global passes of axis 0 (cap 64) and
    of both axes (cap 32); one call, counted once, each time."""
    op = _field_geometry()
    geom = op.fused_geom
    assert geom.Ls == (128, 64)
    theta = torch.tensor(ND_THETAS["se*matern32"], dtype=torch.float64)
    lams = tuple(lam.to(cuda_device, dtype) for lam in tsf.spectrum_nd(
        op._kron.first_columns(theta), geom))
    v = torch.tensor(np.random.default_rng(b).standard_normal((geom.n, b)),
                     device=cuda_device, dtype=dtype)
    _cuda.reset_launches()
    if cap is None:
        got = tsf.fused_gram_matvec_nd(geom, lams, 1e-3, v)
    else:
        got = tsf._launch_gram_2d(geom, lams, 1e-3, v, cap)
    torch.cuda.synchronize()
    assert dict(_cuda.LAUNCHES) == {"ski_gram_2d": 1}
    want = tsf.fused_gram_matvec_nd_plain(geom, lams, 1e-3, v)
    assert _relerr(got, want) < tol


@pytest.mark.cuda
def test_cuda_ski_2d_gram_beyond_the_line_cap_matches_plain(cuda_device):
    """B10 on a field whose time axis (L1 = 8192) is longer than the
    float64 line cap (4096): axis 0 on the global passes, axis 1 on its
    line kernel, without lowering the cap; B11 there as B10's gram once
    per direction."""
    op = _field_geometry((2100, 3))
    geom = op.fused_geom
    assert op.fused and geom.Ls[0] > tsf.line_cap(8) >= geom.Ls[1]
    theta = torch.tensor(ND_THETAS["se*matern32"], dtype=torch.float64)
    lams = tuple(lam.to(cuda_device) for lam in tsf.spectrum_nd(
        op._kron.first_columns(theta), geom))
    assert _cuda.KERNELS.get("ski_gram_2d_line_cap")(8) == tsf.line_cap(8)
    assert _cuda.KERNELS.get("ski_gram_2d_line_cap")(4) == tsf.line_cap(4)
    pairs = tuple(pr.to(cuda_device) for pr in tsf.tangent_spectra_nd(
        op._kron, theta, geom, torch.float64))
    assert tsf.gram_2d_plan(geom.shape, geom.Ls, 9, 8, None,
                            2).per_direction
    for b in (1, 9):
        v = torch.tensor(np.random.default_rng(b).standard_normal(
            (geom.n, b)), device=cuda_device)
        got = tsf.fused_gram_matvec_nd(geom, lams, 1e-3, v)
        want = tsf.fused_gram_matvec_nd_plain(geom, lams, 1e-3, v)
        assert _relerr(got, want) < 1e-12
        # B11: B10's gram once per direction, no noise
        tan = tsf.fused_tangent_matvecs_nd(geom, pairs, v)
        want = tsf.fused_tangent_matvecs_nd_plain(geom, pairs, v)
        for i in range(2):
            assert _relerr(tan[i], want[i]) < 1e-12


FAMILY_THETAS = {"k1": [np.log(3.0), np.log(1.1), 0.1],
                 "k2": ND_THETAS["k2*se"][:5], "se": [np.log(1.3)],
                 "matern12": [np.log(0.9)], "matern32": [np.log(0.7)],
                 "matern52": [np.log(1.6)]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("family", sorted(FAMILY_THETAS))
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_cuda_product_value_sweep_matches_plain(cuda_device, d, family,
                                                dtype, tol):
    """B8 and B13 (the value sweep's product entry) against their plain
    versions: ``family`` on each axis in turn beside "se" on the others,
    b = 1, 9, 16 (registers), 17 and 256 (tensor cores), ragged n1 and
    n2; one launch each, counted under its own name."""
    rng = np.random.default_rng(10 * d + len(family))
    n1, n2 = 333, 301
    for a in range(d):
        kinds = ["se"] * d
        kinds[a] = family
        kind = "*".join(kinds)
        theta = torch.tensor(sum((FAMILY_THETAS[k] for k in kinds), []),
                             dtype=torch.float64)
        p = tops.natural_params_nd(kind, theta).to(cuda_device, dtype)
        x1 = torch.tensor(rng.uniform(0.0, 8.0, (n1, d)), device=cuda_device,
                          dtype=dtype)
        x2 = torch.tensor(rng.uniform(0.0, 8.0, (n2, d)), device=cuda_device,
                          dtype=dtype)
        rows = x2[torch.tensor(rng.permutation(n2)[:97], device=cuda_device)]
        for b in (1, 9, 16, 17, 256):
            v = torch.tensor(rng.standard_normal((n2, b)), device=cuda_device,
                             dtype=dtype)
            _cuda.reset_launches()
            got = tkm.tile_matvec_nd(kinds, p, x1, x2, v)
            slab = tkm.tile_matvec_rows_nd(kinds, p, rows, x2, v)
            torch.cuda.synchronize()
            assert dict(_cuda.LAUNCHES) == {"tile_matvec_nd": 1,
                                            "tile_rows_nd": 1}
            want = tkm.tile_matvec_nd_plain(kinds, p, x1, x2, v)
            assert _relerr(got, want) < tol, (kind, b)
            want = tkm.tile_matvec_nd_plain(kinds, p, rows, x2, v)
            assert _relerr(slab, want) < tol, (kind, b)


def _product_case(rng, d, a, family, dtype, device, n1=333, n2=301):
    """``family`` on axis a beside "se" on the others: kinds, params, the
    natural pdots and ragged (n1, d), (n2, d) points on the card."""
    kinds = ["se"] * d
    kinds[a] = family
    kind = "*".join(kinds)
    theta = torch.tensor(sum((FAMILY_THETAS[k] for k in kinds), []),
                         dtype=torch.float64)
    p = tops.natural_params_nd(kind, theta).to(device, dtype)
    pd = tops.natural_tangents_nd(kind, theta).to(device, dtype)
    x1, x2 = (torch.tensor(rng.uniform(0.0, 8.0, (n, d)), device=device,
                           dtype=dtype) for n in (n1, n2))
    return kinds, p, pd, x1, x2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("family", sorted(FAMILY_THETAS))
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_cuda_product_tangent_sweep_matches_plain(cuda_device, d, family,
                                                  dtype, tol):
    """B9 (the value sweep's product gradient entry) against its plain
    version: ``family`` on each axis in turn beside "se" on the others,
    the natural directions at b = 1, 8, 9, 16 and 17 and m = 1 .. 10
    random dense directions at b = 9, ragged n1 and n2 (at T0 = 3 most
    pairs of a k1 or k2 axis lie beyond its window); one launch per call,
    two calls give the same bits."""
    rng = np.random.default_rng(20 * d + len(family))
    for a in range(d):
        kinds, p, pd, x1, x2 = _product_case(rng, d, a, family, dtype,
                                             cuda_device)
        dense = [torch.tensor(rng.standard_normal((m, d, 8)),
                              device=cuda_device, dtype=dtype)
                 for m in range(1, 11)]
        for b, pdots in ([(b, pd) for b in (1, 8, 9, 16, 17)]
                         + [(9, q) for q in dense]):
            v = torch.tensor(rng.standard_normal((301, b)),
                             device=cuda_device, dtype=dtype)
            _cuda.reset_launches()
            got = tkm.tile_stacked_tangent_matvec_nd(kinds, p, pdots, x1, x2,
                                                     v)
            again = tkm.tile_stacked_tangent_matvec_nd(kinds, p, pdots, x1,
                                                       x2, v)
            torch.cuda.synchronize()
            assert dict(_cuda.LAUNCHES) == {"tile_tangent_nd": 2}
            assert got.shape == (pdots.shape[0], 333, b)
            assert torch.equal(got, again)
            want = tkm.tile_stacked_tangent_matvec_nd_plain(kinds, p, pdots,
                                                            x1, x2, v)
            assert _relerr(got, want) < tol, (kinds, b, pdots.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_product_tangent_sweep_zeroes_beyond_a_k2_window(cuda_device,
                                                              dtype):
    """"k2*se" with rows of x1 far beyond the k2 window of every column
    (finite, 1e6 away, and beyond +-VALUE_BIG): those rows are exactly 0
    (the entry is 0 before any sincos or exp; the plain version gives 0
    for the first and a nan, the sine of an overflowed argument, for the
    second); every other row matches the plain version."""
    rng = np.random.default_rng(7)
    kinds, p, pd, x1, x2 = _product_case(rng, 2, 0, "k2", dtype,
                                         cuda_device)
    x1[40, 0] = 1e6
    x1[70, 0] = 1.25 * tkm.VALUE_BIG[dtype]
    v = torch.tensor(rng.standard_normal((301, 9)), device=cuda_device,
                     dtype=dtype)
    got = tkm.tile_stacked_tangent_matvec_nd(kinds, p, pd, x1, x2, v)
    want = tkm.tile_stacked_tangent_matvec_nd_plain(kinds, p, pd, x1, x2, v)
    torch.cuda.synchronize()
    keep = torch.ones(333, dtype=torch.bool, device=cuda_device)
    keep[[40, 70]] = False
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert _relerr(got[:, keep], want[:, keep]) < tol
    assert not bool(got[:, 40].any()) and not bool(want[:, 40].any())
    assert not bool(got[:, 70].any())


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
    # B12 and B13 run the value sweep: one column limit for both
    limit = _cuda.KERNELS.get("tile_matvec_max_cols")(vt.element_size())
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("b", [1, 8, 9])
@pytest.mark.parametrize("kind", sorted({k for k, _ in THETAS}))
@pytest.mark.parametrize("n1,n2", [(333, 301), (1000, 1001)])
def test_cuda_tile_jvp_matches_plain(cuda_device, kind, b, dtype, tol, n1,
                                     n2):
    """B3 on ragged shapes (no multiple of the 32-row / 64-column tiles)
    against its plain version, along a direction that moves every flat
    coordinate; one launch per call, counted under tile_jvp."""
    rng = np.random.default_rng(9)
    x1 = np.sort(rng.uniform(0.0, 8760.0, n1))
    x2 = np.sort(rng.uniform(0.0, 8760.0, n2))
    v = rng.standard_normal((n2, b))
    theta = torch.tensor(THETAS[(kind, "mid")], dtype=torch.float64)
    dth = torch.tensor(rng.standard_normal(theta.shape[0]))
    p = tops.natural_params(kind, theta).to(cuda_device, dtype)
    pdot = (dth @ tops.natural_tangents(kind, theta)).to(cuda_device, dtype)
    a, c, vv = (torch.tensor(z, device=cuda_device, dtype=dtype)
                for z in (x1, x2, v))
    _cuda.reset_launches()
    got = tkm.tile_jvp(kind, p, pdot, a, c, vv)
    torch.cuda.synchronize()
    assert dict(_cuda.LAUNCHES) == {"tile_jvp": 1}
    assert _relerr(got, tkm.tile_jvp_plain(kind, p, pdot, a, c, vv)) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("b", [1, 8, 9, 16, 17, 64])
@pytest.mark.parametrize("kind", sorted({k for k, _ in THETAS}))
def test_cuda_tangent_sweeps_match_plain(cuda_device, kind, b, order, dtype,
                                         tol):
    """B2 with m = 1, 3 and 5 random dense pdots rows and B3 along a
    random direction, on a ragged 1000 x 1001 block, sorted and unsorted,
    either side of the register switch (b = 16 | 17), against their plain
    versions; one launch per call, two calls give the same bits."""
    rng = np.random.default_rng(b + 3)
    x1 = rng.uniform(0.0, 8760.0, 1000)
    x2 = rng.uniform(0.0, 8760.0, 1001)
    if order == "sorted":
        x1, x2 = np.sort(x1), np.sort(x2)
    theta = torch.tensor(THETAS[(kind, "mid")], dtype=torch.float64)
    p = tops.natural_params(kind, theta).to(cuda_device, dtype)
    a, c, vv = (torch.tensor(z, device=cuda_device, dtype=dtype)
                for z in (x1, x2, rng.standard_normal((1001, b))))
    for m in (1, 3, 5):
        pd = torch.tensor(rng.standard_normal((m, 8)), device=cuda_device,
                          dtype=dtype)
        _cuda.reset_launches()
        got = tkm.tile_stacked_tangent_matvec(kind, p, pd, a, c, vv)
        again = tkm.tile_stacked_tangent_matvec(kind, p, pd, a, c, vv)
        jvp = tkm.tile_jvp(kind, p, pd[0], a, c, vv)
        jvp_again = tkm.tile_jvp(kind, p, pd[0], a, c, vv)
        torch.cuda.synchronize()
        assert dict(_cuda.LAUNCHES) == {"tile_tangent": 2, "tile_jvp": 2}
        assert got.shape == (m, 1000, b) and jvp.shape == (1000, b)
        assert torch.equal(got, again) and torch.equal(jvp, jvp_again)
        assert _relerr(got, tkm.tile_stacked_tangent_matvec_plain(
            kind, p, pd, a, c, vv)) < tol
        assert _relerr(jvp, tkm.tile_jvp_plain(kind, p, pd[0], a, c,
                                               vv)) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("b", [9, 17])
@pytest.mark.parametrize("kind", ["k1", "k2"])
def test_cuda_tangent_sweeps_skip_nothing_beside_a_huge_point(
        cuda_device, kind, b, dtype):
    """A row of x1 beyond +-VALUE_BIG keeps its stripe from being skipped:
    the other rows of B2 and B3 still match their plain versions, and the
    row itself is exactly 0 (the kernels zero an entry outside the window
    before its sincos; the plain version's sine of an overflowed argument
    gives a nan there)."""
    rng = np.random.default_rng(b)
    x1 = np.sort(rng.uniform(0.0, 8760.0, 333))
    x2 = np.sort(rng.uniform(0.0, 8760.0, 301))
    x1[70] = 1.25 * tkm.VALUE_BIG[dtype]
    theta = torch.tensor(THETAS[(kind, "mid")], dtype=torch.float64)
    p = tops.natural_params(kind, theta).to(cuda_device, dtype)
    pd = torch.tensor(rng.standard_normal((3, 8)), device=cuda_device,
                      dtype=dtype)
    a, c, vv = (torch.tensor(z, device=cuda_device, dtype=dtype)
                for z in (x1, x2, rng.standard_normal((301, b))))
    got = tkm.tile_stacked_tangent_matvec(kind, p, pd, a, c, vv)
    jvp = tkm.tile_jvp(kind, p, pd[0], a, c, vv)
    torch.cuda.synchronize()
    keep = torch.arange(333, device=cuda_device) != 70
    tol = 1e-11 if dtype == torch.float64 else 1e-5
    want = tkm.tile_stacked_tangent_matvec_plain(kind, p, pd, a, c, vv)
    assert _relerr(got[:, keep], want[:, keep]) < tol
    want = tkm.tile_jvp_plain(kind, p, pd[0], a, c, vv)
    assert _relerr(jvp[keep], want[keep]) < tol
    assert not bool(got[:, 70].any()) and not bool(jvp[70].any())


@pytest.mark.cuda
def test_cuda_distributed_step_matches_the_cpu(cuda_device):
    """distributed_profiled_loglik on a world-size-1 NCCL group against the
    same call on a gloo group on the CPU, with the same probes and CG to
    its tolerance, on the tile, Toeplitz and SKI branches (n = 1024); the
    card's tile branch launches B3 2 m times."""
    import torch.distributed as dist

    from repro_torch.core import distributed as tdist
    from repro_torch.launch.mesh import make_local_group

    rng = np.random.default_rng(10)
    n = 1024
    full = 2.0 * np.arange(1200)
    inputs = {"pallas": np.sort(rng.uniform(0.0, float(n), n)),
              "toeplitz": np.arange(1.0, n + 1.0),
              "ski": np.delete(full, np.arange(3, 1200, 8))[:n]}
    y = np.sin(np.arange(n) / 9.0) + 0.1 * rng.standard_normal(n)
    z = rng.choice([-1.0, 1.0], (n, 8))
    theta = {"pallas": [3.2, 1.5, 0.05, 2.8, -0.1],
             "toeplitz": [3.2, 1.5, 0.05, 2.8, -0.1],
             "ski": [np.log(300.0), np.log(12.42), 0.0, np.log(23.93), 0.0]}
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        group = make_local_group(dev)
        try:
            for br, x in inputs.items():
                _cuda.reset_launches()
                r = tdist.distributed_profiled_loglik(
                    "k2", theta[br], x, y, 0.1, group, None, n_probes=8,
                    lanczos_k=32, cg_tol=1e-10, cg_max_iter=3000, probes=z,
                    device=dev)
                out[(dev.type, br)] = (float(r.log_p_max), r.grad.cpu())
                if dev.type == "cuda" and br == "pallas":
                    assert _cuda.LAUNCHES["tile_jvp"] == 10
                    assert _cuda.LAUNCHES["tile_tangent"] == 0
        finally:
            dist.destroy_process_group()
    for br in inputs:
        (lp, g), (lp_cpu, g_cpu) = out[("cuda", br)], out[("cpu", br)]
        assert abs(lp - lp_cpu) <= 1e-8 * abs(lp_cpu)
        assert _relerr(g, g_cpu) <= 1e-8
