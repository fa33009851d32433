"""B10's and B11's order of work on the CPU: the 2-D product-SKI gram and
stacked tangents as the card's kernels compute them
(csrc/ski_lines_2d.cuh) and the host-side plan that sizes their launches
and scratch.

``ski_fused.fused_gram_matvec_nd_pruned`` packs two real columns into one
complex column, convolves the m1 occupied rows along axis 1 (cropped to
m2), then the m2 columns along axis 0 (cropped to m1).
``fused_tangent_matvecs_nd_pruned`` runs the forward row transforms once
and each direction's row inverse and columns by its own pair of axis
spectra.  Both are held to 1e-12 relative (max-abs error over max-abs
value) against the plain versions the card holds B10 and B11 against
(``fused_gram_matvec_nd_plain``, ``fused_tangent_matvecs_nd_plain``) and
against the JAX package's fused kernels (Pallas, interpret mode) on the
same geometry.  ``gram_2d_plan`` is held to the launch count and compact
scratch the kernels were designed to (three launches, one buffer of
dirs ceil(b / 2) m1 m2 complex values when both axes fit the line cap)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import operators as jopers
from repro_torch.kernels import operators as topers
from repro_torch.kernels import ski_fused as tsf

TOL = 1e-12
SIGMA, JITTER = 0.1, 1e-8
THETA = [np.log(1.3), np.log(0.7)]
KIND = "se*matern32"
# "k2*se": six tangent directions, five on the time axis
THETA_K2SE = [np.log(3.0), np.log(1.1), 0.1, np.log(1.9), -0.2, np.log(0.8)]


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _gappy_x(shape, drop=0.2, seed=1):
    axes = [h * np.arange(m) for m, h in zip(shape, (0.5, 0.25))]
    X = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 2)
    return X[np.random.default_rng(seed).random(X.shape[0]) >= drop]


def _operator(shape, drop=0.2, seed=1, kind=KIND):
    op = topers.select_operator(kind, _t(_gappy_x(shape, drop, seed)), SIGMA,
                                JITTER)
    assert op.name == "product_ski" and op.fused
    return op


def _with_lengths(geom, Ls):
    """The same geometry embedded at other axis lengths."""
    return tsf.FusedSKIGeometry2D(geom.n, geom.shape, geom.occ, geom.wcell,
                                  geom.cell, geom.offs, Ls, geom.idx,
                                  geom.w)


@pytest.mark.parametrize("data_shape,b", [((10, 8), 1), ((10, 8), 2),
                                          ((10, 8), 3), ((26, 14), 3),
                                          ((34, 5), 2)])
def test_pruned_order_matches_the_plain_version(data_shape, b):
    """The twin against ``fused_gram_matvec_nd_plain`` (m <= 40 per axis,
    odd and even b); the (26, 14) field has m = (32, 20) cells, the
    tightest embedding the port's L rule gives (2 m1 - 1 = L1 - 1)."""
    op = _operator(data_shape)
    geom = op.fused_geom
    assert max(geom.shape) <= 40
    lams = tsf.spectrum_nd(op._kron.first_columns(_t(THETA)), geom)
    v = _t(np.random.default_rng(b).standard_normal((geom.n, b)))
    got = tsf.fused_gram_matvec_nd_pruned(geom, lams, op.noise2, v)
    want = tsf.fused_gram_matvec_nd_plain(geom, lams, op.noise2, v)
    assert got.shape == (geom.n, b)
    assert _rel(got.numpy(), want.numpy()) < TOL


def test_pruned_order_at_the_least_embedding():
    """A grid with m_a - 1 = L_a / 2 on both axes (17 x 9 cells embedded
    at 32 x 16 = 2 m_a - 2, the least circulant embedding): the twin and
    the plain version there agree with each other and with the plain
    version at the geometry's own power-of-two lengths (64 x 32)."""
    op = _operator((11, 3), drop=0.1)
    geom = op.fused_geom
    assert geom.shape == (17, 9) and geom.Ls == (64, 32)
    tight = _with_lengths(geom, (32, 16))
    assert all(m - 1 == L // 2 for m, L in zip(tight.shape, tight.Ls))
    cols = op._kron.first_columns(_t(THETA))
    v = _t(np.random.default_rng(4).standard_normal((geom.n, 3)))
    lams = tsf.spectrum_nd(cols, tight)
    got = tsf.fused_gram_matvec_nd_pruned(tight, lams, op.noise2, v)
    assert _rel(got.numpy(), tsf.fused_gram_matvec_nd_plain(
        tight, lams, op.noise2, v).numpy()) < TOL
    want = tsf.fused_gram_matvec_nd_plain(
        geom, tsf.spectrum_nd(cols, geom), op.noise2, v)
    assert _rel(got.numpy(), want.numpy()) < TOL


def test_pruned_order_matches_the_jax_kernel():
    """The twin against JAX's fused 2-D gram (Pallas, interpret mode) on
    the same gappy field, b = 3 (an odd b: one zero half)."""
    X = _gappy_x((10, 8), drop=0.25, seed=3)
    jp = jopers.select_operator(KIND, X, SIGMA, JITTER, fused=True)
    tp = topers.select_operator(KIND, _t(X), SIGMA, JITTER)
    assert jp.fused and tp.fused
    V = np.random.default_rng(6).standard_normal((X.shape[0], 3))
    want = np.asarray(jax.jit(jp.gram_matvec)(jnp.asarray(THETA),
                                              jnp.asarray(V)))
    geom = tp.fused_geom
    lams = tsf.spectrum_nd(tp._kron.first_columns(_t(THETA)), geom)
    got = tsf.fused_gram_matvec_nd_pruned(geom, lams, tp.noise2, _t(V))
    assert _rel(got.numpy(), want) < TOL


def test_line_cap_is_the_longest_line_a_block_holds():
    for item, cap in ((8, 4096), (4, 8192)):
        assert tsf.line_cap(item) == cap
        assert tsf.line_smem_bytes(cap, 1, item) <= tsf.LINE_SMEM_LIMIT
        assert tsf.line_smem_bytes(2 * cap, 1, item) > tsf.LINE_SMEM_LIMIT


@pytest.mark.parametrize("item", [8, 4])
def test_line_kernel_plans_fit_a_block(item):
    """Every (tpl, lpb) fits a block (threads, shared memory), takes
    threads for the radix-4 butterflies of a line and no more lines than
    there are (rounded up to a power of two)."""
    for lg in range(1, tsf.line_cap(item).bit_length()):
        L = 1 << lg
        for lines in (1, 3, 9, 70, 134, 2106):
            tpl, lpb = tsf.line_kernel_plan(L, lines, item)
            assert 1 <= tpl <= min(max(L // 4, 1), tsf.LINE_TPL)
            assert 1 <= lpb and tpl * lpb <= 1024
            assert lpb <= 1 << (lines - 1).bit_length()
            assert tsf.line_smem_bytes(L, lpb, item) <= tsf.LINE_SMEM_LIMIT
            if lpb > 1:
                assert tsf.line_smem_bytes(L, lpb, item) <= \
                    tsf.LINE_SMEM_TARGET


@pytest.mark.parametrize("b", [1, 8, 9, 256])
def test_plan_at_the_product_ski_cell(b):
    """The N-D cell's geometry (134 x 70 cells, L = 512 x 256): three
    launches and one compact scratch buffer of ceil(b / 2) m1 m2 complex
    values (19.2 MB at b = 256, where the whole-plane passes took two of
    268 MB)."""
    P = (b + 1) // 2
    for item in (8, 4):
        plan = tsf.gram_2d_plan((134, 70), (512, 256), b, item)
        assert plan.launches == 3 <= 5
        assert plan.scratch == (P * 134 * 70, 0)
        assert plan.rows == (64, 4) and plan.cols == (128, 2)
    plan = tsf.gram_2d_plan((134, 70), (512, 256), 256, 8)
    assert 16 * sum(plan.scratch) == 19_210_240


def test_plan_takes_the_global_passes_beyond_the_cap():
    """An axis longer than the cap takes the global passes: its stage's
    ping-pong buffers ((P, m1, L2) for the rows, (P, L1, m2) for the
    columns) size both scratch buffers, and the launches count W^T (or
    the pad), each pass forward and back, and W."""
    P = 5
    plan = tsf.gram_2d_plan((2106, 9), (8192, 32), 9, 8)
    assert plan.cap == 4096
    assert plan.scratch == (P * 8192 * 9, P * 8192 * 9)
    assert plan.launches == 1 + (1 + 2 * 7) + 1
    # float32 holds the 8192-point line in shared memory
    plan = tsf.gram_2d_plan((2106, 9), (8192, 32), 9, 4)
    assert plan.scratch == (P * 2106 * 9, 0) and plan.launches == 3
    # a lowered cap: the columns on passes (64), both axes (32)
    shape, Ls = (46, 30), (128, 64)
    plan = tsf.gram_2d_plan(shape, Ls, 9, 8, 64)
    assert plan.cap == 64 and plan.launches == 1 + (1 + 2 * 4) + 1
    assert plan.scratch == (P * 128 * 30, P * 128 * 30)
    plan = tsf.gram_2d_plan(shape, Ls, 9, 8, 32)
    assert plan.launches == (1 + 2 * 3) + (1 + 2 * 4) + 1
    assert plan.scratch == (P * 128 * 30, P * 128 * 30)
    plan = tsf.gram_2d_plan((46, 100), (128, 256), 9, 8, 128)
    assert plan.launches == (1 + 2 * 4) + 1 + 1
    assert plan.scratch == (P * 46 * 256, P * 46 * 256)


# ---------------------------------------------------------------------------
# B11: the stacked tangents on the same line kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data_shape", [(10, 8), (26, 14)])
@pytest.mark.parametrize("b", [1, 2, 3, 9])
def test_tangent_pruned_order_matches_the_plain_version(data_shape, b):
    """B11's twin against ``fused_tangent_matvecs_nd_plain`` at m = 2
    ("se*matern32": one direction per axis), odd and even b."""
    op = _operator(data_shape)
    geom = op.fused_geom
    pairs = tsf.tangent_spectra_nd(op._kron, _t(THETA), geom, torch.float64)
    assert pairs[0].shape == (2, geom.Ls[0])
    v = _t(np.random.default_rng(b).standard_normal((geom.n, b)))
    got = tsf.fused_tangent_matvecs_nd_pruned(geom, pairs, v)
    want = tsf.fused_tangent_matvecs_nd_plain(geom, pairs, v)
    assert got.shape == (2, geom.n, b)
    assert _rel(got.numpy(), want.numpy()) < TOL


@pytest.mark.parametrize("b", [1, 9])
def test_tangent_pruned_order_takes_six_directions(b):
    """"k2*se" on the (26, 14) field: five directions share the time
    axis's base lam2, the sixth the time axis's base lam1; the twin
    against the plain version, each direction on its own scale."""
    op = _operator((26, 14), kind="k2*se")
    geom = op.fused_geom
    pairs = tsf.tangent_spectra_nd(op._kron, _t(THETA_K2SE), geom,
                                   torch.float64)
    assert pairs[0].shape == (6, geom.Ls[0])
    v = _t(np.random.default_rng(b).standard_normal((geom.n, b)))
    got = tsf.fused_tangent_matvecs_nd_pruned(geom, pairs, v).numpy()
    want = tsf.fused_tangent_matvecs_nd_plain(geom, pairs, v).numpy()
    for i in range(6):
        assert _rel(got[i], want[i]) < TOL


def test_tangent_pruned_order_matches_the_jax_kernel():
    """B11's twin against JAX's fused 2-D tangents (Pallas, interpret
    mode) on one (10, 8) gappy field, m = 2, b = 3."""
    X = _gappy_x((10, 8), drop=0.25, seed=3)
    jp = jopers.select_operator(KIND, X, SIGMA, JITTER, fused=True)
    tp = topers.select_operator(KIND, _t(X), SIGMA, JITTER)
    assert jp.fused and tp.fused
    V = np.random.default_rng(7).standard_normal((X.shape[0], 3))
    want = np.asarray(jax.jit(jp.tangent_matvecs)(jnp.asarray(THETA),
                                                  jnp.asarray(V)))
    geom = tp.fused_geom
    pairs = tsf.tangent_spectra_nd(tp._kron, _t(THETA), geom, torch.float64)
    got = tsf.fused_tangent_matvecs_nd_pruned(geom, pairs, _t(V))
    assert got.shape == want.shape == (2, X.shape[0], 3)
    assert _rel(got.numpy(), want) < TOL


def test_three_buffer_rows_fit_half_the_line_cap():
    """A row line of B11's three buffers (the forward line kept beside the
    inverse's two) fits a block up to 2048 points in float64 and 4096 in
    float32, half the two-buffer cap."""
    for item, cap in ((8, 4096), (4, 8192)):
        half = cap // 2
        assert tsf.line_smem_bytes(half, 1, item, 3) <= tsf.LINE_SMEM_LIMIT
        assert tsf.line_smem_bytes(cap, 1, item, 3) > tsf.LINE_SMEM_LIMIT


@pytest.mark.parametrize("dirs", [2, 6])
@pytest.mark.parametrize("b", [1, 9, 256])
def test_tangent_plan_at_the_product_ski_cell(dirs, b):
    """B11 at the N-D cell (134 x 70 cells, L = 512 x 256): three launches
    whatever the directions, one scratch of dirs ceil(b / 2) m1 m2 complex
    values (1.5 MB at m = 2, b = 9, where the whole-plane passes took two
    of 21 MB), rows of three buffers that fit a block."""
    P = (b + 1) // 2
    for item in (8, 4):
        plan = tsf.gram_2d_plan((134, 70), (512, 256), b, item, None, dirs)
        assert plan.launches == 3 and not plan.per_direction
        assert plan.scratch == (dirs * P * 134 * 70, 0)
        tpl, lpb = plan.rows
        assert tpl * lpb <= 1024
        assert tsf.line_smem_bytes(256, lpb, item, 3) <= \
            tsf.LINE_SMEM_TARGET
        assert plan.cols == tsf.gram_2d_plan((134, 70), (512, 256), b,
                                             item).cols
    if (dirs, b) == (2, 9):
        plan = tsf.gram_2d_plan((134, 70), (512, 256), b, 8, None, dirs)
        assert 16 * sum(plan.scratch) == 1_500_800


def test_tangent_plan_beyond_the_cap_runs_the_gram_per_direction():
    """Beyond the line cap (an axis, or a row line of three buffers too
    long for a block) B11 runs B10's gram once per direction: B10's
    launches times the directions, B10's scratch (reused by each
    direction)."""
    for shape, Ls, item, cap in (((2106, 9), (8192, 32), 8, None),
                                 ((46, 30), (128, 64), 8, 64),
                                 ((46, 30), (128, 64), 8, 32),
                                 ((46, 1200), (128, 4096), 8, None)):
        gram = tsf.gram_2d_plan(shape, Ls, 9, item, cap)
        for dirs in (2, 6):
            plan = tsf.gram_2d_plan(shape, Ls, 9, item, cap, dirs)
            assert plan.per_direction
            assert plan.launches == dirs * gram.launches
            assert (plan.cap, plan.rows, plan.cols, plan.scratch) == \
                (gram.cap, gram.rows, gram.cols, gram.scratch)
    # the 4096-point rows: the line kernels per direction, two buffers
    assert tsf.gram_2d_plan((46, 1200), (128, 4096), 9, 8, None,
                            2).launches == 2 * 3
    # float32 holds the 8192-point column and three 32-point row buffers
    plan = tsf.gram_2d_plan((2106, 9), (8192, 32), 9, 4, None, 2)
    assert plan.launches == 3 and not plan.per_direction
    assert plan.scratch == (2 * 5 * 2106 * 9, 0)
    # one direction is B10's plan
    assert tsf.gram_2d_plan((134, 70), (512, 256), 9, 8, None, 1) == \
        tsf.gram_2d_plan((134, 70), (512, 256), 9, 8)
