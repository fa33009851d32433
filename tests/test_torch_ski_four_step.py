"""B5's, B6's and B7's order of work on the CPU: the 1-D SKI gram and
stacked tangents as the card's kernels compute them
(csrc/ski_lines_1d.cuh) and the host-side plan that sizes their launches
and scratch.

``ski_fused.fused_sandwich_four_step`` packs two real columns of one
member into one complex line and convolves it in four steps over a split
L = L1 L2 (the columns over n2 with the twiddle w_L^{n1 k2}, the rows over
n1 with lam at k2 + L2 k1 and back, the columns back, cropped to m).  It is held to 1e-12 relative (max-abs
error over max-abs value) against the plain versions the card holds B5 and
B7 against (``fused_gram_matvec_plain``, ``fused_bank_matvec_plain``), and
to 1e-9 against the JAX package's fused kernels (Pallas, interpret mode)
on the same record, the tolerance of ``test_torch_ski.py`` and
``test_torch_bank.py`` there.  ``gram_1d_plan`` is held to the split,
launches and one scratch buffer the kernels were designed to.

``ski_fused.fused_tangent_four_step`` is B6's order: W^T and the forward
transforms once, then each direction's spectrum and its inverse
transforms; held to 1e-12 against ``fused_tangent_matvecs_plain`` and to
1e-9 against JAX's ``fused_tangent_matvecs`` (interpret mode), and its
plan (three buffers a row line with several directions, one scratch of
m_dirs lines) to what the kernels take."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.gp import batch as jbatch
from repro.kernels import operators as jopers
from repro_torch.gp import batch as tbatch
from repro_torch.kernels import operators as topers
from repro_torch.kernels import ski_fused as tsf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per pytest worker (several share the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-12
SIGMA_N, JITTER = 0.1, 1e-8
H = 2.0                       # the two-hour tidal cadence
THETAS = {
    "k1": [np.log(60.0), np.log(12.4), 0.1],
    "k2": [np.log(80.0), np.log(12.4), 0.05, np.log(24.0), -0.1],
    "se": [np.log(8.0)],
}
KINDS = ("k1", "k2", "se")    # a bank of B = 3 mixed families


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _gappy(n_full=700, drop=0.1, seed=0):
    """A two-hour record with outages: near-grid, W a selection matrix."""
    rng = np.random.default_rng(seed)
    x = H * np.arange(n_full, dtype=np.float64)
    return x[rng.uniform(size=n_full) >= drop]


def _ski(x, kind="k2"):
    op = topers.SKIOperator(kind, _t(x), SIGMA_N, JITTER, spacing=H)
    assert op.fused
    lam = tsf.spectrum(op._toep.first_column(_t(THETAS[kind]),
                                             torch.float64), op.fused_geom)
    return op, lam


def _bank_spectra(op):
    """(B, L) spectra of KINDS on op's grid."""
    return torch.stack([tsf.spectrum(topers.ToeplitzOperator(
        k, op.grid).first_column(_t(THETAS[k])), op.fused_geom)
        for k in KINDS])


# L = 2048: the plan's own split (32 x 64), two others, and L1 = 1 (one
# line of L points, step 2 a multiply by the spectrum)
SPLITS = [None, (64, 32), (16, 128), (1, 2048)]


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("b", [1, 8, 9])
def test_four_step_twin_matches_the_gram_plain_version(b, split):
    """B5's order against ``fused_gram_matvec_plain`` on a record with
    m = 606 cells at L = 2048, on the plan's split and three others."""
    op, lam = _ski(_gappy(601))
    geom = op.fused_geom
    assert geom.L == 2048
    v = _t(np.random.default_rng(b).standard_normal((geom.n, b)))
    got = tsf.fused_sandwich_four_step(geom, lam, op.noise2, v, split)
    want = tsf.fused_gram_matvec_plain(geom, lam, op.noise2, v)
    assert got.shape == (geom.n, b)
    assert _rel(got.numpy(), want.numpy()) < TOL


def test_four_step_twin_at_the_tightest_embedding():
    """m = 1024 cells at L = 2048 (2 m - 1 = L - 1, the tightest the
    port's L rule gives): step 1's nonzero cells fill the lower half of
    every column, step 3 keeps exactly that half."""
    op, lam = _ski(_gappy(1018, seed=1))
    geom = op.fused_geom
    assert geom.L == 2048 and geom.m_grid == geom.L // 2
    v = _t(np.random.default_rng(3).standard_normal((geom.n, 3)))
    want = tsf.fused_gram_matvec_plain(geom, lam, op.noise2, v)
    for split in SPLITS:
        got = tsf.fused_sandwich_four_step(geom, lam, op.noise2, v, split)
        assert _rel(got.numpy(), want.numpy()) < TOL, split


@pytest.mark.parametrize("split", [None, (64, 32), (1, 2048)])
@pytest.mark.parametrize("c", [1, 3])
def test_four_step_twin_matches_the_bank_plain_version(c, split):
    """B7's order on a bank of B = 3 members (k1, k2, se) at odd c (a zero
    half per member) against ``fused_bank_matvec_plain``; at B = 1 it is
    B5's order on the same inputs."""
    op, _ = _ski(_gappy(601))
    geom = op.fused_geom
    lams = _bank_spectra(op)
    V = _t(np.random.default_rng(c).standard_normal((geom.n, 3, c)))
    got = tsf.fused_sandwich_four_step(geom, lams, op.noise2, V, split)
    want = tsf.fused_bank_matvec_plain(geom, lams, op.noise2, V)
    assert got.shape == V.shape
    assert _rel(got.numpy(), want.numpy()) < TOL
    one = tsf.fused_sandwich_four_step(geom, lams[:1], op.noise2,
                                       V[:, :1].contiguous(), split)
    b5 = tsf.fused_sandwich_four_step(geom, lams[0], op.noise2,
                                      V[:, 0].contiguous(), split)
    assert _rel(one[:, 0].numpy(), b5.numpy()) < TOL


@pytest.fixture(scope="module")
def jax_kernels():
    """JAX's fused gram and bank kernels (Pallas, interpret mode) on a
    gappy record of n = 1087 (m = 1206, L = 4096), computed once: B5 at
    b = 9 and B7 on k1, k2, se at c = 3, with their inputs."""
    x = _gappy(1200)
    jop = jopers.SKIOperator("k2", jnp.asarray(x), SIGMA_N, JITTER,
                             spacing=H, fused=True)
    jb = jbatch.BankOperator(KINDS, jnp.asarray(x), SIGMA_N, JITTER,
                             fused=True)
    assert jop.fused and jb.fused
    rng = np.random.default_rng(11)
    v = rng.standard_normal((x.size, 9))
    gram = jax.jit(jop.bound_gram_matvec(jnp.asarray(THETAS["k2"]),
                                         jnp.float64))(jnp.asarray(v))
    th = np.zeros((3, 5))
    for q, k in enumerate(KINDS):
        th[q, :len(THETAS[k])] = THETAS[k]
    V = rng.standard_normal((x.size, 3, 3))
    bank = jax.jit(jb.bind_matvec(jnp.asarray(th), jnp.float64))(
        jnp.asarray(V))
    return x, v, np.asarray(gram), th, V, np.asarray(bank)


@pytest.mark.parametrize("split", [None, (32, 128), (128, 32)])
def test_four_step_twin_matches_the_jax_kernels(jax_kernels, split):
    """The twin against JAX's fused gram and bank kernels on the same
    inputs, on the plan's split of L = 4096 (64 x 64) and two others
    (JAX's bank pairs columns across members at odd c; the function is the
    same)."""
    x, v, gram, th, V, bank = jax_kernels
    op, lam = _ski(x)
    assert op.fused_geom.L == 4096
    got = tsf.fused_sandwich_four_step(op.fused_geom, lam, op.noise2, _t(v),
                                       split)
    assert _rel(got.numpy(), gram) < 1e-9
    tb = tbatch.BankOperator(KINDS, _t(x), SIGMA_N, JITTER)
    assert tb.fused and tb.fused_geom.L == 4096
    lams = tsf.spectrum(tb.first_columns(_t(th), torch.float64),
                        tb.fused_geom)
    got = tsf.fused_sandwich_four_step(tb.fused_geom, lams, tb.noise2,
                                       _t(V), split)
    assert _rel(got.numpy(), bank) < 1e-9


@pytest.mark.parametrize("b", [1, 8, 9, 256])
def test_plan_at_the_ski_cell(b):
    """The SKI cell's L = 16384 in float64 (line cap 4096): four steps of
    128 x 128, 4 launches (the global passes took 16) and one buffer of
    ceil(b / 2) L complex values (two before)."""
    P = (b + 1) // 2
    plan = tsf.gram_1d_plan(16384, P, 8)
    assert plan.cap == 4096
    assert plan.split == (128, 128) and plan.launches == 4
    assert plan.scratch == P * 16384
    assert plan.cols == (32, 8) and plan.rows == (32, 8)


def test_plan_splits():
    """Four steps at every L, also where one line would fit the cap
    (4096 in float64, 8192 in float32): L2 = min(cap, 2^ceil(log2 L / 2)),
    L1 = L / L2; a bank of B = 20 members of c = 9 (100 lines); a split
    given; the limit cap^2 and splits out of range."""
    for L, item, split in ((2, 8, (1, 2)), (4, 8, (2, 2)),
                           (2048, 8, (32, 64)), (4096, 8, (64, 64)),
                           (8192, 4, (64, 128)), (8192, 8, (64, 128)),
                           (16384, 4, (128, 128))):
        plan = tsf.gram_1d_plan(L, 5, item)
        assert plan.split == split and plan.launches == 4
        assert plan.scratch == 5 * L and plan.cap == tsf.line_cap(item)
    plan = tsf.gram_1d_plan(16384, 20 * 5, 8)
    assert plan.scratch == 100 * 16384 and plan.launches == 4
    plan = tsf.gram_1d_plan(2048, 5, 8, (64, 32))
    assert plan.split == (64, 32) and plan.launches == 4
    assert plan.cols == tsf.line_kernel_plan(32, 64, 8)
    assert plan.rows == tsf.line_kernel_plan(64, 32, 8)
    assert tsf.gram_1d_plan(2048, 5, 8, (1, 2048)).split == (1, 2048)
    assert tsf.gram_1d_plan(1 << 24, 5, 8).split == (4096, 4096)
    with pytest.raises(ValueError, match="four-step limit"):
        tsf.gram_1d_plan(1 << 25, 5, 8)
    for L, split in ((2048, (32, 32)), (2048, (2048, 1)),
                     (16384, (8192, 2))):
        with pytest.raises(ValueError, match="is not L1 x L2"):
            tsf.gram_1d_plan(L, 5, 8, split)


@pytest.mark.parametrize("item", [8, 4])
def test_plans_fit_a_block(item):
    """Every plan's line kernels fit a block, and steps 1-3 hold whole
    groups of lines (lpb divides the lines of one packed column)."""
    cap = tsf.line_cap(item)
    for lg in range(1, 2 * cap.bit_length() - 1):
        L = 1 << lg
        for lines in (1, 5, 100):
            plan = tsf.gram_1d_plan(L, lines, item)
            L1, L2 = plan.split
            assert L1 * L2 == L and L1 <= cap and 2 <= L2 <= cap
            assert L1 % plan.cols[1] == 0 and L2 % plan.rows[1] == 0
            for length, (tpl, lpb) in ((L2, plan.cols), (L1, plan.rows)):
                assert 1 <= tpl and tpl * lpb <= 1024
                assert tsf.line_smem_bytes(length, lpb, item) <= \
                    tsf.LINE_SMEM_LIMIT


# ---------------------------------------------------------------------------
# B6: the stacked tangents, W^T and the forward transforms once
# ---------------------------------------------------------------------------

def _tangent_spectra(op, kind):
    """(m_dirs, L) tangent spectra of ``kind`` on op's grid (3 for k1, 5
    for k2)."""
    grid = topers.ToeplitzOperator(kind, op.grid)
    return tsf.spectrum(grid.first_column_jacobian(_t(THETAS[kind])),
                        op.fused_geom)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("b", [1, 8, 9])
@pytest.mark.parametrize("kind", ["k1", "k2"])
def test_tangent_four_step_twin_matches_the_plain_version(kind, b, split):
    """B6's order against ``fused_tangent_matvecs_plain`` on a record with
    m = 606 cells at L = 2048, on the plan's split and three others (L1 =
    1: step 2 multiplies each direction's spectrum alone)."""
    op, _ = _ski(_gappy(601), kind)
    geom = op.fused_geom
    lams = _tangent_spectra(op, kind)
    v = _t(np.random.default_rng(b).standard_normal((geom.n, b)))
    got = tsf.fused_tangent_four_step(geom, lams, v, split)
    want = tsf.fused_tangent_matvecs_plain(geom, lams, v)
    assert got.shape == (lams.shape[0], geom.n, b)
    assert _rel(got.numpy(), want.numpy()) < TOL


@pytest.fixture(scope="module")
def jax_tangents():
    """JAX's fused tangent kernel (Pallas, interpret mode) on the gappy
    record of :func:`jax_kernels` (n = 1087, L = 4096) for k1 and k2 at
    b = 8 and 9, computed once, with the inputs."""
    x = _gappy(1200)
    rng = np.random.default_rng(13)
    out = {}
    for kind in ("k1", "k2"):
        jop = jopers.SKIOperator(kind, jnp.asarray(x), SIGMA_N, JITTER,
                                 spacing=H, fused=True)
        assert jop.fused
        f = jax.jit(jop.tangent_matvecs)
        for b in (8, 9):
            v = rng.standard_normal((x.size, b))
            out[kind, b] = (v, np.asarray(f(jnp.asarray(THETAS[kind]),
                                            jnp.asarray(v))))
    return x, out


@pytest.mark.parametrize("split", [None, (32, 128), (1, 4096)])
@pytest.mark.parametrize("b", [8, 9])
@pytest.mark.parametrize("kind", ["k1", "k2"])
def test_tangent_four_step_twin_matches_the_jax_kernel(jax_tangents, kind,
                                                       b, split):
    """B6's order against JAX's fused tangents on the same inputs, on the
    plan's split of L = 4096 (64 x 64) and two others (JAX packs
    directions and columns jointly at odd b; the function is the same)."""
    x, out = jax_tangents
    v, want = out[kind, b]
    op, _ = _ski(x, kind)
    assert op.fused_geom.L == 4096
    got = tsf.fused_tangent_four_step(op.fused_geom,
                                      _tangent_spectra(op, kind), _t(v),
                                      split)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < 1e-9


@pytest.mark.parametrize("dirs", [3, 5])
def test_plan_with_directions_at_the_ski_cell(dirs):
    """B6 at the SKI cell (L = 16384, b = 9: 5 packed columns) in float64:
    B5's split and steps 1 and 3, step 2 with three buffers a line (the
    forward line kept beside the inverse's two), 4 launches whatever the
    directions (the global passes took 16) and one buffer of every
    direction's lines."""
    plan = tsf.gram_1d_plan(16384, 5, 8, None, dirs)
    gram = tsf.gram_1d_plan(16384, 5, 8)
    assert plan.split == gram.split == (128, 128)
    assert plan.launches == 4 and plan.cols == gram.cols
    assert plan.rows == tsf.line_kernel_plan(128, 128, 8, 3)
    assert plan.scratch == dirs * 5 * 16384
    tpl, lpb = plan.rows
    assert tsf.line_smem_bytes(128, lpb, 8, 3) <= tsf.LINE_SMEM_TARGET


@pytest.mark.parametrize("item", [8, 4])
def test_plans_with_directions_fit_a_block(item):
    """With several directions every plan's step-2 block holds three
    buffers a line within a block's shared memory, and a row line that
    cannot (L1 > 2048 in float64, 4096 in float32) is refused, default
    split or given."""
    cap = tsf.line_cap(item)
    row_cap = cap // 2
    for lg in range(1, 2 * cap.bit_length() - 1):
        L = 1 << lg
        L1 = L // min(cap, 1 << (L.bit_length() // 2))
        if L1 > row_cap:
            with pytest.raises(ValueError, match="do not fit a block"):
                tsf.gram_1d_plan(L, 5, item, None, 5)
            continue
        plan = tsf.gram_1d_plan(L, 5, item, None, 5)
        assert plan.split == tsf.gram_1d_plan(L, 5, item).split
        tpl, lpb = plan.rows
        assert 1 <= tpl and tpl * lpb <= 1024
        assert L // plan.split[1] % 1 == 0 and plan.split[1] % lpb == 0
        assert tsf.line_smem_bytes(plan.split[0], lpb, item, 3) <= \
            tsf.LINE_SMEM_LIMIT
        assert plan.scratch == 5 * 5 * L
    with pytest.raises(ValueError, match="do not fit a block"):
        tsf.gram_1d_plan(2 * row_cap * cap, 5, item, (2 * row_cap, cap), 3)
    assert tsf.gram_1d_plan(row_cap * cap, 5, item, (row_cap, cap),
                            3).split == (row_cap, cap)
