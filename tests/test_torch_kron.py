"""The N-D grid slice, module by module, against the JAX package: the
product-grid probe, the composite parameter maps, the plain versions of the
product-tile kernels B8/B9 and of the 2-D sandwich kernels B10/B11, the
Kronecker and product-SKI operators, the d-D masked-circulant
preconditioner, product-SKI cross covariances and the multi-axis bank.

Every input is made from a numpy seed and handed to both packages; the JAX
package's Pallas kernels run in interpret mode, as its own tests run them.
Operators and kernels are held to 1e-12 relative (max-abs error over
max-abs value)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import covariances as jcov
from repro.data import grid as jgrid
from repro.gp import batch as jbatch
from repro.kernels import operators as jopers
from repro.kernels import ops as jops
from repro_torch.data import grid as tgrid
from repro_torch.gp import batch as tbatch
from repro_torch.kernels import kernel_matvec as tkm
from repro_torch.kernels import operators as topers
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ski_fused as tsf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run several pytest workers on one machine; torch's CPU
    thread pool in each of them oversubscribes the cores (tens of times
    slower), so each module runs torch on one thread and restores it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-12
SIGMA, JITTER = 0.1, 1e-8
THETAS = {
    "se*matern32": [np.log(1.3), np.log(0.7)],
    "k2*se": [np.log(3.0), np.log(1.1), 0.1, np.log(1.9), -0.2,
              np.log(0.8)],
    "se*matern32*matern12": [np.log(1.6), np.log(0.9), np.log(0.5)],
    "k1*matern52": [np.log(2.5), np.log(0.9), 0.05, np.log(0.6)],
}


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _product_x(shape, hs=(0.5, 0.25, 0.4)):
    axes = [h * np.arange(m) for m, h in zip(shape, hs)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(
        -1, len(shape))


def _gappy_x(shape, drop=0.2, seed=1):
    X = _product_x(shape)
    keep = np.random.default_rng(seed).random(X.shape[0]) >= drop
    return X[keep]


def _scattered(n, d=2, seed=5):
    return np.random.default_rng(seed).uniform(0.0, 5.0, (n, d))


def _inputs():
    rng = np.random.default_rng(7)
    full = _product_x((8, 6))
    # each grid line moved by up to 2.5% of its spacing: "near" per axis
    j1 = 0.5 * np.arange(8) + 0.0125 * rng.uniform(-1, 1, 8)
    j2 = 0.25 * np.arange(6) + 0.00625 * rng.uniform(-1, 1, 6)
    jittered = np.stack(np.meshgrid(j1, j2, indexing="ij"), -1).reshape(-1,
                                                                         2)
    t1 = np.sort(rng.uniform(0, 10, 12))
    return {
        "kron": full,
        "kron_3d": _product_x((4, 3, 5)),
        "permuted": full[rng.permutation(full.shape[0])],
        "gappy": _gappy_x((8, 6)),
        "jittered": jittered,
        "scattered": _scattered(40),
        "one_irregular_axis": np.stack(np.meshgrid(
            t1, 0.3 * np.arange(10), indexing="ij"), -1).reshape(-1, 2),
        "diagonal": np.stack([np.arange(30.0), np.arange(30.0)], -1),
        "duplicates": np.concatenate([full, full[:3]]),
        "constant_axis": np.stack([np.arange(12.0), np.zeros(12)], -1),
    }


# ---------------------------------------------------------------------------
# data/grid.classify_grid_nd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(_inputs()))
def test_classify_grid_nd_matches_the_jax_package(name):
    x = _inputs()[name]
    want = jgrid.classify_grid_nd(x)
    got = tgrid.classify_grid_nd(x)
    assert got.kind == want.kind
    assert [a.kind for a in got.axes] == [a.kind for a in want.axes]
    for ga, wa in zip(got.axes, want.axes):
        assert (ga.h is None) == (wa.h is None)
        if wa.h is not None:
            assert abs(ga.h - wa.h) <= 1e-15 * abs(wa.h)
    assert got.shape == want.shape
    if want.grids is not None:
        for g, w in zip(got.grids, want.grids):
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("x", [np.arange(24.0), np.arange(24.0)[:, None]],
                         ids=["series", "column"])
def test_classify_grid_nd_layout_errors_match(x):
    with pytest.raises(ValueError) as want:
        jgrid.classify_grid_nd(x)
    with pytest.raises(ValueError) as got:
        tgrid.classify_grid_nd(x)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# kernels/ops: composite parameter maps, B8/B9 plain versions, B4 blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(THETAS))
def test_natural_params_and_tangents_nd_match_jacfwd(kind):
    th = np.asarray(THETAS[kind])
    np.testing.assert_allclose(
        tops.natural_params_nd(kind, _t(th)).numpy(),
        np.asarray(jops.natural_params_nd(kind, jnp.asarray(th))),
        rtol=1e-14, atol=0)
    got = tops.natural_tangents_nd(kind, _t(th)).numpy()
    want = np.asarray(jops.natural_tangents_nd(kind, jnp.asarray(th)))
    assert got.shape == want.shape
    assert _rel(got, want) < TOL
    assert [b.shape[0] for b in tops.theta_blocks(kind, _t(th))] == \
        [b.shape[0] for b in jops.theta_blocks(kind, jnp.asarray(th))]


@pytest.mark.parametrize("kind", sorted(THETAS))
def test_b8_b9_plain_match_the_jax_kernels_and_the_dense_k(kind):
    d = kind.count("*") + 1
    th = np.asarray(THETAS[kind])
    rng = np.random.default_rng(11)
    x1 = rng.uniform(0.0, 4.0, (45, d))
    x2 = rng.uniform(0.0, 4.0, (37, d))
    v = rng.standard_normal((37, 3))
    got = tops.matvec(kind, _t(th), _t(x1), _t(x2), _t(v)).numpy()
    want = np.asarray(jops.matvec(kind, jnp.asarray(th), x1, x2, v))
    K = np.asarray(jcov.resolve(kind).fn(jnp.asarray(th), x1, x2))
    assert _rel(got, want) < TOL
    assert _rel(got, K @ v) < TOL
    got_t = tops.matvec_tangents(kind, _t(th), _t(x1), _t(x2), _t(v))
    want_t = np.asarray(jops.matvec_tangents(kind, jnp.asarray(th), x1, x2,
                                             v))
    dK = np.asarray(jax.jacfwd(lambda t: jcov.resolve(kind).fn(t, x1, x2))(
        jnp.asarray(th)))
    assert _rel(got_t.numpy(), want_t) < TOL
    assert _rel(got_t.numpy(), np.einsum("ijm,jb->mib", dK, v)) < TOL
    blk = tops.matrix(kind, _t(th), _t(x1), _t(x2)).numpy()
    assert _rel(blk, np.asarray(jops.matrix(kind, jnp.asarray(th), x1,
                                            x2))) < TOL


def test_composite_fronts_refuse_the_wrong_coordinates():
    th = _t(THETAS["se*matern32"])
    x = _t(np.arange(6.0))
    with pytest.raises(ValueError, match=r"needs \(n, 2\)"):
        tops.matvec("se*matern32", th, x, x, x)
    with pytest.raises(ValueError, match="unknown kernel factor"):
        tops.split_kind("se*nope")
    p = tops.natural_params_nd("se*matern32", th)
    with pytest.raises(ValueError, match="pdots must be"):
        tkm.tile_stacked_tangent_matvec_nd(
            ("se", "matern32"), p, torch.zeros(11, 2, 8, dtype=p.dtype),
            _t(np.zeros((3, 2))), _t(np.zeros((3, 2))),
            _t(np.zeros((3, 1))))


# ---------------------------------------------------------------------------
# KroneckerOperator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,shape", [("se*matern32", (10, 7)),
                                        ("k2*se", (9, 6)),
                                        ("se*matern32*matern12", (5, 4, 3))])
def test_kronecker_operator_matches_the_jax_package(kind, shape):
    X = _product_x(shape)
    th = np.asarray(THETAS[kind])
    jk = jopers.select_operator(kind, X, SIGMA, JITTER)
    tk = topers.select_operator(kind, _t(X), SIGMA, JITTER)
    assert (jk.name, tk.name) == ("kron", "kron") and tk.shape == shape
    V = np.random.default_rng(3).standard_normal((X.shape[0], 3))

    @jax.jit
    def ref(th, V):
        pj = jk.slq_precond(th)
        return (jk.gram_matvec(th, V), jk.tangent_matvecs(th, V),
                pj.logdet, pj.apply_inv(V),
                jcov.resolve(kind).fn(th, X, X))

    gram, tan, logdet, inv, K = (np.asarray(a) for a in ref(
        jnp.asarray(th), jnp.asarray(V)))
    got = tk.bound_gram_matvec(_t(th), torch.float64)(_t(V)).numpy()
    assert _rel(got, gram) < TOL
    assert _rel(got, K @ V + tk.noise2 * V) < TOL
    assert _rel(tk.tangent_matvecs(_t(th), _t(V)).numpy(), tan) < TOL
    pt = tk.slq_precond(_t(th))
    assert abs(float(pt.logdet) - float(logdet)) < 1e-12 * abs(
        float(logdet))
    assert _rel(pt.apply_inv(_t(V)).numpy(), inv) < TOL


def test_kronecker_operator_errors_match():
    Xg = _gappy_x((12, 10))
    with pytest.raises(ValueError, match="ProductSKIOperator"):
        topers.KroneckerOperator("se*se", _t(Xg))
    Xk = _t(_product_x((12, 10)))
    with pytest.raises(ValueError, match=r"plain kind 'se' cannot cover"):
        topers.select_operator("se", Xk, SIGMA, JITTER)
    with pytest.raises(ValueError, match=r"\(n, d>=2\)"):
        topers.select_operator("se*se", _t(np.arange(24.0)), SIGMA, JITTER)
    with pytest.raises(ValueError, match="unknown kernel factor"):
        topers.select_operator("se*nope", Xk, SIGMA, JITTER)


# ---------------------------------------------------------------------------
# ProductSKIOperator, B10/B11 plain versions
# ---------------------------------------------------------------------------

def _dense_W(op):
    idx = op.idx.numpy()
    w = op.w.numpy()
    W = np.zeros((op.n, op.m_grid))
    np.add.at(W, (np.repeat(np.arange(op.n), idx.shape[1]), idx.ravel()),
              w.ravel())
    return W


@pytest.mark.parametrize("kind,case", [("se*matern32", "gappy"),
                                       ("k2*se", "gappy"),
                                       ("se*matern32", "jittered")])
def test_product_ski_matches_the_jax_package(kind, case):
    X = _inputs()[case] if case == "jittered" else _gappy_x((12, 9))
    th = np.asarray(THETAS[kind])
    jp = jopers.select_operator(kind, X, SIGMA, JITTER, fused=False)
    tp = topers.select_operator(kind, _t(X), SIGMA, JITTER)
    assert (jp.name, tp.name) == ("product_ski", "product_ski")
    assert tp.shape == jp.shape
    # jittered points can share a cell: no fused geometry, in JAX too
    assert tp.fused == (case == "gappy") == (jp.fused_geom is not None)
    assert (tp._sel_cells is None) == (case == "jittered")
    tu = topers.ProductSKIOperator(kind, _t(X), SIGMA, JITTER,
                                   spacings=tuple(
                                       a.h for a in tgrid.classify_grid_nd(
                                           X).axes), fused=False)
    V = np.random.default_rng(4).standard_normal((X.shape[0], 3))
    r = np.random.default_rng(5).standard_normal((X.shape[0], 2))
    G = _product_grid(tp)

    @jax.jit
    def ref(th, V, r):
        # the CG preconditioner with the operator's noise, from the
        # reference's own pieces (its circulant_precond omits the noise)
        pc = jopers.masked_circulant_slq_precond(
            jp._lam_with_noise(th, 1e-12), None)
        return (jp.gram_matvec(th, V), jp.tangent_matvecs(th, V),
                jp._W(pc.apply_inv(jp._Wt(r))),
                jcov.resolve(kind).fn(th, G, G))

    want, want_t, want_p, Kk = (np.asarray(a) for a in ref(
        jnp.asarray(th), jnp.asarray(V), jnp.asarray(r)))
    fused = tp.bound_gram_matvec(_t(th), torch.float64)(_t(V)).numpy()
    unfused = tu.bound_gram_matvec(_t(th), torch.float64)(_t(V)).numpy()
    assert _rel(fused, want) < TOL and _rel(unfused, want) < TOL
    # the dense W K_kron W^T of the same geometry
    W = _dense_W(tp)
    assert _rel(fused, W @ Kk @ W.T @ V + tp.noise2 * V) < TOL
    assert _rel(tp.tangent_matvecs(_t(th), _t(V)).numpy(), want_t) < TOL
    assert _rel(tu.tangent_matvecs(_t(th), _t(V)).numpy(), want_t) < TOL
    assert _rel(tp.circulant_precond(_t(th))(_t(r)).numpy(), want_p) < TOL


def test_product_ski_cg_preconditioner_adds_the_noise():
    """The one deliberate difference from the reference: its product-SKI
    CG preconditioner builds the Kronecker-Strang spectrum from the
    noise-free inner operator, so it equals the port's at zero noise
    whatever the operator's noise; the port's carries sigma_n^2 + jitter
    (ROADMAP.md, queue C)."""
    kind = "se*matern32"
    X = _gappy_x((12, 9))
    th = np.asarray(THETAS[kind])
    jp = jopers.select_operator(kind, X, SIGMA, JITTER, fused=False)
    spacings = tuple(a.h for a in tgrid.classify_grid_nd(X).axes)
    quiet = topers.ProductSKIOperator(kind, _t(X), 0.0, 0.0,
                                      spacings=spacings)
    noisy = topers.ProductSKIOperator(kind, _t(X), SIGMA, JITTER,
                                      spacings=spacings)
    r = np.random.default_rng(15).standard_normal((X.shape[0], 2))
    ref = np.asarray(jax.jit(lambda th, r: jp.circulant_precond(th)(r))(
        jnp.asarray(th), jnp.asarray(r)))
    assert _rel(quiet.circulant_precond(_t(th))(_t(r)).numpy(), ref) < TOL
    assert _rel(noisy.circulant_precond(_t(th))(_t(r)).numpy(), ref) > 1e-3


def _product_grid(op):
    return np.stack(np.meshgrid(*[g.numpy() for g in op.grids],
                                indexing="ij"), -1).reshape(-1, op.d)


def test_b10_b11_plain_versions_against_the_jax_kernels():
    """The plain B10/B11 against JAX's fused 2-D kernels (Pallas, interpret
    mode) on the same geometry."""
    kind = "se*matern32"
    X = _gappy_x((10, 8), drop=0.25, seed=3)
    th = np.asarray(THETAS[kind])
    jp = jopers.select_operator(kind, X, SIGMA, JITTER, fused=True)
    tp = topers.select_operator(kind, _t(X), SIGMA, JITTER)
    assert jp.fused and tp.fused
    V = np.random.default_rng(6).standard_normal((X.shape[0], 3))
    want, want_t = (np.asarray(a) for a in jax.jit(
        lambda th, V: (jp.gram_matvec(th, V), jp.tangent_matvecs(th, V)))(
            jnp.asarray(th), jnp.asarray(V)))
    geom = tp.fused_geom
    lams = tsf.spectrum_nd(tp._kron.first_columns(_t(th)), geom)
    got = tsf.fused_gram_matvec_nd(geom, lams, tp.noise2, _t(V)).numpy()
    assert _rel(got, want) < TOL
    pairs = tsf.tangent_spectra_nd(tp._kron, _t(th), geom, torch.float64)
    assert pairs[0].shape == (2, geom.Ls[0])
    got_t = tsf.fused_tangent_matvecs_nd(geom, pairs, _t(V)).numpy()
    assert _rel(got_t, want_t) < TOL


def test_fused_geometry_2d_refusals():
    """d != 2, or two points in one flat cell, have no fused geometry;
    fused=True then raises."""
    X3 = _product_x((4, 3, 5))[::2]
    op3 = topers.ProductSKIOperator("se*se*se", _t(X3), SIGMA, JITTER,
                                    spacings=(0.5, 0.25, 0.4))
    assert op3.fused_geom is None and not op3.fused
    Xs = _scattered(60)
    ski = topers.ProductSKIOperator("se*se", _t(Xs), SIGMA, JITTER,
                                    spacings=(0.5, 0.5))
    assert ski.fused_geom is None and not ski.fused
    with pytest.raises(ValueError, match="fused=True"):
        topers.ProductSKIOperator("se*se", _t(Xs), SIGMA, JITTER,
                                  spacings=(0.5, 0.5), fused=True)


def test_product_ski_3d_unfused_matches_the_jax_package():
    kind = "se*matern32*matern12"
    X = _gappy_x((5, 4, 4), drop=0.3, seed=2)
    th = np.asarray(THETAS[kind])
    jp = jopers.select_operator(kind, X, SIGMA, JITTER)
    tp = topers.select_operator(kind, _t(X), SIGMA, JITTER)
    assert tp.name == "product_ski" and not tp.fused
    V = np.random.default_rng(8).standard_normal((X.shape[0], 2))
    want, want_t = (np.asarray(a) for a in jax.jit(
        lambda th, V: (jp.gram_matvec(th, V), jp.tangent_matvecs(th, V)))(
            jnp.asarray(th), jnp.asarray(V)))
    assert _rel(tp.gram_matvec(_t(th), _t(V)).numpy(), want) < TOL
    assert _rel(tp.tangent_matvecs(_t(th), _t(V)).numpy(), want_t) < TOL


# ---------------------------------------------------------------------------
# the d-D masked-circulant SLQ preconditioner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(9, 7), (5, 4, 3)])
def test_masked_circulant_nd_logdet_and_solve_are_exact(shape):
    rng = np.random.default_rng(9)
    ts = [np.exp(-0.5 * (np.arange(m) / (0.4 * m)) ** 2) for m in shape]
    lam = topers._strang_outer([_t(t) for t in ts], 0.05, 1e-12)
    m = int(np.prod(shape))
    occ = np.sort(rng.choice(m, int(0.8 * m), replace=False))
    pc = topers.masked_circulant_slq_precond(lam, occ)
    # the dense M: the multi-level circulant of spectrum lam
    q = np.fft.ifftn(1.0 / lam.numpy()).real
    idx = np.array(np.unravel_index(np.arange(m), shape))
    diff = (idx[:, :, None] - idx[:, None, :]) % np.array(shape)[:, None,
                                                                 None]
    Minv = q[tuple(diff)]
    M = np.linalg.inv(Minv)
    P = M[np.ix_(occ, occ)]
    sign, want = np.linalg.slogdet(P)
    assert sign > 0
    assert abs(float(pc.logdet) - want) < 1e-10 * abs(want)
    r = rng.standard_normal((occ.size, 2))
    assert _rel(pc.apply_inv(_t(r)).numpy(), np.linalg.solve(P, r)) < 1e-10
    jpc = jopers.masked_circulant_slq_precond(jnp.asarray(lam.numpy()),
                                              occ)
    assert abs(float(pc.logdet) - float(jpc.logdet)) < 1e-12 * abs(want)


# ---------------------------------------------------------------------------
# product-SKI cross covariance (predict's cross="interp")
# ---------------------------------------------------------------------------

def test_product_ski_cross_covariance_matches_the_jax_package():
    kind = "se*matern32"
    X = _gappy_x((12, 9))
    th = np.asarray(THETAS[kind])
    jp = jopers.select_operator(kind, X, SIGMA, JITTER, fused=False)
    tp = topers.select_operator(kind, _t(X), SIGMA, JITTER)
    xs = np.random.default_rng(12).uniform([0.2, 0.1], [5.3, 1.9], (23, 2))
    js = jp.cross_interp(xs)
    ts = tp.cross_interp(_t(xs))
    np.testing.assert_array_equal(ts[0].numpy(), np.asarray(js[0]))
    np.testing.assert_allclose(ts[1].numpy(), np.asarray(js[1]), rtol=0,
                               atol=1e-15)
    a = np.random.default_rng(13).standard_normal(X.shape[0])
    want_m, want_c = (np.asarray(r) for r in jax.jit(
        lambda th, a: (jp.cross_matvec(th, js, a),
                       jp.cross_columns(th, js)))(jnp.asarray(th),
                                                  jnp.asarray(a)))
    assert _rel(tp.cross_matvec(_t(th), ts, _t(a)).numpy(), want_m) < TOL
    assert _rel(tp.cross_columns(_t(th), ts).numpy(), want_c) < TOL
    assert tp.cross_interp(_t(np.array([[-9.0, 0.5]]))) is None
    assert tp.cross_interp(_t(np.arange(3.0))) is None


# ---------------------------------------------------------------------------
# the multi-axis bank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["kron", "gappy"])
def test_multi_axis_bank_matches_the_jax_package(case):
    X = _product_x((8, 6)) if case == "kron" else _gappy_x((9, 7))
    kinds = ("se*matern32", "k2*se", "se*matern32")
    m_max = 6
    thetas = np.zeros((3, m_max))
    for i, k in enumerate(kinds):
        th = np.asarray(THETAS[k])
        thetas[i, :th.size] = th + 0.05 * i
    jb = jbatch.BankOperator(kinds, jnp.asarray(X), SIGMA, JITTER)
    tb = tbatch.BankOperator(kinds, _t(X), SIGMA, JITTER)
    assert tb.structure == jb.structure and tb.shape == jb.shape
    assert not tb.fused and tb.d == 2
    V = np.random.default_rng(14).standard_normal((X.shape[0], 3, 2))
    f64 = jnp.float64

    @jax.jit
    def ref(th, V):
        pj = jb.bind_slq_precond(th, f64)
        return (jb.bind_matvec(th, f64)(V),
                jb.bind_tangent_matvecs(th, f64)(V),
                jb.bind_precond(th, f64)(V), pj.logdet, pj.apply_inv(V))

    mv, tmv, pre, logdet, inv = (np.asarray(a) for a in ref(
        jnp.asarray(thetas), jnp.asarray(V)))
    tt = _t(thetas)
    assert _rel(tb.bind_matvec(tt, torch.float64)(_t(V)).numpy(), mv) < TOL
    assert _rel(tb.bind_tangent_matvecs(tt, torch.float64)(_t(V)).numpy(),
                tmv) < TOL
    assert _rel(tb.bind_precond(tt, torch.float64)(_t(V)).numpy(),
                pre) < TOL
    ps = tb.bind_slq_precond(tt, torch.float64)
    np.testing.assert_allclose(ps.logdet.numpy(), logdet, rtol=1e-12,
                               atol=0)
    assert _rel(ps.apply_inv(_t(V)).numpy(), inv) < TOL
    assert tb.resolve_precond(tbatch.SolverOpts(precond="circulant")) == \
        "circulant"
    with pytest.raises(ValueError, match="same coordinate axes"):
        tbatch.BankOperator(("se*se", "se"), _t(X), SIGMA, JITTER)
