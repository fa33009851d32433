"""The near-grid slice's modules against the JAX package on the same numpy
inputs: grid helpers, the Toeplitz and SKI operators (B5/B6 through their
plain versions), the SKI cross covariance, and the circulant
preconditioners with preconditioned SLQ.  The slice as a whole is in
``test_torch_ski_workflow.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import covariances as jcov
from repro.core import engine as jeng
from repro.core import iterative as jit_
from repro.core.engine import SolverOpts as JSolverOpts
from repro.data import grid as jgrid
from repro.kernels import operators as jopers
import repro_torch.random as rnd
from repro_torch.core import engine as teng
from repro_torch.core import iterative as tit
from repro_torch.core.covariances import resolve
from repro_torch.data import grid as tgrid
from repro_torch.kernels import operators as topers
from repro_torch.kernels import ski_fused as tsf

from test_torch_session import jax_random  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run several pytest workers on one machine; torch's CPU
    thread pool in each of them oversubscribes the cores (tens of times
    slower), so each module runs torch on one thread and restores it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SIGMA_N = 0.1
JITTER = 1e-8
H = 2.0                       # the two-hour tidal cadence
THETAS = {
    "k1": [np.log(60.0), np.log(12.4), 0.1],
    "k2": [np.log(80.0), np.log(12.4), 0.05, np.log(24.0), -0.1],
    "se": [np.log(8.0)],
    "matern12": [np.log(8.0)],
    "matern32": [np.log(8.0)],
    "matern52": [np.log(8.0)],
}


def _t(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _gappy(n_full=700, drop=0.1, seed=0):
    """A two-hour record with outages: near-grid, W a selection matrix."""
    rng = np.random.default_rng(seed)
    x = H * np.arange(n_full, dtype=np.float64)
    return x[rng.uniform(size=n_full) >= drop]


def _jittered(n_full=700, seed=1):
    """Late timestamps by up to 2% of a cell: near-grid with cubic W rows;
    on the grid of spacing H from the first point, each point keeps its own
    cell (the least-squares spacing of classify_grid drifts with the mean
    lateness, so the SKI tests pass spacing=H)."""
    late = np.random.default_rng(seed).uniform(0.0, 0.02, n_full)
    late[0] = 0.0                 # the grid starts at the first point
    return H * (np.arange(n_full) + late)


def _scattered(n=500, seed=2):
    return np.sort(np.random.default_rng(seed).uniform(0.0, 1000.0, n))


SAMPLINGS = {"gappy": _gappy, "jittered": _jittered}


# ---------------------------------------------------------------------------
# Grid helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["gappy", "jittered", "scattered"])
@pytest.mark.parametrize("order", ["cubic", "linear"])
def test_grid_helpers_match_jax(case, order):
    x = {"gappy": _gappy, "jittered": _jittered,
         "scattered": _scattered}[case]()
    assert tgrid.classify_grid(x) == jgrid.classify_grid(x)
    jg = jgrid.build_inducing_grid(x)
    tg = tgrid.build_inducing_grid(x)
    np.testing.assert_array_equal(tg, jg)
    assert tgrid.is_regular_grid(tg) and jgrid.is_regular_grid(jg)
    assert tgrid.is_regular_grid(x) == jgrid.is_regular_grid(x) is False
    ji, jw = jgrid.interp_weights(x, jg, order=order)
    ti, tw = tgrid.interp_weights(_t(x), tg, order=order)
    np.testing.assert_array_equal(ti, ji)
    assert ti.dtype == np.int32
    assert np.max(np.abs(tw - jw)) <= 1e-15
    if case == "gappy":           # the one-hot snap: an exact selection
        assert set(np.unique(tw)) <= {0.0, 1.0}
    with pytest.raises(ValueError, match="stencil"):
        tgrid.interp_weights(np.array([x[0] - 10 * H]), tg, order=order)


# ---------------------------------------------------------------------------
# Toeplitz
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(THETAS))
def test_toeplitz_operator_matches_jax(kind):
    x = H * np.arange(300, dtype=np.float64)
    theta = np.asarray(THETAS[kind])
    v = np.random.default_rng(3).standard_normal((300, 3))
    jop = jopers.select_operator(kind, jnp.asarray(x), SIGMA_N, JITTER)
    top = topers.select_operator(kind, _t(x), SIGMA_N, JITTER)
    assert jop.name == top.name == "toeplitz"
    jt, tt = jnp.asarray(theta), _t(theta)
    assert _rel(top.matvec(tt, _t(v)).numpy(), jop.matvec(jt, v)) < 1e-12
    assert _rel(top.gram_matvec(tt, _t(v)).numpy(),
                jop.gram_matvec(jt, v)) < 1e-12
    assert _rel(top.bound_gram_matvec(tt, torch.float64)(_t(v)).numpy(),
                jop.bound_gram_matvec(jt, jnp.float64)(v)) < 1e-12
    got = top.tangent_matvecs(tt, _t(v)).numpy()
    want = np.asarray(jop.tangent_matvecs(jt, v))
    assert got.shape == want.shape == (len(theta), 300, 3)
    for i in range(len(theta)):        # each direction on its own scale
        assert _rel(got[i], want[i]) < 1e-12
    assert top.tangent_matvecs(tt, _t(v[:, 0])).shape == (len(theta), 300)


# ---------------------------------------------------------------------------
# SKI and the B5 / B6 plain versions
# ---------------------------------------------------------------------------

def _ski_pair(x, kind="k2", jax_fused=False):
    jop = jopers.SKIOperator(kind, jnp.asarray(x), SIGMA_N, JITTER,
                             spacing=H, fused=jax_fused)
    top = topers.SKIOperator(kind, _t(x), SIGMA_N, JITTER, spacing=H)
    assert jop.name == top.name == "ski"
    assert top.fused and top.fused_geom is not None
    return jop, top


@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
@pytest.mark.parametrize("b", [1, 3, 8, 9])
def test_fused_plain_versions_match_unfused_jax(sampling, b):
    """B5 (bound gram) and B6 (stacked tangents) through their plain
    versions against the JAX package's unfused composition."""
    x = SAMPLINGS[sampling]()
    jop, top = _ski_pair(x)
    assert not jop.fused
    theta = np.asarray(THETAS["k2"])
    v = np.random.default_rng(b).standard_normal((x.shape[0], b))
    jt, tt = jnp.asarray(theta), _t(theta)
    got = top.bound_gram_matvec(tt, torch.float64)(_t(v)).numpy()
    assert _rel(got, jop.bound_gram_matvec(jt, jnp.float64)(v)) < 1e-12
    assert _rel(top.gram_matvec(tt, _t(v)).numpy(),
                jop.gram_matvec(jt, v)) < 1e-12
    got = top.tangent_matvecs(tt, _t(v)).numpy()
    want = np.asarray(jop.tangent_matvecs(jt, v))
    for i in range(len(theta)):
        assert _rel(got[i], want[i]) < 1e-12


def test_fused_plain_versions_match_the_jax_kernel_in_interpret_mode():
    """Against the JAX package's fused Pallas kernels (interpret mode on
    the CPU), at the tolerance of its own fused-vs-unfused tests."""
    x = _gappy(1200)
    jop, top = _ski_pair(x, jax_fused=True)
    assert jop.fused
    theta = np.asarray(THETAS["k2"])
    v = np.random.default_rng(4).standard_normal((x.shape[0], 9))
    jt, tt = jnp.asarray(theta), _t(theta)
    got = top.bound_gram_matvec(tt, torch.float64)(_t(v)).numpy()
    assert _rel(got, jop.bound_gram_matvec(jt, jnp.float64)(v)) < 1e-9
    got = top.tangent_matvecs(tt, _t(v)).numpy()
    want = np.asarray(jop.tangent_matvecs(jt, v))
    for i in range(len(theta)):
        assert _rel(got[i], want[i]) < 1e-9


@pytest.mark.parametrize("kind", ["k1", "k2", "matern32"])
def test_gappy_ski_is_the_dense_covariance(kind):
    """W is a selection matrix on a gappy record, so the SKI gram matvec
    is the dense K of the JAX package's build_K."""
    x = _gappy(500)
    theta = np.asarray(THETAS[kind])
    top = topers.select_operator(kind, _t(x), SIGMA_N, JITTER)
    assert top.name == "ski" and top._sel_cells is not None
    K = np.asarray(jcov.build_K(jcov.resolve(kind), jnp.asarray(theta),
                                jnp.asarray(x), SIGMA_N, JITTER))
    v = np.random.default_rng(5).standard_normal((x.shape[0], 4))
    assert _rel(top.gram_matvec(_t(theta), _t(v)).numpy(), K @ v) < 1e-9


def test_fused_geometry_and_its_resolution():
    x = _gappy(300)
    top = topers.select_operator("k1", _t(x), SIGMA_N, JITTER, fused=False)
    assert top.name == "ski" and not top.fused
    geom = top.fused_geom
    assert geom.L >= 2 * geom.m_grid - 1 and geom.L & (geom.L - 1) == 0
    assert geom.offs == (-1, 0, 1, 2)
    empty = geom.occ == geom.n
    assert empty.sum() == geom.m_grid - geom.n
    # scattered data under operator="ski": shared cells, no geometry
    s = topers.select_operator("k1", _t(_scattered(300)), SIGMA_N, JITTER,
                               operator="ski")
    assert s.fused_geom is None and not s.fused
    with pytest.raises(ValueError, match="fused=True"):
        topers.select_operator("k1", _t(_scattered(300)), SIGMA_N, JITTER,
                               operator="ski", fused=True)
    with pytest.raises(ValueError, match="unknown fused mode"):
        tsf.resolve_fused("yes", geom)
    assert tsf.resolve_fused("auto", geom) and tsf.resolve_fused(True, geom)
    with pytest.raises(ValueError, match="contiguous"):
        v = torch.zeros((geom.n, 4), dtype=torch.float64)
        tsf.fused_gram_matvec(geom, torch.zeros(geom.L, dtype=torch.float64),
                              0.0, v[:, ::2])


# ---------------------------------------------------------------------------
# SKI cross covariance (predict)
# ---------------------------------------------------------------------------

def test_cross_interp_matches_jax():
    x = _gappy(600)
    jop, top = _ski_pair(x)
    rng = np.random.default_rng(6)
    xs = np.sort(np.concatenate([rng.uniform(x[0], x[-1], 40),
                                 x[rng.integers(0, x.shape[0], 10)]]))
    theta = np.asarray(THETAS["k2"])
    jstar = jop.cross_interp(jnp.asarray(xs))
    tstar = top.cross_interp(_t(xs))
    np.testing.assert_array_equal(tstar[0].numpy(), np.asarray(jstar[0]))
    np.testing.assert_array_equal(tstar[1].numpy(), np.asarray(jstar[1]))
    v = rng.standard_normal(x.shape[0])
    jt, tt = jnp.asarray(theta), _t(theta)
    assert _rel(top.cross_matvec(tt, tstar, _t(v)).numpy(),
                jop.cross_matvec(jt, jstar, jnp.asarray(v))) < 1e-12
    assert _rel(top.cross_columns(tt, tstar).numpy(),
                jop.cross_columns(jt, jstar)) < 1e-12
    assert top.cross_interp(_t(np.array([x[-1] + 50 * H]))) is None


# ---------------------------------------------------------------------------
# Preconditioners
# ---------------------------------------------------------------------------

def _three_operators():
    return {"toeplitz": H * np.arange(400, dtype=np.float64),
            "ski": _gappy(450), "pallas": _scattered(300)}


@pytest.mark.parametrize("name", ["toeplitz", "ski", "pallas"])
def test_circulant_preconditioners_match_jax(name):
    x = _three_operators()[name]
    theta = np.asarray(THETAS["k1"])
    jop = jopers.select_operator("k1", jnp.asarray(x), SIGMA_N, JITTER)
    top = topers.select_operator("k1", _t(x), SIGMA_N, JITTER)
    assert jop.name == top.name == name
    R = np.random.default_rng(7).standard_normal((x.shape[0], 3))
    jt, tt = jnp.asarray(theta), _t(theta)
    assert _rel(top.circulant_precond(tt)(_t(R)).numpy(),
                jop.circulant_precond(jt)(jnp.asarray(R))) < 1e-10
    if name == "pallas":
        assert not hasattr(top, "slq_precond")
        return
    jslq, tslq = jop.slq_precond(jt), top.slq_precond(tt)
    assert abs(float(tslq.logdet) - float(jslq.logdet)) \
        < 1e-10 * abs(float(jslq.logdet))
    assert _rel(tslq.apply_inv(_t(R)).numpy(),
                jslq.apply_inv(jnp.asarray(R))) < 1e-10
    if name == "ski":
        assert int(top.m_grid - top.n) > 0     # the g x g correction ran


def test_masked_circulant_refusals_match_jax():
    lam = np.linspace(1.0, 2.0, 16)
    occ = np.arange(0, 16, 2)
    assert topers.masked_circulant_slq_precond(_t(lam), occ,
                                               max_miss=4) is None
    assert topers.masked_circulant_slq_precond(
        _t(lam), np.array([1, 1, 2])) is None
    # no missing cell: P is the circulant itself
    full = topers.masked_circulant_slq_precond(_t(lam), np.arange(16))
    jfull = jopers.masked_circulant_slq_precond(jnp.asarray(lam),
                                                np.arange(16))
    assert abs(float(full.logdet) - float(jfull.logdet)) < 1e-12
    R = np.random.default_rng(8).standard_normal((16, 2))
    assert _rel(full.apply_inv(_t(R)).numpy(),
                jfull.apply_inv(jnp.asarray(R))) < 1e-12


def test_preconditioned_slq_matches_jax_with_the_same_probes(jax_random):
    """slq_logdet_precond on the gappy SKI operator, the port's N(0, P)
    probes replayed with jax.random."""
    x = _gappy(600)
    jop, top = _ski_pair(x)
    theta = np.asarray(THETAS["k2"])
    jt, tt = jnp.asarray(theta), _t(theta)
    jl = jit_.slq_logdet_precond(jop.bound_gram_matvec(jt, jnp.float64),
                                 jop.slq_precond(jt), jax.random.key(7),
                                 n_probes=6, k=20)
    tl = tit.slq_logdet_precond(top.bound_gram_matvec(tt, torch.float64),
                                top.slq_precond(tt), rnd.key(7),
                                n_probes=6, k=20)
    assert abs(float(tl) - float(jl)) < 1e-8 * abs(float(jl))


def test_preconditioner_selection_matches_jax():
    x = _gappy(600)
    theta = np.asarray(THETAS["se"])
    jop = jopers.select_operator("se", jnp.asarray(x), SIGMA_N, JITTER)
    top = topers.select_operator("se", _t(x), SIGMA_N, JITTER)
    for choice, rank in ((None, 0), (None, 16), ("pivchol", 0),
                         ("circulant", 0), ("auto", 0)):
        assert tit.resolve_precond(choice, top, rank) \
            == jit_.resolve_precond(choice, jop, rank)
    assert tit.make_preconditioner(top, _t(theta)) is None
    assert tit.make_preconditioner(top, _t(theta), None, 0) is None
    pc = tit.make_preconditioner(top, _t(theta), "circulant")
    assert pc.choice == "circulant" and pc.slq is not None
    with pytest.raises(ValueError):
        tit.make_preconditioner(top, _t(theta), "strang")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tit.make_preconditioner(top, _t(theta), "pivchol")
    s = teng.make_solver("iterative", resolve("se"), _t(theta), _t(x),
                         _t(np.sin(x)), SIGMA_N, key=rnd.key(0),
                         opts=teng.SolverOpts(precond="circulant"))
    assert s._precond is not None and s.op.name == "ski"
    # "auto" turns it on at n >= 2048 and n / noise2 >= 1e6, as in JAX
    xb = _gappy(2600)
    jb = jopers.select_operator("se", jnp.asarray(xb), 0.01, JITTER)
    tb = topers.select_operator("se", _t(xb), 0.01, JITTER)
    assert tit.resolve_precond("auto", tb) == jit_.resolve_precond(
        "auto", jb) == "circulant"
    assert teng.select_precond(tb, teng.SolverOpts(precond="auto")) \
        == jeng.select_precond(jb, JSolverOpts(precond="auto"))
    assert teng.select_fused(tb) and not jeng.select_fused(
        jopers.select_operator("se", jnp.asarray(x), SIGMA_N, JITTER))
