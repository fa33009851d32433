"""The stochastic backend, module by module, against the JAX package: the
batch/rank/epoch policy, the pivoted-Cholesky factor and its Woodbury
apply, the column oracles, the plain versions of the row-slab kernels
B12/B13, and the EigenPro solver itself (solve, log-det, gradient terms)
in its fixed, adaptive and heavy-ball loops.

Every input is made from a numpy seed and handed to both packages; the JAX
side runs under one ``jax.jit`` with its Pallas kernels in interpret mode,
as its own tests run them.  The solver runs under the random seam of
``test_torch_session.py`` (the port replays the JAX package's probes and
epoch permutations).  Tolerances: the policy is equal; the factor, the
Woodbury apply and the row slabs 1e-12 relative (max-abs error over
max-abs value); the solver's answers 1e-9 relative, because the reference
sums in another order (its row-slab kernel over 256-column tiles, its
scatter-adds under XLA) and the epochs compound those last-bit
differences; the epoch counts are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import iterative as jit_
from repro.core import stochastic as jst
from repro.kernels import operators as jopers
from repro.kernels import ops as jops
import repro_torch.random as rnd
from repro_torch.core import engine as teng
from repro_torch.core import iterative as tit
from repro_torch.core import stochastic as tst
from repro_torch.kernels import kernel_matvec as tkm
from repro_torch.kernels import operators as topers
from repro_torch.kernels import ops as tops

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


TOL = 1e-12
SOLVER_TOL = 1e-9
SEED = 11
THETAS = {"se": [np.log(0.9)], "k1": [np.log(40.0), np.log(3.1), 0.1],
          "matern32": [np.log(1.7)],
          "se*matern32": [np.log(1.3), np.log(0.7)]}


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _x(kind, n, seed=SEED):
    """Scattered inputs: sorted uniform times on [0, 40] (1-D kinds) or
    uniform (n, 2) points in [0, 6] x [0, 4] (composite kinds)."""
    rng = np.random.default_rng(seed)
    if "*" in kind:
        return rng.uniform([0.0, 0.0], [6.0, 4.0], (n, 2))
    return np.sort(rng.uniform(0.0, 40.0, n))


def _y(x, seed=SEED):
    rng = np.random.default_rng(seed + 1)
    t = x if x.ndim == 1 else x[:, 0] + 0.5 * x[:, 1]
    return np.sin(2.1 * t) + 0.3 * np.sin(0.37 * t) \
        + 0.1 * rng.standard_normal(x.shape[0])


# ---------------------------------------------------------------------------
# resolve_stochastic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    {}, {"mem_budget_mb": 1}, {"mem_budget_mb": 64, "cg_tol": 0.2},
    {"batch_size": 37}, {"n_epochs": 3, "nystrom_rank": 9},
    {"nystrom_rank": 500, "mem_budget_mb": 2}])
def test_resolve_stochastic_gives_the_reference_plans(opts):
    for n in (1, 7, 100, 1000, 65536, 1 << 20):
        for noise2 in (1.0, 1e-2, 1e-4, 1e-6):
            want = jst.resolve_stochastic(jeng.SolverOpts(**opts), n, noise2)
            got = tst.resolve_stochastic(teng.SolverOpts(**opts), n, noise2)
            assert tuple(got) == tuple(want), (n, noise2, opts)
            assert tit.resolve_rank(noise2, n) == jit_.resolve_rank(noise2,
                                                                    n)


# ---------------------------------------------------------------------------
# The pivoted-Cholesky factor, its Woodbury apply, the column oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["se", "k1", "se*matern32"])
def test_pivoted_cholesky_and_woodbury_match_the_reference(kind):
    n, rank, noise2 = 300, 24, 0.01 + 1e-8
    x = _x(kind, n)
    th = np.asarray(THETAS[kind])
    r = np.random.default_rng(3).standard_normal((n, 3))
    jp = jopers.PallasTileOperator(kind, jnp.asarray(x), 0.1, 1e-8)
    tp = topers.PallasTileOperator(kind, _t(x), 0.1, 1e-8)

    @jax.jit
    def ref(th, r):
        diag = jp.diag(th)
        L = jit_.pivoted_cholesky(diag, lambda i: jp.matcol(th, i), rank)
        Lm = jit_._woodbury_factor(L, noise2)
        return (diag, jp.matcol(th, 17), L,
                jit_._woodbury_apply(L, Lm, noise2)(r))

    diag, col, L, wood = (np.asarray(a) for a in ref(jnp.asarray(th),
                                                     jnp.asarray(r)))
    tth = _t(th)
    assert _rel(tp.diag(tth).numpy(), diag) < TOL
    assert _rel(tp.matcol(tth, 17).numpy(), col) < TOL
    assert _rel(tp.matcol(tth, torch.tensor(17)).numpy(), col) < TOL
    tL = tit.pivoted_cholesky(tp.diag(tth), lambda i: tp.matcol(tth, i),
                              rank)
    assert _rel(tL.numpy(), L) < TOL
    apply = tit._woodbury_apply(tL, tit._woodbury_factor(tL, noise2), noise2)
    assert _rel(apply(_t(r)).numpy(), wood) < TOL
    assert _rel(apply(_t(r[:, 0])).numpy(), wood[:, 0]) < TOL


def test_toeplitz_column_oracles_match_the_reference():
    x = np.arange(200.0) * 0.25
    th = np.asarray(THETAS["matern32"])
    jp = jopers.select_operator("matern32", x, 0.1, 1e-8)
    tp = topers.select_operator("matern32", _t(x), 0.1, 1e-8)
    assert (jp.name, tp.name) == ("toeplitz", "toeplitz")
    diag, col = (np.asarray(a) for a in jax.jit(
        lambda th: (jp.diag(th), jp.matcol(th, 33)))(jnp.asarray(th)))
    assert _rel(tp.diag(_t(th)).numpy(), diag) < TOL
    assert _rel(tp.matcol(_t(th), 33).numpy(), col) < TOL


# ---------------------------------------------------------------------------
# Row slabs: B12 / B13 plain versions against matvec_rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,b,n2,k", [("se", 37, 300, 3),
                                         ("k1", 8, 257, 1),
                                         ("matern32", 100, 513, 9),
                                         ("se*matern32", 45, 301, 2)])
def test_row_slab_plain_versions_match_matvec_rows(kind, b, n2, k):
    x = _x(kind, n2)
    th = np.asarray(THETAS[kind])
    rows = np.random.default_rng(5).permutation(n2)[:b]
    v = np.random.default_rng(6).standard_normal((n2, k))
    want, want1 = (np.asarray(a) for a in jax.jit(
        lambda th, xb, x, v: (jops.matvec_rows(kind, th, xb, x, v),
                              jops.matvec_rows(kind, th, xb, x, v[:, 0])))(
        jnp.asarray(th), jnp.asarray(x[rows]), jnp.asarray(x),
        jnp.asarray(v)))
    tth, tx = _t(th), _t(x)
    got = tops.matvec_rows(kind, tth, tx[rows], tx, _t(v))
    assert got.shape == (b, k)
    assert _rel(got.numpy(), want) < TOL
    assert _rel(tops.matvec_rows(kind, tth, tx[rows], tx,
                                 _t(v[:, 0])).numpy(), want1) < TOL
    kinds = tops.split_kind(kind)
    if len(kinds) > 1:
        p = tops.natural_params_nd(kind, tth)
        plain = tkm.tile_matvec_nd_plain(kinds, p, tx[rows], tx, _t(v),
                                         row_chunk=16)
    else:
        p = tops.natural_params(kind, tth)
        plain = tkm.tile_matvec_plain(kind, p, tx[rows], tx, _t(v),
                                      row_chunk=16)
    assert _rel(plain.numpy(), want) < TOL


@pytest.mark.parametrize("b,n2", [(2048, 65536), (1000, 65537), (8, 65536),
                                  (2048, 1000), (33, 64), (1, 1)])
@pytest.mark.parametrize("sms", [132, 7])
def test_row_segments_cover_the_columns(b, n2, sms):
    """The split grid: whole column tiles per segment, segments covering
    n2 exactly, at most 65,535 of them, and the block target met where
    the columns allow it."""
    segs, seg_cols = tkm.row_segments(b, n2, sms)
    tiles = -(-n2 // tkm.SWEEP_COLS)
    stripes = -(-b // tkm.SWEEP_ROWS)
    assert seg_cols % tkm.SWEEP_COLS == 0
    assert (segs - 1) * seg_cols < n2 <= segs * seg_cols
    assert 1 <= segs <= min(tiles, tkm.MAX_GRID_Y)
    target = tkm.ROWS_BLOCKS_PER_SM * sms
    assert stripes * segs >= min(target, stripes * tiles) // 2


# ---------------------------------------------------------------------------
# StochasticSolver
# ---------------------------------------------------------------------------

SOLVER_CASES = {
    # loop: (kind, n, sigma_n, SolverOpts fields)
    "adaptive": ("se", 512, 0.1, dict(n_probes=4)),
    "fixed": ("se", 512, 0.1, dict(n_probes=4, n_epochs=3)),
    "momentum_adaptive": ("se", 512, 0.1, dict(n_probes=4, momentum=0.5)),
    "momentum_fixed": ("se", 512, 0.1, dict(n_probes=4, n_epochs=2,
                                             momentum=0.3)),
    # a rank that captures y's smooth part but not the Rademacher
    # columns: the warm start is kept on y and dropped on the probes
    "warm_dropped": ("se", 400, 0.1, dict(n_probes=4, n_epochs=2,
                                           nystrom_rank=48)),
    "composite": ("se*matern32", 400, 0.1, dict(n_probes=4, batch_size=48)),
}


def _reference_solver(kind, x, y, sigma_n, th, opts, seed):
    """The JAX solver's answers under one jit: alpha, K^-1 z, the guard's
    dropped columns, ln det, the gradient terms and the epochs of the
    [y | z] solve."""

    @jax.jit
    def run(th):
        s = jst.StochasticSolver(kind, th, x, y, sigma_n,
                                 jax.random.key(seed), opts=opts)
        rhs = jnp.concatenate([s.y[:, None], s.z], axis=1)
        r0 = s._full_matvec(s._warm(rhs)) - rhs
        worse = (jnp.linalg.norm(r0, axis=0)
                 >= jnp.maximum(jnp.linalg.norm(rhs, axis=0), 1e-30))
        quad, tr = s.grad_terms()
        return (s.alpha, s.Kinv_z, worse, s.logdet(), quad, tr,
                s.last_epochs, s.lam)

    return [np.asarray(a) for a in run(jnp.asarray(th))]


@pytest.mark.parametrize("case", list(SOLVER_CASES))
def test_stochastic_solver_matches_the_reference(case, jax_random):
    kind, n, sigma_n, fields = SOLVER_CASES[case]
    x = _x(kind, n)
    y = _y(x)
    th = np.asarray(THETAS[kind])
    (alpha, kinv_z, worse, logdet, quad, tr, epochs,
     lam) = _reference_solver(kind, jnp.asarray(x), jnp.asarray(y), sigma_n,
                              th, jeng.SolverOpts(**fields), SEED)
    tst.reset_epoch_counts()
    s = teng.make_solver("stochastic", kind, _t(th), _t(x), _t(y), sigma_n,
                         key=rnd.key(SEED),
                         opts=teng.SolverOpts(**fields))
    assert isinstance(s, tst.StochasticSolver)
    tquad, ttr = s.grad_terms()
    assert s.last_epochs == int(epochs)
    assert sum(tst.EPOCH_COUNTS.values()) == 1
    assert _rel(s.lam.numpy(), lam) < TOL
    assert _rel(s.alpha.numpy(), alpha) < SOLVER_TOL
    assert _rel(s.Kinv_z.numpy(), kinv_z) < SOLVER_TOL
    assert abs(float(s.logdet()) - float(logdet)) <= 1e-12 * abs(
        float(logdet))
    assert _rel(tquad.numpy(), quad) < SOLVER_TOL
    assert _rel(ttr.numpy(), tr) < SOLVER_TOL
    if case == "warm_dropped":
        assert not worse[0] and worse[1:].all()
    if case.endswith("fixed"):
        assert s.last_epochs == fields["n_epochs"]


def test_stochastic_solve_and_objective_match_the_reference(jax_random):
    """A second solve after [y | z] (a right-hand side of its own) and the
    value and gradient of ln P_max through the engine, default policy."""
    kind, n, sigma_n = "se", 400, 0.1
    x = _x(kind, n, seed=2)
    y = _y(x, seed=2)
    th = np.asarray(THETAS[kind])
    rhs = np.random.default_rng(9).standard_normal((n, 2))
    opts = dict(n_probes=4)

    @jax.jit
    def ref(th, rhs):
        s = jeng.make_solver("stochastic", "se", th, jnp.asarray(x),
                             jnp.asarray(y), sigma_n,
                             key=jax.random.key(SEED),
                             opts=jeng.SolverOpts(**opts))
        return (jeng.profiled_loglik(s), jeng.profiled_grad(s),
                s.solve(rhs), s.solve(rhs[:, 0]))

    lp, g, sol, sol1 = (np.asarray(a) for a in ref(jnp.asarray(th),
                                                   jnp.asarray(rhs)))
    s = teng.make_solver("stochastic", "se", _t(th), _t(x), _t(y), sigma_n,
                         key=rnd.key(SEED), opts=teng.SolverOpts(**opts))
    assert abs(float(teng.profiled_loglik(s)) - float(lp)) \
        <= SOLVER_TOL * abs(float(lp))
    assert _rel(teng.profiled_grad(s).numpy(), g) < SOLVER_TOL
    assert _rel(s.solve(_t(rhs)).numpy(), sol) < SOLVER_TOL
    assert _rel(s.solve(_t(rhs[:, 0])).numpy(), sol1) < SOLVER_TOL
    assert teng.select_stochastic(s.op, teng.SolverOpts(**opts)) == s.plan
    # the probes= argument stands in for the key's Rademacher block
    s2 = teng.make_solver("stochastic", "se", _t(th), _t(x), _t(y), sigma_n,
                          key=rnd.key(SEED), opts=teng.SolverOpts(**opts),
                          probes=s.z.clone())
    assert torch.equal(teng.profiled_grad(s2), teng.profiled_grad(s))
