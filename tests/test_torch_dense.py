"""The dense slice, module by module, against the JAX package: the
covariance library's dense forms, ``build_K``, the hyperlikelihood's value,
gradient and Hessian (eqs. 2.5, 2.7, 2.9, 2.16, 2.17, 2.19), ``evidence_full``,
the dense prediction and draws, the dense solver and scan, and the flat-box
helpers.

Every input is made from a numpy seed and handed to both packages at
n = 40; each JAX reference runs under one ``jax.jit`` (eager JAX spends
seconds per nested jvp).  Tolerances, relative to the largest magnitude of
the quantity (max-abs error over max-abs value): covariances and values
1e-12 (the same formulas; the Cholesky of a K with condition ~1e3 in
another LAPACK moves ln det K at ~1e-14 relative); gradients and Hessians
1e-9 (sums of n^2 products of K^-1 with condition ~1e3 and dK, taken in
another order by torch's einsum; the largest difference measured is
4e-12); posterior draws 1e-8 (the factor of the predictive covariance,
whose condition reaches 1e8 with its 1e-8 jitter).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import covariances as jcov
from repro.core import hyperlik as jhl
from repro.core import laplace as jlap
from repro.core import predict as jpred
from repro.core import reparam as jrep
from repro.core.reparam import FlatBox as JFlatBox
from repro.data import synthetic as jsyn
from repro.data import tidal as jtidal
import repro_torch.random as rnd
from repro_torch.core import covariances as tcov
from repro_torch.core import engine as teng
from repro_torch.core import hyperlik as thl
from repro_torch.core import laplace as tlap
from repro_torch.core import predict as tpred
from repro_torch.core import reparam as trep
from repro_torch.core import train as ttrain
from repro_torch.core.reparam import FlatBox
from repro_torch.data import synthetic as tsyn
from repro_torch.data import tidal as ttidal

from test_torch_session import _jax_key, jax_random  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run several pytest workers on one machine; torch's CPU
    thread pool in each of them oversubscribes the cores (tens of times
    slower), so each module runs torch on one thread and restores it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N = 40
SIGMA_N = 0.1
VALUE_TOL = 1e-12
DERIV_TOL = 1e-9
DRAW_TOL = 1e-8


def _kinds():
    """name -> (JAX covariance, port covariance, theta, input dim)."""
    out = {}
    plain = {"k1": [2.5, 1.2, 0.1], "k2": [2.5, 1.2, 0.1, 2.0, -0.1],
             "se": [0.9], "matern12": [0.9], "matern32": [0.9],
             "matern52": [0.9], "rq": [0.9, 0.3], "periodic": [1.2, 0.1]}
    for name, th in plain.items():
        out[name] = (jcov.resolve(name), tcov.resolve(name), th, 1)
    out["se*periodic"] = (jcov.product("se*periodic", jcov.SE, jcov.PERIODIC),
                          tcov.product("se*periodic", tcov.SE,
                                       tcov.PERIODIC), [1.5, 1.2, 0.1], 1)
    out["mixture"] = (jcov.mixture("mix", jcov.SE, jcov.MATERN32),
                      tcov.mixture("mix", tcov.SE, tcov.MATERN32),
                      [0.3, 0.9, -0.4], 1)
    out["se*matern32"] = (jcov.resolve("se*matern32"),
                          tcov.resolve("se*matern32"), [0.4, -0.2], 2)
    out["se_isotropic_2d"] = (jcov.SE, tcov.SE, [0.3], 2)
    return out


KINDS = _kinds()


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _data(d=1, seed=0, n=N):
    rng = np.random.default_rng(seed)
    if d == 1:
        x = np.sort(rng.uniform(0.0, 60.0, n))
        xs = np.sort(rng.uniform(0.0, 60.0, 9))
        y = np.sin(x / 3.0) + 0.1 * rng.standard_normal(n)
    else:
        x = rng.uniform(0.0, 3.0, (n, d))
        xs = rng.uniform(0.0, 3.0, (9, d))
        y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    return x, y, xs


@pytest.mark.parametrize("name", list(KINDS))
def test_dense_forms_and_profiled_hyperlikelihood(name):
    """build_K, the cross covariance, ln P_max (eq. 2.16), its gradient
    (eq. 2.17) and its Hessian (eq. 2.19) for every registered kind, the
    product, the mixture (its w coordinate), a separable product and an
    isotropic kind on (n, 2) inputs."""
    jc, tc, theta, d = KINDS[name]
    x, y, xs = _data(d)

    @jax.jit
    def ref(th):
        K = jcov.build_K(jc, th, x, SIGMA_N)
        val, cache = jhl.profiled_loglik(jc, th, x, y, SIGMA_N)
        return (K, jc(th, x, xs), val,
                jhl.profiled_grad(jc, th, x, y, SIGMA_N, cache),
                jhl.profiled_hessian(jc, th, x, y, SIGMA_N, cache),
                jhl.sigma_f_hat(cache))

    K, Ks, val, g, H, sf = (np.asarray(a) for a in ref(jnp.asarray(theta)))
    th, xt, yt = _t(theta), _t(x), _t(y)
    assert _rel(tcov.build_K(tc, th, xt, SIGMA_N), K) < VALUE_TOL
    assert _rel(tc(th, xt, _t(xs)), Ks) < VALUE_TOL
    tval, cache = thl.profiled_loglik(tc, th, xt, yt, SIGMA_N)
    assert abs(float(tval) - float(val)) < VALUE_TOL * abs(float(val))
    assert abs(float(thl.sigma_f_hat(cache)) - float(sf)) \
        < VALUE_TOL * float(sf)
    tg = thl.profiled_grad(tc, th, xt, yt, SIGMA_N, cache)
    assert tg.shape == (tc.n_params,) and _rel(tg, g) < DERIV_TOL
    tH = thl.profiled_hessian(tc, th, xt, yt, SIGMA_N, cache)
    assert torch.equal(tH, tH.T) and _rel(tH, H) < DERIV_TOL
    # the dense engine serves the same quantities
    s = teng.make_solver("dense", tc, th, xt, yt, SIGMA_N)
    assert s.backend == "dense" and isinstance(s, teng.DenseCholeskySolver)
    assert float(teng.profiled_loglik(s)) == float(tval)
    assert _rel(teng.profiled_grad(s), g) < DERIV_TOL


def test_full_hyperlikelihood_and_evidence_full():
    """ln P with sigma_f = 1 (eq. 2.5), its gradient (eq. 2.7), the scaled
    form (eq. 2.14), and evidence_full: the Laplace evidence with
    ln sigma_f a flat coordinate, through eq. (2.9) of the scaled
    covariance."""
    x, y, _ = _data(seed=1)
    theta = [2.89, 0.48, 0.33]     # near the k1 peak of this record
    box = ([1.0, 0.0, -0.5, -2.0], [4.0, 2.0, 0.5, 2.0])

    @jax.jit
    def ref(th, lsf):
        val, cache = jhl.loglik(jcov.K1, th, x, y, SIGMA_N)
        g = jhl.loglik_grad(jcov.K1, th, x, y, SIGMA_N, cache)
        scaled, _ = jhl.loglik_scaled(jcov.K1, th, lsf, x, y, SIGMA_N)
        ev = jlap.evidence_full(jcov.K1, th, lsf, x, y, SIGMA_N,
                                JFlatBox(jnp.asarray(box[0]),
                                         jnp.asarray(box[1])))
        return val, g, scaled, ev

    th = _t(theta)
    xt, yt = _t(x), _t(y)
    _, cache = thl.profiled_loglik(tcov.K1, th, xt, yt, SIGMA_N)
    lsf = float(torch.log(thl.sigma_f_hat(cache)))
    val, g, scaled, ev = ref(jnp.asarray(theta), lsf)
    tval, tcache = thl.loglik(tcov.K1, th, xt, yt, SIGMA_N)
    assert abs(float(tval) - float(val)) < VALUE_TOL * abs(float(val))
    assert _rel(thl.loglik_grad(tcov.K1, th, xt, yt, SIGMA_N, tcache),
                g) < DERIV_TOL
    tscaled, _ = thl.loglik_scaled(tcov.K1, th, lsf, xt, yt, SIGMA_N)
    assert abs(float(tscaled) - float(scaled)) \
        < VALUE_TOL * abs(float(scaled))
    tev = tlap.evidence_full(tcov.K1, th, lsf, xt, yt, SIGMA_N,
                             FlatBox(_t(box[0]), _t(box[1])))
    assert np.isfinite(float(ev.log_z))       # a positive-definite H here
    assert abs(float(tev.log_z) - float(ev.log_z)) \
        < DERIV_TOL * abs(float(ev.log_z))
    assert _rel(tev.hessian, ev.hessian) < DERIV_TOL
    assert _rel(tev.errors, ev.errors) < DERIV_TOL
    assert float(tev.log_volume) == pytest.approx(float(ev.log_volume),
                                                  rel=VALUE_TOL)
    assert _rel(tev.theta_hat, ev.theta_hat) < VALUE_TOL
    assert math.isnan(float(tev.sigma_f_hat))


@pytest.mark.parametrize("include_noise", [False, True])
def test_dense_predict_matches_jax(include_noise):
    """The dense posterior mean and variance (eq. 2.1, sigma_f profiled),
    the mean-only path, and the full predictive covariance."""
    x, y, xs = _data(seed=2)
    theta = [2.6, 1.25, 0.0, 2.2, 0.1]

    @jax.jit
    def ref(th):
        post = jpred._predict_impl(jcov.K2, th, x, y, xs, SIGMA_N,
                                   include_noise=include_noise)
        return (post.mean, post.var, post.sigma_f_hat) + \
            jpred.predict_full_cov(jcov.K2, th, x, y, xs, SIGMA_N)

    mean, var, sf, fmean, fcov = (np.asarray(a)
                                  for a in ref(jnp.asarray(theta)))
    th, xt, yt, xst = _t(theta), _t(x), _t(y), _t(xs)
    tpred.VAR_BEFORE_CLAMP_MIN[0] = math.nan
    post = tpred._predict_impl(tcov.K2, th, xt, yt, xst, SIGMA_N,
                               include_noise=include_noise)
    assert _rel(post.mean, mean) < VALUE_TOL * 100
    # var cancels terms of size sigma_f_hat^2: held against that scale
    assert np.max(np.abs(post.var.numpy() - var)) < DERIV_TOL * sf ** 2
    assert float(post.sigma_f_hat) == pytest.approx(float(sf),
                                                    rel=VALUE_TOL)
    assert math.isfinite(tpred.VAR_BEFORE_CLAMP_MIN[0])
    assert tpred.VAR_BEFORE_CLAMP_MIN[0] == pytest.approx(
        float(post.var.min()), abs=DERIV_TOL * sf ** 2)
    mean_only = tpred._predict_impl(tcov.K2, th, xt, yt, xst, SIGMA_N,
                                    compute_var=False)
    assert mean_only.var is None
    assert torch.equal(mean_only.mean, post.mean)
    tmean, tcov_ = tpred.predict_full_cov(tcov.K2, th, xt, yt, xst, SIGMA_N)
    assert _rel(tmean, fmean) < VALUE_TOL * 100
    assert np.max(np.abs(tcov_.numpy() - fcov)) < DERIV_TOL * sf ** 2


def test_draws_match_jax_under_the_random_seam(jax_random):
    """draw_prior (the synthetic data's draw) and draw_posterior (GP.sample)
    replay JAX's normal draws through the seam."""
    x, y, xs = _data(seed=3)
    theta = [2.6, 1.25, 0.0, 2.2, 0.1]
    key = rnd.fold_in(rnd.key(7), 3)
    jkey = _jax_key(key)

    @jax.jit
    def ref(th):
        return (jpred.draw_prior(jkey, jcov.K2, th, x, 1.3, SIGMA_N),
                jpred.draw_posterior(jkey, jcov.K2, th, x, y, xs, SIGMA_N,
                                     n_draws=3))

    prior, post = (np.asarray(a) for a in ref(jnp.asarray(theta)))
    th, xt = _t(theta), _t(x)
    tprior = tpred.draw_prior(key, tcov.K2, th, xt, 1.3, SIGMA_N)
    assert _rel(tprior, prior) < DRAW_TOL
    tpost = tpred.draw_posterior(key, tcov.K2, th, xt, _t(y), _t(xs),
                                 SIGMA_N, n_draws=3)
    assert tpost.shape == (3, 9) and _rel(tpost, post) < DRAW_TOL


def test_failed_cholesky_gives_nan_not_an_exception():
    """A K that is not positive definite in floating point gives a nan
    value, as jnp.linalg.cholesky does (torch.linalg.cholesky would
    raise), so the trainer's line search reads +inf and backtracks; in the
    batched scan only the failing point is nan."""
    x, y, _ = _data(seed=4)
    xt, yt = _t(x), _t(y)
    bad = [math.log(1e4)]                  # K ~ all ones; negative jitter
    jval = jax.jit(lambda t: jhl.profiled_loglik(jcov.SE, t, x, y, 0.0,
                                                 -1e-6)[0])(jnp.asarray(bad))
    assert math.isnan(float(jval))
    val, cache = thl.profiled_loglik(tcov.SE, _t(bad), xt, yt, 0.0, -1e-6)
    assert math.isnan(float(val)) and torch.isnan(cache.L).all()
    vals = thl.profiled_loglik_batch(tcov.SE, _t([[-3.0], bad[:1], [-2.5]]),
                                     xt, yt, 0.0, -1e-6)
    assert torch.isnan(vals[1]) and torch.isfinite(vals[[0, 2]]).all()
    box = FlatBox(_t([-1.0]), _t([12.0]))
    _, value = ttrain.make_objective(tcov.SE, xt, yt, 0.0, box, -1e-6)
    assert math.isnan(float(value(trep.from_box(_t(bad), box))))
    assert ttrain._nan_to_inf(value(trep.from_box(_t(bad), box))) \
        == math.inf


def test_dense_scan_chunks_match_single_points(monkeypatch):
    """The trainer's scan: chunks of batched factorisations (here 3 K's a
    chunk, a ragged last chunk) give each point's own ln P_max."""
    monkeypatch.setitem(thl.SCAN_CHUNK_BYTES, "cpu", 3 * N * N * 8)
    x, y, _ = _data(seed=5)
    xt, yt = _t(x), _t(y)
    rng = np.random.default_rng(5)
    thetas = _t(np.column_stack([rng.uniform(1.5, 3.5, 8),
                                 rng.uniform(0.8, 1.5, 8),
                                 rng.uniform(-0.4, 0.4, 8)]))
    got = thl.profiled_loglik_batch(tcov.K1, thetas, xt, yt, SIGMA_N)
    want = torch.stack([thl.profiled_loglik(tcov.K1, t, xt, yt, SIGMA_N)[0]
                        for t in thetas])
    assert _rel(got, want) < VALUE_TOL
    jwant = jax.jit(jax.vmap(lambda t: jhl.profiled_loglik(
        jcov.K1, t, x, y, SIGMA_N)[0]))(jnp.asarray(thetas.numpy()))
    assert _rel(got, jwant) < VALUE_TOL


def test_in_box_and_ordering_ok_match_jax():
    rng = np.random.default_rng(6)
    box = ([1.0, 0.5, -0.5, 0.5, -0.5], [4.0, 3.0, 0.5, 3.0, 0.5])
    jbox = JFlatBox(jnp.asarray(box[0]), jnp.asarray(box[1]))
    tbox = FlatBox(_t(box[0]), _t(box[1]))
    thetas = rng.uniform(-0.6, 4.2, (40, 5))
    thetas[0] = box[0]                       # the edges are inside
    thetas[1] = box[1]
    want_box, want_order = (np.asarray(a) for a in jax.jit(jax.vmap(
        lambda th: (jrep.in_box(jbox, th), jrep.ordering_ok(jcov.K2, th))))(
            jnp.asarray(thetas)))
    assert want_box[:2].all() and not want_box.all()
    assert want_order.any() and not want_order.all()
    assert trep.in_box(tbox, _t(thetas)).tolist() == want_box.tolist()
    assert trep.ordering_ok(tcov.K2, _t(thetas)).tolist() \
        == want_order.tolist()
    for th, b, o in zip(thetas, want_box, want_order):
        assert bool(trep.in_box(tbox, _t(th))) == b
        assert bool(trep.ordering_ok(tcov.K2, _t(th))) == o
        assert bool(trep.ordering_ok(tcov.K1, _t(th[:3])))


def test_data_records_match_jax(jax_random, tmp_path):
    """The port's data modules draw the JAX package's records under the
    seam: irregular sampling with its k1 draw, a gappy tide record, and a
    NOAA CSV read the same way."""
    key = rnd.key(3)
    jx, jy = jax.jit(lambda k: jsyn.irregular(k, 30, which="k1")[:2])(
        _jax_key(key))
    t = tsyn.irregular(key, 30, which="k1", device="cpu")
    assert _rel(t.x, jx) < VALUE_TOL and _rel(t.y, jy) < VALUE_TOL
    assert t.sigma_n == jsyn.SIGMA_N
    jx, jy = jax.jit(lambda k: jtidal.woods_hole_like(k, months=1)[:2])(
        jax.random.key(2))
    jw = jtidal.drop_random_hours(jtidal.Dataset(jx, jy, 0.01), 0.2,
                                  _jax_key(rnd.key(9)))
    tw = ttidal.drop_random_hours(ttidal.woods_hole_like(
        rnd.key(2), months=1, device="cpu"), 0.2, rnd.key(9))
    assert tw.x.shape == jw.x.shape and tw.x.shape[0] < 328
    assert _rel(tw.x, jw.x) == 0.0 and _rel(tw.y, jw.y) < VALUE_TOL
    path = tmp_path / "noaa.csv"
    path.write_text("Date Time, Water Level, Sigma\n"
                    "2016-01-01 00:00,1.250,0.01\n"
                    "2016-01-01 01:00,1.312,0.01\n"
                    "2016-01-01 02:00, ,0.01\n"
                    "2016-01-01 03:00,1.101,0.01\n")
    jn, tn = jtidal.load_noaa_csv(str(path)), ttidal.load_noaa_csv(
        str(path), device="cpu")
    assert tn.x.tolist() == [0.0, 1.0, 3.0] == np.asarray(jn.x).tolist()
    assert _rel(tn.y, jn.y) == 0.0 and tn.sigma_n == jn.sigma_n
