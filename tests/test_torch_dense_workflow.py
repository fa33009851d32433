"""The dense slice as a whole against the JAX package: the paper's two
examples at n <= 2048, where ``backend="auto"`` binds the dense backend.

  * a quickstart twin under the random seam (``test_torch_session``'s
    ``jax_random``): ``synthetic(key 42, 100, "k2")`` drawn by both
    packages, the scan and restarts of each fit, predict and sample, then
    ``compare`` of k1 against k2 (per-model ln P_max, ln Z, ln B);
  * ``woods_hole_like`` at months = 1 (n = 328): the data, the scan and
    ``compare`` with k2 alone (the JAX reference's eager Laplace stage
    costs ~6 s per model and record here, the port's n = 328 fit ~8 s);
  * the stages on a carried JAX dense fit (``gp.convert``): the port's
    evidence, likelihood, prediction and draws on the JAX package's peaks.

The quickstart budget is 3 restarts x 10 NCG steps x 64 scan points.  At
30 steps the JAX package does not agree with itself there: a one-ulp
change of y moves an unconverged k2 restart by 1.1e-5 in ln P and k2's
ln Z by 1.4e-5 (k1's restart by 6.9e-5 in theta), so a comparison there
would test rounding; at 10 steps the same change moves ln P and ln Z by
at most 5e-10.  The tide record takes 1 x 30 x 128: with fewer steps its
k2 peak has no positive-definite Hessian (a nan ln Z), and at this budget
the same change moves ln P by 1e-9 and ln Z by 1.1e-9 (of ~174).

Tolerances: data 1e-12 (the same draws, one Cholesky of a K with
condition ~1e4); scan values 1e-10 relative to the largest |ln P| of the
scan (K's condition reaches ~1e8 at sigma_n = 0.01, and two LAPACKs put
ln det K ~1e-9 apart at ln P ~ -700); restart peaks 1e-8 in theta and
ln P (relative), ln Z and ln B 1e-8 relative; error bars 1e-6 relative
after a fit (the inverse of a Hessian whose smallest eigenvalue is ~0.05
of its largest ~2e3) and 1e-8 at the JAX peaks; posterior mean 1e-8
relative, variance 1e-8 of sigma_f_hat^2; draws 1e-6 relative (the
factor of a predictive covariance with condition up to 1e8).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import gp as jgp
from repro.core import laplace as jlap
from repro.core import reparam as jrep
from repro.core import train as jtrain
from repro.data.synthetic import synthetic as jsynthetic
from repro.data.tidal import woods_hole_like as jwoods
import repro_torch.random as rnd
from repro_torch import gp as tgp
from repro_torch.core import hyperlik as thl
from repro_torch.core import reparam as trep
from repro_torch.data.synthetic import synthetic as tsynthetic
from repro_torch.data.tidal import woods_hole_like as twoods
from repro_torch.gp.convert import session_from_state

from test_torch_session import _jax_key, _state, jax_random  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run several pytest workers on one machine; torch's CPU
    thread pool in each of them oversubscribes the cores (tens of times
    slower), so each module runs torch on one thread and restores it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FIT_TOL = 1e-8
ERR_TOL = 1e-6
DRAW_TOL = 1e-6
N_STAR = 7
N_DRAWS = 3
SCAN_TOL = 1e-10
# record -> (JAX data, port data, models, NCG budget)
RECORDS = {"quickstart": (lambda: jsynthetic(jax.random.key(42), 100, "k2"),
                          lambda: tsynthetic(rnd.key(42), 100, "k2",
                                             device="cpu"), ("k1", "k2"),
                          dict(n_starts=3, max_iters=10, scan_points=64)),
           "tidal_1_month": (lambda: jwoods(jax.random.key(0), months=1),
                             lambda: twoods(rnd.key(0), months=1,
                                            device="cpu"), ("k2",),
                             dict(n_starts=1, max_iters=30,
                                  scan_points=128))}


def _jspecs(record, sigma_n):
    return jgp.spec_bank(RECORDS[record][2],
                         noise=jgp.NoiseModel(sigma_n=sigma_n),
                         solver=jgp.SolverPolicy(**RECORDS[record][3]))


def _tspecs(record, sigma_n):
    return tgp.spec_bank(RECORDS[record][2],
                         noise=tgp.NoiseModel(sigma_n=sigma_n),
                         solver=tgp.SolverPolicy(**RECORDS[record][3]))


def _jitted_evidence(orig):
    """JAX's dense ``_evidence_profiled_impl`` under ``jax.jit``, one
    compile per covariance and record (eagerly its nested jvps take ~6 s
    per model here)."""
    cache = {}

    def evidence(cov, theta_hat, x, y, sigma_n, box, jeffreys_norm=1.0,
                 jitter=1e-10, backend="dense", **_):
        assert backend == "dense"
        key = (cov.name, np.shape(x), sigma_n, jeffreys_norm, jitter)
        if key not in cache:
            cache[key] = jax.jit(lambda th, xx, yy, lo, hi: orig(
                cov, th, xx, yy, sigma_n, jrep.FlatBox(lo, hi),
                jeffreys_norm, jitter))
        return cache[key](jnp.asarray(theta_hat), x, y, box.lo, box.hi)

    return evidence


def _reference(record):
    """The JAX workflow on one record: gp.compare's sequential key
    threading per model, with the state of each fit, its scan and its
    multimodal evidence; then predict and sample on the k2 fit."""
    ds = RECORDS[record][0]()
    x, y = np.asarray(ds.x), np.asarray(ds.y)
    xstar = np.linspace(x[0], x[-1], N_STAR)
    out = {"x": x, "y": y, "xstar": xstar, "sigma_n": ds.sigma_n,
           "models": []}
    budget = RECORDS[record][3]
    key = jax.random.key(0)
    for spec in _jspecs(record, ds.sigma_n):
        key, kt, kl, _ = jax.random.split(key, 4)
        g = jgp.GP.bind(spec, x, y)
        assert (g.backend, g.operator_name) == ("dense", "dense")
        ks, _ = jax.random.split(kt)        # the scan's key, as _train_impl
        cand = jrep.sample_uniform(ks, g.cov, g.box, (budget["scan_points"],))
        scan = jtrain._scan_objective(g.cov, g.x, g.y, ds.sigma_n,
                                      cand.astype(g.x.dtype), g.jitter)
        g = g.fit(kt)
        mm = g.log_evidence(key=kl, multimodal=True)
        out["models"].append({
            "name": spec.name, "state": _state(g), "cand": np.asarray(cand),
            "scan": np.asarray(scan), "log_z": float(mm.log_z),
            "log_z_modes": np.asarray(mm.log_z_modes),
            "n_modes": mm.n_modes, "errors": np.asarray(mm.best.errors),
            "n_evals": int(g.result.n_evals) + mm.n_modes})
        if spec.name == "k2":
            post = g.predict(xstar)
            out.update(mean=np.asarray(post.mean), var=np.asarray(post.var),
                       draws=np.asarray(g.sample(jax.random.key(5), xstar,
                                                 n_draws=N_DRAWS)))
    return out


@pytest.fixture(scope="module")
def ref():
    orig = jlap._evidence_profiled_impl
    jlap._evidence_profiled_impl = _jitted_evidence(orig)
    try:
        return {record: _reference(record) for record in RECORDS}
    finally:
        jlap._evidence_profiled_impl = orig


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _same_or_both_nan(a, b, rtol):
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    assert a.shape == b.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    np.testing.assert_allclose(a[ok], b[ok], rtol=rtol, atol=0)


def test_quickstart_fits_under_the_random_seam(ref, jax_random):
    """Each model's scan (the points and their ln P_max) and restarts (the
    peaks, their ln P, the evaluations and steps), then predict and sample
    on the k2 fit."""
    r = ref["quickstart"]
    key = rnd.key(0)
    for spec, m in zip(_tspecs("quickstart", r["sigma_n"]), r["models"]):
        key, kt, _, _ = rnd.split(key, 4)
        g = tgp.GP.bind(spec, r["x"], r["y"], device="cpu")
        assert (g.backend, g.operator_name, g.op) == ("dense", "dense", None)
        ks, _ = rnd.split(kt, 2)
        cand = trep.sample_uniform(ks, g.cov, g.box, (len(m["scan"]),))
        assert _rel(cand, m["cand"]) < 1e-15
        scan = thl.profiled_loglik_batch(g.cov, cand, g.x, g.y, r["sigma_n"],
                                         g.jitter)
        assert _rel(scan, m["scan"]) < SCAN_TOL
        g = g.fit(kt)
        res, want = g.result, m["state"]["result"]
        assert res.n_evals == int(want["n_evals"])
        assert res.iters_all.tolist() == want["iters_all"].tolist()
        np.testing.assert_allclose(res.theta_all.numpy(), want["theta_all"],
                                   rtol=FIT_TOL, atol=0)
        np.testing.assert_allclose(res.log_p_all.numpy(), want["log_p_all"],
                                   rtol=FIT_TOL, atol=0)
        assert float(res.sigma_f_hat) == pytest.approx(
            float(want["sigma_f_hat"]), rel=FIT_TOL)
    post = g.predict(r["xstar"])
    assert _rel(post.mean, r["mean"]) < FIT_TOL
    s2 = float(g.result.sigma_f_hat) ** 2
    assert np.max(np.abs(post.var.numpy() - r["var"])) < FIT_TOL * s2
    draws = g.sample(rnd.key(5), r["xstar"], n_draws=N_DRAWS)
    assert draws.shape == (N_DRAWS, N_STAR)
    assert _rel(draws, r["draws"]) < DRAW_TOL


@pytest.mark.parametrize("record", list(RECORDS))
def test_compare_under_the_random_seam(ref, jax_random, record):
    """The data drawn by both packages, then compare: per model ln P_max,
    ln Z (summed over the modes), the evaluations and modes, and ln B.
    The error bars are held on the quickstart record; at the tide record's
    k2 peak (30 steps, not converged) they move by 2e-6 when theta_hat
    moves by 1e-9, and the carried-fit test holds them at the JAX peaks."""
    r = ref[record]
    ds = RECORDS[record][1]()
    assert _rel(ds.x, r["x"]) == 0.0 and ds.sigma_n == r["sigma_n"]
    assert _rel(ds.y, r["y"]) < 1e-12
    if record == "tidal_1_month":           # the scan of the only model
        m = r["models"][0]
        g = tgp.GP.bind(_tspecs(record, ds.sigma_n)[0], r["x"], r["y"],
                        device="cpu")
        scan = thl.profiled_loglik_batch(g.cov, torch.tensor(m["cand"]),
                                         g.x, g.y, ds.sigma_n, g.jitter)
        assert _rel(scan, m["scan"]) < SCAN_TOL
    reports = tgp.compare(_tspecs(record, ds.sigma_n), r["x"], r["y"],
                          key=rnd.key(0), device="cpu")
    for rep, m in zip(reports, r["models"]):
        assert rep.name == m["name"] and rep.n_modes == m["n_modes"]
        assert rep.n_evals_train == m["n_evals"]
        np.testing.assert_allclose(rep.theta_hat.numpy(),
                                   m["state"]["result"]["theta_hat"],
                                   rtol=FIT_TOL, atol=0)
        assert rep.log_p_max == pytest.approx(
            float(m["state"]["result"]["log_p_max"]), rel=FIT_TOL)
        assert math.isfinite(m["log_z"])
        assert rep.log_z_laplace == pytest.approx(m["log_z"], rel=FIT_TOL)
        if record == "quickstart":
            np.testing.assert_allclose(rep.errors.numpy(), m["errors"],
                                       rtol=ERR_TOL, atol=0)
    if len(reports) == 2:
        lnb = tgp.log_bayes_factors(reports)[1, 0].item()
        want = r["models"][1]["log_z"] - r["models"][0]["log_z"]
        assert lnb == pytest.approx(want, rel=FIT_TOL)


@pytest.mark.parametrize("record", list(RECORDS))
def test_stages_on_a_carried_jax_dense_fit(ref, jax_random, record):
    """The port's evidence per mode, ln P_max, predict and sample on the
    JAX package's k2 fit, carried across with no operator."""
    r = ref[record]
    m = r["models"][-1]
    gp = session_from_state(m["state"], r["x"], r["y"], device="cpu")
    assert (gp.backend, gp.operator_name, gp.op) == ("dense", "dense", None)
    key = rnd.key(0)
    for _ in r["models"]:
        key, _, kl, _ = rnd.split(key, 4)
    mm = gp.log_evidence(key=kl, multimodal=True)
    assert mm.n_modes == m["n_modes"]
    _same_or_both_nan(mm.log_z_modes, m["log_z_modes"], FIT_TOL)
    np.testing.assert_allclose(mm.best.errors.numpy(), m["errors"],
                               rtol=FIT_TOL, atol=0)
    res = m["state"]["result"]
    lp = gp.log_likelihood(res["theta_hat"])
    assert float(lp) == pytest.approx(float(res["log_p_max"]), rel=FIT_TOL)
    post = gp.predict(r["xstar"])
    assert _rel(post.mean, r["mean"]) < FIT_TOL
    s2 = float(res["sigma_f_hat"]) ** 2
    assert np.max(np.abs(post.var.numpy() - r["var"])) < FIT_TOL * s2
    assert _rel(gp.sample(rnd.key(5), r["xstar"], n_draws=N_DRAWS),
                r["draws"]) < DRAW_TOL
