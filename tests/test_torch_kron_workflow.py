"""The N-D grid slice as a whole against the JAX package, under the random
seam of ``test_torch_session.py``:

  * a gappy spatio-temporal field (the recipe of
    ``examples/spatiotemporal.py`` at 16 x 12 with 15% of the records
    dropped, n ~ 160) on the product-SKI operator: compare(batch="off")
    (bind -> fit -> log_evidence per model), the gradient at each peak,
    predict with the interpolated cross covariance, and
    compare(batch="auto") (the multi-axis bank);
  * the full field (a Kronecker grid): bind -> fit -> predict;
  * scattered (n, 2) points on the product tiles: the value and gradient
    of ln P_max and predict at one theta.

The iterative backend is pinned (below n = 2048 "auto" is dense) and CG
runs to its tolerance.  The reference's product-SKI CG preconditioner
leaves out the noise (its spectrum comes from the noise-free inner
Kronecker operator, so its CG stalls; ROADMAP.md queue C); the reference
runs here with the noise added, as the port has it.  Tolerances as the
near-grid workflow's: ln P_max and ln Z within 1e-6 relative, the
posterior mean within 1e-8 max|mean|, the variance within 1e-8
sigma_f^2."""

import math

import jax
import numpy as np
import pytest
import torch

from repro import gp as jgp
from repro.core import engine as jeng
from repro.core.engine import SolverOpts as JSolverOpts
from repro.kernels import operators as jopers
import repro_torch.random as rnd
from repro_torch import gp as tgp
from repro_torch.core import engine as teng
from repro_torch.gp.convert import session_from_state

from test_torch_session import _state, jax_random  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run several pytest workers on one machine; torch's CPU
    thread pool in each of them oversubscribes the cores (tens of times
    slower), so each module runs torch on one thread and restores it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SEED = 4
SIGMA_N = 0.05
SHAPE = (13, 10)
N_STAR = 29
MODELS = ("se*se", "se*matern32")
OPTS = dict(n_probes=4, lanczos_k=12, cg_tol=1e-10, cg_max_iter=2000,
            precond="circulant")
POLICY = dict(backend="iterative", n_starts=2, max_iters=3, scan_points=4)


def _t(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


def _field(shape=SHAPE, drop=0.15, seed=SEED):
    """``examples/spatiotemporal.make_field`` in numpy: a smooth-in-time,
    rougher-in-space field on spacings (0.5, 0.25), ``drop`` of the
    records removed, noise SIGMA_N."""
    t = 0.5 * np.arange(shape[0])
    s = 0.25 * np.arange(shape[1])
    X = np.stack(np.meshgrid(t, s, indexing="ij"), -1).reshape(-1, 2)
    rng = np.random.default_rng(seed)
    keep = rng.uniform(size=X.shape[0]) > drop
    X = X[keep]
    f = np.sin(0.8 * X[:, 0]) * np.cos(1.6 * X[:, 1])
    y = f + SIGMA_N * rng.standard_normal(X.shape[0])
    xstar = np.stack([rng.uniform(0.3, t[-1] - 0.3, N_STAR),
                      rng.uniform(0.2, s[-1] - 0.2, N_STAR)], -1)
    return X, y, xstar


def _jspec(name, **policy):
    pol = jgp.SolverPolicy(opts=JSolverOpts(**OPTS), **{**POLICY, **policy})
    return jgp.GPSpec(name, noise=jgp.NoiseModel(sigma_n=SIGMA_N),
                      solver=pol)


def _tspec(name, **policy):
    pol = tgp.SolverPolicy(opts=teng.SolverOpts(**OPTS),
                           **{**POLICY, **policy})
    return tgp.GPSpec(name, noise=tgp.NoiseModel(sigma_n=SIGMA_N),
                      solver=pol)


def _grad_key():
    return jax.random.key(SEED + 100)


def _circulant_precond_with_noise(self, theta, floor=1e-12):
    """The reference's product-SKI CG preconditioner with the operator's
    noise in its Kronecker-Strang spectrum (``_lam_with_noise``)."""
    pc = jopers.masked_circulant_slq_precond(
        self._lam_with_noise(theta, floor), None)

    def apply(r):
        squeeze = r.ndim == 1
        if squeeze:
            r = r[:, None]
        out = self._W(pc.apply_inv(self._Wt(r)))
        return out[:, 0] if squeeze else out

    return apply


@pytest.fixture(scope="module")
def ref():
    """The JAX workflow on the gappy field: per model the key threading of
    gp.compare's sequential path, the gradient at the peak and predict;
    then the batched compare."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jopers.ProductSKIOperator, "circulant_precond",
               _circulant_precond_with_noise)
    try:
        yield _reference()
    finally:
        mp.undo()


def _reference():
    x, y, xstar = _field()
    key = jax.random.key(SEED)
    out = {"x": x, "y": y, "xstar": xstar, "models": []}
    for name in MODELS:
        spec = _jspec(name)
        key, kt, kl, _ = jax.random.split(key, 4)
        g = jgp.GP.bind(spec, x, y)
        assert g.op.name == "product_ski"
        g = g.fit(kt)
        mm = g.log_evidence(key=kl, multimodal=True)
        post = g.predict(xstar)
        lp, grad = jeng.value_and_grad_fn(
            "iterative", spec.cov, g.x, g.y, SIGMA_N, key=_grad_key(),
            jitter=g.jitter, opts=spec.solver.opts, op=g.op)(
                g.result.theta_hat)
        out["models"].append({
            "name": name, "state": _state(g), "log_z": float(mm.log_z),
            "n_modes": mm.n_modes, "lp": float(lp),
            "grad": np.asarray(grad), "mean": np.asarray(post.mean),
            "var": np.asarray(post.var)})
    out["bank"] = [
        {"name": r.name, "log_p_max": r.log_p_max,
         "log_z": r.log_z_laplace, "theta_hat": np.asarray(r.theta_hat),
         "n_modes": r.n_modes}
        for r in jgp.compare([_jspec(m) for m in MODELS], x, y,
                             key=jax.random.key(SEED + 1), batch="on")]
    return out


def _close(got, want, rel=1e-6):
    return abs(got - want) <= rel * abs(want)


def test_reference_gives_finite_evidences(ref):
    """The data and budget are chosen so both evidences exist, on both
    compare paths."""
    assert all(math.isfinite(m["log_z"]) for m in ref["models"])
    assert all(math.isfinite(b["log_z"]) for b in ref["bank"])


def test_gappy_field_sequential_compare_and_predict(ref, jax_random):
    x, y, xstar = ref["x"], ref["y"], ref["xstar"]
    reports = tgp.compare([_tspec(m) for m in MODELS], x, y,
                          key=rnd.key(SEED), batch="off", device="cpu")
    for rep, m in zip(reports, ref["models"]):
        res = m["state"]["result"]
        assert rep.name == m["name"]
        np.testing.assert_allclose(rep.theta_hat.numpy(), res["theta_hat"],
                                   rtol=0, atol=1e-6)
        assert _close(rep.log_p_max, float(res["log_p_max"]))
        assert rep.n_modes == m["n_modes"]
        assert _close(rep.log_z_laplace, m["log_z"])
        gp = tgp.GP.bind(_tspec(m["name"]), x, y, device="cpu")
        assert (gp.backend, gp.operator_name) == ("iterative",
                                                  "product_ski")
        assert gp.op.fused and gp.op._sel_cells is not None
        lp, grad = teng.value_and_grad_fn(
            "iterative", gp.cov, gp.x, gp.y, SIGMA_N,
            key=rnd.key(SEED + 100), jitter=gp.jitter,
            opts=gp.spec.solver.opts, op=gp.op)(_t(res["theta_hat"]))
        assert abs(float(lp) - m["lp"]) < 1e-8 * abs(m["lp"])
        assert (np.max(np.abs(grad.numpy() - m["grad"]))
                < 1e-8 * np.max(np.abs(m["grad"])))
        post = gp.predict(xstar, theta=res["theta_hat"])
        np.testing.assert_allclose(post.mean.numpy(), m["mean"], rtol=0,
                                   atol=1e-8 * np.max(np.abs(m["mean"])))
        s2 = float(res["sigma_f_hat"]) ** 2
        np.testing.assert_allclose(post.var.numpy(), m["var"], rtol=0,
                                   atol=1e-8 * s2)
    lnb = tgp.log_bayes_factors(reports)[1, 0].item()
    z1, z2 = (m["log_z"] for m in ref["models"])
    assert abs(lnb - (z2 - z1)) < 1e-6 * max(abs(z1), abs(z2))


@pytest.mark.parametrize("model", [0, 1])
def test_carried_jax_product_ski_fit(ref, jax_random, model):
    """The port's log_evidence and predict on the JAX package's product-SKI
    fit, carried across by ``gp.convert``."""
    m = ref["models"][model]
    gp = session_from_state(m["state"], ref["x"], ref["y"], device="cpu")
    assert gp.operator_name == "product_ski" and gp.op.fused
    assert gp.box.lo.shape == (2,)
    key = rnd.key(SEED)
    for _ in range(model + 1):
        key, _, kl, _ = rnd.split(key, 4)
    mm = gp.log_evidence(key=kl, multimodal=True)
    assert mm.n_modes == m["n_modes"]
    assert _close(float(mm.log_z), m["log_z"])
    post = gp.predict(ref["xstar"])
    np.testing.assert_allclose(post.mean.numpy(), m["mean"], rtol=0,
                               atol=1e-8 * np.max(np.abs(m["mean"])))
    s2 = float(m["state"]["result"]["sigma_f_hat"]) ** 2
    np.testing.assert_allclose(post.var.numpy(), m["var"], rtol=0,
                               atol=1e-8 * s2)


def test_gappy_field_batched_compare(ref, jax_random):
    """compare(batch="auto") runs the multi-axis bank (product structure,
    the unfused Kronecker cycle) and gives the JAX bank's answers."""
    x, y = ref["x"], ref["y"]
    trained = []
    train = tgp.batch.train_bank

    def spy(*args, **kwargs):
        trained.append(train(*args, **kwargs))
        return trained[-1]

    mp = pytest.MonkeyPatch()
    mp.setattr(tgp.batch, "train_bank", spy)
    try:
        reports = tgp.compare([_tspec(m) for m in MODELS], x, y,
                              key=rnd.key(SEED + 1), batch="auto",
                              device="cpu")
    finally:
        mp.undo()
    assert len(trained) == 1
    bank = trained[0].bank
    assert (bank.structure, bank.d, bank.fused) == ("product", 2, False)
    for rep, want in zip(reports, ref["bank"]):
        assert rep.name == want["name"]
        np.testing.assert_allclose(rep.theta_hat.numpy(), want["theta_hat"],
                                   rtol=0, atol=1e-6)
        assert _close(rep.log_p_max, want["log_p_max"])
        assert rep.n_modes == want["n_modes"]
        assert _close(rep.log_z_laplace, want["log_z"])


def test_kron_grid_fit_and_predict(jax_random):
    x, y, xstar = _field(shape=(10, 8), drop=0.0)
    spec = _jspec("se*matern32", n_starts=1, max_iters=2)
    g = jgp.GP.bind(spec, x, y)
    assert g.op.name == "kron"
    g = g.fit(jax.random.key(SEED))
    post = g.predict(xstar)
    gp = tgp.GP.bind(_tspec("se*matern32", n_starts=1, max_iters=2), x, y,
                     device="cpu")
    assert gp.operator_name == "kron" and gp.op.shape == (10, 8)
    gp = gp.fit(rnd.key(SEED))
    np.testing.assert_allclose(gp.theta_hat.numpy(),
                               np.asarray(g.result.theta_hat), rtol=0,
                               atol=1e-6)
    assert _close(float(gp.result.log_p_max), float(g.result.log_p_max))
    tp = gp.predict(xstar)
    np.testing.assert_allclose(
        tp.mean.numpy(), np.asarray(post.mean), rtol=0,
        atol=1e-8 * np.max(np.abs(np.asarray(post.mean))))
    s2 = float(g.result.sigma_f_hat) ** 2
    np.testing.assert_allclose(tp.var.numpy(), np.asarray(post.var),
                               rtol=0, atol=1e-8 * s2)


def test_scattered_points_on_the_product_tiles(jax_random):
    rng = np.random.default_rng(SEED)
    x = rng.uniform(0.0, 5.0, (60, 2))
    y = np.sin(0.8 * x[:, 0]) * np.cos(1.6 * x[:, 1]) \
        + SIGMA_N * rng.standard_normal(60)
    xstar = rng.uniform(0.5, 4.5, (11, 2))
    theta = np.array([np.log(1.1), np.log(0.6)])
    opts = {**OPTS, "precond": None}
    jpol = jgp.SolverPolicy(opts=JSolverOpts(**opts), **POLICY)
    jspec = jgp.GPSpec("se*matern32", noise=jgp.NoiseModel(SIGMA_N),
                       solver=jpol)
    g = jgp.GP.bind(jspec, x, y)
    assert g.op.name == "pallas"
    lp, grad = jeng.value_and_grad_fn(
        "iterative", jspec.cov, g.x, g.y, SIGMA_N, key=_grad_key(),
        jitter=g.jitter, opts=jpol.opts, op=g.op)(jax.numpy.asarray(theta))
    post = g.predict(xstar, theta=theta)
    tpol = tgp.SolverPolicy(opts=teng.SolverOpts(**opts), **POLICY)
    gp = tgp.GP.bind(tgp.GPSpec("se*matern32",
                                noise=tgp.NoiseModel(SIGMA_N), solver=tpol),
                     x, y, device="cpu")
    assert gp.operator_name == "pallas" and gp.op.kinds == ("se",
                                                           "matern32")
    tlp, tgrad = teng.value_and_grad_fn(
        "iterative", gp.cov, gp.x, gp.y, SIGMA_N, key=rnd.key(SEED + 100),
        jitter=gp.jitter, opts=tpol.opts, op=gp.op)(_t(theta))
    assert abs(float(tlp) - float(lp)) < 1e-8 * abs(float(lp))
    assert (np.max(np.abs(tgrad.numpy() - np.asarray(grad)))
            < 1e-8 * np.max(np.abs(np.asarray(grad))))
    tp = gp.predict(xstar, theta=theta)
    mean = np.asarray(post.mean)
    np.testing.assert_allclose(tp.mean.numpy(), mean, rtol=0,
                               atol=1e-8 * np.max(np.abs(mean)))
    s2 = float(post.sigma_f_hat) ** 2
    np.testing.assert_allclose(tp.var.numpy(), np.asarray(post.var),
                               rtol=0, atol=1e-8 * s2)
