"""The near-grid slice as a whole against the JAX package: a gappy tide
record (``woods_hole_like`` with 12% of the samples dropped) through
compare(batch="off"), the gradient at each peak, predict with the SKI
cross covariance, and the port's stages on a JAX SKI fit carried across,
under the random seam of ``test_torch_session.py``."""

import math

import jax
import numpy as np
import pytest
import torch

from repro import gp as jgp
from repro.core import engine as jeng
from repro.core.engine import SolverOpts as JSolverOpts
from repro.core.reparam import FlatBox as JFlatBox
from repro.data import grid as jgrid
from repro.data.tidal import drop_random_hours, woods_hole_like
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


def _t(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))



SEED = 3       # fit keys whose budget gives both models a finite ln Z
N_STAR = 41
TIDAL_SIGMA_N = 0.01
OPTS = dict(n_probes=4, lanczos_k=12, cg_tol=1e-10, cg_max_iter=2000,
            precond="circulant")
POLICY = dict(backend="iterative", n_starts=2, max_iters=5, scan_points=8)
# tidal constituent bands: window 4 h .. 2000 h, M2 12.2-12.7 h,
# K1 23.5-24.5 h, smoothness in (-0.45, 0.45)
_W, _P1, _P2 = (np.log(4.0), np.log(2000.0)), (np.log(12.2), np.log(12.7)), \
    (np.log(23.5), np.log(24.5))
BOXES = {"k1": (np.array([_W[0], _P1[0], -0.45]),
                np.array([_W[1], _P1[1], 0.45])),
         "k2": (np.array([_W[0], _P1[0], -0.45, _P2[0], -0.45]),
                np.array([_W[1], _P1[1], 0.45, _P2[1], 0.45]))}


def _tidal_data():
    ds = drop_random_hours(woods_hole_like(jax.random.key(0), months=3),
                           0.12, jax.random.key(11))
    x, y = np.asarray(ds.x), np.asarray(ds.y)
    rng = np.random.default_rng(SEED)
    xstar = np.sort(rng.uniform(x[0], x[-1], N_STAR))
    return x, y, xstar


def _grad_key():
    return jax.random.key(SEED + 100)


@pytest.fixture(scope="module")
def ref():
    """The JAX workflow on the gappy record: per model, exactly the key
    threading of gp.compare's sequential path (so these are also the
    reports of compare(batch="off")), the gradient at the peak, predict."""
    x, y, xstar = _tidal_data()
    assert jgrid.classify_grid(x).kind == "near"
    pol = jgp.SolverPolicy(opts=JSolverOpts(**OPTS), **POLICY)
    key = jax.random.key(SEED)
    out = {"x": x, "y": y, "xstar": xstar, "models": []}
    for name in ("k1", "k2"):
        spec = jgp.GPSpec(name, box=JFlatBox(*BOXES[name]),
                          noise=jgp.NoiseModel(sigma_n=TIDAL_SIGMA_N),
                          solver=pol)
        key, kt, kl, _ = jax.random.split(key, 4)
        g = jgp.GP.bind(spec, x, y)
        assert g.op.name == "ski"
        g = g.fit(kt)
        mm = g.log_evidence(key=kl, multimodal=True)
        post = g.predict(xstar)
        lp, grad = jeng.value_and_grad_fn(
            "iterative", spec.cov, g.x, g.y, TIDAL_SIGMA_N, key=_grad_key(),
            jitter=g.jitter, opts=pol.opts, op=g.op)(g.result.theta_hat)
        out["models"].append({
            "name": name, "state": _state(g), "log_z": float(mm.log_z),
            "log_z_modes": np.asarray(mm.log_z_modes),
            "n_modes": mm.n_modes, "lp": float(lp),
            "grad": np.asarray(grad), "mean": np.asarray(post.mean),
            "var": np.asarray(post.var)})
    return out


def _tspec(name):
    pol = tgp.SolverPolicy(opts=teng.SolverOpts(**OPTS), **POLICY)
    return tgp.GPSpec(name, box=BOXES[name],
                      noise=tgp.NoiseModel(sigma_n=TIDAL_SIGMA_N),
                      solver=pol)


def test_reference_gives_finite_evidences(ref):
    """The data, boxes and budget are chosen so both evidences exist."""
    assert all(math.isfinite(m["log_z"]) for m in ref["models"])


def test_gappy_tide_record_under_the_random_seam(ref, jax_random):
    """compare(batch="off") (bind -> fit -> log_evidence per model), then
    the gradient at each peak and predict there, against the JAX
    package."""
    x, y, xstar = ref["x"], ref["y"], ref["xstar"]
    reports = tgp.compare([_tspec("k1"), _tspec("k2")], x, y,
                          key=rnd.key(SEED), batch="off", device="cpu")
    for rep, m in zip(reports, ref["models"]):
        res = m["state"]["result"]
        assert rep.name == m["name"]
        np.testing.assert_allclose(rep.theta_hat.numpy(), res["theta_hat"],
                                   rtol=0, atol=1e-6)
        assert abs(rep.log_p_max - float(res["log_p_max"])) \
            < 1e-8 * abs(float(res["log_p_max"]))
        assert rep.n_modes == m["n_modes"]
        assert abs(rep.log_z_laplace - m["log_z"]) < 1e-6 * abs(m["log_z"])
        gp = tgp.GP.bind(_tspec(m["name"]), x, y, device="cpu")
        assert (gp.backend, gp.operator_name) == ("iterative", "ski")
        assert gp.op.fused and gp.op._sel_cells is not None
        lp, grad = teng.value_and_grad_fn(
            "iterative", gp.cov, gp.x, gp.y, TIDAL_SIGMA_N,
            key=rnd.key(SEED + 100), jitter=gp.jitter,
            opts=gp.spec.solver.opts, op=gp.op)(_t(res["theta_hat"]))
        assert abs(float(lp) - m["lp"]) < 1e-8 * abs(m["lp"])
        assert _rel(grad.numpy(), m["grad"]) < 1e-8
        post = gp.predict(xstar, theta=res["theta_hat"])
        np.testing.assert_allclose(post.mean.numpy(), m["mean"], rtol=0,
                                   atol=1e-8 * np.max(np.abs(m["mean"])))
        s2 = float(res["sigma_f_hat"]) ** 2
        np.testing.assert_allclose(post.var.numpy(), m["var"], rtol=0,
                                   atol=1e-8 * s2)
    lnb = tgp.log_bayes_factors(reports)[1, 0].item()
    z1, z2 = (m["log_z"] for m in ref["models"])
    assert np.sign(lnb) == np.sign(z2 - z1)
    assert abs(lnb - (z2 - z1)) < 1e-6 * max(abs(z1), abs(z2))


@pytest.mark.parametrize("model", [0, 1])
def test_carried_jax_ski_fit(ref, jax_random, model):
    """The port's log_evidence and predict on the JAX package's SKI fit."""
    m = ref["models"][model]
    gp = session_from_state(m["state"], ref["x"], ref["y"], device="cpu")
    assert gp.operator_name == "ski" and gp.op.fused
    assert gp.spec.solver.opts.precond == "circulant"
    key = rnd.key(SEED)
    for _ in range(model + 1):
        key, _, kl, _ = rnd.split(key, 4)
    mm = gp.log_evidence(key=kl, multimodal=True)
    assert mm.n_modes == m["n_modes"]
    np.testing.assert_allclose(np.asarray(mm.log_z_modes),
                               m["log_z_modes"], rtol=1e-6)
    post = gp.predict(ref["xstar"])
    np.testing.assert_allclose(post.mean.numpy(), m["mean"], rtol=0,
                               atol=1e-8 * np.max(np.abs(m["mean"])))
    s2 = float(m["state"]["result"]["sigma_f_hat"]) ** 2
    np.testing.assert_allclose(post.var.numpy(), m["var"], rtol=0,
                               atol=1e-8 * s2)
