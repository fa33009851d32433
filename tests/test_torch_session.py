"""The whole slice, bind -> fit -> log_evidence -> compare -> predict,
against the JAX package on the same numpy data.

The random seam: the port draws all its randomness through
``repro_torch.random.rademacher`` / ``uniform`` / ``normal`` /
``permutation`` from a key that records the JAX key tree.  The fixture
below replaces all four by functions that replay the key's path with
``jax.random``, so the port sees the JAX package's probes (Rademacher, and
the N(0, P) probes of preconditioned SLQ), scan points, start points and
the stochastic backend's epoch orders everywhere.

Two kinds of check:
  * stages on a JAX fit carried across (``repro_torch.gp.convert``): the
    port's evidence and prediction on the JAX package's peaks, so an NCG
    difference cannot hide an evidence or prediction fault;
  * the whole slice under the seam: the port's own fit, evidence, compare
    and predict against the JAX package's.
"""

import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import gp as jgp
from repro.core.engine import SolverOpts as JSolverOpts
import repro_torch.random as rnd
from repro_torch import gp as tgp
from repro_torch.core.engine import SolverOpts
from repro_torch.gp.convert import session_from_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run several pytest workers on one machine; torch's CPU
    thread pool in each of them oversubscribes the cores (tens of times
    slower), so each module runs torch on one thread and restores it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N = 200
SPAN = 200.0
SEED = 3   # a seed whose budget gives both models a finite ln Z
N_STAR = 37
# CG runs to its tolerance: an unconverged CG (stopped by cg_max_iter)
# amplifies rounding differences between two implementations to ~1e-6
OPTS = dict(n_probes=4, lanczos_k=12, cg_tol=1e-8, cg_max_iter=1000)
TIGHT_CG_TOL = 1e-12
POLICY = dict(backend="iterative", n_starts=2, max_iters=3, scan_points=8)


def _jax_key(k: rnd.Key):
    jk = jax.random.key(k.seed)
    for step in k.path:
        if step[0] == "split":
            jk = jax.random.split(jk, step[1])[step[2]]
        else:
            jk = jax.random.fold_in(jk, step[1])
    return jk


@pytest.fixture
def jax_random(monkeypatch):
    """Replay every port draw with jax.random on the recorded key path."""

    def rademacher(k, shape, *, device, dtype=torch.float64):
        z = np.asarray(jax.random.rademacher(_jax_key(k), tuple(shape)))
        return torch.tensor(z, device=device, dtype=dtype)

    def uniform(k, shape, lo=0.0, hi=1.0, *, device, dtype=torch.float64):
        u = np.asarray(jax.random.uniform(_jax_key(k), tuple(shape),
                                          minval=lo, maxval=hi,
                                          dtype=jnp.float64))
        return torch.tensor(u, device=device, dtype=dtype)

    def normal(k, shape, *, device, dtype=torch.float64):
        g = np.asarray(jax.random.normal(_jax_key(k), tuple(shape),
                                         dtype=jnp.float64))
        return torch.tensor(g, device=device, dtype=dtype)

    def permutation(k, n, *, device):
        p = np.asarray(jax.random.permutation(_jax_key(k), int(n)))
        return torch.tensor(p, device=device, dtype=torch.int64)

    monkeypatch.setattr(rnd, "rademacher", rademacher)
    monkeypatch.setattr(rnd, "permutation", permutation)
    monkeypatch.setattr(rnd, "uniform", uniform)
    monkeypatch.setattr(rnd, "normal", normal)


def _data():
    rng = np.random.default_rng(SEED)
    x = np.sort(rng.uniform(0.0, SPAN, N))
    y = (np.sin(2 * np.pi * x / 12.4) + 0.5 * np.sin(2 * np.pi * x / 24.0)
         + 0.1 * rng.standard_normal(N))
    xstar = np.sort(rng.uniform(0.0, SPAN, N_STAR))
    return x, y, xstar


def _state(g):
    """A JAX session's state as plain numbers and numpy arrays."""
    pol = g.spec.solver
    solver = pol._asdict()
    solver["opts"] = pol.opts._asdict()
    r = g.result
    return {"kernel": g.spec.name, "noise": g.spec.noise._asdict(),
            "solver": solver,
            "box": (np.asarray(g.box.lo), np.asarray(g.box.hi)),
            "result": {f: np.asarray(getattr(r, f)) for f in r._fields}}


@pytest.fixture(scope="module")
def ref():
    """The JAX workflow, run once: for each model, exactly the key
    threading of gp.compare's sequential path, then predict."""
    x, y, xstar = _data()
    pol = jgp.SolverPolicy(opts=JSolverOpts(**OPTS), **POLICY)
    specs = jgp.spec_bank(["k1", "k2"], noise=jgp.NoiseModel(sigma_n=0.1),
                          solver=pol)
    key = jax.random.key(SEED)
    out = {"x": x, "y": y, "xstar": xstar, "models": []}
    for spec in specs:
        key, kt, kl, _ = jax.random.split(key, 4)
        g = jgp.GP.bind(spec, x, y).fit(kt)
        mm = g.log_evidence(key=kl, multimodal=True)
        post = g.predict(xstar)
        # the carried-stage predict solves to 1e-12: two CGs stopped at
        # 1e-8 agree only to ~1e-8 times the conditioning
        tight = dataclasses.replace(spec, solver=pol._replace(
            opts=pol.opts._replace(cg_tol=TIGHT_CG_TOL)))
        post_tight = jgp.GP(tight, g.x, g.y, g.box, g.backend, g.jitter,
                            g.kind, g.op, result=g.result).predict(xstar)
        out["models"].append({
            "name": spec.name, "state": _state(g),
            "log_z": float(mm.log_z), "log_z_modes": np.asarray(
                mm.log_z_modes), "n_modes": mm.n_modes,
            "n_evals": int(g.result.n_evals) + mm.n_modes,
            "mean": np.asarray(post.mean), "var": np.asarray(post.var),
            "mean_tight": np.asarray(post_tight.mean),
            "var_tight": np.asarray(post_tight.var)})
    return out


def _tspecs():
    pol = tgp.SolverPolicy(opts=SolverOpts(**OPTS), **POLICY)
    return tgp.spec_bank(["k1", "k2"], noise=tgp.NoiseModel(sigma_n=0.1),
                         solver=pol)


def _same_or_both_nan(a, b, atol):
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    assert a.shape == b.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    np.testing.assert_allclose(a[ok], b[ok], rtol=0, atol=atol)


def test_reference_has_a_finite_evidence(ref):
    """The data and budget are chosen so the comparison is not all-nan."""
    assert any(math.isfinite(m["log_z"]) for m in ref["models"])


@pytest.mark.parametrize("model", [0, 1])
def test_stages_on_carried_jax_fit(ref, jax_random, model):
    """Evidence per mode, ln P_max and the posterior on the JAX peaks."""
    m = ref["models"][model]
    gp = session_from_state(m["state"], ref["x"], ref["y"], device="cpu")
    assert gp.backend == "iterative" and gp.operator_name == "pallas"
    key = rnd.key(SEED)
    for _ in range(model + 1):
        key, kt, kl, _ = rnd.split(key, 4)
    mm = gp.log_evidence(key=kl, multimodal=True)
    assert mm.n_modes == m["n_modes"]
    # the central-difference Hessian amplifies CG error: ln Z to 1e-4
    _same_or_both_nan(mm.log_z_modes, m["log_z_modes"], 1e-4)
    res = m["state"]["result"]
    _, kprobe = rnd.split(kt, 2)       # the scan-seeded fit splits once
    lp = gp.log_likelihood(res["theta_hat"],
                           key=rnd.fold_in(kprobe, 0x5eed))
    assert abs(float(lp) - float(res["log_p_max"])) \
        < 1e-8 * abs(float(res["log_p_max"]))
    state = copy.deepcopy(m["state"])
    state["solver"]["opts"]["cg_tol"] = TIGHT_CG_TOL
    post = session_from_state(state, ref["x"], ref["y"],
                              device="cpu").predict(ref["xstar"])
    np.testing.assert_allclose(post.mean.numpy(), m["mean_tight"],
                               rtol=1e-8,
                               atol=1e-8 * np.max(np.abs(m["mean_tight"])))
    # var = s2 (1 - k*' K^-1 k*) cancels terms of size s2 = sigma_f_hat^2
    s2 = float(res["sigma_f_hat"]) ** 2
    np.testing.assert_allclose(post.var.numpy(), m["var_tight"], rtol=0,
                               atol=1e-8 * s2)


def test_whole_slice_under_the_random_seam(ref, jax_random):
    """The port's own fit and predict per model, then compare(), which
    refits each model under the same keys and adds its evidence."""
    x, y, xstar = ref["x"], ref["y"], ref["xstar"]
    specs = _tspecs()
    key = rnd.key(SEED)
    for spec, m in zip(specs, ref["models"]):
        key, kt, _, _ = rnd.split(key, 4)
        gp = tgp.GP.bind(spec, x, y, device="cpu")
        assert gp.backend == "iterative" and gp.operator_name == "pallas"
        fitted = gp.fit(kt)
        res = m["state"]["result"]
        np.testing.assert_allclose(fitted.result.theta_all.numpy(),
                                   res["theta_all"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(fitted.result.log_p_all.numpy(),
                                   res["log_p_all"], rtol=1e-8)
        assert fitted.result.n_evals == int(res["n_evals"])
        np.testing.assert_array_equal(fitted.result.iters_all.numpy(),
                                      res["iters_all"])
        post = fitted.predict(xstar)
        np.testing.assert_allclose(post.mean.numpy(), m["mean"], rtol=1e-6,
                                   atol=1e-6 * np.max(np.abs(m["mean"])))
        s2 = float(res["sigma_f_hat"]) ** 2
        np.testing.assert_allclose(post.var.numpy(), m["var"], rtol=0,
                                   atol=1e-6 * s2)

    reports = tgp.compare(specs, x, y, key=rnd.key(SEED), device="cpu")
    for rep, m in zip(reports, ref["models"]):
        assert rep.name == m["name"]
        np.testing.assert_allclose(rep.theta_hat.numpy(),
                                   m["state"]["result"]["theta_hat"],
                                   rtol=0, atol=1e-6)
        assert rep.n_modes == m["n_modes"]
        assert rep.n_evals_train == m["n_evals"]
        _same_or_both_nan([rep.log_z_laplace], [m["log_z"]], 1e-3)
    lnb = tgp.log_bayes_factors(reports)[1, 0].item()
    want = ref["models"][1]["log_z"] - ref["models"][0]["log_z"]
    if math.isfinite(want):
        assert abs(lnb - want) < 1e-3
