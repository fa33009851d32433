"""The stochastic slice as a whole against the JAX package, under the random
seam of ``test_torch_session.py`` (the port replays the JAX package's
probes, start points and epoch permutations):

  * 1-D: the repository's own recipe for this backend
    (``run_stochastic`` in ``examples/large_scale_gp.py``): sorted uniform
    times on [0, 100], y = sin 2.1x + 0.3 sin 0.37x + 0.1 noise, sigma_n
    0.1, at n = 512;
  * (n, 2): scattered points in [0, 6] x [0, 4] with the same kind of
    signal, "se*se" and "se*matern32", sigma_n 0.1, at n = 384.

Each runs GP.bind with backend="stochastic" pinned (below n = 65536
"auto" does not escalate), then compare of two kernels (sequential: the
stochastic backend never batches; per model bind -> fit ->
log_evidence), then predict with variance at the first model's peak.
Tolerances: ln P_max, ln Z and ln B within 1e-9 relative, theta_hat
within 1e-9, the posterior mean within 1e-9 max|mean| and the variance
within 1e-9 sigma_f^2: the solver's own parity bound
(test_torch_stochastic.py), since every quantity here is made of its
solves.  The two packages agreed to 3e-13 or better on every one of
these numbers when the test was written.  A third test fits the (n, 2)
recipe of chip_smoke.py's stochastic stage from a uniform start in both
packages, the witness for that stage's pinned start."""

import math

import jax
import numpy as np
import pytest
import torch

from repro import gp as jgp
from repro.core.engine import SolverOpts as JSolverOpts
import repro_torch.random as rnd
from repro_torch import gp as tgp
from repro_torch.core import engine as teng
from repro_torch.core import stochastic as tst

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


N_STAR = 23
OPTS = dict(n_probes=4)
POLICY = dict(backend="stochastic", n_starts=2, max_iters=3)
# seeds whose budget gives every model a finite reference ln Z
CASES = {
    "1d": dict(models=("se", "matern32"), sigma_n=0.1, n=512, seed=5),
    "2d": dict(models=("se*se", "se*matern32"), sigma_n=0.1, n=384, seed=7),
}
REL = 1e-9


def _data(case):
    c = CASES[case]
    rng = np.random.default_rng(c["seed"])
    n = c["n"]
    if case == "1d":
        x = np.sort(rng.uniform(0.0, 100.0, n))
        t = x
        xstar = np.sort(rng.uniform(0.0, 100.0, N_STAR))
    else:
        x = rng.uniform([0.0, 0.0], [6.0, 4.0], (n, 2))
        t = x[:, 0] + 0.5 * x[:, 1]
        xstar = rng.uniform([0.2, 0.2], [5.8, 3.8], (N_STAR, 2))
    y = np.sin(2.1 * t) + 0.3 * np.sin(0.37 * t) \
        + c["sigma_n"] * rng.standard_normal(n)
    return x, y, xstar


def _jspec(name, sigma_n):
    return jgp.GPSpec(name, noise=jgp.NoiseModel(sigma_n=sigma_n),
                      solver=jgp.SolverPolicy(opts=JSolverOpts(**OPTS),
                                              **POLICY))


def _tspec(name, sigma_n):
    return tgp.GPSpec(name, noise=tgp.NoiseModel(sigma_n=sigma_n),
                      solver=tgp.SolverPolicy(opts=teng.SolverOpts(**OPTS),
                                              **POLICY))


def _close(got, want, rel=REL):
    return abs(got - want) <= rel * abs(want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_stochastic_slice_matches_the_jax_package(case, jax_random):
    c = CASES[case]
    x, y, xstar = _data(case)
    sig = c["sigma_n"]
    jreps = jgp.compare([_jspec(m, sig) for m in c["models"]], x, y,
                        key=jax.random.key(c["seed"]))
    g = jgp.GP.bind(_jspec(c["models"][0], sig), x, y)
    assert (g.backend, g.op.name) == ("stochastic", "pallas")
    jpost = g.predict(xstar, theta=jreps[0].theta_hat)

    gp = tgp.GP.bind(_tspec(c["models"][0], sig), x, y, device="cpu")
    assert (gp.backend, gp.operator_name) == ("stochastic", "pallas")
    tst.reset_epoch_counts()
    treps = tgp.compare([_tspec(m, sig) for m in c["models"]], x, y,
                        key=rnd.key(c["seed"]), device="cpu")
    assert sum(tst.EPOCH_COUNTS.values()) > 0
    for rep, want in zip(treps, jreps):
        assert rep.name == want.name
        np.testing.assert_allclose(rep.theta_hat.numpy(),
                                   np.asarray(want.theta_hat), rtol=0,
                                   atol=REL)
        assert _close(rep.log_p_max, float(want.log_p_max))
        assert math.isfinite(want.log_z_laplace)
        assert _close(rep.log_z_laplace, float(want.log_z_laplace))
        assert rep.n_modes == want.n_modes
    lnb = tgp.log_bayes_factors(treps)[1, 0].item()
    want_lnb = jreps[1].log_z_laplace - jreps[0].log_z_laplace
    assert abs(lnb - want_lnb) <= REL * max(abs(r.log_z_laplace)
                                            for r in jreps)

    post = gp.predict(xstar, theta=np.asarray(jreps[0].theta_hat))
    mean = np.asarray(jpost.mean)
    np.testing.assert_allclose(post.mean.numpy(), mean, rtol=0,
                               atol=REL * np.max(np.abs(mean)))
    s2 = float(jpost.sigma_f_hat) ** 2
    np.testing.assert_allclose(post.var.numpy(), np.asarray(jpost.var),
                               rtol=0, atol=REL * s2)


# the (n, 2) recipe of chip_smoke.py's stochastic stage (make_scattered_field:
# uniform points on [0, 63.5] x [0, 15.75], y = sin 0.8t cos 1.6s + 0.05
# noise, "se*matern32") at n = 1024, with that stage's budget: one start,
# 8 NCG steps, 8 probes
FIELD = dict(n=1024, seed=7, sigma_n=0.05, kind="se*matern32", steps=8,
             key=4002)


def _field():
    rng = np.random.default_rng(FIELD["seed"])
    x = rng.uniform([0.0, 0.0], [63.5, 15.75], (FIELD["n"], 2))
    y = np.sin(0.8 * x[:, 0]) * np.cos(1.6 * x[:, 1]) \
        + FIELD["sigma_n"] * rng.standard_normal(FIELD["n"])
    return x, y


def test_scattered_field_fit_from_a_uniform_start_matches_the_jax_package(
        jax_random):
    """From the default policy's uniform start, the stochastic fit of the
    card's (n, 2) recipe ends where the JAX package's ends: the same
    theta_hat and ln P_max, and the same ln Z, nan in both where the
    Laplace Hessian there is not negative definite.  The card's stage pins
    its start at theta = 0 for this reason; this test is the witness
    that the end point from a uniform start is the reference's own."""
    x, y = _field()
    sig, kind = FIELD["sigma_n"], FIELD["kind"]
    pol = dict(backend="stochastic", n_starts=1, max_iters=FIELD["steps"])
    jspec = jgp.GPSpec(kind, noise=jgp.NoiseModel(sigma_n=sig),
                       solver=jgp.SolverPolicy(
                           opts=JSolverOpts(n_probes=8), **pol))
    tspec = tgp.GPSpec(kind, noise=tgp.NoiseModel(sigma_n=sig),
                       solver=tgp.SolverPolicy(
                           opts=teng.SolverOpts(n_probes=8), **pol))
    kf, ke = jax.random.split(jax.random.key(FIELD["key"]))
    jfit = jgp.GP.bind(jspec, x, y).fit(kf)
    jz = float(jfit.log_evidence(key=ke).log_z)
    tkf, tke = rnd.split(rnd.key(FIELD["key"]), 2)
    tfit = tgp.GP.bind(tspec, x, y, device="cpu").fit(tkf)
    tz = float(tfit.log_evidence(key=tke).log_z)
    np.testing.assert_allclose(tfit.result.theta_hat.numpy(),
                               np.asarray(jfit.result.theta_hat), rtol=0,
                               atol=REL)
    assert _close(float(tfit.result.log_p_max),
                  float(jfit.result.log_p_max))
    print(f"uniform start: theta_hat {np.exp(tfit.result.theta_hat.numpy())}"
          f" of box hi {np.exp(tfit.box.hi.numpy())}, ln P_max "
          f"{float(tfit.result.log_p_max)}, ln Z {tz} (JAX {jz})")
    assert math.isnan(tz) == math.isnan(jz)
    assert math.isnan(jz) or _close(tz, jz)
