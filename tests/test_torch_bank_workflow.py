"""The batched compare as a whole against the JAX package: a gappy tide
record (two months of ``woods_hole_like`` with 12% of the samples
dropped, n = 570) through compare(batch="on") on both sides under the
random seam of ``test_torch_session.py``, at model noise 0.03 and at the
record's 0.01, and the port's Laplace stage on a JAX bank fit carried
across with ``repro_torch.gp.convert``."""

import math

import jax
import numpy as np
import pytest
import torch

from repro import gp as jgp
from repro.core.engine import SolverOpts as JSolverOpts
from repro.core.reparam import FlatBox as JFlatBox
from repro.data import grid as jgrid
from repro.data.tidal import drop_random_hours, woods_hole_like
from repro.gp import batch as jbatch
from repro.gp.spec import pad_boxes as jpad_boxes
import repro_torch.random as rnd
from repro_torch import gp as tgp
from repro_torch.core import engine as teng
from repro_torch.gp.compare import bank_laplace
from repro_torch.gp.convert import bank_from_state

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


SEED = 0       # a key whose budget gives both models a finite ln Z
# sigma_n = 0.03 keeps each CG to tolerance at a few hundred iterations
# (the first two tests, about a minute); the record's own 0.01 takes about
# three times the iterations (one test, about a minute and a half)
TIDAL_SIGMA_N = 0.03
RECORD_SIGMA_N = 0.01
OPTS = dict(n_probes=4, lanczos_k=12, cg_tol=1e-10, cg_max_iter=2000,
            precond="circulant")
POLICY = dict(backend="iterative", n_starts=2, max_iters=4)
# tidal constituent bands: window 4 h .. 2000 h, M2 12.2-12.7 h,
# K1 23.5-24.5 h, smoothness in (-0.45, 0.45)
_W, _P1, _P2 = (np.log(4.0), np.log(2000.0)), (np.log(12.2), np.log(12.7)), \
    (np.log(23.5), np.log(24.5))
BOXES = {"k1": (np.array([_W[0], _P1[0], -0.45]),
                np.array([_W[1], _P1[1], 0.45])),
         "k2": (np.array([_W[0], _P1[0], -0.45, _P2[0], -0.45]),
                np.array([_W[1], _P1[1], 0.45, _P2[1], 0.45]))}
NAMES = ("k1", "k2")


def _tidal_data():
    ds = drop_random_hours(woods_hole_like(jax.random.key(0), months=2),
                           0.12, jax.random.key(11))
    return np.array(ds.x), np.array(ds.y)


def _reference(sigma_n):
    """JAX's compare(batch="on") on the gappy record at model noise
    ``sigma_n``, with the bank fit it trains (captured on its way through
    ``train_bank``)."""
    x, y = _tidal_data()
    assert jgrid.classify_grid(x).kind == "near"
    pol = jgp.SolverPolicy(opts=JSolverOpts(**OPTS), **POLICY)
    specs = [jgp.GPSpec(k, box=JFlatBox(*BOXES[k]),
                        noise=jgp.NoiseModel(sigma_n=sigma_n),
                        solver=pol) for k in NAMES]
    fits = []
    train = jbatch.train_bank

    def keep(*args, **kwargs):
        fits.append(train(*args, **kwargs))
        return fits[-1]

    jbatch.train_bank = keep
    try:
        reports = jgp.compare(specs, x, y, key=jax.random.key(SEED),
                              batch="on")
    finally:
        jbatch.train_bank = train
    tr = fits[0]
    assert not tr.bank.fused            # n < 2048: the JAX bank is unfused
    bank_state = {f: np.asarray(getattr(tr, f))
                  for f in ("theta_hat", "theta_all", "log_p_all",
                            "iters_all", "sigma_f_hat", "log_p_max",
                            "n_evals")}
    bank_state["m_params"] = np.asarray(tr.m_params)
    pbox = jpad_boxes([s.box for s in specs], max(tr.m_params))
    bank_state["boxes"] = (np.asarray(pbox.lo), np.asarray(pbox.hi))
    return {"x": x, "y": y, "bank": bank_state,
            "reports": [dict(name=r.name, theta_hat=np.asarray(r.theta_hat),
                             log_p_max=r.log_p_max, log_z=r.log_z_laplace,
                             sigma_f_hat=r.sigma_f_hat, n_modes=r.n_modes,
                             n_evals=r.n_evals_train)
                        for r in reports]}


@pytest.fixture(scope="module")
def ref():
    return _reference(TIDAL_SIGMA_N)


def _tspecs(sigma_n=TIDAL_SIGMA_N):
    pol = tgp.SolverPolicy(opts=teng.SolverOpts(**OPTS), **POLICY)
    return [tgp.GPSpec(k, box=BOXES[k],
                       noise=tgp.NoiseModel(sigma_n=sigma_n),
                       solver=pol) for k in NAMES]


def _check_reports(got, ref):
    for rep, want in zip(got, ref["reports"]):
        assert rep.name == want["name"]
        assert rep.n_modes == want["n_modes"]
        np.testing.assert_allclose(rep.theta_hat.numpy(), want["theta_hat"],
                                   rtol=0, atol=1e-6)
        assert abs(rep.log_p_max - want["log_p_max"]) \
            < 1e-8 * abs(want["log_p_max"])
        assert math.isfinite(want["log_z"])
        assert abs(rep.log_z_laplace - want["log_z"]) \
            < 1e-6 * abs(want["log_z"])
    lnb = tgp.log_bayes_factors(got)[1, 0].item()
    z1, z2 = (r["log_z"] for r in ref["reports"])
    assert abs(lnb - (z2 - z1)) < 1e-6 * max(abs(z1), abs(z2))


def test_batched_compare_under_the_random_seam(ref, jax_random):
    """The port's compare(batch="on") (train_bank, then the modes bank's
    Laplace stage) against the JAX package's: theta_hat, ln P_max, ln Z
    and ln B per model."""
    reports = tgp.compare(_tspecs(), ref["x"], ref["y"], key=rnd.key(SEED),
                          batch="on", device="cpu")
    _check_reports(reports, ref)
    for rep, want in zip(reports, ref["reports"]):
        assert rep.n_evals_train == want["n_evals"]
        assert abs(rep.sigma_f_hat - want["sigma_f_hat"]) \
            < 1e-6 * want["sigma_f_hat"]


def test_laplace_stage_on_a_carried_jax_bank_fit(ref, jax_random):
    """The port's Laplace stage of the batched compare on the JAX
    package's bank fit, carried across: same modes, same ln Z."""
    specs = _tspecs()
    tr, boxes = bank_from_state(specs, ref["bank"], ref["x"], device="cpu")
    assert tr.bank.structure == "near" and tr.bank.fused
    assert tr.bank.B == 2 * len(NAMES)
    x = torch.tensor(ref["x"], dtype=torch.float64)
    y = torch.tensor(ref["y"], dtype=torch.float64)
    kl = rnd.split(rnd.key(SEED), 3)[2]
    reports = bank_laplace(specs, tr, boxes, x, y, kl)
    _check_reports(reports, ref)


def test_batched_compare_at_the_records_noise(jax_random):
    """The same comparison at the record's own noise, sigma_n = 0.01
    (the SKI cell's): CG needs about three times the iterations, and
    the port must still give the JAX package's peaks and evidences."""
    want = _reference(RECORD_SIGMA_N)
    reports = tgp.compare(_tspecs(RECORD_SIGMA_N), want["x"], want["y"],
                          key=rnd.key(SEED), batch="on", device="cpu")
    _check_reports(reports, want)
