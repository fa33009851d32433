"""Port kernels (B1, B2, B4) and parameter maps against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
its public wrappers (Pallas in interpret mode).  Both get the same numpy
inputs.  The CUDA kernels are held against the plain versions on the card
in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import kernel_matvec as tkm
from repro_torch.kernels import kernel_tile as tkt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run several pytest workers on one machine; torch's CPU
    thread pool in each of them oversubscribes the cores (tens of times
    slower), so each module runs torch on one thread and restores it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


KINDS = ("k1", "k2", "se", "matern12", "matern32", "matern52")
SPAN = 8760.0

# flat hyperparameters per case; "edge" puts the periodic timescales near
# the smallest data gap, where pi * dt / T reaches 1e8-1e9
THETAS = {
    ("k1", "mid"): [np.log(300.0), np.log(12.4), 0.1],
    ("k1", "edge"): [np.log(500.0), np.log(3e-5), -0.2],
    ("k2", "mid"): [np.log(400.0), np.log(12.4), 0.05, np.log(24.0), -0.1],
    ("k2", "edge"): [np.log(600.0), np.log(2e-5), 0.2, np.log(7e-5), -0.3],
    ("se", "mid"): [np.log(40.0)],
    ("matern12", "mid"): [np.log(40.0)],
    ("matern32", "mid"): [np.log(40.0)],
    ("matern52", "mid"): [np.log(40.0)],
}
CASES = sorted(THETAS)


def _data(seed, n1, n2, b):
    rng = np.random.default_rng(seed)
    x1 = np.sort(rng.uniform(0.0, SPAN, n1))
    x2 = np.sort(rng.uniform(0.0, SPAN, n2))
    v = rng.standard_normal((n2, b))
    return x1, x2, v


def _t(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


def _relerr(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("kind", KINDS)
def test_natural_params_and_tangents_match_jax(kind):
    rng = np.random.default_rng(1)
    m = tops.FLAT_NPARAMS[kind]
    for _ in range(4):
        theta = rng.uniform(-0.499, 0.499, m) + np.where(
            np.isin(np.arange(m), (2, 4)) & (kind in ("k1", "k2")), 0.0,
            rng.uniform(-3, 6, m))
        want_p = np.asarray(jops.natural_params(kind, jnp.asarray(theta)))
        want_t = np.asarray(jops.natural_tangents(kind, jnp.asarray(theta)))
        got_p = tops.natural_params(kind, _t(theta)).numpy()
        got_t = tops.natural_tangents(kind, _t(theta)).numpy()
        np.testing.assert_allclose(got_p, want_p, rtol=1e-13, atol=0)
        np.testing.assert_allclose(got_t, want_t, rtol=1e-13, atol=0)


def test_smoothness_map_near_box_edge():
    """At 2 xi = 1 - 1e-9 the port's erfinv agrees with scipy's exactly,
    while jax.scipy.special.erfinv is off by 1.3e-11 relative there; the
    tangent's exp(erfinv^2) factor amplifies that to ~7e-10.  So the port
    is held to scipy at 1e-13 and to JAX at the JAX erfinv's own error."""
    from scipy.special import erfinv

    theta = np.array([np.log(300.0), np.log(12.0), 0.5 - 5e-10])
    e = erfinv(2.0 * theta[2])
    ell = np.exp(1.0 + np.sqrt(2.0) * 2.0 * e)
    dell = ell * np.sqrt(2.0) * 2.0 * np.sqrt(np.pi) / 2.0 * 2.0 * np.exp(e * e)
    got_p = tops.natural_params("k1", _t(theta)).numpy()
    got_t = tops.natural_tangents("k1", _t(theta)).numpy()
    np.testing.assert_allclose(got_p[2], ell, rtol=1e-13)
    np.testing.assert_allclose(got_t[2, 2], dell, rtol=1e-13)
    want_t = np.asarray(jops.natural_tangents("k1", jnp.asarray(theta)))
    np.testing.assert_allclose(got_t, want_t, rtol=1e-9, atol=0)


@pytest.mark.parametrize("kind,case", CASES)
def test_plain_tile_matvec_matches_jax(kind, case):
    x1, x2, v = _data(2, 300, 277, 3)
    theta = np.asarray(THETAS[(kind, case)])
    want = jops.matvec(kind, jnp.asarray(theta), jnp.asarray(x1),
                       jnp.asarray(x2), jnp.asarray(v))
    got = tops.matvec(kind, _t(theta), _t(x1), _t(x2), _t(v))
    assert got.shape == (300, 3)
    assert _relerr(got.numpy(), want) < 1e-12


@pytest.mark.parametrize("kind,case", CASES)
def test_plain_stacked_tangents_match_jax(kind, case):
    x1, x2, v = _data(3, 290, 261, 4)
    theta = np.asarray(THETAS[(kind, case)])
    want = jops.matvec_tangents(kind, jnp.asarray(theta), jnp.asarray(x1),
                                jnp.asarray(x2), jnp.asarray(v))
    got = tops.matvec_tangents(kind, _t(theta), _t(x1), _t(x2), _t(v))
    assert got.shape == (len(theta), 290, 4)
    for i in range(len(theta)):
        assert _relerr(got[i].numpy(), np.asarray(want)[i]) < 1e-10


@pytest.mark.parametrize("kind,case", CASES)
def test_plain_tile_matrix_matches_jax(kind, case):
    x1, x2, _ = _data(4, 270, 131, 1)
    theta = np.asarray(THETAS[(kind, case)])
    want = jops.matrix(kind, jnp.asarray(theta), jnp.asarray(x1),
                       jnp.asarray(x2))
    got = tops.matrix(kind, _t(theta), _t(x1), _t(x2))
    assert got.shape == (270, 131)
    assert _relerr(got.numpy(), want) < 1e-12


@pytest.mark.parametrize("kind,case", CASES)
def test_closed_form_derivatives_match_jax_jvp(kind, case):
    """Every natural-slot derivative of every family against jax.jvp of
    the JAX reference tile (ref.matrix_ref)."""
    x1, x2, _ = _data(5, 97, 83, 1)
    theta = np.asarray(THETAS[(kind, case)])
    p = np.asarray(jops.natural_params(kind, jnp.asarray(theta)))
    ns = tref.N_SLOTS[kind]
    pdots = np.eye(8)[:ns]
    got = tref.tangent_matrices_ref(kind, _t(p), _t(pdots), _t(x1), _t(x2))
    for s in range(ns):
        _, want = jax.jvp(lambda pp: jref.matrix_ref(kind, pp, x1, x2),
                          (jnp.asarray(p),), (jnp.asarray(pdots[s]),))
        assert _relerr(got[s].numpy(), want) < 1e-10


def test_wendland_derivative_is_zero_beyond_support():
    p = _t([100.0, 12.0, 1.5, 1, 1, 1, 1, 1])
    dt = _t([0.0, 50.0, 99.999, 100.0, 150.0, -150.0])
    k, g = tref.tile_grad("k1", dt, p)
    assert torch.all(k[3:] == 0) and torch.all(g[3:] == 0)
    assert g[0, 0] == 0          # dW/dT0 vanishes at dt = 0
    assert torch.all(g[1:3, 0] > 0)  # a longer window raises k inside


def test_wrappers_refuse_mixed_devices_and_dtypes():
    x, _, v = _data(6, 10, 10, 2)
    p = torch.ones(8, dtype=torch.float64)
    with pytest.raises(TypeError):
        tkm.tile_matvec("se", p.float(), _t(x), _t(x), _t(v))
    with pytest.raises(ValueError):
        tkm.tile_matvec("se", p, _t(x), _t(x), _t(v)[:5])
    with pytest.raises(ValueError):
        tkt.tile_matrix("nope", p, _t(x), _t(x))
