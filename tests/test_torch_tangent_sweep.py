"""B2's and B3's kernels (``csrc/tangent_sweep.cuh``) on the CPU: the
Wendland-support skip they share with B1, and B2's order of work (the
kind's gradient slots contracted with V first, the directions applied to
the slot sums), held against the dense closed-form derivatives of both
packages; and the port's B2 and B3 plain versions against the JAX
package's Pallas kernels (interpret mode) where the window drops tiles.

The skip's twin is ``kernel_matvec.support_tiles`` with the stripe heights
the two kernels run on (64 rows, and 32 for B2 where a row's gradient
slots times b exceed 16 accumulators) and the value sweep's 32-column
tile.  Inputs are made from numpy seeds and handed to both packages; the
skip's comparisons are exact (a skipped term must be 0, not small)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kernel_matvec as jkm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import kernel_matvec as tkm
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


SPAN = 8760.0
# the window T0 (h) at the fit box's lower edge, the irregular cell's
# truth and the box's upper edge; periods and smoothness as in that cell
WINDOWS = (4.0, 200.0, 2000.0)
REST = {"k1": [np.log(12.42), -0.19],
        "k2": [np.log(12.42), -0.19, np.log(24.0), -0.1]}
OTHER = {"se": [np.log(40.0)], "matern12": [np.log(40.0)],
         "matern32": [np.log(40.0)], "matern52": [np.log(40.0)]}
KINDS = ("k1", "k2", "se", "matern12", "matern32", "matern52")
STRIPES = (tkm.VALUE_ROWS, 32)


def _theta(kind, t0=200.0):
    if kind in REST:
        return np.array([np.log(t0)] + REST[kind])
    return np.array(OTHER[kind])


def _points(seed, n1, n2, order="sorted"):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0.0, SPAN, n1)
    x2 = rng.uniform(0.0, SPAN, n2)
    if order == "sorted":
        x1, x2 = np.sort(x1), np.sort(x2)
    return x1, x2


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _relerr(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("rows", STRIPES)
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("t0", WINDOWS)
@pytest.mark.parametrize("kind", ["k1", "k2"])
def test_dropped_tiles_hold_only_zero_derivatives(kind, t0, order, rows):
    """No (stripe, tile) pair the kernels skip holds a nonzero derivative
    of K in any natural slot, in the port's closed form and in jax.jvp of
    the JAX package's reference tile; on sorted points at a 200 h window
    most pairs go."""
    x1, x2 = _points(int(t0) + rows, 333, 301, order)
    theta = _theta(kind, t0)
    p = tops.natural_params(kind, _t(theta))
    ns = tref.N_SLOTS[kind]
    eye = np.eye(8)[:ns]
    slots = tref.tangent_matrices_ref(kind, p, _t(eye), _t(x1),
                                      _t(x2)).numpy()
    jp = jops.natural_params(kind, jnp.asarray(theta))
    jax_slots = np.stack([np.asarray(jax.jvp(
        lambda pp: jref.matrix_ref(kind, pp, jnp.asarray(x1),
                                   jnp.asarray(x2)),
        (jp,), (jnp.asarray(eye[s]),))[1]) for s in range(ns)])
    s1, s2 = -(-333 // rows), -(-301 // tkm.VALUE_COLS)
    mask = torch.zeros((s1, s2), dtype=torch.bool)
    pairs = tkm.support_tiles(kind, p, _t(x1), _t(x2), rows, tkm.VALUE_COLS)
    mask[pairs[:, 0], pairs[:, 1]] = True
    c = tkm.VALUE_COLS
    for g in (slots, jax_slots):
        for s, t in (~mask).nonzero().tolist():
            block = g[:, s * rows:(s + 1) * rows, t * c:(t + 1) * c]
            assert not np.any(block), "a skipped tile holds a derivative"
    if order == "sorted" and t0 == 200.0:
        assert int((~mask).sum()) > 0.6 * mask.numel()


@pytest.mark.parametrize("pdots", ["natural", "dense"])
@pytest.mark.parametrize("kind", KINDS)
def test_slot_sums_then_directions_match_per_entry_directions(kind, pdots):
    """B2 contracts the kind's NS gradient slots with V and applies the m
    directions to the (NS, n1, b) slot sums once; that equals projecting
    every entry on each direction first (the plain version), to 1e-13,
    for the natural tangents of the main path and for dense pdots."""
    x1, x2 = _points(7, 300, 277)
    rng = np.random.default_rng(8)
    v = _t(rng.standard_normal((277, 9)))
    theta = _t(_theta(kind))
    p = tops.natural_params(kind, theta)
    if pdots == "natural":
        pd = tops.natural_tangents(kind, theta)
    else:
        pd = _t(rng.standard_normal((5, 8)))
    ns = tref.N_SLOTS[kind]
    _, g = tref.tile_grad(kind, _t(x1)[:, None] - _t(x2)[None, :], p)
    sums = torch.einsum("rcs,cb->srb", g, v)
    got = torch.einsum("ms,srb->mrb", pd[:, :ns], sums)
    want = tkm.tile_stacked_tangent_matvec_plain(kind, p, pd, _t(x1),
                                                 _t(x2), v)
    assert got.shape == want.shape == (pd.shape[0], 300, 9)
    assert _relerr(got, want) < 1e-13


@pytest.mark.parametrize("kind", ["k1", "k2"])
def test_plain_tangents_match_the_jax_kernels_where_the_window_drops_tiles(
        kind):
    """The port's B2 and B3 plain versions (what their wrappers take on
    the CPU) against JAX's matvec_stacked_tangent_pallas and
    matvec_tangent_pallas (interpret mode) at a 200 h window, where the
    kernels' skip drops most (stripe, tile) pairs."""
    x1, x2 = _points(11, 512, 512)
    rng = np.random.default_rng(12)
    v = rng.standard_normal((512, 3))
    theta = _theta(kind)
    p = tops.natural_params(kind, _t(theta))
    pd = tops.natural_tangents(kind, _t(theta))
    pdot = _t(rng.standard_normal(len(theta))) @ pd
    pairs = tkm.support_tiles(kind, p, _t(x1), _t(x2))
    assert pairs.shape[0] < 0.5 * (512 // tkm.VALUE_ROWS) * (
        512 // tkm.VALUE_COLS)
    jp = jops.natural_params(kind, jnp.asarray(theta))
    jpd = jops.natural_tangents(kind, jnp.asarray(theta))
    want = jkm.matvec_stacked_tangent_pallas(
        kind, jp, jpd, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(v),
        interpret=True)
    got = tkm.tile_stacked_tangent_matvec(kind, p, pd, _t(x1), _t(x2), _t(v))
    assert got.shape == (len(theta), 512, 3)
    assert _relerr(got, want) < 1e-10
    want = jkm.matvec_tangent_pallas(
        kind, jp, jnp.asarray(pdot.numpy()), jnp.asarray(x1),
        jnp.asarray(x2), jnp.asarray(v), interpret=True)
    got = tkm.tile_jvp(kind, p, pdot, _t(x1), _t(x2), _t(v))
    assert _relerr(got, want) < 1e-10
