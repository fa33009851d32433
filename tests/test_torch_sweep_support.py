"""The support skip of B1 and B12 (``csrc/value_sweep.cuh``) through its
Python twin ``kernel_matvec.support_tiles``, against the dense covariance
of both packages: every (stripe, tile) pair the kernel drops must hold only
exact zeros, in the port's ``ref.matrix_ref`` and in the JAX package's
``repro.kernels.ref.matrix_ref`` alike, for k1 and k2 at windows of 4, 200
and 2000 h, on sorted and unsorted points and ragged sizes; the kinds
without a window keep every pair; and the bound's in-support count
(``support_entries``) is the number of nonzero entries.

Inputs are made from numpy seeds and handed to both packages; the
comparisons are exact (a skipped term must be 0, not small)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
# the window T0 (h) at the box's lower edge, the irregular cell's truth
# and the box's upper edge; periods and smoothness as in that cell
WINDOWS = (4.0, 200.0, 2000.0)
REST = {"k1": [np.log(12.42), -0.19],
        "k2": [np.log(12.42), -0.19, np.log(24.0), -0.1]}
# (n1, n2): no multiple of the 64-row stripe or the 32-column tile
SHAPES = ((333, 301), (1000, 1001), (65, 33))


def _theta(kind, t0):
    return np.array([np.log(t0)] + REST[kind])


def _points(seed, n1, n2, order):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0.0, SPAN, n1)
    x2 = rng.uniform(0.0, SPAN, n2)
    if order == "sorted":
        x1, x2 = np.sort(x1), np.sort(x2)
    return x1, x2


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _kept_mask(kind, p, x1, x2):
    s1 = -(-x1.shape[0] // tkm.VALUE_ROWS)
    s2 = -(-x2.shape[0] // tkm.VALUE_COLS)
    mask = torch.zeros((s1, s2), dtype=torch.bool)
    pairs = tkm.support_tiles(kind, p, x1, x2)
    mask[pairs[:, 0], pairs[:, 1]] = True
    return mask


def _dropped_blocks(mask, K):
    """Each dropped pair's block of K (rows of its stripe, columns of its
    tile)."""
    r, c = tkm.VALUE_ROWS, tkm.VALUE_COLS
    for s, t in (~mask).nonzero().tolist():
        yield K[s * r:(s + 1) * r, t * c:(t + 1) * c]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("t0", WINDOWS)
@pytest.mark.parametrize("kind", ["k1", "k2"])
def test_dropped_tiles_hold_only_zeros(kind, t0, order, shape):
    """No pair the kernel skips holds a nonzero entry of K, in either
    package; on sorted points at a 200 h window most pairs go."""
    n1, n2 = shape
    x1, x2 = _points(int(t0) + n1, n1, n2, order)
    theta = _theta(kind, t0)
    p = tops.natural_params(kind, _t(theta))
    mask = _kept_mask(kind, p, _t(x1), _t(x2))
    K_port = tref.matrix_ref(kind, p, _t(x1), _t(x2)).numpy()
    K_jax = np.asarray(jref.matrix_ref(
        kind, jops.natural_params(kind, jnp.asarray(theta)),
        jnp.asarray(x1), jnp.asarray(x2)))
    dropped = int((~mask).sum())
    for K in (K_port, K_jax):
        for block in _dropped_blocks(mask, K):
            assert not np.any(block), "a skipped tile holds a nonzero entry"
    if order == "sorted" and t0 == 200.0 and n1 >= 333:
        assert dropped > 0.6 * mask.numel()


@pytest.mark.parametrize("kind", ["se", "matern12", "matern32", "matern52"])
def test_kinds_without_a_window_keep_every_pair(kind):
    x1, x2 = _points(5, 333, 301, "sorted")
    p = tops.natural_params(kind, _t([np.log(4.0)]))
    mask = _kept_mask(kind, p, _t(x1), _t(x2))
    assert bool(mask.all())
    assert tkm.support_entries(kind, p, _t(x1), _t(x2)) == 333 * 301


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("t0", WINDOWS)
@pytest.mark.parametrize("kind", ["k1", "k2"])
def test_support_entries_count_the_nonzero_entries(kind, t0, order):
    """The bound's in-support count is the number of nonzero entries of
    the dense K (its row chunking changes nothing)."""
    x1, x2 = _points(17, 1000, 1001, order)
    p = tops.natural_params(kind, _t(_theta(kind, t0)))
    K = tref.matrix_ref(kind, p, _t(x1), _t(x2))
    want = int((K != 0).sum())
    assert tkm.support_entries(kind, p, _t(x1), _t(x2)) == want
    assert tkm.support_entries(kind, p, _t(x1), _t(x2), row_chunk=77) == want


@pytest.mark.parametrize("bad", [np.nan, np.inf, 1e308])
def test_points_beyond_the_finite_range_skip_nothing_in_their_tiles(bad):
    """A stripe or tile holding a nan, an inf or a value whose differences
    could overflow is never skipped; the others still are."""
    x1, x2 = _points(3, 333, 301, "sorted")
    x1[70] = bad    # stripe 1
    x2[40] = bad    # tile 1
    p = tops.natural_params("k2", _t(_theta("k2", 200.0)))
    mask = _kept_mask("k2", p, _t(x1), _t(x2))
    assert bool(mask[1, :].all()) and bool(mask[:, 1].all())
    assert not bool(mask.all())


def test_skip_rule_reads_the_window_from_params():
    """Only params[0] (T0) sets the window: the periods and smoothness do
    not move the kept pairs, and a wider window keeps a superset."""
    x1, x2 = _points(9, 1000, 1001, "sorted")
    masks = {}
    for t0 in WINDOWS:
        for rest in ([np.log(12.42), -0.19], [np.log(3.0), 0.4]):
            p = tops.natural_params("k1", _t([np.log(t0)] + rest))
            masks.setdefault(t0, []).append(
                _kept_mask("k1", p, _t(x1), _t(x2)))
    for t0 in WINDOWS:
        assert torch.equal(masks[t0][0], masks[t0][1])
    assert bool((masks[4.0][0] <= masks[200.0][0]).all())
    assert bool((masks[200.0][0] <= masks[2000.0][0]).all())
