"""The batched bank's modules against the JAX package on the same numpy
inputs: ``pad_boxes``, ``BankOperator`` (matvec, tangents, circulant
apply, SLQ accessors), the masked-circulant bank preconditioner, the bank
CG with its per-column freeze, the bank SLQ log-determinants under the
random seam of ``test_torch_session.py``, the bank objective and its
central-difference Hessians, and B7's plain version against the JAX
package's fused bank kernel in interpret mode.  The slice as a whole is
in ``test_torch_bank_workflow.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import SolverOpts as JSolverOpts
from repro.core.reparam import FlatBox as JFlatBox
from repro.gp import batch as jbatch
from repro.gp.spec import pad_boxes as jpad_boxes
from repro.kernels import operators as jopers
import repro_torch.random as rnd
from repro_torch.core import iterative as it
from repro_torch.core.engine import SolverOpts
from repro_torch.core.reparam import FlatBox
from repro_torch.gp import batch as tbatch
from repro_torch.gp.spec import pad_boxes
from repro_torch.kernels import operators as topers
from repro_torch.kernels import ski_fused as tsf

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


SIGMA_N = 0.1
JITTER = 1e-8
H = 2.0                       # the two-hour tidal cadence
THETAS = {
    "k1": [np.log(60.0), np.log(12.4), 0.1],
    "k2": [np.log(80.0), np.log(12.4), 0.05, np.log(24.0), -0.1],
    "se": [np.log(8.0)],
}
# bank members (mixed families; a repeated family gets another point)
MEMBERS = {1: ("k2",), 3: ("k1", "k2", "se"), 4: ("k2", "se", "k1", "k2")}


def _t(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _gappy(n_full=500, drop=0.1, seed=0):
    """A two-hour record with outages: near-grid, W a selection matrix."""
    rng = np.random.default_rng(seed)
    x = H * np.arange(n_full, dtype=np.float64)
    return x[rng.uniform(size=n_full) >= drop]


def _exact(n=400):
    return H * np.arange(n, dtype=np.float64)


SAMPLINGS = {"gappy": _gappy, "exact": _exact}


def _thetas(kinds):
    """(B, m_max) padded theta bank; the j-th repeat of a family moves
    its first timescale by 0.2 j."""
    m_max = max(len(THETAS[k]) for k in kinds)
    out = np.zeros((len(kinds), m_max))
    for b, k in enumerate(kinds):
        th = np.array(THETAS[k])
        th[0] += 0.2 * kinds[:b].count(k)
        out[b, :th.size] = th
    return out


def _banks(x, kinds, **kw):
    return (jbatch.BankOperator(kinds, jnp.asarray(x), SIGMA_N, JITTER,
                                **kw),
            tbatch.BankOperator(kinds, _t(x), SIGMA_N, JITTER))


def test_pad_boxes_matches_jax():
    boxes = [(np.array([0.5, 1.0, -0.5]), np.array([6.0, 3.0, 0.5])),
             (np.array([2.0]), np.array([4.0]))]
    want = jpad_boxes([JFlatBox(jnp.asarray(lo), jnp.asarray(hi))
                       for lo, hi in boxes], 5)
    got = pad_boxes([FlatBox(_t(lo), _t(hi)) for lo, hi in boxes], 5)
    np.testing.assert_array_equal(got.lo.numpy(), np.asarray(want.lo))
    np.testing.assert_array_equal(got.hi.numpy(), np.asarray(want.hi))
    assert got.lo.shape == (2, 5) and float(got.hi[1, 4]) == 1.0


@pytest.mark.parametrize("B", sorted(MEMBERS))
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_bank_operator_matches_jax(sampling, B):
    """matvec, tangents, circulant apply and SLQ accessors of the bank
    (the port's near-grid bank through B7's plain version)."""
    x = SAMPLINGS[sampling]()
    kinds = MEMBERS[B]
    jb, tb = _banks(x, kinds)
    assert tb.structure == jb.structure == \
        ("near" if sampling == "gappy" else "exact")
    assert (tb.m_grid, tb.L) == (jb.m_grid, jb.L)
    assert tb.fused == (sampling == "gappy") and not jb.fused
    th = _thetas(kinds)
    jt, tt = jnp.asarray(th), _t(th)
    V = np.random.default_rng(B).standard_normal((x.size, B, 3))
    got = tb.bind_matvec(tt, torch.float64)(_t(V)).numpy()
    assert _rel(got, jb.bind_matvec(jt, jnp.float64)(V)) < 1e-10
    got = tb.bind_tangent_matvecs(tt, torch.float64)(_t(V)).numpy()
    want = np.asarray(jb.bind_tangent_matvecs(jt, jnp.float64)(V))
    assert got.shape == want.shape == (x.size, B, th.shape[1], 3)
    for b, k in enumerate(kinds):            # padded directions are zero
        m_k = len(THETAS[k])
        assert _rel(got[:, b, :m_k], want[:, b, :m_k]) < 1e-10
        assert not np.any(got[:, b, m_k:])
    got = tb.bind_precond(tt, torch.float64)(_t(V)).numpy()
    assert _rel(got, jb.bind_precond(jt, jnp.float64)(V)) < 1e-10
    jslq = jb.bind_slq_precond(jt, jnp.float64)
    tslq = tb.bind_slq_precond(tt, torch.float64)
    assert _rel(tslq.apply_inv(_t(V)).numpy(), jslq.apply_inv(V)) < 1e-10
    assert _rel(tslq.logdet.numpy(), jslq.logdet) < 1e-10
    for opts in (dict(), dict(precond="circulant"), dict(precond="auto"),
                 dict(precond_rank=8)):
        assert tb.resolve_precond(SolverOpts(**opts)) \
            == jb.resolve_precond(JSolverOpts(**opts))


def test_bank_geometry_is_shared_and_the_fused_decision_inherited():
    x = _gappy()
    tb = tbatch.BankOperator(("k1", "k2"), _t(x), SIGMA_N, JITTER,
                             fused=False)
    like = tbatch.BankOperator(("se",), _t(x), SIGMA_N, JITTER, like=tb)
    assert like.idx is tb.idx and like.fused_geom is tb.fused_geom
    assert like.fused is False and like.B == 1
    assert tbatch.BankOperator(("se",), _t(x), SIGMA_N, JITTER,
                               like=tb, fused=True).fused is True
    with pytest.raises(ValueError, match="irregular"):
        tbatch.BankOperator(("se", "k1"), _t(np.sort(
            np.random.default_rng(0).uniform(0, 900, 300))), SIGMA_N,
            JITTER)


def test_masked_circulant_bank_matches_jax():
    rng = np.random.default_rng(5)
    m, B = 40, 3
    lams = 1.0 + rng.uniform(size=(B, m))
    lams = 0.5 * (lams + lams[:, (-np.arange(m)) % m])      # real, even
    occ = np.sort(rng.choice(m, 31, replace=False))
    want = jopers.masked_circulant_slq_precond_bank(jnp.asarray(lams), occ)
    got = topers.masked_circulant_slq_precond_bank(_t(lams), occ)
    R = rng.standard_normal((occ.size, B, 2))
    assert _rel(got.apply_inv(_t(R)).numpy(), want.apply_inv(R)) < 1e-10
    assert _rel(got.logdet.numpy(), want.logdet) < 1e-10
    # each member alone is the single-operator preconditioner
    for b in range(B):
        one = topers.masked_circulant_slq_precond(_t(lams[b]), occ)
        assert abs(float(one.logdet) - float(got.logdet[b])) \
            < 1e-12 * abs(float(one.logdet))
    # the refusals: too many missing cells, duplicate cells
    assert topers.masked_circulant_slq_precond_bank(_t(lams), occ,
                                                    max_miss=4) is None
    assert jopers.masked_circulant_slq_precond_bank(
        jnp.asarray(lams), occ, max_miss=4) is None
    assert topers.masked_circulant_slq_precond_bank(
        _t(lams), np.array([1, 1, 2])) is None


def test_bank_cg_freezes_converged_columns():
    """A member whose K is near the identity converges long before the
    others: its column freezes, and every column matches the JAX bank CG
    (both with the bank circulant preconditioner) and a solve of that
    column alone."""
    x = _gappy()
    kinds = ("k2", "se", "k1")
    th = _thetas(kinds)
    th[1, 0] = np.log(0.05)            # se much shorter than the cadence
    jb, tb = _banks(x, kinds)
    rhs = np.random.default_rng(3).standard_normal((x.size, 3, 2))
    jt, tt = jnp.asarray(th), _t(th)
    want = jbatch.bank_cg(jb.bind_matvec(jt, jnp.float64), jnp.asarray(rhs),
                          tol=1e-10, max_iter=3000,
                          precond=jb.bind_precond(jt, jnp.float64))
    got = tbatch.bank_cg(tb.bind_matvec(tt, torch.float64), _t(rhs),
                         tol=1e-10, max_iter=3000,
                         precond=tb.bind_precond(tt, torch.float64))
    assert got.iters == int(want.iters)
    assert _rel(got.x.numpy(), want.x) < 1e-10
    assert float(got.resnorm.max()) <= 1e-10
    alone = tbatch.BankOperator(("se",), _t(x), SIGMA_N, JITTER, like=tb)
    solo = tbatch.bank_cg(alone.bind_matvec(tt[1:2], torch.float64),
                          _t(rhs[:, 1:2]), tol=1e-10, max_iter=3000,
                          precond=alone.bind_precond(tt[1:2], torch.float64))
    assert solo.iters < got.iters / 4
    np.testing.assert_array_equal(solo.x.numpy(), got.x[:, 1:2].numpy())


def test_bank_cg_counts_one_stop_per_member():
    """CG_STOPS counts each member's (n, c) solve once: cut at max_iter
    when one of its columns is above the tolerance, at the tolerance
    otherwise, also when the shared loop ran to max_iter."""
    x = _gappy()
    kinds = ("k2", "se", "k1")
    th = _thetas(kinds)
    th[1, 0] = np.log(0.05)
    _, tb = _banks(x, kinds)
    tt = _t(th)
    rhs = _t(np.random.default_rng(3).standard_normal((x.size, 3, 2)))
    mv, pc = tb.bind_matvec(tt, torch.float64), tb.bind_precond(
        tt, torch.float64)
    it.reset_cg_stops()
    full = tbatch.bank_cg(mv, rhs, tol=1e-10, max_iter=3000, precond=pc)
    assert (it.CG_STOPS["tol"], it.CG_STOPS["max_iter"]) == (3, 0)
    se = tbatch.BankOperator(("se",), _t(x), SIGMA_N, JITTER, like=tb)
    solo = tbatch.bank_cg(se.bind_matvec(tt[1:2], torch.float64),
                          rhs[:, 1:2].contiguous(), tol=1e-10,
                          max_iter=3000,
                          precond=se.bind_precond(tt[1:2], torch.float64))
    assert solo.iters < full.iters
    it.reset_cg_stops()
    tbatch.bank_cg(mv, rhs, tol=1e-10, max_iter=solo.iters, precond=pc)
    assert (it.CG_STOPS["tol"], it.CG_STOPS["max_iter"]) == (1, 2)
    assert it.CG_WORST_RESIDUAL[0] > 1e-10
    it.reset_cg_stops()


@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_bank_slq_logdets_match_jax_with_the_same_probes(jax_random,
                                                         sampling):
    x = SAMPLINGS[sampling](300)
    kinds = MEMBERS[3]
    jb, tb = _banks(x, kinds)
    th = _thetas(kinds)
    jt, tt = jnp.asarray(th), _t(th)
    jmv = jb.bind_matvec(jt, jnp.float64)
    tmv = tb.bind_matvec(tt, torch.float64)
    n = x.size
    want = jbatch.bank_slq_logdet(jmv, n, 3, jax.random.key(2), n_probes=4,
                                  k=16)
    got = tbatch.bank_slq_logdet(tmv, n, 3, rnd.key(2), n_probes=4, k=16)
    assert _rel(got.numpy(), want) < 1e-8
    want = jbatch.bank_slq_logdet_precond(
        jmv, jb.bind_slq_precond(jt, jnp.float64), n, 3, jax.random.key(5),
        n_probes=4, k=16)
    got = tbatch.bank_slq_logdet_precond(
        tmv, tb.bind_slq_precond(tt, torch.float64), n, 3, rnd.key(5),
        n_probes=4, k=16)
    assert _rel(got.numpy(), want) < 1e-8


OBJ_OPTS = dict(n_probes=4, lanczos_k=16, cg_tol=1e-12, cg_max_iter=4000,
                precond="circulant")


def test_bank_objective_and_fd_hessians_match_jax(jax_random):
    """Values, gradients and (from them) the central-difference Hessians
    of the bank objective.  The Hessian divides two gradients' agreement
    by 2 fd_step = 2e-4, so it is held to 1e-6."""
    x = _gappy(400)
    y = np.sin(2 * np.pi * x / 12.42) \
        + SIGMA_N * np.random.default_rng(6).standard_normal(x.size)
    kinds = ("k1", "se", "k1")
    th = _thetas(kinds)
    jb, tb = _banks(x, kinds)
    lo, hi = th - 1.0, th + 1.0
    jobj = jbatch.make_bank_objective(
        jb, JFlatBox(jnp.asarray(lo), jnp.asarray(hi)), jnp.asarray(y),
        jax.random.key(9), JSolverOpts(**OBJ_OPTS))
    tobj = tbatch.make_bank_objective(
        tb, FlatBox(_t(lo), _t(hi)), _t(y), rnd.key(9),
        SolverOpts(**OBJ_OPTS))
    jlp, jg = jobj.value_and_grad_theta(jnp.asarray(th))
    tlp, tg = tobj.value_and_grad_theta(_t(th))
    assert _rel(tlp.numpy(), jlp) < 1e-10
    assert _rel(tg.numpy(), jg) < 1e-8
    assert not np.any(tg.numpy()[1, 1:])        # padded directions
    jf, jgz = jobj.value_and_grad_z(jnp.zeros_like(jnp.asarray(th)))
    tf, tgz = tobj.value_and_grad_z(torch.zeros_like(_t(th)))
    assert _rel(tf.numpy(), jf) < 1e-10 and _rel(tgz.numpy(), jgz) < 1e-8
    assert _rel(tobj.value_z(torch.zeros_like(_t(th))).numpy(),
                jobj.value_z(jnp.zeros_like(jnp.asarray(th)))) < 1e-10
    assert _rel(tobj.sigma2_theta(_t(th)).numpy(),
                jobj.sigma2_theta(jnp.asarray(th))) < 1e-10
    want = jbatch.bank_fd_hessians(jobj.value_and_grad_theta,
                                   jnp.asarray(th))
    got = tbatch.bank_fd_hessians(tobj.value_and_grad_theta, _t(th))
    assert got.shape == (3, 3, 3)
    assert _rel(got.numpy(), want) < 1e-6
    np.testing.assert_array_equal(got.numpy(), got.transpose(1, 2).numpy())


@pytest.mark.parametrize("c", [1, 3, 4])
def test_fused_bank_plain_matches_the_jax_kernel_in_interpret_mode(c):
    """B7's plain version against the JAX package's fused Pallas bank
    kernel (interpret mode on the CPU), which pairs columns across
    members at odd c (its Hermitian straddle); the port packs within a
    member and computes the same function."""
    x = _gappy(150)
    kinds = MEMBERS[3]
    jb, tb = _banks(x, kinds, fused=True)
    assert jb.fused and tb.fused
    th = _thetas(kinds)
    V = np.random.default_rng(c).standard_normal((x.size, 3, c))
    want = jb.bind_matvec(jnp.asarray(th), jnp.float64)(jnp.asarray(V))
    got = tb.bind_matvec(_t(th), torch.float64)(_t(V)).numpy()
    assert _rel(got, want) < 1e-10
    # and member by member, B7's plain version is B5's
    geom = tb.fused_geom
    lams = tsf.spectrum(tb.first_columns(_t(th), torch.float64), geom)
    for b in range(3):
        one = tsf.fused_gram_matvec_plain(geom, lams[b], tb.noise2,
                                          _t(V[:, b]))
        assert _rel(got[:, b], one.numpy()) < 1e-13
