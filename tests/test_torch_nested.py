"""The nested-sampling baseline (``repro_torch.core.nested``) against the
JAX package's ``repro.core.nested``.

Under the random seam (``jax_random``: every port draw replayed with
``jax.random`` on its key's path) the port's sampler sees the JAX
package's start points, chain starts and proposals, so the two runs take
the same steps: ln Z, its error and H agree to rounding, with the same
iterations and evaluations.  With its own draws the port is held to the
analytic evidences of ``tests/test_nested.py``.  Also: the GP integrand
(eq. 2.18) on the dense and iterative backends, the front door
(``GP.log_evidence(method="nested")``, ``compare(run_nested=True)``), the
key's cost at depth, and the twins of the paper's two nested scripts.
"""

import importlib.util
import math
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.stats import norm

from repro import gp as jgp
from repro.core import covariances as JC
from repro.core import laplace as jlap
from repro.core import nested as jnested
from repro.core import reparam as JR
from repro.core.engine import SolverOpts as JSolverOpts
import repro_torch.random as rnd
from repro_torch import gp as tgp
from repro_torch.core import covariances as TC
from repro_torch.core import nested as tnested
from repro_torch.core import reparam as TR
from repro_torch.core.engine import SolverOpts

from test_torch_dense_workflow import _jitted_evidence
from test_torch_session import OPTS, jax_random  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run several pytest workers on one machine; torch's CPU
    thread pool in each of them oversubscribes the cores (tens of times
    slower), so each module runs torch on one thread and restores it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = pathlib.Path(__file__).resolve().parent.parent
REPLAY_TOL = 1e-10
SESSION_TOL = 1e-8


def _rel(got, want):
    return abs(float(got) - float(want)) / max(1.0, abs(float(want)))


# ---------------------------------------------------------------------------
# The toys: a Gaussian in the unit box (d = 3) and a two-component mixture
# ---------------------------------------------------------------------------

def _toy(mod, d):
    return mod.Covariance(name=f"toy{d}",
                          param_names=tuple(f"p{i}" for i in range(d)),
                          fn=None)


def _gauss(d, s, mu=0.4):
    """(JAX ln L of one theta, port ln L of a (B, d) batch, ln Z)."""
    jmu = jnp.full(d, mu)

    def jlog_l(t):
        return (-0.5 * jnp.sum((t - jmu) ** 2) / s**2
                - 0.5 * d * jnp.log(2 * jnp.pi * s**2))

    def tlog_l(t):
        return (-0.5 * torch.sum((t - mu) ** 2, dim=-1) / s**2
                - 0.5 * d * math.log(2 * math.pi * s**2))

    true = float(jnp.sum(jnp.log(norm.cdf((1 - jmu) / s)
                                 - norm.cdf(-jmu / s))))
    return jlog_l, tlog_l, true


def _bimodal(s=0.03):
    d = 2
    jmus = jnp.array([[0.25, 0.25], [0.75, 0.75]])
    tmus = torch.tensor(np.asarray(jmus))

    def jlog_l(t):
        comps = jnp.stack([-0.5 * jnp.sum((t - m) ** 2) / s**2
                           for m in jmus])
        return (jax.scipy.special.logsumexp(comps) + jnp.log(0.5)
                - d * 0.5 * jnp.log(2 * jnp.pi * s**2))

    def tlog_l(t):
        comps = -0.5 * torch.sum((t[:, None, :] - tmus) ** 2, dim=-1) / s**2
        return (torch.logsumexp(comps, dim=-1) + math.log(0.5)
                - d * 0.5 * math.log(2 * math.pi * s**2))

    return jlog_l, tlog_l, 0.0


TOYS = {"gauss3": (3, lambda: _gauss(3, 0.05), 0),
        "bimodal": (2, _bimodal, 1)}


def _boxes(d):
    return (JR.FlatBox(jnp.zeros(d), jnp.ones(d)),
            TR.FlatBox(torch.zeros(d, dtype=torch.float64),
                       torch.ones(d, dtype=torch.float64)))


@pytest.mark.parametrize("toy", list(TOYS))
def test_nested_sample_replays_jax(toy, jax_random):
    """Run to termination at n_live = 100 on the JAX package's draws: the
    same iterations and evaluations, ln Z, its error and H to rounding."""
    d, make, seed = TOYS[toy]
    jlog_l, tlog_l, _ = make()
    jbox, tbox = _boxes(d)
    want = jax.jit(lambda k: jnested.nested_sample(
        k, jlog_l, _toy(JC, d), jbox, n_live=100, max_iter=15000))(
            jax.random.key(seed))
    got = tnested.nested_sample(rnd.key(seed), tlog_l, _toy(TC, d), tbox,
                                n_live=100, max_iter=15000)
    assert got.n_iters == int(want.n_iters) < 15000
    assert got.n_evals == int(want.n_evals)
    for field in ("log_z", "log_z_err", "h_info"):
        assert _rel(getattr(got, field), getattr(want, field)) \
            <= REPLAY_TOL, field


@pytest.mark.parametrize("d,s", [(3, 0.05), (5, 0.08)])
def test_gaussian_box_evidence_on_the_ports_draws(d, s):
    """The port's own draws (no replay): the analytic evidence of a
    Gaussian in the unit box to within the quoted error bar."""
    _, tlog_l, true = _gauss(d, s)
    _, tbox = _boxes(d)
    res = tnested.nested_sample(rnd.key(0), tlog_l, _toy(TC, d), tbox,
                                n_live=200, max_iter=15000)
    err = max(float(res.log_z_err), 0.08)
    assert abs(float(res.log_z) - true) < 3.5 * err, \
        (float(res.log_z), true, err)


def test_bimodal_evidence_on_the_ports_draws():
    _, tlog_l, true = _bimodal()
    _, tbox = _boxes(2)
    res = tnested.nested_sample(rnd.key(1), tlog_l, _toy(TC, 2), tbox,
                                n_live=200, max_iter=15000)
    assert abs(float(res.log_z) - true) < 3.5 * max(float(res.log_z_err),
                                                    0.09)


def test_counts_evaluations():
    """n_live initial + n_chains x n_steps per iteration, and one host
    read per iteration after the first n_live."""
    from repro_torch import _sync

    _, tbox = _boxes(2)

    def log_l(t):
        return -0.5 * torch.sum((t - 0.5) ** 2, dim=-1) / 0.1**2

    _sync.reset()
    res = tnested.nested_sample(rnd.key(2), log_l, _toy(TC, 2), tbox,
                                n_live=100, max_iter=5000)
    assert res.n_evals == 100 + res.n_iters * 8 * 16
    assert 100 < res.n_iters < 5000
    assert _sync.COUNT["nested_iter"] == res.n_iters - 100 + 1
    small = tnested.nested_sample(rnd.key(2), log_l, _toy(TC, 2), tbox,
                                  n_live=16, n_chains=3, n_steps=2,
                                  max_iter=5)
    assert (small.n_iters, small.n_evals) == (5, 16 + 5 * 3 * 2)


def test_log_sub_exp():
    assert tnested._log_sub_exp(0.0, -1.0) == pytest.approx(
        math.log(1.0 - math.exp(-1.0)), rel=1e-15)
    assert tnested._log_sub_exp(-0.5, -0.5025) == pytest.approx(
        float(jnested._log_sub_exp(jnp.float64(-0.5), jnp.float64(-0.5025))),
        rel=1e-14)


# ---------------------------------------------------------------------------
# The keys: draws pinned before the key's hash state was carried, and depth
# ---------------------------------------------------------------------------

def _deep(seed, depth):
    k = rnd.key(seed)
    for i in range(depth):
        k = rnd.split(k, 3)[i % 3]
    return k


PINNED = {
    "root_normal": (lambda: rnd.normal(rnd.key(0), (3,), device="cpu"),
                    [-1.4952630677439331, 1.5878697711800245,
                     -0.01561966649967409]),
    "one_step_uniform": (lambda: rnd.uniform(rnd.split(rnd.key(7), 3)[2],
                                             (2, 2), device="cpu"),
                         [[0.8287497657755205, 0.07756136882709463],
                          [0.7625619344291078, 0.06924307464555968]]),
    "two_step_rademacher": (lambda: rnd.rademacher(
        rnd.fold_in(rnd.split(rnd.key(1))[1], 5), (6,), device="cpu"),
        [1.0, 1.0, -1.0, -1.0, -1.0, 1.0]),
    "fold_in_permutation": (lambda: rnd.permutation(
        rnd.fold_in(rnd.key(3), 2**40), 8, device="cpu"),
        [4, 2, 1, 7, 0, 3, 6, 5]),
    "six_steps_normal": (lambda: rnd.normal(rnd.fold_in(_deep(11, 5), -2),
                                            (2, 2), device="cpu"),
                         [[0.31393175213086255, 1.0051113913928198],
                          [2.856140994323781, 0.36515149528059215]]),
    "float32_uniform": (lambda: rnd.uniform(rnd.key(5), (3,), -1.0, 2.0,
                                            device="cpu",
                                            dtype=torch.float32),
                        [-0.13080263137817383, 1.3682758808135986,
                         -0.9905652403831482]),
}


@pytest.mark.parametrize("case", list(PINNED))
def test_existing_keys_draw_the_same_bits(case):
    """Draws of keys the port already used, taken before a key carried its
    hash state: equal to the bit (the card's reference numbers hang on
    them), and a key rebuilt from its path or pickled draws the same."""
    fn, want = PINNED[case]
    assert fn().tolist() == want
    k = _deep(11, 5)
    assert rnd.Key(k.seed, k.path).digest() == k.digest()
    import pickle

    assert pickle.loads(pickle.dumps(k)) == k


def test_a_deep_key_splits_and_draws_in_constant_time():
    """20000 splits deep (compare's default nested_max_iter): a draw
    costs what it costs at the root, and the path is still the record."""
    import hashlib

    k = rnd.key(3)
    t0 = time.perf_counter()
    for _ in range(20000):
        k, kp, _ = rnd.split(k, 3)
    split_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rnd.randint(kp, (8,), 0, 400, device="cpu")
    for j in range(16):
        rnd.normal(rnd.split(k)[0], (8, 5), device="cpu")
    draw_s = time.perf_counter() - t0
    assert draw_s < 0.01, draw_s
    assert split_s < 2.0, split_s
    assert len(k.path) == 20000
    assert k.digest() == hashlib.sha256(
        repr((k.seed, k.path)).encode()).digest()


# ---------------------------------------------------------------------------
# The GP integrand (eq. 2.18)
# ---------------------------------------------------------------------------

def _record(n=30, seed=4):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 60.0, n))
    y = (np.sin(2 * np.pi * x / 12.4) + 0.4 * np.sin(2 * np.pi * x / 5.0)
         + 0.1 * rng.standard_normal(n))
    return x, y


def test_dense_integrand_matches_jax_with_a_failed_cholesky():
    """Rows of theta through the batched dense integrand against JAX's
    per-theta one; a negative jitter leaves K indefinite at the smooth
    rows, whose Cholesky fails (-1e290 in both)."""
    x, y = _record()
    sigma_n, jitter = 1e-3, -1e-4
    thetas = np.array([[np.log(40.0), np.log(12.4), 0.0, np.log(30.0), 0.1],
                       [np.log(3.0), np.log(1.5), -0.3, np.log(2.0), 0.2],
                       [np.log(500.0), np.log(50.0), 0.4, np.log(60.0),
                        0.3],
                       [np.log(0.8), np.log(0.5), 0.0, np.log(0.9), -0.1]])
    jlog_l = jax.jit(jax.vmap(jnested.make_gp_marg_loglik(
        JC.K2, jnp.asarray(x), jnp.asarray(y), sigma_n, jitter=jitter)))
    want = np.asarray(jlog_l(jnp.asarray(thetas)))
    got = tnested.make_gp_marg_loglik(
        TC.resolve("k2"), torch.tensor(x), torch.tensor(y), sigma_n,
        jitter=jitter)(torch.tensor(thetas)).numpy()
    failed = want == -1e290
    assert failed.any() and not failed.all()
    np.testing.assert_array_equal(got == -1e290, failed)
    np.testing.assert_allclose(got[~failed], want[~failed], rtol=REPLAY_TOL,
                               atol=0)
    # without the negative jitter every row is finite, at the default one
    want = np.asarray(jax.jit(jax.vmap(jnested.make_gp_marg_loglik(
        JC.K2, jnp.asarray(x), jnp.asarray(y), 0.1)))(jnp.asarray(thetas)))
    got = tnested.make_gp_marg_loglik(
        TC.resolve("k2"), torch.tensor(x), torch.tensor(y), 0.1)(
            torch.tensor(thetas)).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=REPLAY_TOL, atol=0)


def test_iterative_integrand_matches_jax_with_the_same_probes(jax_random):
    """n = 512 irregular points on the tile operator, CG to its tolerance
    (test_torch_session's options): the port draws its two probe blocks
    once from the replayed key, JAX inside each evaluation."""
    x, y = _record(512, seed=6)
    x = x * 8.0
    sigma_n = 0.1
    thetas = np.array([[np.log(60.0), np.log(12.4), 0.0],
                       [np.log(200.0), np.log(24.0), 0.2],
                       [np.log(20.0), np.log(7.0), -0.2]])
    jkey = jax.random.key(9)
    jlog_l = jax.jit(jnested.make_gp_marg_loglik(
        JC.K1, jnp.asarray(x), jnp.asarray(y), sigma_n, jitter=1e-8,
        backend="iterative", key=jkey, solver_opts=JSolverOpts(**OPTS)))
    want = np.array([float(jlog_l(jnp.asarray(t))) for t in thetas])
    spec = tgp.GPSpec("k1", noise=tgp.NoiseModel(sigma_n),
                      solver=tgp.SolverPolicy(backend="iterative",
                                              opts=SolverOpts(**OPTS)))
    sess = tgp.GP.bind(spec, x, y, device="cpu")
    assert sess.operator_name == "pallas"
    log_l = tnested.make_gp_marg_loglik(
        sess.cov, sess.x, sess.y, sigma_n, jitter=sess.jitter,
        backend="iterative", key=rnd.key(9), solver_opts=spec.solver.opts,
        op=sess.op)
    got = log_l(torch.tensor(thetas)).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=0)


# ---------------------------------------------------------------------------
# The front door
# ---------------------------------------------------------------------------

NESTED_KW = dict(n_live=50, max_iter=150)
POLICY = dict(backend="dense", n_starts=2, max_iters=10, scan_points=32)
# the front door's record: t = 1..30 (the synthetic recipe's grid), and a
# box that keeps every window over a neighbour (T0 >= 3) and every
# smoothness l >= 0.7 (xi >= -0.25).  In the data-dependent box a short
# window or a small l zeroes every off-diagonal entry of K: ln P is then
# one value over a region of theta, and the values beside it differ from
# it by an ulp or two, computed otherwise by XLA and by LAPACK.  A chain
# that proposes there is accepted or not on those last bits (L > L* with
# L* that plateau), so a replay would test rounding, not the port.
BOXES = {"k1": ([math.log(3.0), math.log(2.0), -0.25],
                [math.log(29.0), math.log(30.0), 0.45]),
         "k2": ([math.log(3.0), math.log(2.0), -0.25, math.log(2.0), -0.25],
                [math.log(29.0), math.log(30.0), 0.45, math.log(30.0),
                 0.45])}


def _front_door_record():
    rng = np.random.default_rng(4)
    x = np.arange(1.0, 31.0)
    y = (np.sin(2 * np.pi * x / 12.4) + 0.4 * np.sin(2 * np.pi * x / 5.0)
         + 0.1 * rng.standard_normal(30))
    return x, y


@pytest.fixture(scope="module")
def ref():
    """The JAX session's nested evidence and compare(run_nested=True) on
    the n = 30 record (its dense Laplace stage under one jax.jit)."""
    x, y = _front_door_record()
    orig = jlap._evidence_profiled_impl
    jlap._evidence_profiled_impl = _jitted_evidence(orig)
    try:
        specs = [jgp.GPSpec(k, box=JR.FlatBox(*map(jnp.asarray, BOXES[k])),
                            noise=jgp.NoiseModel(0.1),
                            solver=jgp.SolverPolicy(**POLICY))
                 for k in ("k1", "k2")]
        ns = jgp.GP.bind(specs[1], x, y).log_evidence(
            method="nested", key=jax.random.key(11), **NESTED_KW)
        reports = jgp.compare(specs, x, y, key=jax.random.key(5),
                              run_nested=True, batch="off",
                              n_live=NESTED_KW["n_live"],
                              nested_max_iter=NESTED_KW["max_iter"])
    finally:
        jlap._evidence_profiled_impl = orig
    return dict(x=x, y=y, ns=ns, reports=reports)


def _tspecs():
    return [tgp.GPSpec(k, box=TR.FlatBox(*(torch.tensor(
                           b, dtype=torch.float64) for b in BOXES[k])),
                       noise=tgp.NoiseModel(0.1),
                       solver=tgp.SolverPolicy(**POLICY))
            for k in ("k1", "k2")]


def test_session_nested_evidence_matches_jax(ref, jax_random):
    sess = tgp.GP.bind(_tspecs()[1], ref["x"], ref["y"], device="cpu")
    got = sess.log_evidence(method="nested", key=rnd.key(11), **NESTED_KW)
    want = ref["ns"]
    assert (got.n_iters, got.n_evals) == (int(want.n_iters),
                                          int(want.n_evals))
    for field in ("log_z", "log_z_err", "h_info"):
        assert _rel(getattr(got, field), getattr(want, field)) \
            <= SESSION_TOL, field
    with pytest.raises(ValueError, match="needs key="):
        sess.log_evidence(method="nested")
    with pytest.raises(ValueError, match="unknown evidence method"):
        sess.log_evidence(method="simpson", key=0)


def test_compare_run_nested_matches_jax(ref, jax_random):
    reports = tgp.compare(_tspecs(), ref["x"], ref["y"], key=rnd.key(5),
                          run_nested=True, batch="off", device="cpu",
                          n_live=NESTED_KW["n_live"],
                          nested_max_iter=NESTED_KW["max_iter"])
    for got, want in zip(reports, ref["reports"]):
        assert got.name == want.name
        assert got.n_evals_train == want.n_evals_train
        assert got.n_evals_nested == want.n_evals_nested
        assert got.speedup == pytest.approx(want.speedup, rel=1e-15)
        # at this budget k2's peak has no positive-definite Hessian in
        # either package: its Laplace ln Z is nan in both
        if got.name == "k1" or not math.isnan(want.log_z_laplace):
            assert _rel(got.log_z_laplace, want.log_z_laplace) \
                <= SESSION_TOL
        else:
            assert math.isnan(got.log_z_laplace)
        for field in ("log_z_nested", "log_z_nested_err"):
            assert _rel(getattr(got, field), getattr(want, field)) \
                <= SESSION_TOL, field


def test_batch_on_with_run_nested_raises_as_in_jax():
    near = np.arange(0.0, 700.0) + 0.01 * np.sin(np.arange(700.0))
    yv = np.sin(near / 7.0)
    msg = "incompatible with run_nested"
    with pytest.raises(ValueError, match=msg):
        jgp.compare(["k1", "k2"], near, yv, run_nested=True, batch="on")
    with pytest.raises(ValueError, match=msg):
        tgp.compare(["k1", "k2"], near, yv, run_nested=True, batch="on",
                    device="cpu")


# ---------------------------------------------------------------------------
# The twins of benchmarks/table1_synthetic.py and benchmarks/speedup.py
# ---------------------------------------------------------------------------

def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_table1_and_speedup_twins_run_on_the_cpu():
    """Both twins at n = 30 with a tiny budget: finite ln Z both ways, the
    evaluation counts and the speed-ups."""
    t1 = _script("table1_torch")
    rows = t1.run(ns=(30,), n_starts=2, max_iters=5, scan_points=16,
                  budget={30: (20, 2, 30)}, device="cpu", verbose=False)
    assert len(rows) == 1
    for k in ("k1", "k2"):
        r = rows[0][k]
        # (ln Z_est may be nan at five NCG steps: a peak with no
        # positive-definite Hessian)
        assert math.isfinite(r["lnZ_num"]) and r["n_modes"] >= 1
        assert r["evals_num"] == 20 + r["n_iters"] * 8 * 2
    assert math.isfinite(rows[0]["lnB_num"])
    sp = _script("speedup_torch")
    out = sp.run(n=30, n_starts=2, max_iters=5, scan_points=16, n_live=20,
                 max_iter=30, device="cpu", verbose=False)
    for r in out:
        assert r["evals_num"] == 20 + r["n_iters"] * 8 * 16
        assert r["speedup_evals"] == r["evals_num"] / r["evals_est"]
        assert r["speedup_wall"] > 0
