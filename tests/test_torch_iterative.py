"""Port's CG, Lanczos, SLQ and iterative hyperlikelihood against the JAX
package, on the same numpy data and the same Rademacher probes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import iterative as jit_
from repro.core import laplace as jlap
from repro.kernels import operators as jopers
from repro_torch.core import engine as teng
from repro_torch.core import iterative as tit
from repro_torch.core import laplace as tlap
from repro_torch.kernels import operators as topers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run several pytest workers on one machine; torch's CPU
    thread pool in each of them oversubscribes the cores (tens of times
    slower), so each module runs torch on one thread and restores it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N = 420
SIGMA_N = 0.1
JITTER = 1e-8
THETAS = {
    "k1": [np.log(60.0), np.log(12.4), 0.1],
    "k2": [np.log(80.0), np.log(12.4), 0.05, np.log(24.0), -0.1],
    "matern32": [np.log(5.0)],
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = np.sort(rng.uniform(0.0, 700.0, N))
    y = (np.sin(2 * np.pi * x / 12.4) + 0.5 * np.sin(2 * np.pi * x / 24.0)
         + SIGMA_N * rng.standard_normal(N))
    return x, y


def _t(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _ops(kind, x):
    jop = jopers.select_operator(kind, jnp.asarray(x), SIGMA_N, JITTER)
    top = topers.select_operator(kind, _t(x), SIGMA_N, JITTER)
    assert jop.name == top.name == "pallas"
    return jop, top


@pytest.mark.parametrize("kind", sorted(THETAS))
def test_cg_solve_matches_jax(data, kind):
    x, _ = data
    rhs = np.random.default_rng(12).standard_normal((N, 5))
    theta = np.asarray(THETAS[kind])
    jop, top = _ops(kind, x)
    jsol = jit_.cg_solve(lambda v: jop.gram_matvec(jnp.asarray(theta), v),
                         jnp.asarray(rhs), tol=1e-10, max_iter=300)
    tsol = tit.cg_solve(lambda v: top.gram_matvec(_t(theta), v), _t(rhs),
                        tol=1e-10, max_iter=300)
    assert tsol.iters == int(jsol.iters)
    assert _rel(tsol.x.numpy(), jsol.x) < 1e-9
    # the same call through a 1-D right-hand side
    t1 = tit.cg_solve(lambda v: top.gram_matvec(_t(theta), v), _t(rhs[:, 0]),
                      tol=1e-10, max_iter=300)
    assert t1.x.shape == (N,) and t1.resnorm.ndim == 0


@pytest.mark.parametrize("kind", sorted(THETAS))
def test_lanczos_and_slq_match_jax(data, kind):
    x, _ = data
    theta = np.asarray(THETAS[kind])
    jop, top = _ops(kind, x)
    key = jax.random.key(3)
    z = np.asarray(jax.random.rademacher(key, (N, 6))).astype(np.float64)
    ja, jb = jit_.lanczos(lambda v: jop.gram_matvec(jnp.asarray(theta), v),
                          jnp.asarray(z), 20)
    ta, tb = tit.lanczos(lambda v: top.gram_matvec(_t(theta), v), _t(z), 20)
    assert _rel(ta.numpy(), ja) < 1e-9
    assert _rel(tb.numpy(), jb) < 1e-9
    jl = jit_.slq_logdet(lambda v: jop.gram_matvec(jnp.asarray(theta), v), N,
                         key, n_probes=6, k=20)
    tl = tit.slq_quadrature(ta, tb, N)
    assert abs(float(tl) - float(jl)) < 1e-9 * abs(float(jl))


@pytest.mark.parametrize("kind", sorted(THETAS))
def test_profiled_loglik_and_grad_match_jax(data, kind):
    """ln P_max (eq. 2.16) and its gradient (eq. 2.17) at a fixed theta,
    with the JAX solver's own probes handed to the port's solver."""
    x, y = data
    theta = np.asarray(THETAS[kind])
    opts = jeng.SolverOpts(n_probes=6, lanczos_k=24, cg_tol=1e-10,
                           cg_max_iter=400)
    key = jax.random.key(5)
    js = jeng.IterativeSolver(kind, jnp.asarray(theta), jnp.asarray(x),
                              jnp.asarray(y), SIGMA_N, key, JITTER, opts)
    jg = jeng.profiled_grad(js)
    jlp = jeng.profiled_loglik(js)
    z_slq = jax.random.rademacher(jax.random.fold_in(key, 1), (N, 6))
    topts = teng.SolverOpts(**opts._asdict())
    ts = teng.IterativeSolver(kind, _t(theta), _t(x), _t(y), SIGMA_N, None,
                              JITTER, topts,
                              probes=(_t(np.asarray(js.z)),
                                      _t(np.asarray(z_slq))))
    tg = teng.profiled_grad(ts)
    tlp = teng.profiled_loglik(ts)
    assert abs(float(tlp) - float(jlp)) < 1e-8 * abs(float(jlp))
    assert _rel(tg.numpy(), jg) < 1e-8
    assert ts.op.name == "pallas"


def test_value_only_solver_pays_one_rhs(data):
    """A value-only evaluation solves y alone; the gradient then adds the
    probe solve, as in the JAX package's lazy solver."""
    x, y = data
    opts = teng.SolverOpts(n_probes=4, lanczos_k=8, cg_tol=1e-8)
    s = teng.make_solver("iterative", _cov("k1"), _t(THETAS["k1"]), _t(x),
                         _t(y), SIGMA_N, opts=opts)
    s.sigma2_hat()
    assert s.alpha is not None and s.Kinv_z is None
    s.grad_terms()
    assert s.Kinv_z.shape == (N, 4)


def _cov(name):
    from repro_torch.core.covariances import resolve
    return resolve(name)


def test_fd_hessian_of_a_quadratic_is_exact():
    A = torch.tensor([[2.0, 0.5], [0.5, 1.0]], dtype=torch.float64)
    H = teng.fd_hessian(lambda th: A @ th, torch.zeros(2,
                                                       dtype=torch.float64))
    assert torch.allclose(H, A, rtol=0, atol=1e-12)


@pytest.mark.parametrize("max_iter", [5, 2000])
def test_cg_stops_record_how_each_solve_ended(data, max_iter):
    """A solve cut at max_iter is counted with its worst residual, which
    is the JAX solver's residual at the same cut."""
    x, _ = data
    rhs = np.random.default_rng(13).standard_normal((N, 3))
    theta = np.asarray(THETAS["k2"])
    jop, top = _ops("k2", x)
    jsol = jit_.cg_solve(lambda v: jop.gram_matvec(jnp.asarray(theta), v),
                         jnp.asarray(rhs), tol=1e-10, max_iter=max_iter)
    tit.reset_cg_stops()
    tit.cg_solve(lambda v: top.gram_matvec(_t(theta), v), _t(rhs),
                 tol=1e-10, max_iter=max_iter)
    cut = int(jsol.iters) == max_iter
    assert cut == (max_iter == 5)
    assert dict(tit.CG_STOPS) == {"max_iter" if cut else "tol": 1}
    want = float(np.max(np.asarray(jsol.resnorm))) if cut else 0.0
    assert abs(tit.CG_WORST_RESIDUAL[0] - want) <= 1e-9 * max(want, 1e-300)


@pytest.mark.parametrize("eigs", [(1.0, 4.0, 9.0), (-2.0, 0.5, 3.0)])
def test_laplace_keeps_each_hessians_eigenvalues(eigs):
    """ln Z is nan exactly when an eigenvalue of H is not positive, as in
    the JAX package, and every Hessian's eigenvalues are kept."""
    q, _ = np.linalg.qr(np.random.default_rng(14).standard_normal((3, 3)))
    H = q @ np.diag(eigs) @ q.T
    jz, _ = jlap._laplace_log_z(jnp.asarray(-3.0), jnp.asarray(1.5),
                                jnp.asarray(H))
    tlap.HESSIAN_EIGENVALUES.clear()
    tz, _ = tlap._laplace_log_z(_t(-3.0), _t(1.5), _t(H))
    assert np.isnan(float(jz)) == np.isnan(float(tz)) == (min(eigs) <= 0)
    if not np.isnan(float(jz)):
        assert abs(float(tz) - float(jz)) < 1e-12 * abs(float(jz))
    assert len(tlap.HESSIAN_EIGENVALUES) == 1
    np.testing.assert_allclose(tlap.HESSIAN_EIGENVALUES[0].numpy(),
                               sorted(eigs), rtol=1e-12)


def test_auto_preconditioner_is_none_on_tiles(data):
    x, _ = data
    top = topers.select_operator("k1", _t(x), SIGMA_N, JITTER)
    assert tit.make_preconditioner(top, _t(THETAS["k1"]), "auto") is None
    assert jit_.resolve_precond("auto", jopers.select_operator(
        "k1", jnp.asarray(x), SIGMA_N, JITTER)) is None


@pytest.mark.parametrize("kind", sorted(THETAS))
def test_operator_diag_and_column_match_jax(data, kind):
    x, _ = data
    theta = np.asarray(THETAS[kind])
    jop, top = _ops(kind, x)
    np.testing.assert_allclose(top.diag(_t(theta)).numpy(),
                               np.asarray(jop.diag(jnp.asarray(theta))),
                               rtol=1e-12)
    for i in (0, 17, N - 1):
        np.testing.assert_allclose(
            top.matcol(_t(theta), i).numpy(),
            np.asarray(jop.matcol(jnp.asarray(theta), i)), rtol=1e-12,
            atol=1e-15)
