"""The distributed slice against the JAX package: B3's plain version and
the forward-mode rule ``ops.matvec_jvp``, the padding to the ranks, the
row-sharded GP step ``distributed_profiled_loglik`` on its three branches
(tiles, Toeplitz, SKI) at world size 1 and 2, the sharded row slab and the
stochastic solver on a process group.

Every input is made from a numpy seed and handed to both packages.  The
JAX side runs under one ``jax.jit`` with its Pallas kernels in interpret
mode and the inputs closed over as numpy constants (its structure probe
needs concrete x).  World size 1 runs in this process on a gloo group
(``launch.mesh.make_local_group("cpu")``) against a 1-device mesh; world
size 2 runs two spawned ranks on a gloo group with a ``FileStore`` under
the test's directory, against the JAX package on a 2-device CPU mesh in
one subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=2``);
each has a time limit and is killed on expiry.  The probes are the JAX
package's: the random seam of ``test_torch_session.py`` in this process,
``probes=`` in the spawned ranks (the seam's patch does not reach them).

Tolerances: the JVP 1e-12 relative (max-abs error over max-abs value);
ln P and sigma2_hat 1e-9 relative, the gradient 1e-8 relative and the CG
iteration counts equal (CG runs to cg_tol = 1e-10, so the two packages'
last-bit differences stay small); the row slab and the stochastic solve
1e-12.

The model noise is sigma_n = 2 (the data's own noise is 0.1), where CG
reaches cg_tol in a few dozen iterations on every branch.  At the
reference tests' sigma_n = 0.1 it takes hundreds of iterations on
n = 333, where finite-precision CG has lost orthogonality and its stop
iteration moves by several when every matvec is perturbed by 1e-15
relative; the two packages sum in different orders, so equal counts
there would test the rounding, not the loop (they part by an iteration
or two).  That point is held to the same ln P and gradient tolerances,
its counts within 5%
(``test_distributed_step_matches_jax_where_cg_is_long``).
"""

import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.core import distributed as jdist
from repro.kernels import ops as jops
from repro.launch.mesh import make_local_mesh
import repro_torch.random as rnd
from repro_torch.core import distributed as tdist
from repro_torch.core import engine as teng
from repro_torch.core import stochastic as tst
from repro_torch.kernels import kernel_matvec as tkm
from repro_torch.kernels import ops as tops
from repro_torch.launch.mesh import make_local_group

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


ROOT = pathlib.Path(__file__).resolve().parent.parent
JVP_TOL = 1e-12
LP_TOL = 1e-9
GRAD_TOL = 1e-8
ROWS_TOL = 1e-12
SEED = 16
SIGMA_N = 2.0
DATA_NOISE = 0.1
JOIN_S = 120
KW = dict(n_probes=8, lanczos_k=32, cg_tol=1e-10)
# the reference tests' point (samples as the time unit), and a point for
# the 2 h tide cadence (hours)
THETA = [3.2, 1.5, 0.05, 2.8, -0.1]
THETA_TIDE = [np.log(300.0), np.log(12.42), 0.0, np.log(23.93), 0.0]
JVP_THETAS = {"k1": [np.log(40.0), np.log(3.1), 0.1],
              "k2": [np.log(40.0), np.log(3.1), 0.1, np.log(7.3), -0.2],
              "se": [np.log(0.9)], "matern12": [np.log(1.7)],
              "matern32": [np.log(1.7)], "matern52": [np.log(1.2)],
              "se*matern32": [np.log(1.3), np.log(0.7)]}
BRANCHES = ("pallas", "toeplitz", "ski")


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# B3 and the forward-mode rule
# ---------------------------------------------------------------------------

def _jvp_inputs(kind):
    """Irregular x1 (77 rows) and x2 (130 columns), both ragged, v with
    8 columns, dv, and a direction dtheta that moves every coordinate."""
    rng = np.random.default_rng(SEED)
    if "*" in kind:
        x1 = rng.uniform([0.0, 0.0], [6.0, 4.0], (61, 2))
        x2 = rng.uniform([0.0, 0.0], [6.0, 4.0], (90, 2))
    else:
        x1 = np.sort(rng.uniform(0.0, 40.0, 77))
        x2 = np.sort(rng.uniform(0.0, 40.0, 130))
    th = np.asarray(JVP_THETAS[kind])
    v = rng.standard_normal((x2.shape[0], 8))
    dv = rng.standard_normal((x2.shape[0], 8))
    dth = rng.standard_normal(th.shape[0])
    return x1, x2, th, dth, v, dv


@functools.lru_cache(maxsize=None)
def _jvp_ref(kind):
    """jax.jvp of the JAX package's ops.matvec at b = 1 and 8, with a zero
    and a given v tangent, in one jitted program."""
    x1, x2, th, dth, v, dv = _jvp_inputs(kind)

    @jax.jit
    def ref(th, dth, v, dv):
        def mv(t, vv):
            return jops.matvec(kind, t, x1, x2, vv)

        out = {}
        for b in (1, 8):
            vb, dvb = v[:, :b], dv[:, :b]
            for name, tan in (("none", jnp.zeros_like(vb)), ("dv", dvb)):
                out[(b, name)] = jax.jvp(mv, (th, vb), (dth, tan))
        return out

    got = ref(jnp.asarray(th), jnp.asarray(dth), jnp.asarray(v),
              jnp.asarray(dv))
    return {k: (np.asarray(p), np.asarray(t)) for k, (p, t) in got.items()}


@pytest.mark.parametrize("with_dv", [False, True], ids=["no_dv", "dv"])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("kind", list(JVP_THETAS))
def test_matvec_jvp_matches_jax_jvp(kind, b, with_dv):
    """ops.matvec_jvp (B3's plain version; B9 with one direction for a
    composite kind; B1/B8 on dv) against jax.jvp of ops.matvec, the
    custom JVP that runs matvec_tangent_pallas."""
    x1, x2, th, dth, v, dv = _jvp_inputs(kind)
    want_out, want_tan = _jvp_ref(kind)[(b, "dv" if with_dv else "none")]
    out, tan = tops.matvec_jvp(kind, _t(th), _t(dth), _t(x1), _t(x2),
                               _t(v[:, :b]),
                               _t(dv[:, :b]) if with_dv else None)
    assert tan.shape == want_tan.shape == (x1.shape[0], b)
    assert _rel(out, want_out) < JVP_TOL
    assert _rel(tan, want_tan) < JVP_TOL


def test_matvec_jvp_squeezes_a_vector():
    x1, x2, th, dth, v, dv = _jvp_inputs("k2")
    out, tan = tops.matvec_jvp("k2", _t(th), _t(dth), _t(x1), _t(x2),
                               _t(v[:, 0]), _t(dv[:, 0]))
    out2, tan2 = tops.matvec_jvp("k2", _t(th), _t(dth), _t(x1), _t(x2),
                                 _t(v[:, :1]), _t(dv[:, :1]))
    assert out.shape == tan.shape == (x1.shape[0],)
    assert torch.equal(out, out2[:, 0]) and torch.equal(tan, tan2[:, 0])


@pytest.mark.parametrize("kind", [k for k in JVP_THETAS if "*" not in k])
def test_tile_jvp_plain_is_a_row_of_the_stacked_plain_version(kind):
    """B3's plain version on the natural tangent of flat direction i is
    row i of B2's plain version on all of them; the wrapper takes it on
    CPU tensors and checks pdot's shape."""
    x1, x2, th, _, v, _ = _jvp_inputs(kind)
    p = tops.natural_params(kind, _t(th))
    pdots = tops.natural_tangents(kind, _t(th))
    stacked = tkm.tile_stacked_tangent_matvec_plain(kind, p, pdots, _t(x1),
                                                    _t(x2), _t(v))
    for i in range(pdots.shape[0]):
        one = tkm.tile_jvp_plain(kind, p, pdots[i], _t(x1), _t(x2), _t(v))
        assert _rel(one, stacked[i]) < 1e-15
        assert torch.equal(tkm.tile_jvp(kind, p, pdots[i], _t(x1), _t(x2),
                                        _t(v)), one)
    with pytest.raises(ValueError, match="pdot must be"):
        tkm.tile_jvp(kind, p, pdots, _t(x1), _t(x2), _t(v))


# ---------------------------------------------------------------------------
# Padding to the ranks
# ---------------------------------------------------------------------------

def test_pad_for_group_decouples_exactly(monkeypatch):
    """Sentinel pad rows 1e12 (1 + i) decouple exactly: K_pad is
    [K, (1 + noise2) I] (the port's plain B4), so det factorises and
    y^T K^-1 y is unchanged; mirrors test_distributed_gp.py's test of the
    JAX package's pad.  A composite kind's (n, d) inputs are not padded."""
    monkeypatch.setattr(tdist.dist, "get_world_size", lambda group=None: 7)
    x, y = _series("pallas", 333)
    xp, yp, n = tdist.pad_for_group(_t(x), _t(y), None)
    pad = 3                                   # 333 + 3 = 7 * 48
    assert n == 333 and xp.shape == yp.shape == (n + pad,)
    assert torch.equal(xp[n:], 1e12 * (1 + torch.arange(pad,
                                                        dtype=xp.dtype)))
    assert torch.equal(yp[n:], torch.zeros(pad, dtype=yp.dtype))
    jitter = 1e-8
    noise2 = SIGMA_N ** 2 + jitter
    K = tops.matrix("k2", _t(THETA), _t(x), _t(x))
    Kp = tops.matrix("k2", _t(THETA), xp, xp)
    assert float(Kp[:n, n:].abs().max()) == 0.0
    assert torch.equal(Kp[n:, n:], torch.eye(pad, dtype=Kp.dtype))
    K.diagonal().add_(noise2)
    Kp.diagonal().add_(noise2)
    L, Lp = torch.linalg.cholesky(K), torch.linalg.cholesky(Kp)
    yKy = float(_t(y) @ torch.cholesky_solve(_t(y)[:, None], L)[:, 0])
    yKy_p = float(yp @ torch.cholesky_solve(yp[:, None], Lp)[:, 0])
    np.testing.assert_allclose(yKy_p, yKy, rtol=1e-10)
    logdet = 2.0 * float(torch.log(torch.diagonal(L)).sum())
    logdet_p = 2.0 * float(torch.log(torch.diagonal(Lp)).sum())
    np.testing.assert_allclose(logdet_p - pad * np.log(1.0 + noise2),
                               logdet, rtol=1e-10)
    x2 = np.random.default_rng(0).uniform(0.0, 5.0, (333, 2))
    with pytest.raises(ValueError, match=r"pads only 1-D inputs"):
        tdist.pad_for_group(_t(x2), _t(y), None)


# ---------------------------------------------------------------------------
# The GP step at world size 1
# ---------------------------------------------------------------------------

def _series(branch, n):
    """(x, y) for one branch: irregular times on [0, n] (tiles), the
    reference tests' exact grid 1..n (Toeplitz), or a gappy record on the
    2 h cadence with every 8th sample dropped (SKI)."""
    rng = np.random.default_rng(SEED + 1)
    if branch == "pallas":
        x = np.sort(rng.uniform(0.0, float(n), n))
    elif branch == "toeplitz":
        x = np.arange(1.0, n + 1.0)
    else:
        full = 2.0 * np.arange(n + n // 7 + 2)
        x = np.delete(full, np.arange(3, full.size, 8))[:n]
    period = 12.42 if branch == "ski" else 9.0
    y = (np.sin(2 * np.pi * x / period) + 0.4 * np.sin(x / 23.0)
         + DATA_NOISE * rng.standard_normal(x.shape[0]))
    return x, y


def _theta(branch):
    return THETA_TIDE if branch == "ski" else THETA


def _jax_step(branch, n, mesh, key):
    x, y = _series(branch, n)

    @jax.jit
    def run(th, yy):
        return jdist.distributed_profiled_loglik("k2", th, x, yy, SIGMA_N,
                                                 mesh, key, **KW)

    r = run(jnp.asarray(_theta(branch)), jnp.asarray(y))
    return {f: np.asarray(getattr(r, f)) for f in r._fields}


def _assert_same_step(got, want):
    assert _rel(got["log_p_max"], want["log_p_max"]) < LP_TOL
    assert _rel(got["sigma2_hat"], want["sigma2_hat"]) < LP_TOL
    assert _rel(got["grad"], want["grad"]) < GRAD_TOL
    assert int(got["cg_iters"]) == int(want["cg_iters"])


@pytest.fixture
def group():
    g = make_local_group("cpu")
    yield g
    dist.destroy_process_group()


@pytest.mark.parametrize("branch", BRANCHES)
def test_distributed_step_matches_jax_on_one_rank(branch, group, jax_random,
                                                  monkeypatch):
    """World size 1 against the JAX package on a 1-device mesh, the
    probes drawn through the seam from the same key; the tile branch's
    gradient is 2 m B3 calls (m = 5), and B2 is never called."""
    n = 400 if branch == "ski" else 333
    calls = {"tile_jvp": 0, "tile_stacked_tangent_matvec": 0}
    for name in calls:
        real = getattr(tkm, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(tkm, name, spy)
    want = _jax_step(branch, n, make_local_mesh(), jax.random.key(SEED))
    x, y = _series(branch, n)
    r = tdist.distributed_profiled_loglik("k2", _theta(branch), x, y,
                                          SIGMA_N, group, rnd.key(SEED),
                                          device="cpu", **KW)
    _assert_same_step({f: getattr(r, f) for f in r._fields}, want)
    assert calls == {"tile_jvp": 10 if branch == "pallas" else 0,
                     "tile_stacked_tangent_matvec": 0}


def test_distributed_step_matches_jax_where_cg_is_long(group, jax_random,
                                                      monkeypatch):
    """The tile branch at the reference tests' sigma_n = 0.1 (~300 CG
    iterations): ln P, sigma2_hat and the gradient to the same tolerances;
    the iteration counts may part by a few (module docstring)."""
    monkeypatch.setattr(sys.modules[__name__], "SIGMA_N", 0.1)
    want = _jax_step("pallas", 333, make_local_mesh(), jax.random.key(SEED))
    x, y = _series("pallas", 333)
    r = tdist.distributed_profiled_loglik("k2", THETA, x, y, 0.1, group,
                                          rnd.key(SEED), device="cpu", **KW)
    assert _rel(r.log_p_max, want["log_p_max"]) < LP_TOL
    assert _rel(r.sigma2_hat, want["sigma2_hat"]) < LP_TOL
    assert _rel(r.grad, want["grad"]) < GRAD_TOL
    assert abs(r.cg_iters - int(want["cg_iters"])) < 0.05 * r.cg_iters


def test_distributed_step_checks_its_group_and_inputs(group, monkeypatch):
    """A gloo group refuses card tensors (and an uninitialised
    torch.distributed refuses to run); only the exact operators are
    allowed, with the JAX package's message; make_local_group refuses a
    second default group."""
    x, y = _series("pallas", 64)
    args = ("k2", THETA, x, y, SIGMA_N, group, rnd.key(0))
    with pytest.raises(ValueError, match="gloo process group serves cpu"):
        tdist._ranks(group, torch.device("cuda"))
    grid2 = np.stack(np.meshgrid(np.arange(8.0), np.arange(8.0),
                                 indexing="ij"), -1).reshape(-1, 2)
    with pytest.raises(ValueError, match="exact matvec operators"):
        tdist.distributed_profiled_loglik("se*matern32", [0.0, 0.0], grid2,
                                          y, SIGMA_N, group, rnd.key(0),
                                          device="cpu")
    with pytest.raises(ValueError, match="probes must be"):
        tdist.distributed_profiled_loglik(*args, probes=np.ones((5, 2)),
                                          device="cpu")
    with pytest.raises(RuntimeError, match="exists already"):
        make_local_group("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdist.distributed_profiled_loglik(*args)
    monkeypatch.setattr(tdist.dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="not initialised"):
        tdist.distributed_profiled_loglik(*args, device="cpu")
    with pytest.raises(NotImplementedError, match="module A7"):
        tdist.lower_gp_cell("k2", 4096, None)


def _stochastic_pair(group, n=333):
    """One StochasticSolver solve with the row slab sharded over ``group``
    and one unsharded, on the same inputs and probes."""
    x, y = _series("pallas", n)
    opts = teng.SolverOpts(n_probes=3, n_epochs=2, batch_size=32,
                           nystrom_rank=8)
    z = np.random.default_rng(SEED + 2).choice([-1.0, 1.0], (n, 3))
    out = []
    for g in (group, None):
        s = tst.StochasticSolver("se", _t([np.log(4.0)]), _t(x), _t(y),
                                 SIGMA_N, rnd.key(SEED), opts=opts,
                                 probes=_t(z), group=g)
        out.append(s.solve(torch.cat([_t(y)[:, None], _t(z)], dim=1)))
    return out


def _rows_pair(group, kind="se", n=333, b=40, k=3):
    """The sharded row slab and the unsharded plain one."""
    rng = np.random.default_rng(SEED + 3)
    x = _t(np.sort(rng.uniform(0.0, 40.0, n)))
    rows = torch.as_tensor(rng.permutation(n)[:b])
    v = _t(rng.standard_normal((n, k)))
    th = _t([np.log(0.9)])
    got = tdist.sharded_rows_matvec(kind, group)(th, x[rows], x, v)
    want = tkm.tile_matvec_plain(kind, tops.natural_params(kind, th),
                                 x[rows], x, v)
    return got, want


def test_sharded_rows_and_stochastic_group_on_one_rank(group):
    got, want = _rows_pair(group)
    assert _rel(got, want) < ROWS_TOL
    sharded, plain = _stochastic_pair(group)
    assert _rel(sharded, plain) < ROWS_TOL


# ---------------------------------------------------------------------------
# World size 2: two spawned ranks against a 2-device mesh
# ---------------------------------------------------------------------------

N2 = 333                 # odd: pad = 1 on two ranks
WORLD = 2

_JAX_2DEV = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
from repro.core import distributed as jdist
from repro.launch.mesh import make_local_mesh

inp = np.load(sys.argv[1])
mesh = make_local_mesh(data=2)
kw = dict(n_probes=int(inp["n_probes"]), lanczos_k=int(inp["lanczos_k"]),
          cg_tol=float(inp["cg_tol"]))
out = {}
for br in ("pallas", "toeplitz", "ski"):
    x = np.asarray(inp[br + "_x"])
    run = jax.jit(lambda th, yy: jdist.distributed_profiled_loglik(
        "k2", th, x, yy, float(inp["sigma_n"]), mesh,
        jax.random.key(int(inp["seed"])), **kw))
    r = run(jnp.asarray(inp[br + "_theta"]), jnp.asarray(inp[br + "_y"]))
    for f in r._fields:
        out[br + "_" + f] = np.asarray(getattr(r, f))
np.savez(sys.argv[2], **out)
"""


def _rank_main(rank, store_path, inputs_path, out_path):
    """One spawned rank: the GP step on every branch, the sharded row
    slab and a stochastic solve; rank 0 writes the results."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        inp = np.load(inputs_path)
        g = dist.group.WORLD
        out = {}
        for br in BRANCHES:
            r = tdist.distributed_profiled_loglik(
                "k2", inp[br + "_theta"], inp[br + "_x"], inp[br + "_y"],
                SIGMA_N, g, None, probes=inp[br + "_z"], device="cpu", **KW)
            for f in r._fields:
                out[br + "_" + f] = np.asarray(getattr(r, f))
        got, want = _rows_pair(g)
        out["rows_got"], out["rows_want"] = got.numpy(), want.numpy()
        sharded, plain = _stochastic_pair(g)
        out["st_sharded"], out["st_plain"] = sharded.numpy(), plain.numpy()
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two packages at world size 2, run together: the JAX package on
    a 2-device mesh in a subprocess, the port on two spawned gloo ranks.
    Each gets JOIN_S seconds and is killed past them."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    inputs = {"n_probes": KW["n_probes"], "lanczos_k": KW["lanczos_k"],
              "cg_tol": KW["cg_tol"], "sigma_n": SIGMA_N, "seed": SEED}
    n_pad = N2 + (-N2) % WORLD
    z = np.asarray(jax.random.rademacher(jax.random.key(SEED),
                                         (n_pad, KW["n_probes"])),
                   dtype=np.float64)
    z[N2:] = 0.0
    for br in BRANCHES:
        x, y = _series(br, N2)
        inputs.update({br + "_x": x, br + "_y": y, br + "_z": z,
                       br + "_theta": np.asarray(_theta(br))})
    inputs_path = tmp / "inputs.npz"
    np.savez(inputs_path, **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + [p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    jax_out = tmp / "jax.npz"
    proc = subprocess.Popen([sys.executable, "-c", _JAX_2DEV,
                             str(inputs_path), str(jax_out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    ctx = mp.get_context("spawn")
    port_out = tmp / "port.npz"
    ranks = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp / "store"), str(inputs_path),
                               str(port_out)))
             for r in range(WORLD)]
    try:
        for p in ranks:
            p.start()
        for p in ranks:
            p.join(JOIN_S)
        hung = [p.pid for p in ranks if p.is_alive()]
        try:
            _, err = proc.communicate(timeout=JOIN_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            pytest.fail(f"the JAX 2-device reference ran past {JOIN_S} s")
    finally:
        for p in ranks:
            if p.is_alive():
                p.kill()
                p.join()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert not hung, f"ranks {hung} ran past {JOIN_S} s and were killed"
    assert [p.exitcode for p in ranks] == [0] * WORLD
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(port_out)), dict(np.load(jax_out))


@pytest.mark.parametrize("branch", BRANCHES)
def test_distributed_step_matches_jax_on_two_ranks(two_ranks, branch):
    """Two gloo ranks (n = 333, pad = 1) against the JAX package on a
    2-device mesh: this pins the pad path and the n_pad scaling of the
    SLQ log-det that the JAX package applies."""
    port, ref = two_ranks
    _assert_same_step({f: port[branch + "_" + f] for f in
                       ("log_p_max", "sigma2_hat", "grad", "cg_iters")},
                      {f: ref[branch + "_" + f] for f in
                       ("log_p_max", "sigma2_hat", "grad", "cg_iters")})


def test_sharded_rows_and_stochastic_group_on_two_ranks(two_ranks):
    port, _ = two_ranks
    assert _rel(port["rows_got"], port["rows_want"]) < ROWS_TOL
    assert _rel(port["st_sharded"], port["st_plain"]) < ROWS_TOL
