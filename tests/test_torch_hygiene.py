"""Boundaries of the port: imports, devices, launch counts and refusals."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import _pending
from repro_torch import gp as tgp
from repro_torch.core import engine as teng
from repro_torch.core import iterative as tit
from repro_torch.core.covariances import resolve
from repro_torch.gp import batch as tbatch
from repro_torch.gp.compare import batchable
from repro_torch.kernels import _cuda
from repro_torch.kernels import kernel_matvec as tkm
from repro_torch.kernels import kernel_tile as tkt
from repro_torch.kernels import operators as topers
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ski_fused as tsf


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
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "large_scale_gp_torch.py",
    ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "tidal_analysis_torch.py",
    ROOT / "scripts" / "table1_torch.py",
    ROOT / "scripts" / "speedup_torch.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "repro"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def _irregular(n=300, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 3000.0, n))
    return x, np.sin(x / 7.0) + 0.1 * rng.standard_normal(n)


def _spec(kernel="k1", backend="iterative", **opts):
    return tgp.GPSpec(kernel, noise=tgp.NoiseModel(0.1),
                      solver=tgp.SolverPolicy(
                          backend=backend, n_starts=1, max_iters=1,
                          opts=teng.SolverOpts(n_probes=2, lanczos_k=4,
                                               **opts)))


def test_entry_points_default_to_the_card(monkeypatch):
    """device=None means CUDA; without a card that is an error that names
    device='cpu', never a silent run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _irregular()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgp.GP.bind(_spec(), x, y)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgp.compare([_spec("k1"), _spec("k2")], x, y)
    near = _near(700)                  # the batched bank's path
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgp.compare([_spec("k1"), _spec("k2")], near, np.sin(near))
    gp = tgp.GP.bind(_spec(), x, y, device="cpu")
    assert gp.x.device.type == "cpu" and gp.x.dtype == torch.float64


def test_cpu_tensors_never_launch_a_kernel():
    _cuda.reset_launches()
    x, y = _irregular(120)
    gp = tgp.GP.bind(_spec(), x, y, device="cpu").fit(0)
    gp.predict(np.linspace(0.0, 3000.0, 9))
    theta = torch.tensor([np.log(50.0), np.log(7.0), 0.0])
    xt = torch.tensor(x)
    tops.matvec("k1", theta, xt, xt, torch.ones(120, 3, dtype=torch.float64))
    tops.matvec_tangents("k1", theta, xt, xt, torch.ones(120, 2,
                                                         dtype=torch.float64))
    tops.matrix("k1", theta, xt, xt[:5])
    tops.matvec_jvp("k1", theta, torch.ones(3, dtype=torch.float64), xt, xt,
                    torch.ones(120, 3, dtype=torch.float64))
    # the near-grid path: B5 and B6 take their plain versions on the CPU
    near = _near(400)
    ski = tgp.GP.bind(_spec(), near, np.sin(near), device="cpu")
    assert ski.op.fused
    s = teng.make_solver("iterative", ski.cov, theta, ski.x, ski.y, 0.1,
                         opts=ski.spec.solver.opts, op=ski.op)
    teng.profiled_grad(s)
    ski.predict(near[::40], theta=theta)
    # the bank: B7 takes its plain version on the CPU
    bank = tbatch.BankOperator(("k1", "k1"), torch.tensor(near), 0.1, 1e-8)
    assert bank.fused
    out = bank.bind_matvec(torch.stack([theta, theta + 0.1]),
                           torch.float64)(torch.ones(bank.n, 2, 3,
                                                     dtype=torch.float64))
    assert out.shape == (bank.n, 2, 3)
    # the N-D paths: B8/B9 on scattered (n, 2) points, B10/B11 on a gappy
    # field, all through their plain versions on the CPU
    th2 = torch.tensor([0.3, -0.2])
    for xx in (_scattered2(80), _gappy_field()):
        nd = tgp.GP.bind(_spec("se*matern32"), xx, np.sin(xx[:, 0]),
                         device="cpu")
        s = teng.make_solver("iterative", nd.cov, th2, nd.x, nd.y, 0.1,
                             opts=nd.spec.solver.opts, op=nd.op)
        teng.profiled_grad(s)
        nd.predict(xx[:5] + 0.01, theta=th2)
    # the stochastic backend: B12 and B13 take their plain versions
    for kind, xx, th in (("k1", x, theta), ("se*matern32", _scattered2(80),
                                             th2)):
        st = tgp.GP.bind(_spec(kind, backend="stochastic", batch_size=16),
                         xx, np.sin(np.reshape(xx, (len(xx), -1))[:, 0]),
                         device="cpu")
        s = teng.make_solver("stochastic", st.cov, th, st.x, st.y, 0.1,
                             opts=st.spec.solver.opts, op=st.op)
        teng.profiled_grad(s)
        st.predict(np.asarray(xx)[:5], theta=th)
    assert sum(_cuda.LAUNCHES.values()) == 0
    assert not _cuda.KERNELS.fns       # nothing was built either


def test_wrappers_reject_devices_they_cannot_serve():
    p = torch.ones(8, dtype=torch.float64)
    x = torch.zeros(4, dtype=torch.float64)
    v = torch.zeros(4, 1, dtype=torch.float64)
    meta = torch.zeros(4, 1, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        tkm.tile_matvec("se", p, x, x, meta)
    with pytest.raises(ValueError):
        tkt.tile_matrix("se", p.to("meta"), x.to("meta"), x.to("meta"))
    assert tkm.tile_matvec("se", p, x, x, v).shape == (4, 1)
    geom = topers.select_operator("k1", torch.tensor(_near(300)), 0.1,
                                  1e-8).fused_geom
    lam = torch.zeros(geom.L, dtype=torch.float64)
    vv = torch.zeros((geom.n, 2), dtype=torch.float64)
    with pytest.raises(ValueError):
        tsf.fused_gram_matvec(geom, lam.to("meta"), 0.0, vv.to("meta"))
    with pytest.raises(ValueError):
        tsf.fused_tangent_matvecs(geom, lam[None].to("meta"), vv.to("meta"))
    with pytest.raises(ValueError, match="one device"):
        tsf.fused_gram_matvec(geom, lam.to("meta"), 0.0, vv)
    assert tsf.fused_gram_matvec(geom, lam, 0.0, vv).shape == (geom.n, 2)
    lams = lam[None].expand(2, -1).contiguous()
    V = torch.zeros((geom.n, 2, 3), dtype=torch.float64)
    with pytest.raises(ValueError):
        tsf.fused_bank_matvec(geom, lams.to("meta"), 0.0, V.to("meta"))
    with pytest.raises(ValueError, match="one device"):
        tsf.fused_bank_matvec(geom, lams.to("meta"), 0.0, V)
    with pytest.raises(ValueError, match="one spectrum per member"):
        tsf.fused_bank_matvec(geom, lams[:1], 0.0, V)
    assert tsf.fused_bank_matvec(geom, lams, 0.0, V).shape == V.shape
    # B8 / B9
    p2 = torch.ones(2, 8, dtype=torch.float64)
    x2 = torch.zeros(4, 2, dtype=torch.float64)
    pd = torch.zeros(3, 2, 8, dtype=torch.float64)
    kinds = ("se", "matern32")
    with pytest.raises(ValueError):
        tkm.tile_matvec_nd(kinds, p2, x2, x2, meta)
    with pytest.raises(ValueError):
        tkm.tile_stacked_tangent_matvec_nd(kinds, p2.to("meta"), pd.to(
            "meta"), x2.to("meta"), x2.to("meta"), meta)
    with pytest.raises(ValueError, match="one device"):
        tkm.tile_matvec_nd(kinds, p2.to("meta"), x2, x2, v)
    assert tkm.tile_matvec_nd(kinds, p2, x2, x2, v).shape == (4, 1)
    assert tkm.tile_stacked_tangent_matvec_nd(kinds, p2, pd, x2, x2,
                                              v).shape == (3, 4, 1)
    # B10 / B11
    g2 = topers.select_operator("se*matern32", torch.tensor(_gappy_field()),
                                0.1, 1e-8).fused_geom
    l1 = torch.zeros(g2.Ls[0], dtype=torch.float64)
    l2 = torch.zeros(g2.Ls[1], dtype=torch.float64)
    v2 = torch.zeros((g2.n, 2), dtype=torch.float64)
    with pytest.raises(ValueError):
        tsf.fused_gram_matvec_nd(g2, (l1.to("meta"), l2.to("meta")), 0.0,
                                 v2.to("meta"))
    with pytest.raises(ValueError, match="one device"):
        tsf.fused_gram_matvec_nd(g2, (l1.to("meta"), l2), 0.0, v2)
    pairs = (l1[None].expand(2, -1).contiguous(),
             l2[None].expand(2, -1).contiguous())
    with pytest.raises(ValueError):
        tsf.fused_tangent_matvecs_nd(
            g2, tuple(p.to("meta") for p in pairs), v2.to("meta"))
    with pytest.raises(ValueError, match="spectra must be"):
        tsf.fused_tangent_matvecs_nd(g2, (pairs[0], pairs[1][:1]), v2)
    assert tsf.fused_gram_matvec_nd(g2, (l1, l2), 0.0, v2).shape == v2.shape
    assert tsf.fused_tangent_matvecs_nd(g2, pairs, v2).shape == (2, g2.n, 2)


def _near(n_full=3000):
    """A gappy record: every 7th sample of a unit grid dropped."""
    return np.delete(np.arange(float(n_full)), np.arange(5, n_full, 7))


def _field(shape=(14, 10)):
    """A full product grid on spacings (0.5, 0.25), row-major."""
    axes = [h * np.arange(m) for m, h in zip(shape, (0.5, 0.25))]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 2)


def _gappy_field(shape=(14, 10)):
    """The field with every 6th point dropped."""
    x = _field(shape)
    return np.delete(x, np.arange(3, x.shape[0], 6), axis=0)


def _scattered2(n=120, seed=0):
    return np.random.default_rng(seed).uniform(0.0, 5.0, (n, 2))


# branches that the dense slice lifted: each now binds or answers
LIFTED = ("backend_dense", "auto_small_n", "dense_only_kind", "gp_sample")


@pytest.mark.parametrize("what", LIFTED)
def test_dense_lifted_branches_answer(what):
    """The branches that the dense slice lifted from
    :func:`test_unported_branches_raise_not_implemented` now bind or
    answer."""
    x, y = _irregular()
    theta = [5.0, 2.0, 0.0]
    if what in ("backend_dense", "auto_small_n"):
        backend = "dense" if what == "backend_dense" else "auto"
        gp = tgp.GP.bind(_spec(backend=backend), x, y, device="cpu")
        assert (gp.backend, gp.operator_name, gp.op) == ("dense", "dense",
                                                         None)
        assert gp.n <= gp.spec.solver.dense_cutoff
        assert torch.isfinite(gp.log_likelihood(theta))
    elif what == "dense_only_kind":
        # no tile: the dense backend takes it, the iterative one refuses
        # it with the JAX package's ValueError
        cov = resolve("periodic")
        assert cov.name == "periodic" and cov.n_params == 2
        gp = tgp.GP.bind(_spec("periodic", backend="auto"), x, y,
                         device="cpu")
        assert gp.backend == "dense"
        assert torch.isfinite(gp.log_likelihood([2.0, 0.1]))
        with pytest.raises(ValueError, match="no registered tile"):
            tgp.GP.bind(_spec("periodic"), x, y, device="cpu")
        with pytest.raises(ValueError, match="no registered tile"):
            teng.resolve_kind(resolve("rq*se"))
    else:
        # joint draws are dense whatever the backend
        gp = tgp.GP.bind(_spec(), x, y, device="cpu")
        assert gp.backend == "iterative"
        draws = gp.sample(0, x[:5], theta=theta, n_draws=2)
        assert draws.shape == (2, 5) and torch.isfinite(draws).all()


@pytest.mark.parametrize("what", ["nested_evidence", "compare_run_nested"])
def test_nested_lifted_branches_answer(what):
    """The branches that the nested slice lifted from
    :func:`test_unported_branches_raise_not_implemented` now answer: the
    nested evidence of a session (and without key= the JAX package's
    ValueError), and compare(run_nested=True) with its nested fields and
    speed-up."""
    x, y = _irregular(40)
    kw = dict(n_live=8, n_chains=2, n_steps=1, max_iter=3)
    if what == "nested_evidence":
        gp = tgp.GP.bind(_spec(backend="dense"), x, y, device="cpu")
        with pytest.raises(ValueError, match="needs key="):
            gp.log_evidence(method="nested")
        res = gp.log_evidence(method="nested", key=0, **kw)
        assert res.n_iters == 3 and res.n_evals == 8 + 3 * 2
        assert torch.isfinite(res.log_z) and torch.isfinite(res.log_z_err)
    else:
        reports = tgp.compare([_spec("k1", backend="dense"),
                               _spec("k2", backend="dense")], x, y,
                              run_nested=True, n_live=8, nested_max_iter=2,
                              device="cpu")
        for r in reports:
            assert r.n_evals_nested == 8 + 2 * 8 * 16
            assert np.isfinite(r.log_z_nested) and r.log_z_nested_err > 0
            assert r.speedup == r.n_evals_nested / (r.n_evals_train + 1)


@pytest.mark.parametrize("what", [
    "operator_lowrank", "precond_pivchol", "precond_rank",
    "bank_pivchol", "bank_precond_rank", "gp_rebind"])
def test_unported_branches_raise_not_implemented(what):
    """Each branch that the port does not run raises NotImplementedError
    and names its queue-A slice."""
    x, y = _irregular()
    near = _near()
    cases = {
        "operator_lowrank": lambda: tgp.GP.bind(
            _spec(operator="lowrank"), x, y, device="cpu"),
        "precond_pivchol": lambda: tgp.GP.bind(
            _spec(precond="pivchol"), x, y, device="cpu").log_likelihood(
                [5.0, 2.0, 0.0]),
        "precond_rank": lambda: tgp.GP.bind(
            _spec(precond_rank=8), x, y, device="cpu").log_likelihood(
                [5.0, 2.0, 0.0]),
        "bank_pivchol": lambda: tgp.compare(
            [_spec("k1", precond="pivchol"), _spec("k2", precond="pivchol")],
            near, np.sin(near), batch="on", device="cpu"),
        "bank_precond_rank": lambda: tgp.compare(
            [_spec("k1", precond_rank=8), _spec("k2", precond_rank=8)],
            near, np.sin(near), batch="on", device="cpu"),
        "gp_rebind": lambda: tgp.GP.bind(_spec(), x, y, device="cpu")
        .rebind(x, y),
    }
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as err:
        cases[what]()
    if what.startswith("bank_") or what.startswith("precond"):
        assert "the rest of slice S2" in str(err.value)
    if what == "gp_rebind":
        assert _pending.SERVE in str(err.value)


def test_pending_names_only_slices_still_to_come():
    """The refusal constants name queue-A slices that are not ported; the
    bank's constant went when the bank slice landed, the dense one with
    the dense slice, the nested one with the nested slice."""
    names = {k for k in vars(_pending) if k.isupper()}
    assert names == {"PIVCHOL", "SERVE", "LM"}


@pytest.mark.parametrize("what", ["backend_stochastic", "auto_huge_n",
                                  "auto_huge_n_grid", "stochastic_nd"])
def test_ported_stochastic_branches_bind(what):
    """The branches the stochastic slice ported: an explicit
    backend="stochastic" binds the tile operator whatever the data's
    structure, and "auto" escalates structure-free data at n >= 65536
    (at that size the test only binds); a grid at that size stays on the
    iterative backend."""
    if what == "backend_stochastic":
        x = np.arange(600.0)                     # an exact grid
        gp = tgp.GP.bind(_spec(backend="stochastic"), x, np.sin(x / 7.0),
                         device="cpu")
        assert gp.log_likelihood([5.0, 2.0, 0.0]).isfinite()
    elif what == "auto_huge_n":
        gp = tgp.GP.bind(_spec(backend="auto"), *_irregular(65536),
                         device="cpu")
    elif what == "auto_huge_n_grid":
        x = _near(77000)
        gp = tgp.GP.bind(_spec(backend="auto"), x, np.sin(x), device="cpu")
        assert gp.n >= 65536
        assert (gp.backend, gp.operator_name) == ("iterative", "ski")
        return
    else:
        x = _scattered2(90)
        gp = tgp.GP.bind(_spec("se*matern32", backend="stochastic",
                               batch_size=16), x, np.sin(x[:, 0]),
                         device="cpu")
        s = teng.make_solver("stochastic", gp.cov, torch.tensor([0.3, -0.2]),
                             gp.x, gp.y, 0.1, opts=gp.spec.solver.opts,
                             op=gp.op)
        assert teng.profiled_grad(s).isfinite().all()
    assert (gp.backend, gp.operator_name) == ("stochastic", "pallas")
    assert isinstance(gp.op, topers.PallasTileOperator)
    plan = teng.select_stochastic(gp.op, gp.spec.solver.opts)
    assert plan.batch <= gp.n and plan.rank >= 2


@pytest.mark.parametrize("what", [
    "exact_grid", "near_grid", "near_grid_auto_policy", "scattered_ski",
    "precond_circulant", "operator_toeplitz"])
def test_ported_grid_branches_bind(what):
    """The branches the near-grid slice ported: exact grids bind the
    Toeplitz operator, near grids SKI with the fused kernels, scattered
    data under operator="ski" the unfused composition, and
    precond="circulant" resolves."""
    x, y = _irregular()
    grid = np.arange(3000.0)
    near = _near()
    theta = [5.0, 2.0, 0.0]
    if what == "exact_grid":
        gp = tgp.GP.bind(_spec(), grid, np.sin(grid), device="cpu")
        assert isinstance(gp.op, topers.ToeplitzOperator)
    elif what == "near_grid":
        gp = tgp.GP.bind(_spec(), near, np.sin(near), device="cpu")
        assert isinstance(gp.op, topers.SKIOperator) and gp.op.fused
        assert teng.select_fused(gp.op)
    elif what == "near_grid_auto_policy":
        # the default policy at n > 2048: iterative, SKI, fused, circulant
        spec = tgp.GPSpec("k1", noise=tgp.NoiseModel(0.01))
        gp = tgp.GP.bind(spec, near, np.sin(near), device="cpu")
        assert (gp.backend, gp.operator_name) == ("iterative", "ski")
        assert gp.op.fused and gp.n > 2048
        assert teng.select_precond(gp.op, teng.SolverOpts(
            precond="auto")) == "circulant"
    elif what == "scattered_ski":
        gp = tgp.GP.bind(_spec(operator="ski"), x, y, device="cpu")
        assert isinstance(gp.op, topers.SKIOperator) and not gp.op.fused
        assert gp.op.fused_geom is None
    elif what == "precond_circulant":
        gp = tgp.GP.bind(_spec(precond="circulant"), near, np.sin(near),
                         device="cpu")
        pc = tit.make_preconditioner(gp.op, torch.tensor(theta),
                                     "circulant")
        assert pc.choice == "circulant" and pc.slq is not None
    else:
        gp = tgp.GP.bind(_spec(operator="toeplitz"), grid, np.sin(grid),
                         device="cpu")
        assert gp.operator_name == "toeplitz"
    assert torch.isfinite(gp.log_likelihood(theta))


@pytest.mark.parametrize("grid", ["near", "exact"])
def test_batched_bank_binds_and_runs(grid, monkeypatch):
    """compare(batch="auto") on a grid runs the bank: a near grid binds
    the fused bank (B7; its plain version here) with the circulant
    preconditioner and the masked-circulant SLQ, an exact grid the
    unfused Toeplitz bank with the Strang SLQ."""
    x = _near(700) if grid == "near" else np.arange(600.0)
    specs = [_spec(k, precond="circulant") for k in ("k1", "se")]
    assert batchable(specs, x)
    bank = tbatch.BankOperator(("k1", "se"), torch.tensor(x), 0.1, 1e-8)
    assert bank.structure == grid and bank.fused == (grid == "near")
    assert bank.resolve_precond(specs[0].solver.opts) == "circulant"
    thetas = torch.tensor([[5.0, 2.0, 0.0], [2.0, 0.0, 0.0]])
    assert bank.bind_slq_precond(thetas, torch.float64) is not None
    if grid == "near":
        # the default policy at n > 2048 with sigma_n = 0.01: circulant
        big = tbatch.BankOperator(("k1", "se"), torch.tensor(_near()), 0.01,
                                  1e-8)
        assert big.n > 2048 and big.fused
        assert big.resolve_precond(teng.SolverOpts(precond="auto")) \
            == "circulant"
    trained = []
    train = tbatch.train_bank

    def spy(*args, **kwargs):
        trained.append(train(*args, **kwargs))
        return trained[-1]

    monkeypatch.setattr(tbatch, "train_bank", spy)
    reports = tgp.compare(specs, x, np.sin(x / 7.0), key=0, device="cpu")
    assert len(trained) == 1 and trained[0].bank.fused == (grid == "near")
    assert [r.name for r in reports] == ["k1", "se"]
    assert all(np.isfinite(r.log_p_max) for r in reports)


@pytest.mark.parametrize("what", ["kron", "product_ski_fused",
                                  "scattered_tiles"])
def test_ported_nd_branches_bind(what):
    """The branches the N-D slice ported: a composite kind on a full
    product grid binds the Kronecker operator, on a gappy field the fused
    product-SKI operator (B10/B11), on scattered (n, 2) points the product
    tiles (B8/B9)."""
    spec = _spec("se*matern32", precond="circulant")
    if what == "kron":
        x = _field()
        gp = tgp.GP.bind(spec, x, np.sin(x[:, 0]), device="cpu")
        assert isinstance(gp.op, topers.KroneckerOperator)
        assert gp.op.shape == (14, 10)
    elif what == "product_ski_fused":
        x = _gappy_field()
        gp = tgp.GP.bind(spec, x, np.sin(x[:, 0]), device="cpu")
        assert isinstance(gp.op, topers.ProductSKIOperator)
        assert gp.op.fused and teng.select_fused(gp.op)
        assert gp.op._sel_cells is not None
        pc = tit.make_preconditioner(gp.op, torch.tensor([0.3, -0.2]),
                                     "circulant")
        assert pc.choice == "circulant" and pc.slq is not None
    else:
        x = _scattered2()
        gp = tgp.GP.bind(spec, x, np.sin(x[:, 0]), device="cpu")
        assert isinstance(gp.op, topers.PallasTileOperator)
        assert gp.op.kinds == ("se", "matern32")
    assert gp.box.lo.shape == (2,)
    assert torch.isfinite(gp.log_likelihood([0.3, -0.2]))


def test_nd_binding_errors_match_the_jax_package():
    """A plain kind on (n, 2) points and a composite kind on a series
    raise the JAX package's ValueErrors; so does batch='on' on scattered
    (n, 2) points."""
    x = _field()
    with pytest.raises(ValueError, match=r"plain kind 'se' cannot cover"):
        tgp.GP.bind(_spec("se"), x, np.sin(x[:, 0]), device="cpu")
    with pytest.raises(ValueError, match=r"needs \(n, 2\) inputs"):
        tgp.GP.bind(_spec("se*se"), np.arange(50.0), np.zeros(50),
                    device="cpu")
    xs = _scattered2()
    with pytest.raises(ValueError, match="batch='on'"):
        tgp.compare([_spec("se*se"), _spec("se*matern32")], xs,
                    np.sin(xs[:, 0]), batch="on", device="cpu")
    assert not batchable([_spec("se*se"), _spec("se*matern32")], xs)
    assert batchable([_spec("se*se"), _spec("se*matern32")], _gappy_field())
    with pytest.raises(NotImplementedError, match="the rest of slice S2"):
        tgp.GP.bind(_spec("se*se"), x, np.sin(x[:, 0]),
                    device="cpu").op.diag(torch.zeros(2))


def test_irregular_data_binds_the_tile_operator():
    x, y = _irregular(2100)
    spec = _spec(backend="auto")
    gp = tgp.GP.bind(spec, x, y, device="cpu")
    assert (gp.backend, gp.operator_name) == ("iterative", "pallas")
    assert isinstance(gp.op, topers.PallasTileOperator)
    assert tit.resolve_precond("auto", gp.op) is None


def test_batch_on_refuses_an_irregular_bank():
    x, y = _irregular()
    with pytest.raises(ValueError, match="batch='on'"):
        tgp.compare([_spec("k1"), _spec("k2")], x, y, batch="on",
                    device="cpu")
    with pytest.raises(ValueError, match="unknown batch mode"):
        tgp.compare([_spec("k1")], x, y, batch="maybe", device="cpu")


def test_spec_validation_matches_the_jax_package():
    with pytest.raises(ValueError, match="unknown covariance"):
        tgp.GPSpec("nope")
    with pytest.raises(ValueError, match="unknown backend"):
        tgp.GPSpec("k1", solver=tgp.SolverPolicy(backend="gpu"))
    with pytest.raises(ValueError, match="unknown preconditioner"):
        _spec(precond="jacobi")
    assert tgp.GPSpec("k2", noise=0.05).noise.sigma_n == 0.05


@pytest.mark.parametrize("field,value,ok", [
    ("momentum", -0.1, False), ("momentum", 1.0, False),
    ("momentum", 0.0, True), ("momentum", 0.9, True),
    ("fused_tile_mb", -1, False), ("fused_tile_mb", 0, True),
    ("fused_tile_mb", 8, True)])
def test_spec_checks_the_stochastic_and_tile_budget_fields(field, value, ok):
    """momentum in [0, 1) and fused_tile_mb >= 0, with the JAX package's
    messages."""
    if ok:
        assert _spec(**{field: value}).solver.opts._asdict()[field] == value
        return
    with pytest.raises(ValueError, match=(
            r"momentum must be in \[0, 1\)" if field == "momentum"
            else "fused_tile_mb must be >= 0 MB")):
        _spec(**{field: value})
