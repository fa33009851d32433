"""Boundaries of the port: imports, devices, launch counts and refusals."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import _pending  # noqa: F401  (imported for its module)
from repro_torch import gp as tgp
from repro_torch.core import engine as teng
from repro_torch.core import iterative as tit
from repro_torch.core.covariances import resolve
from repro_torch.kernels import _cuda
from repro_torch.kernels import kernel_matvec as tkm
from repro_torch.kernels import kernel_tile as tkt
from repro_torch.kernels import operators as topers
from repro_torch.kernels import ops as tops


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
    ROOT / "chip_smoke.py"]


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


@pytest.mark.parametrize("what", [
    "backend_dense", "backend_stochastic", "auto_small_n", "auto_huge_n",
    "operator_toeplitz", "operator_ski", "operator_lowrank",
    "precond_pivchol", "precond_circulant", "precond_rank",
    "exact_grid", "near_grid", "composite_kind", "dense_only_kind",
    "nested_evidence", "batched_bank"])
def test_unported_branches_raise_not_implemented(what):
    x, y = _irregular()
    grid = np.arange(3000.0)
    near = np.delete(np.arange(3000.0), np.arange(5, 3000, 7))
    cases = {
        "backend_dense": lambda: tgp.GP.bind(_spec(backend="dense"), x, y,
                                             device="cpu"),
        "backend_stochastic": lambda: tgp.GP.bind(
            _spec(backend="stochastic"), x, y, device="cpu"),
        "auto_small_n": lambda: tgp.GP.bind(_spec(backend="auto"), x, y,
                                            device="cpu"),
        "auto_huge_n": lambda: tgp.GP.bind(
            _spec(backend="auto"), *_irregular(65536), device="cpu"),
        "operator_toeplitz": lambda: tgp.GP.bind(
            _spec(operator="toeplitz"), x, y, device="cpu"),
        "operator_ski": lambda: tgp.GP.bind(_spec(operator="ski"), x, y,
                                            device="cpu"),
        "operator_lowrank": lambda: tgp.GP.bind(
            _spec(operator="lowrank"), x, y, device="cpu"),
        "precond_pivchol": lambda: tgp.GP.bind(
            _spec(precond="pivchol"), x, y, device="cpu").log_likelihood(
                [5.0, 2.0, 0.0]),
        "precond_circulant": lambda: tgp.GP.bind(
            _spec(precond="circulant"), x, y, device="cpu").log_likelihood(
                [5.0, 2.0, 0.0]),
        "precond_rank": lambda: tgp.GP.bind(
            _spec(precond_rank=8), x, y, device="cpu").log_likelihood(
                [5.0, 2.0, 0.0]),
        "exact_grid": lambda: tgp.GP.bind(_spec(), grid, np.sin(grid),
                                          device="cpu"),
        "near_grid": lambda: tgp.GP.bind(_spec(), near, np.sin(near),
                                         device="cpu"),
        "composite_kind": lambda: resolve("se*matern32"),
        "dense_only_kind": lambda: resolve("periodic"),
        "nested_evidence": lambda: tgp.GP.bind(_spec(), x, y, device="cpu")
        .log_evidence(method="nested"),
        "batched_bank": lambda: tgp.compare([_spec("k1"), _spec("k2")], near,
                                            np.sin(near), device="cpu"),
    }
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cases[what]()


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
