"""Carry a session's or a bank's state across from the JAX package.

A JAX session's state, handed over as plain numbers and numpy arrays, is
turned into the port's: the spec (kernel name, NoiseModel, SolverPolicy and
SolverOpts values), the flat box (lo, hi) and the TrainResult.  With it the
port's ``log_evidence``, ``predict`` and ``sample`` run on a fit made by
the JAX package, so each stage can be checked on its own; a dense fit
(n <= dense_cutoff) comes across with no operator, as it was bound.  Multi-axis sessions
and banks (composite kinds on (n, d) x) come across the same way: the
port binds its own operator on x and takes the state as it is.  A JAX
``BankTrainResult`` comes across the same way (:func:`bank_from_state`),
for the Laplace stage of the batched compare.

``state`` layout (every array a numpy array)::

    {"kernel": "k2",
     "noise": {"sigma_n": ..., "jitter": ..., "include_noise": ...},
     "solver": {"backend": ..., "n_starts": ..., ..., "opts": {...}},
     "box": (lo, hi),
     "result": {"theta_hat", "theta_all", "log_p_all", "sigma_f_hat",
                "log_p_max", "n_evals", "iters_all"}}
"""

from __future__ import annotations

import torch

from .._device import as_tensor, resolve_device
from ..core import engine as eng
from ..core.engine import SolverOpts
from ..core.reparam import FlatBox
from ..core.train import TrainResult
from .batch import BankOperator, BankTrainResult
from .session import GP
from .spec import GPSpec, NoiseModel, SolverPolicy


def spec_from_state(state: dict) -> GPSpec:
    noise = NoiseModel(**state["noise"])
    solver = dict(state["solver"])
    opts = SolverOpts(**solver.pop("opts"))
    return GPSpec(kernel=state["kernel"], noise=noise,
                  solver=SolverPolicy(opts=opts, **solver))


def box_from_state(box, device, dtype=torch.float64) -> FlatBox:
    lo, hi = box
    return FlatBox(as_tensor(lo, device, dtype), as_tensor(hi, device, dtype))


def result_from_state(result: dict, device,
                      dtype=torch.float64) -> TrainResult:
    return TrainResult(
        theta_hat=as_tensor(result["theta_hat"], device, dtype),
        log_p_max=as_tensor(result["log_p_max"], device, dtype),
        sigma_f_hat=as_tensor(result["sigma_f_hat"], device, dtype),
        n_evals=int(result["n_evals"]),
        theta_all=as_tensor(result["theta_all"], device, dtype),
        log_p_all=as_tensor(result["log_p_all"], device, dtype),
        iters_all=torch.as_tensor(result["iters_all"]))


def session_from_state(state: dict, x, y, device=None,
                       dtype=torch.float64) -> GP:
    """A fitted port session on (x, y) carrying the JAX session's state."""
    dev = resolve_device(device)
    spec = spec_from_state(state)
    box = box_from_state(state["box"], dev, dtype)
    gp = GP.bind(spec.with_box(box), x, y, device=dev, dtype=dtype)
    result = (result_from_state(state["result"], dev, dtype)
              if state.get("result") is not None else None)
    return GP(gp.spec, gp.x, gp.y, box, gp.backend, gp.jitter, gp.kind,
              gp.op, result=result)


def bank_from_state(specs, bank_state: dict, x, device=None,
                    dtype=torch.float64):
    """A JAX bank fit on x as the port's (BankTrainResult, boxes).

    ``bank_state`` holds the JAX ``BankTrainResult``'s ``theta_hat``,
    ``theta_all``, ``log_p_all``, ``iters_all``, ``sigma_f_hat``,
    ``log_p_max``, ``n_evals`` and ``m_params`` as numpy arrays, and
    ``boxes``, the padded (K, m_max) box (lo, hi).  The port binds its own
    training bank on x (the specs' kinds times the restarts, their noise
    and fused mode); the boxes come back unpadded, one per model.
    """
    dev = resolve_device(device)
    x = as_tensor(x, dev, dtype)
    m_params = tuple(int(m) for m in bank_state["m_params"])
    lo, hi = (as_tensor(a, dev, dtype) for a in bank_state["boxes"])
    boxes = [FlatBox(lo[k, :m], hi[k, :m]) for k, m in enumerate(m_params)]
    R = int(bank_state["theta_all"].shape[0])
    noise = specs[0].noise
    bank = BankOperator(tuple(eng.resolve_kind(s.cov) for s in specs) * R,
                        x, noise.sigma_n, noise.jitter_for("iterative"),
                        fused=specs[0].solver.opts.fused)
    t = {f: as_tensor(bank_state[f], dev, dtype)
         for f in ("theta_hat", "theta_all", "log_p_all", "sigma_f_hat",
                   "log_p_max")}
    tr = BankTrainResult(
        names=tuple(s.name for s in specs), m_params=m_params, bank=bank,
        n_evals=torch.as_tensor(bank_state["n_evals"]),
        iters_all=torch.as_tensor(bank_state["iters_all"]), **t)
    return tr, boxes
