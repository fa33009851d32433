"""Carry a session's state across from the JAX package.

A JAX session's state, handed over as plain numbers and numpy arrays, is
turned into the port's: the spec (kernel name, NoiseModel, SolverPolicy and
SolverOpts values), the flat box (lo, hi) and the TrainResult.  With it the
port's ``log_evidence`` and ``predict`` run on a fit made by the JAX
package, so each stage can be checked on its own.

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
from ..core.engine import SolverOpts
from ..core.reparam import FlatBox
from ..core.train import TrainResult
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
