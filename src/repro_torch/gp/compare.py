"""Model comparison through the front door (paper Secs. 2-3).

Counterpart of ``repro/gp/compare.py``.  ``compare(specs, x, y, key=...)``
runs each candidate kernel through bind -> fit -> log_evidence and returns
the :class:`ModelReport` list.  Only the sequential path is ported: the
JAX package batches a bank only on exact or near grids (:func:`batchable`),
which irregular x never is, and a batchable bank raises here instead of
quietly running one by one.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from .. import _pending
from .. import random as rnd
from ..core.model_compare import ModelReport, log_bayes_factors
from ..data.grid import classify_grid
from ..kernels.ref import KINDS
from .session import GP
from .spec import GPSpec, as_spec

__all__ = ["compare", "log_bayes_factors", "batchable"]


def batchable(specs: Sequence[GPSpec], x) -> bool:
    """True when the JAX package would train the bank as one batched
    program (1-D inputs on an exact or near grid, shared policy)."""
    if len(specs) < 2:
        return False
    if getattr(x, "ndim", 1) != 1:
        raise _pending.pending("multi-axis inputs", _pending.ND)
    if classify_grid(x).kind not in ("exact", "near"):
        return False
    first = specs[0]
    for s in specs:
        if "*" in s.name or s.name not in KINDS:
            return False
        if s.noise != first.noise or s.solver != first.solver:
            return False
        if s.solver.opts.operator is not None:
            return False
        if s.solver.opts.precond not in (None, "circulant", "pivchol",
                                         "auto"):
            return False
    return True


def compare(specs: Sequence[Union[GPSpec, str]], x, y, key=None,
            run_nested: bool = False, n_live: int = 400,
            nested_max_iter: int = 20000, batch: str = "auto",
            device=None, dtype: torch.dtype = torch.float64
            ) -> list[ModelReport]:
    """Compare candidate covariances by Laplace hyperevidence.

    ``device=None`` means the card.  ``batch`` keeps the JAX package's
    meaning; only its sequential path is ported.
    """
    if key is None:
        key = rnd.key(0)
    elif not isinstance(key, rnd.Key):
        key = rnd.key(int(key))
    specs = [as_spec(s) for s in specs]
    if batch not in ("auto", "on", "off"):
        raise ValueError(f"unknown batch mode {batch!r}; choose "
                         f"'auto', 'on' or 'off'")
    if run_nested:
        raise _pending.pending("the nested-sampling baseline",
                               _pending.DENSE)
    n = int(len(y))
    backend_ok = all(s.solver.resolve_backend(n) == "iterative"
                     for s in specs)
    eligible = batchable(specs, x) and backend_ok
    if batch == "on" and not eligible:
        raise ValueError(
            "batch='on' but the candidate bank cannot run batched: needs "
            ">= 2 specs sharing noise + solver policy, every spec "
            "resolving to the iterative backend, registered kernel tiles, "
            "no explicit operator override, precond None|'circulant'|"
            "'pivchol'|'auto' and inputs classifying 'exact'/'near' "
            "(data.grid.classify_grid)")
    if batch != "off" and eligible:
        raise _pending.pending("batched bank comparison", _pending.BANK)
    return _compare_sequential(specs, x, y, key, device=device, dtype=dtype)


def _compare_sequential(specs, x, y, key, device=None,
                        dtype=torch.float64) -> list[ModelReport]:
    reports = []
    for spec in specs:
        key, kt, kl, _ = rnd.split(key, 4)
        gp = GP.bind(spec, x, y, device=device, dtype=dtype).fit(kt)
        tr = gp.result
        n_evals = int(tr.n_evals)
        if spec.solver.multimodal:
            mm = gp.log_evidence(key=kl, multimodal=True)
            log_z = float(mm.log_z)
            lap = mm.best
            n_modes = mm.n_modes
            n_evals += n_modes
        else:
            lap = gp.log_evidence(key=kl, multimodal=False)
            log_z = float(lap.log_z)
            n_modes = 1
            n_evals += 1
        reports.append(ModelReport(
            name=spec.name,
            theta_hat=tr.theta_hat,
            sigma_f_hat=float(tr.sigma_f_hat),
            log_p_max=float(tr.log_p_max),
            log_z_laplace=log_z,
            errors=lap.errors if lap is not None else torch.zeros(0),
            n_evals_train=n_evals,
            n_modes=n_modes,
        ))
    return reports
