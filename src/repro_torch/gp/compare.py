"""Model comparison through the front door (paper Secs. 2-3).

Counterpart of ``repro/gp/compare.py``.  ``compare(specs, x, y, key=...)``
evaluates candidate kernels on one data set and returns the
:class:`ModelReport` list, by one of two paths, as in the JAX package:

  * batched (``batch="auto"`` or ``"on"``): on an exact or near 1-D grid,
    or a "kron" or "product" (n, d) grid with one factor per axis in
    every composite kind (:func:`batchable`), with every spec on the
    iterative backend, the whole bank of models x restarts trains as one
    program (:mod:`repro_torch.gp.batch`; on a 1-D near grid one B7
    launch per CG or Lanczos iteration, on (n, d) grids the unfused
    Kronecker cycle on ``torch.fft``), and the Laplace Hessians of every
    model's modes come from 2 m_max batched gradient evaluations;
  * sequential (``batch="off"``, not batchable, any spec on the dense
    backend, or ``run_nested``): one bound session per spec, bind -> fit
    -> log_evidence, and with ``run_nested`` the nested-sampling baseline
    (:mod:`repro_torch.core.nested`) from the fourth key of each model's
    split.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from .. import random as rnd
from .._device import as_tensor, resolve_device
from ..core import hyperlik as hl
from ..core import laplace as _laplace
from ..core.model_compare import ModelReport, log_bayes_factors
from ..core.reparam import FlatBox, flat_box, log_prior_volume
from ..data.grid import classify_grid, classify_grid_nd
from ..kernels import ops as kops
from . import batch as _batch
from .session import GP
from .spec import GPSpec, as_spec

__all__ = ["compare", "log_bayes_factors", "batchable"]


def batchable(specs: Sequence[GPSpec], x) -> bool:
    """True when the candidate bank can train as one batched program:
    1-D inputs on an exact or near grid, or (n, d) inputs on a "kron" or
    "product" grid with one registered factor per axis in every spec, and
    a shared policy."""
    if len(specs) < 2:
        return False
    xa = np.asarray(x.detach().cpu() if hasattr(x, "detach") else x)
    d = int(xa.shape[1]) if xa.ndim == 2 else 1
    if d >= 2:
        try:
            if classify_grid_nd(xa).kind not in ("kron", "product"):
                return False
        except ValueError:
            return False
    elif classify_grid(xa).kind not in ("exact", "near"):
        return False
    first = specs[0]
    for s in specs:
        try:
            factors = kops.split_kind(s.name)
        except ValueError:
            return False
        if len(factors) != d:
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

    ``device=None`` means the card.  ``batch``: "auto" batches when
    eligible, "on" forces it (raising if the bank cannot run batched),
    "off" runs the sequential path.  ``run_nested`` adds the
    nested-sampling baseline (``n_live`` live points, at most
    ``nested_max_iter`` iterations), always sequential.
    """
    if key is None:
        key = rnd.key(0)
    elif not isinstance(key, rnd.Key):
        key = rnd.key(int(key))
    specs = [as_spec(s) for s in specs]
    if batch not in ("auto", "on", "off"):
        raise ValueError(f"unknown batch mode {batch!r}; choose "
                         f"'auto', 'on' or 'off'")
    n = int(len(y))
    backend_ok = all(s.solver.resolve_backend(n) == "iterative"
                     for s in specs)
    eligible = batchable(specs, x) and backend_ok
    if batch == "on" and run_nested:
        raise ValueError(
            "batch='on' is incompatible with run_nested=True: the "
            "nested-sampling baseline is never batched — use batch='auto' "
            "or 'off' when requesting it")
    if batch == "on" and not eligible:
        raise ValueError(
            "batch='on' but the candidate bank cannot run batched: needs "
            ">= 2 specs sharing noise + solver policy, every spec "
            "resolving to the iterative backend, registered kernel tiles, "
            "no explicit operator override, precond None|'circulant'|"
            "'pivchol'|'auto' and inputs classifying 'exact'/'near' "
            "(data.grid.classify_grid)")
    if batch != "off" and eligible and not run_nested:
        return _compare_batched(specs, x, y, key, device=device, dtype=dtype)
    return _compare_sequential(specs, x, y, key, run_nested=run_nested,
                               n_live=n_live,
                               nested_max_iter=nested_max_iter,
                               device=device, dtype=dtype)


def _compare_sequential(specs, x, y, key, run_nested=False, n_live=400,
                        nested_max_iter=20000, device=None,
                        dtype=torch.float64) -> list[ModelReport]:
    reports = []
    for spec in specs:
        key, kt, kl, kn = rnd.split(key, 4)
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
        rep = ModelReport(
            name=spec.name,
            theta_hat=tr.theta_hat,
            sigma_f_hat=float(tr.sigma_f_hat),
            log_p_max=float(tr.log_p_max),
            log_z_laplace=log_z,
            errors=lap.errors if lap is not None else torch.zeros(0),
            n_evals_train=n_evals,
            n_modes=n_modes,
        )
        if run_nested:
            ns = gp.log_evidence(method="nested", key=kn, n_live=n_live,
                                 max_iter=nested_max_iter)
            rep.log_z_nested = float(ns.log_z)
            rep.log_z_nested_err = float(ns.log_z_err)
            rep.n_evals_nested = int(ns.n_evals)
        reports.append(rep)
    return reports


def _bank_boxes(specs, x) -> list[FlatBox]:
    """Each spec's flat box as tensors on x's device (the data-dependent
    box where a spec has none)."""
    return [FlatBox(as_tensor(s.box.lo, x.device, x.dtype),
                    as_tensor(s.box.hi, x.device, x.dtype))
            if s.box is not None else flat_box(s.cov, x) for s in specs]


def _compare_batched(specs, x, y, key, device=None,
                     dtype=torch.float64) -> list[ModelReport]:
    """Train the whole bank (:func:`~repro_torch.gp.batch.train_bank`),
    then its Laplace stage (:func:`bank_laplace`)."""
    dev = resolve_device(device)
    x = as_tensor(x, dev, dtype)
    y = as_tensor(y, dev, dtype)
    pol = specs[0].solver
    noise = specs[0].noise
    boxes = _bank_boxes(specs, x)
    key, kt, kl = rnd.split(key, 3)
    tr = _batch.train_bank([s.cov for s in specs], x, y, noise.sigma_n, kt,
                           boxes=boxes, n_starts=pol.n_starts,
                           max_iters=pol.max_iters, grad_tol=pol.grad_tol,
                           jitter=noise.jitter_for("iterative"),
                           opts=pol.opts)
    return bank_laplace(specs, tr, boxes, x, y, kl)


def bank_laplace(specs, tr: _batch.BankTrainResult, boxes, x, y,
                 key) -> list[ModelReport]:
    """The Laplace stage of the batched compare on a bank fit ``tr``.

    Each model's distinct restart peaks (its modes) are collected on the
    host and stacked into one modes bank, on the training bank's geometry;
    its values and the central-difference Hessians of every mode take
    2 m_max + 1 batched evaluations; per-mode evidences are summed within
    each model.
    """
    n = int(y.shape[0])
    pol = specs[0].solver
    noise = specs[0].noise
    covs = [s.cov for s in specs]
    K = len(covs)
    m_max = int(tr.theta_hat.shape[1])
    modes_per_model = []
    for k_i in range(K):
        modes = (_laplace.dedupe_modes(tr.theta_all[:, k_i],
                                       tr.log_p_all[:, k_i])
                 if pol.multimodal else [])
        if not modes:                 # single-mode, or all degenerate
            modes = [tr.theta_hat[k_i].detach().cpu().numpy()]
        modes_per_model.append(modes)
    owners = [k_i for k_i, ms in enumerate(modes_per_model) for _ in ms]
    mode_thetas = torch.as_tensor(
        np.stack([m for ms in modes_per_model for m in ms]),
        dtype=x.dtype, device=x.device)                      # (M, m_max)
    mbank = _batch.BankOperator(tuple(tr.bank.kinds[k_i] for k_i in owners),
                                x, noise.sigma_n,
                                noise.jitter_for("iterative"), like=tr.bank)
    mbox = _batch.pad_boxes([boxes[k_i] for k_i in owners], m_max)
    mobj = _batch.make_bank_objective(
        mbank, FlatBox(mbox.lo.to(x.device), mbox.hi.to(x.device)), y,
        rnd.fold_in(key, _batch.PROBE_KEY), pol.opts)
    lp_modes, _ = mobj.stats_theta(mode_thetas)                # (M,)
    H = _batch.bank_fd_hessians(mobj.value_and_grad_theta, mode_thetas,
                                step=pol.opts.fd_step)
    mconst = hl.marginal_const(n)
    log_vs = [log_prior_volume(covs[k_i], boxes[k_i]) for k_i in range(K)]
    mode_log_z, mode_errors = [], []
    for j, k_i in enumerate(owners):
        m_k = tr.m_params[k_i]
        Hj = -H[j][:m_k, :m_k]
        lz, logdet = _laplace._laplace_log_z(lp_modes[j] + mconst,
                                             log_vs[k_i], Hj)
        mode_log_z.append(float(lz))
        if bool(torch.isfinite(logdet)):      # every eigenvalue positive
            mode_errors.append(torch.sqrt(torch.clamp(
                torch.diagonal(torch.linalg.inv(Hj)), min=0.0)))
        else:
            mode_errors.append(torch.full((m_k,), torch.nan,
                                          dtype=Hj.dtype, device=Hj.device))
    reports = []
    pos = 0
    for k_i, spec in enumerate(specs):
        n_modes = len(modes_per_model[k_i])
        lz_modes = np.asarray(mode_log_z[pos:pos + n_modes])
        errs = mode_errors[pos:pos + n_modes]
        pos += n_modes
        best_j = (int(np.nanargmax(np.where(np.isfinite(lz_modes),
                                            lz_modes, -np.inf)))
                  if np.isfinite(lz_modes).any() else 0)
        m_k = tr.m_params[k_i]
        reports.append(ModelReport(
            name=spec.name,
            theta_hat=tr.theta_hat[k_i][:m_k],
            sigma_f_hat=float(tr.sigma_f_hat[k_i]),
            log_p_max=float(tr.log_p_max[k_i]),
            log_z_laplace=_laplace.logsumexp_modes(lz_modes),
            errors=errs[best_j],
            n_evals_train=int(tr.n_evals[k_i]) + n_modes,
            n_modes=n_modes,
        ))
    return reports
