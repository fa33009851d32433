"""The GP session: one front door for the paper's workflow.

Counterpart of ``repro/gp/session.py``.  ``GP.bind(spec, x, y)`` does the
host-side work once — backend resolution, hyperprior box, structure probe
and operator selection — and returns a session whose ``fit``,
``log_likelihood``, ``log_evidence`` and ``predict`` run on it.  Sessions
are immutable: ``fit`` returns a new, fitted session.

    gp = GP.bind(GPSpec("k2", solver=SolverPolicy(backend="iterative")),
                 x, y, device="cuda").fit(random.key(0))
    lnz = gp.log_evidence().log_z
    post = gp.predict(xstar)

``device=None`` means the card.  The port runs the iterative backend on
the tile operator (irregular x), the Toeplitz operator (an exact grid),
the SKI operator (a near grid: a gappy record), and for a composite
"a*b" kind on (n, d) x the Kronecker operator (a full product grid) and
the product-SKI operator (a gappy field); and the stochastic backend on
the tile operator (structure-free data at large n).  Everything else
raises and names the slice that brings it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _pending
from .. import random as rnd
from .._device import as_tensor, resolve_device
from ..core import engine as eng
from ..core import laplace as _laplace
from ..core import predict as _predict
from ..core import stochastic as _stochastic
from ..core import train as _train
from ..core.covariances import Covariance
from ..core.reparam import FlatBox, flat_box
from ..kernels import operators as kopers
from .spec import GPSpec


def _as_key(key):
    if key is None or isinstance(key, rnd.Key):
        return key
    return rnd.key(int(key))


class GP:
    """A GPSpec bound to one data set (construct with :meth:`bind`)."""

    def __init__(self, spec: GPSpec, x, y, box: FlatBox, backend: str,
                 jitter: float, kind: Optional[str], op, result=None):
        self.spec = spec
        self.x = x
        self.y = y
        self.box = box
        self.backend = backend
        self.jitter = jitter
        self.kind = kind
        self.op = op
        self.result = result          # TrainResult after fit()

    @classmethod
    def bind(cls, spec: GPSpec, x, y, device=None,
             dtype: torch.dtype = torch.float64) -> "GP":
        """Bind a spec to data: backend, box and operator, decided once.

        The backend resolves as in the JAX package: "auto" gives dense up
        to ``dense_cutoff`` points and iterative above, and structure-free
        data (the "pallas" operator) at n >=
        ``core.stochastic.STOCHASTIC_AUTO_MIN_N`` escalates to stochastic.
        An explicit "stochastic" binds the tile operator unless the spec
        names another (the iteration applies exact kernel rows; the
        operator supplies its column oracles and tangents).  The dense
        backend is not ported.
        """
        dev = resolve_device(device)
        x = as_tensor(x, dev, dtype)
        y = as_tensor(y, dev, dtype)
        cov = spec.cov
        n = int(y.shape[0])
        backend = spec.solver.resolve_backend(n)
        if backend == "dense":
            raise _pending.pending(f"backend 'dense' (n = {n})",
                                   _pending.DENSE)
        jitter = spec.noise.jitter_for(backend)
        if spec.box is not None:
            box = FlatBox(as_tensor(spec.box.lo, dev, dtype),
                          as_tensor(spec.box.hi, dev, dtype))
        else:
            box = flat_box(cov, x)
        kind = eng.resolve_kind(cov)
        operator = spec.solver.opts.operator
        if backend == "stochastic" and operator is None:
            operator = "pallas"
        op = kopers.select_operator(kind, x, float(spec.noise.sigma_n),
                                    float(jitter), operator=operator,
                                    fused=spec.solver.opts.fused)
        # the three-way auto dispatch: no grid structure at large n leaves
        # the O(n^2)-per-CG-iteration exact path for the O(b n)-per-step
        # stochastic one
        if (backend == "iterative" and spec.solver.backend == "auto"
                and op.name == "pallas"
                and n >= _stochastic.STOCHASTIC_AUTO_MIN_N):
            backend = "stochastic"
        return cls(spec, x, y, box, backend, jitter, kind, op)

    @property
    def cov(self) -> Covariance:
        return self.spec.cov

    @property
    def n(self) -> int:
        return int(self.y.shape[0])

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def operator_name(self) -> str:
        return self.op.name

    @property
    def theta_hat(self):
        if self.result is None:
            raise ValueError("session is not fitted; call fit(key) first "
                             "or pass theta= explicitly")
        return self.result.theta_hat

    def __repr__(self):
        fitted = "fitted" if self.result is not None else "unfitted"
        return (f"GP({self.spec.name!r}, n={self.n}, "
                f"backend={self.backend!r}, "
                f"operator={self.operator_name!r}, {fitted})")

    def fit(self, key, n_starts: Optional[int] = None,
            max_iters: Optional[int] = None,
            grad_tol: Optional[float] = None,
            scan_points: Optional[int] = None,
            box: Optional[FlatBox] = None, z0s=None) -> "GP":
        """Multi-start NCG on the profiled hyperlikelihood (Sec. 3a).

        Budgets default to the spec's :class:`SolverPolicy`
        (``scan_points=None``: no scan on the iterative backend).  Returns a
        new fitted session carrying the box it was trained in.
        """
        pol = self.spec.solver
        sp = scan_points if scan_points is not None else pol.scan_points
        if sp is None:
            sp = 0
        fit_box = self.box if box is None else FlatBox(
            as_tensor(box[0], self.device, self.x.dtype),
            as_tensor(box[1], self.device, self.x.dtype))
        if z0s is not None:
            z0s = as_tensor(z0s, self.device, self.x.dtype)
        res = _train._train_impl(
            self.cov, self.x, self.y, self.spec.noise.sigma_n, _as_key(key),
            n_starts=n_starts if n_starts is not None else pol.n_starts,
            max_iters=max_iters if max_iters is not None else pol.max_iters,
            grad_tol=grad_tol if grad_tol is not None else pol.grad_tol,
            jitter=self.jitter, box=fit_box, z0s=z0s, scan_points=sp,
            backend=self.backend, solver_opts=pol.opts, op=self.op)
        return GP(self.spec, self.x, self.y, fit_box, self.backend,
                  self.jitter, self.kind, self.op, result=res)

    def log_likelihood(self, theta, key=None):
        """ln P_max(theta) (eq. 2.16)."""
        solver = eng.make_solver(
            self.backend, self.cov,
            as_tensor(theta, self.device, self.x.dtype), self.x, self.y,
            self.spec.noise.sigma_n,
            key=_as_key(key) if key is not None else rnd.key(0),
            jitter=self.jitter, opts=self.spec.solver.opts, op=self.op)
        return eng.profiled_loglik(solver)

    def log_evidence(self, method: str = "laplace", key=None, theta=None,
                     multimodal: Optional[bool] = None,
                     jeffreys_norm: float = 1.0):
        """Laplace hyperevidence ln Z (eq. 2.13).

        At an explicit ``theta``: the single-mode estimate.  Otherwise the
        session must be fitted, and ``multimodal`` (default: the spec
        policy) sums the evidence over the distinct restart peaks.
        """
        if method == "nested":
            raise _pending.pending("the nested-sampling evidence",
                                   _pending.DENSE)
        if method != "laplace":
            raise ValueError(f"unknown evidence method {method!r}; choose "
                             f"'laplace' or 'nested'")
        pol = self.spec.solver
        sigma_n = self.spec.noise.sigma_n
        key = _as_key(key)
        common = dict(jeffreys_norm=jeffreys_norm, jitter=self.jitter,
                      backend=self.backend, key=key, solver_opts=pol.opts,
                      op=self.op)
        if theta is not None:
            return _laplace._evidence_profiled_impl(
                self.cov, as_tensor(theta, self.device, self.x.dtype),
                self.x, self.y, sigma_n, self.box, **common)
        res = self.result
        if res is None:
            raise ValueError("log_evidence() needs a fitted session or an "
                             "explicit theta=")
        mm = pol.multimodal if multimodal is None else multimodal
        if mm:
            return _laplace._evidence_multimodal_impl(
                self.cov, res.theta_all, res.log_p_all, self.x, self.y,
                sigma_n, self.box, **common)
        return _laplace._evidence_profiled_impl(
            self.cov, res.theta_hat, self.x, self.y, sigma_n, self.box,
            **common)

    def predict(self, xstar, theta=None, compute_var: bool = True,
                include_noise: Optional[bool] = None, key=None,
                var_chunk: int = 256, cross: str = "interp"):
        """Posterior mean and variance at xstar (eq. 2.1), sigma_f profiled.

        Uses the fitted peak unless ``theta`` overrides.  Near-grid (SKI)
        sessions interpolate the test points onto the same inducing grid
        (``cross="interp"``, the default), so no (n, n*) block is built;
        ``cross="exact"`` and the other operators take the exact cross
        covariance.  The SKI variance solves ``var_chunk`` test points at
        a time.
        """
        th = theta if theta is not None else self.theta_hat
        inc = (self.spec.noise.include_noise if include_noise is None
               else include_noise)
        return _predict._predict_impl(
            self.cov, as_tensor(th, self.device, self.x.dtype), self.x,
            self.y, as_tensor(xstar, self.device, self.x.dtype),
            self.spec.noise.sigma_n, include_noise=inc, jitter=self.jitter,
            backend=self.backend, key=_as_key(key),
            solver_opts=self.spec.solver.opts, compute_var=compute_var,
            op=self.op, var_chunk=var_chunk, cross=cross)
