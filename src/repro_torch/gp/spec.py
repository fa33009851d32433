"""Declarative GP model specification.

Counterpart of ``repro/gp/spec.py``: a frozen :class:`GPSpec` says which
covariance, what noise model, where the flat hyperprior box sits and how to
solve.  It is a plain frozen dataclass (no pytree: nothing here is traced).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..core import covariances as C
from ..core.covariances import Covariance
from ..core.engine import BACKENDS, SolverOpts
from ..core.iterative import PRECOND_CHOICES
from ..core.reparam import FlatBox
from ..kernels.ski_fused import FUSED_CHOICES


class NoiseModel(NamedTuple):
    """Fixed fractional noise sigma_n (inside the sigma_f^2 envelope,
    eq. 3.1); ``jitter`` None means the per-backend default (1e-10 dense,
    1e-8 iterative); ``include_noise`` is the predictive-variance default."""

    sigma_n: float = 0.1
    jitter: Optional[float] = None
    include_noise: bool = False

    def jitter_for(self, backend: str) -> float:
        if self.jitter is not None:
            return float(self.jitter)
        return 1e-10 if backend == "dense" else 1e-8


class SolverPolicy(NamedTuple):
    """Backend, engine knobs and NCG budget.  "auto" picks dense up to
    ``dense_cutoff`` points and iterative above; at bind time structure-free
    data at n >= STOCHASTIC_AUTO_MIN_N escalates to the stochastic backend.
    """

    backend: str = "auto"
    opts: SolverOpts = SolverOpts()
    n_starts: int = 10
    max_iters: int = 80
    grad_tol: float = 1e-5
    scan_points: Optional[int] = None
    multimodal: bool = True
    dense_cutoff: int = 2048

    def resolve_backend(self, n: int) -> str:
        if self.backend == "auto":
            return "dense" if n <= self.dense_cutoff else "iterative"
        return self.backend


@dataclasses.dataclass(frozen=True)
class GPSpec:
    """Frozen description of one GP model.

    kernel: a registered covariance name or a :class:`Covariance`.
    box: flat-hyperprior box; None derives the data-dependent box at bind.
    noise: :class:`NoiseModel` (a bare float is promoted to one).
    solver: :class:`SolverPolicy`.
    """

    kernel: Union[str, Covariance]
    box: Optional[FlatBox] = None
    noise: NoiseModel = NoiseModel()
    solver: SolverPolicy = SolverPolicy()

    def __post_init__(self):
        if isinstance(self.noise, (int, float)):
            object.__setattr__(self, "noise",
                               NoiseModel(sigma_n=float(self.noise)))
        if isinstance(self.kernel, str):
            try:
                C.resolve(self.kernel)
            except KeyError:
                raise ValueError(
                    f"unknown covariance kind {self.kernel!r}; registered "
                    f"kinds: {sorted(C.REGISTRY)}, '*'-joined for "
                    f"separable multi-axis products (or pass a Covariance "
                    f"object)") from None
        if self.solver.backend not in ("auto",) + BACKENDS:
            raise ValueError(
                f"unknown backend {self.solver.backend!r}; choose from "
                f"{('auto',) + BACKENDS}")
        pc = self.solver.opts.precond
        if pc is not None and pc not in PRECOND_CHOICES:
            raise ValueError(f"unknown preconditioner {pc!r}; choose from "
                             f"{PRECOND_CHOICES} or None")
        fu = self.solver.opts.fused
        if fu not in FUSED_CHOICES:
            raise ValueError(
                f"unknown fused mode {fu!r}; choose from {FUSED_CHOICES}")
        mu = self.solver.opts.momentum
        if not 0.0 <= float(mu) < 1.0:
            raise ValueError(
                f"momentum must be in [0, 1), got {mu!r} (0 disables the "
                "stochastic backend's heavy-ball velocity)")
        if int(self.solver.opts.fused_tile_mb) < 0:
            raise ValueError(
                "fused_tile_mb must be >= 0 MB (0 = the FUSED_TILE_MB "
                f"default), got {self.solver.opts.fused_tile_mb!r}")
        if self.box is not None and not isinstance(self.box, FlatBox):
            object.__setattr__(self, "box", FlatBox(*self.box))

    @property
    def cov(self) -> Covariance:
        return (C.resolve(self.kernel) if isinstance(self.kernel, str)
                else self.kernel)

    @property
    def name(self) -> str:
        return self.kernel if isinstance(self.kernel, str) \
            else self.kernel.name

    def with_box(self, box: FlatBox) -> "GPSpec":
        return dataclasses.replace(self, box=box)


def as_spec(model, noise: Optional[NoiseModel] = None,
            solver: Optional[SolverPolicy] = None) -> GPSpec:
    """Kernel name / Covariance / GPSpec -> GPSpec (specs pass through)."""
    if isinstance(model, GPSpec):
        return model
    return GPSpec(kernel=model,
                  noise=noise if noise is not None else NoiseModel(),
                  solver=solver if solver is not None else SolverPolicy())


def spec_bank(kernels: Sequence[Union[str, Covariance, GPSpec]],
              noise: Optional[NoiseModel] = None,
              solver: Optional[SolverPolicy] = None) -> Tuple[GPSpec, ...]:
    """One spec per kernel, sharing a noise model and solver policy."""
    return tuple(as_spec(k, noise=noise, solver=solver) for k in kernels)


def pad_boxes(boxes: Sequence[FlatBox], m_max: int) -> FlatBox:
    """Stack per-model boxes into one (K, m_max) padded box.

    Padded dimensions get the (0, 1) interval: their widths stay finite
    and the kernels never read them, so their gradients are exactly zero
    and the padded coordinates never move.
    """
    los, his = [], []
    for b in boxes:
        lo, hi = torch.as_tensor(b.lo), torch.as_tensor(b.hi)
        pad = m_max - lo.shape[0]
        los.append(torch.cat([lo, lo.new_zeros(pad)]))
        his.append(torch.cat([hi, hi.new_ones(pad)]))
    return FlatBox(torch.stack(los), torch.stack(his))
