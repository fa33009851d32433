"""Linear operators for the training covariance.

Counterpart of ``repro/kernels/operators.py`` for the structure-free path.
:class:`PallasTileOperator` (the JAX package's name, kept so the two
packages report the same operator) binds one (kind, x, sigma_n, jitter)
training geometry; theta is a per-call argument.  Its gram matvec is the
B1 kernel plus the noise diagonal, its stacked tangents the B2 kernel.

:func:`select_operator` classifies x with ``data.grid.classify_grid`` as
the JAX package does.  Exact and near grids take the Toeplitz and SKI
operators there; those are not ported yet, so they raise here rather than
fall back to the tiles (which would answer differently).
"""

from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

import torch

from .. import _pending
from ..data.grid import GRID_RTOL, classify_grid
from . import ops as kops
from .ref import tile


@runtime_checkable
class LinearOperator(Protocol):
    """Matrix-access contract consumed by the iterative solver engine."""

    name: str
    kind: str
    n: int

    def matvec(self, theta, v) -> torch.Tensor:
        """Noise-free K(x, x) @ v;  v is (n,) or (n, b)."""
        ...

    def gram_matvec(self, theta, v) -> torch.Tensor:
        """(K + (sigma_n^2 + jitter) I) @ v."""
        ...

    def tangent_matvecs(self, theta, V) -> torch.Tensor:
        """dK/dtheta_i @ V stacked over all m flat directions: (m, n, b)."""
        ...


def bound_gram_matvec(op, theta, dtype):
    """``v -> (K + noise2 I) v`` with per-theta work hoisted where the
    operator offers it (``op.bound_gram_matvec``)."""
    bind = getattr(op, "bound_gram_matvec", None)
    if bind is not None:
        return bind(theta, dtype)
    return lambda v: op.gram_matvec(theta, v)


class PallasTileOperator:
    """The general path: K generated tile by tile, never stored; any 1-D x."""

    name = "pallas"

    def __init__(self, kind: str, x, sigma_n: float = 0.0,
                 jitter: float = 0.0):
        kops.check_kind(kind)
        if x.ndim != 1:
            raise ValueError(f"kind {kind!r} needs 1-D coordinates, got "
                             f"shape {tuple(x.shape)}")
        self.kind = kind
        self.x = x
        self.n = int(x.shape[0])
        self.sigma_n = float(sigma_n)
        self.jitter = float(jitter)
        self.noise2 = float(sigma_n) ** 2 + float(jitter)

    def matvec(self, theta, v):
        return kops.matvec(self.kind, theta, self.x, self.x, v)

    def gram_matvec(self, theta, v):
        return kops.gram_matvec(self.kind, theta, self.x, v, self.sigma_n,
                                self.jitter)

    def tangent_matvecs(self, theta, V):
        return kops.matvec_tangents(self.kind, theta, self.x, self.x, V)

    def diag(self, theta):
        """Noise-free diagonal k(x, x) (unit-scale kernels: all ones)."""
        p = kops.natural_params(self.kind, theta).to(self.x.dtype)
        return tile(self.kind, torch.zeros_like(self.x), p)

    def matcol(self, theta, i: int):
        """Column k(x, x_i)."""
        p = kops.natural_params(self.kind, theta).to(self.x.dtype)
        return tile(self.kind, self.x - self.x[i], p)


OPERATORS = ("pallas", "toeplitz", "ski", "lowrank")


def select_operator(kind: str, x, sigma_n: float = 0.0, jitter: float = 0.0,
                    operator: Optional[str] = None,
                    rtol: float = GRID_RTOL) -> PallasTileOperator:
    """Structure-aware dispatch; only the "irregular" branch is ported."""
    kops.check_kind(kind)
    if operator is not None:
        if operator == PallasTileOperator.name:
            return PallasTileOperator(kind, x, sigma_n, jitter)
        if operator in OPERATORS:
            raise _pending.pending(f"operator {operator!r}",
                                   _pending.PIVCHOL if operator == "lowrank"
                                   else _pending.GRID)
        raise ValueError(f"unknown operator {operator!r}; registered: "
                         f"{sorted(OPERATORS)}")
    if x.ndim != 1:
        raise ValueError(f"plain kind {kind!r} needs 1-D coordinates, got "
                         f"shape {tuple(x.shape)}")
    info = classify_grid(x, rtol=rtol)
    if info.kind != "irregular":
        raise _pending.pending(
            f"x classified {info.kind!r} by classify_grid (the "
            f"{'Toeplitz' if info.kind == 'exact' else 'SKI'} operator)",
            _pending.GRID)
    return PallasTileOperator(kind, x, sigma_n, jitter)
