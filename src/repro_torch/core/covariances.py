"""Covariance functions over flat hyperparameters (paper eqs. 3.1-3.5).

Counterpart of ``repro/core/covariances.py`` for the six kinds that have a
matrix-free tile: the paper's k1 and k2 (Wendland window x periodic terms)
and se / matern12 / matern32 / matern52: the record of each kind (its
parameters and which are timescales, smoothness or ordered) and the flat
coordinate maps.  The covariances themselves are the tiles of
``repro_torch.kernels.ref``; the dense forms come with the dense slice.
Flat coordinates: timescales T = exp(phi) (Jeffreys prior) and smoothness
l = exp(mu + sqrt(2) sigma_l erfinv(2 xi)) (log-normal prior).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from .. import _pending

LOGNORMAL_MU = 1.0
LOGNORMAL_SIGMA = 2.0  # paper: variance sigma_l^2 = 4


def smoothness_from_flat(xi):
    """l(xi) per eq. (3.5): flat xi in (-1/2, 1/2) <-> log-normal l."""
    return torch.exp(LOGNORMAL_MU + math.sqrt(2.0) * LOGNORMAL_SIGMA
                     * torch.special.erfinv(2.0 * xi))


def timescale_from_flat(phi):
    """T(phi) per eq. (3.4): flat phi <-> Jeffreys-prior T."""
    return torch.exp(phi)


@dataclasses.dataclass(frozen=True)
class Covariance:
    """A unit-scale covariance over a flat hyperparameter vector.

    timescale_idx / smoothness_idx: entries of theta that are log-timescales
    (data-dependent box) and flat smoothness coordinates (box (-1/2, 1/2)).
    ordering_groups: timescale indices required to be non-decreasing (k2's
    T2 >= T1).
    """

    name: str
    param_names: Tuple[str, ...]
    timescale_idx: Tuple[int, ...] = ()
    smoothness_idx: Tuple[int, ...] = ()
    ordering_groups: Tuple[Tuple[int, ...], ...] = ()

    @property
    def n_params(self) -> int:
        return len(self.param_names)


K1 = Covariance("k1", ("phi0", "phi1", "xi1"),
                timescale_idx=(0, 1), smoothness_idx=(2,))
K2 = Covariance("k2", ("phi0", "phi1", "xi1", "phi2", "xi2"),
                timescale_idx=(0, 1, 3), smoothness_idx=(2, 4),
                ordering_groups=((1, 3),))
SE = Covariance("se", ("phi_l",), timescale_idx=(0,))
MATERN12 = Covariance("matern12", ("phi_l",), timescale_idx=(0,))
MATERN32 = Covariance("matern32", ("phi_l",), timescale_idx=(0,))
MATERN52 = Covariance("matern52", ("phi_l",), timescale_idx=(0,))

REGISTRY = {c.name: c for c in (K1, K2, SE, MATERN12, MATERN32, MATERN52)}

# registered in the JAX package, dense-only there (no tile)
_DENSE_ONLY = ("rq", "periodic")


def resolve(name: str) -> Covariance:
    """Look up one of the six tiled covariances by name."""
    if name in REGISTRY:
        return REGISTRY[name]
    if "*" in name:
        raise _pending.pending(f"composite covariance {name!r}", _pending.ND)
    if name in _DENSE_ONLY:
        raise _pending.pending(f"covariance {name!r} (no matrix-free tile)",
                               _pending.DENSE)
    raise KeyError(f"unknown covariance {name!r}; registered: "
                   f"{sorted(REGISTRY)}")
