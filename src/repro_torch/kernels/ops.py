"""Flat-parameter fronts for the tile kernels.

Counterpart of ``repro/kernels/ops.py`` for 1-D kinds: the flat -> natural
parameter maps run once here (not per tile), the white-noise diagonal is
added outside the kernel as (sigma_n^2 + jitter) * v, and the wrappers of
:mod:`.kernel_matvec` / :mod:`.kernel_tile` do the rest.  The JAX package
pads to tile multiples with a far-away sentinel; the CUDA kernels mask
their ragged edges instead, so nothing is padded here.
"""

from __future__ import annotations

import math

import torch

from .. import _pending
from ..core.covariances import smoothness_from_flat
from . import kernel_matvec, kernel_tile
from .ref import N_PARAM_SLOTS

_FLAT_TO_NATURAL = {
    "k1": lambda th: (torch.exp(th[0]), torch.exp(th[1]),
                      smoothness_from_flat(th[2])),
    "k2": lambda th: (torch.exp(th[0]), torch.exp(th[1]),
                      smoothness_from_flat(th[2]), torch.exp(th[3]),
                      smoothness_from_flat(th[4])),
    "se": lambda th: (torch.exp(th[0]),),
    "matern12": lambda th: (torch.exp(th[0]),),
    "matern32": lambda th: (torch.exp(th[0]),),
    "matern52": lambda th: (torch.exp(th[0]),),
}

FLAT_NPARAMS = {"k1": 3, "k2": 5, "se": 1, "matern12": 1, "matern32": 1,
                "matern52": 1}

# which flat coordinates are smoothness coordinates (the rest are log T)
_SMOOTHNESS = {"k1": (2,), "k2": (2, 4)}


def check_kind(kind: str) -> None:
    """Raise for composite or unknown kinds."""
    if "*" in kind:
        raise _pending.pending(f"composite kind {kind!r}", _pending.ND)
    if kind not in _FLAT_TO_NATURAL:
        raise ValueError(f"unknown kernel kind {kind!r}; tile families: "
                         f"{sorted(_FLAT_TO_NATURAL)}")


def natural_params(kind: str, theta):
    """Flat hyperparameters -> padded (N_PARAM_SLOTS,) natural parameters."""
    check_kind(kind)
    vals = torch.stack(_FLAT_TO_NATURAL[kind](theta))
    out = torch.ones(N_PARAM_SLOTS, dtype=vals.dtype, device=vals.device)
    out[: vals.shape[0]] = vals
    return out


def natural_tangents(kind: str, theta):
    """(m, N_PARAM_SLOTS): row i is d(natural)/d(theta) @ e_i.

    Closed form of the forward-mode Jacobian: dT/dphi = T, and
    dl/dxi = l * (2 sqrt(2) sigma_l / 2) * (sqrt(pi)/2) exp(erfinv(2 xi)^2)
    (erfinv'(u) = (sqrt(pi)/2) exp(erfinv(u)^2)), in the order of JAX's
    jvp rules.
    """
    check_kind(kind)
    nat = natural_params(kind, theta)
    m = FLAT_NPARAMS[kind]
    out = torch.zeros((m, N_PARAM_SLOTS), dtype=nat.dtype,
                      device=nat.device)
    for i in range(m):
        if i in _SMOOTHNESS.get(kind, ()):
            e = torch.special.erfinv(2.0 * theta[i])
            t_erf = (math.sqrt(math.pi) / 2.0) * (2.0 * torch.exp(e * e))
            out[i, i] = (math.sqrt(2.0) * 2.0 * t_erf) * nat[i]
        else:
            out[i, i] = nat[i]
    return out


def matvec(kind: str, theta, x1, x2, v):
    """K(x1, x2) @ v, matrix-free (no noise); v (n2,) or (n2, b)."""
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    p = natural_params(kind, theta).to(v.dtype)
    out = kernel_matvec.tile_matvec(kind, p, x1.to(v.dtype), x2.to(v.dtype),
                                    v)
    return out[:, 0] if squeeze else out


def gram_matvec(kind: str, theta, x, v, sigma_n: float = 0.0,
                jitter: float = 0.0):
    """(K(x, x) + (sigma_n^2 + jitter) I) @ v."""
    return matvec(kind, theta, x, x, v) + (sigma_n ** 2 + jitter) * v


def matvec_tangents(kind: str, theta, x1, x2, v):
    """dK/dtheta_i @ v for all m flat directions in one launch: (m, n1, b)."""
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    p = natural_params(kind, theta).to(v.dtype)
    pdots = natural_tangents(kind, theta).to(v.dtype)
    out = kernel_matvec.tile_stacked_tangent_matvec(
        kind, p, pdots, x1.to(v.dtype), x2.to(v.dtype), v)
    return out[:, :, 0] if squeeze else out


def matrix(kind: str, theta, x1, x2):
    """Dense K(x1, x2), no noise."""
    dtype = torch.promote_types(x1.dtype, x2.dtype)
    p = natural_params(kind, theta).to(dtype)
    return kernel_tile.tile_matrix(kind, p, x1.to(dtype), x2.to(dtype))
