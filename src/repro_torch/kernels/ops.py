"""Flat-parameter fronts for the tile kernels.

Counterpart of ``repro/kernels/ops.py``: the flat -> natural parameter
maps run once here (not per tile), the white-noise diagonal is added
outside the kernel as (sigma_n^2 + jitter) * v, and the wrappers of
:mod:`.kernel_matvec` / :mod:`.kernel_tile` do the rest.  The JAX package
pads to tile multiples with a far-away sentinel; the CUDA kernels mask
their ragged edges instead, so nothing is padded here.

Composite kinds ("se*matern32") are separable products over (n, d)
coordinates, one registered factor per axis; theta is the concatenation
of the per-axis blocks.  Their matvecs are B8, their stacked tangents B9,
their row slabs B13, their dense blocks B4 once per factor.
"""

from __future__ import annotations

import math

import torch

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


def split_kind(kind: str):
    """"se*matern32" -> ("se", "matern32"); plain kinds -> 1-tuple.

    Raises ValueError naming the tile families for unknown pieces.
    """
    parts = tuple(kind.split("*"))
    bad = [p for p in parts if p not in _FLAT_TO_NATURAL]
    if bad:
        raise ValueError(f"unknown kernel factor(s) {bad} in kind {kind!r}; "
                         f"tile families: {sorted(_FLAT_TO_NATURAL)}")
    return parts


def check_kind(kind: str) -> None:
    """Raise for a kind that is not one tile family (composite kinds go
    through :func:`split_kind`)."""
    if kind not in _FLAT_TO_NATURAL:
        raise ValueError(f"unknown kernel kind {kind!r}; tile families: "
                         f"{sorted(_FLAT_TO_NATURAL)}")


def theta_blocks(kind: str, theta):
    """Split a composite kind's flat theta into its per-axis blocks."""
    out, o = [], 0
    for k in split_kind(kind):
        nk = FLAT_NPARAMS[k]
        out.append(theta[o:o + nk])
        o += nk
    return out


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


def natural_params_nd(kind: str, theta):
    """Composite kind -> (d, N_PARAM_SLOTS) per-axis natural parameters."""
    return torch.stack([natural_params(k, tb) for k, tb in
                        zip(split_kind(kind), theta_blocks(kind, theta))])


def natural_tangents_nd(kind: str, theta):
    """(m, d, N_PARAM_SLOTS): the natural tangents of the m flat
    directions of a composite kind.  Direction i moves only the axis that
    owns theta[i], so row i is zero outside that axis; there it is the
    axis's own :func:`natural_tangents` row (the closed form of JAX's
    jacfwd of :func:`natural_params_nd`, block by block)."""
    kinds = split_kind(kind)
    blocks = theta_blocks(kind, theta)
    m = sum(FLAT_NPARAMS[k] for k in kinds)
    out = torch.zeros((m, len(kinds), N_PARAM_SLOTS), dtype=theta.dtype,
                      device=theta.device)
    o = 0
    for a, (k, tb) in enumerate(zip(kinds, blocks)):
        nk = FLAT_NPARAMS[k]
        out[o:o + nk, a] = natural_tangents(k, tb)
        o += nk
    return out


def check_nd_coords(kind: str, kinds, *xs) -> None:
    """Raise unless every x is (n, d) with one column per factor."""
    d = len(kinds)
    for x in xs:
        if x.ndim != 2 or x.shape[1] != d:
            raise ValueError(
                f"composite kind {kind!r} needs (n, {d}) coordinates (one "
                f"column per '*'-joined factor), got shape "
                f"{tuple(x.shape)}")


def matvec(kind: str, theta, x1, x2, v):
    """K(x1, x2) @ v, matrix-free (no noise); v (n2,) or (n2, b).
    Composite kinds take (n, d) coordinates (B8)."""
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    kinds = split_kind(kind)
    if len(kinds) > 1:
        check_nd_coords(kind, kinds, x1, x2)
        p = natural_params_nd(kind, theta).to(v.dtype)
        out = kernel_matvec.tile_matvec_nd(kinds, p, x1.to(v.dtype),
                                           x2.to(v.dtype), v)
    else:
        p = natural_params(kind, theta).to(v.dtype)
        out = kernel_matvec.tile_matvec(kind, p, x1.to(v.dtype),
                                        x2.to(v.dtype), v)
    return out[:, 0] if squeeze else out


def matvec_rows(kind: str, theta, rows_x, x2, v):
    """K(rows_x, x2) @ v for a pre-gathered mini-batch of rows (no
    noise): the stochastic solver's hot loop, b n2 kernel entries per
    call through the row-slab kernel (B12; composite kinds B13 on (b, d)
    rows).  rows_x (b,) or (b, d); v (n2,) or (n2, k)."""
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    kinds = split_kind(kind)
    if len(kinds) > 1:
        check_nd_coords(kind, kinds, rows_x, x2)
        p = natural_params_nd(kind, theta).to(v.dtype)
        out = kernel_matvec.tile_matvec_rows_nd(kinds, p, rows_x.to(v.dtype),
                                                x2.to(v.dtype), v)
    else:
        p = natural_params(kind, theta).to(v.dtype)
        out = kernel_matvec.tile_matvec_rows(kind, p, rows_x.to(v.dtype),
                                             x2.to(v.dtype), v)
    return out[:, 0] if squeeze else out


def gram_matvec(kind: str, theta, x, v, sigma_n: float = 0.0,
                jitter: float = 0.0):
    """(K(x, x) + (sigma_n^2 + jitter) I) @ v."""
    return matvec(kind, theta, x, x, v) + (sigma_n ** 2 + jitter) * v


def matvec_tangents(kind: str, theta, x1, x2, v):
    """dK/dtheta_i @ v for all m flat directions in one launch: (m, n1, b)
    (B2; composite kinds B9)."""
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    kinds = split_kind(kind)
    if len(kinds) > 1:
        check_nd_coords(kind, kinds, x1, x2)
        p = natural_params_nd(kind, theta).to(v.dtype)
        pdots = natural_tangents_nd(kind, theta).to(v.dtype)
        out = kernel_matvec.tile_stacked_tangent_matvec_nd(
            kinds, p, pdots, x1.to(v.dtype), x2.to(v.dtype), v)
    else:
        p = natural_params(kind, theta).to(v.dtype)
        pdots = natural_tangents(kind, theta).to(v.dtype)
        out = kernel_matvec.tile_stacked_tangent_matvec(
            kind, p, pdots, x1.to(v.dtype), x2.to(v.dtype), v)
    return out[:, :, 0] if squeeze else out


def matrix(kind: str, theta, x1, x2):
    """Dense K(x1, x2), no noise.  Composite kinds multiply the per-axis
    blocks, one B4 launch per factor (predict's chunked cross blocks,
    never (n, n))."""
    kinds = split_kind(kind)
    if len(kinds) > 1:
        check_nd_coords(kind, kinds, x1, x2)
        out = None
        for a, (k, tb) in enumerate(zip(kinds, theta_blocks(kind, theta))):
            ka = matrix(k, tb, x1[:, a], x2[:, a])
            out = ka if out is None else out * ka
        return out
    dtype = torch.promote_types(x1.dtype, x2.dtype)
    p = natural_params(kind, theta).to(dtype)
    return kernel_tile.tile_matrix(kind, p, x1.to(dtype), x2.to(dtype))
