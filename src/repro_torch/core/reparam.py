"""Flat-prior box and prior-volume bookkeeping (paper Sec. 3).

Counterpart of ``repro/core/reparam.py`` for 1-D inputs: timescales are
flat in phi = ln T on (ln dt_min, ln dt_max), smoothness coordinates flat
on (-1/2, 1/2); k2's ordering T2 >= T1 halves the box volume.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import random as rnd
from .covariances import Covariance


class FlatBox(NamedTuple):
    lo: torch.Tensor  # (m,)
    hi: torch.Tensor  # (m,)

    @property
    def widths(self):
        return self.hi - self.lo


def data_timescale_range(x):
    """(dt_min, dt_max): smallest positive gap and full span of x."""
    xs = torch.sort(x.reshape(-1)).values
    gaps = torch.diff(xs)
    dt_min = torch.min(torch.where(gaps > 0, gaps,
                                   torch.full_like(gaps, math.inf)))
    return dt_min, xs[-1] - xs[0]


def flat_box(cov: Covariance, x) -> FlatBox:
    """Flat-prior box for every hyperparameter of ``cov`` given 1-D x."""
    if x.ndim != 1:
        raise ValueError(f"flat_box takes 1-D inputs here, got shape "
                         f"{tuple(x.shape)}")
    dt_min, dt_max = data_timescale_range(x)
    lo = torch.zeros(cov.n_params, dtype=x.dtype, device=x.device)
    hi = torch.zeros(cov.n_params, dtype=x.dtype, device=x.device)
    for i in range(cov.n_params):
        if i in cov.timescale_idx:
            lo[i] = torch.log(dt_min)
            hi[i] = torch.log(dt_max)
        elif i in cov.smoothness_idx:
            lo[i] = -0.5
            hi[i] = 0.5
        else:
            lo[i] = 0.0
            hi[i] = 1.0
    return FlatBox(lo, hi)


def log_prior_volume(cov: Covariance, box: FlatBox):
    """ln V of eq. (2.13), minus ln g! for each ordered group of g."""
    lv = torch.sum(torch.log(box.widths))
    for grp in cov.ordering_groups:
        lv = lv - math.lgamma(len(grp) + 1)
    return lv


def apply_ordering(cov: Covariance, theta):
    """Sort each ordered group of theta (last axis) into the ordered region,
    swapping the companion smoothness coordinates (k2: xi_j at phi_j + 1)
    so that k is unchanged."""
    theta = theta.clone()
    for grp in cov.ordering_groups:
        idx = list(grp)
        vals = theta[..., idx]
        order = torch.argsort(vals, dim=-1, stable=True)
        theta[..., idx] = torch.gather(vals, -1, order)
        if all(g + 1 in cov.smoothness_idx for g in grp):
            comp = [g + 1 for g in grp]
            theta[..., comp] = torch.gather(theta[..., comp], -1, order)
    return theta


def sample_uniform(key, cov: Covariance, box: FlatBox, shape=()):
    """Uniform draws over the (ordering-constrained) flat box."""
    u = rnd.uniform(key, tuple(shape) + (cov.n_params,), 0.0, 1.0,
                    device=box.lo.device, dtype=box.lo.dtype)
    theta = box.lo + u * box.widths
    if cov.ordering_groups:
        theta = apply_ordering(cov, theta)
    return theta


def to_box(z, box: FlatBox):
    return box.lo + box.widths * torch.sigmoid(z)


def from_box(theta, box: FlatBox, eps=1e-9):
    u = torch.clamp((theta - box.lo) / box.widths, eps, 1.0 - eps)
    return torch.log(u) - torch.log1p(-u)
