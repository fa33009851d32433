"""Synthetic data sets (paper Sec. 3a, Fig. 1).

Counterpart of ``repro/data/synthetic.py``: realisations of the k1/k2 GPs
at t = 1..n (or at sorted uniform times) with the paper's hyperparameters,
sigma_f = 1, phi0 = 3.5, phi1 = 1.5, xi1 = 0 (k1); k2 adds a second
periodic term, phi2 = 3.0 and xi2 = 0.  Every draw goes through
:mod:`repro_torch.random`.  ``device=None`` means the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import random as rnd
from .._device import resolve_device
from ..core import covariances as cv
from ..core import predict

# Paper Fig. 1 hyperparameters (flat coordinates).
K1_TRUE = (3.5, 1.5, 0.0)
# phi2 = 3.0 (T2 ~ 20) keeps T2 >= T1 and inside the resolvable range for
# every n in Table 1; xi2 = 0 as in the caption.
K2_TRUE = (3.5, 1.5, 0.0, 3.0, 0.0)
SIGMA_F_TRUE = 1.0
SIGMA_N = 0.1  # fixed fractional noise, as in Sec. 3


class Dataset(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    sigma_n: float


def _truth(which: str, dtype, device):
    if which == "k2":
        return cv.K2, torch.tensor(K2_TRUE, dtype=dtype, device=device)
    if which == "k1":
        return cv.K1, torch.tensor(K1_TRUE, dtype=dtype, device=device)
    raise ValueError(which)


def synthetic(key, n: int, which: str = "k2", dtype=torch.float64,
              device=None) -> Dataset:
    """The paper's synthetic data: a k2 (or k1) realisation at t = 1..n."""
    dev = resolve_device(device)
    cov, theta = _truth(which, dtype, dev)
    x = torch.arange(1, n + 1, dtype=dtype, device=dev)
    y = predict.draw_prior(key, cov, theta, x, SIGMA_F_TRUE, SIGMA_N,
                           jitter=1e-10)
    return Dataset(x=x, y=y, sigma_n=SIGMA_N)


def irregular(key, n: int, span: float = 100.0, which: str = "k2",
              dtype=torch.float64, device=None) -> Dataset:
    """Irregularly sampled variant: sorted uniform times on (0, span), the
    case the paper's code targets (no Toeplitz structure, footnote 7)."""
    dev = resolve_device(device)
    kx, ky = rnd.split(key)
    x = torch.sort(rnd.uniform(kx, (n,), device=dev, dtype=dtype)
                   * span).values
    cov, theta = _truth("k2" if which == "k2" else "k1", dtype, dev)
    y = predict.draw_prior(ky, cov, theta, x, SIGMA_F_TRUE, SIGMA_N)
    return Dataset(x=x, y=y, sigma_n=SIGMA_N)
