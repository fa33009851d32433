"""Covariance-function library (paper eqs. 3.1-3.3 + standard kernels).

Counterpart of ``repro/core/covariances.py``: every covariance is a
:class:`Covariance` record holding a pure function ``fn(theta, x1, x2)``
of the flat hyperparameter vector (unit scale: sigma_f^2 is profiled out,
eq. 2.15; the noise sigma_n^2 I is added by :func:`build_K`).  The dense
forms copy the JAX package's formulas term for term, so that ``torch.func``
derivatives of them (the dense hyperlikelihood's dK stack) are those of
``jax.jvp`` there; the matrix-free tiles of ``repro_torch.kernels`` are a
separate implementation over natural parameters.  ``rq`` and ``periodic``
have no tile: they run on the dense backend only.

Flat coordinates: timescales T = exp(phi) (Jeffreys prior) and smoothness
l = exp(mu + sqrt(2) sigma_l erfinv(2 xi)) (log-normal prior).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch

LOGNORMAL_MU = 1.0
LOGNORMAL_SIGMA = 2.0  # paper: variance sigma_l^2 = 4


def smoothness_from_flat(xi):
    """l(xi) per eq. (3.5): flat xi in (-1/2, 1/2) <-> log-normal l."""
    return torch.exp(LOGNORMAL_MU + math.sqrt(2.0) * LOGNORMAL_SIGMA
                     * torch.special.erfinv(2.0 * xi))


def timescale_from_flat(phi):
    """T(phi) per eq. (3.4): flat phi <-> Jeffreys-prior T."""
    return torch.exp(phi)


def _delta(x1, x2):
    """Pairwise signed separation matrix for 1-D inputs."""
    return x1[:, None] - x2[None, :]


def _sqdist(x1, x2):
    """Pairwise squared Euclidean distance; (n,) and (n, d) inputs."""
    x1 = x1.reshape(x1.shape[0], -1)
    x2 = x2.reshape(x2.shape[0], -1)
    d = x1[:, None, :] - x2[None, :, :]
    return torch.sum(d * d, dim=-1)


def compact_support(tau):
    """Eq. (3.3) with the Wendland phi_{3,2} coefficients (DESIGN.md §8:
    the printed 48 is a misprint of 24): C(0) = 1, C(>= 1) = 0."""
    tau = torch.abs(tau)
    val = (1.0 - tau) ** 5 * (8.0 * tau ** 2 + 5.0 * tau + 1.0)
    return torch.where(tau < 1.0, val, 0.0)


def periodic_factor(dt, period, ell):
    """exp[-2/l^2 sin^2(pi dt / T)] (MacKay's periodic covariance)."""
    s = torch.sin(math.pi * dt / period)
    return torch.exp(-2.0 * (s / ell) ** 2)


@dataclasses.dataclass(frozen=True)
class Covariance:
    """A unit-scale covariance over a flat hyperparameter vector.

    fn: ``fn(theta, x1, x2) -> (n1, n2)`` cross-covariance, no noise term.
    timescale_idx / smoothness_idx: entries of theta that are log-timescales
    (data-dependent box) and flat smoothness coordinates (box (-1/2, 1/2)).
    ordering_groups: timescale indices required to be non-decreasing (k2's
    T2 >= T1).
    axes: the per-axis factors of a separable product (empty otherwise).
    """

    name: str
    param_names: Tuple[str, ...]
    fn: Callable
    timescale_idx: Tuple[int, ...] = ()
    smoothness_idx: Tuple[int, ...] = ()
    ordering_groups: Tuple[Tuple[int, ...], ...] = ()
    axes: Tuple["Covariance", ...] = ()

    @property
    def n_params(self) -> int:
        return len(self.param_names)

    def __call__(self, theta, x1, x2):
        return self.fn(theta, x1, x2)


def build_K(cov: Covariance, theta, x, sigma_n: float, jitter: float = 1e-10):
    """Unit-scale training covariance K = k(x,x) + (sigma_n^2 + jitter) I
    (the K of eq. 2.14 with sigma_f^2 factored out)."""
    K = cov(theta, x, x)
    return K + (sigma_n ** 2 + jitter) * torch.eye(
        x.shape[0], dtype=K.dtype, device=K.device)


# ---------------------------------------------------------------------------
# Paper covariances (eqs. 3.1, 3.2)
# ---------------------------------------------------------------------------

def _k1_fn(theta, x1, x2):
    """k1 (eq. 3.1): compact-support window x one periodic term;
    theta = (phi0, phi1, xi1)."""
    dt = _delta(x1, x2)
    t0 = timescale_from_flat(theta[0])
    t1 = timescale_from_flat(theta[1])
    l1 = smoothness_from_flat(theta[2])
    return compact_support(dt / t0) * periodic_factor(dt, t1, l1)


def _k2_fn(theta, x1, x2):
    """k2 (eq. 3.2): window x two periodic terms in one exp;
    theta = (phi0, phi1, xi1, phi2, xi2)."""
    dt = _delta(x1, x2)
    t0 = timescale_from_flat(theta[0])
    t1 = timescale_from_flat(theta[1])
    t2 = timescale_from_flat(theta[3])
    l1 = smoothness_from_flat(theta[2])
    l2 = smoothness_from_flat(theta[4])
    pp = torch.exp(-2.0 * (torch.sin(math.pi * dt / t1) / l1) ** 2
                   - 2.0 * (torch.sin(math.pi * dt / t2) / l2) ** 2)
    return compact_support(dt / t0) * pp


def _se_fn(theta, x1, x2):
    """Squared exponential; theta = (phi_l,), lengthscale exp(phi_l)."""
    ell = torch.exp(theta[0])
    return torch.exp(-0.5 * _sqdist(x1, x2) / ell ** 2)


def _matern12_fn(theta, x1, x2):
    ell = torch.exp(theta[0])
    r = torch.sqrt(_sqdist(x1, x2) + 1e-36)
    return torch.exp(-r / ell)


def _matern32_fn(theta, x1, x2):
    ell = torch.exp(theta[0])
    r = torch.sqrt(_sqdist(x1, x2) + 1e-36) / ell
    a = math.sqrt(3.0) * r
    return (1.0 + a) * torch.exp(-a)


def _matern52_fn(theta, x1, x2):
    ell = torch.exp(theta[0])
    r = torch.sqrt(_sqdist(x1, x2) + 1e-36) / ell
    a = math.sqrt(5.0) * r
    return (1.0 + a + a * a / 3.0) * torch.exp(-a)


def _rq_fn(theta, x1, x2):
    """Rational quadratic; theta = (phi_l, log_alpha)."""
    ell = torch.exp(theta[0])
    alpha = torch.exp(theta[1])
    return (1.0 + 0.5 * _sqdist(x1, x2) / (alpha * ell ** 2)) ** (-alpha)


def _periodic_fn(theta, x1, x2):
    """Pure periodic; theta = (phi_T, xi_l)."""
    return periodic_factor(_delta(x1, x2), timescale_from_flat(theta[0]),
                           smoothness_from_flat(theta[1]))


K1 = Covariance("k1", ("phi0", "phi1", "xi1"), _k1_fn,
                timescale_idx=(0, 1), smoothness_idx=(2,))
K2 = Covariance("k2", ("phi0", "phi1", "xi1", "phi2", "xi2"), _k2_fn,
                timescale_idx=(0, 1, 3), smoothness_idx=(2, 4),
                ordering_groups=((1, 3),))
SE = Covariance("se", ("phi_l",), _se_fn, timescale_idx=(0,))
MATERN12 = Covariance("matern12", ("phi_l",), _matern12_fn,
                      timescale_idx=(0,))
MATERN32 = Covariance("matern32", ("phi_l",), _matern32_fn,
                      timescale_idx=(0,))
MATERN52 = Covariance("matern52", ("phi_l",), _matern52_fn,
                      timescale_idx=(0,))
RQ = Covariance("rq", ("phi_l", "log_alpha"), _rq_fn, timescale_idx=(0,),
                smoothness_idx=(1,))
PERIODIC = Covariance("periodic", ("phi_T", "xi_l"), _periodic_fn,
                      timescale_idx=(0,), smoothness_idx=(1,))


def product(name: str, a: Covariance, b: Covariance) -> Covariance:
    """Pointwise product of two covariances; theta = concat(theta_a,
    theta_b)."""
    na = a.n_params

    def fn(theta, x1, x2):
        return a.fn(theta[:na], x1, x2) * b.fn(theta[na:], x1, x2)

    return Covariance(
        name=name, param_names=a.param_names + b.param_names, fn=fn,
        timescale_idx=a.timescale_idx + tuple(na + i for i in b.timescale_idx),
        smoothness_idx=(a.smoothness_idx
                        + tuple(na + i for i in b.smoothness_idx)))


def mixture(name: str, a: Covariance, b: Covariance) -> Covariance:
    """Convex sum w a + (1 - w) b with flat mixing weight w in (0, 1) as
    theta[0]."""
    na = a.n_params

    def fn(theta, x1, x2):
        w = theta[0]
        return (w * a.fn(theta[1:1 + na], x1, x2)
                + (1.0 - w) * b.fn(theta[1 + na:], x1, x2))

    return Covariance(
        name=name, param_names=("w",) + a.param_names + b.param_names, fn=fn,
        timescale_idx=tuple(1 + i for i in a.timescale_idx)
        + tuple(1 + na + i for i in b.timescale_idx),
        smoothness_idx=tuple(1 + i for i in a.smoothness_idx)
        + tuple(1 + na + i for i in b.smoothness_idx))


def separable(name: str, *factors: Covariance) -> Covariance:
    """Separable product over (n, d) inputs, one 1-D factor per axis:
    k(x, x') = prod_a k_a(x[a], x'[a]), theta the concatenation of the
    per-axis blocks (indices offset accordingly)."""
    if len(factors) < 2:
        raise ValueError("separable() needs at least two axis factors")
    offs = [0]
    for f in factors:
        offs.append(offs[-1] + f.n_params)

    def fn(theta, x1, x2):
        if x1.ndim != 2 or x1.shape[1] != len(factors):
            raise ValueError(
                f"separable covariance '{name}' needs (n, {len(factors)}) "
                f"inputs, got x1 shape {tuple(x1.shape)}; pass one column "
                "per axis factor")
        out = factors[0].fn(theta[offs[0]:offs[1]], x1[:, 0], x2[:, 0])
        for a in range(1, len(factors)):
            out = out * factors[a].fn(theta[offs[a]:offs[a + 1]],
                                      x1[:, a], x2[:, a])
        return out

    return Covariance(
        name=name,
        param_names=tuple(f"ax{a}_{p}" for a, f in enumerate(factors)
                          for p in f.param_names),
        fn=fn,
        timescale_idx=tuple(offs[a] + i for a, f in enumerate(factors)
                            for i in f.timescale_idx),
        smoothness_idx=tuple(offs[a] + i for a, f in enumerate(factors)
                             for i in f.smoothness_idx),
        ordering_groups=tuple(tuple(offs[a] + i for i in grp)
                              for a, f in enumerate(factors)
                              for grp in f.ordering_groups),
        axes=tuple(factors))


REGISTRY = {c.name: c for c in
            (K1, K2, SE, MATERN12, MATERN32, MATERN52, RQ, PERIODIC)}


def resolve(name: str) -> Covariance:
    """Look up a covariance by name; "a*b" names give the separable
    product of registered factors (KeyError naming the factors
    otherwise)."""
    if name in REGISTRY:
        return REGISTRY[name]
    if "*" in name:
        parts = name.split("*")
        missing = [p for p in parts if p not in REGISTRY]
        if missing:
            raise KeyError(f"unknown covariance factor(s) {missing} in "
                           f"{name!r}; registered factors: "
                           f"{sorted(REGISTRY)}")
        return separable(name, *(REGISTRY[p] for p in parts))
    raise KeyError(f"unknown covariance {name!r}; registered: "
                   f"{sorted(REGISTRY)} (join registered names with '*' "
                   f"for a separable multi-axis product, e.g. "
                   f"'se*matern32')")
