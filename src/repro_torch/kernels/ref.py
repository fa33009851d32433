"""Plain PyTorch covariance tiles on natural-scale parameters.

The six tile families of ``repro/kernels/kernel_matvec.py`` (k1, k2, se,
matern12/32/52) and their closed-form derivatives with respect to the
natural slots.  ``params`` is the padded (N_PARAM_SLOTS,) block: k1 =
(T0, T1, l1), k2 = (T0, T1, l1, T2, l2), se / matern* = (ell,).

The operation order matches the reference tile functions, in particular
``sin(pi * dt / T1) / l1``: ``(pi * dt) / T1`` can reach 1e8-1e9 at the
lower edge of the timescale box, where any reordering shows above 1e-12.
The CUDA kernels (``csrc/tile_fns.cuh``) follow the same order.
"""

from __future__ import annotations

import math

import torch

N_PARAM_SLOTS = 8
KINDS = ("k1", "k2", "se", "matern12", "matern32", "matern52")
# natural slots that carry a derivative, per kind
N_SLOTS = {"k1": 3, "k2": 5, "se": 1, "matern12": 1, "matern32": 1,
           "matern52": 1}


def _pow5(a):
    """a^5 as a * (a^2)^2, the multiplication order of lax.integer_pow."""
    a2 = a * a
    return a * (a2 * a2)


def wendland(u):
    """Wendland phi_{3,2}(|u|) (the corrected form), 0 at |u| >= 1."""
    tau = torch.abs(u)
    val = _pow5(1.0 - tau) * (8.0 * tau * tau + 5.0 * tau + 1.0)
    return torch.where(tau < 1.0, val, torch.zeros_like(val))


def tile(kind: str, dt, p):
    """k(dt) for one family; dt any shape, p the natural-parameter block."""
    if kind == "k1":
        s1 = torch.sin(math.pi * dt / p[1]) / p[2]
        return wendland(dt / p[0]) * torch.exp(-2.0 * s1 * s1)
    if kind == "k2":
        s1 = torch.sin(math.pi * dt / p[1]) / p[2]
        s2 = torch.sin(math.pi * dt / p[3]) / p[4]
        return wendland(dt / p[0]) * torch.exp(-2.0 * (s1 * s1 + s2 * s2))
    if kind == "se":
        r = dt / p[0]
        return torch.exp(-0.5 * r * r)
    if kind == "matern12":
        return torch.exp(-torch.abs(dt) / p[0])
    if kind == "matern32":
        a = math.sqrt(3.0) * torch.abs(dt) / p[0]
        return (1.0 + a) * torch.exp(-a)
    if kind == "matern52":
        a = math.sqrt(5.0) * torch.abs(dt) / p[0]
        return (1.0 + a + a * a / 3.0) * torch.exp(-a)
    raise ValueError(f"unknown tile kind {kind!r}; registered: {KINDS}")


def _wendland_grad(dt, t0):
    """(W, dW/dT0): W'(tau) = -14 tau (1-tau)^4 (4 tau + 1), tau = |dt|/T0,
    d tau/d T0 = -tau / T0; both are 0 at tau >= 1."""
    tau = torch.abs(dt / t0)
    om = 1.0 - tau
    om2 = om * om
    om4 = om2 * om2
    inside = tau < 1.0
    zero = torch.zeros_like(tau)
    w = torch.where(inside, om * om4 * (8.0 * tau * tau + 5.0 * tau + 1.0),
                    zero)
    dw = torch.where(inside, (-14.0 * tau * om4 * (4.0 * tau + 1.0))
                     * (-tau / t0), zero)
    return w, dw


def _periodic_grad(dt, period, ell):
    """(s, ds/dT) with s = sin(a) / l, a = (pi dt) / T."""
    a = math.pi * dt / period
    return torch.sin(a) / ell, torch.cos(a) * (-a / period) / ell


def tile_grad(kind: str, dt, p):
    """(k, g): k(dt) and g[..., s] = dk/dp[s] for the kind's natural slots."""
    if kind in ("k1", "k2"):
        w, dw = _wendland_grad(dt, p[0])
        s1, ds1 = _periodic_grad(dt, p[1], p[2])
        if kind == "k2":
            s2, ds2 = _periodic_grad(dt, p[3], p[4])
            per = torch.exp(-2.0 * (s1 * s1 + s2 * s2))
        else:
            per = torch.exp(-2.0 * s1 * s1)
        k = w * per
        g = [dw * per, k * (-4.0 * s1 * ds1), k * (4.0 * s1 * s1 / p[2])]
        if kind == "k2":
            g += [k * (-4.0 * s2 * ds2), k * (4.0 * s2 * s2 / p[4])]
        return k, torch.stack(g, dim=-1)
    ell = p[0]
    if kind == "se":
        r = dt / ell
        k = torch.exp(-0.5 * r * r)
        g = k * r * r / ell
    elif kind == "matern12":
        k = torch.exp(-torch.abs(dt) / ell)
        g = k * (torch.abs(dt) / ell) / ell
    elif kind == "matern32":
        a = math.sqrt(3.0) * torch.abs(dt) / ell
        e = torch.exp(-a)
        k = (1.0 + a) * e
        g = a * a * e / ell
    elif kind == "matern52":
        a = math.sqrt(5.0) * torch.abs(dt) / ell
        e = torch.exp(-a)
        k = (1.0 + a + a * a / 3.0) * e
        g = a * a * (1.0 + a) / 3.0 * e / ell
    else:
        raise ValueError(f"unknown tile kind {kind!r}; registered: {KINDS}")
    return k, g[..., None]


def matrix_ref(kind: str, params, x1, x2):
    """Dense K(x1, x2) on natural parameters, no noise."""
    return tile(kind, x1[:, None] - x2[None, :], params)


def tangent_matrices_ref(kind: str, params, pdots, x1, x2):
    """(m, n1, n2) dense tangents sum_s pdots[i, s] dK/dp[s]."""
    _, g = tile_grad(kind, x1[:, None] - x2[None, :], params)
    ns = g.shape[-1]
    return torch.einsum("abs,ms->mab", g, pdots[:, :ns].to(g.dtype))


# ---------------------------------------------------------------------------
# Separable products over (n, d) coordinates (composite kinds)
# ---------------------------------------------------------------------------

def product_matrix_ref(kinds, params, x1, x2):
    """Dense prod_a k_a(x1[:, a] - x2[:, a]), params (d, N_PARAM_SLOTS);
    the factors multiply in axis order, as the reference product tile."""
    out = None
    for a, k in enumerate(kinds):
        ka = tile(k, x1[:, a, None] - x2[None, :, a], params[a])
        out = ka if out is None else out * ka
    return out


def product_tangent_matrices_ref(kinds, params, pdots, x1, x2):
    """(m, n1, n2) dense tangents of a product kernel, pdots (m, d,
    N_PARAM_SLOTS): the product rule, sum over axes a of
    (sum_s pdots[i, a, s] dk_a/dp[s]) * prod_{b != a} k_b."""
    ks, gs = [], []
    for a, k in enumerate(kinds):
        ka, ga = tile_grad(k, x1[:, a, None] - x2[None, :, a], params[a])
        ks.append(ka)
        gs.append(ga)
    out = None
    for a in range(len(kinds)):
        others = None
        for b in range(len(kinds)):
            if b != a:
                others = ks[b] if others is None else others * ks[b]
        ns = gs[a].shape[-1]
        dk = torch.einsum("rcs,ms->mrc", gs[a],
                          pdots[:, a, :ns].to(gs[a].dtype))
        term = dk if others is None else dk * others
        out = term if out is None else out + term
    return out
