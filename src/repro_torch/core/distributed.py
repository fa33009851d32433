"""The row-sharded distributed GP step over ``torch.distributed``.

Counterpart of ``repro/core/distributed.py``, where one ``shard_map``
region over a mesh's ("pod", "data") axes runs each evaluation.  Here the
ranks of a process group take its place: rank r owns the r-th block of
rows of K and of every vector; theta and the input coordinates are
replicated on every rank.

  * matvec: structure is probed on the unpadded inputs
    (``operators.select_operator``).  On irregular inputs each rank runs
    B1 on its (n / ranks) x n block against the gathered vector; on a
    grid (Toeplitz) or a near grid (SKI) each rank runs the operator's
    own FFT matvec on the gathered vector and keeps its rows;
  * CG state stays row-sharded: each iteration gathers the search
    direction (``all_gather``) and sums the per-column dots
    (``all_reduce``); the loop reads its stop test back to the host once
    per iteration (counted in :mod:`repro_torch._sync`);
  * SLQ (full reorthogonalisation, its projections an ``all_reduce``)
    and the Hutchinson gradient (eq. 2.17) ride the same [y | probes]
    solve; on irregular inputs the gradient is two
    :func:`repro_torch.kernels.ops.matvec_jvp` calls per direction (B3).

Padding: n is padded to a multiple of the ranks with far-away sentinel
inputs 1e12 (1 + i); those rows decouple (zero covariance to every real
point), y and the probes are zero there, and the log-det subtracts
pad ln(1 + sigma_n^2 + jitter) as the JAX package does.

Deliberate differences from the JAX package: ``group`` (a process group)
in place of ``mesh``; on the Toeplitz and SKI branches the gradient's
tangents come from the operator's ``tangent_matvecs`` (all m directions in
one call per right-hand side) where the JAX package differentiates the
operator's matvec one direction at a time; and a composite kind on (n, d)
inputs that needs padding raises a ValueError (the JAX package's 1-D pad
fails there).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import _pending, _sync
from .. import random as rnd
from .._device import as_tensor, resolve_device
from ..kernels import operators as kopers
from ..kernels import ops as kops
from . import iterative as it

LOG2PI = math.log(2.0 * math.pi)
_SENTINEL = 1e12
# the backends whose tensors must lie on one kind of device
_BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


class DistGPResult(NamedTuple):
    log_p_max: torch.Tensor
    grad: torch.Tensor
    sigma2_hat: torch.Tensor
    cg_iters: int


def _ranks(group, device: torch.device):
    """(rank, world size) of this process in ``group``; raises when
    ``torch.distributed`` is not initialised or when the group's backend
    cannot serve tensors on ``device``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "torch.distributed is not initialised: the distributed GP step "
            "needs a process group (repro_torch.launch.mesh."
            "make_local_group() makes a world-size-1 one)")
    backend = str(dist.get_backend(group))
    want = _BACKEND_DEVICE.get(backend)
    if want is not None and device.type != want:
        raise ValueError(f"the {backend} process group serves {want} "
                         f"tensors; the inputs are on {device}")
    return dist.get_rank(group), dist.get_world_size(group)


def _all_gather_rows(v_loc, world: int, group):
    """The row blocks of every rank, stacked in rank order."""
    out = v_loc.new_empty((world * v_loc.shape[0],) + v_loc.shape[1:])
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, v_loc.contiguous(), group=group)
    return out


def _all_sum(t, group):
    """t summed over the ranks (NCCL takes contiguous tensors only)."""
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def pad_for_group(x, y, group):
    """Pad (x, y) so that n divides the group's ranks: sentinel inputs
    1e12 (1 + i) and zero y.  Returns (x, y, n_orig).  Composite kinds'
    (n, d) inputs are not padded: a ValueError names the case."""
    shards = dist.get_world_size(group)
    n = int(x.shape[0])
    pad = (-n) % shards
    if pad:
        if x.ndim != 1:
            raise ValueError(
                f"the distributed step pads only 1-D inputs: (n, d) = "
                f"{tuple(x.shape)} inputs need n divisible by the "
                f"{shards} ranks (n = {n}; the JAX package fails here too)")
        x = torch.cat([x, _SENTINEL * (1 + torch.arange(
            pad, dtype=x.dtype, device=x.device))])
        y = torch.cat([y, y.new_zeros(pad)])
    return x, y, n


def sharded_rows_matvec(kind: str, group):
    """The stochastic solver's row slab with the column axis split over
    the group's ranks.

    Returns ``apply(theta, rows_x, x, v) -> (b, k)`` computing
    K(rows_x, x) @ v: each rank runs the row-slab kernel (B12; B13 for a
    composite kind) on its block of n / ranks columns of x and v, and the
    (b, k) partial products are summed over the ranks (``all_reduce``).
    rows_x, x, v and the result are replicated.  n is padded to the ranks
    with sentinel inputs and zero v rows (no contribution).
    """

    def apply(theta, rows_x, x, v):
        rank, world = _ranks(group, v.device)
        n = int(x.shape[0])
        pad = (-n) % world
        if pad:
            x = torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]),
                                         _SENTINEL)])
            v = torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
        block = (n + pad) // world
        cols = slice(rank * block, (rank + 1) * block)
        part = kops.matvec_rows(kind, theta, rows_x, x[cols], v[cols])
        return _all_sum(part, group)

    return apply


def distributed_profiled_loglik(kind: str, theta, x, y, sigma_n: float,
                                group, key, n_probes: int = 16,
                                lanczos_k: int = 64, cg_tol: float = 1e-8,
                                cg_max_iter: int = 600,
                                jitter: float = 1e-8,
                                with_grad: bool = True, operator=None,
                                probes=None, device=None) -> DistGPResult:
    """Row-sharded matrix-free ln P_max (eq. 2.16) and its gradient (eq.
    2.17) over the ranks of ``group``.

    ``operator`` overrides the structure dispatch ("pallas" | "toeplitz"
    | "ski", the exact-matvec operators).  ``probes`` ((n, p) or
    (n_pad, p)) replaces the Rademacher block drawn from ``key``; its pad
    rows are set to zero.  Every rank passes the same arguments and gets
    the same result.  ``device`` None means the card.
    """
    dev = resolve_device(device)
    rank, world = _ranks(group, dev)
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    theta = as_tensor(theta, dev)
    # the structure probe on the original coordinates: the sentinel pad
    # breaks a grid's regularity, the data need not
    op = kopers.select_operator(kind, x, 0.0, 0.0, operator=operator)
    if op.name not in ("pallas", "toeplitz", "ski"):
        raise ValueError(
            f"distributed path supports the exact matvec operators "
            f"('pallas' | 'toeplitz' | 'ski'), got {op.name!r}")
    structured = op.name in ("toeplitz", "ski")
    x, y, n_orig = pad_for_group(x, y, group)
    n_pad = int(x.shape[0])
    pad = n_pad - n_orig
    noise2 = sigma_n ** 2 + jitter

    if probes is None:
        z = rnd.rademacher(key, (n_pad, n_probes), device=dev,
                           dtype=y.dtype)
    else:
        z = as_tensor(probes, dev, y.dtype)
        if z.ndim != 2 or z.shape[0] not in (n_orig, n_pad):
            raise ValueError(f"probes must be (n, p) or (n_pad, p) with "
                             f"n = {n_orig}, n_pad = {n_pad}; got "
                             f"{tuple(z.shape)}")
        if z.shape[0] == n_orig and pad:
            z = torch.cat([z, z.new_zeros((pad, z.shape[1]))])
    if pad:
        z = z.clone()
        z[n_orig:] = 0.0
    m = int(theta.shape[0])
    block = n_pad // world
    rows = slice(rank * block, (rank + 1) * block)
    x_loc = x[rows]
    rhs_loc = torch.cat([y[:, None], z], dim=1)[rows]

    def gather(v_loc):
        return _all_gather_rows(v_loc, world, group)

    def dots(a, b):
        return _all_sum(torch.sum(a * b, dim=0), group)

    def pad_rows(kv):
        if not pad:
            return kv
        return torch.cat([kv, kv.new_zeros((pad,) + tuple(kv.shape[1:]))])

    def kv_rows(v_full):
        """This rank's rows of the noise-free K @ v."""
        if structured:
            # the operator's FFT matvec on the gathered vector; the pad
            # rows decouple, so their block of K v is exactly zero
            return pad_rows(op.matvec(theta, v_full[:n_orig]))[rows]
        return kops.matvec(kind, theta, x_loc, x, v_full)

    def mv_loc(v_loc):
        return kv_rows(gather(v_loc)) + noise2 * v_loc

    def tangent_rows(v_full):
        """This rank's rows of dK/dtheta_i @ v for every direction i
        (the structured operators)."""
        T = op.tangent_matvecs(theta, v_full[:n_orig])      # (m, n, b)
        if pad:
            T = torch.cat([T, T.new_zeros((m, pad, T.shape[2]))], dim=1)
        return T[:, rows]

    # ---- batched CG on [y | probes] ----
    b_loc = rhs_loc
    sol = torch.zeros_like(b_loc)
    r = b_loc
    pv = r
    rz = dots(r, r)
    thresh = cg_tol * torch.clamp(torch.sqrt(dots(b_loc, b_loc)), min=1e-30)
    iters = 0
    # the stop test reads the residuals of every column: one host read
    # per iteration; ||r|| is sqrt(r . r), the dot CG carries
    while iters < cg_max_iter and _sync.host(
            torch.any(torch.sqrt(rz) > thresh), "distributed_cg"):
        Ap = mv_loc(pv)
        alpha = rz / torch.clamp(dots(pv, Ap), min=1e-300)
        sol = sol + alpha * pv
        r = r - alpha * Ap
        rz_new = dots(r, r)
        beta = rz_new / torch.clamp(rz, min=1e-300)
        pv = r + beta * pv
        rz = rz_new
        iters += 1
    alpha_loc = sol[:, 0]
    kinv_z_loc = sol[:, 1:]
    y_loc = rhs_loc[:, 0]
    z_loc = rhs_loc[:, 1:]
    s2 = dots(y_loc, alpha_loc) / n_orig

    # ---- SLQ log-det: Lanczos on the sharded probe block ----
    k = lanczos_k
    p = z_loc.shape[1]
    Q = z_loc.new_zeros((k,) + tuple(z_loc.shape))
    Q[0] = z_loc / torch.clamp(torch.sqrt(dots(z_loc, z_loc)), min=1e-30)
    al = z_loc.new_zeros((k, p))
    be = z_loc.new_zeros((max(k - 1, 1), p))
    for i in range(k):
        qi = Q[i]
        w = mv_loc(qi)
        a = dots(qi, w)
        bprev = be[i - 1] if i > 0 else torch.zeros_like(a)
        w = w - a * qi - bprev * Q[max(i - 1, 0)]
        proj = _all_sum(torch.einsum("knp,np->kp", Q[:i + 1], w), group)
        w = w - torch.einsum("kp,knp->np", proj, Q[:i + 1])
        bn = torch.sqrt(dots(w, w))
        if i + 1 < k:
            Q[i + 1] = w / torch.clamp(bn, min=1e-30)
            be[i] = bn
        al[i] = a
    logdet = it.slq_plain_logdet(al, be, n_pad)
    # the sentinel rows decouple into a (1 + noise2) I block (unit-diagonal
    # kernels); copied from the JAX package, which scales the SLQ mean by
    # n_pad although the zero pad rows of the probes never see that block
    logdet = logdet - pad * math.log(1.0 + noise2)
    lp = -0.5 * n_orig * (LOG2PI + 1.0 + torch.log(s2)) - 0.5 * logdet

    # ---- gradient (eq. 2.17) with Hutchinson traces ----
    grad = torch.zeros_like(theta)
    if with_grad:
        alpha_full = gather(alpha_loc[:, None])
        z_full = gather(z_loc)
        if structured:
            # all m directions per right-hand side, this rank's rows
            dk_as = tangent_rows(alpha_full)[:, :, 0]
            dk_zs = tangent_rows(z_full)
        grads = []
        for i in range(m):
            if structured:
                dk_a, dk_z = dk_as[i], dk_zs[i]
            else:
                e = torch.zeros_like(theta)
                e[i] = 1.0
                dk_a = kops.matvec_jvp(kind, theta, e, x_loc, x,
                                       alpha_full)[1][:, 0]
                dk_z = kops.matvec_jvp(kind, theta, e, x_loc, x, z_full)[1]
            g_quad = 0.5 * dots(alpha_loc, dk_a) / s2
            g_tr = 0.5 * torch.mean(dots(kinv_z_loc, dk_z))
            grads.append(g_quad - g_tr)
        grad = torch.stack(grads)
    return DistGPResult(lp, grad, s2, iters)


def lower_gp_cell(kind: str, n: int, mesh, n_probes: int = 16,
                  dtype=None):
    """The JAX package's dry-run lowering of the distributed step on a
    production TPU mesh (launch/dryrun.py --gp): not ported."""
    raise _pending.pending("lower_gp_cell (the dry-run lowering on a "
                           "production mesh)", _pending.LM)
