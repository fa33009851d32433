"""Process groups for the distributed GP step.

Counterpart of ``repro/launch/mesh.py``.  ``make_local_mesh`` there builds
a tiny mesh over the local devices so that tests drive the sharded code
path on one device; :func:`make_local_group` here starts the default
``torch.distributed`` group of this one process (world size 1): NCCL on
the card, gloo on the CPU, with the rendezvous in an in-process
``HashStore`` (no port, no file).  Multi-rank groups are the caller's:
``torch.distributed.init_process_group`` with a store, a rank and a world
size.  ``make_production_mesh`` (TPU pods) is not ported.
"""

from __future__ import annotations

import datetime

import torch.distributed as dist

from .._device import resolve_device

INIT_TIMEOUT_S = 60


def make_local_group(device=None):
    """The world-size-1 default process group for ``device`` (None: the
    card).  Raises if a default group exists already; end it with
    ``torch.distributed.destroy_process_group()``."""
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already; call "
                           "torch.distributed.destroy_process_group() first")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, store=dist.HashStore(), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    return dist.group.WORLD
