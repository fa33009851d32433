"""The port's one source of randomness.

A :class:`Key` records a seed and the path of splits and fold-ins that led
to it, exactly where the JAX package splits or folds its ``jax.random``
keys.  Only :func:`rademacher`, :func:`uniform` and :func:`normal` draw:
each seeds a ``torch.Generator`` from the key's path.  The draws differ
from JAX's bits for the same seed; a test that needs the JAX package's
probes, scan points and start points replaces these functions by ones
that replay the key's path with ``jax.random`` (the key path is the whole
interface).
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Tuple

import torch


class Key(NamedTuple):
    """A seed and the path of ``("split", n, i)`` / ``("fold_in", data)``
    steps that derive this key from it."""

    seed: int
    path: Tuple[tuple, ...] = ()


def key(seed: int) -> Key:
    return Key(int(seed), ())


def split(k: Key, num: int = 2) -> Tuple[Key, ...]:
    """``num`` child keys, as ``jax.random.split(k, num)``."""
    return tuple(Key(k.seed, k.path + (("split", int(num), i),))
                 for i in range(int(num)))


def fold_in(k: Key, data: int) -> Key:
    """A child key for ``data``, as ``jax.random.fold_in(k, data)``."""
    return Key(k.seed, k.path + (("fold_in", int(data)),))


def _generator(k: Key) -> torch.Generator:
    digest = hashlib.sha256(repr((k.seed, k.path)).encode()).digest()
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int.from_bytes(digest[:8], "little") & (2**63 - 1))
    return gen


def rademacher(k: Key, shape, *, device, dtype=torch.float64):
    """+-1 entries with equal probability."""
    bits = torch.randint(0, 2, tuple(shape), generator=_generator(k))
    return (2 * bits - 1).to(device=device, dtype=dtype)


def uniform(k: Key, shape, lo: float = 0.0, hi: float = 1.0, *, device,
            dtype=torch.float64):
    """Uniform entries on [lo, hi)."""
    u = torch.rand(tuple(shape), generator=_generator(k), dtype=dtype)
    return (lo + (hi - lo) * u).to(device)


def normal(k: Key, shape, *, device, dtype=torch.float64):
    """Standard normal entries (the N(0, P) probes of preconditioned SLQ
    colour these)."""
    g = torch.randn(tuple(shape), generator=_generator(k), dtype=dtype)
    return g.to(device)
