"""The port's one source of randomness.

A :class:`Key` records a seed and the path of splits and fold-ins that led
to it, exactly where the JAX package splits or folds its ``jax.random``
keys.  Only :func:`rademacher`, :func:`uniform`, :func:`normal`,
:func:`randint` and :func:`permutation` draw: each seeds a
``torch.Generator`` from the sha256 of ``repr((seed, path))``.  The draws
differ from JAX's bits for the same seed; a test that needs the JAX
package's probes, scan points, start points, epoch orders and the nested
sampler's draws replaces these functions by ones that replay the key's
path with ``jax.random`` (the key path is the whole interface).

A key carries the hash state of its repr up to the path's closing
brackets, so a split, a fold-in and a draw cost the same at any depth (the
nested sampler splits its key once per iteration, tens of thousands of
times).
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import torch


class Key:
    """A seed and the path of ``("split", n, i)`` / ``("fold_in", data)``
    steps that derive this key from it.

    Immutable.  A child copies its parent's hash state and feeds it one
    step; ``path`` is built on first use, from the parent's, and cached.
    """

    __slots__ = ("seed", "_parent", "_step", "_depth", "_sha", "_path")

    def __init__(self, seed: int, path: Tuple[tuple, ...] = ()):
        self.seed = int(seed)
        self._parent = None
        self._step = None
        self._depth = 0
        self._sha = hashlib.sha256(f"({self.seed!r}, (".encode())
        for step in path:
            self._feed(step)
        self._path = tuple(path)

    def _feed(self, step: tuple) -> None:
        sep = b", " if self._depth else b""
        self._sha.update(sep + repr(step).encode())
        self._depth += 1

    def _child(self, step: tuple) -> "Key":
        k = Key.__new__(Key)
        k.seed = self.seed
        k._parent = self
        k._step = step
        k._depth = self._depth
        k._sha = self._sha.copy()
        k._feed(step)
        k._path = None
        return k

    @property
    def parent(self):
        """The key this one was split or folded from (None for a root)."""
        return self._parent

    @property
    def step(self):
        """The last step of the path, from :attr:`parent` (None for a
        root)."""
        return self._step

    @property
    def path(self) -> Tuple[tuple, ...]:
        if self._path is None:
            chain = []
            k = self
            while k._path is None:
                chain.append(k)
                k = k._parent
            for c in reversed(chain):
                c._path = c._parent._path + (c._step,)
        return self._path

    def digest(self) -> bytes:
        """sha256 of ``repr((seed, path))`` (a one-step path's repr keeps
        its trailing comma)."""
        h = self._sha.copy()
        h.update(b",))" if self._depth == 1 else b"))")
        return h.digest()

    def __eq__(self, other):
        if not isinstance(other, Key):
            return NotImplemented
        return self.seed == other.seed and self.path == other.path

    def __hash__(self):
        return hash((self.seed, self.path))

    def __repr__(self):
        return f"Key(seed={self.seed!r}, path={self.path!r})"

    def __reduce__(self):
        return Key, (self.seed, self.path)


def key(seed: int) -> Key:
    return Key(int(seed))


def split(k: Key, num: int = 2) -> Tuple[Key, ...]:
    """``num`` child keys, as ``jax.random.split(k, num)``."""
    num = int(num)
    return tuple(k._child(("split", num, i)) for i in range(num))


def fold_in(k: Key, data: int) -> Key:
    """A child key for ``data``, as ``jax.random.fold_in(k, data)``."""
    return k._child(("fold_in", int(data)))


def _generator(k: Key) -> torch.Generator:
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int.from_bytes(k.digest()[:8], "little") & (2**63 - 1))
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


def randint(k: Key, shape, lo: int, hi: int, *, device):
    """Integers uniform on [lo, hi) (int64), as
    ``jax.random.randint(k, shape, lo, hi)`` (the nested sampler's chain
    starts)."""
    return torch.randint(int(lo), int(hi), tuple(shape),
                         generator=_generator(k)).to(device)


def permutation(k: Key, n: int, *, device):
    """A random permutation of range(n) (int64), as
    ``jax.random.permutation(k, n)`` (the stochastic backend's epochs)."""
    return torch.randperm(int(n), generator=_generator(k)).to(device)
