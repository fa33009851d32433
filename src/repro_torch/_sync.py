"""Counted host reads of device values.

Eager PyTorch has no ``while_loop``: a loop whose condition depends on a
device value (CG's residual test, NCG's Armijo test) reads it back to the
host once per iteration, which waits for the device.  Every such read on
the solver path goes through :func:`host`, so a run can report how many it
made (:data:`COUNT`).
"""

from __future__ import annotations

import collections

COUNT: collections.Counter = collections.Counter()


def host(t, what: str = "read"):
    """The Python value of a 0-d tensor (bool, int or float), counted."""
    COUNT[what] += 1
    return t.item()


def reset() -> None:
    COUNT.clear()


def total() -> int:
    return sum(COUNT.values())
