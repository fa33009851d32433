"""Refusals for what the port does not run yet.

Anything outside the ported path raises :class:`NotImplementedError` that
names the slice of ROADMAP.md queue A which brings it, instead of falling
back to another path (which would answer differently from the JAX package).
"""

from __future__ import annotations

PIVCHOL = ("the rest of slice S2 (pivoted-Cholesky preconditioner and "
           "low-rank operator)")
SERVE = "module A5 (serve/ and checkpoint/)"
LM = "module A7 (the LM scaffold and its launch/ tools)"


def pending(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; it comes with "
        f"{slice_name} (ROADMAP.md, queue A)")
