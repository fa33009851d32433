"""Hyperlikelihood constants (paper Sec. 2).

Counterpart of ``marginal_const`` in ``repro/core/hyperlik.py``; the dense
hyperlikelihood itself comes with the dense slice.
"""

from __future__ import annotations

import math


def marginal_const(n: int, jeffreys_norm: float = 1.0) -> float:
    """ln of the constant relating P_marg to P_max, eq. (2.18):
    P_marg = c/2 (2e/n)^{n/2} Gamma(n/2) P_max, c the Jeffreys
    normalisation.  Model-independent (cancels in Bayes factors)."""
    n = float(n)
    return (math.log(jeffreys_norm / 2.0)
            + 0.5 * n * (math.log(2.0) + 1.0 - math.log(n))
            + math.lgamma(0.5 * n))
