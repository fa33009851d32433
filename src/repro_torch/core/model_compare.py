"""Model-comparison reports and pairwise log Bayes factors (paper Secs. 2-3).

Counterpart of ``ModelReport`` and ``log_bayes_factors`` in
``repro/core/model_compare.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass
class ModelReport:
    name: str
    theta_hat: torch.Tensor
    sigma_f_hat: float
    log_p_max: float
    log_z_laplace: float
    errors: torch.Tensor        # inverse-Hessian error bars (best mode)
    n_evals_train: int
    n_modes: int = 1            # distinct modes summed into log_z_laplace
    log_z_nested: Optional[float] = None
    log_z_nested_err: Optional[float] = None
    n_evals_nested: Optional[int] = None

    @property
    def speedup(self) -> Optional[float]:
        """Likelihood-evaluation speed-up factor over nested sampling."""
        if self.n_evals_nested is None:
            return None
        return self.n_evals_nested / max(self.n_evals_train + 1, 1)


def log_bayes_factors(reports: Sequence[ModelReport]):
    """Pairwise ln B_ij = ln Z_i - ln Z_j (Laplace estimates)."""
    z = torch.tensor([r.log_z_laplace for r in reports], dtype=torch.float64)
    return z[:, None] - z[None, :]
