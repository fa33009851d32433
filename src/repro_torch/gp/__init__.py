"""The front door: specs, sessions and model comparison."""

from .compare import compare, log_bayes_factors
from .session import GP
from .spec import GPSpec, NoiseModel, SolverPolicy, as_spec, spec_bank

__all__ = ["GP", "GPSpec", "NoiseModel", "SolverPolicy", "as_spec",
           "spec_bank", "compare", "log_bayes_factors"]
