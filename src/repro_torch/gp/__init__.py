"""The front door: specs, sessions, model comparison and the batched
candidate bank (:mod:`repro_torch.gp.batch`)."""

from ..core.model_compare import ModelReport
from . import batch
from .compare import compare, log_bayes_factors
from .session import GP
from .spec import GPSpec, NoiseModel, SolverPolicy, as_spec, spec_bank

__all__ = ["GP", "GPSpec", "NoiseModel", "SolverPolicy", "ModelReport",
           "as_spec", "spec_bank", "compare", "log_bayes_factors"]
