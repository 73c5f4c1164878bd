"""Reference-compatible namespace (counterpart of `aux_ssm_tpu/csmc.py`):
the generic and independent auxiliary particle-Gibbs kernel factories and
the Feynman-Kac model interfaces."""

from .kernels.csmc_aux import get_kernel as get_generic_kernel
from .kernels.csmc_base import CSMCState, Distribution, Dynamics, Potential, UnivariatePotential
from .kernels.csmc_independent import get_kernel as get_independent_kernel

__all__ = [
    "get_generic_kernel",
    "get_independent_kernel",
    "CSMCState",
    "Distribution",
    "UnivariatePotential",
    "Dynamics",
    "Potential",
]
