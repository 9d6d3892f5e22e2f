"""The HIP-GP model (mean-field, block-diagonal and full-rank families) and
the dense SVGP baseline; the 1-D derivative-observation GP is the
functional module `models.derivative_gp`."""
from .hipgp import HIPGP, HIPGPState
from .svgp import SVGP, SVGPState
from . import derivative_gp

__all__ = ["HIPGP", "HIPGPState", "SVGP", "SVGPState", "derivative_gp"]
