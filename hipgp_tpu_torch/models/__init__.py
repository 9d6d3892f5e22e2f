"""The HIP-GP model (mean-field family, circulant whitening)."""
from .hipgp import HIPGP, HIPGPState

__all__ = ["HIPGP", "HIPGPState"]
