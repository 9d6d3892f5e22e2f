"""Stationary covariance kernels, the inter-domain cross-covariances of
line-integral observations and the derivative-observation covariances."""
from .interdomain import (DoublyDiagInterpolator, k_doubly_diag_quad,
                          k_semi_mc, k_semi_quad, k_semi_sqexp)
from .stationary import Gneiting, Kernel, Matern, SqExp, kernel_from_name
from . import derivatives

__all__ = ["Kernel", "SqExp", "Matern", "Gneiting", "kernel_from_name",
           "DoublyDiagInterpolator", "k_doubly_diag_quad", "k_semi_mc",
           "k_semi_quad", "k_semi_sqexp", "derivatives"]
