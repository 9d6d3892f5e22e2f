"""Stationary covariance kernels and the inter-domain cross-covariances of
line-integral observations."""
from .interdomain import (DoublyDiagInterpolator, k_doubly_diag_quad,
                          k_semi_mc, k_semi_quad, k_semi_sqexp)
from .stationary import Gneiting, Kernel, Matern, SqExp, kernel_from_name

__all__ = ["Kernel", "SqExp", "Matern", "Gneiting", "kernel_from_name",
           "DoublyDiagInterpolator", "k_doubly_diag_quad", "k_semi_mc",
           "k_semi_quad", "k_semi_sqexp"]
