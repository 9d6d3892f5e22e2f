"""Stationary covariance kernels."""
from .stationary import Gneiting, Kernel, Matern, SqExp, kernel_from_name

__all__ = ["Kernel", "SqExp", "Matern", "Gneiting", "kernel_from_name"]
