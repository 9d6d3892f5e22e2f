"""hipgp_tpu_torch — the PyTorch/CUDA port of hipgp_tpu.

Hierarchical inducing-point Gaussian processes on a grid, for one NVIDIA
Hopper card: the BTTB/circulant operator, the PCG whitening solve, the
mean-field natural-gradient SVI fit and prediction.  The hot op of the 2-D
path, the cropped real-Fourier sandwich, is a hand-written CUDA kernel
(``csrc/mxu2d.cu``) built with nvcc at first use; everything else is plain
PyTorch.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, where each kernel's plain PyTorch version runs instead.
"""

__version__ = "0.1.0"

from . import convert, infer, kernels, models, ops, utils

__all__ = ["convert", "infer", "kernels", "models", "ops", "utils"]
