"""hipgp_tpu_torch — the PyTorch/CUDA port of hipgp_tpu.

Hierarchical inducing-point Gaussian processes on a grid, for one NVIDIA
Hopper card: the BTTB/circulant operator, the PCG whitening solve, the
mean-field natural-gradient SVI fit (with Adam on the hyperparameters,
differentiated through the whitening) and prediction, for point and
line-integral observations.  The hot ops are hand-written CUDA kernels built
with nvcc at first use: the cropped real-Fourier sandwich of the 2-D path
and its full-plane form (``csrc/sandwich_fft.cu``), its weight-plane form for
the 3-D path (``csrc/sandwich_wp.cu``), the whole-sample 3-D sandwich
(``csrc/mxu3d.cu``) and
the stages of the packed radix circulant apply of the 1-D long axis
(``csrc/radix.cu``); everything else is plain PyTorch.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``, where each kernel's
plain PyTorch version runs instead.
"""

__version__ = "0.1.0"

from . import convert, infer, kernels, models, ops, utils

__all__ = ["convert", "infer", "kernels", "models", "ops", "utils"]
