"""Run the LIVE reference (ziggy) on modern torch via API shims.

The port's own copy of `hipgp_tpu/experiments/ref_compat.py` (which
imports only torch), so that the port imports nothing of the JAX package.

The reference targets torch<=1.7: its FFT/Toeplitz layer calls the removed
function forms ``torch.fft(x, signal_ndim)`` / ``torch.ifft`` (complex as a
trailing dim of size 2), and its linear algebra uses the removed
``torch.cholesky`` / ``torch.triangular_solve`` / ``torch.solve``.  This
module installs faithful shims for exactly those five calls so the actual
reference natgrad/batch-solve/predict stack executes unmodified on CPU
torch 2.x — used by the natgrad trajectory parity study
(`experiments/natgrad_trajectory.py`) and available to tests.  The
reference checkout is looked for at ``REF_ROOT``: the ``HIPGP_REFERENCE``
environment variable, else ``/root/reference``, the fixed location that the
JAX package's `import_ziggy` and its reference tests use;
`import_ziggy` raises FileNotFoundError without it.

The shims reproduce the OLD contracts:
  * old ``torch.fft(input, signal_ndim, normalized=False)``: input
    (..., 2) real view of complex, transform over the LAST ``signal_ndim``
    dims (before the trailing 2).
  * old ``torch.solve(B, A) -> (X, LU)`` solves A X = B (note argument
    order) — LU is returned as A (the reference only uses ``[0]``).
  * old ``torch.triangular_solve(B, A, upper=True, ...) -> (X, A)``.

This is test scaffolding for parity evidence, not part of the port's
compute path.
"""
from __future__ import annotations

import os
import sys
import types

_INSTALLED = False
REF_ROOT = os.environ.get("HIPGP_REFERENCE", "/root/reference")


def reference_present(ref_root: str = None) -> bool:
    """True when the ziggy package is in the reference checkout."""
    return os.path.isdir(os.path.join(ref_root or REF_ROOT, "ziggy"))


def install():
    """Idempotently install the torch<=1.7 shims and pyprind stub; returns
    the patched torch module."""
    global _INSTALLED
    import torch

    if _INSTALLED:
        return torch

    if "pyprind" not in sys.modules:  # cosmetic progress-bar dep of the ref
        mod = types.ModuleType("pyprind")
        mod.prog_bar = lambda it, **k: it
        sys.modules["pyprind"] = mod

    fftmod = torch.fft  # the torch.fft MODULE (keep a handle before shadowing)

    def _dims(signal_ndim):
        return tuple(range(-signal_ndim, 0))

    def old_fft(input, signal_ndim, normalized=False):
        c = torch.view_as_complex(input.contiguous())
        norm = "ortho" if normalized else "backward"
        return torch.view_as_real(fftmod.fftn(c, dim=_dims(signal_ndim), norm=norm))

    def old_ifft(input, signal_ndim, normalized=False):
        c = torch.view_as_complex(input.contiguous())
        norm = "ortho" if normalized else "backward"
        return torch.view_as_real(fftmod.ifftn(c, dim=_dims(signal_ndim), norm=norm))

    # keep torch.fft.<submodule attrs> working for any modern-API callers
    for name in dir(fftmod):
        if not name.startswith("_"):
            setattr(old_fft, name, getattr(fftmod, name))

    def old_cholesky(input, upper=False, out=None):
        L = torch.linalg.cholesky(input)
        L = L.mH if upper else L
        if out is not None:
            out.copy_(L)
            return out
        return L

    def old_triangular_solve(b, A, upper=True, transpose=False, unitriangular=False):
        X = torch.linalg.solve_triangular(
            A.mT if transpose else A, b, upper=(upper != transpose),
            unitriangular=unitriangular,
        )
        return X, A

    def old_solve(B, A):
        return torch.linalg.solve(A, B), A

    # torch<=1.7 also had .fft/.ifft as Tensor METHODS (used by the
    # reference's gpt_fft.py:8,12 on the hyperparameter-gradient path);
    # modern Tensor has no such attributes, so adding them is safe.
    def method_fft(self, signal_ndim, normalized=False):
        return old_fft(self, signal_ndim, normalized)

    def method_ifft(self, signal_ndim, normalized=False):
        return old_ifft(self, signal_ndim, normalized)

    torch.fft = old_fft
    torch.ifft = old_ifft
    torch.Tensor.fft = method_fft
    torch.Tensor.ifft = method_ifft
    torch.cholesky = old_cholesky
    torch.triangular_solve = old_triangular_solve
    torch.solve = old_solve
    _INSTALLED = True
    return torch


def import_ziggy(ref_root: str = None):
    """Install shims and import the reference package; returns the module.
    Raises FileNotFoundError when the checkout has no ``ziggy``."""
    ref_root = ref_root or REF_ROOT
    if not reference_present(ref_root):
        raise FileNotFoundError(
            f"the live reference (ziggy) is not at {ref_root}: the 'ref' and "
            "'ref-svgp' legs need its checkout (set HIPGP_REFERENCE)")
    install()
    if ref_root not in sys.path:
        sys.path.insert(0, ref_root)
    import ziggy

    return ziggy
