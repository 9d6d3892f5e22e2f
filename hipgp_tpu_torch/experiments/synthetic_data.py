"""Synthetic data generators for the paper experiments.

Parity reference: `experiments-hip-gp/synthetic_data.py` (random sin/tanh
MLP surface, complexities simple/medium/hard) and
`ziggy/misc/util.py:53-74` (integrated_obs ray quadrature) — rebuilt with
numpy (no torch), vectorized Gauss-Legendre ray integration instead of
per-point scipy.quad loops.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["make_two_dim_function", "make_two_dim_data", "integrated_obs", "make_one_dim_function"]


def make_two_dim_function(weight_std: float = 35.0, hidden_dim: int = 10, seed: int = 42):
    """Random one-hidden-layer sin/tanh network with softplus output —
    a wiggly positive 2-D surface."""
    rs = np.random.RandomState(seed)
    W = rs.randn(2, hidden_dim) * weight_std
    b = rs.randn(hidden_dim) * weight_std
    Wo = rs.randn(hidden_dim, 1) * 0.2
    bo = rs.randn(1) * 0.2

    def f(x):
        x = np.atleast_2d(np.asarray(x, np.float64))
        h = np.tanh(np.sin(x @ W + b))
        out = h @ Wo + bo
        return np.logaddexp(0.0, out)  # softplus

    return f


def make_one_dim_function(weight_std: float = 10.0, hidden_dim: int = 25, seed: int = 0):
    """Random 1-D MLP function and its analytic derivative (for the
    derivative-observation experiment, `run_exact_gp_1d_derivative.py`)."""
    rs = np.random.RandomState(seed)
    W = rs.randn(1, hidden_dim) * weight_std
    b = rs.randn(hidden_dim)
    Wo = rs.randn(hidden_dim, 1) * 0.5

    def f(t):
        t = np.asarray(t, np.float64).reshape(-1, 1)
        return (np.tanh(t @ W + b) @ Wo).reshape(-1)

    def fprime(t):
        t = np.asarray(t, np.float64).reshape(-1, 1)
        s = 1.0 - np.tanh(t @ W + b) ** 2
        return ((s * W) @ Wo).reshape(-1)

    return f, fprime


def integrated_obs(xobs: np.ndarray, ftrue: Callable, order: int = 128) -> np.ndarray:
    """e(x) = ||x|| * int_0^1 f(a x) da via Gauss-Legendre quadrature
    (replacing the reference's per-point scipy.quad loop,
    `ziggy/misc/util.py:53-74`)."""
    xobs = np.asarray(xobs, np.float64)
    t, w = np.polynomial.legendre.leggauss(order)
    t = 0.5 * (t + 1.0)
    w = 0.5 * w
    N, D = xobs.shape
    pts = (xobs[:, None, :] * t[None, :, None]).reshape(-1, D)
    vals = np.asarray(ftrue(pts)).reshape(N, order)
    dists = np.sqrt(np.sum(xobs**2, axis=-1))
    return (vals @ w) * dists


def make_two_dim_data(
    Nobs: int = 20000,
    Ntest: int = 2000,
    noise_std: float = 0.01,
    function_complexity: str = "medium",
    do_integrated: bool = False,
    xlo: float = -1.0,
    xhi: float = 1.0,
    gridnum: int = 256,
    seed: int = 42,
) -> Dict:
    """The synthetic 2-D regression dataset
    (`experiments-hip-gp/synthetic_data.py:13-77`): mean-centered truth on a
    gridnum^2 grid, uniform observations with iid noise, optional
    line-integral observations."""
    rs = np.random.RandomState(seed)
    weight_std, hidden_dim = {
        "simple": (10, 10),
        "medium": (35, 10),
        "hard": (40, 25),
    }[function_complexity]
    ftrue = make_two_dim_function(weight_std, hidden_dim, seed=42)

    x1 = np.linspace(xlo, xhi, gridnum)
    x2 = np.linspace(xlo, xhi, gridnum)
    xx1, xx2 = np.meshgrid(x1, x2, indexing="ij")
    xgrid = np.column_stack([xx1.ravel(), xx2.ravel()])
    fgrid_orig = ftrue(xgrid).reshape(-1)
    fmean = fgrid_orig.mean()
    fgrid = fgrid_orig - fmean

    xobs = rs.rand(Nobs, 2) * (xhi - xlo) + xlo
    sobs = noise_std * np.ones(Nobs)
    fobs = ftrue(xobs).reshape(-1) - fmean
    yobs = fobs + sobs * rs.randn(Nobs)

    xtest = rs.rand(Ntest, 2) * (xhi - xlo) + xlo
    ftest = ftrue(xtest).reshape(-1) - fmean

    eobs = aobs = etest = None
    if do_integrated:
        fc = lambda x: ftrue(x).reshape(-1) - fmean
        eobs = integrated_obs(xobs, fc)
        aobs = eobs + sobs * rs.randn(Nobs)
        etest = integrated_obs(xtest, fc)

    return {
        "xobs": xobs, "fobs": fobs, "yobs": yobs, "sobs": sobs,
        "eobs": eobs, "aobs": aobs,
        "xtest": xtest, "ftest": ftest, "etest": etest,
        "xgrid": xgrid, "fgrid": fgrid,
        "x1_grid": x1, "x2_grid": x2,
        "grid_shape": (gridnum, gridnum),
        "grid_extent": (xlo, xhi, xlo, xhi),
        "f_snr": float(np.std(fobs) / noise_std),
        "ftrue": ftrue,
        "fmean": float(fmean),
    }
