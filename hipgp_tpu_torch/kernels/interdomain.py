"""Inter-domain cross-covariances for line-integral observations.

Counterpart of `hipgp_tpu/kernels/interdomain.py`.  An integrated
observation is e(x') = ||x'|| * int_0^1 f(alpha x') dalpha, the integral of
the latent field along the ray from the origin to x' (the geometry of
interstellar-dust extinction).  Three pieces:

* :func:`k_semi_sqexp` - the analytic semi-integrated cross-covariance of
  the squared-exponential kernel (a difference of Gaussian CDFs);
* :func:`k_semi_mc` - the randomized-midpoint Monte-Carlo estimator for any
  kernel, from a ``torch.Generator`` or from the stratified offset itself;
* :class:`DoublyDiagInterpolator` - the doubly-integrated diagonal
  K~(x', x') by linear interpolation in a unit-parameter table, scaled on
  the device.

The host oracles (:func:`k_semi_quad`, :func:`k_doubly_diag_quad`) are
tensorized Gauss-Legendre quadratures in numpy; the interpolator builds its
table with the second one, in this process (no disk cache).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..utils.stats import normal_cdf

__all__ = [
    "k_semi_sqexp",
    "k_semi_mc",
    "DoublyDiagInterpolator",
    "k_semi_quad",
    "k_doubly_diag_quad",
    "normal_cdf",
]

SQRT2PI = math.sqrt(2.0 * math.pi)


def k_semi_sqexp(xpoint: torch.Tensor, xintegrated: torch.Tensor,
                 params) -> torch.Tensor:
    """Analytic Cov(f(xpoint), e(xintegrated)) for SqExp: (Npoint, Nint).

    With k(x, y) = sig2 exp(-1/2 (x-y)^T S^{-1} (x-y)), S = ell^2 I, the ray
    integral of a Gaussian bump is a difference of Gaussian CDFs:
      int_0^1 exp(-1/2 (a t^2 - 2 b t + c)) dt
        = exp(b^2/2a - c/2) sqrt(2 pi / a) [Phi((1-b/a) sqrt a) - Phi((-b/a) sqrt a)].
    """
    sig2, ell = params
    inv_ell2 = 1.0 / (ell * ell)   # scalar or (D,) ARD
    xi, xp = xintegrated, xpoint

    dists = torch.sqrt(torch.sum(xi * xi, dim=-1))           # (Nint,)
    a = torch.sum((xi * xi) * inv_ell2, dim=-1)               # (Nint,)
    b = (xi * inv_ell2) @ xp.T                                # (Nint, Npoint)
    c = torch.sum((xp * xp) * inv_ell2, dim=-1)               # (Npoint,)

    a = torch.clamp(a, min=1e-30)[:, None]
    scale = torch.sqrt(1.0 / a)
    loc = b / a
    coef = sig2 * torch.exp(b * b / (2.0 * a) - c[None, :] / 2.0) * SQRT2PI * scale
    phi = normal_cdf(1.0, loc, scale) - normal_cdf(0.0, loc, scale)
    return (coef * phi * dists[:, None]).T


def k_semi_mc(kernel: Callable, xpoint: torch.Tensor, xintegrated: torch.Tensor,
              params, npts: int = 5, generator: Optional[torch.Generator] = None,
              u: Optional[float] = None) -> torch.Tensor:
    """Randomized-midpoint MC estimate of the semi-integrated kernel:
    (Npoint, Nint).

    One shared stratified grid alpha_j = j/npts + u with u ~ U[0, 1/npts),
    drawn from ``generator`` (a CPU generator; seed 0 when None) unless the
    offset ``u`` itself is given."""
    D = xpoint.shape[1]
    Ni = xintegrated.shape[0]
    if u is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        u = float(torch.rand((), generator=generator, dtype=torch.float64)) / npts
    alphas = (torch.arange(npts, dtype=xpoint.dtype, device=xpoint.device) / npts
              + u)
    xgrid = xintegrated[:, None, :] * alphas[None, :, None]   # (Ni, npts, D)
    Kpis = kernel(xpoint, xgrid.reshape(-1, D), params).reshape(-1, Ni, npts)
    dists = torch.sqrt(torch.sum(xintegrated ** 2, dim=-1))
    return torch.mean(Kpis, dim=-1) * dists[None, :]


# ---------------------------------------------------------------------------
# Host Gauss-Legendre quadrature oracles (numpy; table builds and tests).
# ---------------------------------------------------------------------------


def _gl_nodes(n: int, lo: float = 0.0, hi: float = 1.0):
    x, w = np.polynomial.legendre.leggauss(n)
    x = 0.5 * (hi - lo) * x + 0.5 * (hi + lo)
    w = 0.5 * (hi - lo) * w
    return x, w


def k_semi_quad(kernel_np: Callable, xpoint: np.ndarray, xint: np.ndarray,
                order: int = 200) -> np.ndarray:
    """High-order quadrature oracle for the semi-integrated kernel;
    ``kernel_np(x, y) -> (N, M)`` numpy.  Returns (Npoint, Nint)."""
    xpoint = np.asarray(xpoint, dtype=np.float64)
    xint = np.asarray(xint, dtype=np.float64)
    t, w = _gl_nodes(order)
    Ni, D = xint.shape
    pts = (xint[:, None, :] * t[None, :, None]).reshape(-1, D)
    K = np.asarray(kernel_np(xpoint, pts)).reshape(len(xpoint), Ni, order)
    dists = np.sqrt(np.sum(xint ** 2, axis=-1))
    return np.einsum("pio,o->pi", K, w) * dists[None, :]


def k_doubly_diag_quad(kernel_np: Callable, x: np.ndarray,
                       order: int = 100) -> np.ndarray:
    """Quadrature oracle for the doubly-integrated diagonal: for each row
    x_n, ||x_n||^2 * int_0^1 int_0^1 k(a x_n, b x_n) da db.  Returns (N,)."""
    x = np.asarray(x, dtype=np.float64)
    t, w = _gl_nodes(order)
    out = np.zeros(x.shape[0])
    W = np.outer(w, w)
    for n in range(x.shape[0]):
        pa = x[n][None, :] * t[:, None]                       # (order, D)
        K = np.asarray(kernel_np(pa, pa))                     # (order, order)
        out[n] = np.sum(W * K) * np.sum(x[n] ** 2)
    return out


class DoublyDiagInterpolator:
    """Linear interpolation of the doubly-integrated diagonal.

    At construction it builds the unit-parameter table
    g(d) = d^2 * int int k1(a d e, b d e) da db on an N-point distance grid
    by host quadrature in float64; a call evaluates
    K~(x, x; sig2, ell) = (||x||^2 / s^2) * sig2 * g(s), s = ||x / ell||, by
    linear interpolation with the last slope extrapolated (the reference
    interpolator's semantics).  The table is rebuilt in every process; it
    takes well under a second."""

    def __init__(self, kernel, N: int = 50, dmax: float = 5.0, order: int = 100):
        dgrid = np.linspace(0.0, dmax, N)
        one = torch.tensor(1.0, dtype=torch.float64)

        def kernel_np(a, b):
            return kernel(torch.as_tensor(a), torch.as_tensor(b), (one, one)).numpy()

        knn = k_doubly_diag_quad(kernel_np, np.column_stack([dgrid, np.zeros(N)]),
                                 order=order)
        slopes = (knn[1:] - knn[:-1]) / (dgrid[1:] - dgrid[:-1])
        self.distance_grid = dgrid
        self.slopes = np.concatenate([slopes, slopes[-1:]])
        self.knn = knn
        self._tables: Dict[tuple, tuple] = {}

    def _on(self, dtype, device):
        key = (dtype, str(device))
        if key not in self._tables:
            self._tables[key] = tuple(
                torch.as_tensor(a).to(dtype=dtype, device=device)
                for a in (self.distance_grid, self.slopes, self.knn))
        return self._tables[key]

    def __call__(self, x: torch.Tensor, params) -> torch.Tensor:
        sig2, ell = params
        grid, slopes, knn = self._on(x.dtype, x.device)
        s2 = torch.sum((x / ell) ** 2, dim=-1)
        dists = torch.sqrt(s2)
        lower = torch.clamp(torch.sum(dists[:, None] > grid[None, :], dim=-1) - 1,
                            0, len(self.knn) - 1)
        ivals = knn[lower] + slopes[lower] * (dists - grid[lower])
        # exact ARD reduction: k(a x, b x) = k1(|a - b| s), so
        # K~(x, x) = sig2 (||x||^2 / s^2) g(s); g(0) = 0 makes the guard inert
        x2 = torch.sum(x * x, dim=-1)
        return x2 / torch.clamp(s2, min=1e-30) * sig2 * ivals
