"""Dust-density ground truth for the dust-map experiment, deposited on the
device.

Counterpart of `hipgp_tpu/experiments/dust_density.py` (the reference's
``genDustDensity`` without yt):

* ``metal_weighted_dust_density`` - the per-particle metal-weighted
  neutral-hydrogen density of an SPH snapshot (numpy, float64);
* ``sph_deposit`` - SPH scatter of a per-particle field onto a regular grid
  with the M4 cubic-spline kernel: each particle adds to a static window of
  at most ``max_window`` cells a side around its base cell, by
  ``index_add_`` over flat cell indices, one chunk of particles at a time;
* ``cic_deposit`` - cloud-in-cell (trilinear) deposition of a mass-like
  quantity, divided by the cell volume;
* ``gen_dust_density`` - the two above on a latte-format npz snapshot.

The JAX package's choices are kept: the smoothing length clipped to the
window with a quarter-cell floor and one extra cell a side, the tail chunk
padded with zero-weight particles at ``left - 1e3``, and float32 by default
(``dtype=torch.float64`` gives the plain float64 deposition the card's run
is held against).  The functions take numpy input and return a numpy
array.  Float32 ``index_add_`` on a CUDA device adds in no fixed order, so
the card's grid differs from the CPU's by rounding.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["metal_weighted_dust_density", "sph_deposit", "cic_deposit",
           "gen_dust_density", "cubic_spline_kernel"]


def metal_weighted_dust_density(snapshot) -> np.ndarray:
    """Per-particle dust proxy rho * fractionH * hydrogen_neutral_fraction *
    10**metallicity, fractionH = 1 - massfraction_all - massfraction_he,
    from the latte npz keys ``density``, ``hydrogenneutralfraction``,
    ``massfraction`` (N, 2: [all, he]) and ``metallicitytotal``."""
    mf = np.asarray(snapshot["massfraction"], dtype=np.float64)
    frac_h = 1.0 - mf[:, 0] - mf[:, 1]
    rho = np.asarray(snapshot["density"], dtype=np.float64)
    neutral = np.asarray(snapshot["hydrogenneutralfraction"], dtype=np.float64)
    metallicity = np.asarray(snapshot["metallicitytotal"], dtype=np.float64)
    return rho * frac_h * neutral * 10.0 ** metallicity


def cubic_spline_kernel(q: torch.Tensor) -> torch.Tensor:
    """Unnormalized M4 cubic spline w(q), support q in [0, 2) (the 3-D
    normalization 1/(pi h^3) is the caller's)."""
    w1 = 1.0 - 1.5 * q ** 2 + 0.75 * q ** 3
    w2 = 0.25 * (2.0 - q) ** 3
    zero = torch.zeros_like(q)
    return torch.where(q < 1.0, w1, torch.where(q < 2.0, w2, zero))


def _window_offsets(w: int) -> np.ndarray:
    """(w^3, 3) integer offsets covering a w-cell cube centered at 0."""
    r = np.arange(w) - (w - 1) // 2
    ox, oy, oz = np.meshgrid(r, r, r, indexing="ij")
    return np.column_stack([ox.ravel(), oy.ravel(), oz.ravel()])


def _scatter(grid_flat, idx, w, dims):
    """Add the weights ``w`` (B, K) at cells ``idx`` (B, K, 3) into the flat
    grid; cells outside it get nothing."""
    dims_t = torch.as_tensor(dims, device=idx.device)
    inside = torch.all((idx >= 0) & (idx < dims_t), dim=-1)
    w = torch.where(inside, w, torch.zeros_like(w))
    flat = (idx[..., 0] * dims[1] + idx[..., 1]) * dims[2] + idx[..., 2]
    flat = torch.where(inside, flat, torch.zeros_like(flat))
    grid_flat.index_add_(0, flat.reshape(-1), w.reshape(-1))


def _sph_chunk(grid_flat, pos, vals, hs, left, cell, dims, offsets):
    """Scatter one particle chunk: pos (B, 3), vals (B,) = (m / rho) A,
    hs (B,); each particle onto the window ``offsets`` around its base
    (nearest-center) cell."""
    base = torch.floor((pos - left) / cell - 0.5).to(torch.int64)
    idx = base[:, None, :] + offsets[None, :, :]              # (B, W3, 3)
    centers = left + (idx.to(pos.dtype) + 0.5) * cell
    r = torch.sqrt(torch.sum((centers - pos[:, None, :]) ** 2, dim=-1))
    h = hs[:, None]
    w = cubic_spline_kernel(r / h) / (math.pi * h ** 3) * vals[:, None]
    _scatter(grid_flat, idx, w, dims)


def _chunks(n: int, chunk: int):
    return [(s, min(s + chunk, n)) for s in range(0, n, chunk)]


def sph_deposit(positions, values, masses, densities, smoothing_lengths, left_edge,
                right_edge, dims, chunk: int = 65536, max_window: int = 9,
                device="cuda", dtype=torch.float32) -> np.ndarray:
    """SPH scatter of a per-particle field onto a regular grid: at each cell
    center x, A(x) = sum_p (m_p / rho_p) A_p W(|x - x_p|, h_p) with the M4
    cubic spline (support 2 h).  h is clipped to the window (at least a
    quarter cell); a particle reaches at most ``max_window`` cells a side.
    Returns a (nx, ny, nz) numpy array."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    positions = np.asarray(positions, dtype=np_dt)
    vals = np.asarray((np.asarray(masses, np.float64)
                       / np.maximum(np.asarray(densities, np.float64), 1e-300))
                      * np.asarray(values, np.float64), dtype=np_dt)
    hs = np.asarray(smoothing_lengths, dtype=np_dt)
    left = np.asarray(left_edge, dtype=np_dt)
    right = np.asarray(right_edge, dtype=np_dt)
    dims = tuple(int(d) for d in dims)
    cell = (right - left) / np.asarray(dims, dtype=np_dt)
    # the window covers the support 2h measured from the particle, which
    # sits up to one cell past its floor-biased base-cell center: one extra
    # cell a side in the h clip and in the window; the quarter-cell floor
    # keeps r/h and 1/h^3 finite for tiny windows and h = 0
    max_h = float(cell.min()) * max(((max_window - 1) // 2 - 1) / 2.0, 0.25)
    hs = np.clip(hs, float(cell.min()) * 0.25, max_h)
    need = ((int(np.ceil(2.0 * hs.max() / cell.min())) + 1) * 2 + 1
            if len(hs) else 1)
    window = min(max(need, 3), max_window)
    offsets = torch.as_tensor(_window_offsets(window), dtype=torch.int64, device=device)
    as_t = lambda a: torch.as_tensor(a).to(device)
    grid = torch.zeros(math.prod(dims), dtype=dtype, device=device)
    left_t, cell_t = as_t(left), as_t(cell)
    n = len(positions)
    for s, e in _chunks(n, chunk):
        p, v, h = positions[s:e], vals[s:e], hs[s:e]
        if e - s < chunk and n > chunk:
            # the tail chunk padded to the chunk size with zero-weight
            # particles far outside the grid (the JAX package's static shape)
            pad = chunk - (e - s)
            p = np.concatenate([p, np.full((pad, 3), left - 1e3, np_dt)])
            v = np.concatenate([v, np.zeros(pad, np_dt)])
            h = np.concatenate([h, np.full(pad, hs.max(), np_dt)])
        _sph_chunk(grid, as_t(p), as_t(v), as_t(h), left_t, cell_t, dims, offsets)
    return grid.reshape(dims).cpu().numpy()


_CORNERS = [[a, b, c] for a in (0, 1) for b in (0, 1) for c in (0, 1)]


def _cic_chunk(grid_flat, pos, vals, left, cell, dims, corners):
    u = (pos - left) / cell - 0.5                 # cell-center coordinates
    i0 = torch.floor(u).to(torch.int64)
    frac = u - i0.to(pos.dtype)
    idx = i0[:, None, :] + corners[None, :, :]    # (B, 8, 3)
    w = torch.prod(torch.where(corners[None, :, :] == 1, frac[:, None, :],
                               1.0 - frac[:, None, :]), dim=-1) * vals[:, None]
    _scatter(grid_flat, idx, w, dims)


def cic_deposit(positions, quantity, left_edge, right_edge, dims, chunk: int = 262144,
                device="cuda", dtype=torch.float32) -> np.ndarray:
    """Cloud-in-cell deposition: each particle's quantity spread trilinearly
    over its 8 surrounding cell centers, divided by the cell volume (a mass
    deposits a density).  Returns a (nx, ny, nz) numpy array."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    positions = np.asarray(positions, dtype=np_dt)
    q = np.asarray(quantity, dtype=np_dt)
    left = np.asarray(left_edge, dtype=np_dt)
    right = np.asarray(right_edge, dtype=np_dt)
    dims = tuple(int(d) for d in dims)
    cell = (right - left) / np.asarray(dims, dtype=np_dt)
    vol = float(np.prod(cell))
    as_t = lambda a: torch.as_tensor(a).to(device)
    corners = torch.as_tensor(_CORNERS, dtype=torch.int64, device=device)
    grid = torch.zeros(math.prod(dims), dtype=dtype, device=device)
    left_t, cell_t = as_t(left), as_t(cell)
    n = len(positions)
    for s, e in _chunks(n, chunk):
        p, v = positions[s:e], q[s:e]
        if e - s < chunk and n > chunk:
            pad = chunk - (e - s)
            p = np.concatenate([p, np.full((pad, 3), left - 1e3, np_dt)])
            v = np.concatenate([v, np.zeros(pad, np_dt)])
        _cic_chunk(grid, as_t(p), as_t(v), left_t, cell_t, dims, corners)
    return grid.reshape(dims).cpu().numpy() / vol


def gen_dust_density(xgrid, nx: int, ny: int, nz: int,
                     snapshot_path: str = "latte10kpc_m12f_lsr2_corrected.npz",
                     method: str = "sph", device="cuda",
                     dtype=torch.float32) -> np.ndarray:
    """The reference's ``genDustDensity`` without yt: the latte-format npz
    snapshot's metal-weighted neutral-hydrogen density deposited onto the
    [-max|x|, max|x|]^3 box of ``xgrid`` in nx x ny x nz cells, by 'sph'
    (needs ``smoothlength``; else CIC) or 'cic' (the dust mass
    (m / rho) rho_dust per cell volume)."""
    with np.load(snapshot_path) as latte:
        snap = {k: latte[k] for k in latte.files}
    pos = np.column_stack([snap["x"], snap["y"], snap["z"]])
    dust_rho = metal_weighted_dust_density(snap)
    scales = np.max(np.abs(np.asarray(xgrid)), axis=0)
    left, right = -scales, scales
    kw = dict(device=device, dtype=dtype)
    if method == "sph" and "smoothlength" in snap:
        return sph_deposit(pos, dust_rho, snap["mass"], snap["density"],
                           snap["smoothlength"], left, right, (nx, ny, nz), **kw)
    m_dust = (np.asarray(snap["mass"], np.float64)
              / np.maximum(np.asarray(snap["density"], np.float64), 1e-300) * dust_rho)
    return cic_deposit(pos, m_dust, left, right, (nx, ny, nz), **kw)
