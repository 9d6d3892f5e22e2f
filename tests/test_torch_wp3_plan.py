"""Kernel B-6's cluster-resident FFT design (hipgp_tpu_torch/csrc/mxu3d.cu)
on the CPU: its plan, its tables, its gate and its arithmetic.

The kernel runs only on the card (tests/test_torch_cuda.py), and its
thread-block clusters cannot be emulated here.  So a numpy model of it,
pass by pass, with the radices and the float64 twiddle tables the wrapper
hands the kernel, is held against the plain version
`mxu3d.sandwich_wp3_plain` in float64: the packed minor-axis row pass and
its split by units of two items, each CTA's share of the half spectrum,
the per-column (j0, j1) slab with its pruned register-radix steps and the
in-slab real-basis weighting, the inverse steps, the crop, the row pass back
and the dots.  The gate's shared-memory reckoning, shapes and radices are
checked against the CUDA source's own.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu_torch.ops import bttb, mxu3d, solve

CL = mxu3d.WP3_CLUSTER
SRC = Path(mxu3d.__file__).resolve().parent.parent / "csrc" / "mxu3d.cu"
DUST = ((32, 64, 64), (64, 128, 128))
SMALL = [((8, 16, 16), (16, 32, 32)), ((5, 13, 9), (16, 32, 32)),
         ((16, 32, 32), (32, 64, 64)), ((27, 30, 61), (64, 64, 128))]


def _dft(R, sign):
    j = np.arange(R)
    return np.exp(sign * 2j * np.pi * np.outer(j, j) / R)


def _pos(k, L):
    """Position of frequency k after the forward steps: k = k1 + R1 k2 lies
    at k1 R2 + k2 (the digit-reversed order both steps leave in place)."""
    R1, R2 = mxu3d.wp3_radices(L)
    return (k % R1) * R2 + k // R1


def _fwd(v, L, nin):
    """The kernel's forward DFT of the last axis (nin <= L/2 values, the
    rest zero): step 1, the R1-point DFT over b of the positions a1 + R2 b
    with b < R1/2 only (the pruned half), into k1 at a1 + R2 k1; step 2, the
    block k1 times tw[a k1], the R2-point DFT over a into k2 at R2 k1 + k2."""
    R1, R2 = mxu3d.wp3_radices(L)
    tw = mxu3d._wp3_twiddles_np(L)
    assert nin <= L // 2
    x = np.zeros(v.shape[:-1] + (L // 2,), dtype=np.complex128)
    x[..., :nin] = v[..., :nin]
    x = x.reshape(v.shape[:-1] + (R1 // 2, R2))                  # [b, a1]
    y1 = np.einsum("...ba,bk->...ka", x, _dft(R1, -1)[: R1 // 2])  # [k1, a1]
    y1 = y1 * tw[np.outer(np.arange(R1), np.arange(R2))]
    y2 = np.einsum("...ka,aj->...kj", y1, _dft(R2, -1))             # [k1, k2]
    return y2.reshape(v.shape[:-1] + (L,))


def _inv(p, L, nout):
    """The inverse (e^+, unnormalised) from the position order: step A, the
    R2-point DFT over k2 of block k1 times conj tw[a k1]; step B, the
    R1-point DFT over k1 of the positions a + R2 k1, forming only b < R1/2
    (n = a + R2 b < L/2), cropped to nout."""
    R1, R2 = mxu3d.wp3_radices(L)
    tw = mxu3d._wp3_twiddles_np(L)
    assert nout <= L // 2
    y = p.reshape(p.shape[:-1] + (R1, R2))                          # [k1, k2]
    y = np.einsum("...kj,ja->...ka", y, _dft(R2, 1))                 # [k1, a]
    y = y * np.conj(tw[np.outer(np.arange(R1), np.arange(R2))])
    y = np.einsum("...ka,kb->...ba", y, _dft(R1, 1)[:, : R1 // 2])   # [b, a]
    return y.reshape(p.shape[:-1] + (L // 2,))[..., :nout]


def _row_units(L2):
    """The split's work units, as the kernel's row pass assigns them: unit
    u < R1/2 holds items u and R1 - u (unit 0: items 0 and R1/2), whose
    frequencies are closed under k -> L2 - k.  Per unit, its (column,
    position of Z_k, position of Z_{L2-k}) triples; column 0 carries bins 0
    and L2/2 (partners of themselves)."""
    R1, R2 = mxu3d.wp3_radices(L2)
    units = []
    for u in range(R1 // 2):
        items = (u, R1 - u) if u else (0, R1 // 2)
        out = []
        for k1 in items:
            for k2 in range(R2):
                k = k1 + R1 * k2
                if k > L2 // 2:
                    continue
                kr = (L2 - k) % L2
                # the partner's item and register, in the unit
                assert kr % R1 in items
                col = 0 if k in (0, L2 // 2) else k
                out.append((col, k1 * R2 + k2, _pos(kr, L2)))
        units.append(out)
    return units


def _model(x, w, dims, edims):
    """y and dots of the kernel's passes for a (B, d0, d1, d2) float64
    stack, every CTA of a cluster of CL in turn."""
    (d0, d1, d2), (W, L1, L2) = dims, edims
    C, CPC, N = L2 // 2, L2 // 2 // CL, L2 // 2
    P = -(-d0 // CL)
    wq = np.stack([w[:, :, :C], w[:, :, [N] + [L2 - c for c in range(1, C)]]], -1)
    wq = wq / (W * L1 * L2)                       # [k0, k1, c, (cos, sin)]
    units = _row_units(L2)
    ys, dots = [], []
    for xb in x:
        # 1. each CTA's rows, two real rows as one complex row, the forward
        # L2 steps, the split into the packed half spectrum S[r] (C, P d1)
        S = np.zeros((CL, C, P * d1), dtype=np.complex128)
        for r in range(CL):
            rows = xb[r * P:min(r * P + P, d0)].reshape(-1, d2)
            nr = rows.shape[0]
            if nr == 0:
                continue
            npr = -(-nr // 2)
            z = rows[:npr].astype(np.complex128)
            z[: nr - npr] += 1j * rows[npr:]
            Z = _fwd(z, L2, d2)
            for unit in units:
                for col, pk, pr in unit:
                    zk, zr = Z[:, pk], Z[:, pr]
                    if col == 0:
                        z0, zn = Z[:, _pos(0, L2)], Z[:, _pos(N, L2)]
                        a, b = z0.real + 1j * zn.real, z0.imag + 1j * zn.imag
                        if pk != _pos(0, L2):
                            continue            # bin L2/2: written with bin 0
                    else:
                        a, b = 0.5 * (zk + np.conj(zr)), -0.5j * (zk - np.conj(zr))
                    S[r, col, :npr] = a
                    S[r, col, npr:nr] = b[: nr - npr]
        # 2. each column c of CTA r: the slab gathered over the cluster, the
        # j1 then the j0 forward steps, the weighting, the inverse steps, the
        # slab scattered back in place
        for r in range(CL):
            for c in range(r * CPC, (r + 1) * CPC):
                U = np.stack([S[j0 // P, c, (j0 % P) * d1:(j0 % P + 1) * d1]
                              for j0 in range(d0)])
                V = _fwd(_fwd(U, L1, d1).T, W, d0).T      # [p0, p1]
                V = _weigh(V, wq[:, :, c], W, L1)
                U = _inv(_inv(V.T, W, d0).T, L1, d1)
                for j0 in range(d0):
                    S[j0 // P, c, (j0 % P) * d1:(j0 % P + 1) * d1] = U[j0]
        # 3. the row pass back: the complex row's spectrum from the two half
        # spectra, the inverse steps, the real part to one row, the imaginary
        # part to the other
        y = np.zeros((d0, d1, d2))
        for r in range(CL):
            lo, hi = r * P, min(r * P + P, d0)
            nr = (hi - lo) * d1
            if nr <= 0:
                continue
            npr = -(-nr // 2)
            rowsa = S[r][:, :npr]
            rowsb = np.zeros_like(rowsa)
            rowsb[:, : nr - npr] = S[r][:, npr:nr]
            zp = np.zeros((npr, L2), dtype=np.complex128)
            for k in range(L2):
                a, b = (_half(rowsa, k, L2), _half(rowsb, k, L2))
                zp[:, _pos(k, L2)] = a + 1j * b
            out = _inv(zp, L2, d2)
            rows = np.concatenate([out.real, out.imag[: nr - npr]])
            y[lo:hi] = rows.reshape(hi - lo, d1, d2)
        ys.append(y)
        dots.append(float(np.sum(xb * y)))
    return np.stack(ys), np.asarray(dots)


def _half(Sr, k, L2):
    """Frequency k of the rows' Hermitian spectrum from their packed half
    spectrum (C, rows): bins 0 and L2/2 are the real and imaginary parts of
    column 0, bins above L2/2 the conjugates of their mirrors."""
    N = L2 // 2
    if k == 0:
        return Sr[0].real
    if k == N:
        return Sr[0].imag
    return Sr[k] if k < N else np.conj(Sr[L2 - k])


def _weigh(V, wc, W, L1):
    """The kernel's in-slab weighting of one packed column's slab V (position
    order): per group (g0 <= W/2, g1 <= L1/2) the four mirror positions; the
    Hermitian partner (-k0, -k1) separates the minor axis's cosine and sine
    parts Rc, Rs; the mirror pair (k0, -k1) separates each part's cc, ss, sc,
    cs; each weighed by w at its real-basis index, then rebuilt.  Positions
    shared by two corners of a group (g0 in {0, W/2} or g1 in {0, L1/2}) get
    the same value from both."""
    g0, g1 = np.meshgrid(np.arange(W // 2 + 1), np.arange(L1 // 2 + 1), indexing="ij")
    k0m, k1m = (W - g0) % W, (L1 - g1) % L1
    p0, p0m, p1, p1m = _pos(g0, W), _pos(k0m, W), _pos(g1, L1), _pos(k1m, L1)
    v00, v01, v10, v11 = V[p0, p1], V[p0, p1m], V[p0m, p1], V[p0m, p1m]
    parts = ((0.5 * (v00 + np.conj(v11)), 0.5 * (v01 + np.conj(v10))),
             (0.5j * (v00 - np.conj(v11)), 0.5j * (v01 - np.conj(v10))))
    new = []
    for part, (R, Rm) in enumerate(parts):
        cc = 0.5 * (R.real + Rm.real) * wc[g0, g1, part]
        ss = 0.5 * (Rm.real - R.real) * wc[k0m, k1m, part]
        sc = -0.5 * (R.imag + Rm.imag) * wc[k0m, g1, part]
        cs = 0.5 * (Rm.imag - R.imag) * wc[g0, k1m, part]
        new.append(((cc - ss) - 1j * (sc + cs), (cc + ss) - 1j * (sc - cs)))
    (rc, rcm), (rs, rsm) = new
    out = V.copy()
    out[p0, p1] = rc - 1j * rs
    out[p0m, p1m] = np.conj(rc) - 1j * np.conj(rs)
    out[p0, p1m] = rcm - 1j * rsm
    out[p0m, p1] = np.conj(rcm) - 1j * np.conj(rsm)
    return out


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b))


def _check(dims, edims, w, B, seed):
    x = np.random.default_rng(seed).standard_normal((B,) + dims)
    y, dots = _model(x, w, dims, edims)
    yp, dp = mxu3d.sandwich_wp3_plain(torch.as_tensor(x), torch.as_tensor(w), dims,
                                      edims, selfdot=True)
    assert _rel(y, yp.numpy()) <= 1e-12
    assert _rel(dots, dp.numpy()) <= 1e-12


def _odd_weights(edims, seed):
    return np.random.default_rng(seed).uniform(0.1, 2.0, edims)


def _even_weights(edims, seed):
    w = _odd_weights(edims, seed)
    flip = w[np.ix_(*[(-np.arange(L)) % L for L in edims])]
    return 0.5 * (w + flip)


def test_model_matches_plain_at_the_dust_map_with_the_solver_spectrum():
    grids = [torch.linspace(-1.0, 1.0, m, dtype=torch.float64) for m in (64, 64, 32)]
    kf = lambda a, b: torch.exp(-0.5 * torch.sum(((a[:, None, :] - b[None, :, :]) / 0.07)
                                                 ** 2, -1))
    spec = bttb.make_spectrum(grids, kf, jitter=1e-3)
    _, _, pdims, pedims, wK = solve._mxu3d_permuted(
        spec, bttb._full_weights(spec.eigs, spec.edims[-1]))
    assert (pdims, pedims) == DUST and mxu3d._wp3_ok(pdims, pedims, torch.float32)
    _check(pdims, pedims, wK.numpy(), 1, 0)


def test_model_matches_plain_at_the_dust_map_with_weights_that_are_not_even():
    _check(*DUST, _odd_weights(DUST[1], 1), 1, 1)


@pytest.mark.parametrize("dims,edims", SMALL)
@pytest.mark.parametrize("even", [True, False])
def test_model_matches_plain_at_small_shapes(dims, edims, even):
    assert mxu3d._wp3_ok(dims, edims, torch.float32)
    w = (_even_weights if even else _odd_weights)(edims, 2)
    _check(dims, edims, w, 2, 3)


@pytest.mark.parametrize("L2", [16, 32, 64, 128])
def test_row_units_cover_each_packed_column_once(L2):
    R1, R2 = mxu3d.wp3_radices(L2)
    units = _row_units(L2)
    assert len(units) == R1 // 2
    cols = [c for unit in units for c, _, _ in unit]
    # column 0 twice (bins 0 and L2/2, one unit), every other once; each
    # unit forms R2 columns
    assert sorted(cols) == [0] + list(range(L2 // 2))
    assert all(len({c for c, _, _ in unit}) == R2 for unit in units)


def test_plan_and_tables():
    for L, (R1, R2) in mxu3d._WP3_RADICES.items():
        assert R1 * R2 == L and R1 >= R2 and R1 % 2 == 0 and R2 % 2 == 0
        # positions: a permutation of the frequencies
        assert sorted(_pos(np.arange(L), L)) == list(range(L))
        v = np.random.default_rng(L).standard_normal(L // 2) + 0j
        got = _fwd(v, L, L // 2)
        assert np.allclose(got[_pos(np.arange(L), L)], np.fft.fft(v, n=L), atol=1e-12)
        back = _inv(got, L, L // 2) / L
        assert np.allclose(back, v, atol=1e-12)
    t = mxu3d._wp3_tables((16, 32, 64), "cpu").numpy()
    want = np.concatenate([mxu3d._wp3_twiddles_np(L) for L in (16, 32, 64)])
    assert np.array_equal(t[0::2], want.real.astype(np.float32))
    assert np.array_equal(t[1::2], want.imag.astype(np.float32))


def _source_fn(name):
    src = SRC.read_text()
    m = re.search(r"\b" + name + r"\(([^)]*)\)\s*\{\s*return ([^;]*);", src)
    assert m, name
    args = [a.split()[-1] for a in m.group(1).split(",")]
    body = re.sub(r"\(size_t\)", "", m.group(2)).replace("/", "//")
    return args, body


def _eval(fn, **kw):
    args, body = _source_fn(fn)
    env = {a: kw[a] for a in args}
    env.update(CL=CL, col_stride=mxu3d._wp3_col_stride, row_stride=mxu3d._wp3_row_stride)
    return eval(body, {"__builtins__": {}}, env)


def test_gate_mirrors_the_source():
    src = SRC.read_text()
    shapes = re.search(r"#define WP3_FOR_EACH_SHAPE\(X\)(.*)", src).group(1)
    assert tuple(tuple(map(int, s)) for s in re.findall(
        r"X\((\d+), (\d+), (\d+)\)", shapes)) == mxu3d._WP3_SHAPES
    rad = {int(L): (int(a), int(b)) for L, a, b in re.findall(
        r"template <> struct Rad<(\d+)> \{ static constexpr int R1 = (\d+), R2 = (\d+); \};",
        src)}
    assert rad == mxu3d._WP3_RADICES
    assert f"constexpr int CL = {CL};" in src
    for rows in range(1, 600):
        assert _eval("col_stride", rows=rows) == mxu3d._wp3_col_stride(rows)
        assert mxu3d._wp3_col_stride(rows) % 16 == 2 and mxu3d._wp3_col_stride(rows) >= rows
    for L in mxu3d._WP3_RADICES:
        assert _eval("row_stride", L=L) == mxu3d._wp3_row_stride(L)
        assert mxu3d._wp3_row_stride(L) % 16 == 8
    for dims, edims in [DUST] + SMALL + [((64, 64, 64), (128, 128, 128))]:
        d0, d1 = dims[:2]
        W, L1, L2 = edims
        assert _eval("smem_bytes", d0=d0, d1=d1, W=W, L1=L1, L2=L2) == \
            mxu3d._wp3_smem_bytes(dims, edims)
    # the dust map's share: 128 KiB of half spectrum (+ the column pad), a
    # 64 x 136 slab buffer and 320 twiddles, one CTA per SM; (128, 128, 128)
    # does not fit
    assert mxu3d._wp3_smem_bytes(*DUST) == 8 * (64 * 258 + 64 * 136 + 320)
    assert not mxu3d._wp3_ok((64, 64, 64), (128, 128, 128), torch.float32)


def test_gate_refuses_what_the_kernel_does_not_take():
    assert mxu3d._wp3_ok(*DUST, torch.float32)
    assert not mxu3d._wp3_ok(*DUST, torch.float64)
    # data above half an axis (the pruned steps), an embedding not built
    assert not mxu3d._wp3_ok((33, 64, 64), (64, 128, 128), torch.float32)
    assert not mxu3d._wp3_ok((32, 64, 65), (64, 128, 128), torch.float32)
    assert not mxu3d._wp3_ok((32, 64, 64), (64, 128, 120), torch.float32)
    assert not mxu3d._wp3_ok((8, 8, 8), (15, 15, 15), torch.float32)
