"""Kernel B-5's plane-resident FFT design (hipgp_tpu_torch/csrc/sandwich_wp.cu)
on the CPU: its radix plan, its tables, its route choice and its arithmetic.

The kernel itself runs only on the card (tests/test_torch_cuda.py).  Here a
numpy model of it, pass by pass, with the plan, twiddles and position tables
the wrapper hands the kernel (the model below, on no path), is held against
NumPy's FFT for every {2,3,5}-smooth length up to 512 and against the plain
version `mxu2d.sandwich_wp_plain` in float64 at four crops, with the solver's
spectra and with weights that are not even; the route chooser is checked to
send the 3-D main path's planes to the resident kernel and large expanded
planes to kernel A's three passes.
"""
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu_torch.ops import bttb, mxu2d


def _smooth_lengths(limit):
    out = []
    for n in range(1, limit + 1):
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            out.append(n)
    return out


SMOOTH = _smooth_lengths(512)


def _dft_matrix(R, sign):
    j = np.arange(R)
    return np.exp(sign * 2j * np.pi * np.outer(j, j) / R)


def _stage_index(N, Lt, R):
    """The butterflies of one stage on blocks of Lt positions: (positions
    (nb, R), nl (nb,)) with position blk * Lt + nl + (Lt / R) * j."""
    S = Lt // R
    blk, nl = np.meshgrid(np.arange(N // Lt), np.arange(S), indexing="ij")
    base = (blk * Lt + nl).ravel()
    return base[:, None] + S * np.arange(R)[None, :], nl.ravel()


def _forward(v, N, radices, tw, nin):
    """The kernel's forward DFT of the last axis of v (nin values, zero
    beyond): decimation in frequency in place, each stage's output k times
    tw[nl * k * N / Lt]; the result in digit-reversed order."""
    buf = np.zeros(v.shape[:-1] + (N,), dtype=np.complex128)
    buf[..., :nin] = v[..., :nin]
    Lt = N
    for R in radices:
        idx, nl = _stage_index(N, Lt, R)
        out = buf[..., idx] @ _dft_matrix(R, -1.0)
        out *= tw[nl[:, None] * np.arange(R)[None, :] * (N // Lt)]
        buf[..., idx] = out
        Lt //= R
    return buf


def _inverse(buf, N, radices, tw, nout):
    """The kernel's inverse (unnormalised) DFT from digit-reversed order:
    the adjoint stages in reverse, each input j times conj
    tw[nl * j * N / Lt] before the butterfly; the first nout outputs."""
    buf = buf.copy()
    Lt = 1
    for R in reversed(radices):
        Lt *= R
        idx, nl = _stage_index(N, Lt, R)
        vals = buf[..., idx] * np.conj(tw[nl[:, None] * np.arange(R)[None, :] * (N // Lt)])
        buf[..., idx] = vals @ _dft_matrix(R, 1.0)
    return buf[..., :nout]


def _tables(L):
    tw, pos, _ = mxu2d._wp_table_np(L)
    return mxu2d.wp_fft_plan(L), tw, pos


def _wp_in_pass_order(x, w, o_shape):
    """Kernel B-5's resident route in float64 with its plan and tables:
    paired row DFTs and the split into half spectra (bins 0 and L1/2, both
    real, packed in column 0), the column DFT, the scale, the inverse column
    DFT, the paired inverse row DFT from the Hermitian mirror, read by
    position through the frequency table; returns (y, dots)."""
    B, W, i0, i1 = x.shape
    L0, L1 = w.shape[1:]
    o0, o1 = o_shape
    (r0, tw0, pos0), (r1, tw1, pos1) = _tables(L0), _tables(L1)
    C, nyq = (L1 + 1) // 2, L1 % 2 == 0
    # 1. rows: pair (r, r + npi) as one complex row
    npi = (i0 + 1) // 2
    z = x[:, :, :npi].astype(np.complex128)
    z[:, :, :i0 - npi] += 1j * x[:, :, npi:]
    Z = _forward(z, L1, r1, tw1, i1)
    k = np.arange(C)
    zk, zr = Z[..., pos1[k]], Z[..., pos1[(-k) % L1]]
    a, b = 0.5 * (zk + np.conj(zr)), (zk - np.conj(zr)) / 2j
    zn = Z[..., pos1[L1 // 2]] if nyq else 0.0 * zk[..., 0]
    a[..., 0] = zk[..., 0].real + 1j * zn.real
    b[..., 0] = zk[..., 0].imag + 1j * zn.imag
    S = np.zeros((B, W, max(i0, o0), C), dtype=np.complex128)
    S[:, :, :npi] = a
    S[:, :, npi:i0] = b[:, :, :i0 - npi]
    # 2. columns: forward, scale as the real basis applies w, inverse
    U = _forward(np.swapaxes(S[:, :, :i0], 2, 3), L0, r0, tw0, i0)     # (B, W, C, L0)
    kk = np.arange(L0 // 2 + 1)
    kr = (-kk) % L0
    p, q = pos0[kk], pos0[kr]
    u, v = U[..., p], U[..., q]
    k1 = np.arange(C)
    k1s = (-k1) % L1
    k1s[0] = L1 // 2 if nyq else 0      # column 0's imaginary part is bin L1/2
    g = lambda rows, cols: np.swapaxes(w[:, rows][:, :, cols], 1, 2)[None]   # (1, W, C, nk)
    scale = 1.0 / (L0 * L1)
    rc = 0.5 * (u + np.conj(v))
    rs = 0.5j * (u - np.conj(v))
    zc = (rc.real * g(kk, k1) + 1j * rc.imag * g(kr, k1)) * scale
    zs = (rs.real * g(kk, k1s) + 1j * rs.imag * g(kr, k1s)) * scale
    other = kr != kk
    U[..., q[other]] = (np.conj(zc) - 1j * np.conj(zs))[..., other]
    U[..., p] = zc - 1j * zs
    S[:, :, :o0] = np.swapaxes(_inverse(U, L0, r0, tw0, o0), 2, 3)
    # 3. rows back: pair (m, m + npo) as one complex row from the half spectra
    npo = (o0 + 1) // 2
    ya = S[:, :, :npo].copy()
    yb = np.zeros_like(ya)
    yb[:, :, :o0 - npo] = S[:, :, npo:o0]
    full = np.arange(L1)
    mirror = 2 * full > L1
    kk1 = np.where(mirror, L1 - full, full)
    a, c = ya[..., np.minimum(kk1, C - 1)], yb[..., np.minimum(kk1, C - 1)]
    a = np.where(mirror, np.conj(a), a)
    c = np.where(mirror, np.conj(c), c)
    for t, src in ((a, ya), (c, yb)):
        t[..., 0] = src[..., 0].real
        if nyq:
            t[..., L1 // 2] = src[..., 0].imag
    freq1 = mxu2d._wp_table_np(L1)[2]
    out = _inverse((a + 1j * c)[..., freq1], L1, r1, tw1, o1)
    y = np.zeros((B, W, o0, o1))
    y[:, :, :npo] = out.real
    y[:, :, npo:o0] = out.imag[:, :, :o0 - npo]
    dots = np.sum(x * y, axis=(1, 2, 3)) if (i0, i1) == tuple(o_shape) else None
    return y, dots


def _spectra(dims, W, ell=0.07):
    """W per-plane spectra of the solver's kind: SqExp at W length scales."""
    ws = []
    for q in range(W):
        grids = [torch.linspace(-1.0, 1.0, m, dtype=torch.float64) for m in dims]
        e = ell * (1.0 + 0.5 * q)
        kf = lambda a, b: torch.exp(
            -0.5 * torch.sum(((a[:, None, :] - b[None, :, :]) / e) ** 2, -1))
        spec = bttb.make_spectrum(grids, kf, jitter=1e-3)
        ws.append(bttb._full_weights(spec.eigs, spec.edims[-1]).numpy())
    return spec.edims, np.stack(ws)


def test_plan_covers_every_smooth_length():
    assert len(SMOOTH) == 68 and 125 in SMOOTH and 512 in SMOOTH
    for L in SMOOTH:
        rad = mxu2d.wp_fft_plan(L)
        assert int(np.prod(rad)) == L
        assert set(rad) <= {1, 2, 3, 4, 5, 8, 16} and len(rad) <= mxu2d._WP_MAX_STAGES
        assert (rad == (1,)) == (L == 1)
        if L % 2 == 0:
            assert rad[0] % 2 == 0      # the even radix leads
    for L in (7, 37, 1031, 3 ** 9):
        with pytest.raises(ValueError):
            mxu2d.wp_fft_plan(L)


@pytest.mark.parametrize("L", SMOOTH)
def test_fft_model_matches_numpy_at_every_smooth_length(L):
    # the forward stages leave frequency k at pos[k]; the inverse stages from
    # there give L * ifft; pruned to the first half of the inputs and outputs
    # too; float64 rounding of at most 6 stages, <= 1e-12 relative
    rad, tw, pos = _tables(L)
    assert sorted(pos) == list(range(L))
    rng = np.random.default_rng(L)
    v = rng.standard_normal((2, 3, L)) + 1j * rng.standard_normal((2, 3, L))
    for nin in {L, (L + 1) // 2}:
        got = _forward(v, L, rad, tw, nin)[..., pos]
        want = np.fft.fft(v[..., :nin], n=L)
        assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)
    spec = np.fft.fft(v)
    for nout in {L, (L + 1) // 2}:
        dr = np.zeros_like(spec)
        dr[..., pos] = spec
        got = _inverse(dr, L, rad, tw, nout)
        want = L * np.fft.ifft(spec)[..., :nout]
        assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)


def test_tables_are_float64_twiddles():
    for L in (1, 9, 128, 250, 512):
        tw, pos, freq = mxu2d._wp_table_np(L)
        assert tw.dtype == np.complex128
        assert np.allclose(tw, np.exp(-2j * np.pi * np.arange(L) / L), rtol=0, atol=1e-15)
        assert np.array_equal(pos[freq], np.arange(L))
        flat = mxu2d._wp_tables(L, "cpu")
        assert flat.dtype == torch.float32 and flat.shape == (4 * L,)
        assert torch.equal(flat[2 * L:3 * L], torch.as_tensor(pos, dtype=torch.float32))
        assert torch.equal(flat[3 * L:], torch.as_tensor(freq, dtype=torch.float32))


# (dims, embedded dims): a small pair, L0 odd and L1 = 2^4 * 5, data past
# half the axis and L1 = 4 * 3, the 3-D main path's (128, 128) planes and an axis of 250
PAIRS = [((12, 9), (24, 16)), ((63, 40), (125, 80)), ((5, 7), (8, 12)),
         ((64, 64), (128, 128)), ((125, 32), (250, 64))]


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "x".join(map(str, p[1])))
@pytest.mark.parametrize("crop", ["selfdot", "out_expanded", "in_expanded", "full"])
@pytest.mark.parametrize("weights", ["spectrum", "uneven"])
def test_model_in_pass_order_matches_plain(pair, crop, weights):
    # the kernel's arithmetic in float64 against the dense real-basis sandwich
    # of every plane, W = 2 planes with their own spectra, <= 1e-12 relative
    dims, edims = pair
    W = 2
    got_edims, w = _spectra(dims, W)
    assert tuple(got_edims) == edims
    if crop != "selfdot":
        w = np.sqrt(w)
    if weights == "uneven":
        w = np.random.default_rng(1).uniform(0.1, 2.0, (W,) + edims)
    in_exp = crop in ("in_expanded", "full")
    out_exp = crop in ("out_expanded", "full")
    i_shape, o_shape = mxu2d._crops(dims, edims, in_exp, out_exp)
    x = np.random.default_rng(sum(dims)).standard_normal((2, W) + i_shape)
    y, dots = _wp_in_pass_order(x, w, o_shape)
    tables = mxu2d._tables(dims, edims, in_exp, out_exp, torch.float64, "cpu")
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    if crop == "selfdot":
        yp, dp = mxu2d.sandwich_wp_plain(xt, wt, *tables[:4], selfdot=True)
        assert np.linalg.norm(dots - dp.numpy()) <= 1e-12 * np.linalg.norm(dp.numpy())
    else:
        yp = mxu2d.sandwich_wp_plain(xt, wt, *tables[:4])
    yp = yp.numpy()
    assert y.shape == yp.shape == (2, W) + o_shape
    assert np.linalg.norm(y - yp) <= 1e-12 * np.linalg.norm(yp)


@pytest.mark.parametrize("i_shape,o_shape", [((64, 64), (64, 64)), ((64, 64), (128, 128)),
                                             ((128, 128), (64, 64))],
                         ids=["selfdot", "R^T", "pullback"])
def test_route_sends_the_3d_main_path_to_the_resident_kernel(i_shape, o_shape):
    route, lay = mxu2d._wp_route(i_shape, (128, 128), o_shape)
    assert route == "resident"
    # what the kernel is given fits: each group's transforms times their odd
    # stride in the buffer, the buffer holds one transform, the shared
    # memory within a block's
    C, L = 64, 128
    npi, npo = (i_shape[0] + 1) // 2, (o_shape[0] + 1) // 2
    assert (lay["G"] | 1) * L <= lay["WB"] and 1 <= lay["G"] <= C
    assert (lay["RGi"] | 1) * L <= lay["WB"] and 1 <= lay["RGi"] <= npi
    assert (lay["RGo"] | 1) * L <= lay["WB"] and 1 <= lay["RGo"] <= npo
    assert lay["smem"] == mxu2d._wp_resident_smem(L, L, max(i_shape[0], o_shape[0]), C | 1,
                                                  lay["WB"])
    assert lay["smem"] <= mxu2d._SMEM_LIMIT - mxu2d._WP_STATIC_SMEM
    # the self-dot apply, 1 + 2k of each PCG solve: three blocks per SM
    if i_shape == o_shape:
        assert 3 * (lay["smem"] + mxu2d._WP_STATIC_SMEM + 1024) <= 228 * 1024


@pytest.mark.parametrize("i_shape,edims,o_shape,route", [
    ((256, 256), (256, 256), (256, 256), "three-pass"),
    ((128, 128), (256, 256), (256, 256), "three-pass"),
    ((256, 256), (256, 256), (128, 128), "three-pass"),
    ((512, 512), (512, 512), (512, 512), "three-pass"),
    ((128, 128), (256, 256), (128, 128), "resident"),
    ((125, 125), (250, 250), (125, 125), "resident"),
    ((12, 9), (24, 16), (24, 16), "resident"),
])
def test_route_is_chosen_by_shape(i_shape, edims, o_shape, route):
    # an expanded (256, 256) plane's half spectrum, 256 x 129 complex, is more
    # than a block's shared memory: kernel A's passes with a plane index
    assert mxu2d._wp_route(i_shape, edims, o_shape)[0] == route


def test_wp_launch_refuses_what_the_kernels_do_not_take():
    # refused before anything is built or launched
    x = torch.zeros((2, 3, 12, 9), dtype=torch.float32)
    w = torch.ones((3, 24, 16), dtype=torch.float32)
    with pytest.raises(TypeError):
        mxu2d._launch_wp(x.double(), w, (12, 9), selfdot=False)
    with pytest.raises(ValueError, match="contiguous"):
        mxu2d._launch_wp(x.transpose(2, 3).contiguous().transpose(2, 3), w, (12, 9),
                         selfdot=False)
    with pytest.raises(ValueError, match="self-dot"):
        mxu2d._launch_wp(x, w, (24, 16), selfdot=True)
    with pytest.raises(ValueError, match="smooth"):
        mxu2d._launch_wp(torch.zeros((2, 3, 7, 9)), torch.ones((3, 14, 16)), (7, 9),
                         selfdot=False)
