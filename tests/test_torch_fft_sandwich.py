"""Kernel A's FFT-structured design (hipgp_tpu_torch/csrc/sandwich_fft.cu) on
the CPU: its plan, its tables and its arithmetic.

The kernel itself runs only on the card (tests/test_torch_cuda.py).  Here the
plan's tables are applied with torch ops in the kernel's pass order (the
helper below, on no path) and held against the plain version
`mxu2d.sandwich_plain` in float64, with the solver's spectra and with
weights that are not even; the spectra the solver passes are checked to be
even in each axis, the condition under which the sandwich is a plain
circulant FFT apply; and B-8's refusal of tables the kernel does not read is
checked on CPU tensors.
"""
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu_torch.ops import bttb, mxu2d, pallas_transform

# (dims, embedded dims): a small pair, an odd length, the 2-D protocol's
# (250, 250) and the largest embedding kernel A takes
PAIRS = [((12, 9), (24, 16)), ((63, 40), (125, 80)), ((125, 125), (250, 250)),
         ((256, 256), (512, 512))]
CROPS = ["cropped", "out_expanded", "in_expanded", "full", "selfdot"]


def _smooth_lengths(limit):
    return [n for n in range(1, limit + 1)
            if n == 2 ** _val(n, 2) * 3 ** _val(n, 3) * 5 ** _val(n, 5)]


def _val(n, p):
    k = 0
    while n % p == 0:
        n //= p
        k += 1
    return k


def _pad8(n):
    return (n + 7) // 8 * 8


def _split(tab, a, b, inverse, swap):
    """(P, Q, tP, tQ, tw[n2, k1]) of the flat complex table, as the kernel's
    `make_split` and `load_tables` read it."""
    size = lambda P, Q: P * _pad8(P) + Q * _pad8(Q) + Q * _pad8(P)
    P, Q = (b, a) if swap else (a, b)
    base = inverse * (size(a, b) + size(b, a)) + (size(a, b) if swap else 0)
    blk = tab[base:base + size(P, Q)]
    tp = blk[:P * _pad8(P)].reshape(P, _pad8(P))
    tq = blk[P * _pad8(P):P * _pad8(P) + Q * _pad8(Q)].reshape(Q, _pad8(Q))
    tw = blk[P * _pad8(P) + Q * _pad8(Q):].reshape(Q, _pad8(P))
    # the padding is zero
    for t, n in ((tp, P), (tq, Q), (tw, P)):
        assert not bool(t[:, n:].abs().sum() if torch.is_tensor(t) else np.abs(t[:, n:]).sum())
    return P, Q, tp[:, :P], tq[:, :Q], tw[:, :P]


def _dft(v, tab, plan, inverse, swap, nout):
    """One length-L DFT of the last axis of v (its nin = v.shape[-1] entries,
    zero beyond) as the kernel's two steps, first nout outputs."""
    P, Q, tp, tq, tw = _split(tab, *plan, inverse, swap)
    x = torch.zeros(v.shape[:-1] + (P * Q,), dtype=torch.complex128)
    x[..., :v.shape[-1]] = v
    X = x.reshape(v.shape[:-1] + (P, Q))                       # [n1, n2]
    A = torch.einsum("...pq,kp->...kq", X, tp) * tw.T          # [k1, n2]
    Y = torch.einsum("...kq,jq->...kj", A, tq)                 # [k1, k2]
    return Y.transpose(-1, -2).reshape(v.shape[:-1] + (P * Q,))[..., :nout]


def _fft_sandwich_in_pass_order(x, w, o_shape):
    """Kernel A's arithmetic with its own plan, tables and orientations, in
    float64: row DFT, column DFT, scale, inverse column DFT, inverse real
    row DFT; returns (y, dots)."""
    B, i0, i1 = x.shape
    L0, L1 = w.shape
    o0, o1 = o_shape
    (a0, b0, a1, b1), swaps = mxu2d._fft_launch_plan((i0, i1), (L0, L1), o_shape)
    t0, t1 = (torch.as_tensor(mxu2d._fft_table_np(L)) for L in (L0, L1))
    H = L1 // 2 + 1
    s1 = _dft(x.to(torch.complex128), t1, (a1, b1), 0, swaps[0], H)      # (B, i0, H)
    u = _dft(s1.transpose(1, 2), t0, (a0, b0), 0, swaps[1], L0)        # (B, H, L0)
    # the scale: the cosine and sine parts of each column, frequency pairs
    # (k0, L0-k0) together, with w as the real basis applies it
    # (the real basis weighs the cosine of frequency f <= L/2 with w[f] and
    # its sine with w[L-f]: at index k, Re with w[fk] and Im with w[L-fk])
    k0 = torch.arange(L0)
    v = u[..., (-k0) % L0]
    rc, rs = 0.5 * (u + v.conj()), 0.5j * (u - v.conj())
    fk = torch.minimum(k0, L0 - k0)
    wre, wim = w[fk], w[(L0 - fk) % L0]
    k1s = (-torch.arange(H)) % L1
    zc = rc.real * wre[:, :H].T + 1j * rc.imag * wim[:, :H].T
    zs = rs.real * wre[:, k1s].T + 1j * rs.imag * wim[:, k1s].T
    z = (zc - 1j * zs) / (L0 * L1)
    s2 = _dft(z, t0, (a0, b0), 1, swaps[2], o0)                        # (B, H, o0)
    c = torch.full((H,), 2.0, dtype=torch.float64)
    c[0] = 1.0
    if L1 % 2 == 0:
        c[H - 1] = 1.0
    y = _dft(s2.transpose(1, 2) * c, t1, (a1, b1), 1, swaps[3], o1).real
    return y, (torch.sum(x * y, dim=(1, 2)) if (i0, i1) == tuple(o_shape) else None)


def _even_spectrum(dims, ell=0.07):
    grids = [torch.linspace(-1.0, 1.0, m, dtype=torch.float64) for m in dims]
    kf = lambda a, b: torch.exp(
        -0.5 * torch.sum(((a[:, None, :] - b[None, :, :]) / ell) ** 2, -1))
    spec = bttb.make_spectrum(grids, kf, jitter=1e-3)
    return spec, bttb._full_weights(spec.eigs, spec.edims[-1])


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_plan_covers_every_smooth_length():
    lengths = _smooth_lengths(512)
    assert len(lengths) == 68 and 125 in lengths and 512 in lengths
    for L in lengths:
        a, b = mxu2d.fft_plan(L)
        assert a * b == L and 1 <= a <= b <= 32
    for L in (37, 1031, 33 * 33):
        with pytest.raises(ValueError, match="no split"):
            mxu2d.fft_plan(L)


@pytest.mark.parametrize("L", [1, 2, 9, 16, 125, 250, 512])
def test_tables_are_the_dft_matrices(L):
    # each direction's and orientation's blocks: the P- and Q-point DFT
    # matrices and the twiddles, padded with zeros
    a, b = mxu2d.fft_plan(L)
    tab = mxu2d._fft_table_np(L)
    size = lambda P, Q: P * _pad8(P) + Q * _pad8(Q) + Q * _pad8(P)
    assert tab.shape == (2 * (size(a, b) + size(b, a)),)
    assert mxu2d._fft_tables(L, "cpu").shape == (tab.size, 2)
    for inverse, sign in ((0, -1.0), (1, 1.0)):
        for swap in (0, 1):
            P, Q, tp, tq, tw = _split(torch.as_tensor(tab), a, b, inverse, swap)
            assert (P, Q) == ((b, a) if swap else (a, b))
            for n, t in ((P, tp), (Q, tq)):
                r = np.arange(n)
                want = np.exp(sign * 2j * np.pi * np.outer(r, r) / n)
                assert np.allclose(t.numpy(), want, rtol=0, atol=1e-12)
            want = np.exp(sign * 2j * np.pi * np.outer(np.arange(Q), np.arange(P)) / L)
            assert np.allclose(tw.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "x".join(map(str, p[1])))
@pytest.mark.parametrize("crop", CROPS)
@pytest.mark.parametrize("weights", ["spectrum", "uneven"])
def test_tables_in_pass_order_match_plain(pair, crop, weights):
    # the kernel's arithmetic in float64 against the dense real-basis
    # sandwich, with the solver's spectrum and with weights that are not even
    # in either axis: float64 rounding of sums of at most 2 * 32 terms per
    # step, <= 1e-12 relative
    dims, edims = pair
    spec, w = _even_spectrum(dims)
    assert spec.edims == edims
    if crop == "out_expanded":
        w = torch.sqrt(w)
    if weights == "uneven":
        w = torch.as_tensor(np.random.default_rng(1).uniform(0.1, 2.0, edims))
    in_exp = crop in ("in_expanded", "full")
    out_exp = crop in ("out_expanded", "full")
    i_shape, o_shape = mxu2d._crops(dims, edims, in_exp, out_exp)
    x = torch.as_tensor(np.random.default_rng(sum(dims)).standard_normal((2,) + i_shape))
    y, dots = _fft_sandwich_in_pass_order(x, w, o_shape)
    tables = mxu2d._tables(dims, edims, in_exp, out_exp, torch.float64, "cpu")
    yp, dp = mxu2d.sandwich_plain(x, w, *tables[:4], selfdot=True) if crop == "selfdot" \
        else (mxu2d.sandwich_plain(x, w, *tables[:4]), None)
    assert y.shape == yp.shape == (2,) + o_shape
    assert _rel(y, yp) <= 1e-12
    if crop == "selfdot":
        assert _rel(dots, dp) <= 1e-12


@pytest.mark.parametrize("dims", [p[0] for p in PAIRS], ids=str)
def test_solver_spectra_are_even_in_each_axis(dims):
    # w[k0, k1] = w[L0-k0, k1] = w[k0, L1-k1] for wK (make_spectrum's full
    # weights) and so for 1/wK and sqrt(wK), up to the float64 rounding of
    # the FFT that builds the spectrum: for these the sandwich is the
    # circulant apply crop(irfft2(w[:, :L1/2+1] * rfft2(pad(x)))), the
    # torch.fft yardstick chip_smoke.py times (kernel A applies the odd parts
    # too, so it does not need this)
    spec, w = _even_spectrum(dims)
    L0, L1 = spec.edims
    r0, r1 = (-torch.arange(L0)) % L0, (-torch.arange(L1)) % L1
    scale = float(w.abs().max())
    assert float((w - w[r0]).abs().max()) <= 1e-13 * scale
    assert float((w - w[:, r1]).abs().max()) <= 1e-13 * scale


def test_orientation_takes_the_cheaper_split():
    # (P, Q) = (25, 10) for the cropped forward column DFT at 250: step 1
    # 25 * 125, step 2 10 * 250 complex multiply-adds, against 10 * 125 +
    # 25 * 250 for (10, 25); back to the crop the other way round
    assert mxu2d.fft_plan(250) == (10, 25)
    assert mxu2d._fft_orient((10, 25), 125, 250) == 1
    assert mxu2d._fft_orient((10, 25), 250, 125) == 0
    assert mxu2d._fft_orient((10, 25), 250, 250) == 0


def test_fft_launch_refuses_what_the_kernel_does_not_take():
    # refused before anything is built or launched
    x = torch.zeros((2, 12, 9), dtype=torch.float32)
    w = torch.ones((24, 16), dtype=torch.float32)
    with pytest.raises(TypeError):
        mxu2d._launch_fft(x.double(), w, (12, 9), selfdot=False)
    with pytest.raises(ValueError, match="contiguous"):
        mxu2d._launch_fft(x.transpose(1, 2).contiguous().transpose(1, 2), w, (12, 9),
                          selfdot=False)
    with pytest.raises(ValueError, match="self-dot"):
        mxu2d._launch_fft(x, w, (24, 16), selfdot=True)
    with pytest.raises(ValueError, match="no split"):
        mxu2d._launch_fft(torch.zeros((2, 37, 9)), torch.ones((74, 16)), (37, 9),
                          selfdot=False)


def test_b8_refuses_tables_that_are_not_the_cached_basis():
    # the kernel never reads Q0 and Q1, so on the card it takes only the
    # cached real Fourier bases (what bttb._apply_spectrum_matmul passes)
    x = torch.zeros((2, 24, 16), dtype=torch.float32)
    Q0 = bttb._real_fourier_basis(24, torch.float32, x.device)
    Q1 = bttb._real_fourier_basis(16, torch.float32, x.device)
    pallas_transform._check_basis(Q0, Q1, x)
    with pytest.raises(ValueError, match="cached real Fourier basis"):
        pallas_transform._check_basis(Q0.clone(), Q1, x)
    with pytest.raises(ValueError, match="as Q1"):
        pallas_transform._check_basis(Q0, torch.eye(16), x)
    with pytest.raises(ValueError, match="cached real Fourier basis"):
        pallas_transform._check_basis(Q0, Q1, x.double())
