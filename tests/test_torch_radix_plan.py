"""The register-radix design of the radix kernels (hipgp_tpu_torch/csrc/radix.cu:
B-2/B-3 stage 1, B-4 middle, B-7 dual middle) on the CPU.

The kernels run only on the card (tests/test_torch_cuda.py).  Here a numpy
model of each, step by step, with the radices, digit orders and float64
tables the wrappers hand the kernels (`radix_fft._S1_RADICES`,
`_MID_RADICES`, `_kernel_table_np`; the model below is on no path), is held
in float64 against NumPy's FFT and against the plain versions
(`stage1_plain`, `stage1_inv_dot_plain`, `middle_plain`, `middle_dual_plain`)
at every plan of the card tests' lengths, at the 1-D main path's crops, at
8 rows and at an odd crop at A = 2048, with the solver's three diagonals and
with a diagonal that is not even.  The middle's shared-memory layout is
checked too: each phase's half-warp accesses hit distinct bank pairs.  The
weight cotangent (``radix_middle_wgrad``, a two-CTA cluster) is modelled the
same way: its two CTAs' product items, the stage-order index each writes,
and the sum over v in the kernel's order (the split's run of v, the splits
in order) against `middle_wgrad_plain`; its cluster size, split rule and
shared memory are held to the source.
The radices are the kernels' own: the dicts are held here to the plan
specialisations of the CUDA source (`S1Plan`, `MidPlan`, `MC1`/`MC2`), and on
the card the wrapper holds them to the built kernels' `radix_plan` before
its first launch at a plan.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu_torch.experiments.run_pcg_vs_cholesky import (protocol_problem,
                                                             protocol_spectrum)
from hipgp_tpu_torch.kernels import kernel_from_name
from hipgp_tpu_torch.ops import radix_fft, solve

RADIX_LENGTHS = [8192, 32768, 1 << 18, 1 << 20, 1 << 21, 1 << 22, 1 << 25]
MAIN_PATH_CROPS = [(1 << 18, 8), (1 << 20, 31), (1 << 21, 64)]
MC, MC1, MC2 = 128, 16, 8
MS = MC + MC // 16 + 1   # the middle's row stride in shared memory (complex)


def _einsum(spec, *ops):
    return np.einsum(spec, *ops, optimize=True)


def _F(R, sign):
    """[n, k] = exp(sign 2 pi i n k / R): v @ _F(R, sign) is the R-point DFT."""
    j = np.arange(R)
    return np.exp(sign * 2j * np.pi * np.outer(j, j) / R)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b))


def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# ---------------------------------------------------------------------------
# Stage 1 (B-2, B-3)
# ---------------------------------------------------------------------------

def _stage1_model(x, A, in_rows, out_rows, sign, twA):
    """The kernel's A-point DFT over axis 1 of x (V, in_rows, N): in-place
    register steps of `_S1_RADICES[A]`; rows >= in_rows never read (nor,
    where in_rows <= A/2 on the forward, the first step's upper half); only
    the kept frequencies of the last step formed.  Returns (V, out_rows, N)
    and checks that every output row is formed exactly once."""
    radices = radix_fft._S1_RADICES[A]
    V, _, N = x.shape
    tw = twA if sign < 0 else np.conj(twA)
    ar = np.arange
    R1 = radices[0]
    # step 1: item a1 < A / R1 over the rows a1 + (A / R1) b
    s1 = A // R1
    rows = ar(s1)[:, None] + s1 * ar(R1)[None, :]
    keep = rows < in_rows
    if sign < 0 and 2 * in_rows <= A:
        assert not np.any(rows[:, R1 // 2:] < in_rows)   # the skipped half is zero
        keep &= ar(R1)[None, :] < R1 // 2
    vals = np.where(keep[None, :, :, None], x[:, np.minimum(rows, in_rows - 1)], 0.0)
    out = _einsum("visn,sk->vikn", vals, _F(R1, sign))
    if len(radices) == 1:
        freqs, res = rows, out              # a1 = 0: register k holds frequency k
    else:
        buf = np.zeros((V, A, N), dtype=complex)
        buf[:, rows] = out
        if len(radices) == 3:
            R2 = radices[1]
            n2 = A // R1
            m2 = n2 // R2
            k1, a2 = np.meshgrid(ar(R1), ar(m2), indexing="ij")
            loc = a2.ravel()[:, None] + m2 * ar(R2)[None, :]
            pos = k1.ravel()[:, None] * n2 + loc
            vals = buf[:, pos] * tw[(loc * k1.ravel()[:, None]) % A][None, :, :, None]
            buf[:, pos] = _einsum("visn,sk->vikn", vals, _F(R2, sign))
        RL = radices[-1]
        blk = ar(A // RL)
        if len(radices) == 2:
            pre, twk = blk, blk
        else:
            R2 = radices[1]
            pre, twk = blk // R2 + R1 * (blk % R2), (blk % R2) * R1
        pos = blk[:, None] * RL + ar(RL)[None, :]
        vals = buf[:, pos] * tw[(ar(RL)[None, :] * twk[:, None]) % A][None, :, :, None]
        res = _einsum("visn,sk->vikn", vals, _F(RL, sign))
        freqs = pre[:, None] + (A // RL) * ar(RL)[None, :]
    RL = radices[-1]
    kept = RL // 2 if sign > 0 and 2 * out_rows <= A else RL
    y = np.zeros((V, out_rows, N), dtype=complex)
    formed = np.zeros(out_rows, dtype=int)
    for r in range(kept):
        f = freqs[:, r]
        ok = f < out_rows
        y[:, f[ok]] = res[:, ok, r]
        np.add.at(formed, f[ok], 1)
    assert np.all(formed == 1)
    return y


def _stage1_tables(A):
    return radix_fft._kernel_table_np({8: 8192, 16: 1 << 18, 32: 1 << 19, 64: 1 << 20,
                                       128: 1 << 21, 256: 1 << 22, 512: 1 << 23,
                                       1024: 1 << 24, 2048: 1 << 25}[A])["twA"]


def test_plans_cover_every_length():
    for A, radices in radix_fft._S1_RADICES.items():
        assert int(np.prod(radices)) == A and max(radices) <= 16
        assert list(radices) == sorted(radices, reverse=True)
    for B, (r1, r2) in radix_fft._MID_RADICES.items():
        assert r1 * r2 == B and r1 <= 16 and r2 <= 8
    for L in RADIX_LENGTHS + [1 << 14, 1 << 16, 1 << 17, 1 << 19, 1 << 23, 1 << 24]:
        A, B, C = radix_fft._factorize(L)
        assert A in radix_fft._S1_RADICES and B in radix_fft._MID_RADICES and C == MC
        r1, r2 = radix_fft._MID_RADICES[B]
        tab = radix_fft._kernel_table_np(L)
        sizes = [t.size for t in tab.values()]
        assert sizes == [A, MC1 * MC2, B, r1 * C, r2 * C, A * B, A * C]


def test_radices_are_the_kernel_sources_plans():
    # the numbers in the template specialisations of csrc/radix.cu, read as
    # text: a radix changed, or two swapped, on one side only fails here
    src = (Path(radix_fft.__file__).resolve().parent.parent / "csrc" / "radix.cu").read_text()
    spec = r"template <> struct {}<(\d+)>\s*\{{\s*static constexpr int ([^;]*);"
    fields = lambda body: dict((k.strip(), int(v)) for k, v in
                               (f.split("=") for f in body.split(",")))
    s1 = {int(n): fields(b) for n, b in re.findall(spec.format("S1Plan"), src)}
    mid = {int(n): fields(b) for n, b in re.findall(spec.format("MidPlan"), src)}
    assert {A: tuple(r for r in (f["R1"], f["R2"], f["R3"]) if r > 1)
            for A, f in s1.items()} == radix_fft._S1_RADICES
    assert {B: (f["R1"], f["R2"]) for B, f in mid.items()} == radix_fft._MID_RADICES
    mc = re.search(r"constexpr int MC1 = (\d+), MC2 = (\d+);", src)
    assert (int(mc.group(1)), int(mc.group(2))) == (radix_fft._MC1, radix_fft._MC2) \
        == (MC1, MC2)


def test_tables_are_float64_twiddles():
    L = 1 << 21
    A, B, C = radix_fft._factorize(L)
    tab = radix_fft._kernel_table_np(L)
    r1, r2 = radix_fft._MID_RADICES[B]
    assert all(t.dtype == np.complex128 for t in tab.values())
    # T1 = t1r[ka, b] t1c[ka, c], T2[k1 + r1 k2, c] = base[k1, c] fac[k2, c]
    ka, b, c = 77, 101, 93
    t1 = np.exp(-2j * np.pi * ka * (b * C + c) / L)
    assert abs(tab["t1r"][ka, b] * tab["t1c"][ka, c] - t1) < 1e-14
    k1, k2 = 5, 6
    t2 = np.exp(-2j * np.pi * (k1 + r1 * k2) * c / (B * C))
    assert abs(tab["base"][k1, c] * tab["fac"][k2, c] - t2) < 1e-14
    flat = radix_fft._kernel_table(L, torch.device("cpu"))
    assert flat.dtype == torch.float32
    assert flat.numel() == 2 * sum(t.size for t in tab.values())


@pytest.mark.parametrize("A", sorted(radix_fft._S1_RADICES))
def test_stage1_model_matches_numpy(A):
    rng = np.random.default_rng(A)
    x = _crandn(rng, 2, A, 8)
    twA = _stage1_tables(A)
    assert _rel(_stage1_model(x, A, A, A, -1, twA), np.fft.fft(x, axis=1)) < 1e-13
    assert _rel(_stage1_model(x, A, A, A, 1, twA), A * np.fft.ifft(x, axis=1)) < 1e-13
    for rows in (A // 2, A // 2 + 1, 1):
        want = np.fft.fft(x[:, :rows], n=A, axis=1)
        assert _rel(_stage1_model(x[:, :rows], A, rows, A, -1, twA), want) < 1e-13
        want = A * np.fft.ifft(x, axis=1)[:, :rows]
        assert _rel(_stage1_model(x, A, A, rows, 1, twA), want) < 1e-13


def _s1_cases(L):
    A = radix_fft._factorize(L)[0]
    crops = {A, A // 2, A // 2 + 1, min(8, A)}
    crops |= {r for (l, r) in MAIN_PATH_CROPS if l == L}
    if A == 2048:
        crops.add(1001)
    return A, sorted(crops)


@pytest.mark.parametrize("L", RADIX_LENGTHS)
def test_stage1_model_matches_plain(L):
    # the forward from each crop of rows, the inverse and the inverse with
    # self-dots to each crop, against the plain dense-table versions in f64
    # (a column subset: the columns are independent)
    A, crops = _s1_cases(L)
    p64 = radix_fft.make_plan(L, torch.float64)
    twA = radix_fft._kernel_table_np(L)["twA"]
    rng = np.random.default_rng(L % 1000)
    N = 16
    z = _crandn(rng, 2, A, N)
    for rows in crops:
        x = _crandn(rng, 2, rows, N)
        got = _stage1_model(x, A, rows, A, -1, twA)
        wr, wi = radix_fft._s1_tables(p64, rows, A, False)
        want = radix_fft.stage1_plain(torch.as_tensor(x.real), torch.as_tensor(x.imag), wr, wi)
        assert _rel(got, want[0].numpy() + 1j * want[1].numpy()) < 1e-12
        u = _crandn(rng, 2, rows, N)
        got = _stage1_model(z, A, A, rows, 1, twA)
        wr, wi = radix_fft._s1_tables(p64, A, rows, True)
        want = radix_fft.stage1_inv_dot_plain(
            torch.as_tensor(z.real), torch.as_tensor(z.imag), torch.as_tensor(u.real),
            torch.as_tensor(u.imag), wr, wi)
        assert _rel(got, want[0].numpy() + 1j * want[1].numpy()) < 1e-12
        dr = np.sum(u.real * got.real, axis=(1, 2))
        di = np.sum(u.imag * got.imag, axis=(1, 2))
        scale = np.sqrt(np.sum((u.real * got.real) ** 2, axis=(1, 2)))
        assert np.max(np.abs(dr - want[2].numpy()) / scale) < 1e-12
        assert np.max(np.abs(di - want[3].numpy()) / scale) < 1e-12


# ---------------------------------------------------------------------------
# The middle (B-4, B-7)
# ---------------------------------------------------------------------------

def _middle_forward_model(y, kas, L):
    """Phases 1-3 of the kernel on planes y (V, len(kas), B, C) complex:
    returns the plane state after phase 3.  A position split into digits is
    a reshape: row a1 + R2 b is [b, a1] of (R1, R2), position a + 8 m of a
    row is [m, a] of (16, 8)."""
    A, B, C = radix_fft._factorize(L)
    R1, R2 = radix_fft._MID_RADICES[B]
    t = radix_fft._kernel_table_np(L)
    V, K = y.shape[:2]
    t1r, t1c = t["t1r"][kas], t["t1c"][kas]           # (K, B), (K, C)
    # phase 1: items (c, a1), rows a1 + R2 b times T1's row factor, DFT over b
    # into k1 at rows a1 + R2 k1
    v = y.reshape(V, K, R1, R2, C) * t1r.reshape(K, R1, R2)[None, :, :, :, None]
    s = _einsum("vkbac,bj->vkjac", v, _F(R1, -1)).reshape(V, K, B, C)
    if R2 == 1:   # one step: row kb holds kb, then T2 and T1's column factor
        s = s * t["base"][None, None] * t1c[None, :, None, :]
    else:
        # phase 2: items (c, k1), rows k1 R2 + a times W_B^{a k1}, DFT over a
        # into k2 at rows k1 R2 + k2 (kb = k1 + R1 k2), times T2, T1's column
        twb = t["twB"][np.outer(np.arange(R1), np.arange(R2))]
        v = s.reshape(V, K, R1, R2, C) * twb[None, None, :, :, None]
        t2 = t["base"][:, None, :] * t["fac"][None, :, :]   # (R1, R2, C)
        s = (_einsum("vkjac,an->vkjnc", v, _F(R2, -1)) * t2[None, None]
             * t1c[None, :, None, None, :]).reshape(V, K, B, C)
    # phase 3: positions a + 8 m, DFT over m into k1 at a + 8 k1
    return _einsum("vkrma,mj->vkrja", s.reshape(V, K, B, MC1, MC2),
                   _F(MC1, -1)).reshape(V, K, B, C)


def _middle_inverse_model(s, dk, kas, L):
    """Phases 4-7 on the phase-3 state with dk = d[kas], the planes' part of
    the stage-order diagonal d (A, B, C): returns z (V, len(kas), B, C)."""
    A, B, C = radix_fft._factorize(L)
    R1, R2 = radix_fft._MID_RADICES[B]
    t = radix_fft._kernel_table_np(L)
    V, K = s.shape[:2]
    t1r, t1c = t["t1r"][kas], t["t1c"][kas]
    # phase 4: positions 8 k1 + a ([k1, a]) times W_C^{a k1}, DFT over a into
    # k2 (kc = k1 + 16 k2), times d[kb(row), kc], the inverse DFT, times conj
    tw4 = t["tw4"].T                                    # [k1, a]
    spec = _einsum("vkrja,an->vkrjn", s.reshape(V, K, B, MC1, MC2) * tw4, _F(MC2, -1))
    row = np.arange(B)
    kb = row // R2 + R1 * (row % R2)
    dk = dk[:, kb].reshape(K, B, MC2, MC1).transpose(0, 1, 3, 2)   # [k1, k2]
    back = _einsum("vkrjn,na->vkrja", spec * dk[None], _F(MC2, 1)) * np.conj(tw4)
    # phase 5: positions a + 8 k1 ([k1, a]), inverse DFT over k1 into c = a + 8 m
    s = _einsum("vkrja,jm->vkrma", back, _F(MC1, 1)).reshape(V, K, B, C)
    if R2 == 1:
        s = s * np.conj(t["base"][None, None] * t1c[None, :, None, :])
    else:
        # phase 6: rows k1 R2 + k2 times conj T2 and conj T1's column factor,
        # inverse DFT over k2 into a, times conj W_B^{a k1}
        t2 = t["base"][:, None, :] * t["fac"][None, :, :]
        v = s.reshape(V, K, R1, R2, C) * np.conj(t2[None, None] * t1c[None, :, None, None, :])
        twb = t["twB"][np.outer(np.arange(R1), np.arange(R2))]
        s = (_einsum("vkjnc,na->vkjac", v, _F(R2, 1))
             * np.conj(twb)[None, None, :, :, None]).reshape(V, K, B, C)
    # phase 7: rows a1 + R2 k1 ([k1, a1]), inverse DFT over k1 into
    # b = a1 + R2 m, times conj T1's row factor
    z = _einsum("vkjac,jm->vkmac", s.reshape(V, K, R1, R2, C), _F(R1, 1)).reshape(V, K, B, C)
    return z * np.conj(t1r)[None, :, :, None]


def _middle_chain(y, dk, kas, L):
    """The middle's function by NumPy's FFT: per plane ka, conj(T1) times the
    B*C-point inverse DFT of d' times the DFT of T1 y, d'[kb + B kc] =
    d[ka, kb, kc] (dk = d[kas])."""
    A, B, C = radix_fft._factorize(L)
    V, K = y.shape[:2]
    n = np.arange(B * C)
    t1 = np.exp(-2j * np.pi * ((np.asarray(kas)[:, None] * n) % L) / L)
    dp = dk.transpose(0, 2, 1).reshape(K, B * C)
    f = np.fft.fft(t1 * y.reshape(V, K, B * C), axis=-1)
    return (np.conj(t1) * B * C * np.fft.ifft(dp * f, axis=-1)).reshape(y.shape)


def _plain_planes(y, dk, kas, L):
    """`middle_plain`'s own chain (`_middle_forward`, `_middle_inverse` on its
    float64 tables) on the planes kas."""
    t1, t2, wb, wc = radix_fft._middle_tables(L, torch.float64, torch.device("cpu"))
    f = radix_fft._middle_forward(torch.as_tensor(y), t1[kas], t2, wb, wc)
    zr, zi = radix_fft._middle_inverse(f * torch.as_tensor(dk), t1[kas], t2, wb, wc)
    return zr.numpy() + 1j * zi.numpy()


def _diag(L, rng, even=True):
    d = 0.5 + rng.random(L)
    if even:
        d = 0.5 * (d + np.concatenate([d[:1], d[1:][::-1]]))
    p64 = radix_fft.make_plan(L, torch.float64)
    return radix_fft.permute_weights(torch.as_tensor(d), p64).numpy()


@pytest.mark.parametrize("L", RADIX_LENGTHS)
def test_middle_model_matches_plain(L):
    # an even and an uneven diagonal; every plane against middle_plain where
    # A <= 16, else eight planes (both ends, the middle) against middle_plain's
    # chain on them (to 2^22; its T1 table at 2^25 would take 0.5 GB) and
    # against NumPy's FFT chain
    A, B, C = radix_fft._factorize(L)
    rng = np.random.default_rng(L % 997)
    kas = (list(range(A)) if A <= 16
           else [0, 1, 5, A // 2 - 1, A // 2, A // 2 + 1, A - 2, A - 1])
    y = _crandn(rng, 1, len(kas), B, C)
    state = _middle_forward_model(y, kas, L)
    for even in (True, False):
        if L <= 1 << 21:
            dk = _diag(L, rng, even)[kas]
        else:   # the sampled planes' part of a diagonal (uneven at 2^22 and 2^25)
            dk = 0.5 + rng.random((len(kas), B, C))
        got = _middle_inverse_model(state, dk, kas, L)
        assert _rel(got, _middle_chain(y, dk, kas, L)) < 1e-12
        if len(kas) == A:
            plan = radix_fft.make_plan(L, torch.float64)
            want = radix_fft.middle_plain(torch.as_tensor(y.real), torch.as_tensor(y.imag),
                                          torch.as_tensor(dk), plan)
            assert _rel(got, want[0].numpy() + 1j * want[1].numpy()) < 1e-12
        elif L <= 1 << 22:
            assert _rel(got, _plain_planes(y, dk, kas, L)) < 1e-12


def test_middle_model_with_the_solver_diagonals():
    # the planes solver's three diagonals (K, C^-1, R^T) at M = 131 072 and
    # the dual middle (one forward half, two inverse halves) on the first two
    M = 131_072
    grid, kfun = protocol_problem(kernel_from_name("Mat52"), M, torch.float64, "cpu")
    spec = protocol_spectrum(grid, kfun)
    L = spec.edims[0]
    plan = radix_fft.make_plan(L, torch.float64)
    w = solve._planes_weights(spec, plan)
    diags = [w / L, 1.0 / (w * L), torch.sqrt(w) / L]
    A = plan.A
    rng = np.random.default_rng(5)
    kas = list(range(A))
    y = _crandn(rng, 1, A, plan.B, plan.C)
    yr, yi = torch.as_tensor(y.real), torch.as_tensor(y.imag)
    state = _middle_forward_model(y, kas, L)
    for dt in diags:
        got = _middle_inverse_model(state, dt.numpy(), kas, L)
        want = radix_fft.middle_plain(yr, yi, dt, plan)
        assert _rel(got, want[0].numpy() + 1j * want[1].numpy()) < 1e-12
    want = radix_fft.middle_dual_plain(yr, yi, diags[0], diags[1], plan)
    for k, dt in enumerate(diags[:2]):
        got = _middle_inverse_model(state, dt.numpy(), kas, L)
        assert _rel(got, want[2 * k].numpy() + 1j * want[2 * k + 1].numpy()) < 1e-12


def _phys(p):
    return p + (p >> 4)


@pytest.mark.parametrize("B", [16, 32, 64, 128])
def test_middle_shared_memory_layout_has_no_bank_conflicts(B):
    # a half-warp's 64-bit accesses (16 lanes) hit 16 distinct bank pairs in
    # every phase: columns (lanes along c), rows (lanes along rows, the odd
    # row stride) and phase 4 (lanes along k1, the pad after every 16)
    R1, R2 = radix_fft._MID_RADICES[B]
    NT = min(512, B * MC // 16)
    assert sorted({r * MS + _phys(p) for r in range(B) for p in range(MC)}) == sorted(
        set(r * MS + _phys(p) for r in range(B) for p in range(MC)))
    assert len({r * MS + _phys(p) for r in range(B) for p in range(MC)}) == B * MC
    assert B * MS * 8 <= 232448

    def pairs(addrs):   # a float2 at complex index i takes banks 2i, 2i+1
        return len({a % 16 for a in addrs})

    for half in range(NT // 16):
        lanes = range(16 * half, 16 * half + 16)
        # phases 1, 2, 6, 7: q -> (c = q % 128, j = q / 128), one row per step
        cols = [q % MC for q in lanes]
        assert pairs(7 * MS + _phys(c) for c in cols) == 16
        # phases 3, 5: q -> (row = q % B, a = q / B), position a + 8 m
        for m in range(MC1):
            addrs = [(q % B) * MS + _phys(q // B + MC2 * m) for q in lanes]
            assert pairs(addrs) == 16
        # phase 4: q -> (k1 = q % 16, row = q / 16), position 8 k1 + a
        for a in range(MC2):
            addrs = [(q // MC1) * MS + _phys(MC2 * (q % MC1) + a) for q in lanes]
            assert pairs(addrs) == 16


# ---------------------------------------------------------------------------
# B-4's weight cotangent (radix_middle_wgrad): a two-CTA cluster a (ka, split)
# ---------------------------------------------------------------------------

SMS = 132   # the H100's streaming multiprocessors
WGRAD_CASES = [8192, 1 << 14, 32768, 1 << 16, 1 << 17, 1 << 21]   # B = 8 ... 128; the headline


def _wgrad_items(B):
    """The product's items of the kernel, per (rank, thread q, item i):
    (row of the plane, kc it writes, position it reads in the row); thread
    q's i-th item is j = q + i NT of its rank's half of the rows."""
    NT = min(512, B * MC // 16)
    PER = B // 2 * MC // NT
    assert PER * NT * 2 == B * MC
    rank, q, i = np.meshgrid(np.arange(2), np.arange(NT), np.arange(PER), indexing="ij")
    j = q + i * NT
    row, pos = rank * (B // 2) + j // MC, j % MC
    return row, pos // MC2 + MC1 * (pos % MC2), pos


def _spectrum_rows(state):
    """Phase 4's forward half written back in place: item (row, k1) turns
    positions 8 k1 + a (times W_C^{a k1}) into kc = k1 + 16 k2 at position
    8 k1 + k2.  Returns the plane state (..., B, C) after it."""
    L = 1 << 21   # any plan: tw4 depends on C only
    tw4 = radix_fft._kernel_table_np(L)["tw4"].T   # [k1, a]
    *lead, B, _ = state.shape
    s = state.reshape(*lead, B, MC1, MC2) * tw4
    return _einsum("...ja,an->...jn", s, _F(MC2, -1)).reshape(*lead, B, MC)


@pytest.mark.parametrize("B", [8, 16, 32, 64, 128])
def test_wgrad_halves_cover_each_point_once(B):
    # the two CTAs' items cover every (kb, kc) of a plane exactly once, each
    # read at the position phase 4's write-back left kc in, and written to
    # d's stage order at kb = row / R2 + R1 (row % R2)
    R1, R2 = radix_fft._MID_RADICES[B]
    row, kc, pos = _wgrad_items(B)
    kb = row // R2 + R1 * (row % R2)
    flat = (kb * MC + kc).ravel()
    assert np.array_equal(np.sort(flat), np.arange(B * MC))
    # write-back: item (row, k1) puts kc = k1 + 16 k2 at position 8 k1 + k2
    k1, k2 = np.meshgrid(np.arange(MC1), np.arange(MC2), indexing="ij")
    where = np.empty(MC, dtype=int)
    where[k1 + MC1 * k2] = MC2 * k1 + k2
    assert np.array_equal(pos, where[kc])
    # the rows of each rank are its own half
    assert set(row[0].ravel()) == set(range(B // 2))
    assert set(row[1].ravel()) == set(range(B // 2, B))
    # a warp's 32 items: consecutive positions of one row (256 contiguous
    # bytes of the partner's plane but the pad), and each half-warp's
    # 64-bit reads on 16 distinct bank pairs
    for r in range(2):
        for q0 in range(0, row.shape[1], 32):
            for i in range(row.shape[2]):
                w_row, w_pos = row[r, q0:q0 + 32, i], pos[r, q0:q0 + 32, i]
                assert len(set(w_row)) == 1 and np.array_equal(np.diff(w_pos), np.ones(31))
                for h in (0, 16):
                    addrs = w_row[h:h + 16] * MS + _phys(pos[r, q0 + h:q0 + h + 16, i])
                    assert len({a % 16 for a in addrs}) == 16


@pytest.mark.parametrize("L", WGRAD_CASES)
@pytest.mark.parametrize("V", [1, 3, 40])
def test_wgrad_model_matches_plain(L, V):
    # the kernel step by step in float64: phases 1-3 (`_middle_forward_model`),
    # phase 4's forward half written back, the product of each rank's half
    # of the rows, summed over v in the kernel's order (the split's
    # contiguous run of v, then the splits in order by the second launch)
    # and written in stage order; against middle_wgrad_plain (every plane
    # where A = 8; at the headline eight planes against its own chain on
    # them): <= 1e-12
    A, B, C = radix_fft._factorize(L)
    R1, R2 = radix_fft._MID_RADICES[B]
    kas = list(range(A)) if A <= 16 else [0, 1, 5, A // 2 - 1, A // 2, A // 2 + 1, A - 2, A - 1]
    K = len(kas)
    rng = np.random.default_rng(L + V)
    x, g = _crandn(rng, V, K, B, C), _crandn(rng, V, K, B, C)
    X, G = (_spectrum_rows(_middle_forward_model(y, kas, L)) for y in (x, g))
    row, kc, pos = _wgrad_items(B)
    row, kc, pos = row.ravel(), kc.ravel(), pos.ravel()
    terms = (X.real * G.real + X.imag * G.imag)[:, :, row, pos]   # (V, K, items)
    splits = radix_fft.wgrad_splits(V, A, SMS)
    part = np.zeros((splits, K, row.size))
    for s in range(splits):
        for v in range(s * V // splits, (s + 1) * V // splits):
            part[s] += terms[v]
    acc = np.zeros((K, row.size))
    for s in range(splits):
        acc += part[s]
    got = np.empty((K, B, C))
    got[:, row // R2 + R1 * (row % R2), kc] = acc
    if K == A:
        plan = radix_fft.make_plan(L, torch.float64)
        t = lambda z: torch.as_tensor(np.ascontiguousarray(z))
        want = radix_fft.middle_wgrad_plain(t(x.real), t(x.imag), t(g.real), t(g.imag),
                                            plan).numpy()
    else:
        t1, t2, wb, wc = radix_fft._middle_tables(L, torch.float64, torch.device("cpu"))
        Xp, Gp = (radix_fft._middle_forward(torch.as_tensor(y), t1[kas], t2, wb, wc)
                  for y in (x, g))
        want = torch.sum(Xp.real * Gp.real + Xp.imag * Gp.imag, dim=0).numpy()
    assert _rel(got, want) <= 1e-12


def _source_fn(name, src):
    m = re.search(r"\b" + name + r"\(([^)]*)\)\s*\{\s*return ([^;]*);", src)
    assert m, name
    args = [a.split()[-1] for a in m.group(1).split(",") if a.strip()]
    return args, m.group(2)


def test_wgrad_cluster_and_splits_mirror_the_source():
    # radix_fft.WGRAD_CLUSTER and wgrad_splits are the source's WCL and
    # wgrad_splits (the rule the launcher applies; the wrapper sizes the
    # partial sums by it); the shared memory a CTA, the plane, the staged
    # real half and the mbarrier, fits one block at every B
    src = (Path(radix_fft.__file__).resolve().parent.parent / "csrc" / "radix.cu").read_text()
    assert f"constexpr int WCL = {radix_fft.WGRAD_CLUSTER};" in src
    args, body = _source_fn("wgrad_splits", src)
    assert args == ["V", "A", "sms"]
    env = {"WCL": radix_fft.WGRAD_CLUSTER, "clampi": lambda x, lo, hi: min(max(x, lo), hi)}
    for sms in (16, 78, 114, 132):
        for A in (8, 16, 32, 64, 128, 256, 2048):
            for V in (1, 2, 3, 7, 8, 40, 128, 1000):
                want = radix_fft.wgrad_splits(V, A, sms)
                assert eval(body.replace("/", "//"), {"__builtins__": {}},
                            {**env, "V": V, "A": A, "sms": sms}) == want
                assert 1 <= want <= V
                # one wave of clusters where A leaves room, else one a ka
                assert A * want <= max(A, sms // radix_fft.WGRAD_CLUSTER)
    _, body = _source_fn("wgrad_smem", src)
    for B in (8, 16, 32, 64, 128):
        smem = eval(body.replace("mid_smem<B>()", "mid_smem").replace("(size_t)", "")
                    .replace("sizeof(float)", "4"), {"__builtins__": {}},
                    {"mid_smem": B * MS * 8, "B": B, "MC": MC})
        assert smem == B * MS * 8 + B * MC * 4 + 16 and smem <= 232448
        assert (B * MS * 8) % 16 == 0   # the staged half is 16-byte aligned
    assert smem == 205_840
