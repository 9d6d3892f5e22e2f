"""Kernels A and B-8 (hipgp_tpu_torch/csrc/sandwich_fft.cu), the radix
kernels B-2, B-3, B-4 and B-7 (hipgp_tpu_torch/csrc/radix.cu) and the 3-D
sandwich kernels B-5 (csrc/sandwich_wp.cu) and B-6 (csrc/mxu3d.cu) against their
plain PyTorch versions on a CUDA card.  Every test here needs the card and
skips without one.

On the machine with the card, which has no JAX, run without the suite's
conftest (it imports JAX):
    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu_torch.kernels import Matern
from hipgp_tpu_torch.ops import bttb, mxu2d, mxu3d, radix_fft, solve

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _spec(dims, dtype, dev, ell=0.07):
    grids = [torch.linspace(-1.0, 1.0, m, dtype=dtype, device=dev) for m in dims]
    kf = lambda a, b: torch.exp(
        -0.5 * torch.sum(((a[:, None, :] - b[None, :, :]) / ell) ** 2, -1))
    return bttb.make_spectrum(grids, kf, jitter=1e-3)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


# (63, 40) embeds at (125, 80), odd; (256, 256) at (512, 512), the largest
# embedding kernel A takes (the dense kernel's shared-memory slab refused its
# expanded input)
@pytest.mark.parametrize("dims", [(12, 9), (7, 20), (33, 17), (64, 64), (63, 40),
                                  (256, 256)])
@pytest.mark.parametrize("B", [1, 3, 70])
@pytest.mark.parametrize("mode", ["cropped", "out_expanded", "in_expanded", "full",
                                  "selfdot"])
def test_kernel_matches_plain_f64_reference(dev, dims, B, mode):
    # f32 kernel against the plain version in f64 on the same inputs: f32
    # rounding of two 2-step DFTs per axis, well under 1e-5 relative
    spec = _spec(dims, torch.float64, dev)
    w64 = bttb._full_weights(spec.eigs, spec.edims[-1])
    if mode == "out_expanded":
        w64 = torch.sqrt(w64)
    in_exp = mode in ("in_expanded", "full")
    out_exp = mode in ("out_expanded", "full")
    gen = torch.Generator(device=dev).manual_seed(B)
    shape = spec.edims if in_exp else spec.dims
    x64 = torch.randn((B,) + tuple(shape), generator=gen, device=dev,
                      dtype=torch.float64)
    x, w = x64.float().contiguous(), w64.float().contiguous()
    t64 = mxu2d._tables(spec.dims, spec.edims, in_exp, out_exp, torch.float64, dev)
    before = dict(mxu2d.LAUNCHES)
    if mode == "selfdot":
        y, dots = mxu2d.sandwich_apply_selfdot(x, w, spec.dims, spec.edims)
        yp, dp = mxu2d.sandwich_plain(x.double(), w.double(), *t64[:4], selfdot=True)
        assert _rel(dots, dp) <= 1e-5
        assert mxu2d.LAUNCHES["sandwich_apply_selfdot"] == before["sandwich_apply_selfdot"] + 1
    else:
        y = mxu2d.sandwich_apply(x, w, spec.dims, spec.edims, in_expanded=in_exp,
                                 out_expanded=out_exp)
        yp = mxu2d.sandwich_plain(x.double(), w.double(), *t64[:4])
        assert mxu2d.LAUNCHES["sandwich_apply"] == before["sandwich_apply"] + 1
    torch.cuda.synchronize()
    assert y.shape == yp.shape and y.dtype == torch.float32
    assert _rel(y, yp) <= 1e-5


@pytest.mark.parametrize("dims", [(40, 40), (256, 256)])
def test_selfdot_is_deterministic(dev, dims):
    spec = _spec(dims, torch.float32, dev)
    w = bttb._full_weights(spec.eigs, spec.edims[-1]).contiguous()
    x = torch.randn((33,) + dims, device=dev)
    y1, d1 = mxu2d.sandwich_apply_selfdot(x, w, spec.dims, spec.edims)
    y2, d2 = mxu2d.sandwich_apply_selfdot(x, w, spec.dims, spec.edims)
    assert torch.equal(y1, y2) and torch.equal(d1, d2)


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    spec = _spec((12, 9), torch.float32, dev)
    w = bttb._full_weights(spec.eigs, spec.edims[-1]).contiguous()
    x = torch.randn((2, 12, 9), device=dev)
    with pytest.raises(TypeError):
        mxu2d.sandwich_apply(x.double(), w.double(), spec.dims, spec.edims)
    with pytest.raises(ValueError):
        mxu2d.sandwich_apply(x.transpose(1, 2).contiguous().transpose(1, 2), w,
                             spec.dims, spec.edims)
    with pytest.raises(ValueError):
        mxu2d.sandwich_apply(x, w.cpu(), spec.dims, spec.edims)


def test_kernel_path_whiten_matches_plain_path(dev):
    # the f32 kernel path (fused PCG + sandwich R^T) against the f64 plain
    # path on the card; 10 truncated PCG iterations in f32 stay within 5e-3
    s64 = _spec((48, 40), torch.float64, dev, ell=0.05)
    s32 = _spec((48, 40), torch.float32, dev, ell=0.05)
    rng = np.random.default_rng(0)
    knm = torch.as_tensor(rng.standard_normal((64, s64.M)), device=dev)
    before = dict(mxu2d.LAUNCHES)
    solve.PCG_STATS.update(solves=0, iterations=0)
    kn32 = solve.whiten(s32, knm.float(), maxiter=10)
    kn64 = solve.whiten(s64, knm, maxiter=10)
    assert solve.PCG_STATS["solves"] == 1
    k = solve.PCG_STATS["iterations"]
    assert mxu2d.LAUNCHES["sandwich_apply_selfdot"] == before["sandwich_apply_selfdot"] + 1 + 2 * k
    assert mxu2d.LAUNCHES["sandwich_apply"] == before["sandwich_apply"] + 1
    assert _rel(kn32, kn64) <= 5e-3


# ---------------------------------------------------------------------------
# the radix kernels (csrc/radix.cu)
# ---------------------------------------------------------------------------

RADIX_LENGTHS = [8192, 32768, 1 << 18, 1 << 20, 1 << 21, 1 << 22, 1 << 25]
# (L, rows of data) of the section 5.2 sizes on the planes path:
# M = 131 072, 500 000 and 2^20
MAIN_PATH_CROPS = [(1 << 18, 8), (1 << 20, 31), (1 << 21, 64)]


def _plans(L, dev):
    return (radix_fft.make_plan(L, torch.float32, dev),
            radix_fft.make_plan(L, torch.float64, dev))


def _even_spectrum(L, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    d = 0.5 + torch.rand(L, generator=g, device=dev, dtype=torch.float64)
    return 0.5 * (d + torch.cat([d[:1], d[1:].flip(0)]))


def _randn(shape, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev, dtype=torch.float64)


@pytest.mark.parametrize("L", RADIX_LENGTHS)
@pytest.mark.parametrize("case", ["forward", "forward_cropped", "inverse",
                                  "inverse_cropped"])
def test_radix_stage1_matches_plain(dev, L, case):
    # f32 kernel (register-radix FFT) against the plain dense-table version in f32
    # and in f64 on the same inputs: f32 rounding of A-point sums
    p32, p64 = _plans(L, dev)
    A, N, V = p32.A, p32.B * p32.C, 4
    rows = A // 2 + 1
    inverse = case.startswith("inverse")
    in_rows = rows if case == "forward_cropped" else A
    out_rows = rows if case == "inverse_cropped" else A
    x = _randn((2, V, in_rows, N), dev, L + len(case))
    x32 = x.float()
    before = radix_fft.LAUNCHES["stage1"]
    y = radix_fft.stage1(x32[0], x32[1], p32, out_rows, inverse)
    assert radix_fft.LAUNCHES["stage1"] == before + 1
    wr, wi = radix_fft._s1_tables(p32, in_rows, out_rows, inverse)
    y32 = radix_fft.stage1_plain(x32[0], x32[1], wr, wi)
    wr, wi = radix_fft._s1_tables(p64, in_rows, out_rows, inverse)
    y64 = radix_fft.stage1_plain(x[0], x[1], wr, wi)
    torch.cuda.synchronize()
    for k in range(2):
        assert y[k].shape == (V, out_rows, N) and y[k].dtype == torch.float32
        assert _rel(y[k], y32[k]) <= 1e-5
        assert _rel(y[k], y64[k]) <= 1e-5


@pytest.mark.parametrize("L", RADIX_LENGTHS)
@pytest.mark.parametrize("cropped", [False, True])
def test_radix_stage1_inv_dot_matches_plain(dev, L, cropped):
    p32, p64 = _plans(L, dev)
    A, N, V = p32.A, p32.B * p32.C, 4
    rows = A // 2 if cropped else A
    z = _randn((2, V, A, N), dev, L)
    u = _randn((2, V, rows, N), dev, L + 1)
    z32, u32 = z.float(), u.float()
    before = radix_fft.LAUNCHES["stage1_inv_dot"]
    got = radix_fft.stage1_inv_dot(z32[0], z32[1], u32[0], u32[1], p32, rows)
    assert radix_fft.LAUNCHES["stage1_inv_dot"] == before + 1
    wr, wi = radix_fft._s1_tables(p64, A, rows, True)
    want = radix_fft.stage1_inv_dot_plain(z[0], z[1], u[0], u[1], wr, wi)
    torch.cuda.synchronize()
    for k in range(2):
        assert _rel(got[k], want[k]) <= 1e-5
    # the dots sum ~V * rows * N products of O(1) terms with random signs:
    # hold their error to the scale of the terms, not of the small sum
    scale = torch.sqrt(torch.sum((u[0] * want[0]) ** 2, dim=(1, 2)))
    for k in (2, 3):
        assert got[k].shape == (V,)
        assert float(torch.max(torch.abs(got[k].double() - want[k]) / scale)) <= 1e-5


@pytest.mark.parametrize("L", RADIX_LENGTHS)
def test_radix_middle_matches_plain(dev, L):
    p32, p64 = _plans(L, dev)
    V = 4
    y = _randn((2, V, p32.A, p32.B, p32.C), dev, L)
    d64 = radix_fft.permute_weights(_even_spectrum(L, dev, L), p64)
    y32, d32 = y.float(), d64.float()
    before = radix_fft.LAUNCHES["middle"]
    got = radix_fft.middle(y32[0], y32[1], d32, p32)
    assert radix_fft.LAUNCHES["middle"] == before + 1
    want32 = radix_fft.middle_plain(y32[0], y32[1], d32, p32)
    want64 = radix_fft.middle_plain(y[0], y[1], d64, p64)
    torch.cuda.synchronize()
    for k in range(2):
        assert _rel(got[k], want32[k]) <= 1e-5
        assert _rel(got[k], want64[k]) <= 1e-5


@pytest.mark.parametrize("L,rows", MAIN_PATH_CROPS)
def test_radix_main_path_crops_match_plain(dev, L, rows):
    # the forward stage from the rows of data and the self-dot inverse back
    # to them, at the crops the planes PCG gives the kernels
    p32, p64 = _plans(L, dev)
    A, N, V = p32.A, p32.B * p32.C, 4
    x = _randn((2, V, rows, N), dev, L + rows)
    u = _randn((2, V, rows, N), dev, L + rows + 1)
    z = _randn((2, V, A, N), dev, L + rows + 2)
    x32, u32, z32 = x.float(), u.float(), z.float()
    fwd = radix_fft.stage1(x32[0], x32[1], p32, A, inverse=False)
    inv = radix_fft.stage1_inv_dot(z32[0], z32[1], u32[0], u32[1], p32, rows)
    want_fwd = radix_fft.stage1_plain(x[0], x[1], *radix_fft._s1_tables(p64, rows, A, False))
    want_inv = radix_fft.stage1_inv_dot_plain(z[0], z[1], u[0], u[1],
                                              *radix_fft._s1_tables(p64, A, rows, True))
    torch.cuda.synchronize()
    for k in range(2):
        assert fwd[k].shape == (V, A, N) and inv[k].shape == (V, rows, N)
        assert _rel(fwd[k], want_fwd[k]) <= 1e-5
        assert _rel(inv[k], want_inv[k]) <= 1e-5
    scale = torch.sqrt(torch.sum((u[0] * want_inv[0]) ** 2, dim=(1, 2)))
    for k in (2, 3):
        assert float(torch.max(torch.abs(inv[k].double() - want_inv[k]) / scale)) <= 1e-5


def test_radix_selfdot_is_deterministic(dev):
    p32, _ = _plans(1 << 18, dev)
    A, N = p32.A, p32.B * p32.C
    z = torch.randn((2, 3, A, N), device=dev)
    u = torch.randn((2, 3, A // 2, N), device=dev)
    a = radix_fft.stage1_inv_dot(z[0], z[1], u[0], u[1], p32, A // 2)
    b = radix_fft.stage1_inv_dot(z[0], z[1], u[0], u[1], p32, A // 2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_radix_middle_is_deterministic(dev):
    # a second call of B-4 and of B-7 on the same inputs is bit-equal
    L = 1 << 21
    p32, _ = _plans(L, dev)
    y = _randn((2, 2, p32.A, p32.B, p32.C), dev, 3).float()
    d = radix_fft.permute_weights(_even_spectrum(L, dev, 4) / L, p32).float().contiguous()
    a = radix_fft.middle(y[0], y[1], d, p32)
    b = radix_fft.middle(y[0], y[1], d, p32)
    assert all(torch.equal(x, z) for x, z in zip(a, b))
    a = radix_fft.middle_dual(y[0], y[1], d, 2.0 * d, p32)
    b = radix_fft.middle_dual(y[0], y[1], d, 2.0 * d, p32)
    assert all(torch.equal(x, z) for x, z in zip(a, b))


@pytest.mark.parametrize("rows", [8, 1001])
def test_radix_stage1_crops_at_the_largest_plan(dev, rows):
    # A = 2048 (three register steps, 4-column tiles): the forward stage from
    # `rows` rows of data and the self-dot inverse back to them, at a crop of
    # 8 rows (within the lower half: the pruned variants) and at an odd crop
    p32, p64 = _plans(1 << 25, dev)
    A, N, V = p32.A, p32.B * p32.C, 2
    x = _randn((2, V, rows, N), dev, rows)
    z = _randn((2, V, A, N), dev, rows + 1)
    u = _randn((2, V, rows, N), dev, rows + 2)
    x32, z32, u32 = x.float(), z.float(), u.float()
    fwd = radix_fft.stage1(x32[0], x32[1], p32, A, inverse=False)
    inv = radix_fft.stage1_inv_dot(z32[0], z32[1], u32[0], u32[1], p32, rows)
    want_fwd = radix_fft.stage1_plain(x[0], x[1], *radix_fft._s1_tables(p64, rows, A, False))
    want_inv = radix_fft.stage1_inv_dot_plain(z[0], z[1], u[0], u[1],
                                              *radix_fft._s1_tables(p64, A, rows, True))
    torch.cuda.synchronize()
    for k in range(2):
        assert fwd[k].shape == (V, A, N) and inv[k].shape == (V, rows, N)
        assert _rel(fwd[k], want_fwd[k]) <= 1e-5
        assert _rel(inv[k], want_inv[k]) <= 1e-5
    scale = torch.sqrt(torch.sum((u[0] * want_inv[0]) ** 2, dim=(1, 2)))
    for k in (2, 3):
        assert float(torch.max(torch.abs(inv[k].double() - want_inv[k]) / scale)) <= 1e-5


def test_radix_kernels_set_their_shared_memory_attribute_once(dev):
    # every kernel of csrc/radix.cu is configured on the first launch of any:
    # later launches of every wrapper, at every plan, set no attribute again
    def launch_all():
        for L in (8192, 1 << 18, 1 << 21, 1 << 25):
            p32, _ = _plans(L, dev)
            A, B, C = p32.A, p32.B, p32.C
            x = torch.randn((2, 1, A, B * C), device=dev)
            radix_fft.stage1(x[0], x[1], p32, A, inverse=False)
            radix_fft.stage1(x[0], x[1], p32, A // 2, inverse=True)
            radix_fft.stage1_inv_dot(x[0], x[1], x[0, :, :8], x[1, :, :8], p32, 8)
            y = x.view(2, 1, A, B, C)
            d = torch.ones((A, B, C), device=dev)
            radix_fft.middle(y[0], y[1], d, p32)
            radix_fft.middle_dual(y[0], y[1], d, d, p32)
            radix_fft.middle_wgrad(y[0], y[1], y[1], y[0], p32)
        torch.cuda.synchronize()
        return radix_fft.attribute_sets()

    first = launch_all()
    sets, kernels = first
    # stage 1: 9 plans x 6 variants; the middle, its weight cotangent and the
    # dual middle: 5 x 3
    assert kernels == 9 * 6 + 5 * 3
    assert 0 < sets <= kernels
    assert launch_all() == first


@pytest.mark.parametrize("A", [8, 16, 32, 64, 128, 256, 512, 1024, 2048])
def test_radix_kernels_take_the_wrappers_radices(dev, A):
    # the built kernels' plan (radix_plan) is the one the tables and the CPU
    # model (tests/test_torch_radix_plan.py) follow, at every (A, B) they take
    for B in (8, 16, 32, 64, 128):
        assert radix_fft._kernel_plan(A, B) == (
            radix_fft._S1_RADICES[A], radix_fft._MID_RADICES[B],
            (radix_fft._MC1, radix_fft._MC2))
    assert radix_fft._kernel_plan(A, 256) is None
    assert radix_fft._kernel_plan(4096, 128) is None


def test_radix_table_check_refuses_radices_in_another_order(dev, monkeypatch):
    # (8, 16) over b sizes the table as (16, 8) does, with other twiddles
    caches = (radix_fft._kernel_table_np, radix_fft._kernel_table,
              radix_fft._checked_table)
    p32, _ = _plans(1 << 21, dev)
    y = torch.randn((2, 1, p32.A, p32.B, p32.C), device=dev)
    d = torch.ones((p32.A, p32.B, p32.C), device=dev)
    monkeypatch.setitem(radix_fft._MID_RADICES, 128, (8, 16))
    try:
        for c in caches:
            c.cache_clear()
        with pytest.raises(ValueError, match="radices"):
            radix_fft.middle(y[0], y[1], d, p32)
    finally:
        for c in caches:
            c.cache_clear()


def test_radix_wrappers_refuse_what_the_kernels_do_not_take(dev):
    p32, _ = _plans(8192, dev)
    A, B, C = p32.A, p32.B, p32.C
    x = torch.randn((2, A, B * C), device=dev)
    with pytest.raises(TypeError):
        radix_fft.stage1(x.double(), x.double(), p32, A, inverse=False)
    with pytest.raises(ValueError):
        radix_fft.stage1(x[:, ::2], x[:, ::2], p32, A, inverse=False)
    with pytest.raises(ValueError):
        radix_fft.stage1(x, x.cpu(), p32, A, inverse=False)
    y = x.view(2, A, B, C)
    d = torch.ones((A, B, C), device=dev)
    with pytest.raises(ValueError):
        radix_fft.middle(y, y, d.cpu(), p32)
    with pytest.raises(TypeError):
        radix_fft.stage1_inv_dot(x.double(), x.double(), x.double(), x.double(), p32, A)


@pytest.mark.parametrize("M", [131072, 131073])
def test_planes_gram_solve_matches_plain_path(dev, M):
    # the f32 kernel path (planes PCG + R^T through the radix kernels)
    # against the same solver on the CPU in f32 through the plain stages,
    # and against the f64 plain path (torch.fft PCG) on the card
    kern = Matern(2.5)
    kf = lambda a, b: kern(a, b, (0.1, 1.0 / M))
    b = np.random.default_rng(M).standard_normal((5, M))
    specs = {}
    for name, dt, where in (("k32", torch.float32, dev), ("c32", torch.float32, "cpu"),
                            ("k64", torch.float64, dev)):
        grid = torch.linspace(0.0, 1.0, M, dtype=dt, device=where)
        specs[name] = bttb.make_spectrum([grid], kf, jitter=1e-3)
    assert solve._planes_solver_ok(specs["k32"], torch.float32, dev)
    before = dict(radix_fft.LAUNCHES)
    solve.PCG_STATS.update(solves=0, iterations=0)
    out = {}
    for name, spec in specs.items():
        rhs = torch.as_tensor(b, dtype=spec.eigs.dtype, device=spec.eigs.device)
        if name == "c32":   # the planes solver itself, its stages plain on the CPU
            x = solve._planes_solver(spec, rhs, 20, 0.0, True)
            out[name] = solve._rt_planes(spec, x)
        else:
            out[name] = solve.gram_solve(spec, rhs, maxiter=20, tol=0.0,
                                         fixed_iters=True).cpu()
    k = 20
    assert radix_fft.LAUNCHES["middle"] - before["middle"] == 2 * k + 2
    assert radix_fft.LAUNCHES["stage1_inv_dot"] - before["stage1_inv_dot"] == 2 * k + 1
    assert radix_fft.LAUNCHES["stage1"] - before["stage1"] == 2 * k + 3
    assert out["k32"].shape == (5, specs["k32"].Mprime)
    assert _rel(out["k32"], out["c32"]) <= 1e-4
    assert _rel(out["k32"], out["k64"]) <= 5e-3


# ---------------------------------------------------------------------------
# the 3-D sandwich: kernel B-5 (csrc/sandwich_wp.cu, with kernel A's passes and a
# plane index for planes above one block) and kernel B-6 (csrc/mxu3d.cu)
# at the shapes of the dust map's main path (64 x 64 x 32 grid, embedded
# (128, 128, 64), kernel order (32, 64, 64) -> (64, 128, 128))
# ---------------------------------------------------------------------------

DIMS_3D, EDIMS_3D = (32, 64, 64), (64, 128, 128)


def _spectrum_3d(dev, dtype=torch.float32):
    """The main path's spectrum (SqExp, sig2 0.5, ell 0.07, jitter 1e-3 on the
    64 x 64 x 32 grid over [-1, 1]^3) and its kernel-order permutation."""
    kern = lambda a, b: 0.5 * torch.exp(
        -0.5 * torch.sum(((a[:, None, :] - b[None, :, :]) / 0.07) ** 2, -1))
    grids = [torch.linspace(-1.0, 1.0, m, dtype=dtype, device=dev) for m in (64, 64, 32)]
    spec = bttb.make_spectrum(grids, kern, jitter=1e-3)
    perm = mxu3d.best_perm(spec.edims)
    w = bttb._full_weights(spec.eigs, spec.edims[-1]).permute(perm).contiguous()
    return spec, w


@pytest.mark.parametrize("B,mode,weights", [
    (512, "selfdot", "wK"), (512, "out_expanded", "sqrt"), (400, "selfdot", "wK"),
    (400, "out_expanded", "sqrt"), (512, "selfdot", "1/wK"), (512, "in_expanded", "sqrt"),
    (3, "selfdot", "wK"), (5, "out_expanded", "sqrt"), (2, "expanded_512", "stack")])
def test_wp_kernel_matches_plain(dev, B, mode, weights):
    # B-5 at the PCG (w = wK and 1/wK), R^T, prediction-chunk and pullback
    # (expanded in) shapes, at odd batches, and a W = 3 stack expanded in and
    # out at (512, 512) (kernel A's passes with a plane index; the dense
    # kernel refused an expanded axis above 432) against its plain version
    # in f32 and f64: <= 1e-5; the route is the one the shape gives
    if mode == "expanded_512":
        spec = _spec((256, 256), torch.float32, dev, ell=0.05)
        w1 = bttb._full_weights(spec.eigs, spec.edims[-1])
        w = torch.stack([w1, torch.sqrt(w1), 1.0 / w1]).contiguous()
        W, inner, einner = 3, (256, 256), tuple(spec.edims)
        in_exp = out_exp = True
        route = "three-pass"
    else:
        _, w = _spectrum_3d(dev)
        w = {"wK": w, "sqrt": torch.sqrt(w), "1/wK": 1.0 / w}[weights].contiguous()
        W, inner, einner = EDIMS_3D[0], DIMS_3D[1:], EDIMS_3D[1:]
        in_exp, out_exp = mode == "in_expanded", mode == "out_expanded"
        route = "resident"
    selfdot = mode == "selfdot"
    t32 = mxu2d._tables(inner, einner, in_exp, out_exp, torch.float32, dev)
    t64 = mxu2d._tables(inner, einner, in_exp, out_exp, torch.float64, dev)
    assert mxu2d._wp_route(t32[4], einner, t32[5])[0] == route
    x = torch.randn((B, W) + t32[4], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(B))
    key = "sandwich_apply_wp_selfdot" if selfdot else "sandwich_apply_wp"
    before = mxu2d.LAUNCHES[key]
    got = mxu2d.sandwich_apply_wp(x, w, inner, einner, in_expanded=in_exp,
                                  out_expanded=out_exp, selfdot=selfdot)
    assert mxu2d.LAUNCHES[key] == before + 1
    want32 = mxu2d.sandwich_wp_plain(x, w, *t32[:4], selfdot=selfdot)
    want64 = mxu2d.sandwich_wp_plain(x.double(), w.double(), *t64[:4], selfdot=selfdot)
    torch.cuda.synchronize()
    if selfdot:
        assert _rel(got[1], want32[1]) <= 1e-5 and _rel(got[1], want64[1]) <= 1e-5
        got, want32, want64 = got[0], want32[0], want64[0]
    assert got.shape == want64.shape == (B, W) + t32[5]
    assert _rel(got, want32) <= 1e-5 and _rel(got, want64) <= 1e-5


# B-6's shapes: the dust map's, and the small ones the CPU model of the
# kernel holds against the plain version (tests/test_torch_wp3_plan.py)
WP3_SHAPES = [(DIMS_3D, EDIMS_3D), ((8, 16, 16), (16, 32, 32)), ((5, 13, 9), (16, 32, 32)),
              ((16, 32, 32), (32, 64, 64)), ((27, 30, 61), (64, 64, 128))]


def _wp3_weights(dev, edims, even):
    """The solver's spectrum at the dust map (else a random even w), or a
    random w that is not even."""
    if even and edims == EDIMS_3D:
        return _spectrum_3d(dev)[1]
    w = np.random.default_rng(len(edims) + edims[0]).uniform(0.1, 2.0, edims)
    if even:
        w = 0.5 * (w + w[np.ix_(*[(-np.arange(L)) % L for L in edims])])
    return torch.as_tensor(w, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("shape", range(len(WP3_SHAPES)))
@pytest.mark.parametrize("B", [1, 3, 512])
@pytest.mark.parametrize("even", [True, False])
@pytest.mark.parametrize("selfdot", [True, False])
def test_wp3_kernel_matches_plain(dev, shape, B, even, selfdot):
    # B-6 against its plain version in f32 and f64 (<= 1e-5 relative: f32
    # rounding of two register steps per axis), for the solver's spectrum and
    # a w that is not even; a repeated call bit-equal
    dims, edims = WP3_SHAPES[shape]
    assert mxu3d._wp3_ok(dims, edims, torch.float32)
    w = _wp3_weights(dev, edims, even)
    x = torch.randn((B,) + dims, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(6 + B))
    before = mxu3d.LAUNCHES["sandwich_apply_wp3"]
    got = mxu3d.sandwich_apply_wp3(x, w, dims, edims, selfdot=selfdot)
    again = mxu3d.sandwich_apply_wp3(x, w, dims, edims, selfdot=selfdot)
    assert mxu3d.LAUNCHES["sandwich_apply_wp3"] == before + 2
    y32, d32 = mxu3d.sandwich_wp3_plain(x, w, dims, edims, selfdot=True)
    y64, d64 = mxu3d.sandwich_wp3_plain(x.double(), w.double(), dims, edims, selfdot=True)
    torch.cuda.synchronize()
    if selfdot:
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        y, dots = got
        assert _rel(dots, d32) <= 1e-5 and _rel(dots, d64) <= 1e-5
    else:
        assert torch.equal(got, again)
        y = got
    assert y.shape == x.shape
    assert _rel(y, y32) <= 1e-5 and _rel(y, y64) <= 1e-5
    assert mxu3d._wp3_clusters(dims, edims, x.device) >= 1


def test_3d_selfdots_are_deterministic(dev):
    _, w = _spectrum_3d(dev)
    x = torch.randn((96,) + DIMS_3D, device=dev)
    u = torch.randn((96, EDIMS_3D[0]) + DIMS_3D[1:], device=dev)
    a = mxu3d.sandwich_apply_wp3(x, w, DIMS_3D, EDIMS_3D, selfdot=True)
    b = mxu3d.sandwich_apply_wp3(x, w, DIMS_3D, EDIMS_3D, selfdot=True)
    c = mxu2d.sandwich_apply_wp(u, w, DIMS_3D[1:], EDIMS_3D[1:], selfdot=True)
    d = mxu2d.sandwich_apply_wp(u, w, DIMS_3D[1:], EDIMS_3D[1:], selfdot=True)
    assert all(torch.equal(p, q) for p, q in zip(a + c, b + d))


def test_3d_wrappers_refuse_what_the_kernels_do_not_take(dev):
    _, w = _spectrum_3d(dev)
    inner, einner = DIMS_3D[1:], EDIMS_3D[1:]
    u = torch.randn((2, EDIMS_3D[0]) + inner, device=dev)
    with pytest.raises(TypeError):
        mxu2d.sandwich_apply_wp(u.double(), w.double(), inner, einner)
    with pytest.raises(ValueError):
        mxu2d.sandwich_apply_wp(u.transpose(2, 3).contiguous().transpose(2, 3), w,
                                inner, einner)
    with pytest.raises(ValueError):
        mxu2d.sandwich_apply_wp(u, w.cpu(), inner, einner)
    x = torch.randn((2,) + DIMS_3D, device=dev)
    with pytest.raises(TypeError):
        mxu3d.sandwich_apply_wp3(x.double(), w.double(), DIMS_3D, EDIMS_3D)
    with pytest.raises(ValueError):
        mxu3d.sandwich_apply_wp3(x.transpose(2, 3).contiguous().transpose(2, 3), w,
                                 DIMS_3D, EDIMS_3D)
    with pytest.raises(ValueError):
        mxu3d.sandwich_apply_wp3(x, w.cpu(), DIMS_3D, EDIMS_3D)


def test_3d_kernel_path_whiten_matches_plain_paths(dev):
    # the f32 kernel path (fused 3-D PCG + R^T) on 16 rows against the same
    # solver on the CPU in f32 through the plain stages, with the same f32
    # spectrum (<= 1e-4), and the f64 plain path on the card (<= 5e-3), 20
    # iterations, launches exact.  The CPU solver gets the card's spectrum:
    # built on the CPU in f32, the smallest eigenvalues carry other f32
    # rounding than the card's, which this ill-conditioned solve amplifies
    # (3.2e-4 of the whitening on an H100 when each side built its own)
    s32, _ = _spectrum_3d(dev)
    c32 = dataclasses.replace(s32, column=s32.column.cpu(), eigs=s32.eigs.cpu(),
                              ecolumn=s32.ecolumn.cpu())
    s64, _ = _spectrum_3d(dev, torch.float64)
    assert solve._mxu3d_solver_ok(s32, torch.float32, dev)
    b = np.random.default_rng(3).standard_normal((16, s32.M))
    before = {**mxu2d.LAUNCHES, **mxu3d.LAUNCHES}
    solve.PCG_STATS.update(solves=0, iterations=0)
    k32 = solve.whiten(s32, torch.as_tensor(b, dtype=torch.float32, device=dev),
                       maxiter=20, tol=0.0, fixed_iters=True)
    torch.cuda.synchronize()
    moved = {n: v - before[n] for n, v in {**mxu2d.LAUNCHES, **mxu3d.LAUNCHES}.items()
             if v != before[n]}
    applies = "sandwich_apply_wp3" if mxu3d.USE_WP3 else "sandwich_apply_wp_selfdot"
    assert solve.PCG_STATS == {"solves": 1, "iterations": 20}
    assert moved == {applies: 41, "sandwich_apply_wp": 1}
    xc = solve._mxu3d_solver(c32, torch.as_tensor(b, dtype=torch.float32), 20, 0.0, True)
    c = solve._rt_mxu3d(c32, xc)
    k64 = solve.whiten(s64, torch.as_tensor(b, device=dev), maxiter=20, tol=0.0,
                       fixed_iters=True)
    assert k32.shape == (16, s32.Mprime)
    assert _rel(k32.cpu(), c) <= 1e-4
    assert _rel(k32, k64) <= 5e-3


# ---------------------------------------------------------------------------
# the training path: kernel A's backward, B-8 (the full-plane sandwich,
# csrc/sandwich_fft.cu with full crops), B-7 (the two-diagonal middle,
# csrc/radix.cu) and the whitening's gradient
# ---------------------------------------------------------------------------

def test_kernel_a_backward_at_the_pullback_crops(dev):
    # the main path's R^T, (256, 125, 125) -> (256, 250, 250), differentiated
    # on the card: gx is kernel A at the pullback crops (256, 250, 250) ->
    # (256, 125, 125), gw the plain analyses; both against the f64 plain
    # version's autograd on the card, <= 1e-5
    spec = _spec((125, 125), torch.float64, dev, ell=0.05)
    w64 = torch.sqrt(bttb._full_weights(spec.eigs, spec.edims[-1]))
    x64 = _randn((256, 125, 125), dev, 1)
    g64 = _randn((256, 250, 250), dev, 2)
    x = x64.float().requires_grad_()
    w = w64.float().contiguous().requires_grad_()
    before = mxu2d.LAUNCHES["sandwich_apply"]
    y = mxu2d.sandwich_apply(x, w, spec.dims, spec.edims, out_expanded=True)
    got = (y,) + torch.autograd.grad(y, (x, w), g64.float())
    # R^T and its pullback launch kernel A
    assert mxu2d.LAUNCHES["sandwich_apply"] - before == 2
    # the reference: autograd through the f64 plain version on the card
    t64 = mxu2d._tables(spec.dims, spec.edims, False, True, torch.float64, dev)
    xr, wr = x64.clone().requires_grad_(), w64.clone().requires_grad_()
    yr = mxu2d.sandwich_plain(xr, wr, *t64[:4])
    want = (yr,) + torch.autograd.grad(yr, (xr, wr), g64)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _rel(a, b) <= 1e-5
    # the pullback itself, as a forward call at its crops
    t64 = mxu2d._tables(spec.dims, spec.edims, True, False, torch.float64, dev)
    y = mxu2d.sandwich_apply(g64.float(), w64.float().contiguous(), spec.dims, spec.edims,
                             in_expanded=True)
    assert y.shape == (256, 125, 125)
    assert _rel(y, mxu2d.sandwich_plain(g64, w64, *t64[:4])) <= 1e-5


@pytest.mark.parametrize("shape", [(256, 250, 250), (3, 16, 12), (70, 64, 64)])
def test_b8_matches_plain(dev, shape):
    # B-8 and its backward (gx is B-8 again, gw plain) against the plain
    # version in f32 and f64, <= 1e-5
    from hipgp_tpu_torch.ops import pallas_transform

    B, L0, L1 = shape
    Q = {dt: (bttb._real_fourier_basis(L0, dt, dev), bttb._real_fourier_basis(L1, dt, dev))
         for dt in (torch.float32, torch.float64)}
    w64 = 0.1 + torch.rand((L0, L1), generator=torch.Generator(device=dev).manual_seed(B),
                           device=dev, dtype=torch.float64)
    x64, g64 = _randn(shape, dev, 3), _randn(shape, dev, 4)
    x = x64.float().requires_grad_()
    w = w64.float().requires_grad_()
    before = pallas_transform.LAUNCHES["circulant_apply_2d"]
    y = pallas_transform.circulant_apply_2d(x, *Q[torch.float32], w)
    got = (y,) + torch.autograd.grad(y, (x, w), g64.float())
    # the apply and its backward's gx launch B-8
    assert pallas_transform.LAUNCHES["circulant_apply_2d"] - before == 2
    # the references: the plain version in f32, and autograd through it in f64
    y32 = pallas_transform._apply_einsum(x64.float(), *Q[torch.float32], w64.float())
    xr, wr = x64.clone().requires_grad_(), w64.clone().requires_grad_()
    yr = pallas_transform._apply_einsum(xr, *Q[torch.float64], wr)
    want = (yr,) + torch.autograd.grad(yr, (xr, wr), g64)
    torch.cuda.synchronize()
    assert _rel(y, y32) <= 1e-5
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _rel(a, b) <= 1e-5


def test_b8_refuses_tables_it_does_not_read(dev):
    # the FFT kernel computes with its own tables: anything but the cached
    # real Fourier bases raises, and nothing is launched
    from hipgp_tpu_torch.ops import pallas_transform

    Q0 = bttb._real_fourier_basis(24, torch.float32, dev)
    Q1 = bttb._real_fourier_basis(16, torch.float32, dev)
    x = torch.randn((3, 24, 16), device=dev)
    w = torch.ones((24, 16), device=dev)
    before = pallas_transform.LAUNCHES["circulant_apply_2d"]
    for q0, q1 in ((Q0.clone(), Q1), (Q0, torch.eye(16, device=dev))):
        with pytest.raises(ValueError, match="cached real Fourier basis"):
            pallas_transform.circulant_apply_2d(x, q0, q1, w)
    assert pallas_transform.LAUNCHES["circulant_apply_2d"] == before
    assert pallas_transform.circulant_apply_2d(x, Q0, Q1, w).shape == (3, 24, 16)
    assert pallas_transform.LAUNCHES["circulant_apply_2d"] == before + 1


def test_training_step_at_256_squared(dev):
    # one 2-D training step at M = 256^2 (embedded (512, 512)): the
    # whitening's backward runs kernel A's pullback (512, 512) -> (256, 256),
    # which the dense kernel's shared memory could not take; finite ELBO and
    # hyper-gradients, launches exact
    from hipgp_tpu_torch.experiments.run_synthetic import build_model

    k = 3
    model = build_model("SqExp", 256, 1000, 1.0, 0.05, 0.01, dtype=torch.float32,
                        device=dev)
    assert model.spectrum(model.init_state()).edims == (512, 512)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-1, 1, (64, 2)), dtype=torch.float32, device=dev)
    y = torch.as_tensor(np.sin(3 * rng.uniform(-1, 1, 64)), dtype=torch.float32,
                        device=dev)
    mxu2d.reset_launches()
    solve.PCG_STATS.update(solves=0, iterations=0)
    elbo, g = model.elbo_and_grads(model.init_state(), x, y, None, maxiter_cg=k,
                                   compute_hyper_grads=True)
    torch.cuda.synchronize()
    assert np.isfinite(float(elbo))
    for name in ("log_sig2", "log_ell", "log_noise2"):
        assert np.isfinite(float(getattr(g, name)))
    # the forward and the backward solve; R^T and its pullback
    st = dict(solve.PCG_STATS)
    assert st["solves"] == 2 and st["iterations"] <= 2 * k
    assert {n: v for n, v in mxu2d.LAUNCHES.items() if v} == {
        "sandwich_apply_selfdot": st["solves"] + 2 * st["iterations"], "sandwich_apply": 2}


@pytest.mark.parametrize("L", RADIX_LENGTHS)
def test_radix_middle_dual_matches_plain(dev, L):
    # B-7 against its plain version in f32 and f64 and against two B-4
    # launches, <= 1e-5
    p32, p64 = _plans(L, dev)
    V = 4
    y = _randn((2, V, p32.A, p32.B, p32.C), dev, L + 5)
    dA64 = radix_fft.permute_weights(_even_spectrum(L, dev, L) / L, p64)
    dB64 = radix_fft.permute_weights(1.0 / (_even_spectrum(L, dev, L) * L), p64)
    y32, dA, dB = y.float(), dA64.float().contiguous(), dB64.float().contiguous()
    before = dict(radix_fft.LAUNCHES)
    got = radix_fft.middle_dual(y32[0], y32[1], dA, dB, p32)
    assert radix_fft.LAUNCHES["middle_dual"] == before["middle_dual"] + 1
    want32 = radix_fft.middle_dual_plain(y32[0], y32[1], dA, dB, p32)
    want64 = radix_fft.middle_dual_plain(y[0], y[1], dA64, dB64, p64)
    twice = (radix_fft.middle(y32[0], y32[1], dA, p32)
             + radix_fft.middle(y32[0], y32[1], dB, p32))
    torch.cuda.synchronize()
    for k in range(4):
        assert got[k].shape == y32[0].shape
        assert _rel(got[k], want32[k]) <= 1e-5
        assert _rel(got[k], want64[k]) <= 1e-5
        assert _rel(got[k], twice[k]) <= 1e-5


def test_radix_dual_apply_matches_two_applies(dev):
    # fused_circulant_apply_cropped_dual at the headline plan and crop (64 of
    # 128 rows) against two cropped applies, <= 1e-5
    L, rows, V = 1 << 21, 64, 4
    p32, _ = _plans(L, dev)
    N = p32.B * p32.C
    x = _randn((2, V, rows * N), dev, 7).float()
    dA = radix_fft.permute_weights(_even_spectrum(L, dev, 8) / L, p32).float().contiguous()
    dB = radix_fft.permute_weights(_even_spectrum(L, dev, 9) / L, p32).float().contiguous()
    got = radix_fft.fused_circulant_apply_cropped_dual(x[0], x[1], dA, dB, p32, rows, rows)
    for (gr, gi), d in zip(got, (dA, dB)):
        wr, wi = radix_fft.fused_circulant_apply_cropped(x[0], x[1], d, p32, rows, rows)
        assert _rel(gr, wr) <= 1e-5 and _rel(gi, wi) <= 1e-5


def _whiten_grads(dims, dt, where, ell=0.05, sig2=0.3, pallas=False):
    """(loss, d loss / d(log_sig2, log_ell, rhs)) of sum(whiten(spec, rhs) * c)
    with 10 PCG iterations, rhs and c from one numpy seed."""
    rng = np.random.default_rng(11)
    M = dims[0] * dims[1]
    b = rng.standard_normal((32, M))
    c = rng.standard_normal((32, int(np.prod(bttb.embedded_dims(dims)))))
    ls = torch.tensor(np.log(sig2), dtype=dt, device=where, requires_grad=True)
    le = torch.tensor(np.log(ell), dtype=dt, device=where, requires_grad=True)
    rhs = torch.as_tensor(b, dtype=dt, device=where).requires_grad_()
    p = (torch.exp(ls), torch.exp(le))
    kern = lambda a, bb: p[0] * torch.exp(
        -0.5 * torch.sum(((a[:, None, :] - bb[None, :, :]) / p[1]) ** 2, -1))
    grids = [torch.linspace(-1.0, 1.0, m, dtype=dt, device=where) for m in dims]
    spec = bttb.make_spectrum(grids, kern, jitter=1e-3)
    saved = bttb.USE_MXU2D_PCG, bttb.USE_PALLAS_TRANSFORM
    bttb.USE_MXU2D_PCG, bttb.USE_PALLAS_TRANSFORM = not pallas, pallas
    try:
        kn = solve.whiten(spec, rhs, maxiter=10, tol=0.0, fixed_iters=True)
        loss = torch.sum(kn * torch.as_tensor(c, dtype=dt, device=where))
        return loss, torch.autograd.grad(loss, (ls, le, rhs))
    finally:
        bttb.USE_MXU2D_PCG, bttb.USE_PALLAS_TRANSFORM = saved


@pytest.mark.parametrize("route", ["mxu2d", "b8"])
def test_whiten_gradient_on_the_card_matches_f64_cpu(dev, route):
    # the f32 kernel-path gradient of a 10-iteration whitening (kernel A's
    # fused PCG and backward, or the generic PCG over B-8) against the f64
    # plain path on the CPU: each of d/d log_sig2, d/d log_ell and d/d rhs
    # within 1e-2 relative, the limit [train-grad] holds the model to;
    # launches exact
    from hipgp_tpu_torch.ops import pallas_transform

    dims = (48, 40)
    k = 10
    before = {**mxu2d.LAUNCHES, **pallas_transform.LAUNCHES}
    solve.PCG_STATS.update(solves=0, iterations=0)
    l32, g32 = _whiten_grads(dims, torch.float32, dev, pallas=route == "b8")
    torch.cuda.synchronize()
    moved = {n: v - before[n] for n, v in {**mxu2d.LAUNCHES, **pallas_transform.LAUNCHES}.items()
             if v != before[n]}
    if route == "mxu2d":
        # forward and backward solve; R^T and its pullback; dK by einsum
        assert solve.PCG_STATS == {"solves": 2, "iterations": 2 * k}
        assert moved == {"sandwich_apply_selfdot": 2 * (1 + 2 * k), "sandwich_apply": 2}
    else:
        # each solve 1 + 2k applies, R^T one (its backward one more, for
        # gx), and the dK term's matmul_by_K one forward launch
        assert moved == {"circulant_apply_2d": 2 * (1 + 2 * k) + 2 + 1}
    l64, g64 = _whiten_grads(dims, torch.float64, "cpu")
    assert abs(float(l32) - float(l64)) <= 1e-2 * abs(float(l64))
    for got, want in zip(g32, g64):
        assert _rel(got.cpu(), want) <= 1e-2


def test_gradient_guards_on_the_card(dev):
    # the 1-D planes/radix branch and the 3-D B-5 branch are differentiable
    # through their kernels (the radix apply's backward, B-5's); the
    # solver-internal self-dot applies (kernel A's, B-6) still raise for a
    # required gradient, and run without one
    ell = torch.tensor(1.0 / 131072, device=dev, requires_grad=True)
    kern = Matern(2.5)
    grid = torch.linspace(0.0, 1.0, 131072, device=dev)
    spec = bttb.make_spectrum([grid], lambda a, b: kern(a, b, (0.1, ell)), jitter=1e-3)
    rhs = torch.randn((8, 131072), device=dev)
    assert solve._planes_solver_ok(spec, torch.float32, dev)
    before = radix_fft.LAUNCHES["middle_wgrad"]
    (g,) = torch.autograd.grad(torch.sum(solve.whiten(spec, rhs, maxiter=2) ** 2), ell)
    # the R^T's and the dK term's weight cotangents
    assert radix_fft.LAUNCHES["middle_wgrad"] == before + 2
    assert bool(torch.isfinite(g))
    v = rhs.clone().requires_grad_()
    (gv,) = torch.autograd.grad(torch.sum(bttb.matmul_by_K(spec, v)), v)
    assert gv.shape == v.shape and bool(torch.isfinite(gv).all())
    s3, w3 = _spectrum_3d(dev)
    x3 = torch.randn((2, s3.M), device=dev, requires_grad=True)
    before = mxu2d.LAUNCHES["sandwich_apply_wp"]
    (g3,) = torch.autograd.grad(torch.sum(solve.whiten(s3, x3, maxiter=2) ** 2), x3)
    assert mxu2d.LAUNCHES["sandwich_apply_wp"] == before + 2   # R^T and its pullback
    assert bool(torch.isfinite(g3).all())
    xs = torch.randn((2,) + DIMS_3D, device=dev)
    with pytest.raises(NotImplementedError, match="solver-internal"):
        mxu3d.sandwich_apply_wp3(xs, w3.clone().requires_grad_(), DIMS_3D, EDIMS_3D,
                                 selfdot=True)
    s2 = _spec((24, 20), torch.float32, dev)
    w2 = bttb._full_weights(s2.eigs, s2.edims[-1]).requires_grad_()
    with pytest.raises(NotImplementedError, match="solver-internal"):
        mxu2d.sandwich_apply_selfdot(torch.randn((2, 24, 20), device=dev), w2, s2.dims,
                                     s2.edims)
    with torch.no_grad():
        assert mxu3d.sandwich_apply_wp3(xs, w3, DIMS_3D, EDIMS_3D, selfdot=True)[0].shape \
            == xs.shape


def _switch_case(case, dev, dtype):
    """A 1-D spectrum whose length the radix plan supports with the planes
    path's 8 rows (Matern-5/2, M = 131 072), or a small 3-D one (SqExp on
    16 x 16 x 8), with jitter 0.1 for a well-conditioned solve; and 4
    right-hand sides from a seed."""
    if case == "1d":
        kern = Matern(2.5)
        grid = torch.linspace(0.0, 1.0, 131072, dtype=dtype, device=dev)
        spec = bttb.make_spectrum([grid], lambda a, b: kern(a, b, (0.1, 1.0 / 131072)),
                                  jitter=0.1)
    else:
        kf = lambda a, b: 0.5 * torch.exp(
            -0.5 * torch.sum(((a[:, None, :] - b[None, :, :]) / 0.2) ** 2, -1))
        grids = [torch.linspace(-1.0, 1.0, m, dtype=dtype, device=dev) for m in (16, 16, 8)]
        spec = bttb.make_spectrum(grids, kf, jitter=0.1)
    b = np.random.default_rng(9).standard_normal((4, spec.M))
    return spec, torch.as_tensor(b, dtype=dtype, device=dev)


def _whiten_eigs_grad(spec, b):
    """The whitening of b (20 fixed iterations) and the gradient of a fixed
    projection of it with respect to spec.eigs.  The embedded column is
    dropped, so that every path's weights (the planes path's R^T included,
    which otherwise reads them from the column) come from spec.eigs."""
    eigs = spec.eigs.detach().clone().requires_grad_()
    s = dataclasses.replace(spec, eigs=eigs, ecolumn=None)
    kn = solve.whiten(s, b, maxiter=20, tol=0.0, fixed_iters=True)
    proj = torch.cos(torch.arange(kn.shape[-1], device=kn.device, dtype=kn.dtype))
    (g,) = torch.autograd.grad(torch.sum(kn * proj), eigs)
    return kn.detach(), g


@pytest.mark.parametrize("case,switch", [("1d", "USE_RADIX_FFT"), ("3d", "USE_MXU3D_PCG")])
def test_kernel_path_switch_routes_to_the_plain_path(dev, monkeypatch, case, switch):
    # with the switch off, the f32 CUDA whitening takes the plain path: no
    # kernel launch, and a gradient with respect to the spectrum that
    # matches the f64 plain path (<= 1e-3 relative: f32 rounding of a
    # well-conditioned 20-iteration solve); with it on, the kernel path's
    # gradient (the radix apply's or B-5's backward) matches it too
    spec, b = _switch_case(case, dev, torch.float32)
    spec64, b64 = _switch_case(case, dev, torch.float64)
    kn64, g64 = _whiten_eigs_grad(spec64, b64)
    ok = solve._planes_solver_ok if case == "1d" else solve._mxu3d_solver_ok
    assert getattr(bttb, switch) and ok(spec, torch.float32, dev)
    before = dict(radix_fft.LAUNCHES)
    knk, gk = _whiten_eigs_grad(spec, b)
    torch.cuda.synchronize()
    if case == "1d":
        assert radix_fft.LAUNCHES["middle_wgrad"] == before["middle_wgrad"] + 2
    assert _rel(knk, kn64) <= 1e-3 and _rel(gk, g64) <= 1e-3
    monkeypatch.setattr(bttb, switch, False)
    assert not ok(spec, torch.float32, dev)
    if case == "1d":
        assert not bttb._radix_apply_ok(spec, torch.float32, dev)
    counters = (radix_fft.LAUNCHES, mxu2d.LAUNCHES, mxu3d.LAUNCHES)
    before = [dict(c) for c in counters]
    kn32, g32 = _whiten_eigs_grad(spec, b)
    torch.cuda.synchronize()
    assert [dict(c) for c in counters] == before
    assert bool(torch.isfinite(g32).all())
    assert _rel(kn32, kn64) <= 1e-3 and _rel(g32, g64) <= 1e-3



def _fb_data():
    from hipgp_tpu_torch.experiments.synthetic_data import make_two_dim_data

    return make_two_dim_data(Nobs=600, Ntest=10, noise_std=0.05, gridnum=8, seed=1)


def _fb_model(dtype, device, grid=24):
    from hipgp_tpu_torch.experiments.run_synthetic import build_model

    d = _fb_data()
    return build_model("SqExp", grid, 600, float(np.var(d["yobs"])), 0.1, 0.05,
                       dtype=dtype, device=device), d


@pytest.mark.parametrize("solver", ["gram", "dense"])
def test_batch_solve_on_the_card_matches_the_cpu_plain_path(dev, solver):
    # the closed-form fit on a 24^2 grid (embedded 46^2), 600 rows in 3
    # batches: the f32 kernel path on the card against the f64 plain path on
    # the CPU, the whitening run to its tolerance (maxiter_cg 100) and the
    # mean solve converged; theta1 within the f32 whitening's 5e-3, the
    # ELBO within 1e-4 ([accuracy-full-batch]'s limits)
    kw = dict(batch_size=200, maxiter_cg=100, mean_solver=solver,
              mean_solver_maxiter=3000, mean_solver_tol=1e-10, compute_elbo=True)
    out = {}
    for dtype, device in ((torch.float32, dev), (torch.float64, "cpu")):
        m, d = _fb_model(dtype, device)
        st, elbo = m.batch_solve(m.init_state(), d["xobs"], d["yobs"], d["sobs"], **kw)
        out[device == "cpu"] = (st, float(elbo))
    (s32, e32), (s64, e64) = out[False], out[True]
    assert bool(torch.isfinite(s32.theta1).all()) and np.isfinite(e32)
    assert _rel(s32.theta2.cpu(), s64.theta2) <= 1e-4
    assert _rel(s32.theta1.cpu(), s64.theta1) <= 5e-3
    assert abs(e32 - e64) <= 1e-4 * abs(e64)


@pytest.mark.parametrize("solver", ["gram", "dense", "cg"])
def test_batch_solve_kernel_a_launches(dev, solver):
    # every batch of the sweep is one whitening solve through kernel A:
    # 1 + 2k self-dots (k from PCG_STATS) and one R^T; 'dense' whitens the
    # data again for the ELBO, 'cg' reuses its stacked kn
    m, d = _fb_model(torch.float32, dev)
    mxu2d.reset_launches()
    solve.PCG_STATS.update(solves=0, iterations=0)
    m.batch_solve(m.init_state(), d["xobs"], d["yobs"], d["sobs"], batch_size=200,
                  maxiter_cg=10, mean_solver=solver, compute_elbo=True)
    torch.cuda.synchronize()
    st = dict(solve.PCG_STATS)
    assert st["solves"] == (6 if solver == "dense" else 3)
    assert dict(mxu2d.LAUNCHES) == {
        "sandwich_apply_selfdot": st["solves"] + 2 * st["iterations"],
        "sandwich_apply": st["solves"], "sandwich_apply_wp": 0,
        "sandwich_apply_wp_selfdot": 0}


def test_batch_solve_factored_on_the_card(dev):
    # 'factored' on a 16^2 grid (kappa 48, inside the float32 trust region),
    # 600 rows in 3 batches: the f32 kernel path against the f64 plain path on
    # the card, both whitenings at maxiter_cg 100 and the mean converged; the
    # factor's 256 rows are one g-stage solve through kernel A and the sweep
    # whitens nothing; no fallback.  Limits: the f32 factored solve's own
    # error, 4e-4 on the CPU at this grid with factor_jitter 1e-4 (the JAX
    # package's float32 jitter) against 1e-10
    import warnings

    from hipgp_tpu_torch.models.hipgp import FACTORED_STATS

    kw = dict(batch_size=200, maxiter_cg=100, mean_solver="factored",
              mean_solver_maxiter=3000, mean_solver_tol=1e-10, compute_elbo=True)
    out = {}
    for dtype in (torch.float32, torch.float64):
        m, d = _fb_model(dtype, dev, grid=16)
        mxu2d.reset_launches()
        solve.PCG_STATS.update(solves=0, iterations=0)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            st, elbo = m.batch_solve(m.init_state(), d["xobs"], d["yobs"], d["sobs"], **kw)
        torch.cuda.synchronize()
        out[dtype] = (st, float(elbo), dict(mxu2d.LAUNCHES), dict(solve.PCG_STATS))
    (s32, e32, lc, ps), (s64, e64, lc64, _) = out[torch.float32], out[torch.float64]
    assert FACTORED_STATS["kappa"] < 1e3
    assert ps["solves"] == 1
    assert lc == {"sandwich_apply_selfdot": 1 + 2 * ps["iterations"], "sandwich_apply": 1,
                  "sandwich_apply_wp": 0, "sandwich_apply_wp_selfdot": 0}
    assert not any(lc64.values())
    assert np.isfinite(e32)
    assert _rel(s32.theta2, s64.theta2) <= 5e-3
    assert _rel(s32.theta1, s64.theta1) <= 5e-3
    assert abs(e32 - e64) <= 1e-2 * abs(e64)


def test_batch_solve_matfree_3d_on_the_card(dev):
    # 'matfree' on a 16 x 16 x 8 dust-map grid (embedded (30, 30, 15): the
    # outer products and B-5), 384 line integrals in 3 batches, whitening at
    # maxiter_cg 50, the mean PCG run out: the f32 kernel path against the
    # f64 plain path on the card (theta1 <= 5e-3, ELBO <= 1e-4, as
    # [accuracy-full-batch-3d]); per sweep batch 1 + 2k self-dot applies and
    # one R^T of B-5, the mean PCG's re-sweeps launch nothing
    from hipgp_tpu_torch.experiments import run_domain

    prob = run_domain.domain_problem(384, 10, 0.1, 16, 8)
    kw = dict(batch_size=128, maxiter_cg=50, integrated_obs=True, mean_solver="matfree",
              mean_solver_maxiter=2000, mean_solver_tol=1e-10, compute_elbo=True)
    out = {}
    for dtype in (torch.float32, torch.float64):
        m = run_domain.domain_model("SqExp", prob["grids"], 384, 1.0, 0.2, dtype=dtype,
                                    device=dev)
        mxu2d.reset_launches()
        mxu3d.reset_launches()
        solve.PCG_STATS.update(solves=0, iterations=0)
        st, elbo = m.batch_solve(m.init_state(), prob["xobs"], prob["aobs"], prob["sobs"],
                                 **kw)
        torch.cuda.synchronize()
        out[dtype] = (st, float(elbo), {**mxu2d.LAUNCHES, **mxu3d.LAUNCHES},
                      dict(solve.PCG_STATS))
    (s32, e32, lc, ps), (s64, e64, lc64, _) = out[torch.float32], out[torch.float64]
    assert ps["solves"] == 3
    applies = ps["solves"] + 2 * ps["iterations"]
    assert lc == {"sandwich_apply_wp_selfdot": applies, "sandwich_apply_wp": 3,
                  "sandwich_apply_wp3": 0, "sandwich_apply": 0, "sandwich_apply_selfdot": 0}
    assert not any(lc64.values())
    assert np.isfinite(e32)
    assert _rel(s32.theta1, s64.theta1) <= 5e-3
    assert abs(e32 - e64) <= 1e-4 * abs(e64)


# ---------------------------------------------------------------------------
# the backwards of the 1-D and 3-D paths: the radix apply's (B-2, B-4 and
# radix_middle_wgrad) and kernel B-5's
# ---------------------------------------------------------------------------

# one length per B the middle takes (8, 16, 32, 64, 128 at A = 8) and the
# headline plan (128, 128, 128)
WGRAD_LENGTHS = [8192, 1 << 14, 32768, 1 << 16, 1 << 17, 1 << 21]


# V = 2 at A = 8: two clusters a ka, one plane pair each; V = 128 at the
# headline: the training step's 128 planes, one cluster a ka
@pytest.mark.parametrize("L,V", [(L, V) for L in WGRAD_LENGTHS for V in (1, 2, 3, 40)]
                         + [(1 << 21, 128)])
def test_radix_middle_wgrad_matches_plain(dev, L, V):
    # radix_middle_wgrad (V split over clusters or not) against its plain
    # version in f32 and f64 on the same inputs: <= 1e-5 (f32 rounding of
    # the two forward halves and the sum over v); a second call bit-equal
    p32, p64 = _plans(L, dev)
    shape = (V, p32.A, p32.B, p32.C)
    x = _randn((4,) + shape, dev, L + V)
    x32 = x.float()
    before = radix_fft.LAUNCHES["middle_wgrad"]
    got = radix_fft.middle_wgrad(*x32, p32)
    again = radix_fft.middle_wgrad(*x32, p32)
    assert radix_fft.LAUNCHES["middle_wgrad"] == before + 2
    want32 = radix_fft.middle_wgrad_plain(*x32, p32)
    want64 = radix_fft.middle_wgrad_plain(*x, p64)
    torch.cuda.synchronize()
    assert got.shape == shape[1:] and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert _rel(got, want32) <= 1e-5 and _rel(got, want64) <= 1e-5


@pytest.mark.parametrize("L,V", [(8192, 3), (8192, 40), (1 << 21, 2)])
def test_radix_middle_wgrad_scratch_is_only_the_partials(dev, L, V):
    # no spectrum goes to device memory: a call allocates dbar and, where a
    # ka's planes are split over clusters, the splits' partial sums, nothing
    # else
    p32, _ = _plans(L, dev)
    x32 = _randn((4, V, p32.A, p32.B, p32.C), dev, L).float()
    radix_fft.middle_wgrad(*x32, p32)   # the plan table, built once a plan
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = radix_fft.wgrad_splits(V, p32.A, sms)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = radix_fft.middle_wgrad(*x32, p32)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(dev) - base
    assert extra == 4 * L * (1 + (splits if splits > 1 else 0))
    assert out.shape == (p32.A, p32.B, p32.C)


def test_radix_middle_wgrad_refuses_unaligned_planes(dev):
    # the planes' real parts arrive by bulk copies: x and g start 16-byte
    # aligned, or the wrapper raises before a launch
    p32, _ = _plans(8192, dev)
    n = 2 * p32.L
    buf = torch.randn((4 * n + 1,), device=dev)
    x = [buf[1 + k * n:1 + (k + 1) * n].view(2, p32.A, p32.B, p32.C) for k in range(4)]
    before = radix_fft.LAUNCHES["middle_wgrad"]
    with pytest.raises(ValueError):
        radix_fft.middle_wgrad(*x, p32)
    assert radix_fft.LAUNCHES["middle_wgrad"] == before


@pytest.mark.parametrize("L,rows", MAIN_PATH_CROPS)
@pytest.mark.parametrize("crop", ["R^T", "full"])
def test_radix_apply_backward_matches_plain(dev, L, rows, crop):
    # the radix apply's VJP on the card (gx: B-2, B-4, B-2 with the crops
    # swapped; gd: two B-2 forwards and radix_middle_wgrad) at the planes
    # path's R^T crop (rows -> A) and uncropped (the dK term's apply)
    # against the same Function on the CPU in f64 with the plain stages:
    # <= 1e-5 each; launches exact
    p32 = radix_fft.make_plan(L, torch.float32, dev)
    p64 = radix_fft.make_plan(L, torch.float64, "cpu")
    A, N, V = p32.A, p32.B * p32.C, 3
    in_rows = rows if crop == "R^T" else A
    rng = np.random.default_rng(L + rows)
    x = rng.standard_normal((2, V, in_rows * N))
    c = rng.standard_normal((2, V, A * N))
    d = radix_fft.permute_weights(_even_spectrum(L, "cpu", L) / L, p64)

    def grads(dt, where, plan):
        xr, xi = (torch.as_tensor(a, dtype=dt, device=where).requires_grad_() for a in x)
        dp = d.to(dtype=dt, device=where).contiguous().requires_grad_()
        yr, yi = radix_fft.fused_circulant_apply_cropped(xr, xi, dp, plan, in_rows, A)
        cr, ci = (torch.as_tensor(a, dtype=dt, device=where) for a in c)
        return torch.autograd.grad(torch.sum(yr * cr + yi * ci), (xr, xi, dp))

    before = dict(radix_fft.LAUNCHES)
    g32 = grads(torch.float32, dev, p32)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in radix_fft.LAUNCHES.items() if v != before[k]}
    assert moved == {"stage1": 6, "middle": 2, "middle_wgrad": 1}
    g64 = grads(torch.float64, "cpu", p64)
    for got, want in zip(g32, g64):
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        assert _rel(got.cpu(), want) <= 1e-5


@pytest.mark.parametrize("mode", ["out_expanded", "in_expanded", "cropped"])
def test_wp_backward_matches_plain(dev, mode):
    # B-5's VJP on the card (gx: B-5 with the crops swapped; gw: the
    # per-plane analysis product summed over b, plain PyTorch in full FP32)
    # at the dust map's R^T shapes with 16 samples, against the same
    # Function on the CPU in f64: <= 1e-5 each; gx one B-5 launch
    _, w = _spectrum_3d(dev)
    w = torch.sqrt(w).contiguous()
    W, inner, einner = EDIMS_3D[0], DIMS_3D[1:], EDIMS_3D[1:]
    in_exp, out_exp = mode == "in_expanded", mode == "out_expanded"
    i_shape = einner if in_exp else inner
    o_shape = einner if out_exp else inner
    rng = np.random.default_rng(len(mode))
    x = rng.standard_normal((16, W) + i_shape)
    c = rng.standard_normal((16, W) + o_shape)

    def grads(where, dt):
        tx = torch.as_tensor(x, dtype=dt, device=where).requires_grad_()
        tw = w.to(dtype=dt, device=where).requires_grad_()
        y = mxu2d.sandwich_apply_wp(tx, tw, inner, einner, in_expanded=in_exp,
                                    out_expanded=out_exp)
        return torch.autograd.grad(torch.sum(y * torch.as_tensor(c, dtype=dt, device=where)),
                                   (tx, tw))

    before = mxu2d.LAUNCHES["sandwich_apply_wp"]
    g32 = grads(dev, torch.float32)
    torch.cuda.synchronize()
    assert mxu2d.LAUNCHES["sandwich_apply_wp"] == before + 2
    g64 = grads("cpu", torch.float64)
    for got, want in zip(g32, g64):
        assert got.shape == want.shape
        assert _rel(got.cpu(), want) <= 1e-5


def _learn_step_model(case, dev):
    """A learn-kernel, learn-noise model in f32 on the card and one
    minibatch: the 1-D section 5.2 operator at M = 131 072 (Matern-5/2, sig2
    0.1, ell one grid spacing; the planes path's smallest size) with 64
    noisy point observations of a sine, or the integrated dust-map model on
    a 16 x 16 x 8 grid (SqExp, ell 0.2) with 64 line integrals."""
    from hipgp_tpu_torch.experiments import run_domain
    from hipgp_tpu_torch.models import HIPGP

    rng = np.random.default_rng(3)
    if case == "1d":
        M = 131072
        x = rng.uniform(0.0, 1.0, (64, 1))
        y = np.sin(12.0 * x[:, 0]) + 0.1 * rng.standard_normal(64)
        model = HIPGP(Matern(2.5), [np.linspace(0.0, 1.0, M)], num_obs=64,
                      sig2_init=0.1, ell_init=1.0 / M, noise2_init=0.01, jitter=1e-3,
                      learn_kernel=True, learn_noise=True, device=dev)
    else:
        from hipgp_tpu_torch.kernels import SqExp

        x, y, _, _, _ = run_domain.make_synthetic_domain_data(64, 0.1)
        grids = [np.linspace(-1.0, 1.0, n) for n in (16, 16, 8)]
        model = HIPGP(SqExp(), grids, num_obs=64, sig2_init=0.5, ell_init=0.2,
                      noise2_init=0.01, jitter=1e-3, learn_kernel=True, learn_noise=True,
                      support_integrated_obs=True, device=dev)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    return model, t(x), t(y)


@pytest.mark.parametrize("case,switch", [("1d", "USE_RADIX_FFT"), ("3d", "USE_MXU3D_PCG")])
def test_learn_kernel_step_matches_the_plain_path(dev, monkeypatch, case, switch):
    # one elbo_and_grads with compute_hyper_grads on the kernel path (the
    # planes PCG or the 3-D fused PCG, the R^T and its backward through
    # the radix kernels or B-5, the dK term through radix_middle_wgrad on
    # 1-D) against the same step with the switch off (the plain path, no
    # launch), both f32: each hyper-gradient within 1e-3 relative
    model, x, y = _learn_step_model(case, dev)
    state = model.init_state()
    kw = dict(maxiter_cg=10, integrated_obs=case == "3d", compute_hyper_grads=True)
    counters = (radix_fft.LAUNCHES, mxu2d.LAUNCHES, mxu3d.LAUNCHES)
    out = {}
    for on in (True, False):
        monkeypatch.setattr(bttb, switch, on)
        before = [dict(c) for c in counters]
        elbo, g = model.elbo_and_grads(state, x, y, None, **kw)
        torch.cuda.synchronize()
        moved = [{k: v - b[k] for k, v in c.items() if v != b[k]}
                 for c, b in zip(counters, before)]
        out[on] = (float(elbo), [float(getattr(g, k)) for k in
                                 ("log_sig2", "log_ell", "log_noise2")])
        if not on:
            assert moved == [{}, {}, {}]
        elif case == "1d":
            assert moved[0]["middle_wgrad"] == 2
        else:
            assert moved[1]["sandwich_apply_wp"] == 2   # R^T and its pullback
    (e1, g1), (e0, g0) = out[True], out[False]
    assert np.isfinite(e1) and abs(e1 - e0) <= 1e-3 * abs(e0)
    for a, b in zip(g1, g0):
        assert np.isfinite(a) and abs(a - b) <= 1e-3 * abs(b), (g1, g0)


def test_resume_round_trip_on_the_card(dev, tmp_path):
    # fit resume through the kernel path: a 2-D learn-kernel, learn-noise
    # fit (M = 32^2, 1 024 rows, batch 128, the warm start, schedule_lr)
    # of two epochs without a break, against one epoch with a checkpoint
    # and a resume for the second: state, hypers and the second epoch's
    # ELBO trace within 1e-5 relative; the resumed epoch launches kernel A
    # (2 (1 + 2k) self-dots, one R^T and one pullback a step)
    from hipgp_tpu_torch.experiments.run_synthetic import build_model, marginal_sig2
    from hipgp_tpu_torch.experiments.synthetic_data import make_two_dim_data
    from hipgp_tpu_torch.infer import FitConfig, svigp_fit

    d = make_two_dim_data(Nobs=1024, Ntest=10, noise_std=0.01, gridnum=32, seed=42)
    sig2 = marginal_sig2(d["yobs"], d["sobs"])
    model = build_model("SqExp", 32, 1024, sig2, 0.05, 0.01, dtype=torch.float32, device=dev)
    st0 = model.init_state()
    cfg = FitConfig(epochs=2, batch_size=128, lr=1e-2, maxiter_cg=5, learn_kernel=True,
                    learn_noise=True)
    data = (d["xobs"], d["yobs"], d["sobs"])
    full, frep = svigp_fit(model, st0, *data, cfg, verbose=False, theta2_warmstart=True)
    cdir = str(tmp_path / "ckpt")
    svigp_fit(model, st0, *data, dataclasses.replace(cfg, epochs=1), verbose=False,
              checkpoint_dir=cdir, checkpoint_every=1, theta2_warmstart=True)
    before = dict(mxu2d.LAUNCHES)
    res, rrep = svigp_fit(model, st0, *data, cfg, verbose=False, checkpoint_dir=cdir,
                          resume=True, theta2_warmstart=True)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in mxu2d.LAUNCHES.items()}
    assert rrep["steps"] == 8 and rrep["natgrad_rho"] is None
    for f in ("theta1", "theta2", "log_sig2", "log_ell", "log_noise2"):
        assert _rel(getattr(res, f), getattr(full, f)) <= 1e-5, f
    want = np.asarray(frep["elbo_trace"][8:])
    assert np.max(np.abs(np.asarray(rrep["elbo_trace"]) - want) / np.abs(want)) <= 1e-5
    assert moved["sandwich_apply_selfdot"] == 8 * 2 * (1 + 2 * 5)
    assert moved["sandwich_apply"] == 8 * 2


@pytest.mark.parametrize("method", ["sph", "cic"])
def test_deposit_on_the_card_matches_the_cpu_path(dev, method):
    # 50 000 particles (h 0.3-3 cells, log-normal) onto 32 x 32 x 16 cells:
    # the card's float32 deposition against the same function in float64 on
    # the CPU, every cell within 1e-4 of the largest, the sums within 1e-5
    from hipgp_tpu_torch.experiments import dust_density as dd

    rng = np.random.default_rng(3)
    n, dims = 50_000, (32, 32, 16)
    left, right = np.array([-1.0, -1.0, -0.5]), np.array([1.0, 1.0, 0.5])
    cell = (right - left) / np.array(dims)
    pos = rng.uniform(left + cell, right - cell, (n, 3))
    vals, m, rho = rng.uniform(0.5, 2, n), rng.uniform(0.5, 1.5, n), rng.uniform(0.5, 1.5, n)
    hs = np.clip(np.exp(rng.normal(0.0, 0.6, n)), 0.3, 3.0) * cell.min()
    if method == "sph":
        run = lambda **kw: dd.sph_deposit(pos, vals, m, rho, hs, left, right, dims,
                                          chunk=8192, **kw)
    else:
        run = lambda **kw: dd.cic_deposit(pos, m, left, right, dims, chunk=8192, **kw)
    got = run(device=dev)
    want = run(device="cpu", dtype=torch.float64)
    assert got.dtype == np.float32 and got.shape == dims
    assert float(np.max(np.abs(got - want))) <= 1e-4 * float(want.max())
    assert abs(float(got.sum(dtype=np.float64)) / float(want.sum()) - 1) <= 1e-5
