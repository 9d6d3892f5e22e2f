"""Kernel A (hipgp_tpu_torch/csrc/mxu2d.cu) against its plain PyTorch version
on a CUDA card.  Every test here needs the card and skips without one.

On the machine with the card, which has no JAX, run without the suite's
conftest (it imports JAX):
    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from hipgp_tpu_torch.ops import bttb, mxu2d, solve

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel A has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _spec(dims, dtype, dev, ell=0.07):
    grids = [torch.linspace(-1.0, 1.0, m, dtype=dtype, device=dev) for m in dims]
    kf = lambda a, b: torch.exp(
        -0.5 * torch.sum(((a[:, None, :] - b[None, :, :]) / ell) ** 2, -1))
    return bttb.make_spectrum(grids, kf, jitter=1e-3)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("dims", [(12, 9), (7, 20), (33, 17), (64, 64)])
@pytest.mark.parametrize("B", [1, 3, 70])
@pytest.mark.parametrize("mode", ["cropped", "out_expanded", "in_expanded", "selfdot"])
def test_kernel_matches_plain_f64_reference(dev, dims, B, mode):
    # f32 kernel against the plain version in f64 on the same inputs: f32
    # rounding of sums of up to L terms, well under 1e-5 relative
    spec = _spec(dims, torch.float64, dev)
    w64 = bttb._full_weights(spec.eigs, spec.edims[-1])
    if mode == "out_expanded":
        w64 = torch.sqrt(w64)
    in_exp, out_exp = mode == "in_expanded", mode == "out_expanded"
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


def test_selfdot_is_deterministic(dev):
    spec = _spec((40, 40), torch.float32, dev)
    w = bttb._full_weights(spec.eigs, spec.edims[-1]).contiguous()
    x = torch.randn((33, 40, 40), device=dev)
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
