"""Parity of the port's 3-D sandwich path with the JAX package.

The weight-plane sandwich (kernel B-5's plain version), the 3-D sandwich
built on it, kernel B-6's plain version and the fused 3-D PCG solver and
R^T (`solve._mxu3d_solver`, `solve._rt_mxu3d`) run on the CPU in float64;
the JAX side runs its Pallas kernels in interpret mode.  Inputs are made
with numpy from seeds and handed to both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu.ops import bttb as jbttb
from hipgp_tpu.ops import mxu2d as jmxu2d
from hipgp_tpu.ops import mxu3d as jmxu3d
from hipgp_tpu.ops import solve as jsolve
from hipgp_tpu_torch.ops import bttb, mxu2d, mxu3d, solve

ELL = 0.07


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _grids(dims):
    return [np.linspace(-1.0, 1.0, m) for m in dims]


def _specs(dims):
    """The same SqExp spectrum (sig2 0.5, ell 0.07, jitter 1e-3) in both
    packages, float64."""
    grids = _grids(dims)
    tk = lambda a, b: 0.5 * torch.exp(
        -0.5 * torch.sum(((a[:, None, :] - b[None, :, :]) / ELL) ** 2, -1))
    jk = lambda a, b: 0.5 * jnp.exp(
        -0.5 * jnp.sum(((a[:, None, :] - b[None, :, :]) / ELL) ** 2, -1))
    tspec = bttb.make_spectrum([torch.as_tensor(g) for g in grids], tk, jitter=1e-3)
    jspec = jbttb.make_spectrum([jnp.asarray(g) for g in grids], jk, jitter=1e-3)
    return tspec, jspec


def test_spectra_agree_3d():
    tspec, jspec = _specs((8, 8, 4))
    assert tspec.edims == tuple(jspec.edims)
    np.testing.assert_allclose(_np(tspec.eigs), np.asarray(jspec.eigs), rtol=1e-10,
                               atol=1e-14)


@pytest.mark.parametrize("mode", ["cropped", "in_expanded", "out_expanded", "selfdot"])
@pytest.mark.parametrize("dims,edims", [((7, 9), (12, 16)), ((8, 8), (14, 14))])
def test_sandwich_wp_plain_matches_jax(mode, dims, edims):
    # the weight-plane sandwich on the CPU (its plain version) against JAX's
    # Pallas kernel in interpret mode, float64: <= 1e-10
    rng = np.random.default_rng(len(mode) + dims[0])
    B, W = 3, 4
    in_exp, out_exp = mode == "in_expanded", mode == "out_expanded"
    x = rng.standard_normal((B, W) + (edims if in_exp else dims))
    w = rng.uniform(0.1, 2.0, (W,) + edims)
    selfdot = mode == "selfdot"
    got = mxu2d.sandwich_apply_wp(torch.as_tensor(x), torch.as_tensor(w), dims, edims,
                                  in_expanded=in_exp, out_expanded=out_exp,
                                  selfdot=selfdot)
    want = jmxu2d.sandwich_apply_wp(jnp.asarray(x), jnp.asarray(w), dims, edims,
                                    in_expanded=in_exp, out_expanded=out_exp,
                                    interpret=True, selfdot=selfdot)
    if selfdot:
        assert _rel(got[1], want[1]) <= 1e-10
        got, want = got[0], want[0]
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-10


def test_sandwich_wp_refuses_bad_shapes():
    x = torch.zeros((2, 3, 7, 9), dtype=torch.float64)
    w = torch.ones((3, 12, 16), dtype=torch.float64)
    with pytest.raises(ValueError):
        mxu2d.sandwich_apply_wp(x[:, :, :6], w, (7, 9), (12, 16))
    with pytest.raises(ValueError):
        mxu2d.sandwich_apply_wp(x, w[:2], (7, 9), (12, 16))
    with pytest.raises(ValueError):
        mxu2d.sandwich_apply_wp(x, w, (7, 9), (12, 16), out_expanded=True,
                                selfdot=True)


@pytest.mark.parametrize("mode", ["cropped", "out_expanded", "selfdot"])
@pytest.mark.parametrize("dims", [(6, 7, 5), (8, 8, 4)])
def test_sandwich_apply_3d_matches_jax(mode, dims):
    # the 3-D sandwich (outer products + weight-plane sandwich) against JAX's
    # in interpret mode, float64: <= 1e-10
    edims = bttb.embedded_dims(dims)
    rng = np.random.default_rng(sum(dims) + len(mode))
    x = rng.standard_normal((2,) + dims)
    w = rng.uniform(0.1, 2.0, edims)
    tx, tw, jx, jw = torch.as_tensor(x), torch.as_tensor(w), jnp.asarray(x), jnp.asarray(w)
    if mode == "selfdot":
        got = mxu3d.sandwich_apply_3d_selfdot(tx, tw, dims, edims)
        want = jmxu3d.sandwich_apply_3d_selfdot(jx, jw, dims, edims, interpret=True)
        assert _rel(got[0], want[0]) <= 1e-10 and _rel(got[1], want[1]) <= 1e-10
        # the dots are the 3-D inner products <x, y>
        assert _rel(got[1], torch.sum(tx * got[0], dim=(1, 2, 3))) <= 1e-12
        return
    out_exp = mode == "out_expanded"
    got = mxu3d.sandwich_apply_3d(tx, tw, dims, edims, out_expanded=out_exp)
    want = jmxu3d.sandwich_apply_3d(jx, jw, dims, edims, out_expanded=out_exp,
                                    interpret=True)
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-10


@pytest.mark.parametrize("dims", [(6, 7, 5), (8, 8, 4)])
def test_wp3_plain_matches_jax_einsum_operators(dims):
    # kernel B-6's plain version (permuted to the kernel order) is K; the
    # 3-D sandwich with the expanded output is R^T: against JAX's einsum
    # matmul_by_K / matmul_by_RT, float64, <= 1e-10
    tspec, jspec = _specs(dims)
    perm = mxu3d.best_perm(tspec.edims)
    inv = solve._inv_perm(perm)
    pdims = tuple(dims[a] for a in perm)
    pedims = tuple(tspec.edims[a] for a in perm)
    v = np.random.default_rng(5).standard_normal((3, tspec.M))
    wK = bttb._full_weights(tspec.eigs, tspec.edims[-1]).permute(perm).contiguous()
    x = torch.as_tensor(v).reshape((3,) + dims).permute((0,) + tuple(a + 1 for a in perm))
    y, dots = mxu3d.sandwich_wp3_plain(x.contiguous(), wK, pdims, pedims, selfdot=True)
    y = y.permute((0,) + tuple(a + 1 for a in inv)).reshape(3, tspec.M)
    want = jbttb.matmul_by_K(jspec, jnp.asarray(v))
    assert _rel(y, want) <= 1e-10
    assert _rel(dots, np.sum(v * np.asarray(want), axis=1)) <= 1e-10
    # the wrapper on a CPU tensor is the plain version
    y2 = mxu3d.sandwich_apply_wp3(x.contiguous(), wK, pdims, pedims)
    assert _rel(y2.permute((0,) + tuple(a + 1 for a in inv)).reshape(3, -1), y) <= 1e-14
    rt = solve._rt_mxu3d(tspec, torch.as_tensor(v))
    assert rt.shape == (3, tspec.Mprime)
    assert _rel(rt, jbttb.matmul_by_RT(jspec, jnp.asarray(v))) <= 1e-10


def test_use_wp3_selects_the_whole_sample_path(monkeypatch):
    # with USE_WP3 a float32 self-dot apply at a shape B-6's gate admits goes
    # through B-6's wrapper (on the CPU its plain version): the same function
    # as the B-5 pipeline; a shape the gate refuses stays on the pipeline
    rng = np.random.default_rng(2)
    calls = []
    wrapped = mxu3d.sandwich_apply_wp3
    monkeypatch.setattr(mxu3d, "sandwich_apply_wp3",
                        lambda *a, **k: calls.append(1) or wrapped(*a, **k))
    for dims, edims, admitted in [((5, 13, 9), (16, 32, 32), True),
                                  ((5, 8, 8), (8, 14, 14), False)]:
        assert mxu3d._wp3_ok(dims, edims, torch.float32) == admitted
        x = torch.as_tensor(rng.standard_normal((3,) + dims), dtype=torch.float32)
        w = torch.as_tensor(rng.uniform(0.1, 2.0, edims), dtype=torch.float32)
        calls.clear()
        monkeypatch.setattr(mxu3d, "USE_WP3", False)
        pipe = mxu3d.sandwich_apply_3d_selfdot(x, w, dims, edims)
        assert not calls
        monkeypatch.setattr(mxu3d, "USE_WP3", True)
        whole = mxu3d.sandwich_apply_3d_selfdot(x, w, dims, edims)
        assert calls == ([1] if admitted else [])
        assert _rel(whole[0], pipe[0]) <= 1e-6 and _rel(whole[1], pipe[1]) <= 1e-6
        # float64 fails B-6's gate, so the pipeline carries it even then
        assert not mxu3d._wp3_ok(dims, edims, torch.float64)


def test_best_perm_and_inverse_match_jax():
    for edims in [(128, 128, 64), (14, 14, 6), (12, 12, 8), (6, 14, 14), (8, 8, 8)]:
        assert mxu3d.best_perm(edims) == jmxu3d.best_perm(edims)
        perm = mxu3d.best_perm(edims)
        assert solve._inv_perm(perm) == jsolve._inv_perm(perm)
    # the dust map's (nx, nx, nz) grid puts z outer
    assert mxu3d.best_perm((128, 128, 64)) == (2, 0, 1)


def test_mxu3d_gate():
    tspec, _ = _specs((8, 8, 4))
    assert not solve._mxu3d_solver_ok(tspec, torch.float32, "cpu")
    assert not solve._mxu3d_solver_ok(tspec, torch.float64, "cuda")
    assert solve._mxu3d_solver_ok(tspec, torch.float32, "cuda")
    flat = bttb.BTTBSpectrum(column=None, eigs=None, dims=(8, 8, 1), edims=(14, 14, 1))
    assert not solve._mxu3d_solver_ok(flat, torch.float32, "cuda")
    big = bttb.BTTBSpectrum(column=None, eigs=None, dims=(300, 8, 4), edims=(600, 14, 6))
    assert not solve._mxu3d_solver_ok(big, torch.float32, "cuda")
    planar = bttb.BTTBSpectrum(column=None, eigs=None, dims=(8, 8), edims=(14, 14))
    assert not solve._mxu3d_solver_ok(planar, torch.float32, "cuda")
    # B-6's own gate: float32, an embedding it is built for, the data in the
    # lower half of each axis, the CTA's share in one block's shared memory
    assert mxu3d._wp3_ok((32, 64, 64), (64, 128, 128), torch.float32)
    assert not mxu3d._wp3_ok((32, 64, 64), (64, 128, 128), torch.float64)
    assert not mxu3d._wp3_ok((32, 400, 64), (64, 512, 128), torch.float32)


def test_use_mxu3d_pcg_switches_the_3d_gate(monkeypatch):
    # the JAX package's USE_MXU3D_PCG: on (the default), a float32 CUDA
    # request takes the fused 3-D path; off, the plain path
    tspec, _ = _specs((8, 8, 4))
    dev = torch.device("cuda")
    assert bttb.USE_MXU3D_PCG is True
    assert solve._mxu3d_solver_ok(tspec, torch.float32, dev)
    monkeypatch.setattr(bttb, "USE_MXU3D_PCG", False)
    assert not solve._mxu3d_solver_ok(tspec, torch.float32, dev)


_SOLVES = {}


def _solves(dims, fixed_iters):
    """The port's fused 3-D PCG + R^T and JAX's (interpret mode), batch 3,
    12 iterations, cached per case."""
    key = (dims, fixed_iters)
    if key not in _SOLVES:
        tspec, jspec = _specs(dims)
        b = np.random.default_rng(11).standard_normal((3, tspec.M))
        tx = solve._mxu3d_solver(tspec, torch.as_tensor(b), 12, 1e-8, fixed_iters)
        jx = jsolve._mxu3d_solver(jspec, 12, 1e-8, fixed_iters)(None, jnp.asarray(b))
        _SOLVES[key] = (tspec, jspec, b, tx, np.asarray(jx))
    return _SOLVES[key]


@pytest.mark.parametrize("fixed_iters", [True, False])
def test_mxu3d_solver_matches_jax(fixed_iters):
    # the fused 3-D PCG called directly on the CPU (plain applies) against
    # JAX's with its interpret-mode kernel: rtol 1e-9
    _, _, _, tx, jx = _solves((8, 8, 4), fixed_iters)
    np.testing.assert_allclose(_np(tx), jx, rtol=1e-9, atol=1e-9 * np.abs(jx).max())


def test_rt_mxu3d_matches_jax():
    tspec, jspec, _, tx, jx = _solves((8, 8, 4), True)
    got = solve._rt_mxu3d(tspec, tx)
    want = np.asarray(jsolve._rt_mxu3d(jspec, jnp.asarray(jx)))
    np.testing.assert_allclose(_np(got), want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


def test_mxu3d_whiten_matches_the_plain_path():
    # the fused 3-D PCG + R^T against the plain path of the same spectrum
    # (generic PCG over the einsum matvecs, then matmul_by_RT): the same
    # operator and update order, so float64 rounding only
    tspec, _, b, tx, _ = _solves((8, 8, 4), True)
    fused = solve._rt_mxu3d(tspec, tx)
    plain = solve.whiten(tspec, torch.as_tensor(b), maxiter=12, tol=0.0,
                         fixed_iters=True)
    assert _rel(fused, plain) <= 1e-10
    stats = dict(solve.PCG_STATS)
    solve._mxu3d_solver(tspec, torch.as_tensor(b), 5, 1e-8, True)
    assert solve.PCG_STATS["solves"] == stats["solves"] + 1
    assert solve.PCG_STATS["iterations"] == stats["iterations"] + 5
