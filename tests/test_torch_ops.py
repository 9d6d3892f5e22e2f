"""Parity of the PyTorch port's ops (hipgp_tpu_torch.ops) with the JAX package.

Both packages get the same float64 inputs, made with numpy from a seed, on
the CPU.  The JAX side runs as its own tests run it here: the Pallas sandwich
kernel in interpret mode, the solves through the generic `pcg` path.  The
port's sandwich wrapper takes its plain PyTorch version for CPU tensors.
"""
import subprocess
import sys
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu.ops import bttb as jbttb
from hipgp_tpu.ops import cg as jcg
from hipgp_tpu.ops import mxu2d as jmxu2d
from hipgp_tpu.ops import solve as jsolve
from hipgp_tpu_torch.ops import bttb as tbttb
from hipgp_tpu_torch.ops import cg as tcg
from hipgp_tpu_torch.ops import mxu2d as tmxu2d
from hipgp_tpu_torch.ops import solve as tsolve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kfun_jax(ell):
    return lambda a, b: jnp.exp(
        -0.5 * jnp.sum(((a[:, None, :] - b[None, :, :]) / ell) ** 2, -1))


def _kfun_torch(ell):
    return lambda a, b: torch.exp(
        -0.5 * torch.sum(((a[:, None, :] - b[None, :, :]) / ell) ** 2, -1))


def _specs(dims, ell=0.07, lo=0.0, hi=1.0):
    grids = [np.linspace(lo, hi, m) for m in dims]
    js = jbttb.make_spectrum([jnp.asarray(g) for g in grids], _kfun_jax(ell),
                             jitter=1e-3)
    ts = tbttb.make_spectrum([torch.as_tensor(g) for g in grids],
                             _kfun_torch(ell), jitter=1e-3)
    return js, ts


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.array(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("dims", [(1,), (2,), (7,), (16,), (40,), (125,),
                                  (260,), (300, 5), (12, 9), (125, 125),
                                  (3, 4, 5)])
def test_embedded_dims_verbatim(dims):
    # exact integer rules: they fix M' and the whitened layout
    assert tbttb.expanded_dims(dims) == jbttb.expanded_dims(dims)
    assert tbttb.embedded_dims(dims) == jbttb.embedded_dims(dims)
    for m in (1, 2, 3, 4):
        assert tbttb.embedded_dims(dims, (m,) * len(dims)) == \
            jbttb.embedded_dims(dims, (m,) * len(dims))


@pytest.mark.parametrize("n", [1, 2, 7, 11, 97, 248, 511, 1000, 4097])
def test_next_fast_len_verbatim(n):
    assert tbttb.next_fast_len(n) == jbttb.next_fast_len(n)
    assert tbttb.next_fast_len(n, 4) == jbttb.next_fast_len(n, 4)


@pytest.mark.parametrize("dims", [(12, 9), (16, 16), (32, 32)])
def test_spectrum_matches_jax(dims):
    # same kernel values, same FFT sizes: agreement to float64 rounding
    js, ts = _specs(dims)
    assert ts.dims == js.dims and ts.edims == js.edims
    np.testing.assert_allclose(_np(ts.column), _np(js.column), rtol=1e-13, atol=0)
    np.testing.assert_allclose(_np(ts.ecolumn), _np(js.ecolumn), rtol=1e-13, atol=0)
    np.testing.assert_allclose(_np(ts.eigs), _np(js.eigs), rtol=1e-10, atol=1e-12)


def test_toeplitz_column_and_circulant_embed_match_jax():
    # the unpadded column and its mirror extension: the same kernel values
    grids = [np.linspace(0.0, 1.0, m) for m in (9, 6)]
    jcol = jbttb.toeplitz_column([jnp.asarray(g) for g in grids], _kfun_jax(0.1))
    tcol = tbttb.toeplitz_column([torch.as_tensor(g) for g in grids], _kfun_torch(0.1))
    np.testing.assert_allclose(_np(tcol), _np(jcol), rtol=1e-14, atol=0)
    temb = tbttb.circulant_embed(tcol)
    assert temb.shape == (16, 10)
    np.testing.assert_array_equal(_np(temb), _np(jbttb.circulant_embed(jnp.asarray(_np(tcol)))))


def test_spectrum_clamps_and_matches_dense_gram():
    # the top-left M x M block of the circulant is the dense Gram, and the
    # clamp floor is the JAX package's 1e-6
    dims = (10, 8)
    grids = [torch.linspace(0.0, 1.0, m, dtype=torch.float64) for m in dims]
    ts = tbttb.make_spectrum(grids, _kfun_torch(0.08), jitter=1e-3)
    assert float(ts.eigs.min()) >= tbttb.DEFAULT_EIG_FLOOR
    K = tbttb.dense_gram(grids, _kfun_torch(0.08), jitter=1e-3)
    v = torch.as_tensor(np.random.default_rng(3).standard_normal((4, ts.M)))
    got = tbttb.matmul_by_K(ts, v)
    np.testing.assert_allclose(_np(got), _np(v @ K), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("op", ["matmul_by_K", "matmul_by_RT", "matmul_by_Cinv"])
def test_matvecs_match_jax(op):
    # the same real-basis einsum chain in both packages: float64 rounding
    js, ts = _specs((12, 9))
    rng = np.random.default_rng(1)
    v = rng.standard_normal((5, ts.M))
    got = getattr(tbttb, op)(ts, torch.as_tensor(v))
    want = getattr(jbttb, op)(js, jnp.asarray(v))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-11, atol=1e-12)


def test_fft_path_matches_matmul_path(monkeypatch):
    # above MATMUL_DFT_MAX_LEN the port uses torch.fft; it is the same
    # operator as the real-basis chain (checked here by forcing the switch)
    _, ts = _specs((12, 9))
    v = torch.as_tensor(np.random.default_rng(2).standard_normal((3, ts.M)))
    want = tbttb.matmul_by_K(ts, v)
    want_rt = tbttb.matmul_by_RT(ts, v)
    monkeypatch.setattr(tbttb, "MATMUL_DFT_MAX_LEN", 1)
    np.testing.assert_allclose(_np(tbttb.matmul_by_K(ts, v)), _np(want),
                               rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(_np(tbttb.matmul_by_RT(ts, v)), _np(want_rt),
                               rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("dims", [(12, 9), (16, 16)])
@pytest.mark.parametrize("mode", ["cropped", "out_expanded", "in_expanded",
                                  "selfdot"])
def test_plain_sandwich_matches_pallas_interpret(dims, mode):
    # the plain sandwich against the Pallas kernel in interpret mode (f64
    # dots at HIGHEST there): the same four contractions in another order,
    # so agreement is to a few float64 ulps of the DFT sums (<= 1e-10)
    js, ts = _specs(dims)
    w = _np(jbttb._full_weights(js.eigs, js.edims[-1]))
    if mode == "out_expanded":
        w = np.sqrt(w)
    rng = np.random.default_rng(4)
    in_exp = mode == "in_expanded"
    shape = ts.edims if in_exp else ts.dims
    x = rng.standard_normal((6,) + tuple(shape))
    kw = dict(in_expanded=in_exp, out_expanded=mode == "out_expanded")
    if mode == "selfdot":
        y, dots = tmxu2d.sandwich_apply_selfdot(torch.as_tensor(x), torch.as_tensor(w),
                                                ts.dims, ts.edims)
        jy, jdots = jmxu2d.sandwich_apply_selfdot(jnp.asarray(x), jnp.asarray(w),
                                                  js.dims, js.edims, interpret=True)
        assert _rel(dots, jdots) <= 1e-10
    else:
        y = tmxu2d.sandwich_apply(torch.as_tensor(x), torch.as_tensor(w),
                                  ts.dims, ts.edims, **kw)
        jy = jmxu2d.sandwich_apply(jnp.asarray(x), jnp.asarray(w), js.dims,
                                   js.edims, interpret=True, **kw)
    assert y.shape == jy.shape
    assert _rel(y, jy) <= 1e-10


def test_sandwich_wrappers_check_shapes():
    _, ts = _specs((12, 9))
    w = tbttb._full_weights(ts.eigs, ts.edims[-1])
    with pytest.raises(ValueError):
        tmxu2d.sandwich_apply(torch.zeros((2, 9, 12), dtype=torch.float64), w,
                              ts.dims, ts.edims)
    with pytest.raises(ValueError):
        tmxu2d.sandwich_apply_selfdot(torch.zeros((2, 12, 9), dtype=torch.float64),
                                      w[:, :-1], ts.dims, ts.edims)


def test_plain_sandwich_counts_no_launch():
    # a CPU call takes the plain version: the kernel counters stay put
    _, ts = _specs((12, 9))
    w = tbttb._full_weights(ts.eigs, ts.edims[-1])
    before = dict(tmxu2d.LAUNCHES)
    tmxu2d.sandwich_apply_selfdot(torch.zeros((2, 12, 9), dtype=torch.float64), w,
                                  ts.dims, ts.edims)
    assert tmxu2d.LAUNCHES == before


def test_solver_gate_takes_kernel_path_only_on_cuda_f32():
    _, ts = _specs((12, 9))
    assert not tsolve._mxu2d_solver_ok(ts, torch.float32, torch.device("cpu"))
    assert tsolve._mxu2d_solver_ok(ts, torch.float32, torch.device("cuda"))
    assert not tsolve._mxu2d_solver_ok(ts, torch.float64, torch.device("cuda"))


@pytest.mark.parametrize("fixed_iters", [True, False])
def test_pcg_matches_jax(fixed_iters):
    # identical update order and guards; float64 rounding only
    js, ts = _specs((14, 11), ell=0.05)
    b = np.random.default_rng(5).standard_normal((4, ts.M))
    tmv = lambda v: tbttb.matmul_by_K(ts, v)
    tpc = lambda v: tbttb.matmul_by_Cinv(ts, v)
    jmv = lambda v: jbttb.matmul_by_K(js, v)
    jpc = lambda v: jbttb.matmul_by_Cinv(js, v)
    if fixed_iters:
        got = tcg.pcg_scan(tmv, torch.as_tensor(b), precond=tpc, num_iters=15)
        want = jcg.pcg_scan(jmv, jnp.asarray(b), precond=jpc, num_iters=15)
    else:
        res = tcg.pcg_result(tmv, torch.as_tensor(b), precond=tpc, maxiter=200,
                             tol=1e-9)
        jres = jcg.pcg_result(jmv, jnp.asarray(b), precond=jpc, maxiter=200,
                              tol=1e-9)
        assert res.iters == int(jres.iters) < 200
        got, want = res.x, jres.x
    assert _rel(got, want) <= 1e-9


@pytest.mark.parametrize("fixed_iters", [True, False])
def test_fused_sandwich_pcg_matches_jax_fused_pcg(fixed_iters):
    # the port of _fused_sandwich_pcg (plain sandwich on the CPU) against the
    # JAX fused PCG with the Pallas kernel in interpret mode
    js, ts = _specs((14, 11), ell=0.05)
    wK = _np(jbttb._full_weights(js.eigs, js.edims[-1]))
    b = np.random.default_rng(6).standard_normal((4,) + ts.dims)
    tsolve.PCG_STATS.update(solves=0, iterations=0)
    got = tsolve._mxu2d_pcg(torch.as_tensor(b), torch.as_tensor(wK),
                            torch.as_tensor(1.0 / wK), ts.dims, ts.edims, 12,
                            1e-12, fixed_iters)
    want = jsolve._mxu2d_pcg(jnp.asarray(b), jnp.asarray(wK), jnp.asarray(1.0 / wK),
                             js.dims, js.edims, 12, 1e-12, fixed_iters)
    # the early exit (all ||r|| < tol) fires before 12 iterations here
    assert tsolve.PCG_STATS["solves"] == 1
    assert (tsolve.PCG_STATS["iterations"] == 12 if fixed_iters
            else 0 < tsolve.PCG_STATS["iterations"] < 12)
    assert _rel(got, want) <= 1e-9


@pytest.mark.parametrize("dims", [(16, 16), (20, 12)])
def test_whiten_matches_jax(dims):
    # JAX whiten on the CPU takes the generic pcg path; the port's CPU path
    # is the same algorithm: float64 rounding of 10 PCG iterations (<= 1e-8)
    js, ts = _specs(dims, ell=0.06, lo=-1.0, hi=1.0)
    knm = np.random.default_rng(7).standard_normal((8, ts.M))
    got = tsolve.whiten(ts, torch.as_tensor(knm), maxiter=10)
    want = jsolve.whiten(js, jnp.asarray(knm), maxiter=10)
    assert got.shape == (8, ts.Mprime)
    assert _rel(got, want) <= 1e-8


def test_kernel_path_solver_matches_plain_path_on_cpu():
    # the kernel-path solver (fused PCG + sandwich R^T), run with the plain
    # sandwich on the CPU, equals the plain path's whiten
    _, ts = _specs((16, 16), ell=0.06)
    knm = torch.as_tensor(np.random.default_rng(8).standard_normal((5, ts.M)))
    d = tsolve._mxu2d_solver(ts, knm, 10, 1e-8, False)
    got = tsolve._rt_mxu2d(ts, d)
    want = tsolve.whiten(ts, knm, maxiter=10)
    assert _rel(got, want) <= 1e-9


def test_port_imports_no_jax():
    # every module of the package, found by walking it, and the chip script,
    # import neither JAX nor the JAX package, nor pandas or matplotlib
    code = ("import importlib, pkgutil, sys, hipgp_tpu_torch;"
            "mods = [m.name for m in pkgutil.walk_packages("
            "hipgp_tpu_torch.__path__, 'hipgp_tpu_torch.')];"
            "[importlib.import_module(m) for m in mods];"
            "import chip_smoke;"
            "assert 'hipgp_tpu_torch.ops.radix_fft' in mods, mods;"
            "assert 'hipgp_tpu_torch.experiments.run_pcg_vs_cholesky' in mods, mods;"
            "new = {'hipgp_tpu_torch.kernels.interdomain', 'hipgp_tpu_torch.ops.mxu3d',"
            " 'hipgp_tpu_torch.experiments.run_domain',"
            " 'hipgp_tpu_torch.experiments.profile_domain_step',"
            " 'hipgp_tpu_torch.ops.bidiag', 'hipgp_tpu_torch.ops.tridiag',"
            " 'hipgp_tpu_torch.ops.toeplitz_dense',"
            " 'hipgp_tpu_torch.experiments.run_solve_kn',"
            " 'hipgp_tpu_torch.experiments.preconditioner_analysis',"
            " 'hipgp_tpu_torch.experiments.dust_density',"
            " 'hipgp_tpu_torch.models.svgp', 'hipgp_tpu_torch.models.derivative_gp',"
            " 'hipgp_tpu_torch.kernels.derivatives', 'hipgp_tpu_torch.viz',"
            " 'hipgp_tpu_torch.utils.profiling', 'hipgp_tpu_torch.utils.naming',"
            " 'hipgp_tpu_torch.experiments.run_derivative_1d',"
            " 'hipgp_tpu_torch.experiments.natgrad_trajectory',"
            " 'hipgp_tpu_torch.experiments.precision_study',"
            " 'hipgp_tpu_torch.experiments.demo_1d',"
            " 'hipgp_tpu_torch.experiments.run_3droad',"
            " 'hipgp_tpu_torch.experiments.run_ukhousing',"
            " 'hipgp_tpu_torch.experiments.ref_compat'};"
            "assert new <= set(mods), sorted(new - set(mods));"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'hipgp_tpu', 'pandas', 'matplotlib')];"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


@pytest.mark.parametrize("fixed_iters", [False, True])
def test_inv_matmul_without_preconditioner_matches_jax(fixed_iters):
    # do_precond=False runs plain CG in both packages
    js, ts = _specs((12, 9), ell=0.15)
    b = np.random.default_rng(11).standard_normal((3, ts.M))
    kw = dict(maxiter=15, tol=1e-8, do_precond=False, fixed_iters=fixed_iters)
    got = tsolve.inv_matmul(ts, torch.as_tensor(b), **kw)
    want = jsolve.inv_matmul(js, jnp.asarray(b), **kw)
    assert _rel(got, want) <= 1e-9
    # it is not the preconditioned solve
    pre = tsolve.inv_matmul(ts, torch.as_tensor(b), maxiter=15, tol=1e-8,
                            fixed_iters=fixed_iters)
    assert _rel(got, pre) > 1e-6
    kn = tsolve.whiten(ts, torch.as_tensor(b), **kw)
    assert _rel(kn, jsolve.whiten(js, jnp.asarray(b), **kw)) <= 1e-9
