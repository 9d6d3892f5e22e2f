"""The solver API of the PyTorch port (hipgp_tpu_torch) against the JAX
package: the x0 start of the three PCGs, pcg_trace, the tridiagonal and
bidiagonal solvers, the dense Toeplitz helpers, bttb_matvec, spectrum_from_column,
make_spectrum's eig_floor and pad_to_fast (with the kernel paths' gates on the
minimal embedding) and the normal-density helpers.  Both sides get the same
float64 inputs, made with numpy from a seed, on the CPU; each tolerance is
stated where it is asserted.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu import ops as jops
from hipgp_tpu.kernels import Matern as JMatern
from hipgp_tpu.kernels import SqExp as JSqExp
from hipgp_tpu.ops import bidiag as jbidiag
from hipgp_tpu.ops import bttb as jbttb
from hipgp_tpu.utils import stats as jstats
from hipgp_tpu_torch import ops as tops
from hipgp_tpu_torch.kernels import Matern, SqExp
from hipgp_tpu_torch.ops import bidiag as tbidiag
from hipgp_tpu_torch.ops import bttb as tbttb
from hipgp_tpu_torch.ops import solve as tsolve
from hipgp_tpu_torch.utils import stats as tstats

PARAMS = (1.0, 0.1)
JITTER = 1e-3


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _specs(dims=(12, 11), **kw):
    # the JAX test's operator (tests/test_cg_solve.py: SqExp, (1, 0.1),
    # jitter 1e-3) on the same grid in both packages
    grids = [np.linspace(0.0, 1.0, m) for m in dims]
    js = jops.make_spectrum([jnp.asarray(g) for g in grids],
                            lambda x, y: JSqExp()(x, y, PARAMS), jitter=JITTER, **kw)
    ts = tops.make_spectrum([_t(g) for g in grids],
                            lambda x, y: SqExp()(x, y, PARAMS), jitter=JITTER, **kw)
    return js, ts


def _ops(js, ts):
    j = (lambda v: jops.matmul_by_K(js, v), lambda v: jops.matmul_by_Cinv(js, v))
    t = (lambda v: tops.matmul_by_K(ts, v), lambda v: tops.matmul_by_Cinv(ts, v))
    return j, t


# ---------------------------------------------------------------------------
# PCG: the x0 start and pcg_trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["pcg", "pcg_result", "pcg_scan"])
def test_pcg_x0_start_matches_jax(solver):
    # an x0 start (r = b - A x0) at 7 iterations on the JAX test's operator:
    # x within 1e-10 relative of JAX's (float64 rounding of the same
    # iterations); pcg_result's count and residuals as JAX's; x0 = 0 gives
    # the zero start's x bit for bit; one more iteration from the 7th
    # iterate lowers the residual
    rng = np.random.default_rng(3)
    js, ts = _specs()
    (jK, jC), (tK, tC) = _ops(js, ts)
    b = rng.standard_normal((3, js.M))
    x0 = 0.1 * rng.standard_normal((3, js.M))
    if solver == "pcg_scan":
        jx = jops.pcg_scan(jK, jnp.asarray(b), jC, 7, x0=jnp.asarray(x0))
        tx = tops.pcg_scan(tK, _t(b), tC, 7, x0=_t(x0))
        zero = tops.pcg_scan(tK, _t(b), tC, 7, x0=torch.zeros(3, js.M, dtype=torch.float64))
        plain = tops.pcg_scan(tK, _t(b), tC, 7)
    else:
        kw = dict(maxiter=7, tol=1e-14)
        jr = getattr(jops, solver)(jK, jnp.asarray(b), jC, x0=jnp.asarray(x0), **kw)
        tr = getattr(tops, solver)(tK, _t(b), tC, x0=_t(x0), **kw)
        zero = getattr(tops, solver)(tK, _t(b), tC, x0=torch.zeros(3, js.M, dtype=torch.float64),
                                     **kw)
        plain = getattr(tops, solver)(tK, _t(b), tC, **kw)
        if solver == "pcg_result":
            assert tr.iters == int(jr.iters) == 7
            _close(tr.resnorm, jr.resnorm, 1e-8)
            jx, tx, zero, plain = jr.x, tr.x, zero.x, plain.x
        else:
            jx, tx = jr, tr
    assert np.linalg.norm(_np(tx) - _np(jx)) <= 1e-10 * np.linalg.norm(_np(jx))
    assert torch.equal(zero, plain)
    r7 = torch.linalg.norm(_t(b) - tK(tx))
    r8 = torch.linalg.norm(_t(b) - tK(tops.pcg_scan(tK, _t(b), tC, 1, x0=tx)))
    assert r8 < r7


@pytest.mark.parametrize("metric", ["none", "array", "dict", "x0"])
def test_pcg_trace_matches_jax(metric):
    # the JAX test's trace (tests/test_cg_solve.py: 30 iterations, the
    # circulant preconditioner): x within 1e-10 relative, the (30, bsz)
    # resnorm trace within 1e-8 relative of its first entry, the metric
    # trace within 1e-10 (max |x_k|, or a dict of RMSE and MAE against a
    # reference, stacked leaf by leaf); with x0 the same from that start;
    # the residual falls by 1e-4 as in the JAX test
    rng = np.random.default_rng(4)
    js, ts = _specs()
    (jK, jC), (tK, tC) = _ops(js, ts)
    b = rng.standard_normal((2, js.M))
    ref = rng.standard_normal((2, js.M))
    fns = {
        "none": (None, None),
        "array": (lambda xk: jnp.max(jnp.abs(xk)), lambda xk: torch.max(torch.abs(xk))),
        "dict": (lambda xk: {"rmse": jnp.sqrt(jnp.mean((xk - ref) ** 2)),
                             "mae": jnp.mean(jnp.abs(xk - ref))},
                 lambda xk: {"rmse": torch.sqrt(torch.mean((xk - _t(ref)) ** 2)),
                             "mae": torch.mean(torch.abs(xk - _t(ref)))}),
    }
    jm, tm = fns.get(metric, fns["array"])
    x0 = 0.1 * rng.standard_normal((2, js.M)) if metric == "x0" else None
    jx, jtr = jops.pcg_trace(jK, jnp.asarray(b), jC, 30, metric_fn=jm,
                             x0=None if x0 is None else jnp.asarray(x0))
    tx, ttr = tops.pcg_trace(tK, _t(b), tC, 30, metric_fn=tm,
                             x0=None if x0 is None else _t(x0))
    assert np.linalg.norm(_np(tx) - _np(jx)) <= 1e-10 * np.linalg.norm(_np(jx))
    assert ttr["resnorm"].shape == (30, 2)
    _close(ttr["resnorm"], jtr["resnorm"], 0, atol=1e-8 * float(np.max(jtr["resnorm"][0])))
    assert float(ttr["resnorm"][-1].max()) < float(ttr["resnorm"][0].max()) * 1e-4
    assert set(ttr) == set(jtr)
    if metric == "dict":
        for k in ("rmse", "mae"):
            assert ttr["metric"][k].shape == (30,)
            _close(ttr["metric"][k], jtr["metric"][k], 1e-10)
    elif tm is not None:
        assert ttr["metric"].shape == (30,)
        _close(ttr["metric"], jtr["metric"], 1e-10)


# ---------------------------------------------------------------------------
# tridiagonal and bidiagonal solvers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 12])
def test_tridiagonal_solve_matches_jax(n):
    # the JAX test's system (diag U[2, 3], off-diagonal U[-0.5, 0.5], 3
    # right-hand sides), n == 1 included: x within 1e-12 of JAX's and
    # A x = b to 1e-10
    rng = np.random.default_rng(5)
    d = rng.uniform(2.0, 3.0, (n, 3))
    c = rng.uniform(-0.5, 0.5, (n - 1, 3))
    b = rng.standard_normal((n, 3))
    tx = tops.tridiagonal_solve(_t(d), _t(c), _t(b))
    jx = jops.tridiagonal_solve(jnp.asarray(d), jnp.asarray(c), jnp.asarray(b))
    _close(tx, jx, 1e-12)
    for j in range(3):
        A = np.diag(d[:, j]) + np.diag(c[:, j], 1) + np.diag(c[:, j], -1)
        np.testing.assert_allclose(A @ _np(tx)[:, j], b[:, j], rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("J", [10, 6])
def test_bidiag_factors_match_jax(J):
    # the JAX test's full-rank run (N = 10, M = 14, J = N, 2 columns) and a
    # truncated one (J = 6): U, V, alphas, betas within 1e-10 of JAX's;
    # at J = N, A V = U B with orthonormal U and V (to 1e-8, the JAX test's
    # limits), and V's last row unwritten at k = J - 1 in both
    rng = np.random.default_rng(6)
    N, M = 10, 14
    A = rng.standard_normal((M, N))
    b = rng.standard_normal((N, 2))
    tf = tbidiag.golub_kahan_bidiag(lambda v: _t(A) @ v, lambda u: _t(A).T @ u, _t(b), J)
    jf = jbidiag.golub_kahan_bidiag(lambda v: jnp.asarray(A) @ v,
                                    lambda u: jnp.asarray(A).T @ u, jnp.asarray(b), J)
    for f in ("U", "V", "alphas", "betas"):
        _close(getattr(tf, f), getattr(jf, f), 0, atol=1e-10)
    if J == N:
        for j in range(2):
            U, V = _np(tf.U[:, :, j]).T, _np(tf.V[:, :, j]).T
            np.testing.assert_allclose(U.T @ U, np.eye(N), atol=1e-8)
            np.testing.assert_allclose(V.T @ V, np.eye(N), atol=1e-8)
            B = np.diag(_np(tf.alphas[:, j])) + np.diag(_np(tf.betas[:-1, j]), 1)
            np.testing.assert_allclose(A @ V, U @ B, atol=1e-8)


@pytest.mark.parametrize("J", [9, 5])
def test_bidiag_solve_matches_jax(J):
    # the JAX test's solve (N = 9, M = 12, one column) at J = N and
    # truncated at J = 5: c within 1e-10 relative of JAX's; at J = N, c =
    # V (B B^T)^{-1} alpha_1 ||b|| e_1 formed densely (1e-6, the JAX test's)
    rng = np.random.default_rng(7)
    N, M = 9, 12
    A = rng.standard_normal((M, N))
    b = rng.standard_normal((N, 1))
    args_t = (lambda v: _t(A) @ v, lambda u: _t(A).T @ u, _t(b), J)
    tc = tops.bidiag_solve(*args_t)
    jc = jops.bidiag_solve(lambda v: jnp.asarray(A) @ v, lambda u: jnp.asarray(A).T @ u,
                           jnp.asarray(b), J)
    assert np.linalg.norm(_np(tc) - _np(jc)) <= 1e-10 * np.linalg.norm(_np(jc))
    if J == N:
        f = tops.golub_kahan_bidiag(*args_t)
        V = _np(f.V[:, :, 0]).T
        a, be = _np(f.alphas[:, 0]), _np(f.betas[:, 0])
        off = a[1:] * be[:-1]
        BBt = np.diag(a ** 2 + be ** 2) + np.diag(off, 1) + np.diag(off, -1)
        e1 = np.zeros(N)
        e1[0] = a[0] * np.linalg.norm(b[:, 0])
        np.testing.assert_allclose(_np(tc[:, 0]), V @ np.linalg.solve(BBt, e1),
                                   rtol=1e-6, atol=1e-8)


def test_dense_toeplitz_functions_match_jax():
    # the JAX test's column and row (6 x 5): toeplitz, sym_toeplitz and
    # toeplitz_getitem equal to JAX's; toeplitz_matmul and
    # sym_toeplitz_matmul within 1e-12 of JAX's and of the dense product
    rng = np.random.default_rng(8)
    c = rng.standard_normal(6)
    r = np.concatenate([[c[0]], rng.standard_normal(4)])
    T = tops.toeplitz(_t(c), _t(r))
    np.testing.assert_array_equal(_np(T), np.asarray(jops.toeplitz(jnp.asarray(c),
                                                                    jnp.asarray(r))))
    np.testing.assert_array_equal(_np(tops.sym_toeplitz(_t(c))),
                                  np.asarray(jops.sym_toeplitz(jnp.asarray(c))))
    i, j = np.array([0, 3, 5, 1]), np.array([4, 0, 2, 1])
    np.testing.assert_array_equal(
        _np(tops.toeplitz_getitem(_t(c), _t(r), _t(i), _t(j))),
        np.asarray(jops.toeplitz_getitem(jnp.asarray(c), jnp.asarray(r), i, j)))
    assert float(tops.toeplitz_getitem(_t(c), _t(r), 4, 1)) == c[3]
    v = rng.standard_normal((3, 5))
    got = tops.toeplitz_matmul(_t(c), _t(r), _t(v))
    _close(got, jops.toeplitz_matmul(jnp.asarray(c), jnp.asarray(r), jnp.asarray(v)), 0,
           atol=1e-12)
    _close(got, v @ _np(T).T, 0, atol=1e-12)
    w = rng.standard_normal((2, 6))
    _close(tops.sym_toeplitz_matmul(_t(c), _t(w)),
           jops.sym_toeplitz_matmul(jnp.asarray(c), jnp.asarray(w)), 0, atol=1e-12)


# ---------------------------------------------------------------------------
# spectra: spectrum_from_column, make_spectrum's eig_floor and pad_to_fast
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("floor", [1e-6, 1e-2])
def test_spectrum_from_column_matches_jax(floor):
    # a Matern-5/2 column on a 9 x 7 grid at ell 0.5 (its embedding has
    # clamped eigenvalues): dims, the minimal 2m - 2 edims, the column,
    # the embedded column and the spectrum clamped to eig_floor within
    # 1e-12 of JAX's
    grids = [np.linspace(0.0, 1.0, 9), np.linspace(0.0, 1.0, 7)]
    jcol = jbttb.toeplitz_column([jnp.asarray(g) for g in grids],
                                 lambda x, y: JMatern(2.5)(x, y, (1.0, 0.5)), JITTER)
    js = jops.spectrum_from_column(jcol, floor)
    ts = tops.spectrum_from_column(_t(jcol), floor)
    assert ts.dims == js.dims == (9, 7) and ts.edims == js.edims == (16, 12)
    for f in ("column", "ecolumn", "eigs"):
        _close(getattr(ts, f), getattr(js, f), 0, atol=1e-12)
    assert float(ts.eigs.min()) == floor


@pytest.mark.parametrize("pad", [True, False])
def test_make_spectrum_floor_and_pad_match_jax(pad):
    # make_spectrum with eig_floor 1e-2 (it clamps eigenvalues of this
    # operator) with and without pad_to_fast: edims, column and spectrum
    # within 1e-12 of JAX's; K v (the cropped operator does not depend on
    # the embedding) and the whitening solve within 1e-10
    rng = np.random.default_rng(9)
    js, ts = _specs(dims=(20, 13), eig_floor=1e-2, pad_to_fast=pad)
    assert ts.edims == js.edims == ((40, 24) if pad else (38, 24))
    for f in ("column", "eigs"):
        _close(getattr(ts, f), getattr(js, f), 0, atol=1e-12)
    assert float(ts.eigs.min()) == 1e-2
    v = rng.standard_normal((2, ts.M))
    _close(tops.matmul_by_K(ts, _t(v)), jops.matmul_by_K(js, jnp.asarray(v)), 0, atol=1e-10)
    _close(tops.whiten(ts, _t(v), maxiter=15), jops.whiten(js, jnp.asarray(v), maxiter=15),
           0, atol=1e-9)


def test_minimal_embedding_gates():
    # pad_to_fast=False gives the minimal 2m - 2 embedding, which need not be
    # {2,3,5}-smooth: each kernel path's gate (asked as for float32 on a
    # CUDA device) takes it where the kernel has a plan and refuses it
    # otherwise, so the generic path runs instead.  2-D m = 38: 74 = 2 x 37
    # has no kernel-A split (refused; padded, 75 is taken); m = 36: 70 =
    # 7 x 10 (taken by kernel A, refused by the 3-D gate: B-5 needs smooth
    # lengths); 1-D m = 4097: 8192, a radix plan (the radix apply);
    # m = 131073: 262144 (the planes PCG too); m = 4500: 8998, none
    # (padded: 16384)
    cuda, f32 = torch.device("cuda"), torch.float32
    kern = lambda x, y: SqExp()(x, y, PARAMS)

    def spec(dims, pad):
        return tops.make_spectrum([torch.linspace(0.0, 1.0, m, dtype=torch.float64)
                                   for m in dims], kern, JITTER, pad_to_fast=pad)

    s = spec((38, 38), False)
    assert s.edims == (74, 74) and not tsolve._mxu2d_solver_ok(s, f32, cuda)
    assert tsolve._mxu2d_solver_ok(spec((38, 38), True), f32, cuda)
    s = spec((36, 36), False)
    assert s.edims == (70, 70) and tsolve._mxu2d_solver_ok(s, f32, cuda)
    s3 = spec((36, 5, 4), False)
    assert s3.edims == (70, 8, 6) and not tsolve._mxu3d_solver_ok(s3, f32, cuda)
    assert tsolve._mxu3d_solver_ok(spec((36, 5, 4), True), f32, cuda)
    v = types.SimpleNamespace(device=cuda, dtype=f32)   # a float32 CUDA tensor's
    saved = tbttb.USE_PALLAS_TRANSFORM
    try:
        tbttb.USE_PALLAS_TRANSFORM = True
        assert not tbttb._pallas_transform_ok(spec((38, 38), False), v)
        assert tbttb._pallas_transform_ok(spec((36, 36), False), v)
    finally:
        tbttb.USE_PALLAS_TRANSFORM = saved
    s1 = spec((4097,), False)   # the same embedding as padding gives
    assert s1.edims == spec((4097,), True).edims == (8192,)
    assert tbttb._radix_apply_ok(s1, f32, cuda)
    s1 = spec((131073,), False)
    assert s1.edims == (262144,) and tsolve._planes_solver_ok(s1, f32, cuda)
    s1 = spec((4500,), False)
    assert s1.edims == (8998,) and not tsolve._planes_solver_ok(s1, f32, cuda)
    assert not tbttb._radix_apply_ok(s1, f32, cuda)
    assert spec((4500,), True).edims == (16384,)


def test_minimal_embedding_radix_solve(monkeypatch):
    # the 1-D minimal embedding the radix gate takes (m = 4097, L = 8192):
    # its spectrum through the radix planes PCG and R^T (gates opened on
    # the CPU, the kernels' plain versions) against the generic path on the
    # same spectrum, 20 fixed iterations, float64: within 1e-10
    rng = np.random.default_rng(10)
    s = tops.make_spectrum([torch.linspace(0.0, 1.0, 4097, dtype=torch.float64)],
                           lambda x, y: Matern(2.5)(x, y, (1.0, 0.01)), JITTER,
                           pad_to_fast=False)
    b = _t(rng.standard_normal((8, 4097)))
    want = tsolve.whiten(s, b, maxiter=20, tol=0.0, fixed_iters=True)
    monkeypatch.setattr(tsolve, "_planes_solver_ok", lambda *a: True)
    monkeypatch.setattr(tbttb, "_radix_apply_ok", lambda *a: True)
    got = tsolve.whiten(s, b, maxiter=20, tol=0.0, fixed_iters=True)
    assert got.shape == (8, 8192)
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= 1e-10


@pytest.mark.parametrize("mode", ["gram", "rtv", "rv", "cinv"])
def test_bttb_matvec_matches_jax(mode):
    # the four structured matvecs by name on the JAX test's operator:
    # within 1e-12 of JAX's (the whitened space for 'rv'); an unknown name
    # raises in both
    rng = np.random.default_rng(13)
    js, ts = _specs()
    v = rng.standard_normal((2, js.Mprime if mode == "rv" else js.M))
    got = tops.bttb_matvec(ts, _t(v), mode)
    _close(got, jops.bttb_matvec(js, jnp.asarray(v), mode), 0,
           atol=1e-12 * float(np.abs(_np(got)).max()))
    with pytest.raises(ValueError, match="unknown mode"):
        tops.bttb_matvec(ts, _t(v), "kv")


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

def test_stats_helpers_match_jax():
    # normal_logpdf, normal_cdf and kl_mvn_chol on random inputs (a 7-dim
    # KL between two random SPD covariances by their Cholesky factors):
    # within 1e-12 of JAX's; KL(p || p) = 0; the inter-domain kernel's CDF
    # is this one
    rng = np.random.default_rng(12)
    y, loc, scale = rng.standard_normal(9), rng.standard_normal(9), rng.uniform(0.2, 2, 9)
    _close(tstats.normal_logpdf(_t(y), _t(loc), _t(scale)),
           jstats.normal_logpdf(jnp.asarray(y), jnp.asarray(loc), jnp.asarray(scale)), 1e-12)
    _close(tstats.normal_cdf(_t(y), _t(loc), _t(scale)),
           jstats.normal_cdf(jnp.asarray(y), jnp.asarray(loc), jnp.asarray(scale)), 1e-12)
    _close(tstats.normal_logpdf(_t(y), 0.5, 2.0),
           jstats.normal_logpdf(jnp.asarray(y), 0.5, 2.0), 1e-12)

    def chol(k):
        a = rng.standard_normal((k, k))
        return np.linalg.cholesky(a @ a.T + k * np.eye(k))

    m0, m1, c0, c1 = rng.standard_normal(7), rng.standard_normal(7), chol(7), chol(7)
    got = float(tstats.kl_mvn_chol(_t(m0), _t(c0), _t(m1), _t(c1)))
    want = float(jstats.kl_mvn_chol(jnp.asarray(m0), jnp.asarray(c0), jnp.asarray(m1),
                                    jnp.asarray(c1)))
    assert got > 0 and abs(got - want) <= 1e-12 * abs(want)
    assert abs(float(tstats.kl_mvn_chol(_t(m0), _t(c0), _t(m0), _t(c0)))) <= 1e-12
    from hipgp_tpu_torch.kernels import interdomain

    assert interdomain.normal_cdf is tstats.normal_cdf
