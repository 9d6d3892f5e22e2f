"""Parity of the port's 1-D long-axis path (hipgp_tpu_torch.ops.radix_fft,
the planes solver and the section 5.2 driver) with the JAX package.

Both packages get the same float64 inputs, made with numpy from a seed, on
the CPU.  The JAX side runs as its own tests run it here: stage 1 through
its einsum fallback, the middle kernel and the stage-1 self-dot kernel in
Pallas interpret mode.  The port's radix wrappers take their plain PyTorch
versions for CPU tensors.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu.kernels import Matern as JMatern
from hipgp_tpu.kernels import SqExp as JSqExp
from hipgp_tpu.ops import bttb as jbttb
from hipgp_tpu.ops import radix_fft as jr
from hipgp_tpu.ops import solve as jsolve
from hipgp_tpu_torch.kernels import Matern as TMatern
from hipgp_tpu_torch.kernels import SqExp as TSqExp
from hipgp_tpu_torch.ops import bttb as tbttb
from hipgp_tpu_torch.ops import radix_fft as tr
from hipgp_tpu_torch.ops import solve as tsolve
from hipgp_tpu_torch.utils.timing import chain_time

LENGTHS = [8192, 16384, 32768]


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _plans(L):
    return jr.make_plan(L, jnp.float64), tr.make_plan(L, torch.float64)


def _even_spectrum(L, rng):
    d = 0.5 + rng.random(L)
    return 0.5 * (d + np.concatenate([d[:1], d[1:][::-1]]))


@functools.lru_cache(maxsize=None)
def _specs_1d(M, ell, kern="SqExp", sig2=1.0):
    jk, tk = (JSqExp(), TSqExp()) if kern == "SqExp" else (JMatern(2.5), TMatern(2.5))
    js = jbttb.make_spectrum([jnp.linspace(0.0, 1.0, M)],
                             lambda a, b: jk(a, b, (sig2, ell)), jitter=1e-3)
    ts = tbttb.make_spectrum([torch.linspace(0.0, 1.0, M, dtype=torch.float64)],
                             lambda a, b: tk(a, b, (sig2, ell)), jitter=1e-3)
    return js, ts


# ---------------------------------------------------------------------------
# layout functions
# ---------------------------------------------------------------------------

def test_factorization_matches_jax():
    for L in [1 << k for k in range(8, 27)] + [6144, 1000, 3 * 2 ** 15]:
        assert tr._factorize(L) == jr._factorize(L), L
        assert tr.radix_supported(L) == jr.radix_supported(L), L
        if jr.radix_supported(L):
            assert tr.row_multiple(L) == jr.row_multiple(L), L


@pytest.mark.parametrize("L", LENGTHS)
def test_plan_tables_match_jax(L):
    jp, tp = _plans(L)
    assert (tp.L, tp.A, tp.B, tp.C) == (jp.L, jp.A, jp.B, jp.C)
    for name in jr.RadixPlan._fields[4:]:
        np.testing.assert_array_equal(_np(getattr(tp, name)),
                                      np.asarray(getattr(jp, name)), err_msg=name)


@pytest.mark.parametrize("L", LENGTHS)
def test_permute_weights_matches_jax(L):
    jp, tp = _plans(L)
    d = _even_spectrum(L, np.random.default_rng(L))
    got = tr.permute_weights(_t(d), tp)
    want = jr.permute_weights(jnp.asarray(d), jp)
    assert got.shape == (tp.A, tp.B, tp.C)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("L", LENGTHS)
def test_stage_order_weights_match_jax(L):
    M = L // 2 + 1
    ts = tbttb.make_spectrum([torch.linspace(0.0, 1.0, M, dtype=torch.float64)],
                             lambda a, b: TSqExp()(a, b, (1.0, 3.0 / M)), jitter=1e-3)
    assert ts.edims == (L,)
    jp, tp = _plans(L)
    got = tr.stage_order_weights(ts.ecolumn, tp)
    want = jr.stage_order_weights(jnp.asarray(_np(ts.ecolumn)), jp)
    assert _rel(got, want) <= 1e-9
    # it is the natural-order spectrum in stage order
    full = tbttb._full_weights(ts.eigs, L)
    clamped = torch.maximum(got, torch.min(ts.eigs))
    assert _rel(clamped, tr.permute_weights(full, tp) * L) <= 1e-9


# ---------------------------------------------------------------------------
# the plain stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("case", ["forward", "forward_cropped", "inverse",
                                  "inverse_cropped"])
def test_stage1_plain_matches_jax(L, case):
    jp, tp = _plans(L)
    A, N = tp.A, tp.B * tp.C
    rows = 5
    rng = np.random.default_rng(L + len(case))
    V = 3
    if case.startswith("forward"):
        in_rows = rows if case.endswith("cropped") else A
        x = rng.standard_normal((2, V, in_rows, N))
        got = tr.stage1(_t(x[0]), _t(x[1]), tp, A, inverse=False)
        want = jr._stage1_fwd(jnp.asarray(x[0]).reshape(V, -1),
                              jnp.asarray(x[1]).reshape(V, -1), jp, jr.HIGHEST,
                              None if in_rows == A else in_rows)
        want = [np.asarray(w).reshape(V, A, N) for w in want]
    else:
        out_rows = rows if case.endswith("cropped") else A
        z = rng.standard_normal((2, V, A, N))
        got = tr.stage1(_t(z[0]), _t(z[1]), tp, out_rows, inverse=True)
        want = jr._stage1_inv(jnp.asarray(z[0]).reshape(V, A, tp.B, tp.C),
                              jnp.asarray(z[1]).reshape(V, A, tp.B, tp.C), jp,
                              jr.HIGHEST, None if out_rows == A else out_rows)
        want = [np.asarray(w).reshape(V, out_rows, N) for w in want]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= 1e-10


@pytest.mark.parametrize("L", [8192, 32768])
def test_stage1_inv_dot_plain_matches_jax(L):
    jp, tp = _plans(L)
    A, B, C = tp.A, tp.B, tp.C
    N = B * C
    rows, V = 3, 2
    rng = np.random.default_rng(L + 1)
    z = rng.standard_normal((2, V, A, N))
    u = rng.standard_normal((2, V, rows, N))
    got = tr.stage1_inv_dot(_t(z[0]), _t(z[1]), _t(u[0]), _t(u[1]), tp, rows)
    # the einsum fallback of `_stage1_inv_dot`
    want = jr._stage1_inv_dot(jnp.asarray(z[0]).reshape(V, A, B, C),
                              jnp.asarray(z[1]).reshape(V, A, B, C),
                              jnp.asarray(u[0]).reshape(V, -1),
                              jnp.asarray(u[1]).reshape(V, -1), jp, jr.HIGHEST, rows)
    # the Pallas kernel in interpret mode, called directly
    wc, ws = jp.wac[:rows], -jp.was[:rows]
    pallas = jr._stage1_inv_dot_pallas(jnp.asarray(z[0]), jnp.asarray(z[1]),
                                       jnp.asarray(u[0]), jnp.asarray(u[1]),
                                       wc, ws, wc + ws, jr.HIGH)
    for ref in (want, pallas):
        for k in range(2):
            assert _rel(got[k], np.asarray(ref[k]).reshape(V, rows, N)) <= 1e-10
        for k in (2, 3):
            assert _rel(got[k], ref[k]) <= 1e-10


@pytest.mark.parametrize("L", LENGTHS)
def test_middle_plain_matches_jax_pallas_interpret(L):
    jp, tp = _plans(L)
    A, B, C = tp.A, tp.B, tp.C
    V = 2
    rng = np.random.default_rng(L + 2)
    y = rng.standard_normal((2, V, A, B, C))
    d = tr.permute_weights(_t(_even_spectrum(L, rng)), tp)
    got = tr.middle(_t(y[0]), _t(y[1]), d, tp)
    want = jr._middle_pallas(jnp.asarray(y[0]), jnp.asarray(y[1]),
                             jnp.asarray(_np(d)), jp, jr.HIGH)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-10


def test_stage1_wrapper_refuses_bad_shapes():
    tp = tr.make_plan(8192, torch.float64)
    x = torch.zeros((1, 3, tp.B * tp.C), dtype=torch.float64)
    with pytest.raises(ValueError):
        tr.stage1(x, x, tp, tp.A + 1, inverse=False)
    with pytest.raises(ValueError):
        tr.stage1(x[..., :-1], x[..., :-1], tp, tp.A, inverse=False)
    with pytest.raises(ValueError):
        tr.middle(x, x, torch.zeros((tp.A, tp.B, tp.C), dtype=torch.float64), tp)


# ---------------------------------------------------------------------------
# the applies
# ---------------------------------------------------------------------------

def _apply_inputs(L, seed, rows=None):
    jp, tp = _plans(L)
    rng = np.random.default_rng(seed)
    n = L if rows is None else rows * tp.B * tp.C
    x = rng.standard_normal((2, 2, n))
    d = _even_spectrum(L, rng)
    return jp, tp, x, jr.permute_weights(jnp.asarray(d), jp), tr.permute_weights(_t(d), tp)


def test_fused_circulant_apply_matches_jax_and_fft():
    L = 8192
    jp, tp, x, jd, td = _apply_inputs(L, 0)
    got = tr.fused_circulant_apply(_t(x[0]), _t(x[1]), td, tp)
    want = jr.fused_circulant_apply(jnp.asarray(x[0]), jnp.asarray(x[1]), jd, jp)
    d = _np(td).transpose(2, 1, 0).reshape(-1) * L   # back to natural order
    for k in range(2):
        assert _rel(got[k], want[k]) <= 1e-10
        oracle = np.fft.ifft(d * np.fft.fft(x[k], axis=-1), axis=-1).real
        assert _rel(got[k], oracle) <= 1e-10


@pytest.mark.parametrize("in_rows,out_rows", [(3, 3), (2, 8), (8, 5)])
def test_fused_circulant_apply_cropped_matches_jax(in_rows, out_rows):
    L = 8192
    jp, tp, x, jd, td = _apply_inputs(L, in_rows * 10 + out_rows, rows=in_rows)
    got = tr.fused_circulant_apply_cropped(_t(x[0]), _t(x[1]), td, tp, in_rows, out_rows)
    want = jr.fused_circulant_apply_cropped(jnp.asarray(x[0]), jnp.asarray(x[1]), jd,
                                            jp, in_rows, out_rows)
    for k in range(2):
        assert got[k].shape == (2, out_rows * tp.B * tp.C)
        assert _rel(got[k], want[k]) <= 1e-10


def test_fused_circulant_apply_cropped_selfdot_matches_jax():
    L, rows = 16384, 4
    jp, tp, x, jd, td = _apply_inputs(L, 5, rows=rows)
    got = tr.fused_circulant_apply_cropped_selfdot(_t(x[0]), _t(x[1]), td, tp, rows, rows)
    want = jr.fused_circulant_apply_cropped_selfdot(jnp.asarray(x[0]), jnp.asarray(x[1]),
                                                    jd, jp, rows, rows)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-10
    with pytest.raises(ValueError):
        tr.fused_circulant_apply_cropped_selfdot(_t(x[0]), _t(x[1]), td, tp, rows, rows + 1)


# ---------------------------------------------------------------------------
# the planes solver, R^T, the 1-D operator family
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_planes(M, nb, seed):
    """JAX's planes solve (12 fixed iterations) and R^T of (nb, M) rows from
    ``seed``, shared by the tests that hold the port against them."""
    js, _ = _specs_1d(M, 2.5 / M)
    b = np.random.default_rng(seed).standard_normal((nb, M))
    x = jsolve._planes_solver(js, 12, 0.0, True)(None, jnp.asarray(b))
    return b, np.asarray(x), np.asarray(jsolve._rt_planes(js, x))


@pytest.mark.parametrize("M,nb", [(4100, 3), (4096, 4)])
def test_planes_solver_and_rt_match_jax(M, nb):
    _, ts = _specs_1d(M, 2.5 / M)
    b, want, want_rt = _jax_planes(M, nb, 6)
    got = tsolve._planes_solver(ts, _t(b), 12, 0.0, True)
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-8)
    # and the port's own generic path, as the JAX package's test holds its solver
    plain = tsolve.inv_matmul(ts, _t(b), maxiter=12, tol=0.0, fixed_iters=True)
    np.testing.assert_allclose(_np(got), _np(plain), rtol=1e-6, atol=1e-8)
    got_rt = tsolve._rt_planes(ts, got)
    assert got_rt.shape == (nb, ts.Mprime)
    np.testing.assert_allclose(_np(got_rt), want_rt, rtol=1e-6, atol=1e-8)
    assert _rel(got_rt, tbttb.matmul_by_RT(ts, got)) <= 1e-10


def test_planes_early_exit_matches_generic_pcg():
    M = 4100
    _, ts = _specs_1d(M, 2.5 / M)
    b = _t(np.random.default_rng(9).standard_normal((3, M)))
    got = tsolve._planes_solver(ts, b, 40, 1e-4, False)
    want = tsolve.inv_matmul(ts, b, maxiter=40, tol=1e-4)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("M", [1000, 10_000, 100_000, 131_072, 500_000, 1 << 20])
def test_planes_gate_follows_the_protocol_table(M):
    # radix plans and crop rows of the section 5.2 sizes: only M >= 131072
    # reaches >= 8 rows of data
    edims = tbttb.embedded_dims((M,))
    assert edims == jbttb.embedded_dims((M,))
    spec = tbttb.BTTBSpectrum(column=None, eigs=None, dims=(M,), edims=edims)
    planes = M in (131_072, 500_000, 1 << 20)
    assert tsolve._planes_solver_ok(spec, torch.float32, "cuda") == planes
    assert not tsolve._planes_solver_ok(spec, torch.float32, "cpu")
    assert not tsolve._planes_solver_ok(spec, torch.float64, "cuda")
    v = torch.zeros(0, dtype=torch.float32)
    assert not tbttb._radix_apply_ok(spec, v.dtype, v.device)   # a CPU tensor
    assert tr.radix_supported(edims[0]) == (M != 1000)


@pytest.mark.parametrize("gate", ["planes", "radix_apply"])
def test_use_radix_fft_switches_the_1d_gates(monkeypatch, gate):
    # the JAX package's USE_RADIX_FFT: on (the default), a float32 CUDA
    # request at a radix-supported length takes the planes solver and the
    # radix apply; off, neither
    M = 131_072
    edims = tbttb.embedded_dims((M,))
    spec = tbttb.BTTBSpectrum(column=None, eigs=None, dims=(M,), edims=edims)
    ok = tsolve._planes_solver_ok if gate == "planes" else tbttb._radix_apply_ok
    dev = torch.device("cuda")
    assert tbttb.USE_RADIX_FFT is True
    assert ok(spec, torch.float32, dev)
    monkeypatch.setattr(tbttb, "USE_RADIX_FFT", False)
    assert not ok(spec, torch.float32, dev)


@pytest.mark.parametrize("M", [100, 300, 4100])
def test_1d_spectrum_and_matvecs_match_jax(M):
    js, ts = _specs_1d(M, 3.0 / M, kern="Mat52", sig2=0.1)
    assert ts.edims == js.edims
    assert _rel(ts.eigs, js.eigs) <= 1e-10
    assert _rel(ts.ecolumn, js.ecolumn) <= 1e-12
    v = np.random.default_rng(M).standard_normal((3, M))
    for tf, jf in ((tbttb.matmul_by_K, jbttb.matmul_by_K),
                   (tbttb.matmul_by_RT, jbttb.matmul_by_RT),
                   (tbttb.matmul_by_Cinv, jbttb.matmul_by_Cinv)):
        assert _rel(tf(ts, _t(v)), jf(js, jnp.asarray(v))) <= 1e-10


def test_cholesky_whiten_matches_jax():
    M = 200
    grid = np.linspace(0.0, 1.0, M)
    jk, tk = JMatern(2.5), TMatern(2.5)
    Kj = jbttb.dense_gram([jnp.asarray(grid)], lambda a, b: jk(a, b, (0.1, 1.0 / M)), 1e-3)
    Kt = tbttb.dense_gram([_t(grid)], lambda a, b: tk(a, b, (0.1, 1.0 / M)), 1e-3)
    assert _rel(Kt, Kj) <= 1e-12
    v = np.random.default_rng(3).standard_normal((4, M))
    got = tsolve.cholesky_whiten(Kt, _t(v), jitter=1e-4)
    want = jsolve.cholesky_whiten(Kj, jnp.asarray(v), jitter=1e-4)
    assert _rel(got, want) <= 1e-10


def test_whiten_1d_matches_jax():
    # the port's whiten on the CPU (generic PCG, then matmul_by_RT) against
    # JAX's planes solve and R^T of the same rows
    M = 4100
    _, ts = _specs_1d(M, 2.5 / M)
    knm, _, want = _jax_planes(M, 3, 6)
    got = tsolve.whiten(ts, _t(knm), maxiter=12, tol=0.0, fixed_iters=True)
    assert got.shape == (3, ts.Mprime)
    assert _rel(got, want) <= 1e-8


@pytest.mark.parametrize("nb", [3, 4])
def test_pack_rows_round_trip(nb):
    x = _t(np.random.default_rng(nb).standard_normal((nb, 5)))
    xr, xi = tr.pack_rows(x, 8)
    V = (nb + 1) // 2
    assert xr.shape == xi.shape == (V, 8)
    assert torch.equal(xr[:, :5], x[0::2]) and torch.equal(xi[: nb // 2, :5], x[1::2])
    assert not xr[:, 5:].any() and not xi[:, 5:].any() and not xi[nb // 2:].any()
    assert torch.equal(tr.unpack_rows(xr, xi, nb)[:, :5], x)


@pytest.mark.parametrize("nb", [3, 4])
@pytest.mark.parametrize("op", ["K", "RT"])
def test_radix_apply_branch_matches_jax(nb, op):
    # bttb's 1-D radix branch (taken for float32 CUDA tensors), driven
    # directly here on float64 CPU tensors through the plain stages
    M = 4100
    js, ts = _specs_1d(M, 2.5 / M)
    assert tr.radix_supported(ts.edims[0])
    v = np.random.default_rng(nb).standard_normal((nb, M))
    weights = ts.eigs if op == "K" else torch.sqrt(ts.eigs)
    got = tbttb._apply_spectrum_radix(ts, _t(v), weights, False, op == "RT")
    jf = jbttb.matmul_by_K if op == "K" else jbttb.matmul_by_RT
    want = jf(js, jnp.asarray(v))
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-10


# ---------------------------------------------------------------------------
# timing and the section 5.2 driver
# ---------------------------------------------------------------------------

def test_chain_time_keeps_the_values():
    calls = []

    def f(x):
        calls.append(x.clone())
        return 2.0 * x

    x = torch.arange(4, dtype=torch.float64)
    secs, out = chain_time(f, x, reps=2, warmup=1)
    assert secs >= 0.0 and len(calls) == 4
    assert all(torch.equal(c, x) for c in calls)
    assert torch.equal(out, 2.0 * x)


def test_run_pcg_vs_cholesky_main(tmp_path):
    from hipgp_tpu_torch.experiments import run_pcg_vs_cholesky

    out = run_pcg_vs_cholesky.main(["--sizes", "300", "5000", "--kernels", "Mat52",
                                    "--reps", "1", "--device", "cpu",
                                    "--output-dir", str(tmp_path)])
    rows = out["Mat52"]
    assert [r["M"] for r in rows] == [300, 5000]
    assert all(r["pcg_fft_sec"] > 0 and r["cholesky_sec"] > 0 for r in rows)
    text = (tmp_path / "wall_clock_time_summary_pcg_vs_cholesky_Mat52.csv").read_text()
    lines = text.strip().splitlines()
    assert lines[0] == "M,pcg_fft_sec,cholesky_sec" and len(lines) == 3
    assert all(math.isfinite(float(c)) for ln in lines[1:] for c in ln.split(","))
