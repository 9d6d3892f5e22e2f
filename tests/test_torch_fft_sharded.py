"""Parity of the port's grid-sharded circulant solves with the JAX package.

tests/test_fft_sharded.py's cases, ported: one world of four gloo ranks on
the CPU (`hipgp_tpu_torch.parallel.launch`, one cluster for the file;
`torch_parallel_ranks.fft_sharded_cases`) runs ``sharded_matmul_by_K``,
``sharded_inv_matmul`` and ``sharded_gram_solve`` on the 17 x 13 grid, with
the long-axis FFT path forced (``matmul_max_len`` 0 and 30), on a 3-D grid
and on a 1-D grid by the four-step FFT, each held to the JAX package's
single-device ``matmul_by_K`` (1e-9), ``inv_matmul`` and ``gram_solve``
(1e-7) on the same spectrum; a shard count that does not divide the
embedding raises; ``shard_multiples``' padding leaves K exact;
``local_spectrum_weights`` matches ``host_weights``; and the gradient of the
sharded whitening (``local_whiten_diff``) in the right-hand side and the
log-hyperparameters matches ``jax.grad`` of the single-device ``whiten`` at
the same fixed iteration count.  Without ranks: ``make_spectrum``'s
``multiple_of`` and ``transform='matmul'``, ``pcg``'s ``dot_fn`` and
``HIPGP(grid_shards=)`` against JAX, and kernel A's gate on the padded
embeddings.  All in float64.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

import torch_parallel_ranks as ranks
from hipgp_tpu import kernels as jkernels
from hipgp_tpu import ops as jops
from hipgp_tpu.models import HIPGP as JHIPGP
from hipgp_tpu.ops.cg import pcg_result as jpcg_result
from hipgp_tpu.parallel.fft_sharded import GridShardInfo as JGridShardInfo
from hipgp_tpu.parallel.fft_sharded import host_weights as jhost_weights
from hipgp_tpu_torch.kernels import SqExp
from hipgp_tpu_torch.models import HIPGP
from hipgp_tpu_torch.ops import make_spectrum, mxu2d
from hipgp_tpu_torch.ops import solve as tsolve
from hipgp_tpu_torch.ops.cg import pcg_result
from hipgp_tpu_torch.parallel import launch, shard_multiples

RANKS = 4
JKERNELS = {"SqExp": jkernels.SqExp(), "Mat52": jkernels.Matern(2.5),
            "Mat32": jkernels.Matern(1.5)}


def _b(seed, rows, M):
    return np.random.default_rng(seed).standard_normal((rows, M))


def _case(dims, ell, seed, rows, maxiter=150, max_len=None, multiple_of=None, solves=True):
    M = int(np.prod(dims))
    return dict(dims=dims, kernel="SqExp", ell=ell, b=_b(seed, rows, M), maxiter=maxiter,
                max_len=max_len, multiple_of=multiple_of, solves=solves)


SOLVES = {
    "2d": _case((17, 13), 0.1, 0, 5, maxiter=200),
    "2d-fft-all": _case((17, 13), 0.1, 3, 5, max_len=0),
    "2d-fft-leading": _case((17, 13), 0.1, 3, 5, max_len=30),
    "3d": _case((9, 7, 5), 0.2, 1, 3),
    "1d-four-step": _case((1000,), 0.005, 2, 4, maxiter=100,
                          multiple_of=shard_multiples((1000,), RANKS)),
}
WEIGHTS = {"2d": ((11, 13), "SqExp", 0.15), "3d": ((9, 7, 6), "Mat52", 0.2),
           "1d": ((40,), "SqExp", 0.08), "1d-long": ((300,), "Mat32", 0.01)}
GRAD = dict(dims=(17, 13), sig2=1.3, ell=0.1, maxiter=10)


def _jspec(c, sig2=1.0):
    grids = [jnp.linspace(0.0, 1.0, m) for m in c["dims"]]
    kern = JKERNELS[c["kernel"]]
    return jops.make_spectrum(grids, lambda a, b: kern(a, b, (sig2, c["ell"])), jitter=1e-3,
                              multiple_of=c.get("multiple_of"))


@pytest.fixture(scope="module")
def cluster():
    pad = _case((15, 4), 0.07, 4, 3, multiple_of=shard_multiples((15, 4), RANKS),
                solves=False)
    grad_M = int(np.prod(GRAD["dims"]))
    g_edims = jops.make_spectrum([jnp.linspace(0.0, 1.0, m) for m in GRAD["dims"]],
                                 lambda a, b: JKERNELS["SqExp"](a, b, (1.0, 0.1))).edims
    inputs = {
        "solves": {**SOLVES, "pad-exact": pad},
        "bad": dict(dims=(4, 4), kernel="SqExp", ell=0.1),
        "weights": {k: dict(dims=d, kernel=kn, ell=ell,
                            multiple_of=shard_multiples(d, RANKS))
                    for k, (d, kn, ell) in WEIGHTS.items()},
        "grad": {**GRAD, "b": _b(6, 3, grad_M), "r": _b(7, 3, int(np.prod(g_edims)))},
    }
    return inputs, launch.run(ranks.fft_sharded_cases, RANKS, args=(inputs,), device="cpu",
                              timeout_s=300)


def _every_rank(out, key):
    for r in out[1:]:
        for k, v in out[0][key].items():
            np.testing.assert_array_equal(np.asarray(r[key][k]), np.asarray(v))
    return out[0][key]


@pytest.mark.parametrize("key", list(SOLVES))
def test_sharded_solves_match_jax_single_device(cluster, key):
    inputs, out = cluster
    c = inputs["solves"][key]
    spec = _jspec(c)
    got = _every_rank(out, f"solves/{key}")
    assert tuple(got["edims"]) == tuple(spec.edims)
    b = jnp.asarray(c["b"])
    np.testing.assert_allclose(got["K"], np.asarray(jops.matmul_by_K(spec, b)), rtol=1e-9,
                               atol=1e-11)
    it = dict(maxiter=c["maxiter"], tol=1e-12)
    np.testing.assert_allclose(got["inv"], np.asarray(jops.inv_matmul(spec, b, **it)),
                               rtol=1e-7, atol=1e-9)
    want = np.asarray(jops.gram_solve(spec, b, **it))
    assert got["gram"].shape == want.shape == (b.shape[0], spec.Mprime)
    np.testing.assert_allclose(got["gram"], want, rtol=1e-7, atol=1e-9)


def test_sharded_rejects_bad_shard_count(cluster):
    _, out = cluster
    # the 4 x 4 grid embeds at (6, 6): not divisible by four shards
    for r in out:
        assert r["bad"] is not None and "not divisible by 4 shards" in r["bad"]


def test_shard_multiples_padding_is_exact(cluster):
    inputs, out = cluster
    c = inputs["solves"]["pad-exact"]
    got = _every_rank(out, "solves/pad-exact")
    # the minimal embedding (28, 6) padded to multiples of 4: K unchanged
    assert got["edims"][0] % RANKS == 0 and got["edims"][-1] % RANKS == 0
    grids = [jnp.linspace(0.0, 1.0, m) for m in c["dims"]]
    Kd = jops.dense_gram(grids, lambda a, b: JKERNELS["SqExp"](a, b, (1.0, c["ell"])),
                         jitter=1e-3)
    np.testing.assert_allclose(got["K"], c["b"] @ np.asarray(Kd), rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("key", list(WEIGHTS))
def test_local_spectrum_weights_match_host_weights(cluster, key):
    inputs, out = cluster
    c = inputs["weights"][key]
    spec = _jspec({**c, "kernel": c["kernel"]}, sig2=1.3)
    info = JGridShardInfo(spec, RANKS)
    jw = np.asarray(jhost_weights(spec, info))
    for rank, r in enumerate(out):
        got, want = r[f"weights/{key}"]
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
        # the port's host_weights block is the JAX layout's block
        blk = (jw[rank * info.rows_per:(rank + 1) * info.rows_per] if info.nd == 1
               else np.split(jw, RANKS, axis=-1)[rank])
        np.testing.assert_allclose(want, blk, rtol=1e-12, atol=1e-13)


def test_local_whiten_diff_gradients_match_jax_whiten(cluster):
    inputs, out = cluster
    c = inputs["grad"]
    grids = [jnp.linspace(0.0, 1.0, m) for m in c["dims"]]

    def f(b, log_sig2, log_ell):
        p = (jnp.exp(log_sig2), jnp.exp(log_ell))
        spec = jops.make_spectrum(grids, lambda u, v: JKERNELS["SqExp"](u, v, p), jitter=1e-3)
        kn = jops.whiten(spec, b, maxiter=c["maxiter"], tol=0.0)
        return jnp.sum(jnp.asarray(c["r"]) * kn), kn

    args = (jnp.asarray(c["b"]), jnp.log(c["sig2"]), jnp.log(c["ell"]))
    (loss, kn), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(*args)
    got = _every_rank(out, "grad")
    np.testing.assert_allclose(got["kn"], np.asarray(kn), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-9)
    np.testing.assert_allclose(got["g_b"], np.asarray(grads[0]), rtol=1e-7,
                               atol=1e-7 * np.abs(np.asarray(grads[0])).max())
    np.testing.assert_allclose(got["g_log_sig2"], float(grads[1]), rtol=1e-7)
    np.testing.assert_allclose(got["g_log_ell"], float(grads[2]), rtol=1e-7)


@pytest.mark.parametrize("transform", ["fft", "matmul"])
@pytest.mark.parametrize("dims,shards", [((17, 13), 4), ((9, 7, 5), 2), ((300,), 4)])
def test_make_spectrum_multiple_of_and_transform_match_jax(dims, shards, transform):
    mult = shard_multiples(dims, shards)
    jspec = jops.make_spectrum([jnp.linspace(0.0, 1.0, m) for m in dims],
                               lambda a, b: JKERNELS["SqExp"](a, b, (1.0, 0.1)), jitter=1e-3,
                               multiple_of=mult, transform=transform)
    grids = [torch.linspace(0.0, 1.0, m, dtype=torch.float64) for m in dims]
    spec = make_spectrum(grids, lambda a, b: SqExp()(a, b, (1.0, 0.1)), jitter=1e-3,
                         multiple_of=mult, transform=transform)
    assert spec.edims == tuple(jspec.edims)
    assert all(e % m == 0 for e, m in zip(spec.edims, mult))
    np.testing.assert_allclose(spec.eigs.numpy(), np.asarray(jspec.eigs), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(spec.ecolumn.numpy(), np.asarray(jspec.ecolumn), rtol=1e-14)
    with pytest.raises(ValueError, match="multiple_of requires pad_to_fast"):
        make_spectrum(grids, lambda a, b: SqExp()(a, b, (1.0, 0.1)), pad_to_fast=False,
                      multiple_of=mult)
    with pytest.raises(ValueError, match="unknown transform"):
        make_spectrum(grids, lambda a, b: SqExp()(a, b, (1.0, 0.1)), transform="dct")


def test_pcg_dot_fn_matches_jax():
    # PCG in the inner product <a, b>_D = sum(a * d * b): the operator D^-1 A
    # is self-adjoint in it, so CG converges in that geometry
    rng = np.random.default_rng(8)
    n = 12
    G = rng.standard_normal((n, n))
    A = G @ G.T + n * np.eye(n)
    d = rng.uniform(0.5, 2.0, n)
    b = rng.standard_normal((3, n))
    tres = pcg_result(lambda v: (v @ torch.tensor(A.T)) / torch.tensor(d),
                      torch.tensor(b) / torch.tensor(d), maxiter=5, tol=0.0,
                      dot_fn=lambda u, v: torch.sum(u * torch.tensor(d) * v, dim=-1))
    jres = jpcg_result(lambda v: (v @ jnp.asarray(A.T)) / jnp.asarray(d),
                       jnp.asarray(b) / jnp.asarray(d), maxiter=5, tol=0.0,
                       dot_fn=lambda u, v: jnp.sum(u * jnp.asarray(d) * v, axis=-1))
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=1e-12)
    np.testing.assert_allclose(tres.resnorm.numpy(), np.asarray(jres.resnorm), rtol=1e-10)
    assert tres.iters == int(jres.iters) == 5


@pytest.mark.parametrize("shards", [2, 4])
def test_hipgp_grid_shards_matches_jax_padded_model(shards):
    rng = np.random.default_rng(9)
    x = rng.uniform(0.05, 0.95, (80, 2))
    y = np.sin(4 * x[:, 0]) + 0.1 * rng.standard_normal(80)
    s = np.full(80, 0.1)
    grids = [np.linspace(0.0, 1.0, 10)] * 2
    jm = JHIPGP(jkernels.SqExp(), [jnp.asarray(g) for g in grids], num_obs=80, ell_init=0.1,
                noise2_init=0.01, grid_shards=shards, dtype=jnp.float64)
    tm = HIPGP(SqExp(), grids, num_obs=80, ell_init=0.1, noise2_init=0.01,
               grid_shards=shards, dtype=torch.float64, device="cpu")
    plain = HIPGP(SqExp(), grids, num_obs=80, dtype=torch.float64, device="cpu")
    assert tm.edims == tuple(jm.edims) and tm.Mprime == jm.Mprime
    assert all(e % shards == 0 for e in (tm.edims[0], tm.edims[-1]))
    if shards == 4:
        assert tm.Mprime > plain.Mprime   # (18, 18) stays at 2, pads to (20, 20) at 4
    js, ts = jm.init_state(), tm.init_state()
    for k in ("theta1", "theta2"):
        assert getattr(ts, k).shape == getattr(js, k).shape == (tm.Mprime,)
    np.testing.assert_allclose(ts.theta2.numpy(), np.asarray(js.theta2), rtol=1e-15)
    for k in ("log_sig2", "log_ell", "log_noise2"):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)),
                                   rtol=1e-15)
    # the padded model's spectrum, its transforms and its closed-form fit
    for transform in ("fft", "matmul"):
        np.testing.assert_allclose(tm.spectrum(ts, transform=transform).eigs.numpy(),
                                   np.asarray(jm.spectrum(js, transform=transform).eigs),
                                   rtol=1e-10, atol=1e-12)
    jst = jm.batch_solve(js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(s), maxiter_cg=200)
    tst = tm.batch_solve(ts, x, y, s, maxiter_cg=200)
    np.testing.assert_allclose(tst.theta2.numpy(), np.asarray(jst.theta2), rtol=1e-8)
    np.testing.assert_allclose(tst.theta1.numpy(), np.asarray(jst.theta1), rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_kernel_a_takes_the_padded_embeddings_its_plans_admit(shards, capsys):
    # the fused 2-D solve's gate (kernel A) on the grid_shards-padded
    # embeddings of the 2-D protocol's grids: it takes exactly those that
    # mxu2d.plans_ok admits; the refused ones are printed
    refused = []
    for m in (16, 33, 64, 100, 125, 200, 256):
        edims = HIPGP(SqExp(), [np.linspace(0, 1, m)] * 2, num_obs=1, grid_shards=shards,
                      device="cpu").edims
        spec = types.SimpleNamespace(dims=(m, m), edims=edims)
        ok = tsolve._mxu2d_solver_ok(spec, torch.float32, "cuda")
        admitted = max(edims) <= mxu2d.MXU2D_MAX_LEN and mxu2d.plans_ok(edims)
        assert ok == admitted, (m, edims)
        if not ok:
            refused.append((m, edims))
    print(f"grid_shards={shards}: kernel A refuses {refused or 'none'}")
    assert (125, (250, 250)) not in refused
