"""Parity of the port's model-parallel natural-gradient training with the
JAX package.

One world of four gloo ranks on the CPU runs every case of this file once,
in float64, on a (2, 2) ('dp', 'grid') mesh (`torch_parallel_ranks.
mp_train_cases`, which imports neither JAX nor the JAX package), mirroring
tests/test_mp_train.py: ``mp_elbo_and_grads`` (the ELBO and natural
gradient, the hyper-gradients through the split whitening at fixed
iterations, 2-D and 1-D, mean-field and block) against the JAX package's
single-device ``elbo_and_grads``; ``mp_svigp_fit`` (a 3-epoch learn-kernel
trajectory with the warm start, an uneven batch learning the noise, the
block family, the 1-D grid) with ``mp_predict`` of its state against JAX's
``svigp_fit`` and ``predict``; the split spectrum against the whole one;
``make_mp_kn_fn`` on the 1-D four-step layout against ``compute_kn``; a
checkpointed fit, whose file holds the whole state, resumed by the port and
by the JAX package.  The Monte-Carlo estimator's draws are held against the
port's own single-device step (the JAX package draws from ``jax.random``).
Tolerances are tests/test_mp_train.py's or tighter, stated where used.
"""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

import torch_parallel_ranks as ranks
from hipgp_tpu.infer.fit import FitConfig as JFitConfig
from hipgp_tpu.infer.fit import svigp_fit as jsvigp_fit
from hipgp_tpu.kernels import SqExp as JSqExp
from hipgp_tpu.models import HIPGP as JHIPGP
from hipgp_tpu_torch import convert
from hipgp_tpu_torch.parallel import launch
from hipgp_tpu_torch.utils import checkpoint as tckpt

RANKS = 4
MESH = (2, 2)
NG = 2


def _jmodel(p):
    kw = {} if p["block_sizes"] is None else {"block_sizes": p["block_sizes"]}
    if p.get("learn_noise"):
        kw["learn_noise"] = True
    grids = [jnp.linspace(p["lo"], 1.0, p["m"])] * p["dim"]
    return JHIPGP(JSqExp(), grids, num_obs=p["N"], family=p["family"], ell_init=p["ell"],
                  noise2_init=0.01, grid_shards=p["ng"],
                  support_integrated_obs=p["integrated"], dtype=jnp.float64, **kw)


def _jstate_np(p):
    js = _jmodel(p).init_state()
    return {k: np.asarray(getattr(js, k)) for k in convert.STATE_FIELDS}


def _jstate(p, d):
    return _jmodel(p).init_state().replace(**{k: jnp.asarray(v) for k, v in d.items()})


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


MF = ranks.mp_model_kw(300, NG)
BLOCK = ranks.mp_model_kw(300, NG, family="block", block_sizes=(5, 4))
ONE_D = ranks.mp_model_kw(120, NG, m=40, dim=1, ell=0.08)


def _grads_case(p, data, n, **kw):
    x, y, s = data
    return dict(model=p, state=_jstate_np(p), x=x[:n], y=y[:n], s=s[:n],
                kw=dict(maxiter_cg=30, **kw))


def _fit_case(p, data, cfg, kw=None, s=True, **extra):
    x, y, sd = data
    return dict(model=p, state=_jstate_np(p), x=x, y=y, s=sd if s else None, cfg=cfg,
                kw=kw or {}, **extra)


def _inputs():
    d300, d1 = ranks.mp_data(), ranks.mp_data(N=120, dim=1)
    d250 = ranks.mp_data(N=250)
    xq = ranks.mp_data(N=64, seed=7)[0]
    noise_model = dict(ranks.mp_model_kw(250, NG), learn_noise=True)
    # the fits' whitening converged (60 iterations, the PCG's exit at 1e-8):
    # 30 truncated iterations of two PCGs whose transforms round differently
    # (the split real-basis products, JAX's FFTs) differ by ~5e-6 relative
    # at ell 0.15, which three epochs carry to ~2e-5 (tests/test_mp_train.py
    # runs 30 and takes 1e-5, JAX's split and single-device solves rounding
    # alike); converged, they agree to ~1e-9
    traj = dict(epochs=3, batch_size=100, lr=0.01, maxiter_cg=60, learn_kernel=True,
                kernel_lr=1e-3)
    ckpt = dict(epochs=2, batch_size=100, lr=0.01, maxiter_cg=60)
    # line integrals by the Monte-Carlo estimator, for the draws
    rng = np.random.default_rng(3)
    xi = rng.uniform(0.1, 0.95, (64, 2))
    mc = dict(ranks.mp_model_kw(64, NG, m=9, ell=0.2, integrated=True))
    return {
        "grads": {
            "natgrad": _grads_case(MF, d300, 100),
            "hyper": _grads_case(MF, d300, 100, compute_hyper_grads=True),
            "hyper-block": _grads_case(BLOCK, d300, 100, compute_hyper_grads=True),
            "hyper-1d": _grads_case(ONE_D, d1, 60, compute_hyper_grads=True),
            "mc-biased": dict(model=mc, state=None, x=xi, y=np.sin(3 * xi[:, 0]),
                              s=np.full(64, 0.1), seed=11,
                              kw=dict(maxiter_cg=60, compute_hyper_grads=True,
                                      integrated_obs=True,
                                      semi_integrated_estimator="mc-biased",
                                      semi_integrated_samps=5)),
        },
        "fits": {
            # the predictions converged: 30 truncated iterations of two PCGs
            # whose sums run in different orders move sigma by ~2e-3 where
            # Knn - kn.kn nearly cancels (tests/test_mp_train.py checks mu
            # alone there)
            "trajectory": _fit_case(MF, d300, traj, dict(theta2_warmstart=True), xq=xq,
                                    predict=dict(maxiter_cg=300)),
            "trajectory-sharded": _fit_case(MF, d300, traj,
                                            dict(theta2_warmstart=True,
                                                 spectrum_mode="sharded")),
            # 91 rows a batch, rounded up to 92 for the two 'dp' positions
            "uneven-no-noise": _fit_case(noise_model, d250,
                                         dict(epochs=2, batch_size=91, lr=0.01,
                                              maxiter_cg=60, learn_noise=True,
                                              kernel_lr=1e-3), s=False),
            "block": _fit_case(BLOCK, d300, dict(epochs=2, batch_size=100, lr=0.01,
                                                 maxiter_cg=60),
                               dict(theta2_warmstart=True), xq=xq,
                               predict=dict(maxiter_cg=300)),
            "1d": _fit_case(ONE_D, d1, dict(epochs=2, batch_size=40, lr=0.01, maxiter_cg=60,
                                            learn_kernel=True, kernel_lr=1e-3),
                            dict(theta2_warmstart=True)),
            "checkpointed": _fit_case(MF, d300, ckpt, dict(checkpoint_every=1),
                                      checkpoint="ckpt", keep_checkpoint="ckpt-epoch2"),
            "resumed": _fit_case(MF, d300, dict(ckpt, epochs=3),
                                 dict(checkpoint_every=1, resume=True), checkpoint="ckpt"),
        },
        "kn_fn": dict(model=ranks.mp_model_kw(120, NG, m=40, dim=1, ell=0.08),
                      state=_jstate_np(ONE_D), x=d1[0][:40], kw=dict(maxiter_cg=60)),
    }


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("mp-train"))
    inputs = _inputs()
    out = launch.run(ranks.mp_train_cases, RANKS, args=(inputs, outdir), device="cpu",
                     timeout_s=900)
    return inputs, out, outdir


def _jfit(c, **kw):
    jm = _jmodel(c["model"])
    cfg = JFitConfig(**c["cfg"])
    s = None if c["s"] is None else jnp.asarray(c["s"])
    fit_kw = {k: v for k, v in c["kw"].items() if k != "spectrum_mode"}
    fit_kw.update(kw)
    st, rep = jsvigp_fit(jm, _jstate(c["model"], c["state"]), jnp.asarray(c["x"]),
                         jnp.asarray(c["y"]), s, cfg, verbose=False, **fit_kw)
    return jm, st, rep


@pytest.mark.parametrize("key", ["natgrad", "hyper", "hyper-block", "hyper-1d"])
def test_mp_elbo_and_grads_match_jax(cluster, key):
    inputs, out, _ = cluster
    c = inputs["grads"][key]
    for r in out[1:]:
        assert r[f"grads/{key}"]["elbo"] == out[0][f"grads/{key}"]["elbo"]
    got = out[0][f"grads/{key}"]
    jm = _jmodel(c["model"])
    jelbo, jg = jm.elbo_and_grads(_jstate(c["model"], c["state"]), jnp.asarray(c["x"]),
                                  jnp.asarray(c["y"]), jnp.asarray(c["s"]), **c["kw"])
    # at the same 30 truncated iterations, tests/test_mp_train.py's limits:
    # the ELBO 1e-4, the natural gradient 1e-5, the hyper-gradients 1e-4
    # (log_sig2; here also log_noise2) and 1e-3 (log_ell)
    np.testing.assert_allclose(got["elbo"], float(jelbo), rtol=1e-4)
    assert _rel(got["theta1"], jg.theta1) < 1e-5
    assert _rel(got["theta2"], jg.theta2) < 1e-5
    if c["kw"].get("compute_hyper_grads"):
        for k, tol in (("log_sig2", 1e-4), ("log_ell", 1e-3), ("log_noise2", 1e-4)):
            np.testing.assert_allclose(got[k], np.asarray(getattr(jg, k)), rtol=tol,
                                       err_msg=k)
        assert got["log_ell"] != 0.0


def test_mp_mc_biased_draws_match_the_single_device_step(cluster):
    # every rank draws the estimator's offset from an identically seeded
    # generator once a step, as the single-device step draws it: the same
    # ELBO and gradients
    inputs, out, _ = cluster
    c = inputs["grads"]["mc-biased"]
    m = ranks.mp_model(c["model"])
    st = m.init_state()
    got = out[0]["grads/mc-biased"]
    want_elbo, want = m.elbo_and_grads(st, torch.tensor(c["x"]), torch.tensor(c["y"]),
                                       torch.tensor(c["s"]),
                                       generator=torch.Generator().manual_seed(c["seed"]),
                                       **c["kw"])
    np.testing.assert_allclose(got["elbo"], float(want_elbo), rtol=1e-8)
    assert _rel(got["theta1"], want.theta1.numpy()) < 1e-7
    for k in ("log_sig2", "log_ell", "log_noise2"):
        np.testing.assert_allclose(got[k], float(getattr(want, k)), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("key", ["trajectory", "uneven-no-noise", "block", "1d"])
def test_mp_svigp_fit_matches_jax(cluster, key):
    inputs, out, _ = cluster
    c = inputs["fits"][key]
    got = out[0][f"fits/{key}"]
    for r in out[1:]:
        np.testing.assert_array_equal(r[f"fits/{key}"]["epoch_elbos"], got["epoch_elbos"])
    cfg_over = {}
    if key == "uneven-no-noise":
        # the single-device fit at the batch mp_svigp_fit rounds 91 up to
        cfg_over = {"cfg": dict(c["cfg"], batch_size=92)}
    jm, st, rep = _jfit({**c, **cfg_over})
    # tests/test_mp_train.py: epoch ELBOs 1e-5, theta 1e-5, the learned
    # hyperparameter 1e-6
    np.testing.assert_allclose(got["epoch_elbos"], rep["epoch_elbos"], rtol=1e-6)
    assert _rel(got["theta1"], st.theta1) < 1e-6
    assert _rel(got["theta2"], st.theta2) < 1e-6
    for k in ("log_sig2", "log_ell", "log_noise2"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(st, k)), rtol=1e-6, err_msg=k)
    if rep.get("natgrad_rho") is not None:
        np.testing.assert_allclose(got["rho"], rep["natgrad_rho"], rtol=1e-6)
    if "predict" in c:
        mu, sig = jm.predict(st, jnp.asarray(c["xq"]), **c["predict"])
        # tests/test_mp_train.py's 1e-4 / 5e-5
        np.testing.assert_allclose(got["mu"], np.asarray(mu), rtol=1e-4, atol=5e-5)
        np.testing.assert_allclose(got["sig"], np.asarray(sig), rtol=1e-4, atol=5e-5)


def test_mp_fit_sharded_spectrum_matches_host(cluster):
    # the split spectrum build is differentiable: hyperparameters learn
    # without any rank holding all M' eigenvalues (tests/test_mp_train.py:
    # ELBOs 1e-4, theta1 1e-4, log_ell 1e-6)
    _, out, _ = cluster
    h, s = out[0]["fits/trajectory"], out[0]["fits/trajectory-sharded"]
    np.testing.assert_allclose(s["epoch_elbos"], h["epoch_elbos"], rtol=1e-6)
    assert _rel(s["theta1"], h["theta1"]) < 1e-5
    np.testing.assert_allclose(s["log_ell"], h["log_ell"], rtol=1e-8)


def test_mp_kn_fn_1d_four_step_matches_jax(cluster):
    # each rank's (rows, M'/2) block, gathered: JAX's compute_kn at the same
    # 60 iterations (tests/test_mp_train.py: 1e-6 / 1e-8)
    inputs, out, _ = cluster
    c = inputs["kn_fn"]
    r = out[0]["kn_fn"]
    jm = _jmodel(c["model"])
    st = _jstate(c["model"], c["state"])
    Knm, Knn = jm.make_grams(st, jnp.asarray(c["x"]))
    kn = jm.compute_kn(st, Knm, maxiter_cg=60)
    assert r["local_shape"] == (20, 1)
    assert [o["kn_fn"]["offset"] for o in out] == [0, jm.Mprime // 2] * 2
    np.testing.assert_allclose(r["kn"], np.asarray(kn), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(r["knn"], np.asarray(Knn))


def test_mp_checkpoint_holds_the_whole_state_and_resumes_in_both_packages(cluster,
                                                                           tmp_path):
    # rank 0 writes the gathered state: each file equals the fit's whole
    # state; the port's resumed third epoch and the JAX package's, from a
    # copy of the epoch-2 directory, match the uninterrupted single-device
    # JAX fit (no warm start or shuffle: a resumed fit is the uninterrupted
    # one)
    inputs, out, outdir = cluster
    ck, rs = out[0]["fits/checkpointed"], out[0]["fits/resumed"]
    c = inputs["fits"]["resumed"]

    def file_state(d):
        like = convert.state_from_numpy({k: ck[k] for k in convert.STATE_FIELDS},
                                        device="cpu")
        return tckpt.load_pytree(os.path.join(outdir, d, "state.npz"), like)

    for d, want in (("ckpt-epoch2", ck), ("ckpt", rs)):
        st_file = file_state(d)
        for k in convert.STATE_FIELDS:
            np.testing.assert_array_equal(getattr(st_file, k).numpy(), want[k], err_msg=k)
    assert ck["steps"] == 6 and rs["steps"] == 3
    fit_kw = {k: v for k, v in c["kw"].items() if k not in ("checkpoint_every", "resume")}
    _, jst, jrep = _jfit(c, **fit_kw)
    # tests/test_mp_train.py's trajectory limits (1e-5), tighter
    assert _rel(rs["theta1"], jst.theta1) < 1e-6
    assert _rel(rs["theta2"], jst.theta2) < 1e-6
    np.testing.assert_allclose(rs["epoch_elbos"], jrep["epoch_elbos"][2:], rtol=1e-6)
    jdir = tmp_path / "jax-resume"
    shutil.copytree(os.path.join(outdir, "ckpt-epoch2"), jdir)
    _, jres, jres_rep = _jfit(c, checkpoint_dir=str(jdir), checkpoint_every=1, resume=True)
    assert _rel(rs["theta1"], jres.theta1) < 1e-6
    np.testing.assert_allclose(rs["epoch_elbos"], jres_rep["epoch_elbos"], rtol=1e-6)
