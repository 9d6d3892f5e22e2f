"""Fit resume in the PyTorch port (hipgp_tpu_torch) against the JAX package.

The optimizer's saved form (the leaves of the JAX package's optax state, in
its flatten order, with its treedef string), checkpoints written by one
package and resumed by the other, the port's own resume against its
uninterrupted fit, and the two ways a resumed fit differs from an
uninterrupted one in both packages (the theta2 warm start and its lr clamp
are skipped; a shuffled fit restarts its permutation stream).  Both sides
get the same float64 inputs, made with numpy from a seed, on the CPU; each
tolerance is stated where it is asserted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu.infer import FitConfig as JFitConfig
from hipgp_tpu.infer import svigp_fit as jsvigp_fit
from hipgp_tpu.infer.fit import make_optimizer as jmake_optimizer
from hipgp_tpu.kernels import SqExp as JSqExp
from hipgp_tpu.models import HIPGP as JHIPGP
from hipgp_tpu.models.hipgp import HIPGPState as JState
from hipgp_tpu.utils import checkpoint as jckpt
from hipgp_tpu_torch import convert
from hipgp_tpu_torch.infer import FitConfig, svigp_fit
from hipgp_tpu_torch.infer.fit import make_optimizer
from hipgp_tpu_torch.kernels import SqExp
from hipgp_tpu_torch.models import HIPGP, HIPGPState
from hipgp_tpu_torch.utils import checkpoint

HYPERS = ("log_sig2", "log_ell", "log_noise2")


def _data(n=40):
    # the data of the JAX package's test_fit_resume_roundtrip
    # (tests/test_hipgp_model.py: make_data, seed 0)
    rng = np.random.default_rng(0)
    x = rng.uniform(0.05, 0.95, (n, 2))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.1 * rng.standard_normal(n)
    return x, y, np.full(n, 0.1)


def _models(whitened="cholesky", learn=False, m=8):
    # the JAX test's model (SqExp on an m x m grid of [0, 1]^2, ell 0.2,
    # sig2 1, noise2 0.01), in both packages, and its init state in both
    grids = [np.linspace(0.0, 1.0, m)] * 2
    kw = dict(num_obs=40, family="mean-field", whitened_type=whitened, ell_init=0.2,
              sig2_init=1.0, noise2_init=0.01, learn_kernel=learn, learn_noise=learn)
    jm = JHIPGP(JSqExp(), [jnp.asarray(g) for g in grids], dtype=jnp.float64, **kw)
    tm = HIPGP(SqExp(), grids, dtype=torch.float64, device="cpu", **kw)
    jst = jm.init_state()
    tst = convert.state_from_numpy(
        {k: np.asarray(getattr(jst, k)) for k in convert.STATE_FIELDS}, device="cpu")
    return jm, tm, jst, tst


def _cfgs(**kw):
    jcfg = JFitConfig(**{"batch_size": 20, "lr": 0.02, "maxiter_cg": 20, **kw})
    return jcfg, FitConfig(**{f.name: getattr(jcfg, f.name)
                              for f in dataclasses.fields(FitConfig)})


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _assert_states_close(tst, jst, tol):
    for f in convert.STATE_FIELDS:
        got, want = getattr(tst, f), getattr(jst, f)
        if f.startswith("theta"):
            assert _rel(got, want) <= tol, (f, _rel(got, want))
        else:
            assert abs(float(got) - float(want)) <= tol * max(abs(float(want)), 1.0), f


# ---------------------------------------------------------------------------
# the optimizer's saved form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", [True, False])
@pytest.mark.parametrize("learn", [True, False])
def test_optimizer_leaves_match_optax(schedule, learn):
    # the four optimizer configurations: FitOptimizer.leaves against
    # jax.tree.flatten of the JAX package's make_optimizer state, fresh and
    # after 3 steps on the same random gradients: the same number of leaves,
    # shapes and dtypes, values within 1e-12 (the counts exact), and the
    # same treedef string; load_leaves puts a fresh optimizer where the
    # stepped one is
    rng = np.random.default_rng(11)
    M = 6
    start = dict(theta1=rng.standard_normal(M), theta2=-np.abs(rng.standard_normal(M)),
                 log_sig2=np.array(0.3), log_ell=np.array(np.log(0.2)),
                 log_noise2=np.array(np.log(0.01)))
    jst = JState(**{k: jnp.asarray(v) for k, v in start.items()})
    tst = HIPGPState(**{k: torch.as_tensor(v) for k, v in start.items()})
    jcfg, cfg = _cfgs(schedule_lr=schedule, learn_kernel=learn, learn_noise=learn,
                      kernel_lr=1e-2)
    jopt = jmake_optimizer(jst, jcfg)
    jos = jopt.init(jst)
    topt = make_optimizer(tst, cfg)
    for step in range(4):
        jleaves, jtree = jax.tree.flatten(jos)
        tleaves = topt.leaves(tst)
        assert len(tleaves) == len(jleaves) == (7 if learn else 0) + (1 if schedule else 0)
        for t, j in zip(tleaves, jleaves):
            j = np.asarray(j)
            assert tuple(t.shape) == j.shape and t.numpy().dtype == j.dtype
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-12, atol=0)
        if step == 3:
            break
        g = {k: rng.standard_normal(np.shape(v)) * 10 ** rng.uniform(-2, 1)
             for k, v in start.items()}
        upd, jos = jopt.update(JState(**{k: jnp.asarray(v) for k, v in g.items()}), jos, jst)
        jst = optax.apply_updates(jst, upd)
        tst = topt.step(tst, HIPGPState(**{k: torch.as_tensor(v) for k, v in g.items()}))
    assert topt.treedef(tst) == str(jtree)
    for k in HYPERS:   # Adam's update of the hypers (none moves without learn)
        assert abs(float(getattr(tst, k)) - float(getattr(jst, k))) <= 1e-12
    fresh = make_optimizer(tst, cfg)
    fresh.load_leaves([t.numpy() for t in topt.leaves(tst)], tst)
    assert all(torch.equal(a, b) for a, b in zip(fresh.leaves(tst), topt.leaves(tst)))
    assert fresh.current_lr() == topt.current_lr()
    with pytest.raises(ValueError, match="leaves"):
        fresh.load_leaves([np.int32(0)] * 3, tst)


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", [False, True])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, schedule):
    # the JAX test's protocol: 6 epochs without a break in JAX; 3 epochs in
    # JAX with a checkpoint every epoch; the port resumes that directory to
    # epoch 6.  Against the JAX uninterrupted fit: theta and the last 3
    # epochs' ELBO trace within 1e-10 relative with a constant lr; with the
    # scheduled lr within 1e-7, because optax evaluates the schedule in
    # float32 even under x64 (lr relative error up to 6e-8 a step; an
    # intended difference of the port, ROADMAP section C)
    x, y, s = _data()
    jm, tm, jst0, tst0 = _models()
    jcfg6, cfg6 = _cfgs(epochs=6, schedule_lr=schedule)
    jcfg3, _ = _cfgs(epochs=3, schedule_lr=schedule)
    cdir = str(tmp_path / "ckpt")
    jfull, jrep = jsvigp_fit(jm, jst0, x, y, s, jcfg6, verbose=False)
    jsvigp_fit(jm, jst0, x, y, s, jcfg3, verbose=False, checkpoint_dir=cdir,
               checkpoint_every=1)
    tres, trep = svigp_fit(tm, tst0, x, y, s, cfg6, verbose=False, checkpoint_dir=cdir,
                           resume=True)
    tol = 1e-7 if schedule else 1e-10
    assert trep["steps"] == 6 and len(trep["epoch_elbos"]) == 3
    _assert_states_close(tres, jfull, tol)
    np.testing.assert_allclose(trep["elbo_trace"], jrep["elbo_trace"][6:], rtol=tol)


def test_port_checkpoint_restores_in_jax(tmp_path, monkeypatch):
    # the port fits 2 epochs with learn_kernel and learn_noise (Adam on the
    # hypers, the scheduled lr) and a checkpoint every epoch; JAX's
    # restore_checkpoint reads the directory with its own templates: the
    # state bit for bit, the 8 optimizer leaves as the fit's optimizer held
    # them when it saved (the counts exact, the moments bit for bit: float64
    # both ways) and the step
    import hipgp_tpu_torch.infer.fit as tfit

    x, y, s = _data()
    jm, tm, jst0, tst0 = _models(whitened="ziggy", learn=True)
    jcfg, cfg = _cfgs(epochs=2, learn_kernel=True, learn_noise=True, kernel_lr=1e-2)
    cdir = str(tmp_path / "ckpt")
    captured = {}

    def spy(odir, state, opt_state=None, step=0, extra=None):
        captured.update(state=state, step=step,
                        leaves=[t.clone() for t in opt_state.leaves(state)])
        checkpoint.save_checkpoint(odir, state, opt_state, step, extra)

    monkeypatch.setattr(tfit, "save_checkpoint", spy)
    svigp_fit(tm, tst0, x, y, s, cfg, verbose=False, checkpoint_dir=cdir,
              checkpoint_every=1)
    topt_saved = captured["leaves"]
    jopt = jmake_optimizer(jst0, jcfg)
    jst, jos, step = jckpt.restore_checkpoint(cdir, jst0, jopt.init(jst0))
    assert step == captured["step"] == 2
    for f in convert.STATE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jst, f)),
                                      getattr(captured["state"], f).numpy())
    jleaves = jax.tree.flatten(jos)[0]
    assert len(jleaves) == len(topt_saved) == 8
    for j, t in zip(jleaves, topt_saved):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    assert int(jleaves[0]) == int(jleaves[-1]) == 4   # Adam's and the schedule's counts


def test_port_checkpoint_resumes_in_jax(tmp_path):
    # the port fits 3 epochs with a checkpoint every epoch (constant lr); JAX
    # resumes the directory to epoch 6; against the port's own uninterrupted
    # 6 epochs: theta within 1e-10 relative
    x, y, s = _data()
    jm, tm, jst0, tst0 = _models()
    jcfg6, cfg6 = _cfgs(epochs=6, schedule_lr=False)
    _, cfg3 = _cfgs(epochs=3, schedule_lr=False)
    cdir = str(tmp_path / "ckpt")
    tfull, _ = svigp_fit(tm, tst0, x, y, s, cfg6, verbose=False)
    svigp_fit(tm, tst0, x, y, s, cfg3, verbose=False, checkpoint_dir=cdir,
              checkpoint_every=1)
    jres, jrep = jsvigp_fit(jm, jst0, x, y, s, jcfg6, verbose=False, checkpoint_dir=cdir,
                            resume=True)
    assert len(jrep["elbo_trace"]) == 6
    _assert_states_close(tfull, jres, 1e-10)


# ---------------------------------------------------------------------------
# the port's own resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("learn", [False, True])
def test_resume_equals_the_uninterrupted_fit(tmp_path, learn):
    # 4 epochs without a break against 2 epochs with a checkpoint every 2
    # and a resume to 4, the scheduled lr: bit for bit (the same operations
    # in the same order).  With learn_kernel and learn_noise (Adam on the
    # hypers, the ziggy whitening) the hypers, the ELBO trace of epochs 2-3,
    # the optimizer's leaves and its next lr too; the checkpoint's step is 2
    x, y, s = _data()
    _, tm, _, tst0 = _models(whitened="ziggy" if learn else "cholesky", learn=learn)
    kw = dict(learn_kernel=learn, learn_noise=learn, kernel_lr=1e-2)
    _, cfg4 = _cfgs(epochs=4, **kw)
    _, cfg2 = _cfgs(epochs=2, **kw)
    cdir = str(tmp_path / "ckpt")
    full, frep = svigp_fit(tm, tst0, x, y, s, cfg4, verbose=False)
    part, _ = svigp_fit(tm, tst0, x, y, s, cfg2, verbose=False, checkpoint_dir=cdir,
                        checkpoint_every=2)
    res, rrep = svigp_fit(tm, tst0, x, y, s, cfg4, verbose=False, checkpoint_dir=cdir,
                          resume=True)
    for f in convert.STATE_FIELDS:
        assert torch.equal(getattr(res, f), getattr(full, f)), f
    assert rrep["elbo_trace"] == frep["elbo_trace"][4:]
    assert rrep["steps"] == 4 and rrep["epoch_elbos"] == frep["epoch_elbos"][2:]
    if learn:
        assert rrep["ell_trace"] == frep["ell_trace"][2:]
        assert all(float(getattr(full, k)) != float(getattr(tst0, k)) for k in HYPERS)
    # the saved optimizer: what the fit's optimizer held after epoch 2
    opt = make_optimizer(part, cfg4)
    _, got, step = checkpoint.restore_checkpoint(cdir, part, opt)
    assert step == 2 and got is opt and opt.count == 4
    assert (opt.hyper is not None) == learn and (not learn or opt.hyper.count == 4)
    assert opt.current_lr() == cfg4.lr * cfg4.step_decay ** 4
    # max_steps counts this call's steps; an epoch it cuts is not saved
    cut = str(tmp_path / "cut")
    _, crep = svigp_fit(tm, tst0, x, y, s, cfg4, verbose=False, checkpoint_dir=cut,
                        checkpoint_every=1, max_steps=3)
    assert crep["steps"] == 3 and checkpoint.restore_checkpoint(cut, part)[2] == 1
    _, crep = svigp_fit(tm, tst0, x, y, s, cfg4, verbose=False, checkpoint_dir=cut,
                        resume=True, max_steps=3)
    assert crep["steps"] == 3 and len(crep["epoch_elbos"]) == 2
    # no checkpoint in the directory: resume starts from the given state
    fresh, frep2 = svigp_fit(tm, tst0, x, y, s, cfg2, verbose=False,
                             checkpoint_dir=str(tmp_path / "none"), resume=True)
    assert torch.equal(fresh.theta1, part.theta1) and frep2["steps"] == 4


# ---------------------------------------------------------------------------
# the two intended differences of a resumed fit, as in the JAX package
# ---------------------------------------------------------------------------

def test_resume_skips_the_warm_start_and_its_clamp(tmp_path):
    # theta2_warmstart with natgrad_safe_lr='clamp' at an lr the clamp
    # lowers (0.08: the estimated limit 2/rho is 0.124, the clamp halves
    # it, so the unclamped lr is still stable): the uninterrupted fit runs every epoch at the clamped lr, the
    # resumed one restores theta2 (no warm start) and so estimates no rho
    # and runs at config.lr, in JAX as in the port.  The port's resumed fit
    # against JAX's: theta within 1e-10 relative, the same report entries;
    # and it differs from the port's uninterrupted fit
    x, y, s = _data()
    jm, tm, jst0, tst0 = _models()
    jcfg3, cfg3 = _cfgs(epochs=3, schedule_lr=False, lr=0.08)
    jcfg1, cfg1 = _cfgs(epochs=1, schedule_lr=False, lr=0.08)
    kw = dict(theta2_warmstart=True, natgrad_safe_lr="clamp")
    full, frep = svigp_fit(tm, tst0, x, y, s, cfg3, verbose=False, **kw)
    assert frep["lr_used"] < cfg3.lr and frep["natgrad_rho"] is not None
    for fit, m, st, c1, c3 in ((jsvigp_fit, jm, jst0, jcfg1, jcfg3),
                               (svigp_fit, tm, tst0, cfg1, cfg3)):
        d = str(tmp_path / fit.__module__)
        fit(m, st, x, y, s, c1, verbose=False, checkpoint_dir=d, checkpoint_every=1, **kw)
        res = fit(m, st, x, y, s, c3, verbose=False, checkpoint_dir=d, resume=True, **kw)
        if fit is jsvigp_fit:
            jres, jrep = res
        else:
            tres, trep = res
    for rep in (jrep, trep):
        assert rep["lr_used"] == cfg3.lr and rep["natgrad_rho"] is None
    _assert_states_close(tres, jres, 1e-10)
    np.testing.assert_allclose(trep["elbo_trace"], jrep["elbo_trace"], rtol=1e-10)
    assert _rel(tres.theta1, full.theta1) > 1e-6


def test_resume_restarts_the_shuffle_stream(tmp_path):
    # with shuffle the resumed fit starts a fresh default_rng(seed): its
    # first epoch (epoch 1) draws epoch 0's permutation, in JAX as in the
    # port.  The port's resumed fit against JAX's: theta within 1e-10
    # relative; its epoch-1 ELBO trace is not the uninterrupted fit's, and
    # equals that of a fit whose epoch 1 sees epoch 0's permutation
    x, y, s = _data()
    jm, tm, jst0, tst0 = _models()
    jcfg2, cfg2 = _cfgs(epochs=2, schedule_lr=False, shuffle=True, seed=5)
    jcfg1, cfg1 = _cfgs(epochs=1, schedule_lr=False, shuffle=True, seed=5)
    out = {}
    for fit, m, st, c1, c2 in ((jsvigp_fit, jm, jst0, jcfg1, jcfg2),
                               (svigp_fit, tm, tst0, cfg1, cfg2)):
        d = str(tmp_path / fit.__module__)
        fit(m, st, x, y, s, c1, verbose=False, checkpoint_dir=d, checkpoint_every=1)
        out[fit is svigp_fit] = fit(m, st, x, y, s, c2, verbose=False, checkpoint_dir=d,
                                    resume=True)
    (tres, trep), (jres, jrep) = out[True], out[False]
    _assert_states_close(tres, jres, 1e-10)
    np.testing.assert_allclose(trep["elbo_trace"], jrep["elbo_trace"], rtol=1e-10)
    full, frep = svigp_fit(tm, tst0, x, y, s, cfg2, verbose=False)
    assert trep["elbo_trace"] != frep["elbo_trace"][2:]
    # epoch 1 on epoch 0's permutation: the rows in that order, unshuffled
    perm = np.random.default_rng(5).permutation(len(x))
    part, _ = svigp_fit(tm, tst0, x, y, s, cfg1, verbose=False)
    _, cfg_plain = _cfgs(epochs=1, schedule_lr=False)
    again, arep = svigp_fit(tm, part, x[perm], y[perm], s[perm], cfg_plain, verbose=False)
    assert arep["elbo_trace"] == trep["elbo_trace"]
    assert torch.equal(again.theta1, tres.theta1)
