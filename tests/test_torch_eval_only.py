"""Parity of the port's evaluation of a saved state and its epoch step with
the JAX package.

``fit_predict_and_save(eval_only_state=)`` (the JAX harness's crash
recovery: restore a saved state, fit nothing, write the evaluation and the
artifacts) in both packages on a state that either package saved, with the
fit functions patched to raise; the restore's shape check; and
``infer.make_train_step``'s epoch against JAX's ``make_train_step`` epoch on
the same state and batches, with and without learned hyperparameters and
cut by ``limit``, and as the one epoch loop of ``svigp_fit``.  The
'dp' and 'mp' cases of the eval-only path run in the rank clusters of
tests/test_torch_parallel.py and tests/test_torch_mp.py.  Everything runs
on the CPU in float64, on 12^2 and 16^2 grids; each tolerance is stated
where it is asserted.
"""
import csv
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu import kernels as jkernels
from hipgp_tpu.experiments import harness as jharness
from hipgp_tpu.infer import FitConfig as JFitConfig
from hipgp_tpu.infer import fit as jfit
from hipgp_tpu.models import HIPGP as JHIPGP
from hipgp_tpu.utils import checkpoint as jckpt
from hipgp_tpu_torch import convert
from hipgp_tpu_torch import kernels as tkernels
from hipgp_tpu_torch.experiments import harness
from hipgp_tpu_torch.infer import FitConfig, make_train_step, svigp_fit
from hipgp_tpu_torch.infer import fit as tfit
from hipgp_tpu_torch.infer.fit import make_optimizer, prepare_batches
from hipgp_tpu_torch.models import HIPGP
from hipgp_tpu_torch.utils import checkpoint as tckpt

N, M1, ELL, NOISE = 200, 12, 0.2, 0.01
GRIDS = [np.linspace(-1, 1, M1)] * 2


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = rng.uniform(-0.95, 0.95, (N, 2))
    f = lambda a: np.sin(3 * a[:, 0]) * np.cos(2 * a[:, 1])
    s = rng.uniform(0.03, 0.08, N)
    xt = rng.uniform(-0.9, 0.9, (60, 2))
    g = np.linspace(-0.9, 0.9, 8)
    xg = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    return dict(x=x, y=f(x) + s * rng.standard_normal(N), s=s, xt=xt, ft=f(xt), xg=xg,
                fg=f(xg))


def _jmodel(grids=GRIDS, num_obs=N, sig2=0.5, ell=ELL, learn=False):
    return JHIPGP(jkernels.SqExp(), [jnp.asarray(g) for g in grids], num_obs=num_obs,
                  sig2_init=sig2, ell_init=ell, noise2_init=NOISE ** 2, init_Svar=1.0,
                  jitter=1e-3, learn_kernel=learn, learn_noise=learn, dtype=jnp.float64)


def _tmodel(grids=GRIDS, num_obs=N, sig2=0.5, ell=ELL, learn=False):
    return HIPGP(tkernels.SqExp(), grids, num_obs=num_obs, sig2_init=sig2, ell_init=ell,
                 noise2_init=NOISE ** 2, init_Svar=1.0, jitter=1e-3, learn_kernel=learn,
                 learn_noise=learn, dtype=torch.float64, device="cpu")


def _jstate(jm, key=3):
    # a state away from the prior, so the predictions depend on every leaf
    st = jm.init_state(jax.random.PRNGKey(key))
    return st.replace(theta1=st.theta1 * 30.0, theta2=st.theta2 * 2.0,
                      log_ell=st.log_ell + 0.1)


def _csv_rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _assert_same_csv(got_path, want_path, rtol=1e-7, atol=1e-10):
    got, want = _csv_rows(got_path), _csv_rows(want_path)
    assert got[0] == want[0] and len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b
                continue
            assert fa == pytest.approx(fb, rel=rtol, abs=atol), (got_path, a, b)


def _no_fit(*args, **kwargs):
    raise AssertionError("an eval-only run fitted")


@pytest.mark.parametrize("saved_by", ["jax", "torch"])
def test_eval_only_harness_matches_jax(data, tmp_path, monkeypatch, saved_by):
    # the same eval-only harness run in both packages on one file: the metric
    # CSVs within 1e-7 relative (1e-10 absolute), the same files (the
    # figures included: matplotlib imports here), fit_params.json's
    # fit_method the one passed in, time_report.csv's columns JAX's, the
    # restored state the file's; no fit function runs in either
    js = _jstate(_jmodel())
    path = str(tmp_path / "state.npz")
    if saved_by == "jax":
        jckpt.save_pytree(path, js)
    else:
        st = convert.state_from_numpy({k: np.asarray(getattr(js, k))
                                       for k in convert.STATE_FIELDS}, device="cpu")
        tckpt.save_pytree(path, st.replace(theta1=st.theta1 * -0.5))
    for mod, cls in ((harness, HIPGP), (jharness, JHIPGP)):
        monkeypatch.setattr(mod, "svigp_fit", _no_fit)
        monkeypatch.setattr(cls, "batch_solve", _no_fit)
    kw = dict(name="run", xobs=data["x"], yobs=data["y"], sobs=data["s"],
              xinduce_grids=GRIDS, kernel="SqExp", sig2_init="marginal", ell_init=ELL,
              noise2_init=NOISE, fit_method="natgrad", maxiter_cg=10, xtest=data["xt"],
              ftest=data["ft"], xgrid=data["xg"], fgrid=data["fg"], grid_shape=(8, 8),
              grid_extent=(-0.9, 0.9, -0.9, 0.9), eval_only_state=path)
    _, jst, jrep = jharness.fit_predict_and_save(output_dir=str(tmp_path / "jax"),
                                                 dtype=jnp.float64, **kw)
    _, tst, trep = harness.fit_predict_and_save(output_dir=str(tmp_path / "torch"),
                                                dtype=torch.float64, device="cpu", **kw)
    tdir, jdir = tmp_path / "torch" / "run", tmp_path / "jax" / "run"
    for name in ("errordf-summary.csv", "noise_reduction.csv", "coverage_table.csv"):
        _assert_same_csv(tdir / name, jdir / name)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert "elbo_trace.npy" not in os.listdir(tdir)
    for d in (tdir, jdir):
        with open(d / "fit_params.json") as f:
            assert json.load(f)["fit_method"] == "natgrad"
    with open(tdir / "time_report.csv") as f:
        assert next(csv.reader(f)) == list(pd.read_csv(jdir / "time_report.csv").columns)
    assert trep["elbo_trace"] is None and trep["epoch_elbos"] == []
    assert trep["elbo_trace"] == jrep["elbo_trace"]
    assert trep["epoch_elbos"] == jrep["epoch_elbos"]
    assert trep["time_report"]["fitting"] >= 0.0
    with np.load(path) as saved:
        for i, k in enumerate(convert.STATE_FIELDS):
            np.testing.assert_array_equal(getattr(tst, k).numpy(), saved[f"arr_{i}"])
            np.testing.assert_array_equal(np.asarray(getattr(jst, k)), saved[f"arr_{i}"])
    # each prediction itself: the 50-iteration prediction PCGs of the two
    # packages round differently (JAX's FFTs, the port's real-basis
    # products) and stop short of convergence on this grid, which moves a
    # single mean by up to ~3e-7 relative (1.7e-8 absolute)
    for k in ("fmu_test", "fsig_test", "fmu_grid", "fsig_grid"):
        np.testing.assert_allclose(trep["pdict"][k], jrep["pdict"][k], rtol=1e-6,
                                   atol=1e-9, err_msg=k)


def test_eval_only_rejects_a_mismatched_file(tmp_path):
    # a 10^2 model's state for the 12^2 model: ValueError naming the file
    # and both shapes, before any evaluation
    small = _tmodel(grids=[np.linspace(-1, 1, 10)] * 2)
    path = str(tmp_path / "small.npz")
    tckpt.save_pytree(path, small.init_state())
    want = tuple(_tmodel().init_state().theta1.shape)
    got = tuple(small.init_state().theta1.shape)
    with pytest.raises(ValueError) as e:
        harness.restore_eval_state(_tmodel(), path)
    assert path in str(e.value) and str(got) in str(e.value) and str(want) in str(e.value)


def test_run_domain_eval_only_runs_no_fit(tmp_path, monkeypatch):
    # run_domain --eval-only-state goes through the harness's restore and
    # runs no fit: svigp_fit and batch_solve patched to raise
    from hipgp_tpu_torch.experiments import run_domain

    argv = ["--device", "cpu", "--nobs", "300", "--ntest", "40", "--nx", "6", "--nz", "4"]
    out = run_domain.main(argv + ["--output-dir", str(tmp_path)])
    calls = []
    restore = harness.restore_eval_state
    monkeypatch.setattr(run_domain, "restore_eval_state",
                        lambda *a, **k: calls.append(a[1:]) or restore(*a, **k))
    monkeypatch.setattr(run_domain, "svigp_fit", _no_fit)
    monkeypatch.setattr(HIPGP, "batch_solve", _no_fit)
    again = run_domain.main(argv + ["--eval-only-state", str(tmp_path / "state.npz"),
                                    "--output-dir", str(tmp_path / "eval")])
    assert calls == [(str(tmp_path / "state.npz"), None, None)]
    assert again["steps"] == 0 and again["fit_method"] == "eval-only"
    assert again["e_post_rmse"] == pytest.approx(out["e_post_rmse"], rel=1e-12)


# ---------------------------------------------------------------------------
# the epoch step
# ---------------------------------------------------------------------------

TRAIN_N, TRAIN_M = 512, 16


@pytest.fixture(scope="module")
def train_data():
    rng = np.random.default_rng(42)
    x = rng.uniform(-0.95, 0.95, (TRAIN_N, 2))
    s = np.full(TRAIN_N, NOISE)
    return x, np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + s * rng.standard_normal(TRAIN_N), s


@pytest.mark.parametrize("learn,limit", [(False, None), (True, None), (True, 2)])
def test_make_train_step_matches_jax(train_data, learn, limit):
    # one epoch (M = 16^2, N = 512, batch 128: four batches, 10 PCG
    # iterations; natgrad, and with learn Adam at kernel_lr 1e-2 on the
    # three log-hypers) from the same state and batches: the port's
    # epoch_step against JAX's jitted scan (on the first `limit` batches
    # where the port's epoch is cut), state and ELBOs within 1e-8 relative
    # (float64 rounding of truncated solves; a constant natgrad lr, because
    # optax rounds a scheduled lr to float32)
    x, y, s = train_data
    grids = [np.linspace(-1, 1, TRAIN_M)] * 2
    jm = _jmodel(grids, TRAIN_N, sig2=0.4, ell=0.08, learn=learn)
    tm = _tmodel(grids, TRAIN_N, sig2=0.4, ell=0.08, learn=learn)
    js = _jstate(jm)
    ts = convert.state_from_numpy({k: np.asarray(getattr(js, k))
                                   for k in convert.STATE_FIELDS}, device="cpu")
    jcfg = JFitConfig(epochs=1, batch_size=128, maxiter_cg=10, schedule_lr=False,
                      learn_kernel=learn, learn_noise=learn, kernel_lr=1e-2)
    cfg = FitConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(FitConfig)})
    # a learned noise replaces the per-point one, as svigp_fit drops it
    s = None if learn else s
    jb = jfit.prepare_batches(jnp.asarray(x), jnp.asarray(y),
                              None if s is None else jnp.asarray(s), 128)
    nb = jb[0].shape[0] if limit is None else limit
    jopt = jfit.make_optimizer(js, jcfg)
    jepoch = jfit.make_train_step(jm, jcfg, jopt)
    jst, _, _, jelbos = jepoch(js, jopt.init(js), jax.random.PRNGKey(0),
                               *(None if a is None else a[:nb] for a in jb))
    tb = prepare_batches(torch.as_tensor(x), torch.as_tensor(y),
                         None if s is None else torch.as_tensor(s), 128)
    opt = make_optimizer(ts, cfg)
    epoch = make_train_step(tm, cfg, opt)
    gen = torch.Generator().manual_seed(0)
    tst, opt2, gen2, elbos = epoch(ts, opt, gen, *tb, limit=limit)
    assert opt2 is opt and gen2 is gen and opt.count == nb
    assert tuple(elbos.shape) == (nb,)
    np.testing.assert_allclose(elbos.numpy(), np.asarray(jelbos), rtol=1e-8)
    for k in convert.STATE_FIELDS:
        got, want = getattr(tst, k).numpy(), np.asarray(getattr(jst, k))
        assert np.linalg.norm(got - want) <= 1e-8 * np.linalg.norm(want), k
        if k.startswith("log_"):
            assert (float(got) != float(getattr(js, k))) == learn, k


def test_svigp_fit_runs_its_epochs_through_make_train_step(train_data, monkeypatch):
    # svigp_fit's one epoch loop is make_train_step's: every epoch is one
    # epoch_step call, max_steps its limit, and the fit's trace is what the
    # calls returned
    x, y, s = train_data
    grids = [np.linspace(-1, 1, 8)] * 2
    tm = _tmodel(grids, TRAIN_N, sig2=0.4, ell=0.2)
    calls, traces = [], []

    def counted(*a, **k):
        step = make_train_step(*a, **k)

        def epoch_step(*args, limit=None):
            calls.append(limit)
            out = step(*args, limit=limit)
            traces.append(out[-1].numpy())
            return out

        return epoch_step

    monkeypatch.setattr(tfit, "make_train_step", counted)
    cfg = FitConfig(epochs=3, batch_size=128, maxiter_cg=5)
    _, rep = svigp_fit(tm, tm.init_state(), x, y, s, cfg, verbose=False, max_steps=6)
    assert calls == [6, 2]
    assert rep["steps"] == 6
    np.testing.assert_array_equal(rep["elbo_trace"], np.concatenate(traces))
