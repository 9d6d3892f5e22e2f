"""The drivers of the PyTorch port's dense SVGP, derivative GP and studies
(hipgp_tpu_torch.experiments: demo_1d, natgrad_trajectory,
precision_study, run_synthetic --models SVGP, ref_compat) against the JAX
package's drivers at the cut sizes of its tests (tests/test_experiments.py);
run_derivative_1d is tests/test_torch_a7_derivative.py, run_3droad and
run_ukhousing tests/test_torch_a7_uci.py.

Both packages run float64 on the CPU.  The live-reference legs need the
ziggy checkout and skip without it, as tests/test_natgrad_trajectory.py
does.  Each tolerance is stated where it is asserted.
"""
import csv
import json
import os
import types

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu.experiments import demo_1d as jdemo
from hipgp_tpu.experiments import natgrad_trajectory as jtraj
from hipgp_tpu.experiments import run_synthetic as jsyn
from hipgp_tpu.experiments.synthetic_data import make_two_dim_data
from hipgp_tpu_torch.experiments import (demo_1d, natgrad_trajectory, precision_study,
                                         ref_compat, run_synthetic)


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _assert_csv_close(got_path, want_path, rtol):
    got, want = _rows(got_path), _rows(want_path)
    assert len(got) == len(want) and list(got[0]) == list(want[0])
    for g, w in zip(got, want):
        for k in w:
            try:
                wv = float(w[k])
            except ValueError:
                assert g[k] == w[k], k
                continue
            assert float(g[k]) == pytest.approx(wv, rel=rtol, abs=1e-12, nan_ok=True), k


def _assert_predictions_close(got_dir, want_dir, rtol):
    got, want = np.load(got_dir / "predictions.npz"), np.load(want_dir / "predictions.npz")
    assert set(got.files) == set(want.files)
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-10, err_msg=k)
    _assert_csv_close(got_dir / "noise_reduction.csv", want_dir / "noise_reduction.csv", rtol)


# ---------------------------------------------------------------------------
# demo_1d
# ---------------------------------------------------------------------------

def test_demo_1d_matches_jax_and_plots(tmp_path):
    want = jdemo.main(["--n", "150", "--num-inducing", "24",
                       "--out", str(tmp_path / "jax.png")])
    got = demo_1d.main(["--n", "150", "--num-inducing", "24", "--f64", "--device", "cpu",
                        "--out", str(tmp_path / "port.png")])
    assert set(got) == set(want) == {"SVGP (dense)", "HIP-GP (mean-field)"}
    for name, (mu, sig) in want.items():
        np.testing.assert_allclose(got[name][0], np.asarray(mu), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(got[name][1], np.asarray(sig), rtol=1e-8)
    assert os.path.getsize(tmp_path / "port.png") > 0
    # the fit alone, as the card runs it: both RMSEs below 0.1
    results, _ = demo_1d.fit(dtype=torch.float64, device="cpu")
    assert all(r[2] < 0.1 for r in results.values())


# ---------------------------------------------------------------------------
# the natgrad trajectory study
# ---------------------------------------------------------------------------

def _traj_args(**kw):
    base = dict(nobs=200, ntest=100, m1=8, epochs=2, batch_size=100, lr=1e-2,
                schedule_lr=False, step_decay=0.99, maxiter_cg=20, predict_maxiter_cg=50,
                ell=0.2, sig2=None, noise=0.1, gridnum=30, seed=42, warmstart=False,
                paper=False, family="mean-field", xblock_size=4, learn_kernel=False,
                kernel_lr=1e-3, safe_lr="warn", device="cpu", output_dir=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.fixture(scope="module")
def traj_data():
    args = _traj_args()
    data = make_two_dim_data(Nobs=args.nobs, Ntest=args.ntest, noise_std=args.noise,
                             gridnum=args.gridnum, seed=args.seed)
    return {k: np.asarray(v) if v is not None else None for k, v in data.items()}


def _assert_rows_close(got, want, keys, rtol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in keys:
            assert g[k] == pytest.approx(w[k], rel=rtol), k


def test_trajectory_torch_legs_match_jax_legs(traj_data):
    # nobs 200, m1 8, 2 epochs: the port's 'torch' leg against JAX's 'jax'
    # leg, 'chol' against 'chol' and 'torch-svgp' against 'jax-svgp', the
    # per-epoch ELBO, RMSE and coverage, 1e-8
    args = _traj_args(sig2=float(np.var(traj_data["yobs"]) - 0.1 ** 2))
    for wt, jtag, ttag in (("ziggy", "jax", "torch"), ("cholesky", "chol", "chol")):
        want = jtraj.run_jax(traj_data, args, wt, jtag)
        got = natgrad_trajectory.run_torch(traj_data, args, wt, ttag)
        _assert_rows_close(got, want, ("elbo", "rmse", "cov1", "cov2"), 1e-8)
    want = jtraj.run_jax_svgp(traj_data, args)
    got = natgrad_trajectory.run_torch_svgp(traj_data, args)
    _assert_rows_close(got, want, ("elbo", "rmse"), 1e-8)


def test_trajectory_main_writes_each_leg_and_solve(tmp_path):
    out = natgrad_trajectory.main(["--modes", "torch", "solve", "torch-svgp", "compare",
                                   "--nobs", "200", "--m1", "8", "--epochs", "2",
                                   "--device", "cpu", "--output-dir", str(tmp_path)])
    for leg in ("torch", "solve", "torch-svgp"):
        rows = _rows(tmp_path / f"{leg}.csv")
        assert all(np.isfinite(float(r["rmse"])) for r in rows)
    assert len(out["torch"]) == 2 and out["compare"] == {}
    assert json.load(open(tmp_path / "compare.json")) == {}


def test_reference_legs_raise_without_the_checkout(monkeypatch, tmp_path):
    monkeypatch.setattr(ref_compat, "REF_ROOT", str(tmp_path / "nowhere"))
    with pytest.raises(FileNotFoundError, match="live reference"):
        natgrad_trajectory.main(["--modes", "ref", "--nobs", "50", "--m1", "4",
                                 "--device", "cpu", "--output-dir", str(tmp_path)])


@pytest.mark.skipif(not ref_compat.reference_present(), reason="reference not present")
def test_reference_legs_pair_with_the_port(tmp_path):
    # the live reference's natgrad and dense SVGP against the port's legs
    natgrad_trajectory.main(["--modes", "ref", "torch", "ref-svgp", "torch-svgp", "compare",
                             "--nobs", "200", "--m1", "8", "--epochs", "2",
                             "--device", "cpu", "--output-dir", str(tmp_path)])
    cmp = json.load(open(tmp_path / "compare.json"))
    assert cmp["torch"]["max_abs_rmse_dev"] <= 1e-6
    assert cmp["torch-svgp"]["max_abs_rmse_dev"] <= 1e-6


# ---------------------------------------------------------------------------
# the precision study, run_synthetic --models SVGP
# ---------------------------------------------------------------------------

def test_precision_study_runs_and_restores_its_switches(tmp_path):
    before = precision_study.switch_values()
    out = precision_study.main(["--device", "cpu", "--m1-2d", "12", "--m-1d", "4096",
                                "--bsz-2d", "3", "--bsz-1d", "2", "--reps", "1",
                                "--output-dir", str(tmp_path)])
    assert precision_study.switch_values() == before
    for regime, n in (("2d", 6), ("1d", 2)):
        rows = json.load(open(tmp_path / f"summary_{regime}.json"))["rows"]
        assert len(rows) == n == len(out[regime])
        for r in rows:
            assert np.isfinite(r["apply_ms"]) and np.isfinite(r["whiten20_ms"])
            # float32 against the float64 oracle (bfloat16 operands: ~1e-2)
            assert r["rel_err_vs_f64"] <= (5e-2 if r["policy"] == "einsum-bf16" else 1e-5)
    routes = {r["policy"]: r["generic_route"]
              for r in json.load(open(tmp_path / "summary_2d.json"))["rows"]}
    assert routes["torch.fft"] == "torch.fft" and routes["einsum-fp32"] == "einsum"


def test_run_synthetic_svgp_matches_jax(tmp_path):
    # --models SVGP through the harness (the unwhitened dense SVGP over the
    # 8 x 8 grid): both CSVs of the run and the predictions, 1e-8, at a
    # constant lr (optax rounds a scheduled one to float32, ROADMAP C)
    argv = ["--nobs", "300", "--ntest", "60", "--num-inducing", "8", "--gridnum", "12",
            "--models", "SVGP", "--ell", "0.3", "--epochs", "2", "--batch-size", "100",
            "--no-schedule-lr", "--f64"]
    jsyn.main(argv + ["--output-dir", str(tmp_path / "jax")])
    out = run_synthetic.main(argv + ["--output-dir", str(tmp_path / "port"),
                                     "--device", "cpu"])
    _assert_csv_close(tmp_path / "port" / "errordf-summary.csv",
                      tmp_path / "jax" / "errordf-summary.csv", 1e-8)
    _assert_predictions_close(tmp_path / "port" / "SVGP-SqExp",
                              tmp_path / "jax" / "SVGP-SqExp", 1e-8)
    assert out["model"] == "SVGP-SqExp" and out["steps"] == 6
    for fig in ("posterior-grid.jpg", "comparison-grid.jpg", "elbo.jpg", "qq.pdf"):
        assert (tmp_path / "port" / "SVGP-SqExp" / fig).exists()
