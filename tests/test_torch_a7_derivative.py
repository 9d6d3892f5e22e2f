"""Paper section 5.3's driver on the PyTorch port
(hipgp_tpu_torch.experiments.run_derivative_1d) against the JAX package's
at the cut size of its test (tests/test_experiments.py): the Adam fit of
(sig2, ell) through the closed-form solve in both whitenings, and the
notebook's --compare table.  Both packages run float64 on the CPU; the JAX
side compiles one Adam step a fit, which is most of this file's time.
"""
import csv

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu.experiments import run_derivative_1d as jder
from hipgp_tpu_torch.experiments import run_derivative_1d


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


@pytest.mark.parametrize("whitened_type", ["cholesky", "ziggy"])
def test_run_derivative_1d_matches_jax(whitened_type, tmp_path):
    # the JAX test's cut size: the summary row, 1e-8, and the loss trace,
    # 1e-8 under the cholesky whitening; under 'ziggy' 1e-7: the loss
    # -ELBO/1e4 is a small difference of large sums, and the two packages'
    # truncated PCG (tol 1e-8 absolute) differ in the last bits of kn
    argv = ["--nlatent", "60", "--nprime", "8", "--num-inducing", "32", "--steps", "5",
            "--maxiter-cg", "40", "--whitened-type", whitened_type, "--f64"]
    jder.main(argv + ["--output-dir", str(tmp_path / "jax")])
    row = run_derivative_1d.main(argv + ["--output-dir", str(tmp_path / "port"),
                                         "--device", "cpu"])
    _assert_csv_close(tmp_path / "port" / "derivative-1d-summary.csv",
                      tmp_path / "jax" / "derivative-1d-summary.csv", 1e-8)
    np.testing.assert_allclose(np.load(tmp_path / "port" / "loss_trace.npy"),
                               np.load(tmp_path / "jax" / "loss_trace.npy"),
                               rtol=1e-8 if whitened_type == "cholesky" else 1e-7)
    assert row["latent_rmse"] < 1.0


def test_run_derivative_1d_compare_matches_jax(tmp_path):
    # the notebook's comparison table, with and without the derivative
    # observations (a zero-row derivative set), 1e-8
    argv = ["--nlatent", "40", "--nprime", "6", "--num-inducing", "24", "--steps", "3",
            "--maxiter-cg", "40", "--f64", "--compare"]
    jder.main(argv + ["--output-dir", str(tmp_path / "jax")])
    rows = run_derivative_1d.main(argv + ["--output-dir", str(tmp_path / "port"),
                                          "--device", "cpu"])
    _assert_csv_close(tmp_path / "port" / "derivative-comparison.csv",
                      tmp_path / "jax" / "derivative-comparison.csv", 1e-8)
    assert [r["model"] for r in rows] == ["ziggy"] * 2 + ["cholesky"] * 2 + ["exact-gp"] * 2
