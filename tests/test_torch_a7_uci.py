"""The Appendix C.3 and section 5.4 drivers of the PyTorch port
(hipgp_tpu_torch.experiments.run_3droad, run_ukhousing) against the JAX
package's, on their synthetic data at the JAX tests' cut sizes
(tests/test_experiments.py) and on small data files the tests write (the
UCI file and the land-registry files are not in the repository).

Both packages run float64 on the CPU: the JAX drivers build their model in
float32 (the harness's default dtype), so the tests run them with the
harness's dtype set to float64; nothing in the JAX package changes.  Each
tolerance is stated where it is asserted.
"""
import csv
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu.experiments import run_3droad as j3d
from hipgp_tpu.experiments import run_ukhousing as juk
from hipgp_tpu_torch.experiments import run_3droad, run_ukhousing


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


@pytest.fixture
def jax_harness_f64(monkeypatch):
    # the JAX drivers' harness call with dtype float64 (its default is float32)
    for mod in (j3d, juk):
        monkeypatch.setattr(mod, "fit_predict_and_save",
                            functools.partial(mod.fit_predict_and_save, dtype=jnp.float64))


def _assert_predictions_close(got_dir, want_dir, rtol):
    got, want = np.load(got_dir / "predictions.npz"), np.load(want_dir / "predictions.npz")
    assert set(got.files) == set(want.files)
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-10, err_msg=k)
    _assert_csv_close(got_dir / "noise_reduction.csv", want_dir / "noise_reduction.csv", rtol)


def test_run_3droad_matches_jax(jax_harness_f64, tmp_path):
    argv = ["--nobs", "400", "--num-inducing", "8", "--ell", "0.5", "--maxiter-cg", "20"]
    j3d.main(argv + ["--output-dir", str(tmp_path / "jax")])
    run_3droad.main(argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu",
                            "--f64"])
    _assert_predictions_close(tmp_path / "port" / "3droad-mean-field",
                              tmp_path / "jax" / "3droad-mean-field", 1e-8)


def test_run_3droad_reads_the_uci_file(jax_harness_f64, tmp_path):
    # the real-data path on a small file of the UCI layout (id, lat, lon, alt)
    rs = np.random.RandomState(5)
    n = 300
    lat, lon = rs.uniform(56.6, 57.7, n), rs.uniform(8.1, 10.4, n)
    alt = 20 * np.sin(3 * lat) * np.cos(2 * lon) + rs.standard_normal(n)
    path = tmp_path / "3D_spatial_network.txt"
    np.savetxt(path, np.column_stack([np.arange(n), lon, lat, alt]), delimiter=",")
    x, y = run_3droad.load_uci_3droad(str(path))
    jx, jy = j3d.load_uci_3droad(str(path))
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    argv = ["--data-path", str(path), "--num-inducing", "8", "--ell", "0.5"]
    j3d.main(argv + ["--output-dir", str(tmp_path / "jax")])
    run_3droad.main(argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu",
                            "--f64"])
    _assert_predictions_close(tmp_path / "port" / "3droad-mean-field",
                              tmp_path / "jax" / "3droad-mean-field", 1e-8)


def test_run_ukhousing_matches_jax(jax_harness_f64, tmp_path):
    argv = ["--nobs", "400", "--ntest", "80", "--num-inducing-x", "10",
            "--num-inducing-y", "8", "--ell", "1.0", "--maxiter-cg", "20"]
    with pytest.warns(RuntimeWarning, match="degenerate"):
        juk.main(argv + ["--output-dir", str(tmp_path / "jax")])
        run_ukhousing.main(argv + ["--output-dir", str(tmp_path / "port"), "--device",
                                   "cpu", "--f64"])
    _assert_predictions_close(tmp_path / "port" / "ukhousing-mean-field",
                              tmp_path / "jax" / "ukhousing-mean-field", 1e-8)


def test_uk_housing_csv_pipeline_matches_jax(jax_harness_f64, tmp_path):
    # the raw land-registry join, the region filter and the noise estimate
    # on small files the test writes, against the JAX (pandas) pipeline;
    # then the driver on the prepared file
    rs = np.random.RandomState(2)
    pcs = [f"AB{i} {i}XY" for i in range(60)]
    with open(tmp_path / "postcodes.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Postcode", "Latitude", "Longitude"])
        for i, pc in enumerate(pcs[:55]):       # five postcodes unknown
            w.writerow([pc, f"{rs.uniform(50.2, 55.3):.6f}", f"{rs.uniform(-5.5, 1.6):.6f}"])
        w.writerow(["ZZ9 9ZZ", "70.1", "-1.0"])  # north of the latitude filter
    with open(tmp_path / "prices.csv", "w", newline="") as f:
        w = csv.writer(f)
        for i in range(400):
            pc = "ZZ9 9ZZ" if i % 97 == 0 else pcs[rs.randint(60)]
            price = 500 if i % 53 == 0 else int(rs.uniform(5e4, 9e5))
            w.writerow([f"{{{i}}}", price, "2018-01-01", pc, "F" if i % 3 else "T", "N"])
    for mod, tag in ((run_ukhousing, "port"), (juk, "jax")):
        mod.prepare_uk_housing_csv(str(tmp_path / "prices.csv"),
                                   str(tmp_path / "postcodes.csv"),
                                   str(tmp_path / f"prepared-{tag}.csv"))
    got, want = _rows(tmp_path / "prepared-port.csv"), _rows(tmp_path / "prepared-jax.csv")
    assert list(got[0]) == ["longitude", "latitude", "log_price"] and len(got) == len(want)
    for g, w in zip(got, want):
        for k in w:
            assert float(g[k]) == pytest.approx(float(w[k]), rel=1e-15), k
    x, y = run_ukhousing.load_prepared_csv(str(tmp_path / "prepared-port.csv"))
    jx, jy = juk.load_prepared_csv(str(tmp_path / "prepared-jax.csv"))
    np.testing.assert_allclose(x, jx, rtol=1e-15)
    np.testing.assert_allclose(y, jy, rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(run_ukhousing.local_noise_estimate(x, y, num_boxes=50),
                                  juk.local_noise_estimate(jx, jy, num_boxes=50))
    argv = ["--ntest", "40", "--num-inducing-x", "8", "--num-inducing-y", "6",
            "--ell", "1.0", "--sig2-init", "0.5"]
    juk.main(argv + ["--data-path", str(tmp_path / "prepared-jax.csv"),
                     "--output-dir", str(tmp_path / "jax")])
    run_ukhousing.main(argv + ["--data-path", str(tmp_path / "prepared-port.csv"),
                               "--output-dir", str(tmp_path / "port"), "--device", "cpu",
                               "--f64"])
    _assert_predictions_close(tmp_path / "port" / "ukhousing-mean-field",
                              tmp_path / "jax" / "ukhousing-mean-field", 1e-8)
