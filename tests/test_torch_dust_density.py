"""The dust-density deposition of the PyTorch port (hipgp_tpu_torch) on the
CPU: the JAX package's six cases (tests/test_dust_density.py: brute-force
numpy oracles, mass conservation, the derived-field formula, a synthetic
snapshot, the kernel's normalization) against the port, the port's
deposition against the JAX package's (which computes in float32), and
run_domain's --snapshot ground truth against the JAX run_domain's.
"""
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu.experiments import dust_density as jdd
from hipgp_tpu.experiments import run_domain as jrun_domain
from hipgp_tpu_torch.experiments import dust_density as tdd
from hipgp_tpu_torch.experiments import run_domain

CPU = dict(device="cpu")


def _cell_centers(left, right, dims):
    axes = [left[d] + (np.arange(dims[d]) + 0.5) * (right[d] - left[d]) / dims[d]
            for d in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    return np.column_stack([gx.ravel(), gy.ravel(), gz.ravel()])


def _sph_oracle(pos, vals, m, rho, hs, left, right, dims):
    """Brute force: A(x) = sum_p (m_p / rho_p) A_p W(|x - x_p|, h_p)."""
    centers = _cell_centers(left, right, dims)
    out = np.zeros(len(centers))
    for p in range(len(pos)):
        q = np.linalg.norm(centers - pos[p], axis=1) / hs[p]
        w = np.where(q < 1.0, 1 - 1.5 * q ** 2 + 0.75 * q ** 3,
                     np.where(q < 2.0, 0.25 * (2 - q) ** 3, 0.0)) / (np.pi * hs[p] ** 3)
        out += (m[p] / rho[p]) * vals[p] * w
    return out.reshape(dims)


def _sph_case(seed=0, n=40):
    rs = np.random.RandomState(seed)
    pos = rs.uniform(-0.8, 0.8, (n, 3))
    vals = rs.uniform(0.5, 2.0, n)
    m = rs.uniform(0.5, 1.5, n)
    rho = rs.uniform(0.5, 1.5, n)
    hs = rs.uniform(0.15, 0.4, n)     # support 2h <= 0.8 < the window's reach
    return pos, vals, m, rho, hs, np.full(3, -1.0), np.full(3, 1.0)


def _snapshot(path, seed, n):
    rs = np.random.RandomState(seed)
    np.savez(path, x=rs.uniform(-1, 1, n), y=rs.uniform(-1, 1, n), z=rs.uniform(-1, 1, n),
             density=rs.uniform(0.5, 1.5, n), hydrogenneutralfraction=rs.uniform(0, 1, n),
             massfraction=rs.uniform(0.05, 0.3, (n, 2)),
             metallicitytotal=rs.uniform(-1, 0.5, n), smoothlength=rs.uniform(0.2, 0.5, n),
             mass=rs.uniform(0.5, 1.5, n))
    return rs


# ---------------------------------------------------------------------------
# the JAX package's six cases, against the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sph_deposit_matches_bruteforce(dtype):
    # the JAX test's case (40 particles, 6 x 5 x 4 cells, chunk 16, window
    # 11), float32 within the JAX test's 2e-5 relative / 1e-7 absolute;
    # float64 within 1e-12 relative
    pos, vals, m, rho, hs, left, right = _sph_case()
    got = tdd.sph_deposit(pos, vals, m, rho, hs, left, right, (6, 5, 4), chunk=16,
                          max_window=11, dtype=dtype, **CPU)
    want = _sph_oracle(pos, vals, m, rho, hs, left, right, (6, 5, 4))
    f32 = dtype == torch.float32
    assert got.dtype == (np.float32 if f32 else np.float64)
    np.testing.assert_allclose(got, want, rtol=2e-5 if f32 else 1e-12,
                               atol=1e-7 if f32 else 1e-14)


def test_sph_deposit_tiny_window_and_h_stay_finite():
    # max_window <= 4 drives the h clip to its quarter-cell floor, and h = 0
    # particles deposit as narrow finite blobs (the JAX test's case)
    rs = np.random.RandomState(2)
    n, dims = 20, (6, 6, 6)
    left, right = np.full(3, -1.0), np.full(3, 1.0)
    pos = rs.uniform(-0.8, 0.8, (n, 3))
    vals = rs.uniform(0.5, 2.0, n)
    hs = rs.uniform(0.1, 0.3, n)
    hs[:4] = 0.0
    for win in (3, 4, 9):
        got = tdd.sph_deposit(pos, vals, np.ones(n), np.ones(n), hs, left, right, dims,
                              chunk=8, max_window=win, **CPU)
        assert np.all(np.isfinite(got)), f"non-finite deposit at window {win}"
        assert got.max() > 0.0


def test_cic_mass_conservation_and_oracle():
    # the JAX test's case: 200 particles over 1 cell from the boundary keep
    # their mass (1e-5 relative); one particle at a cell center deposits
    # only there
    rs = np.random.RandomState(1)
    n, dims = 200, (8, 8, 8)
    left, right = np.zeros(3), np.full(3, 2.0)
    cell = (right - left) / np.array(dims)
    pos = rs.uniform(0.3, 1.7, (n, 3))
    q = rs.uniform(0.1, 1.0, n)
    grid = tdd.cic_deposit(pos, q, left, right, dims, chunk=64, **CPU)
    vol = float(np.prod(cell))
    np.testing.assert_allclose(grid.sum() * vol, q.sum(), rtol=1e-5)
    c0 = left + (np.array([2, 3, 4]) + 0.5) * cell
    g1 = tdd.cic_deposit(c0[None, :], np.array([3.0]), left, right, dims, **CPU)
    assert g1[2, 3, 4] == pytest.approx(3.0 / vol, rel=1e-6)
    assert np.count_nonzero(g1) == 1


def test_metal_weighted_density_formula():
    snap = {"density": np.array([2.0, 4.0]),
            "hydrogenneutralfraction": np.array([0.5, 0.25]),
            "massfraction": np.array([[0.1, 0.2], [0.05, 0.25]]),
            "metallicitytotal": np.array([0.0, 1.0])}
    want = np.array([2.0 * 0.7 * 0.5 * 1.0, 4.0 * 0.7 * 0.25 * 10.0])
    np.testing.assert_allclose(tdd.metal_weighted_dust_density(snap), want)
    np.testing.assert_array_equal(tdd.metal_weighted_dust_density(snap),
                                  jdd.metal_weighted_dust_density(snap))


def test_gen_dust_density_from_synthetic_snapshot(tmp_path):
    # the JAX test's 100-particle snapshot onto 6^3 cells by both methods:
    # finite, positive somewhere, and within 1e-5 relative of JAX's grid
    path = tmp_path / "latte.npz"
    rs = _snapshot(path, 2, 100)
    xgrid = rs.uniform(-1, 1, (50, 3))
    for method in ("sph", "cic"):
        grid = tdd.gen_dust_density(xgrid, 6, 6, 6, snapshot_path=str(path), method=method,
                                    **CPU)
        assert grid.shape == (6, 6, 6)
        assert np.all(np.isfinite(grid)) and grid.max() > 0
        want = jdd.gen_dust_density(xgrid, 6, 6, 6, snapshot_path=str(path), method=method)
        np.testing.assert_allclose(grid, want, rtol=1e-5, atol=1e-5 * float(want.max()))


def test_cubic_spline_normalization():
    # int W d^3r = 1 (radial quadrature), and the kernel's branch values
    r = np.linspace(0, 2, 20001)
    w = tdd.cubic_spline_kernel(torch.as_tensor(r)).numpy() / np.pi
    np.testing.assert_allclose(np.trapezoid(4 * np.pi * r ** 2 * w, r), 1.0, rtol=1e-6)
    np.testing.assert_allclose(
        tdd.cubic_spline_kernel(torch.tensor([0.5, 1.5, 2.5], dtype=torch.float64)).numpy(),
        [1 - 1.5 * 0.25 + 0.75 * 0.125, 0.25 * 0.5 ** 3, 0.0])


# ---------------------------------------------------------------------------
# against the JAX package's deposition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_deposits_match_jax(dtype):
    # 3 000 particles with log-normal smoothing lengths of 0.3-3 cells onto
    # 16 x 16 x 8 cells, in chunks that leave a padded tail chunk: SPH at
    # the default window (9; h clipped to 1.5 cells) and CIC, each within
    # 1e-5 relative of the JAX package's (float32) grid, at its largest
    # cell and cell by cell relative to it; the sums within 1e-5
    rng = np.random.default_rng(21)
    n, dims = 3000, (16, 16, 8)
    left, right = np.array([-1.0, -1.0, -0.5]), np.array([1.0, 1.0, 0.5])
    cell = (right - left) / np.array(dims)
    pos = rng.uniform(left, right, (n, 3))
    vals, m, rho = rng.uniform(0.5, 2, n), rng.uniform(0.5, 1.5, n), rng.uniform(0.5, 1.5, n)
    hs = np.clip(np.exp(rng.normal(0.0, 0.6, n)), 0.3, 3.0) * cell.min()
    got = tdd.sph_deposit(pos, vals, m, rho, hs, left, right, dims, chunk=1024, dtype=dtype,
                          **CPU)
    want = jdd.sph_deposit(pos, vals, m, rho, hs, left, right, dims, chunk=1024)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(want.max()))
    assert abs(got.sum() / want.sum() - 1) <= 1e-5
    got = tdd.cic_deposit(pos, m, left, right, dims, chunk=1024, dtype=dtype, **CPU)
    want = jdd.cic_deposit(pos, m, left, right, dims, chunk=1024)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(want.max()))
    assert abs(got.sum() / want.sum() - 1) <= 1e-5


# ---------------------------------------------------------------------------
# run_domain --snapshot
# ---------------------------------------------------------------------------

def _obs_table(path, seed=3, m=240):
    # the JAX test's reference-format observation table (no density column:
    # the slice's truth comes from the snapshot)
    rs = np.random.RandomState(seed)
    xyz = rs.uniform(-1, 1, (m, 3))
    xyz = xyz[np.linalg.norm(xyz, axis=1) > 0.2]
    e = np.abs(rs.randn(len(xyz))) + 0.1
    with open(path, "w") as f:
        f.write("x y z e e_err\n")
        for row in zip(xyz[:, 0], xyz[:, 1], xyz[:, 2], e, np.full(len(xyz), 0.05)):
            f.write(" ".join(repr(float(v)) for v in row) + "\n")


@pytest.mark.parametrize("method", ["sph", "cic"])
def test_run_domain_snapshot_truth_matches_jax(tmp_path, method):
    # the JAX test's run (a 300-particle snapshot, a 240-star table, 40 test
    # stars, 6 x 6 x 4 grid, ell 0.4, eval grid 6, the closed-form dense
    # fit, float64) through the port's run_domain on the CPU and the JAX
    # package's: the slice's truth within 1e-5 relative of JAX's (JAX
    # deposits in float32), the latent RMSE within 1e-5 of the one JAX's
    # predictions give; a missing snapshot raises
    snap, table = tmp_path / "latte.npz", tmp_path / "obs.dat"
    _snapshot(snap, 3, 300)
    _obs_table(table)
    argv = ["--data-path", str(table), "--snapshot", str(snap), "--deposit-method", method,
            "--ntest", "40", "--nx", "6", "--nz", "4", "--ell", "0.4", "--maxiter-cg", "10",
            "--eval-grid", "6", "--batch-size", "100", "--f64"]
    jrun_domain.main(argv + ["--output-dir", str(tmp_path / "jax")])
    preds = np.load(tmp_path / "jax" / "domain-mean-field" / "predictions.npz")
    out = run_domain.main(argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    prob = run_domain.domain_problem(0, 40, 0.1, 6, 4, eval_grid=6, data_path=str(table))
    fgrid = run_domain.snapshot_truth(np.concatenate([prob["xobs"], prob["xtest"]]),
                                      prob["xgrid"], prob["zmid"], 6, 4, str(snap), method,
                                      device="cpu")
    np.testing.assert_allclose(fgrid, preds["fgrid"], rtol=0,
                               atol=1e-5 * float(np.abs(preds["fgrid"]).max()))
    want = float(np.sqrt(np.mean((preds["fgrid"] - preds["fmu_grid"]) ** 2)))
    assert out["deposit_s"] > 0
    assert abs(out["latent_rmse"] - want) <= 1e-5 * want
    with pytest.raises(FileNotFoundError):
        run_domain.main(["--data-path", str(table), "--snapshot", str(tmp_path / "none.npz"),
                         "--device", "cpu", "--output-dir", str(tmp_path / "x")])
