"""The port's multi-process runtime against the JAX package.

tests/test_multihost.py's cluster, ported: a real world of two gloo ranks
on the CPU (`hipgp_tpu_torch.parallel.launch`, one cluster for the file,
`torch_parallel_ranks.multihost_cases`), N = 241 rows split by
`multihost.process_slice` (one pad row), each rank feeding only its block
(`global_batch`, `global_row_weights`), a cross-rank barrier
(`sync_global`) and the row-weighted ``dp_batch_solve`` held to the JAX
package's single-process ``batch_solve`` at its tolerance (1e-8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

import torch_parallel_ranks as ranks
from hipgp_tpu.kernels import SqExp as JSqExp
from hipgp_tpu.models.hipgp import HIPGP as JHIPGP
from hipgp_tpu_torch.parallel import launch, multihost

N, RANKS = 241, 2


@pytest.fixture(scope="module")
def cluster():
    return launch.run(ranks.multihost_cases, RANKS, args=(N,), device="cpu", timeout_s=300)


def _data():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (N, 2))
    return x, np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]), np.full(N, 0.1)


def test_process_slice_splits_241_rows(cluster):
    assert [r["slice"] for r in cluster] == [(0, 121), (121, 241)]


def test_global_batch_and_row_weights_pad_the_last_block(cluster):
    x, _, _ = _data()
    for r, (lo, hi) in zip(cluster, [(0, 121), (121, 241)]):
        # every block holds ceil(241 / 2) = 121 rows; the global array 242
        assert r["x_shape"] == (2 * 121, 2)
        np.testing.assert_array_equal(r["x_local"][:hi - lo], x[lo:hi])
        pad = 121 - (hi - lo)
        np.testing.assert_array_equal(r["w_local"], [1.0] * (hi - lo) + [0.0] * pad)
        np.testing.assert_array_equal(r["x_local"][hi - lo:], np.zeros((pad, 2)))
        np.testing.assert_array_equal(r["s_local"][hi - lo:], np.ones(pad))
    assert cluster[1]["w_local"][-1] == 0.0


def test_sync_global_returns_the_world_size(cluster):
    assert [r["sync"] for r in cluster] == [float(RANKS)] * RANKS


def test_on_coordinator_on_rank_0_only(cluster):
    assert [r["coordinator"] for r in cluster] == [True] + [False] * (RANKS - 1)
    assert multihost.on_coordinator()   # this process is in no world


def test_dp_batch_solve_row_weights_matches_jax_single_process(cluster):
    x, y, s = _data()
    grids = [jnp.linspace(-1.0, 1.0, 8, dtype=jnp.float64)] * 2
    model = JHIPGP(JSqExp(), grids, num_obs=N, family="mean-field", ell_init=0.3,
                   noise2_init=0.01)
    new, elbo = model.batch_solve(model.init_state(), jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(s), batch_size=-1, maxiter_cg=50,
                                  compute_elbo=True)
    for r in cluster:
        np.testing.assert_allclose(r["theta1"], np.asarray(new.theta1), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(r["theta2"], np.asarray(new.theta2), rtol=1e-8, atol=1e-10)
        # N_real from the weights: the pad row counts in no sum
        np.testing.assert_allclose(r["elbo"], float(elbo), rtol=1e-8)
