"""Run by hand (not a pytest module): the JAX package's saved section-14a
dust-map states through both packages' integrated prediction, in float64 on
the CPU.

RESULTS.md section 14a records, for the 'matfree' full-batch fit of the
64 x 64 x 32 grid at ell 0.2 and 0.07, the state (`state.npz`) and the
predictions made on the chip that fitted it (`predictions.npz`, under
`results/domain-paper[-ell007]/domain-mean-field/`).  This script rebuilds
the protocol's data (`run_domain.domain_problem`, 100 000 + 2 000 stars,
seed 0), loads that state into the port (float64 and float32) and into the
JAX package (float64), predicts the line integrals e at the first ``--n``
test stars (analytic semi-integrated covariances, the whitening at 50
iterations, as the driver does) and prints each prediction's relative
difference from the recorded ``emu_test`` and from each other, and its RMSE
against the true e.

Usage: JAX_PLATFORMS=cpu python tests/domain_state_crosscheck.py --ell 0.2 --n 16
       (about 4 minutes and 3 GB on 8 CPU cores)
"""
import argparse
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hipgp_tpu import kernels as jkernels  # noqa: E402
from hipgp_tpu.models import HIPGP as JHIPGP  # noqa: E402
from hipgp_tpu_torch.experiments import run_domain  # noqa: E402
from hipgp_tpu_torch.utils import checkpoint  # noqa: E402

RUNS = {0.2: "results/domain-paper/domain-mean-field",
        0.07: "results/domain-paper-ell007/domain-mean-field"}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ell", type=float, default=0.2, choices=sorted(RUNS))
    p.add_argument("--n", type=int, default=16)
    args = p.parse_args(argv)
    jax.config.update("jax_enable_x64", True)
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        RUNS[args.ell])
    ref = np.load(os.path.join(root, "predictions.npz"))
    prob = run_domain.domain_problem(100_000, 2000, 0.1, 64, 32, eval_grid=30)
    assert np.allclose(ref["etest"], prob["etest"], rtol=0, atol=1e-12), "not the recorded data"
    sig2 = run_domain.empirical_sig2_init(prob["xobs"], prob["aobs"])
    x, e, recorded = prob["xtest"][:args.n], prob["etest"][:args.n], ref["emu_test"][:args.n]
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    rmse = lambda a: float(np.sqrt(np.mean((a - e) ** 2)))
    out = {"recorded": recorded}
    for dt in (torch.float64, torch.float32):
        m = run_domain.domain_model("SqExp", prob["grids"], len(prob["xobs"]), sig2, args.ell,
                                    dtype=dt, device="cpu")
        st = checkpoint.load_pytree(os.path.join(root, "state.npz"), m.init_state())
        t0 = time.perf_counter()
        mu, _ = m.predict(st, torch.as_tensor(x, dtype=dt), maxiter_cg=50,
                          integrated_obs=True, semi_integrated_samps=200)
        out[f"port {dt}"] = mu.double().numpy()
        print(f"port {dt}: {time.perf_counter() - t0:.1f} s", flush=True)
        del m
    jm = JHIPGP(jkernels.SqExp(), [jnp.asarray(g) for g in prob["grids"]],
                num_obs=len(prob["xobs"]), sig2_init=sig2, ell_init=args.ell,
                noise2_init=1.0, init_Svar=1.0, jitter=1e-3, support_integrated_obs=True,
                dtype=jnp.float64)
    saved = np.load(os.path.join(root, "state.npz"))
    fields = ("theta1", "theta2", "log_sig2", "log_ell", "log_noise2")
    js = jm.init_state().replace(**{k: jnp.asarray(saved[f], jnp.float64)
                                    for k, f in zip(fields, saved.files)})
    jmu, _ = jm.predict(js, jnp.asarray(x), maxiter_cg=50, integrated_obs=True,
                        semi_integrated_estimator="analytic")
    out["jax float64"] = np.asarray(jmu, np.float64)
    for k, v in out.items():
        print(f"{k}: e RMSE over {args.n} stars {rmse(v):.5f}; rel diff from the recorded "
              f"emu_test {rel(v, recorded):.3e}, from jax float64 "
              f"{rel(v, out['jax float64']):.3e}", flush=True)
    return out


if __name__ == "__main__":
    main()
