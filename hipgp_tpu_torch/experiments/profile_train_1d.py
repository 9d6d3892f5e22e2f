"""Where the time of one training step on the 1-D long axis goes.

Builds the 1-D training problem (`train_1d_problem`: HIPGP mean-field on the
section 5.2 operator, Matern-5/2 with sig2 0.1 and ell one grid spacing on
[0, 1], jitter 1e-3, learning its hyperparameters; noisy observations of a
1-D MLP function) in float32, warm-starts theta2 as `svigp_fit` does, and
times ``--reps`` training steps (`infer.fit.batch_step` with
``learn_kernel`` and ``learn_noise``: natgrad plus the hyper-gradients
through the planes PCG, the R^T's backward and the dK term's radix apply
backward, and Adam) on consecutive batches, first by the host clock between
synchronisations, then under torch.profiler, which splits the device time
into the radix kernels (B-2/B-3 ``stage1_kernel`` with the dots'
reduction, B-4 ``middle_kernel``, ``middle_wgrad_kernel`` with its
reduction), the FFTs (the spectrum build), the cuBLAS products (the
float64 stage-order weights) and everything else (the Knm build, the PCG
vectors, the ELBO and its backward).  Reads the peak device memory of a
step.  Prints one JSON line.

Usage (on the card): python -m hipgp_tpu_torch.experiments.profile_train_1d
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..infer import FitConfig, svigp_fit
from ..infer.fit import batch_step, make_optimizer, prepare_batches
from ..kernels import Matern
from ..models import HIPGP
from .synthetic_data import make_one_dim_function

__all__ = ["main", "train_1d_problem"]

TOP = 12
GROUPS = {"stage1 (B-2, B-3)": ("stage1_kernel", "dot_reduce_kernel"),
          "middle (B-4)": ("middle_kernel",),
          "middle_wgrad": ("middle_wgrad_kernel", "wgrad_reduce_kernel"),
          "FFT": ("fft", "FFT"),
          "cuBLAS products": ("gemm", "Kernel2", "cutlass", "xmma")}


def _group(name: str) -> str:
    for group, keys in GROUPS.items():
        if any(k in name for k in keys):
            return group
    return "other"


def train_1d_problem(M: int = 1 << 20, nobs: int = 5120, noise_std: float = 0.1,
                     dtype=torch.float32, device="cuda"):
    """The 1-D training problem: (model, x (nobs, 1), y (nobs,)).  The model
    is HIPGP mean-field on the section 5.2 operator at size M (Matern-5/2,
    sig2 0.1, ell one grid spacing 1/M on [0, 1], jitter 1e-3, as
    `run_pcg_vs_cholesky.protocol_problem` builds it) with noise2 noise_std^2
    and learn_kernel, learn_noise; the data are make_one_dim_function(seed=0)
    taken on [-1, 1] and rescaled onto [0, 1], plus noise noise_std, drawn
    from numpy seed 42."""
    rng = np.random.default_rng(42)
    f, _ = make_one_dim_function(seed=0)
    x = rng.uniform(0.0, 1.0, (nobs, 1))
    y = f(2.0 * x[:, 0] - 1.0) + noise_std * rng.standard_normal(nobs)
    model = HIPGP(Matern(2.5), [np.linspace(0.0, 1.0, M)], num_obs=nobs, sig2_init=0.1,
                  ell_init=1.0 / M, noise2_init=noise_std ** 2, init_Svar=1.0, jitter=1e-3,
                  learn_kernel=True, learn_noise=True, dtype=dtype, device=device)
    return model, x, y


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-inducing", type=int, default=1 << 20)
    p.add_argument("--nobs", type=int, default=5120)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--maxiter-cg", type=int, default=20)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_1d needs a CUDA device")
    dev = torch.device("cuda")
    from torch.profiler import ProfilerActivity, profile

    model, x, y = train_1d_problem(args.num_inducing, args.nobs, device=dev)
    cfg = FitConfig(epochs=0, batch_size=args.batch_size, maxiter_cg=args.maxiter_cg,
                    learn_kernel=True, learn_noise=True)
    state, _ = svigp_fit(model, model.init_state(), x, y, None, cfg, verbose=False,
                         theta2_warmstart=True, natgrad_safe_lr="off")
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    xb, yb, _, w = prepare_batches(as_t(x), as_t(y).reshape(-1), None, args.batch_size)
    opt = make_optimizer(state, cfg)
    reps = min(args.reps, xb.shape[0])
    box = [state]

    def steps():
        for b in range(reps):
            box[0], _ = batch_step(model, cfg, opt, box[0], xb[b], yb[b], None, w[b])

    steps()   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / reps
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    groups = {g: 0.0 for g in list(GROUPS) + ["other"]}
    for e in kernels:
        groups[_group(e.key)] += e.self_device_time_total / 1e3 / reps
    dev_ms = sum(groups.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP]
    row = {
        "M": model.M, "embedded": list(model.edims), "batch": args.batch_size,
        "maxiter_cg": args.maxiter_cg, "step_ms": step_ms, "step_ms_profiled": prof_ms,
        "peak_memory_gb": peak_gb,
        "device_ms": dev_ms if dev_ms > 0 else None,
        "idle_share": (1.0 - dev_ms / prof_ms) if dev_ms > 0 else None,
        "device_ms_by_group": groups,
        "top_kernels": [{"name": e.key[:80], "ms_per_step": e.self_device_time_total
                         / 1e3 / reps, "calls_per_step": e.count / reps} for e in top],
        "device": torch.cuda.get_device_name(0),
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
