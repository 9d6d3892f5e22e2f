"""Where the time of one training step of the 2-D protocol goes.

Builds the paper's 2-D synthetic protocol as `chip_smoke.py` [main] does
(N = 20 000, M = 125^2 embedded at (250, 250), SqExp at ell 0.05, float32,
batch 256, ``--maxiter-cg`` PCG iterations) and times, on the first batch
from the initial state, the forward-only natural-gradient step and the
training step with ``learn_kernel`` and ``learn_noise``
(`infer.fit.batch_step`: natgrad plus the hyper-gradients through the
whitening and Adam) by the host clock between synchronisations; then
``--chain`` training steps as an epoch of `svigp_fit` runs them (from the
theta2 warm start, each on the next batch from the last step's state), one
by one, with the device memory held after each; then ``--reps`` more of them
under torch.profiler, which splits their device time into kernel A (its
launches), the cuBLAS products, the FFTs and everything else, and lists the
host operations that take the most time.  Prints one JSON line.

Usage (on the card): python -m hipgp_tpu_torch.experiments.profile_train_step
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..infer import FitConfig, svigp_fit
from ..infer.fit import batch_step, make_optimizer, prepare_batches
from .run_synthetic import build_model, marginal_sig2
from .synthetic_data import make_two_dim_data

__all__ = ["main"]

TOP = 12
# kernel-name fragments of each group (the CUDA sources' function names:
# csrc/sandwich_fft.cu's passes; B-8 launches kernel A's code, so it shows as
# kernel A)
GROUPS = {"kernel A": ("rows_forward_kernel", "columns_kernel", "rows_inverse_kernel",
                       "dots_reduce_kernel"),
          "cuBLAS products": ("gemm", "Kernel2", "cutlass", "xmma"),
          "FFT": ("fft", "FFT")}


def _group(name: str) -> str:
    for group, keys in GROUPS.items():
        if any(k in name for k in keys):
            return group
    return "other"


def _sync_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-inducing", type=int, default=125)
    p.add_argument("--nobs", type=int, default=20_000)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--maxiter-cg", type=int, default=10)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--chain", type=int, default=40,
                   help="chained training steps timed one by one")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step needs a CUDA device")
    dev = torch.device("cuda")
    from torch.profiler import ProfilerActivity, profile

    d = make_two_dim_data(Nobs=args.nobs, Ntest=10, noise_std=0.01,
                          function_complexity="medium", gridnum=64, seed=42)
    model = build_model("SqExp", args.num_inducing, len(d["xobs"]),
                        marginal_sig2(d["yobs"], d["sobs"]), 0.05, 0.01, device=dev)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    xb, yb, _, w = prepare_batches(as_t(d["xobs"]), as_t(d["yobs"]), None,
                                   args.batch_size)
    state = model.init_state()
    steps = {}
    for name, learn in (("forward_only", False), ("train", True)):
        cfg = FitConfig(batch_size=args.batch_size, maxiter_cg=args.maxiter_cg,
                        learn_kernel=learn, learn_noise=learn)
        opt = make_optimizer(state, cfg)
        steps[name] = (lambda cfg=cfg, opt=opt:
                       batch_step(model, cfg, opt, state, xb[0], yb[0], None, w[0]))
    host_ms = {name: _sync_ms(fn, args.reps) for name, fn in steps.items()}
    # the training epoch as svigp_fit runs it: from the warm-started state,
    # each step on the next batch from the state the last one left; each
    # step's host time ending in a sync, and the memory held after it
    cfg = FitConfig(epochs=0, batch_size=args.batch_size, maxiter_cg=args.maxiter_cg,
                    learn_kernel=True, learn_noise=True)
    warm, _ = svigp_fit(model, state, d["xobs"], d["yobs"], None, cfg, verbose=False,
                        theta2_warmstart=True, natgrad_safe_lr="off")
    opt = make_optimizer(warm, cfg)
    chained, mem = [], []
    st = warm
    for b in range(min(args.chain, xb.shape[0])):
        t0 = time.perf_counter()
        st, _ = batch_step(model, cfg, opt, st, xb[b], yb[b], None, w[b])
        torch.cuda.synchronize()
        chained.append((time.perf_counter() - t0) * 1e3)
        mem.append(torch.cuda.memory_allocated() / 2 ** 20)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in range(args.reps):
            st, _ = batch_step(model, cfg, opt, st, xb[b], yb[b], None, w[b])
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / args.reps
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    groups = {g: 0.0 for g in list(GROUPS) + ["other"]}
    for e in kernels:
        groups[_group(e.key)] += e.self_device_time_total / 1e3 / args.reps
    dev_ms = sum(groups.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP]
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    top_host = sorted(host, key=lambda e: -e.self_cpu_time_total)[:TOP]
    row = {
        "grid": list(model.dims), "embedded": list(model.edims),
        "batch": args.batch_size, "maxiter_cg": args.maxiter_cg,
        "forward_only_step_ms": host_ms["forward_only"],
        "train_step_ms": host_ms["train"],
        "chained_train_step_ms": chained, "chained_allocated_mib": mem,
        "train_step_ms_profiled": prof_ms,
        "device_ms": dev_ms if dev_ms > 0 else None,
        "idle_share": (1.0 - dev_ms / prof_ms) if dev_ms > 0 else None,
        "device_ms_by_group": groups,
        "top_kernels": [{"name": e.key[:80], "ms_per_step": e.self_device_time_total
                         / 1e3 / args.reps, "calls_per_step": e.count / args.reps}
                        for e in top],
        "top_host_ops": [{"name": e.key[:80], "self_cpu_ms_per_step":
                          e.self_cpu_time_total / 1e3 / args.reps,
                          "calls_per_step": e.count / args.reps} for e in top_host],
        "device": torch.cuda.get_device_name(0),
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
