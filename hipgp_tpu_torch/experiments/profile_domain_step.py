"""Where the time of one 3-D natural-gradient step of the dust map goes.

Builds the section 5.5 problem as `run_domain` does (synthetic field, the
nx x nx x nz grid, SqExp at ``--ell``, sig2 by the empirical init, float32)
and times the natgrad step (`infer.fit.batch_step`: the integrated Knm, the
whitening with ``--maxiter-cg`` PCG iterations, the ELBO and the natural
gradient; with ``--learn`` the training step with ``learn_kernel`` and
``learn_noise``, whose hyper-gradients solve again and run B-5's backward)
on the first batch from the initial state (its work does not depend on the
state, but for the PCG's early exit): first by the host clock between
synchronisations, then under torch.profiler, which splits the device time
into kernel B-5 (its resident kernel and the plane dots' reduction),
kernel B-6 (with its weights' layout launch), the cuBLAS products (the
two outer-axis contractions per apply and the model's kn products), and
everything else (the Knm build, the PCG vectors, the ELBO and the
gradient).  The Knm build alone is also timed by the host clock, and the
peak device memory of one step is read (`torch.cuda.max_memory_allocated`
after a reset).  Prints one JSON line.

Usage (on the card): python -m hipgp_tpu_torch.experiments.profile_domain_step
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..infer import FitConfig
from ..infer.fit import batch_step, make_optimizer, prepare_batches
from ..ops import mxu3d
from .run_domain import domain_model, domain_problem, empirical_sig2_init

__all__ = ["main"]

TOP = 10
# kernel-name fragments of each group (the CUDA sources' function names)
GROUPS = {"B-5": ("wp_resident_kernel", "planedots_reduce_kernel"),
          "B-6": ("wp3_kernel", "weights_kernel"),
          "cuBLAS products": ("gemm", "Kernel2", "cutlass", "xmma")}


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
    p.add_argument("--nx", type=int, default=64)
    p.add_argument("--nz", type=int, default=32)
    p.add_argument("--ell", type=float, default=0.07)
    p.add_argument("--nobs", type=int, default=10_240)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--maxiter-cg", type=int, default=20)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--learn", action="store_true",
                   help="the training step: learn_kernel and learn_noise")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_domain_step needs a CUDA device")
    dev = torch.device("cuda")
    from torch.profiler import ProfilerActivity, profile

    prob = domain_problem(args.nobs, 0, 0.1, args.nx, args.nz)
    sig2 = empirical_sig2_init(prob["xobs"], prob["aobs"])
    model = domain_model("SqExp", prob["grids"], len(prob["xobs"]), sig2, args.ell,
                         device=dev)
    cfg = FitConfig(batch_size=args.batch_size, maxiter_cg=args.maxiter_cg,
                    integrated_obs=True, lr=1e-4, learn_kernel=args.learn,
                    learn_noise=args.learn)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    # a learned noise replaces the per-point one, as in svigp_fit
    xb, yb, sb, w = prepare_batches(as_t(prob["xobs"]), as_t(prob["aobs"]),
                                    None if args.learn else as_t(prob["sobs"]),
                                    cfg.batch_size)
    state = model.init_state()
    opt = make_optimizer(state, cfg)
    step = lambda: batch_step(model, cfg, opt, state, xb[0], yb[0],
                              None if sb is None else sb[0], w[0])
    knm = lambda: model.make_grams(state, xb[0], integrated_obs=True)

    step_ms = _sync_ms(step, args.reps)
    knm_ms = _sync_ms(knm, args.reps)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    step()
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    step_mib = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / args.reps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    groups = {g: 0.0 for g in list(GROUPS) + ["other"]}
    for e in kernels:
        groups[_group(e.key)] += e.self_device_time_total / 1e3 / args.reps
    dev_ms = sum(groups.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP]
    row = {
        "grid": list(model.dims), "embedded": list(model.edims),
        "batch": args.batch_size, "maxiter_cg": args.maxiter_cg, "learn": args.learn,
        "use_wp3": mxu3d.USE_WP3, "step_ms": step_ms, "step_ms_profiled": prof_ms,
        "knm_build_ms": knm_ms, "peak_memory_mib": peak_mib,
        "step_peak_above_state_mib": step_mib,
        "device_ms": dev_ms if dev_ms > 0 else None,
        "idle_share": (1.0 - dev_ms / prof_ms) if dev_ms > 0 else None,
        "device_ms_by_group": groups,
        "top_kernels": [{"name": e.key[:80], "ms_per_step": e.self_device_time_total
                         / 1e3 / args.reps, "calls_per_step": e.count / args.reps}
                        for e in top],
        "device": torch.cuda.get_device_name(0),
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
