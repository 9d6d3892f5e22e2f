"""Where the time of one 1-D whitening solve goes on the card.

Runs the section 5.2 protocol's solve (make_spectrum + gram_solve, Mat52,
sig2 0.1, ell one grid spacing, batch 8, 20 fixed PCG iterations, float32)
at each size, first timed by the host clock between synchronisations, then
under torch.profiler: the CUDA kernels' summed device time per solve, the
device's idle share of the wall time, and the kernels that take the most
device time.  Prints one JSON line per size.

Usage (on the card): python -m hipgp_tpu_torch.experiments.profile_gram_solve
       --sizes 131072 1048576
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..kernels import kernel_from_name
from .run_pcg_vs_cholesky import MAXITER, protocol_problem, protocol_solve

__all__ = ["main"]


BSZ, TOP = 8, 8   # the protocol's batch; kernels listed


def _solve_fn(M, dev):
    grid, kfun = protocol_problem(kernel_from_name("Mat52"), M, device=dev)
    v = torch.randn((BSZ, M), generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    pcg_path = protocol_solve(grid, kfun, MAXITER)
    return lambda: pcg_path(v)


def _device_us(events) -> float:
    """Summed self device time of the CUDA kernels among ``events``."""
    total = 0.0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total += e.self_device_time_total
    return total


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", type=int, nargs="+", default=[131_072, 1 << 20])
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_gram_solve needs a CUDA device")
    dev = torch.device("cuda")
    from torch.profiler import ProfilerActivity, profile

    results = []
    for M in args.sizes:
        solve = _solve_fn(M, dev)
        for _ in range(3):
            solve()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            solve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.reps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.reps):
                solve()
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3 / args.reps
        events = prof.key_averages()
        dev_ms = _device_us(events) / 1e3 / args.reps
        kernels = sorted((e for e in events
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: -e.self_device_time_total)
        top = [{"name": e.key[:80], "ms_per_solve": e.self_device_time_total / 1e3 / args.reps,
                "calls_per_solve": e.count / args.reps} for e in kernels[:TOP]]
        row = {"M": M, "wall_ms": wall_ms, "wall_ms_profiled": prof_wall_ms,
               "device_ms": dev_ms if dev_ms > 0 else None,
               "idle_share": (1.0 - dev_ms / prof_wall_ms) if dev_ms > 0 else None,
               "top_kernels": top, "device": torch.cuda.get_device_name(0)}
        print(json.dumps(row), flush=True)
        results.append(row)
    return results


if __name__ == "__main__":
    main()
