"""Where the time of one 1-D whitening solve goes on the card.

Runs the section 5.2 protocol's solve (make_spectrum + gram_solve, Mat52,
sig2 0.1, ell one grid spacing, batch 8, 20 fixed PCG iterations, float32)
at each size, first timed by the host clock between synchronisations, then
under torch.profiler: the CUDA kernels' summed device time per solve, the
device's idle share of the wall time, the device time of the radix kernels
by group (the middle, B-4 and B-7; stage 1 and its dots, B-2 and B-3) and
the kernels that take the most device time, and the host's own cost of one
call of each radix wrapper at the size's plan and crop (checks,
allocations, the launch; timed over calls that do not wait for the card).
Prints one JSON line per size, with the card's name and power limit
(nvidia-smi).

Usage (on the card): python -m hipgp_tpu_torch.experiments.profile_gram_solve
       --sizes 131072 1048576
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..kernels import kernel_from_name
from ..ops import bttb, radix_fft
from .run_pcg_vs_cholesky import MAXITER, protocol_problem, protocol_solve

__all__ = ["main"]


BSZ, TOP = 8, 8   # the protocol's batch; kernels listed
# kernel-name fragments of each group (csrc/radix.cu's function names)
GROUPS = {"middle": ("middle_kernel", "middle_dual_kernel"),
          "stage1 + dot": ("stage1_kernel", "dot_reduce_kernel")}


def _group(name: str) -> str:
    for group, keys in GROUPS.items():
        if any(k in name for k in keys):
            return group
    return "other"


def _card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def _solve_fn(M, dev):
    grid, kfun = protocol_problem(kernel_from_name("Mat52"), M, device=dev)
    v = torch.randn((BSZ, M), generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    pcg_path = protocol_solve(grid, kfun, MAXITER)
    return lambda: pcg_path(v)


def _host_us(M, dev, calls=100):
    """Microseconds of host time per call of each radix wrapper on the planes
    path's operands at size M (V = BSZ / 2 packed planes, the data rows of
    the crop): ``calls`` calls queued without a synchronisation, fewer than
    the launch queue holds, so the host never waits for the card."""
    p = radix_fft.make_plan(bttb.embedded_dims((M,))[0], torch.float32, dev)
    V, A, N = BSZ // 2, p.A, p.B * p.C
    rows = -(-M // N)
    x = torch.randn((2, V, A, N), device=dev)
    y = x.view(2, V, A, p.B, p.C)
    d = torch.ones((A, p.B, p.C), device=dev)
    u = x[:, :, :rows].contiguous()
    fns = {"stage1": lambda: radix_fft.stage1(u[0], u[1], p, A, inverse=False),
           "stage1_inv_dot": lambda: radix_fft.stage1_inv_dot(x[0], x[1], u[0], u[1], p,
                                                              rows),
           "middle": lambda: radix_fft.middle(y[0], y[1], d, p)}
    out = {}
    for name, fn in fns.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - t0) * 1e6 / calls
        torch.cuda.synchronize()
    return out


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
    card = _card()
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
        groups = {g: 0.0 for g in list(GROUPS) + ["other"]}
        for e in kernels:
            groups[_group(e.key)] += e.self_device_time_total / 1e3 / args.reps
        top = [{"name": e.key[:80], "ms_per_solve": e.self_device_time_total / 1e3 / args.reps,
                "calls_per_solve": e.count / args.reps} for e in kernels[:TOP]]
        row = {"M": M, "wall_ms": wall_ms, "wall_ms_profiled": prof_wall_ms,
               "device_ms": dev_ms if dev_ms > 0 else None,
               "idle_share": (1.0 - dev_ms / prof_wall_ms) if dev_ms > 0 else None,
               "device_ms_by_group": groups, "host_us_per_call": _host_us(M, dev),
               "top_kernels": top,
               "device": torch.cuda.get_device_name(0), "card": card}
        print(json.dumps(row), flush=True)
        results.append(row)
    return results


if __name__ == "__main__":
    main()
