"""Chained-input steady-state timing.

Counterpart of `hipgp_tpu/utils/timing.py`.  Every rep's input is made
data-dependent on the previous rep's output by a zero-valued nudge
(0 * sum(out)), which keeps the numbers identical while serialising the
reps, so the time is per-call latency, not overlapped throughput.  The reps
are bracketed by device synchronisations, so on a CUDA device the host clock
covers the device's work.
"""
from __future__ import annotations

import time

import torch

__all__ = ["chain_time"]


def _first_tensor(out) -> torch.Tensor:
    return out if isinstance(out, torch.Tensor) else out[0]


def _link(x, out):
    dep = torch.sum(_first_tensor(out)) * 0
    if isinstance(x, torch.Tensor):
        return x + dep.to(x.dtype)
    return type(x)(a + dep.to(a.dtype) for a in x)


def _sync(out) -> None:
    t = _first_tensor(out)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def chain_time(f, x, reps: int = 5, warmup: int = 3):
    """Return (seconds_per_call, last_output) of ``f(x)`` at steady state.

    ``x`` is a tensor or a tuple/list of tensors; ``f``'s output is a tensor
    or a sequence whose first element is one."""
    out = f(x)
    _sync(out)
    for _ in range(warmup):
        x = _link(x, out)
        out = f(x)
        _sync(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        x = _link(x, out)
        out = f(x)
    _sync(out)
    return (time.perf_counter() - t0) / reps, out
