"""Phase timing and tracing (counterpart of `hipgp_tpu/utils/profiling.py`).

`PhaseTimer` accumulates the wall clock of named phases, with the card
synchronised on entry and exit when CUDA is in use, so a phase's seconds
cover its device work; `trace` captures a `torch.profiler` trace (CPU and,
where CUDA is in use, CUDA activities) of the enclosed block and writes it
as a Chrome trace.  `PhaseTimer.report()` returns a list of rows (dicts),
where the JAX package returns a DataFrame: the card's machine has no pandas.
"""
from __future__ import annotations

import contextlib
import csv
import os
import time
from collections import defaultdict
from typing import Dict, List

import torch

__all__ = ["PhaseTimer", "trace"]

COLUMNS = ("phase", "total_s", "calls", "mean_s")


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    """Accumulate the wall clock per named phase, device-synchronised.

    >>> t = PhaseTimer()
    >>> with t("fit"):
    ...     state = step(state)
    >>> t.report()   # [{"phase": "fit", "total_s": ..., "calls": 1, "mean_s": ...}]
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str):
        _sync()   # drain pending work
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    def report(self) -> List[dict]:
        """One row per phase, in order of first use: phase, total_s, calls,
        mean_s."""
        return [{"phase": k, "total_s": v, "calls": self.counts[k],
                 "mean_s": v / max(self.counts[k], 1)} for k, v in self.totals.items()]

    def to_csv(self, path: str) -> None:
        """The report as CSV, the JAX package's columns."""
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=COLUMNS)
            w.writeheader()
            w.writerows(self.report())


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed block into
    ``logdir/trace.json`` (Chrome trace format; CUDA activities too when
    CUDA is in use).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
