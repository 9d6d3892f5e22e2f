"""Where the time of ``radix_middle_wgrad`` (csrc/radix.cu) goes, phase by phase.

Builds the kernel with its phase clocks (``-DWGRAD_PHASE_CLOCKS``: thread 0
of each CTA sums ``clock64()`` differences between the phases' barriers by
phase and adds them to a device counter per phase when it is done), runs it
through the `radix_fft` wrapper at the 1-D training step's shape, 128 planes
of the headline plan (A, B, C) = (128, 128, 128), on random stage-1 outputs,
and prints one JSON line: the milliseconds a call by CUDA events with the
clocks on, and each phase's SM clock cycles per plane and CTA, in the
kernel's order: the wait for the staged real half, phase 1 (reading it and
the imaginary half), phase 2, phase 3, phase 4's forward half, the first
cluster barrier, the product over distributed shared memory, the second
cluster barrier.  The marks cost a clock read per phase; the kernel's own
build has none.

Usage (on the card): python -m hipgp_tpu_torch.experiments.profile_wgrad_phases
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess

import torch

from .. import _build
from ..ops import radix_fft

__all__ = ["main", "PHASES"]

PHASES = ("wait for the staged half", "phase 1", "phase 2", "phase 3",
          "phase 4 forward half", "cluster barrier 1", "product", "cluster barrier 2")


def _phase_lib():
    """The kernels built with -DWGRAD_PHASE_CLOCKS into the package's build
    directory (cached by the source's content), bound as the wrapper's
    library."""
    src = _build.CSRC_DIR / "radix.cu"
    flags = [*_build.NVCC_FLAGS, "-DWGRAD_PHASE_CLOCKS"]
    text = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(
        _build.CSRC_DIR.glob("*.cuh"))) + " ".join(flags).encode()
    out = _build.BUILD_DIR / f"libradix_phases-{hashlib.sha1(text).hexdigest()[:12]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".tmp")
        subprocess.run([_build._nvcc(), *flags, "-o", str(tmp), str(src)], check=True)
        os.replace(tmp, out)
    lib = radix_fft._bind(ctypes.CDLL(str(out)))
    lib.radix_wgrad_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.radix_wgrad_phase_clocks.restype = ctypes.c_int
    return lib


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--planes", type=int, default=128)
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_wgrad_phases needs a CUDA device")
    dev = torch.device("cuda")
    plan = radix_fft.make_plan(1 << 21, torch.float32, dev)
    V, A, B, C = args.planes, plan.A, plan.B, plan.C
    x = torch.randn((4, V, A, B, C), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    lib = _phase_lib()
    saved = radix_fft._LIB
    radix_fft._LIB = lib
    try:
        call = lambda: radix_fft.middle_wgrad(*x, plan)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        clocks = (ctypes.c_ulonglong * 8)()
        lib.radix_wgrad_phase_clocks(clocks, 1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            call()
        end.record()
        end.synchronize()
        err = lib.radix_wgrad_phase_clocks(clocks, 1)
        if err:
            raise RuntimeError(f"reading the phase clocks failed: cudaError_t {err}")
    finally:
        radix_fft._LIB = saved
    # each of the 2 A V planes (x's and g's) is transformed by one CTA
    per = args.reps * 2 * V * A
    cycles = {name: clocks[i] / per for i, name in enumerate(PHASES)}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    row = {"planes": V, "plan": [A, B, C], "ms_with_clocks": start.elapsed_time(end) / args.reps,
           "splits": radix_fft.wgrad_splits(V, A, sms),
           "cycles_per_plane_and_cta": cycles, "total": sum(cycles.values()),
           "device": torch.cuda.get_device_name(0)}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
