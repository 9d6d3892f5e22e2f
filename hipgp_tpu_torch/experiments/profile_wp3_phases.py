"""Where the time of kernel B-6 (csrc/mxu3d.cu) goes, phase by phase.

Builds the kernel with its phase clocks (``-DWP3_PHASE_CLOCKS``: thread 0 of
each CTA adds ``clock64()`` differences between the phases' barriers to a
device counter per phase), runs it through the `mxu3d` wrapper at the dust
map's self-dot shape, (512, 32, 64, 64) through (64, 128, 128), with the
solver's spectrum (SqExp, sig2 0.5, ell 0.07, jitter 1e-3 on the 64 x 64 x
32 grid), and prints one JSON line: the milliseconds a call by CUDA events
with the clocks on, and each phase's SM clock cycles per sample and CTA (a
CTA sees each of its cluster's samples once), in the kernel's order: the row
pass, the cluster barrier, the first gather, per packed column the L1 step
2, the W steps, the weighting, the inverse W steps, the inverse L1 step A
and the scatter with the next gather, the cluster barrier, the row pass back
with the dot, the last cluster barrier.  The marks cost a clock read and an
atomic add per phase and CTA; the kernel's own build has none.

Usage (on the card): python -m hipgp_tpu_torch.experiments.profile_wp3_phases
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
from ..ops import bttb, mxu3d, solve

__all__ = ["main", "PHASES"]

PHASES = ("row pass", "cluster barrier 1", "first gather", "L1 step 2", "W step 1",
          "W step 2", "weighting", "inverse W step A", "inverse W step B",
          "inverse L1 step A", "scatter + next gather", "cluster barrier 2",
          "row pass back + dot", "cluster barrier 3")


def _phase_lib():
    """The kernel built with -DWP3_PHASE_CLOCKS into the package's build
    directory (cached by the source's content), bound as the wrapper's
    library."""
    src = _build.CSRC_DIR / "mxu3d.cu"
    flags = [*_build.NVCC_FLAGS, "-DWP3_PHASE_CLOCKS"]
    text = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(
        _build.CSRC_DIR.glob("*.cuh"))) + " ".join(flags).encode()
    out = _build.BUILD_DIR / f"libmxu3d_phases-{hashlib.sha1(text).hexdigest()[:12]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".tmp")
        subprocess.run([_build._nvcc(), *flags, "-o", str(tmp), str(src)], check=True)
        os.replace(tmp, out)
    lib = mxu3d._bind(ctypes.CDLL(str(out)))
    lib.mxu3d_wp3_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mxu3d_wp3_phase_clocks.restype = ctypes.c_int
    return lib


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_wp3_phases needs a CUDA device")
    dev = torch.device("cuda")
    kern = lambda a, b: 0.5 * torch.exp(
        -0.5 * torch.sum(((a[:, None, :] - b[None, :, :]) / 0.07) ** 2, -1))
    grids = [torch.linspace(-1.0, 1.0, m, device=dev) for m in (64, 64, 32)]
    spec = bttb.make_spectrum(grids, kern, jitter=1e-3)
    _, _, dims, edims, w = solve._mxu3d_permuted(
        spec, bttb._full_weights(spec.eigs, spec.edims[-1]))
    x = torch.randn((args.batch,) + dims, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    lib = _phase_lib()
    saved = mxu3d._LIB
    mxu3d._LIB = lib
    try:
        call = lambda: mxu3d.sandwich_apply_wp3(x, w, dims, edims, selfdot=True)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        clocks = (ctypes.c_ulonglong * 16)()
        lib.mxu3d_wp3_phase_clocks(clocks, 1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            call()
        end.record()
        end.synchronize()
        err = lib.mxu3d_wp3_phase_clocks(clocks, 1)
        if err:
            raise RuntimeError(f"reading the phase clocks failed: cudaError_t {err}")
    finally:
        mxu3d._LIB = saved
    per = args.reps * args.batch * mxu3d.WP3_CLUSTER
    cycles = {name: clocks[i] / per for i, name in enumerate(PHASES)}
    row = {"shape": [args.batch, *dims], "embedded": list(edims),
           "ms_with_clocks": start.elapsed_time(end) / args.reps,
           "clusters": mxu3d._wp3_clusters(dims, edims, dev),
           "cycles_per_sample_and_cta": cycles, "total": sum(cycles.values()),
           "device": torch.cuda.get_device_name(0)}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
