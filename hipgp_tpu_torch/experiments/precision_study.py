"""Transform precision policy study (SURVEY section 7.5), on the port.

Counterpart of `hipgp_tpu/experiments/precision_study.py` with the card's
policies.  For each policy it measures the relative error of one circulant
apply K x against a float64 numpy oracle applying the same clamped
spectrum, the apply's ms, and the ms of a 20-iteration whitening solve at
the same shape (a per-apply gain that vanishes in the solve is noise).

  2-D, the M = 125^2 protocol's grid (SqExp, ell 0.05), batch 256:
    kernel-A      the shipped path: kernel A's apply, the fused kernel-A PCG
    einsum-fp32   the real-basis einsum chain, TF32 off (the generic PCG)
    einsum-tf32   the same with TF32 on
    einsum-bf16   the same with bfloat16 operands, float32 accumulation
    torch.fft     the rfft2 chain (the generic PCG over it)
    B-8           kernel B-8 (``bttb.USE_PALLAS_TRANSFORM`` on)
  1-D, L = 2^21 (M = 2^20, SqExp at one grid spacing), batch 8:
    radix         the shipped path: kernels B-2 to B-4
    torch.fft     ``bttb.USE_RADIX_FFT`` off

Every switch a policy flips (`bttb.USE_MXU2D_PCG`, `USE_PALLAS_TRANSFORM`,
`USE_RADIX_FFT`, `MATMUL_DFT_POLICY`, `MATMUL_DFT_MAX_LEN`) is restored in a
``finally``.  Each row records the launches of the kernels the policy ran.
Writes ``summary_2d.json`` and ``summary_1d.json`` into ``--output-dir``.

Usage: python -m hipgp_tpu_torch.experiments.precision_study
       (add --device cpu --m1-2d 16 --m-1d 4096 --bsz-2d 4 --bsz-1d 2 for a
       small CPU run)
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os

import numpy as np
import torch

from ..kernels import SqExp
from ..ops import bttb, mxu2d, pallas_transform, radix_fft
from ..ops.bttb import _full_weights, make_spectrum
from ..ops.solve import whiten
from ..utils.timing import chain_time

__all__ = ["main", "run_2d", "run_1d", "SWITCHES"]

# the module switches a policy may flip, read back after the study
SWITCHES = ("USE_MXU2D_PCG", "USE_PALLAS_TRANSFORM", "USE_RADIX_FFT",
            "MATMUL_DFT_POLICY", "MATMUL_DFT_MAX_LEN")


def switch_values() -> dict:
    return {k: getattr(bttb, k) for k in SWITCHES}


@contextlib.contextmanager
def _switches(**values):
    saved = switch_values()
    try:
        for k, v in values.items():
            setattr(bttb, k, v)
        yield
    finally:
        for k, v in saved.items():
            setattr(bttb, k, v)


def _launches() -> dict:
    return {**{f"mxu2d.{k}": v for k, v in mxu2d.LAUNCHES.items()},
            **{f"pallas_transform.{k}": v for k, v in pallas_transform.LAUNCHES.items()},
            **{f"radix_fft.{k}": v for k, v in radix_fft.LAUNCHES.items()}}


def _oracle_apply(x: np.ndarray, full_eigs: np.ndarray, dims, edims):
    """The float64 numpy circulant apply of the clamped spectrum: pad, FFT,
    scale, inverse FFT, crop."""
    B = x.shape[0]
    xpad = np.zeros((B,) + tuple(edims))
    sl = (slice(None),) + tuple(slice(0, d) for d in dims)
    xpad[sl] = x.reshape((B,) + tuple(dims))
    axes = tuple(range(1, 1 + len(edims)))
    y = np.fft.ifftn(full_eigs * np.fft.fftn(xpad, axes=axes), axes=axes).real
    return y[sl].reshape(B, -1)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _measure(regime, name, spec, x, want, apply_fn, reps, switches):
    """One policy's row: error of apply_fn(x) against the oracle, apply ms,
    20-iteration whitening ms, and the kernel launches of the whole."""
    with _switches(**switches):
        before = _launches()
        got = apply_fn(x).double().cpu().numpy()
        t_apply, _ = chain_time(apply_fn, x, reps=reps)
        t_solve, _ = chain_time(lambda v: whiten(spec, v, maxiter=20), x, reps=reps)
        route = bttb.apply_route(spec, x.dtype, x.device)
        moved = {k: v - before[k] for k, v in _launches().items() if v != before[k]}
    row = {"regime": regime, "policy": name, "rel_err_vs_f64": _rel(got, want),
           "apply_ms": 1e3 * t_apply, "whiten20_ms": 1e3 * t_solve,
           "generic_route": route, "launches": moved}
    print(row, flush=True)
    return row


def run_2d(bsz: int, reps: int, device="cuda", m1: int = 125):
    grids = [torch.linspace(0.0, 1.0, m1, dtype=torch.float32, device=device)] * 2
    kern = SqExp()
    spec = make_spectrum(grids, lambda a, b: kern(a, b, (1.0, 0.05)), jitter=1e-3)
    dims, edims = spec.dims, spec.edims
    x64 = np.random.default_rng(0).standard_normal((bsz, m1 * m1))
    x = torch.as_tensor(x64, dtype=torch.float32, device=device)
    wK = _full_weights(spec.eigs, edims[-1]).contiguous()
    want = _oracle_apply(x64, wK.double().cpu().numpy(), dims, edims)

    def kernel_a(v):
        y = mxu2d.sandwich_apply(v.reshape((-1,) + dims).contiguous(), wK, dims, edims)
        return y.reshape(v.shape[0], -1)

    generic = lambda v: bttb.matmul_by_K(spec, v)
    off = dict(USE_MXU2D_PCG=False, USE_PALLAS_TRANSFORM=False)
    policies = [
        ("kernel-A", kernel_a, {}),
        ("einsum-fp32", generic, dict(off, MATMUL_DFT_POLICY="fp32")),
        ("einsum-tf32", generic, dict(off, MATMUL_DFT_POLICY="tf32")),
        ("einsum-bf16", generic, dict(off, MATMUL_DFT_POLICY="bf16")),
        ("torch.fft", generic, dict(off, MATMUL_DFT_MAX_LEN=0)),
        ("B-8", generic, dict(USE_MXU2D_PCG=False, USE_PALLAS_TRANSFORM=True)),
    ]
    return [_measure("2d", name, spec, x, want, fn, reps, sw) for name, fn, sw in policies]


def run_1d(bsz: int, reps: int, device="cuda", M: int = 2 ** 20):
    grids = [torch.linspace(0.0, 1.0, M, dtype=torch.float32, device=device)]
    kern = SqExp()
    ell = 1.0 / M   # the reference protocol: one grid spacing
    spec = make_spectrum(grids, lambda a, b: kern(a, b, (0.1, ell)), jitter=1e-3)
    L = spec.edims[0]
    x64 = np.random.default_rng(1).standard_normal((bsz, M))
    x = torch.as_tensor(x64, dtype=torch.float32, device=device)
    full = _full_weights(spec.eigs, L).double().cpu().numpy()
    want = _oracle_apply(x64, full, spec.dims, spec.edims)
    generic = lambda v: bttb.matmul_by_K(spec, v)
    return [_measure("1d", "radix", spec, x, want, generic, reps, {}),
            _measure("1d", "torch.fft", spec, x, want, generic, reps,
                     dict(USE_RADIX_FFT=False))]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--bsz-2d", type=int, default=256)
    p.add_argument("--bsz-1d", type=int, default=8)
    p.add_argument("--m1-2d", type=int, default=125, help="inducing points per axis (2-D)")
    p.add_argument("--m-1d", type=int, default=2 ** 20, help="inducing points (1-D)")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--output-dir", default="./output-precision-study")
    p.add_argument("--regime", choices=["2d", "1d", "all"], default="all")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print("device:", name, flush=True)
    os.makedirs(args.output_dir, exist_ok=True)
    out = {}
    for regime, run in (("2d", lambda: run_2d(args.bsz_2d, args.reps, dev, args.m1_2d)),
                        ("1d", lambda: run_1d(args.bsz_1d, args.reps, dev, args.m_1d))):
        if args.regime not in (regime, "all"):
            continue
        out[regime] = run()
        path = os.path.join(args.output_dir, f"summary_{regime}.json")
        with open(path, "w") as f:
            json.dump({"device": name, "rows": out[regime]}, f, indent=1)
        print("wrote", path, flush=True)
    return out


if __name__ == "__main__":
    main()
