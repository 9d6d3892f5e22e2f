#!/usr/bin/env python3
"""Drive the PyTorch port (hipgp_tpu_torch) on one CUDA card, end to end.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one line of progress with its seconds:
  1. build   - every CUDA source of the port, one nvcc per source, in parallel;
  2. kernels - each kernel's wrapper against its plain PyTorch version on the
               card, at the shapes the main path gives it, in float32 with
               TF32 off; times by CUDA events after a warm-up;
  3. main    - the paper's 2-D synthetic protocol: 20 000 + 2 000 points from
               seed 42, the M = 125^2 mean-field model, one natural-gradient
               epoch (79 steps at batch 256, maxiter_cg 10, after the theta2
               warm start) through svigp_fit, then batch_predict on the test
               points; the launch counters are zeroed just before and read
               just after, and checked against the solver's own iteration
               count (each PCG solve makes 1 + 2k self-dot launches, each
               whitening one R^T launch);
  4. accuracy - the float32 kernel-path whitening at M = 125^2 on 256 rows
               against the float64 plain path on the card.
Any failed check raises, so the script exits non-zero.  The line before the
last is the card's name and power limit from nvidia-smi, the one before it a
JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or without the port
beside the script, it exits non-zero and prints no result.
"""
import json
import math
import subprocess
import sys
import time

FP32_PEAK = 67e12     # FLOP/s, H100 SXM, CUDA cores (NVIDIA data sheet)
HBM_RATE = 3.35e12    # bytes/s, H100 SXM
KERNEL_SOURCE = "hipgp_tpu_torch/csrc/mxu2d.cu"
TPU_KERNEL = "hipgp_tpu/ops/mxu2d.py:201"   # pl.pallas_call of _make_kernel


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, warmup=3, reps=20):
    """Mean milliseconds of fn() on the card over ``reps`` launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _fft_ops(n, real):
    """Nominal operations of one n-point FFT: 5 n log2 n for complex data,
    half that for real data (the usual convention for FFT FLOP counts)."""
    return (2.5 if real else 5.0) * n * math.log2(n)


def sandwich_bound_ms(B, i, L, o, selfdot):
    """Least time for the sandwich's work on the card, the larger of
      * operations: the sandwich is a circulant apply, so its least work is
        the FFT formulation on the (L0, L1) embedding, pruned to the rows
        that hold data: a real FFT along the minor axis of the i0 input rows,
        complex FFTs along the leading axis of the L1/2 + 1 half-spectrum
        columns, the scale by the real spectrum, the same two steps back for
        the o0 output rows, and the self-dot; over the FP32 peak;
      * bytes: x and w read once, y (and dots) written once; over the memory
        rate.
    Returns (ms, 'operations' | 'bytes', dense_ms), where dense_ms is the
    operation time of the four dense real-DFT contractions that kernel A and
    its plain version actually perform (about ten times the FFT count)."""
    (i0, i1), (L0, L1), (o0, o1) = i, L, o
    half = L1 // 2 + 1
    ops = (i0 * _fft_ops(L1, True) + 2 * half * _fft_ops(L0, False)
           + 2 * L0 * half + o0 * _fft_ops(L1, True))
    ops = B * (ops + (2 * o0 * o1 if selfdot else 0))
    dense = 2 * B * (i0 * i1 * L1 + L0 * i0 * L1 + o0 * L0 * L1 + o0 * L1 * o1)
    dense += B * L0 * L1 + (2 * B * o0 * o1 if selfdot else 0)
    nbytes = 4 * (B * i0 * i1 + L0 * L1 + B * o0 * o1 + (B if selfdot else 0))
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            1e3 * dense / FP32_PEAK)


def circulant_conv(torch, mxu2d, w, dims, edims, i, o):
    """The sandwich as one torch.nn.functional.conv2d call (the library
    yardstick).  With the spectrum even in each axis the sandwich is the
    circulant c of the embedding applied to the zero-padded input and
    cropped: y[p] = sum_q c[(p - q) mod L] x[q].  That is a
    cross-correlation with a (o0 + i0 - 1, o1 + i1 - 1) stencil and padding
    (o0 - 1, o1 - 1).  Returns (fn(x) -> y, stencil)."""
    (L0, L1), (i0, i1), (o0, o1) = edims, i, o
    dev = w.device
    full = mxu2d._tables(dims, edims, True, True, torch.float64, dev)
    delta = torch.zeros((1, L0, L1), dtype=torch.float64, device=dev)
    delta[0, 0, 0] = 1.0
    c = mxu2d.sandwich_plain(delta, w.double(), *full[:4])[0]   # column 0 of C
    p0, p1 = o0 - 1, o1 - 1
    k0 = (p0 - torch.arange(o0 + i0 - 1, device=dev)) % L0
    k1 = (p1 - torch.arange(o1 + i1 - 1, device=dev)) % L1
    stencil = c[k0][:, k1].to(w.dtype)[None, None].contiguous()
    conv = torch.nn.functional.conv2d
    return (lambda x: conv(x[:, None], stencil, padding=(p0, p1))[:, 0]), stencil


def library_ms(torch, mxu2d, x, w, dims, edims, tables, y64, name):
    """Time the one-call yardstick (conv2d; without the self-dot) after
    checking that it computes the sandwich; None, with the reason logged,
    where cuDNN refuses it or it disagrees with the float64 plain version."""
    fn, stencil = circulant_conv(torch, mxu2d, w, dims, edims, tables[4], tables[5])
    try:
        err = rel(fn(x), y64)
        if err > 1e-4:
            log(f"[kernels] {name} library conv2d disagrees (rel err {err:.3e}); "
                f"library_ms null")
            return None
        ms = cuda_ms(torch, lambda: fn(x), warmup=1, reps=3)
    except RuntimeError as e:
        log(f"[kernels] {name} library conv2d refused ({e}); library_ms null")
        return None
    log(f"[kernels] {name} library conv2d, stencil {tuple(stencil.shape[2:])}: "
        f"rel err {err:.3e} vs float64, {ms:.4f} ms")
    return ms


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def check(cond, msg):
    if not cond:
        raise RuntimeError("check failed: " + msg)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 2
    try:
        import hipgp_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    import numpy as np

    from hipgp_tpu_torch import _build
    from hipgp_tpu_torch.experiments.run_synthetic import build_model, marginal_sig2
    from hipgp_tpu_torch.experiments.synthetic_data import make_two_dim_data
    from hipgp_tpu_torch.infer import FitConfig, batch_predict, svigp_fit
    from hipgp_tpu_torch.ops import bttb, mxu2d, solve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_all = time.perf_counter()
    log(f"chip_smoke: torch {torch.__version__} (CUDA {torch.version.cuda}) on "
        f"{torch.cuda.get_device_name(0)}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build_all(verbose=True)
    log(f"[build] nvcc per source: {json.dumps({k: round(v, 2) for k, v in secs.items()})}"
        f"; {time.perf_counter() - t0:.2f} s")

    # ---- data and the model's spectrum -------------------------------------
    t0 = time.perf_counter()
    d = make_two_dim_data(Nobs=20_000, Ntest=2000, noise_std=0.01,
                          function_complexity="medium", gridnum=64, seed=42)
    sig2 = marginal_sig2(d["yobs"], d["sobs"])
    model = build_model("SqExp", 125, len(d["xobs"]), sig2, 0.05, 0.01,
                        dtype=torch.float32, device=dev)
    state0 = model.init_state()
    spec = model.spectrum(state0)
    dims, edims = spec.dims, spec.edims
    wK = bttb._full_weights(spec.eigs, edims[-1]).contiguous()
    log(f"[setup] data N={len(d['xobs'])}+{len(d['xtest'])}, grid {dims} -> "
        f"embedded {edims}, M'={model.Mprime}; {time.perf_counter() - t0:.2f} s")

    # ---- 2. kernels against their plain versions ---------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    cases = [
        # (wrapper, B, weights, label)
        ("sandwich_apply_selfdot", 256, wK, "PCG apply, w = wK"),
        ("sandwich_apply_selfdot", 256, (1.0 / wK).contiguous(), "PCG apply, w = 1/wK"),
        ("sandwich_apply_selfdot", 2000, wK, "predict PCG apply, w = wK"),
        ("sandwich_apply", 256, torch.sqrt(wK).contiguous(), "R^T, w = sqrt(wK)"),
        ("sandwich_apply", 2000, torch.sqrt(wK).contiguous(), "predict R^T"),
    ]
    for name, B, w, label in cases:
        selfdot = name == "sandwich_apply_selfdot"
        out_exp = not selfdot
        tables = mxu2d._tables(dims, edims, False, out_exp, torch.float32, dev)
        x = torch.randn((B,) + dims, generator=gen, device=dev, dtype=torch.float32)
        if selfdot:
            kern = lambda: mxu2d.sandwich_apply_selfdot(x, w, dims, edims)
        else:
            kern = lambda: mxu2d.sandwich_apply(x, w, dims, edims, out_expanded=True)
        plain = lambda: mxu2d.sandwich_plain(x, w, *tables[:4], selfdot=selfdot)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        y, yp = (got[0], want[0]) if selfdot else (got, want)
        check(y.shape == yp.shape == (B,) + tables[5], f"{name} shape {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), f"{name} non-finite output")
        err_y = rel(y, yp)
        err_abs = float((y - yp).abs().max())
        # both accumulate each contraction in order with FMA, so they may
        # agree bit for bit; the float64 plain version shows the f32 error
        t64 = mxu2d._tables(dims, edims, False, out_exp, torch.float64, dev)
        y64 = mxu2d.sandwich_plain(x.double(), w.double(), *t64[:4], selfdot=selfdot)
        y64 = y64[0] if selfdot else y64
        err64 = rel(y, y64)
        msg = (f"rel err y {err_y:.3e} (max abs {err_abs:.3e}; vs float64 "
               f"{err64:.3e})")
        check(err_y <= 1e-5 and err64 <= 1e-5, f"{name} ({label}) y {msg}")
        if selfdot:
            err_d = rel(got[1], want[1])
            msg += f", dots {err_d:.3e}"
            check(err_d <= 1e-5, f"{name} ({label}) dots rel err {err_d:.3e}")
        ms, plain_ms = cuda_ms(torch, kern), cuda_ms(torch, plain)
        bound, bound_by, dense_ms = sandwich_bound_ms(B, tables[4], edims, tables[5],
                                                      selfdot)
        log(f"[kernels] {name} B={B} {label}: {msg}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}; FFT count), "
            f"dense-DFT operation time {dense_ms:.4f} ms")
        if B == 256 and name not in results:   # the natgrad-step shape
            results[name] = dict(max_abs_err=err_abs, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound, bound_by=bound_by,
                                 library_ms=library_ms(torch, mxu2d, x, w, dims, edims,
                                                       tables, y64, name))
    log(f"[kernels] done; {time.perf_counter() - t0:.2f} s")

    # ---- 3. the main path ----------------------------------------------------
    t0 = time.perf_counter()
    cfg = FitConfig(epochs=1, batch_size=256, lr=1e-2, maxiter_cg=10)
    mxu2d.reset_launches()
    solve.PCG_STATS.update(solves=0, iterations=0)
    state, report = svigp_fit(model, state0, d["xobs"], d["yobs"], d["sobs"], cfg,
                              verbose=False, theta2_warmstart=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches, fit_stats = dict(mxu2d.LAUNCHES), dict(solve.PCG_STATS)
    t1 = time.perf_counter()
    mu, sig = batch_predict(model, state, d["xtest"], batch_size=4096,
                            maxiter_cg=cfg.predict_maxiter_cg)
    mu, sig = mu.cpu().numpy(), sig.cpu().numpy()
    predict_s = time.perf_counter() - t1
    launches, stats = dict(mxu2d.LAUNCHES), dict(solve.PCG_STATS)

    trace = np.asarray(report["elbo_trace"])
    steps = report["steps"]
    step_s = report["epoch_times"][0] / steps
    log(f"[main] fit: warm start + {steps} natgrad steps in {fit_s:.2f} s "
        f"({step_s * 1e3:.1f} ms/step); ELBO first {trace[0]:.4f}, last "
        f"{trace[-1]:.4f}; mean of first 10 {trace[:10].mean():.4f}, of last 10 "
        f"{trace[-10:].mean():.4f}")
    check(steps == 79, f"{steps} steps, expected 79")
    check(bool(np.isfinite(trace).all()), "non-finite ELBO")
    check(trace[-10:].mean() > trace[:10].mean(), "the ELBO did not rise")
    for tag, lc, st in (("fit", fit_launches, fit_stats), ("fit+predict", launches, stats)):
        want_sd = st["solves"] + 2 * st["iterations"]
        log(f"[main] {tag}: {st['solves']} PCG solves, {st['iterations']} "
            f"iterations -> expect {want_sd} self-dot launches and {st['solves']} "
            f"R^T launches; counted {lc}")
        check(lc["sandwich_apply_selfdot"] == want_sd, f"{tag} self-dot launch count")
        check(lc["sandwich_apply"] == st["solves"], f"{tag} R^T launch count")
    check(fit_stats["solves"] == 2 * steps, "one solve per warm-start batch and per step")
    check(fit_stats["iterations"] <= 10 * fit_stats["solves"], "maxiter_cg exceeded")
    rmse = float(np.sqrt(np.mean((mu - d["ftest"]) ** 2)))
    fstd = float(np.std(d["ftest"]))
    check(mu.shape == sig.shape == (2000,), "prediction shape")
    check(bool(np.isfinite(mu).all() and np.isfinite(sig).all()), "non-finite prediction")
    check(rmse < fstd, f"test RMSE {rmse} not below std(ftest) {fstd}")
    log(f"[main] predict: 2000 points in {predict_s:.2f} s; test RMSE {rmse:.5f} vs "
        f"std(ftest) {fstd:.5f}; {time.perf_counter() - t0:.2f} s")

    # ---- 4. whitening accuracy: f32 kernel path vs f64 plain path ------------
    t0 = time.perf_counter()
    x64 = torch.as_tensor(d["xobs"][:256], dtype=torch.float64, device=dev)
    m64 = build_model("SqExp", 125, len(d["xobs"]), sig2, 0.05, 0.01,
                      dtype=torch.float64, device=dev)
    s64 = m64.init_state()
    knm64, _ = m64.make_grams(s64, x64)
    kn64 = solve.whiten(m64.spectrum(s64), knm64, maxiter=10)
    knm32, _ = model.make_grams(state0, x64.float())
    before = dict(mxu2d.LAUNCHES)
    kn32 = solve.whiten(spec, knm32, maxiter=10)
    torch.cuda.synchronize()
    check(mxu2d.LAUNCHES["sandwich_apply"] == before["sandwich_apply"] + 1,
          "the f32 whitening did not take the kernel path")
    err = rel(kn32, kn64)
    log(f"[accuracy] whiten M=125^2, 256 rows, maxiter 10: f32 kernel path vs f64 "
        f"plain path rel err {err:.3e}; {time.perf_counter() - t0:.2f} s")
    check(err <= 5e-3, f"whiten rel err {err}")

    kernels = []
    for name in ("sandwich_apply_selfdot", "sandwich_apply"):
        r = results[name]
        kernels.append({
            "name": f"mxu2d.{name}", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": TPU_KERNEL, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
        check(launches[name] > 0, f"{name} never launched on the main path")
    log(f"[done] total {time.perf_counter() - t_all:.2f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    print(smi.splitlines()[0] if smi else "nvidia-smi printed nothing", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
