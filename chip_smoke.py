#!/usr/bin/env python3
"""Drive the PyTorch port (hipgp_tpu_torch) on one CUDA card, end to end.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one line of progress with its seconds:
  1. build   - every CUDA source of the port, one nvcc per source, in parallel;
  2. kernels - each kernel A wrapper (the FFT-structured sandwich) against
               its plain PyTorch version in float32 and float64 on the card,
               at the shapes the 2-D main path gives it (the R^T's pullback,
               (256, 250, 250) -> (256, 125, 125), included), and kernel B-8
               (the same kernel uncropped) at (256, 250, 250), in float32
               with TF32 off; times by CUDA events after a warm-up: the
               kernel and the plain version in turns, the torch.fft chain,
               the bound; B-8 against the einsum chain in turns (the
               measurement behind bttb.USE_PALLAS_TRANSFORM); the
               self-dot and pullback at M = 256^2 through (512, 512); and the
               'factored' g-stage's shape, (2 048, 64, 64) through (128, 128):
               the first 2 048 rows of the Cholesky factor of
               [full-batch-factored]'s data Gram (localized columns, not
               random draws) through the self-dot at wK and 1/wK and the
               R^T, timed (their own entries of the kernels line);
  3. main    - the paper's 2-D synthetic protocol: 20 000 + 2 000 points from
               seed 42, the M = 125^2 mean-field model, one natural-gradient
               epoch (79 steps at batch 256, maxiter_cg 10, after the theta2
               warm start) through svigp_fit, then batch_predict on the test
               points; the launch counters are zeroed just before and read
               just after, and checked against the solver's own iteration
               count (each PCG solve makes 1 + 2k self-dot launches, each
               whitening one R^T launch);
  4. accuracy - the float32 kernel-path whitening at M = 125^2 on 256 rows
               against the float64 plain path on the card, and the same
               whitening with USE_MXU2D_PCG off and USE_PALLAS_TRANSFORM on
               (the generic PCG over B-8, 2k + 2 B-8 launches);
     train   - the flagship training step: one epoch of the same protocol
               with learn_kernel and learn_noise (natgrad on theta, Adam at
               kernel_lr 1e-3 on the three log-hyperparameters, gradients
               through the whitening by implicit differentiation and through
               kernel A's backward) from the warm start, then prediction;
               per step 2 (1 + 2k) self-dot launches, one R^T and one
               pullback, checked exactly;
     train-grad - one batch from the trained state: the float32 kernel-path
               hyper-gradients against the float64 plain path (limit 1e-2
               relative each), and with USE_PALLAS_TRANSFORM on (one B-8
               launch, the dK term; within 1e-4 of the flag-off run);
     resume  - fit resume on [train]'s protocol (schedule_lr, the warm
               start, natgrad_safe_lr 'warn'): two epochs without a break,
               then one epoch with a checkpoint every epoch resumed for the
               second; the resumed state, hypers and ELBO trace within 1e-5
               of the uninterrupted second epoch, the optimizer at the
               resume (Adam's moments and count, the schedule's count and
               lr) as the uninterrupted run's after its first epoch, kernel
               A's launches in the resumed epoch exact (no warm start, no
               rho); the seconds to save and restore, the checkpoint's bytes;
     full-batch - the closed-form fit (HIPGP.batch_solve) on [main]'s data
               and model: one batch of 20 000 rows, maxiter_cg 10, the mean
               solve at 200 iterations and tol 1e-8, with the ELBO; 'gram'
               then 'dense' (the 62 500^2 matrix and its factor, peak
               torch.cuda.max_memory_allocated under 40 GB), each with the
               counters zeroed just before and read just after (per
               whitening solve 1 + 2k self-dots and one R^T: one solve for
               'gram', two for 'dense'), the seconds of the sweep, the mean
               stage and the ELBO; a prediction of the test points from each
               state (RMSE below std(ftest)); theta2 of 'gram' against
               'dense' within 1e-4; then 'factored' (kappa ~3e3 is above the
               float32 trust region: the RuntimeWarning, and the state and
               ELBO of 'gram' within 1e-6) and 'matfree' (theta2 as 'gram''s
               within 1e-4, its mean PCG's iterations and relative residual,
               the same launch and memory checks);
     accuracy-full-batch - 'gram' on a 64^2 grid, converged (maxiter_cg
               200, the mean solve to tol 1e-10): the float32 kernel path
               against the float64 plain path (theta1 <= 5e-3, ELBO <= 1e-4
               relative), then one 'gram' solve with the cholesky whitening
               (finite ELBO, RMSE below std(ftest));
     full-batch-factored - 'factored' on the same data at 64^2 (kappa under
               1e3): at an explicit factor_jitter 1e-4 (the JAX package's
               float32 jitter; logged; where its bracket guard fires, held
               to 'gram'), then at the default (keyed on the factor's dtype:
               1e-10, the port factors A in float64): no fallback, both
               guards' numbers, stage seconds and peak, ELBO finite, RMSE
               below std(ftest), kernel-A launches exact (two g-stage solves
               of 2 048 factor rows, and the prediction's); then converged
               against [accuracy-full-batch]'s float32 'gram': theta2
               max-relative and ELBO within 1e-2;
     main-block - [main]'s protocol with the block family (2 500 blocks of
               5 x 5 on the 250^2 embedding): the warm start, the clamped lr,
               one epoch of 79 steps, prediction; ELBO rising, rho > 1, RMSE
               below std(ftest), kernel-A launches exact; ms a step beside
               [main]'s;
     full-rank - the full-rank family (the harness's, 'standard') at 64^2
               (M' = 16 384) on [main]'s 20 000 rows, fit by batch_solve
               'dense', prediction and get_inducing_S (symmetric, positive
               diagonal); kernel-A launches exact; then with the whitening
               converged, against the same fit in float64 on the plain path
               (theta1 <= 5e-3, ELBO <= 5e-4: float32 kn moves the full-rank
               bound by 1.4e-4);
  5. kernels-1d - each radix kernel (B-2 stage1, B-3 stage1_inv_dot, B-4
               middle) against its plain version in float32 and in float64 at
               every plan, crop and diagonal the 1-D path gives it at the
               sizes of main-1d: (A, B, C) = (8, 32, 128) uncropped at
               M = 10 000, (16, 128, 128) with 8 rows at 131 072,
               (64, 128, 128) with 31 rows at 500 000, and the headline
               (128, 128, 128) with 64 rows at 2^20 (V = 4 packed planes
               throughout), with the protocol spectrum's weights, and B-7 (the
               two-diagonal middle) with the first two diagonals at each plan;
               at the headline, times of kernel, plain version and
               torch.fft yardstick by CUDA events as in every phase, and
               beside them their device times alone (CUDA-graph replay,
               the kernels line's graph_ms, plain_graph_ms and
               library_graph_ms), each kernel's share of its bound; the
               yardstick is itself held to 1e-5 of f64: fft(n=A) and
               ifft for B-2, ifft + slice + the two self-dots for B-3,
               conj(T1) ifft(d' fft(T1 y)) over each plane for B-4 (one fft,
               two products, two iffts for B-7); and B-7 against two B-4
               launches; radix_middle_wgrad (B-4's weight cotangent) on the
               B-2 forwards of x at the crop and g uncropped at every plan,
               at the headline with the training step's 128 planes, timed
               beside its bound and the torch.fft yardstick (fft of both
               sides, the product, the sum over v), with its ptxas
               registers and spills, its shared memory a CTA and its
               resident two-CTA clusters logged; and the radix apply's
               backward (gx, gd) at the R^T's crop against the plain stages
               in f32 and f64;
  6. main-1d - the paper's section 5.2 driver (run_pcg_vs_cholesky.main,
               Mat52, 3 chained reps) at M = 10 000, 131 072, 500 000 and
               2^20, one size per call with the counters zeroed just before
               and read just after: at the planes-path sizes each 20-iteration
               gram_solve launches middle 2k+2, stage1_inv_dot 2k+1 and
               stage1 2k+3 times (k = 20);
  7. accuracy-1d - at each of those sizes, the float32 kernel-path gram_solve
               (batch 8, 20 iterations) against the same float32 path with
               the plain stages (limit 1e-4) and against the float64 plain
               path on the card: pcg_scan over torch.fft, then matmul_by_RT
               (limit 5e-3);
     train-1d - the 1-D long axis learning its hyperparameters: HIPGP on the
               section 5.2 operator at M = 2^20, 5 120 observations of a 1-D
               MLP function plus noise 0.1 (seed 42), the theta2 warm start,
               then 10 svigp_fit steps at batch 256 and maxiter_cg 20 with
               learn_kernel and learn_noise (kernel_lr 1e-3); ms per step,
               hypers before and after, the ELBO trace, peak memory; the
               launches of B-2, B-3, B-4 and radix_middle_wgrad checked
               exactly against PCG_STATS;
     train-grad-1d - one batch of 32 rows from the trained state: the f32
               kernel-path hyper-gradients against the f64 plain path (limit
               1e-2 relative each), the f32 plain path (USE_RADIX_FFT off)
               logged;
     solve-kn - the paper's section 5.1 study (run_solve_kn.main at its
               defaults: 2-D grids 25, 50, 100, Mat52 at ell 0.05, 2 000
               iterations, batch 16, float32, --no-plots), one grid a call:
               traces finite, PCG at the script's tolerance (10 x the least
               CG RMSE) in no more iterations than CG; the iterations, the
               seconds and the matvec route of each grid;
     precond - the appendix C.1 study (preconditioner_analysis.main at its
               defaults, float32 and --f64): the whole r_pcg table logged as
               found, each row's matvec route; r_pcg <= 1 in the JAX test's
               case (Mat52, ell 0.05, sizes 16 and 64, f64, tol 1e-5);
  8. kernels-3d - the weight-plane kernel B-5 against its plain version in
               float32 and float64 at every shape the 3-D path gives it (the
               PCG self-dot applies (512, 64, 64, 64) with wK and 1/wK, R^T out
               to (512, 64, 128, 128), and the prediction chunk of 400), at
               the pullback crop (expanded in) and, through kernel A's passes
               with a plane index, a (2, 3, 512, 512) stack expanded in and
               out; each case's route, and the times of kernel, plain version
               and torch.fft chain beside its bound; the whole-sample kernel
               B-6 (the cluster-resident FFT sandwich) at the self-dot shape
               (512, 32, 64, 64) with the solver's spectrum, in float32 and
               float64; a second call bit-equal; its bound by operations and
               by bytes, its cluster size and active clusters; B-6 against
               the B-5 pipeline (outer products included), in turns; B-5's
               backward at the R^T's shapes (gx, a B-5 launch at the swapped
               crops; gw, the per-plane analysis product) against the plain
               sandwich's autograd in f32 and f64; B-5 at
               [accuracy-full-batch-3d]'s shapes, (512, 30, 32, 32) through
               (64, 64) planes (B-6's gate does not take that embedding);
  9. main-3d - the paper's section 5.5 dust map (run_domain.main): 64 x 64 x
               32 inducing grid, SqExp with ell 0.07 and the analytic
               semi-integrated estimator, 10 240 line-integral observations
               (cut from 100 000) and 1 000 test stars (cut from 2 000), the
               theta2 warm start, the clamped lr, one natgrad epoch of 20
               steps at batch 512 and maxiter_cg 20, then prediction of e at
               the test stars and of the density on the 20 x 20 slice; the
               counters zeroed just before and read just after: every 3-D
               PCG solve makes 1 + 2k self-dot applies, every whitening one
               R^T;
 10. accuracy-3d - 64 rows of the main path's integrated Knm, 20 iterations:
               the float32 kernel-path whiten against the same float32 path
               with the plain stages (limit 1e-4) and, at ell 0.07, against
               the float64 plain path (limit 5e-3); at ell 0.2 the float64
               error is logged (the float32 spectrum's floor dominates it);
     full-batch-3d - run_domain's paper-scale full-batch fit, 'matfree', at
               main-3d's settings and cut (the mean PCG at 200 iterations,
               tol 1e-8 relative): seconds of the sweep, the mean stage (and
               an iteration) and the ELBO, iterations and residual, peak
               memory under 16 GB, ELBO finite, e post-RMSE below
               rms(e_test); B-6 and B-5 launches exact against PCG_STATS (the
               float64 mean PCG launches nothing);
     accuracy-full-batch-3d - 'matfree' on a 32 x 32 x 16 grid, 2 048 line
               integrals, ell 0.07, converged: float32 on the kernel path
               against float32 'gram' (theta2 <= 1e-6, theta1 <= 5e-3, ELBO
               <= 1e-4) and against float64 on the plain path (theta1 <= 5e-3,
               ELBO <= 1e-4);
     full-batch-3d-block - full-batch-3d with the block 2 x 2 x 2 family
               (131 072 blocks of 8): stage seconds, the block Lambda's share
               of the sweep, peak memory, B-6 and B-5 launches exact; its qm
               within 1e-5 of full-batch-3d's mean-field qm and its ELBO not
               below the mean-field one (Fischer's inequality);
     accuracy-full-batch-3d-block - the block 2 x 2 x 2 'matfree' at 32 x 32
               x 16, converged: float32 on the kernel path against float64 on
               the plain path (theta2 <= 1e-4, theta1 <= 5e-3, ELBO <= 1e-4);
     train-3d - the dust map learning its hyperparameters: main-3d's model and
               data, the warm start, 10 svigp_fit steps at batch 512 and
               maxiter_cg 20 with learn_kernel and learn_noise; ms per step,
               the hypers, peak memory; B-6's self-dot applies and B-5's R^T
               and pullback launches checked exactly;
     train-grad-3d - 64 integrated rows from that state: the f32 kernel-path
               hyper-gradients against the f64 plain path (limit 1e-2), the
               f32 plain path (USE_MXU3D_PCG off) logged;
     deposit - the dust-density deposition on the card: sph_deposit and
               cic_deposit of 4 194 304 synthetic particles (log-normal
               smoothing lengths of 0.3-3 cells) onto 128 x 128 x 64 cells,
               seconds, particles a second and peak memory; the first
               262 144 against the same function in float64 on the CPU (max
               cell and sum within 1e-4), CIC mass at the full count within
               1e-5 of sum(q) / cell volume; run_domain --snapshot
               --deposit-method sph and cic end to end at [main-3d]'s cut on
               a written observation table and snapshot;
 11. svgp    - the dense SVGP at the 2-D protocol's M = 125^2 (15 625
               inducing points, unwhitened, jitter 1e-3, [main]'s data):
               run_synthetic --models SVGP --fit-method full-batch in float64
               and in float32 (seconds, peak memory < 60 GB, float64 test RMSE
               below std(ftest), ELBO finite; the float64 predictive mean
               and std against a plain float64 closed form of the same
               posterior, SVGP_PLAIN_TOL; the float32 theta1 and
               predictions against float64 logged), then 10 natgrad steps
               through svigp_fit in float64 at batch 256 and lr 1e-2 x 1000/N
               (ELBO finite at every step, theta moved, ||theta1 - theta1*||
               against the closed form logged after each step);
     derivative - run_derivative_1d at its defaults with --f64, then
               --compare: the latent RMSE finite and at most 1.25 x the exact
               joint GP's, the tables logged beside RESULTS section 6's;
     trajectory - natgrad_trajectory at the reduced scale (legs torch, chol,
               solve, torch-svgp; float64) and at --paper --warmstart
               --safe-lr clamp --ell 0.2 --epochs 3 (the torch leg in float32
               on kernel A, its launches exact against PCG_STATS; the solve
               leg): rows finite, the solve RMSE below std(ftest), RMSE and
               ELBO per epoch beside the TPU's recorded ones;
     precision - precision_study at its defaults (2-D batch 256 at 125^2:
               kernel A, the einsum chain in FP32, TF32 and bf16, torch.fft,
               B-8; 1-D batch 8 at L = 2^21: the radix kernels, torch.fft):
               every FP32 policy's apply within 1e-5 of the float64 oracle,
               TF32 and bf16 logged, each kernel policy's launches moved,
               every switch restored;
     uci     - run_3droad and run_ukhousing on their synthetic data at their
               defaults (20 000 rows, the 'dense' closed form): predictions
               finite, test RMSE below the targets' std, kernel A's launches
               exact where the embedding has a kernel-A plan;
     demo-1d - demo_1d's fit (dense SVGP and 1-D HIP-GP): RMSEs below 0.1;
     trace   - utils.profiling's PhaseTimer and trace around 5 natgrad steps
               of [main]'s model: the Chrome trace names kernel A's CUDA
               kernels, the timer counts 5 calls; ms a step beside [main]'s;
     dp      - (after [accuracy]) two ranks over gloo on the one card
               (parallel.launch; gloo for several ranks on one GPU, NCCL
               cannot): [main]'s epoch through svigp_fit(data_shard_fn=
               make_dp_data_shard_fn(mesh)), 128 rows a rank a step; theta1,
               theta2, the ELBO trace, rho and the lr used within 1e-4 of
               [main]'s; each rank's kernel-A launches exact against its own
               PCG_STATS; ms a step beside [main]'s, the bytes all-reduced a
               step, each rank's peak; no rank runs nvcc;
     dp-solve - the same ranks: dp_batch_solve with the ELBO at 64^2
               (M' = 16 384) on [main]'s data cut to 19 999 rows, laid out by
               process_slice / global_batch / global_row_weights (one pad
               row), micro-batch 2 000, maxiter_cg 10; in float32 theta2
               within 1e-4, theta1 within 1.5e-3 and the ELBO within 1e-5
               of the single-process dense batch_solve; in float64 theta and
               the ELBO within 1e-8 of the single-process float64 solve at
               the ranks' micro-batch of 1 000; the sweep's, all-reduce's
               and finalize's seconds, the peaks;
     grid-fft - the same ranks: sharded_gram_solve at M = 125^2 (the spectrum
               at multiple_of = shard_multiples(dims, 2), 256 rows, 10
               iterations) and on the section 5.2 operator at M = 2^20 by
               the four-step FFT (batch 8, 20 iterations), each within 5e-3
               of the float64 single-device plain gram_solve, beside the
               float32 kernel path (kernel A; the radix kernels): the gap,
               ms a solve for both, the bytes through all_to_all a solve;
     dp-nccl - a world of one rank over NCCL: [main]'s epoch (within 1e-6 of
               [main]'s; the gap reported) and the 2-D [grid-fft] case;
Any failed check raises, so the script exits non-zero.  The line before the
last is the card's name and power limit from nvidia-smi, the one before it a
JSON object with one entry per kernel (the radix kernels' entries add the
graph-replay times of [kernels-1d]); the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or without the port
beside the script, it exits non-zero and prints no result.
"""
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

FP32_PEAK = 67e12     # FLOP/s, H100 SXM, CUDA cores (NVIDIA data sheet)
HBM_RATE = 3.35e12    # bytes/s, H100 SXM
# device-time-only (CUDA-graph replay) times of the radix kernels' entries
GRAPH_KEYS = ("graph_ms", "plain_graph_ms", "library_graph_ms")
KERNEL_SOURCE = "hipgp_tpu_torch/csrc/sandwich_fft.cu"   # kernels A and B-8
WP_SOURCE = "hipgp_tpu_torch/csrc/sandwich_wp.cu"        # kernel B-5
TPU_KERNEL = "hipgp_tpu/ops/mxu2d.py:201"   # pl.pallas_call of _make_kernel
RADIX_SOURCE = "hipgp_tpu_torch/csrc/radix.cu"
# pl.pallas_call sites of the TPU kernels the radix kernels replace
RADIX_TPU_KERNELS = {"stage1": "hipgp_tpu/ops/radix_fft.py:649",
                     "stage1_inv_dot": "hipgp_tpu/ops/radix_fft.py:686",
                     "middle": "hipgp_tpu/ops/radix_fft.py:530"}
WP_TPU_KERNEL = "hipgp_tpu/ops/mxu2d.py:325"    # pl.pallas_call of _make_kernel_wp
WP3_SOURCE = "hipgp_tpu_torch/csrc/mxu3d.cu"
WP3_TPU_KERNEL = "hipgp_tpu/ops/mxu3d.py:248"   # pl.pallas_call of _make_kernel_wp3
DUAL_TPU_KERNEL = "hipgp_tpu/ops/radix_fft.py:497"   # _middle_pallas_dual
B8_TPU_KERNEL = "hipgp_tpu/ops/pallas_transform.py:99"   # _pallas_apply
# the section 5.5 dust map as main-3d runs it (the JAX RESULTS section 14d
# natgrad protocol, cut to 10 240 observations and 1 000 test stars)
DOMAIN = dict(nobs=10_240, ntest=1000, noise_std=0.1, nx=64, nz=32)
DOMAIN_ELL = 0.07
# [accuracy-full-batch-3d]: a 32 x 32 x 16 grid (M = 16 384, so 'gram''s
# float64 A is 2.1 GB) and 2 048 line integrals of the same dust field
FB3_ACC = dict(nobs=2048, ntest=100, noise_std=0.1, nx=32, nz=16)
DOMAIN_BATCH = 512
HEADLINE_M = 1 << 20      # the 1-D headline: L = 2^21, (A, B, C) = (128, 128, 128)
SIZES_1D = (10_000, 131_072, 500_000, HEADLINE_M)
PCG_ITERS = 20            # the section 5.2 protocol's fixed iteration count


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


def graph_ms(torch, fn, warmup=3, reps=20):
    """Mean milliseconds of fn() on the card, device time only: ``reps``
    calls captured in one CUDA graph (after ``warmup`` calls on a side
    stream) and the graph replayed between two events.  For kernels as
    short as the host's own cost of a wrapper call (its checks and
    allocations, tens of microseconds), back-to-back calls time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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
    operation time of the four dense real-DFT contractions that the plain
    version performs (about ten times the FFT count)."""
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


def fft_chain_ms(torch, x, w, edims, dims_out, y64):
    """Time of the torch.fft chain of a 2-D sandwich (rfft2 x w, irfft2,
    crop; the yardstick of the pullback and B-8) after checking it against
    the float64 plain result: (ms, rel err)."""
    fn = lambda: fft_chain(torch, x, w, edims, dims_out)
    err = rel(fn(), y64)
    check(err <= 1e-4, f"torch.fft chain rel err {err:.3e}")
    return cuda_ms(torch, fn, warmup=1, reps=5), err


def phase_kernels_b8(torch, dev, wK, edims, gen):
    """Kernel B-8 (the full-plane sandwich) at (256, 250, 250) with the
    main path's spectrum against its plain version (the einsum chain) and
    float64, limit 1e-5; times of B-8 and the einsum chain in turns, and the
    torch.fft chain, the bound.  Returns B-8's record of the kernels line."""
    from hipgp_tpu_torch.ops import bttb, mxu2d, pallas_transform

    B = 256
    Q0, Q1 = (bttb._real_fourier_basis(L, torch.float32, dev) for L in edims)
    Q0d, Q1d = (bttb._real_fourier_basis(L, torch.float64, dev) for L in edims)
    x = torch.randn((B,) + tuple(edims), generator=gen, device=dev)
    kern = lambda: pallas_transform.circulant_apply_2d(x, Q0, Q1, wK)
    plain = lambda: pallas_transform._apply_einsum(x, Q0, Q1, wK)
    got, want = kern(), plain()
    y64 = pallas_transform._apply_einsum(x.double(), Q0d, Q1d, wK.double())
    torch.cuda.synchronize()
    check(got.shape == want.shape == (B,) + tuple(edims), f"B-8 shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "B-8 non-finite output")
    err32, err64 = rel(got, want), rel(got, y64)
    abs_err = float((got - want).abs().max())
    check(err32 <= 1e-5 and err64 <= 1e-5,
          f"B-8 rel err vs plain f32 {err32:.3e}, vs f64 {err64:.3e}")
    k1, p1 = cuda_ms(torch, kern), cuda_ms(torch, plain)
    p2, k2 = cuda_ms(torch, plain), cuda_ms(torch, kern)
    ms, plain_ms = 0.5 * (k1 + k2), 0.5 * (p1 + p2)
    fft_ms, fft_err = fft_chain_ms(torch, x, wK, edims, edims, y64)
    bound, bound_by, dense_ms = sandwich_bound_ms(B, edims, edims, edims, False)
    log(f"[kernels] B-8 circulant_apply_2d B={B} {tuple(edims)}, w = wK: rel err vs "
        f"plain f32 {err32:.3e} (max abs {abs_err:.3e}), vs float64 {err64:.3e}; kernel "
        f"{ms:.4f} ms ({k1:.4f}, {k2:.4f}), einsum chain (plain) {plain_ms:.4f} ms "
        f"({p1:.4f}, {p2:.4f}), in turns; torch.fft chain {fft_ms:.4f} ms (rel err vs "
        f"f64 {fft_err:.3e}); bound {bound:.4f} ms ({bound_by}; FFT count), dense-DFT "
        f"operation time {dense_ms:.4f} ms; USE_PALLAS_TRANSFORM = "
        f"{bttb.USE_PALLAS_TRANSFORM}")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=fft_ms)


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


def _by_rows(fn, x, rows=2000):
    """fn of x, applied to blocks of at most ``rows`` rows and concatenated
    (a plain version row by row holds a batch of 20 000 within memory)."""
    import torch

    parts = [fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def phase_kernel_a_case(torch, dev, mxu2d, gen, name, B, w, label, dims, edims, in_exp,
                        out_exp, timed, with_library=False, x=None):
    """Kernel A through one wrapper at one shape: against its plain version
    in float32 and float64 (limit 1e-5, dots too); with ``timed``, the
    kernel and the plain version in turns, the torch.fft chain, the bound
    and, ``with_library``, the conv2d yardstick.  The input is ``x``, or
    normal draws from ``gen``.  Returns its record of the kernels line (None
    when not ``timed``)."""
    selfdot = name == "sandwich_apply_selfdot"
    tables = mxu2d._tables(dims, edims, in_exp, out_exp, torch.float32, dev)
    if x is None:
        x = torch.randn((B,) + tables[4], generator=gen, device=dev, dtype=torch.float32)
    check(tuple(x.shape) == (B,) + tables[4], f"{name} input {tuple(x.shape)}")
    if selfdot:
        kern = lambda: mxu2d.sandwich_apply_selfdot(x, w, dims, edims)
    else:
        kern = lambda: mxu2d.sandwich_apply(x, w, dims, edims, in_expanded=in_exp,
                                            out_expanded=out_exp)
    plain = lambda: mxu2d.sandwich_plain(x, w, *tables[:4], selfdot=selfdot)
    got = kern()
    want = _by_rows(lambda xs: mxu2d.sandwich_plain(xs, w, *tables[:4], selfdot=selfdot), x)
    torch.cuda.synchronize()
    y, yp = (got[0], want[0]) if selfdot else (got, want)
    check(y.shape == yp.shape == (B,) + tables[5], f"{name} shape {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), f"{name} non-finite output")
    err_y = rel(y, yp)
    err_abs = float((y - yp).abs().max())
    t64 = mxu2d._tables(dims, edims, in_exp, out_exp, torch.float64, dev)
    y64 = _by_rows(lambda xs: mxu2d.sandwich_plain(xs.double(), w.double(), *t64[:4],
                                                   selfdot=selfdot), x)
    y64, d64 = (y64[0], y64[1]) if selfdot else (y64, None)
    err64 = rel(y, y64)
    msg = f"rel err y {err_y:.3e} (max abs {err_abs:.3e}; vs float64 {err64:.3e})"
    check(err_y <= 1e-5 and err64 <= 1e-5, f"{name} ({label}) y {msg}")
    if selfdot:
        err_d, err_d64 = rel(got[1], want[1]), rel(got[1], d64)
        msg += f", dots {err_d:.3e} (vs float64 {err_d64:.3e})"
        check(err_d <= 1e-5 and err_d64 <= 1e-5, f"{name} ({label}) dots {msg}")
    if not timed:
        ms = cuda_ms(torch, kern, warmup=1, reps=5)
        log(f"[kernels] {name} B={B} {label}: {msg}; kernel {ms:.4f} ms")
        return None
    k1, p1 = cuda_ms(torch, kern), cuda_ms(torch, plain)
    p2, k2 = cuda_ms(torch, plain), cuda_ms(torch, kern)
    ms, plain_ms = 0.5 * (k1 + k2), 0.5 * (p1 + p2)
    fft_ms, fft_err = fft_chain_ms(torch, x, w, edims, tables[5], y64)
    bound, bound_by, dense_op_ms = sandwich_bound_ms(B, tables[4], edims, tables[5], selfdot)
    log(f"[kernels] {name} B={B} {label}: {msg}; kernel {ms:.4f} ms ({k1:.4f}, {k2:.4f}), "
        f"plain {plain_ms:.4f} ms ({p1:.4f}, {p2:.4f}), in turns; torch.fft chain {fft_ms:.4f} ms (rel err vs f64 "
        f"{fft_err:.3e}); bound {bound:.4f} ms ({bound_by}; FFT count), dense-DFT "
        f"operation time {dense_op_ms:.4f} ms")
    lib = (library_ms(torch, mxu2d, x, w, dims, edims, tables, y64, name)
           if with_library else None)
    return dict(max_abs_err=err_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=lib)


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def max_rel(a, b):
    """max |a - b| / max |b|: the JAX package's factored-solve measure."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def factored_model(torch, dev, d, dtype=None):
    """[full-batch-factored]'s model: [main]'s data on a 64^2 grid (SqExp,
    ell 0.05), float32 unless ``dtype``; with its init state and spectrum."""
    from hipgp_tpu_torch.experiments.run_synthetic import build_model, marginal_sig2

    m = build_model("SqExp", FB_ACC_GRID, len(d["xobs"]), marginal_sig2(d["yobs"], d["sobs"]),
                    0.05, 0.01, dtype=dtype or torch.float32, device=dev)
    st = m.init_state()
    return m, st, m.spectrum(st)


def phase_kernels_factored(torch, dev, mxu2d, gen, d):
    """Kernel A at the 'factored' g-stage's shape: the first FACTOR_CHUNK
    rows of L_A^T, L_A the Cholesky factor (the solver's default jitter) of
    [full-batch-factored]'s data Gram over all 20 000 rows, as (2048, 64, 64)
    images through the (128, 128) embedding: the PCG self-dot apply at wK and
    1/wK and the R^T at sqrt(wK), each against its plain version and float64
    (limit 1e-5) and timed.  Returns the records of the kernels line."""
    from hipgp_tpu_torch.infer.fit import prepare_batches
    from hipgp_tpu_torch.models.hipgp import FACTOR_CHUNK, GRAM_ACC_DTYPE
    from hipgp_tpu_torch.ops import bttb

    m, st, spec = factored_model(torch, dev, d)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    xb, yb, sb, w = prepare_batches(as_t(d["xobs"]), as_t(d["yobs"]), as_t(d["sobs"]), -1)
    flags = dict(integrated_obs=False, semi_integrated_estimator="analytic",
                 semi_integrated_samps=10, generator=None)
    A = m._gram_sweep(st, spec, (xb, yb, w, sb), flags, 0, kn=False)[1]
    L, eps = m.factor_data_gram(A)
    del A
    check(L.dtype == GRAM_ACC_DTYPE, f"the factor is {L.dtype}")
    B = min(FACTOR_CHUNK, m.M)
    rows = L.T[:B].to(torch.float32).reshape((B,) + m.dims).contiguous()
    del L
    nz = (rows.abs() > 1e-6 * rows.abs().amax(dim=(1, 2), keepdim=True)).sum(dim=(1, 2))
    log(f"[kernels] 'factored' g-stage input: rows of L_A^T, L_A the Cholesky factor of "
        f"the {FB_ACC_GRID}^2 data Gram A (jitter {eps:.3e}); {B} rows of "
        f"{m.M} points, entries above 1e-6 of the row's largest: median "
        f"{int(nz.median())}, min {int(nz.min())}, max {int(nz.max())}")
    wK = bttb._full_weights(spec.eigs, spec.edims[-1]).contiguous()
    out = {}
    for name, w, label in (
            ("sandwich_apply_selfdot", wK, "factored g-stage PCG apply, w = wK"),
            ("sandwich_apply_selfdot", (1.0 / wK).contiguous(),
             "factored g-stage PCG apply, w = 1/wK"),
            ("sandwich_apply", torch.sqrt(wK).contiguous(), "factored g-stage R^T")):
        r = phase_kernel_a_case(torch, dev, mxu2d, gen, name, B, w, label,
                                spec.dims, spec.edims, False, name == "sandwich_apply",
                                timed=True, with_library="1/wK" not in label, x=rows)
        out.setdefault(f"factored {name}", r)
    return out


def ptxas_resources(log, kernel):
    """ptxas -v's registers and spills of every instance of ``kernel`` in a
    build log: {template argument: (registers, spill stores, spill loads)}."""
    out, cur, spill = {}, None, (None, None)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur, spill = m.group(1), (None, None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur and kernel in cur:
            arg = re.search(kernel + r"ILi(\d+)E", cur)
            out[int(arg.group(1)) if arg else cur] = (int(m.group(1)), *spill)
    return out


def check(cond, msg):
    if not cond:
        raise RuntimeError("check failed: " + msg)


def radix_bound_ms(kind, V, A, B, C, in_rows, out_rows):
    """Least time for a radix stage's work on the card, the larger of
      * operations: the FFT formulation (5 n log2 n per complex n-point FFT):
        stage 1 is V * B*C A-point FFTs; the middle is the (B, C)-plane FFT
        of every (v, ka) both ways plus the product with d; its weight
        cotangent the forward (B, C)-plane FFT of both inputs plus 4
        operations a point for Re[X conj(G)] and the sum; the self-dot
        adds 2 operations per output element of each part;
      * bytes: the input planes (and rider, and d) read once, the output
        planes (and dots) written once; over the memory rate.
    Returns (ms, 'operations' | 'bytes', dense_ms), where dense_ms is the
    operation time of the dense-table formulation of the TPU kernels (three
    real table products per complex DFT), which the kernels do not use."""
    N = B * C
    if kind == "middle":
        ops = V * A * (2 * _fft_ops(N, False) + 2 * N)
        dense = V * A * 2 * 3 * 2 * (B * B * C + B * C * C)
        nbytes = 4 * (2 * 2 * V * A * N + A * N)
    elif kind == "middle_wgrad":   # two forward halves, the product, the sum over v
        ops = V * A * (2 * _fft_ops(N, False) + 4 * N)
        dense = V * A * 2 * 3 * 2 * (B * B * C + B * C * C)
        nbytes = 4 * (4 * V * A * N + A * N)
    elif kind == "middle_dual":   # one forward half, two products, two inverse halves
        ops = V * A * (3 * _fft_ops(N, False) + 4 * N)
        dense = V * A * 3 * 3 * 2 * (B * B * C + B * C * C)
        nbytes = 4 * (3 * 2 * V * A * N + 2 * A * N)
    else:
        ops = V * N * _fft_ops(A, False)
        dense = 3 * 2 * out_rows * in_rows * N * V
        nbytes = 4 * 2 * V * N * (in_rows + out_rows)
        if kind == "stage1_inv_dot":
            ops += 2 * 2 * V * out_rows * N
            nbytes += 4 * (2 * V * out_rows * N + 2 * V)
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            1e3 * dense / FP32_PEAK)


def protocol_spectrum_1d(M, dtype, dev):
    """The section 5.2 protocol's operator at size M, as the driver builds it
    (Matern-5/2, sig2 0.1, ell one grid spacing on [0, 1], jitter 1e-3)."""
    from hipgp_tpu_torch.experiments.run_pcg_vs_cholesky import (protocol_problem,
                                                                 protocol_spectrum)
    from hipgp_tpu_torch.kernels import kernel_from_name

    return protocol_spectrum(*protocol_problem(kernel_from_name("Mat52"), M, dtype, dev))


def radix_operands(torch, M, dev):
    """What the 1-D main path hands the radix kernels at size M: (plan in
    f32 and f64, crop rows, planes path?, {label: stage-order diagonal}).
    The planes path crops to the rows that hold data and takes w/L, 1/(wL)
    and sqrt(w)/L; the generic path applies uncropped (rows = A) with the
    permuted natural spectra of K, C^-1 and R^T."""
    from hipgp_tpu_torch.ops import bttb, radix_fft, solve

    spec = protocol_spectrum_1d(M, torch.float32, dev)
    L = spec.edims[0]
    p32 = radix_fft.make_plan(L, torch.float32, dev)
    p64 = radix_fft.make_plan(L, torch.float64, dev)
    planes = solve._planes_solver_ok(spec, torch.float32, dev)
    if planes:
        w = solve._planes_weights(spec, p32)
        weights = {"w/L": w / L, "1/(wL)": 1.0 / (w * L), "sqrt(w)/L": torch.sqrt(w) / L}
        rows = -(-M // (p32.B * p32.C))
    else:
        perm = lambda e: radix_fft.permute_weights(bttb._full_weights(e, L), p32)
        weights = {"eigs/L": perm(spec.eigs), "1/(eigs L)": perm(1.0 / spec.eigs),
                   "sqrt(eigs)/L": perm(torch.sqrt(spec.eigs))}
        rows = p32.A
    return p32, p64, rows, planes, {k: v.contiguous() for k, v in weights.items()}


def radix_backward_check(torch, dev, p32, p64, rows, V):
    """The radix apply's backward at the planes R^T's crop (rows -> A): gx
    (B-2, B-4, B-2 with the crops swapped) and gd (two B-2 forwards and
    radix_middle_wgrad) on the card in f32 against the same Function with
    the plain stages in f32 and in f64, limit 1e-5 each; launches exact."""
    from hipgp_tpu_torch.ops import radix_fft

    A, N = p32.A, p32.B * p32.C
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((2, V, rows * N), generator=gen, device=dev, dtype=torch.float64)
    c = torch.randn((2, V, A * N), generator=gen, device=dev, dtype=torch.float64)
    d = torch.rand((p32.A, p32.B, p32.C), generator=gen, device=dev,
                   dtype=torch.float64) / p32.L

    def grads(dt, plan):
        xr, xi = (t.to(dt, copy=True).requires_grad_() for t in x)
        dp = d.to(dt, copy=True).requires_grad_()
        yr, yi = radix_fft.fused_circulant_apply_cropped(xr, xi, dp, plan, rows, A)
        loss = torch.sum(yr * c[0].to(dt) + yi * c[1].to(dt))
        return torch.autograd.grad(loss, (xr, xi, dp))

    before = dict(radix_fft.LAUNCHES)
    got = grads(torch.float32, p32)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in radix_fft.LAUNCHES.items() if v != before[k]}
    check(moved == {"stage1": 6, "middle": 2, "middle_wgrad": 1},
          f"radix apply forward + backward launched {moved}")
    with plain_radix_stages(radix_fft):
        want32 = grads(torch.float32, p32)
        want64 = grads(torch.float64, p64)
    errs = [(rel(g, w32), rel(g, w64)) for g, w32, w64 in zip(got, want32, want64)]
    log(f"[kernels-1d] the radix apply's backward, {rows} -> {A} rows, V = {V}: rel err "
        f"(vs plain stages f32, vs f64) gxr {errs[0][0]:.3e}, {errs[0][1]:.3e}; gxi "
        f"{errs[1][0]:.3e}, {errs[1][1]:.3e}; gd {errs[2][0]:.3e}, {errs[2][1]:.3e}; "
        f"launches {moved}")
    check(all(max(e) <= 1e-5 for e in errs), f"radix apply backward rel errs {errs}")


def phase_kernels_1d(torch, dev):
    """Each radix kernel against its plain version (f32 and f64) at the
    plan, crop rows and diagonals the main path gives it at every size of
    [main-1d]; times at the headline.  Returns the per-kernel record of the
    kernels line (launches filled in later)."""
    from hipgp_tpu_torch import _build
    from hipgp_tpu_torch.ops import radix_fft

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                     dtype=torch.float64)
    fft = torch.fft
    results = {}
    for M in SIZES_1D:
        p32, p64, rows, planes, weights = radix_operands(torch, M, dev)
        L, A, B, C = p32.L, p32.A, p32.B, p32.C
        N, V = B * C, 4
        timed = M == HEADLINE_M
        if timed:
            check((L, A, B, C, rows) == (1 << 21, 128, 128, 128, 64),
                  f"headline plan {(L, A, B, C, rows)}")
        tag = f"M={M} (A, B, C) = {(A, B, C)}"

        def record(name, label, got, want32, want64, kern, plain, bound, lib_fn=None,
                   lib_ref=None, lib_err=None):
            torch.cuda.synchronize()
            errs, errs64, abs_err = [], [], 0.0
            for g, w32, w64 in zip(got, want32, want64):
                check(g.shape == w32.shape and g.dtype == torch.float32,
                      f"{name} {tag} ({label}) shape {tuple(g.shape)}")
                check(bool(torch.isfinite(g).all()),
                      f"{name} {tag} ({label}) non-finite output")
                errs.append(rel(g, w32))
                errs64.append(rel(g, w64))
                abs_err = max(abs_err, float((g - w32).abs().max()))
            msg = (f"rel err vs plain f32 {max(errs):.3e} (max abs {abs_err:.3e}), "
                   f"vs plain f64 {max(errs64):.3e}")
            check(max(errs) <= 1e-5 and max(errs64) <= 1e-5, f"{name} {tag} ({label}) {msg}")
            if not timed:
                log(f"[kernels-1d] {name} {tag} {label}: {msg}")
                return
            # ms as in every phase (back-to-back calls between events), and
            # the device time alone (graph replay) beside it
            ms, plain_ms = cuda_ms(torch, kern), cuda_ms(torch, plain)
            g_ms, g_plain = graph_ms(torch, kern), graph_ms(torch, plain)
            lib_ms = g_lib = None
            if lib_fn is not None:
                lib_e = lib_err(lib_fn()) if lib_err is not None else rel(lib_fn(), lib_ref)
                check(lib_e <= 1e-5, f"{name} ({label}) library call rel err {lib_e:.3e}")
                lib_ms, g_lib = cuda_ms(torch, lib_fn), graph_ms(torch, lib_fn)
                msg += (f"; library rel err vs f64 {lib_e:.3e}, {lib_ms:.4f} ms "
                        f"(graph {g_lib:.4f})")
            log(f"[kernels-1d] {name} {tag} {label}: {msg}; kernel {ms:.4f} ms "
                f"({100 * bound[0] / ms:.1f} % of its bound; graph {g_ms:.4f} ms, "
                f"{100 * bound[0] / g_ms:.1f} %), plain {plain_ms:.4f} ms (graph "
                f"{g_plain:.4f}), bound {bound[0]:.4f} ms ({bound[1]}; FFT count), "
                f"dense-table operation time {bound[2]:.4f} ms")
            if name not in results:
                results[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                                     bound_ms=bound[0], bound_by=bound[1],
                                     library_ms=lib_ms, graph_ms=g_ms,
                                     plain_graph_ms=g_plain, library_graph_ms=g_lib)

        # the torch.fft chain of the middle (the yardstick of B-4 and B-7):
        # conj(T1) ifft(d' fft(T1 y)) over each plane's B*C points, with
        # d'[ka, kb + B kc] = d[ka, kb, kc] (stage order is natural order
        # within a plane); T1 and d' are formed outside the timing
        if timed:
            n = torch.arange(N, device=dev, dtype=torch.float64)
            ang = (-2.0 * math.pi / L) * torch.arange(A, device=dev,
                                                       dtype=torch.float64)[:, None] * n
            t1 = torch.polar(torch.ones_like(ang), ang).to(torch.complex64)
            t1c = t1.conj()
            flat = lambda d: d.permute(0, 2, 1).reshape(A, N).to(torch.complex64)

        def middle_chain(yc, *ds):
            f = fft.fft(t1 * yc, dim=-1)
            return [fft.ifft(d * f, dim=-1, norm="forward") * t1c for d in ds]

        def planes(z):   # (V, A, N) complex -> the kernels' (2, V, A, B, C) parts
            return torch.stack([z.real, z.imag]).view(2, V, A, B, C)

        # B-2 forward, rows -> A (every apply's first stage; cropped on the
        # planes path)
        x = rnd(2, V, rows, N)
        x32 = x.float()
        wr, wi = radix_fft._s1_tables(p32, rows, A, False)
        wr64, wi64 = radix_fft._s1_tables(p64, rows, A, False)
        xc = torch.complex(x32[0], x32[1])
        ref = fft.fft(torch.complex(x[0], x[1]), n=A, dim=1)
        record("stage1", f"forward {rows} -> {A} rows",
               radix_fft.stage1(x32[0], x32[1], p32, A, False),
               radix_fft.stage1_plain(x32[0], x32[1], wr, wi),
               radix_fft.stage1_plain(x[0], x[1], wr64, wi64),
               lambda: radix_fft.stage1(x32[0], x32[1], p32, A, False),
               lambda: radix_fft.stage1_plain(x32[0], x32[1], wr, wi),
               radix_bound_ms("stage1", V, A, B, C, rows, A),
               lambda: torch.view_as_real(fft.fft(xc, n=A, dim=1)),
               torch.view_as_real(ref))
        # B-2 inverse, uncropped A -> A rows (R^T's last stage; every apply's
        # on the generic path)
        z = rnd(2, V, A, N)
        z32 = z.float()
        wr, wi = radix_fft._s1_tables(p32, A, A, True)
        wr64, wi64 = radix_fft._s1_tables(p64, A, A, True)
        zc = torch.complex(z32[0], z32[1])
        ref = fft.ifft(torch.complex(z[0], z[1]), dim=1, norm="forward")
        record("stage1", f"inverse {A} -> {A} rows",
               radix_fft.stage1(z32[0], z32[1], p32, A, True),
               radix_fft.stage1_plain(z32[0], z32[1], wr, wi),
               radix_fft.stage1_plain(z[0], z[1], wr64, wi64),
               lambda: radix_fft.stage1(z32[0], z32[1], p32, A, True),
               lambda: radix_fft.stage1_plain(z32[0], z32[1], wr, wi),
               radix_bound_ms("stage1", V, A, B, C, A, A),
               lambda: torch.view_as_real(fft.ifft(zc, dim=1, norm="forward")),
               torch.view_as_real(ref))
        # B-4 with each of the three diagonals of the path
        y = rnd(2, V, A, B, C)
        y32 = y.float()
        yc = torch.complex(y32[0], y32[1]).view(V, A, N)
        for label, d32 in weights.items():
            d64 = d32.double()
            want64 = radix_fft.middle_plain(y[0], y[1], d64, p64)
            dflat = flat(d32) if timed else None
            record("middle", f"d = {label}",
                   radix_fft.middle(y32[0], y32[1], d32, p32),
                   radix_fft.middle_plain(y32[0], y32[1], d32, p32), want64,
                   lambda: radix_fft.middle(y32[0], y32[1], d32, p32),
                   lambda: radix_fft.middle_plain(y32[0], y32[1], d32, p32),
                   radix_bound_ms("middle", V, A, B, C, A, A),
                   lambda: middle_chain(yc, dflat)[0], torch.stack(want64).view(2, V, A, B, C),
                   lambda z: rel(planes(z), torch.stack(want64).view(2, V, A, B, C)))
        # B-7 with the path's first two diagonals (those of K and C^-1): the
        # middle of `fused_circulant_apply_cropped_dual` (no solver calls it)
        (la, dA), (lb, dB) = list(weights.items())[:2]
        want64 = radix_fft.middle_dual_plain(y[0], y[1], dA.double(), dB.double(), p64)
        dAf, dBf = (flat(dA), flat(dB)) if timed else (None, None)
        record("middle_dual", f"dA = {la}, dB = {lb}",
               radix_fft.middle_dual(y32[0], y32[1], dA, dB, p32),
               radix_fft.middle_dual_plain(y32[0], y32[1], dA, dB, p32), want64,
               lambda: radix_fft.middle_dual(y32[0], y32[1], dA, dB, p32),
               lambda: radix_fft.middle_dual_plain(y32[0], y32[1], dA, dB, p32),
               radix_bound_ms("middle_dual", V, A, B, C, A, A),
               lambda: middle_chain(yc, dAf, dBf), None,
               lambda z: max(rel(planes(z[0]), torch.stack(want64[:2]).view(2, V, A, B, C)),
                             rel(planes(z[1]), torch.stack(want64[2:]).view(2, V, A, B, C))))
        if timed:
            dual = lambda: radix_fft.middle_dual(y32[0], y32[1], dA, dB, p32)
            two = lambda: (radix_fft.middle(y32[0], y32[1], dA, p32),
                           radix_fft.middle(y32[0], y32[1], dB, p32))
            for how, timer in (("events", cuda_ms), ("graph", graph_ms)):
                d1, w1 = timer(torch, dual), timer(torch, two)
                w2, d2 = timer(torch, two), timer(torch, dual)
                log(f"[kernels-1d] middle_dual {tag} ({how}): one B-7 launch "
                    f"{0.5 * (d1 + d2):.4f} ms ({d1:.4f}, {d2:.4f}) against two B-4 "
                    f"launches {0.5 * (w1 + w2):.4f} ms ({w1:.4f}, {w2:.4f}), in turns")
        # radix_middle_wgrad (B-4's weight cotangent) on the B-2 forwards of
        # x from the crop's rows and of g uncropped, as the apply's backward
        # hands them over (the R^T's on the planes path; the dK term's has
        # x uncropped too); at the headline with the training step's 128
        # planes (a batch of 256 rows)
        Vw = 128 if timed else V
        xs, gs = rnd(2, Vw, rows, N), rnd(2, Vw, A, N)
        w64 = [t.view(Vw, A, B, C) for t in
               radix_fft.stage1_plain(xs[0], xs[1], *radix_fft._s1_tables(p64, rows, A, False))
               + radix_fft.stage1_plain(gs[0], gs[1], *radix_fft._s1_tables(p64, A, A, False))]
        del xs, gs
        w32 = [t.float().contiguous() for t in w64]
        want64 = radix_fft.middle_wgrad_plain(*w64, p64)
        del w64
        if timed:
            # the torch.fft yardstick: fft(T1 y) of both sides over each
            # plane's B*C points, the product and the sum over v, in the
            # plane's natural order kb + B kc
            xc, gc = (torch.complex(a, b).view(Vw, A, N) for a, b in (w32[:2], w32[2:]))

            def wgrad_chain():
                X, G = fft.fft(t1 * xc, dim=-1), fft.fft(t1 * gc, dim=-1)
                return torch.sum(X.real * G.real + X.imag * G.imag, dim=0)

            wgrad_err = lambda z: rel(z.view(A, C, B).permute(0, 2, 1), want64)
        else:
            wgrad_chain = wgrad_err = None
        record("middle_wgrad", f"V = {Vw}, x from {rows} rows, g from {A}",
               (radix_fft.middle_wgrad(*w32, p32),),
               (radix_fft.middle_wgrad_plain(*w32, p32),), (want64,),
               lambda: radix_fft.middle_wgrad(*w32, p32),
               lambda: radix_fft.middle_wgrad_plain(*w32, p32),
               radix_bound_ms("middle_wgrad", Vw, A, B, C, A, A),
               wgrad_chain, None, wgrad_err)
        del w32, want64
        if timed:
            del xc, gc
            # the weight cotangent's resources: ptxas's registers and spills
            # of each instance (from this run's build), the dynamic shared
            # memory a CTA and the clusters resident at once
            smem, clusters = radix_fft.wgrad_kernel_info(B)
            res = ptxas_resources(_build.LOGS.get("radix", ""), "middle_wgrad_kernel")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            log(f"[kernels-1d] middle_wgrad_kernel resources: ptxas (registers, spill "
                f"stores, spill loads) by B {res or 'not in this run (library cached)'}; "
                f"{smem} bytes of dynamic shared memory a CTA at B = {B}; clusters of "
                f"{radix_fft.WGRAD_CLUSTER} CTAs, {clusters} resident at once "
                f"(cudaOccupancyMaxActiveClusters); {radix_fft.wgrad_splits(Vw, A, sms)} "
                f"split(s) a ka at V = {Vw}, A = {A} on {sms} SMs")
            radix_backward_check(torch, dev, p32, p64, rows, V)
        if not planes:   # the generic path launches no stage1_inv_dot
            continue
        # B-3 inverse A -> rows with the self-dots (every PCG apply's last stage)
        u = rnd(2, V, rows, N)
        u32 = u.float()
        wr, wi = radix_fft._s1_tables(p32, A, rows, True)
        wr64, wi64 = radix_fft._s1_tables(p64, A, rows, True)
        got = radix_fft.stage1_inv_dot(z32[0], z32[1], u32[0], u32[1], p32, rows)
        want32 = radix_fft.stage1_inv_dot_plain(z32[0], z32[1], u32[0], u32[1], wr, wi)
        want64 = radix_fft.stage1_inv_dot_plain(z[0], z[1], u[0], u[1], wr64, wi64)
        torch.cuda.synchronize()
        # each dot sums rows * B*C products of random sign: hold its error to
        # the scale of the terms
        scale = torch.sqrt(torch.sum((u[0] * want64[0]) ** 2, dim=(1, 2)))
        dot_err = max(float(torch.max((got[k].double() - want64[k]).abs() / scale))
                      for k in (2, 3))
        check(dot_err <= 1e-5, f"stage1_inv_dot {tag} dots err {dot_err:.3e} of the "
              f"terms' scale")
        log(f"[kernels-1d] stage1_inv_dot {tag} dots: err {dot_err:.3e} of the terms' "
            f"scale vs plain f64")
        def b3_chain():   # ifft + slice + the two self-dots
            yc3 = fft.ifft(zc, dim=1, norm="forward")[:, :rows]
            return (yc3, torch.sum(u32[0] * yc3.real, dim=(1, 2)),
                    torch.sum(u32[1] * yc3.imag, dim=(1, 2)))

        def b3_err(out):
            yc3, dr, di = out
            e = rel(torch.stack([yc3.real, yc3.imag]), torch.stack(want64[:2]))
            for k, dk in ((2, dr), (3, di)):
                e = max(e, float(torch.max((dk.double() - want64[k]).abs() / scale)))
            return e

        record("stage1_inv_dot", f"inverse {A} -> {rows} rows with self-dots",
               got[:2], want32[:2], want64[:2],
               lambda: radix_fft.stage1_inv_dot(z32[0], z32[1], u32[0], u32[1], p32, rows),
               lambda: radix_fft.stage1_inv_dot_plain(z32[0], z32[1], u32[0], u32[1],
                                                      wr, wi),
               radix_bound_ms("stage1_inv_dot", V, A, B, C, A, rows), b3_chain, None,
               b3_err)
    log(f"[kernels-1d] done; {time.perf_counter() - t0:.2f} s")
    return results


def phase_main_1d(torch):
    """The section 5.2 driver at each size, with the launch counts checked;
    returns the launches summed over the sizes."""
    import tempfile

    from hipgp_tpu_torch.experiments import run_pcg_vs_cholesky
    from hipgp_tpu_torch.ops import radix_fft, solve
    from hipgp_tpu_torch.ops.bttb import BTTBSpectrum, embedded_dims

    t0 = time.perf_counter()
    reps, warmup = 3, 3     # chain_time: one first call + warmup + reps solves
    calls = 1 + warmup + reps
    total = dict.fromkeys(radix_fft.LAUNCHES, 0)
    k = PCG_ITERS
    with tempfile.TemporaryDirectory() as tmp:
        for M in SIZES_1D:
            radix_fft.reset_launches()
            solve.PCG_STATS.update(solves=0, iterations=0)
            out = run_pcg_vs_cholesky.main([
                "--sizes", str(M), "--kernels", "Mat52", "--reps", str(reps),
                "--maxiter-cg", str(k), "--output-dir", f"{tmp}/{M}"])
            torch.cuda.synchronize()
            lc, st = dict(radix_fft.LAUNCHES), dict(solve.PCG_STATS)
            row = out["Mat52"][0]
            L = embedded_dims((M,))[0]
            shape_only = BTTBSpectrum(column=None, eigs=None, dims=(M,), edims=(L,))
            planes = solve._planes_solver_ok(shape_only, torch.float32, "cuda")
            chol = (f"; Cholesky {row['cholesky_sec'] * 1e3:.3f} ms"
                    if math.isfinite(row["cholesky_sec"]) else "")
            log(f"[main-1d] M={M} (L={L}, {'planes PCG' if planes else 'generic PCG'}"
                f"): {row['pcg_fft_sec'] * 1e3:.3f} ms per solve{chol}; "
                f"{st['solves']} fused solves, {st['iterations']} iterations; "
                f"launches {lc}")
            check(math.isfinite(row["pcg_fft_sec"]) and row["pcg_fft_sec"] > 0,
                  f"M={M} solve time")
            if planes:
                check(st["solves"] == calls and st["iterations"] == k * calls,
                      f"M={M}: {st} fused solves, expected {calls} of {k} iterations")
                want = {"middle": (2 * k + 2) * calls,
                        "stage1_inv_dot": (2 * k + 1) * calls,
                        "stage1": (2 * k + 3) * calls, "middle_dual": 0, "middle_wgrad": 0}
            else:   # generic PCG: 2k+1 operator applies and one R^T, uncropped
                want = {"middle": (2 * k + 2) * calls, "stage1_inv_dot": 0,
                        "stage1": 2 * (2 * k + 2) * calls, "middle_dual": 0,
                        "middle_wgrad": 0}
            check(lc == want, f"M={M} launches {lc}, expected {want}")
            for name in total:
                total[name] += lc[name]
    log(f"[main-1d] launches over the sizes {total}; {time.perf_counter() - t0:.2f} s")
    return total


@contextlib.contextmanager
def plain_radix_stages(radix_fft):
    """Route the radix applies through the plain versions of the three
    stages and of the weight cotangent, on whatever device their tensors
    are (the reference of [accuracy-1d] and of the apply's backward;
    nothing is launched or counted meanwhile)."""
    saved = (radix_fft.stage1, radix_fft.stage1_inv_dot, radix_fft.middle,
             radix_fft.middle_wgrad)

    def stage1(xr, xi, plan, out_rows, inverse):
        tables = radix_fft._s1_tables(plan, xr.shape[1], out_rows, inverse)
        return radix_fft.stage1_plain(xr, xi, *tables)

    def stage1_inv_dot(zr, zi, ur, ui, plan, out_rows):
        tables = radix_fft._s1_tables(plan, zr.shape[1], out_rows, True)
        return radix_fft.stage1_inv_dot_plain(zr, zi, ur, ui, *tables)

    radix_fft.stage1, radix_fft.stage1_inv_dot = stage1, stage1_inv_dot
    radix_fft.middle, radix_fft.middle_wgrad = radix_fft.middle_plain, radix_fft.middle_wgrad_plain
    try:
        yield
    finally:
        (radix_fft.stage1, radix_fft.stage1_inv_dot, radix_fft.middle,
         radix_fft.middle_wgrad) = saved


def phase_accuracy_1d(torch, dev):
    """At every size of [main-1d], the f32 kernel-path gram_solve (batch 8,
    20 iterations, protocol parameters) against the same f32 path with the
    plain stages (limit 1e-4) and against the f64 plain path: pcg_scan over
    torch.fft, then matmul_by_RT (limit 5e-3)."""
    import numpy as np

    from hipgp_tpu_torch.ops import radix_fft, solve

    t0 = time.perf_counter()
    for M in SIZES_1D:
        b = np.random.default_rng(0).standard_normal((8, M))
        out = {}
        for key, dt in (("kernel", torch.float32), ("plain32", torch.float32),
                        ("plain64", torch.float64)):
            spec = protocol_spectrum_1d(M, dt, dev)
            rhs = torch.as_tensor(b, dtype=dt, device=dev)
            before = dict(radix_fft.LAUNCHES)
            run = lambda: solve.gram_solve(spec, rhs, maxiter=PCG_ITERS, tol=0.0,
                                           fixed_iters=True)
            if key == "plain32":
                with plain_radix_stages(radix_fft):
                    out[key] = run()
            else:
                out[key] = run()
            torch.cuda.synchronize()
            moved = radix_fft.LAUNCHES["middle"] - before["middle"]
            check(moved == (2 * PCG_ITERS + 2 if key == "kernel" else 0),
                  f"M={M} {key} gram_solve launched middle {moved} times")
        k32 = out["kernel"]
        check(k32.shape == out["plain64"].shape == (8, spec.Mprime),
              f"M={M} gram_solve shape {tuple(k32.shape)}")
        check(bool(torch.isfinite(k32).all()), f"M={M} non-finite f32 gram_solve")
        err32, err64 = rel(k32, out["plain32"]), rel(k32, out["plain64"])
        log(f"[accuracy-1d] gram_solve M={M}, batch 8, {PCG_ITERS} iterations: f32 "
            f"kernel path vs f32 plain stages rel err {err32:.3e}, vs f64 plain "
            f"path {err64:.3e}")
        check(err32 <= 1e-4, f"M={M} 1-D gram_solve rel err vs f32 plain {err32}")
        check(err64 <= 5e-3, f"M={M} 1-D gram_solve rel err vs f64 plain {err64}")
    log(f"[accuracy-1d] done; {time.perf_counter() - t0:.2f} s")


def wp_bound_ms(B, W, i, L, o, selfdot):
    """Least time for kernel B-5's work: kernel A's rule (sandwich_bound_ms)
    over the B*W planes, with the W weight planes read once.  Returns
    (ms, 'operations' | 'bytes')."""
    (i0, i1), (L0, L1), (o0, o1) = i, L, o
    half = L1 // 2 + 1
    ops = (i0 * _fft_ops(L1, True) + 2 * half * _fft_ops(L0, False)
           + 2 * L0 * half + o0 * _fft_ops(L1, True))
    ops = B * W * (ops + (2 * o0 * o1 if selfdot else 0))
    nbytes = 4 * (B * W * (i0 * i1 + o0 * o1) + W * L0 * L1 + (B if selfdot else 0))
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def wp3_bound_ms(B, dims, edims, selfdot):
    """Least time for the whole cropped 3-D sandwich (kernel B-6): the FFT
    formulation pruned to the data, per sample a real FFT along the minor
    axis of the d0*d1 input rows, complex FFTs along the middle axis of the
    d0 * (L2/2 + 1) columns that hold data and along the outer axis of all
    L1 * (L2/2 + 1), the scale, the same back, and the self-dot; against x
    and w read once and y written once.  Returns (ms, 'operations' | 'bytes',
    the operations' ms, the bytes' ms)."""
    (d0, d1, d2), (W, L1, L2) = dims, edims
    half = L2 // 2 + 1
    one_way = (d0 * d1 * _fft_ops(L2, True) + d0 * half * _fft_ops(L1, False)
               + L1 * half * _fft_ops(W, False))
    ops = B * (2 * one_way + 2 * W * L1 * half + (2 * d0 * d1 * d2 if selfdot else 0))
    nbytes = 4 * (2 * B * d0 * d1 * d2 + W * L1 * L2 + (B if selfdot else 0))
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            1e3 * t_ops, 1e3 * t_bytes)


def fft_chain(torch, x, w, edims, dims_out):
    """The port's torch.fft formulation of the same sandwich (the library
    yardstick): rfftn of the zero-padded trailing axes, times the real
    half-spectrum, irfftn, crop."""
    nd = len(edims)
    axes = tuple(range(-nd, 0))
    half = w[..., : edims[-1] // 2 + 1]
    y = torch.fft.irfftn(torch.fft.rfftn(x, s=edims, dim=axes) * half, s=edims, dim=axes)
    return y[(Ellipsis,) + tuple(slice(0, d) for d in dims_out)]


def domain_setup(torch, dev, ell, dtype, problem=None):
    """The main-3d protocol's data (or ``problem``'s: `domain_problem`'s
    keywords), model, init state and spectrum at ``ell`` (sig2 by the
    empirical init, as run_domain does)."""
    from hipgp_tpu_torch.experiments import run_domain

    prob = run_domain.domain_problem(**(problem or DOMAIN))
    sig2 = run_domain.empirical_sig2_init(prob["xobs"], prob["aobs"])
    model = run_domain.domain_model("SqExp", prob["grids"], len(prob["xobs"]), sig2,
                                    ell, dtype=dtype, device=dev)
    state = model.init_state()
    return prob, model, state, model.spectrum(state)


def wp_backward_check(torch, dev, mxu2d, w, inner, einner, gen, B=512):
    """B-5's backward at the R^T's crop (cropped in, expanded out), B
    samples: gx (B-5 with the crops swapped, one launch) and gw (the
    per-plane analysis product summed over b, plain PyTorch in full FP32)
    against the plain sandwich's autograd in f32 and in f64, limit 1e-5
    each; the backward's time beside the forward's."""
    W = w.shape[0]
    x = torch.randn((B, W) + tuple(inner), generator=gen, device=dev)
    g = torch.randn((B, W) + tuple(einner), generator=gen, device=dev)

    def kernel_grads():
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = mxu2d.sandwich_apply_wp(xx, ww, inner, einner, out_expanded=True)
        return torch.autograd.grad(torch.sum(y * g), (xx, ww))

    def plain_grads(dt):
        t = mxu2d._tables(inner, einner, False, True, dt, dev)
        xx, ww = x.to(dt, copy=True).requires_grad_(), w.to(dt, copy=True).requires_grad_()
        y = mxu2d.sandwich_wp_plain(xx, ww, *t[:4])
        return torch.autograd.grad(torch.sum(y * g.to(dt)), (xx, ww))

    before = mxu2d.LAUNCHES["sandwich_apply_wp"]
    got = kernel_grads()
    torch.cuda.synchronize()
    n = mxu2d.LAUNCHES["sandwich_apply_wp"] - before
    check(n == 2, f"B-5 forward + backward launched {n} times, expected 2")
    errs = []
    for dt in (torch.float32, torch.float64):
        want = plain_grads(dt)
        errs.append([rel(a, b) for a, b in zip(got, want)])
        del want
    ms_kernel = cuda_ms(torch, kernel_grads, warmup=1, reps=5)
    ms_plain = cuda_ms(torch, lambda: plain_grads(torch.float32), warmup=1, reps=5)
    log(f"[kernels-3d] B-5's backward at the R^T ({B}, {W}) + {tuple(inner)} -> "
        f"{tuple(einner)}: rel err gx {errs[0][0]:.3e} (vs f64 {errs[1][0]:.3e}), gw "
        f"{errs[0][1]:.3e} (vs f64 {errs[1][1]:.3e}); forward + backward {ms_kernel:.4f} ms "
        f"(B-5 twice, gw in PyTorch), the plain sandwich's autograd {ms_plain:.4f} ms")
    check(all(e <= 1e-5 for row in errs for e in row), f"B-5 backward rel errs {errs}")


def phase_kernels_3d(torch, dev):
    """B-5 against its plain version (f32 and f64) at every shape the 3-D path
    gives it, B-6 at the self-dot shape; dots, determinism, times, bounds and
    the torch.fft-chain yardstick; B-6 against the B-5 pipeline.  Returns the
    per-kernel records of the kernels line (launches filled in later)."""
    from hipgp_tpu_torch.ops import bttb, mxu2d, mxu3d, solve

    t0 = time.perf_counter()
    _, _, _, spec = domain_setup(torch, dev, DOMAIN_ELL, torch.float32)
    _, _, pdims, pedims, wK = solve._mxu3d_permuted(
        spec, bttb._full_weights(spec.eigs, spec.edims[-1]))
    check((pdims, pedims) == ((32, 64, 64), (64, 128, 128)),
          f"main-path kernel order {pdims} -> {pedims}")
    W, inner, einner = pedims[0], pdims[1:], pedims[1:]
    gen = torch.Generator(device=dev).manual_seed(3)
    results = {}

    def compare(name, label, got, want32, want64, selfdot):
        torch.cuda.synchronize()
        y, y32, y64 = (got[0], want32[0], want64[0]) if selfdot else (got, want32, want64)
        check(y.shape == y32.shape and y.dtype == torch.float32,
              f"{name} ({label}) shape {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), f"{name} ({label}) non-finite output")
        err32, err64 = rel(y, y32), rel(y, y64)
        abs_err = float((y - y32).abs().max())
        msg = (f"rel err vs plain f32 {err32:.3e} (max abs {abs_err:.3e}), vs plain "
               f"f64 {err64:.3e}")
        check(err32 <= 1e-5 and err64 <= 1e-5, f"{name} ({label}) {msg}")
        if selfdot:
            d32, d64 = rel(got[1], want32[1]), rel(got[1], want64[1])
            msg += f"; dots vs plain f32 {d32:.3e}, vs f64 {d64:.3e}"
            check(d32 <= 1e-5 and d64 <= 1e-5, f"{name} ({label}) dots {msg}")
        return msg, abs_err

    def same_again(name, label, got, call):
        again = call()
        torch.cuda.synchronize()
        pairs = zip(got, again) if isinstance(got, tuple) else [(got, again)]
        check(all(torch.equal(a, b) for a, b in pairs),
              f"{name} ({label}): a second identical call is not bit-equal")

    def b5_case(B, w, crop, label, inner, einner):
        """B-5 at one shape: against its plain version in f32 and f64, a
        second call bit-equal, timed beside the plain version, the torch.fft
        chain and the bound.  Returns its record."""
        W = w.shape[0]
        selfdot, in_exp, out_exp = crop == "selfdot", crop == "in", crop == "out"
        t32 = mxu2d._tables(inner, einner, in_exp, out_exp, torch.float32, dev)
        t64 = mxu2d._tables(inner, einner, in_exp, out_exp, torch.float64, dev)
        x = torch.randn((B, W) + t32[4], generator=gen, device=dev)
        call = lambda: mxu2d.sandwich_apply_wp(x, w, inner, einner, in_expanded=in_exp,
                                               out_expanded=out_exp, selfdot=selfdot)
        got = call()
        want32 = mxu2d.sandwich_wp_plain(x, w, *t32[:4], selfdot=selfdot)
        want64 = mxu2d.sandwich_wp_plain(x.double(), w.double(), *t64[:4],
                                         selfdot=selfdot)
        msg, abs_err = compare("B-5", label, got, want32, want64, selfdot)
        same_again("B-5", label, got, call)
        y64 = want64[0] if selfdot else want64
        del want32, want64
        route = mxu2d._wp_route(t32[4], einner, t32[5])[0]
        bound = wp_bound_ms(B, W, t32[4], einner, t32[5], selfdot)
        plain = lambda: mxu2d.sandwich_wp_plain(x, w, *t32[:4], selfdot=selfdot)
        k1, p1 = cuda_ms(torch, call), cuda_ms(torch, plain, warmup=1, reps=5)
        p2, k2 = cuda_ms(torch, plain, warmup=1, reps=5), cuda_ms(torch, call)
        ms, plain_ms = 0.5 * (k1 + k2), 0.5 * (p1 + p2)
        o_shape = t32[5]
        lib = lambda: fft_chain(torch, x, w, einner, o_shape)
        lib_err = rel(lib(), y64)
        # the fft chain drops w's odd part, which 1/wK weighs most (the f32
        # spectrum is even only to rounding): there it is a yardstick of time,
        # not of the function
        if "1/wK" not in label:
            check(lib_err <= 1e-4, f"B-5 torch.fft chain rel err {lib_err:.3e}")
        del y64
        lib_ms = cuda_ms(torch, lib, warmup=1, reps=5)
        msg += (f"; route {route}; kernel {ms:.4f} ms ({k1:.4f}, {k2:.4f}), plain "
                f"{plain_ms:.4f} ms ({p1:.4f}, {p2:.4f}), in turns; torch.fft chain "
                f"{lib_ms:.4f} ms (rel err vs f64 {lib_err:.3e}, no self-dot); bound "
                f"{bound[0]:.4f} ms ({bound[1]}; pruned FFT count), kernel at "
                f"{100 * bound[0] / ms:.1f} % of it")
        log(f"[kernels-3d] B-5 ({B}, {W}) + {t32[4]} -> {t32[5]} {label}: {msg}")
        return route, dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms)

    # ---- B-5 at the PCG self-dot, R^T, prediction-chunk and pullback shapes --
    sq = torch.sqrt(wK).contiguous()
    cases = [(512, wK, "selfdot", "PCG self-dot apply, w = wK"),
             (512, (1.0 / wK).contiguous(), "selfdot", "PCG self-dot apply, w = 1/wK"),
             (512, sq, "out", "R^T, w = sqrt(wK)"),
             (400, wK, "selfdot", "prediction-chunk self-dot apply"),
             (400, sq, "out", "prediction-chunk R^T"),
             (512, sq, "in", "R^T pullback (expanded in), w = sqrt(wK)")]
    for B, w, crop, label in cases:
        route, r = b5_case(B, w, crop, label, inner, einner)
        if label == "PCG self-dot apply, w = wK":
            check(route == "resident", f"B-5 self-dot route {route}")
            results["B-5"] = r
        if crop == "in":   # the R^T's pullback: the launch of B-5's backward
            results["B-5 backward"] = r

    # ---- [accuracy-full-batch-3d]'s shapes: the 32 x 32 x 16 grid embeds at
    # (64, 64, 30), which B-6's gate does not take, so its PCG applies go
    # through the outer products and B-5 with 30 weight planes
    _, _, _, spec_a = domain_setup(torch, dev, DOMAIN_ELL, torch.float32, FB3_ACC)
    _, _, adims, aedims, wKa = solve._mxu3d_permuted(
        spec_a, bttb._full_weights(spec_a.eigs, spec_a.edims[-1]))
    on_b6 = mxu3d._wp3_ok(adims, aedims, torch.float32)
    log(f"[kernels-3d] [accuracy-full-batch-3d]'s grid {spec_a.dims} -> {spec_a.edims}, "
        f"kernel order {adims} -> {aedims}: B-6's gate {on_b6}")
    check(not on_b6, f"B-6 takes {aedims}: [accuracy-full-batch-3d] expects the B-5 route")
    for B, w, crop, label in ((512, wKa, "selfdot", "(30 planes) PCG self-dot apply, w = wK"),
                              (512, (1.0 / wKa).contiguous(), "selfdot",
                               "(30 planes) PCG self-dot apply, w = 1/wK"),
                              (512, torch.sqrt(wKa).contiguous(), "out",
                               "(30 planes) R^T, w = sqrt(wK)")):
        b5_case(B, w, crop, label, adims[1:], aedims[1:])
    del wKa, spec_a

    # ---- B-5's backward at the R^T's shapes ---------------------------------
    wp_backward_check(torch, dev, mxu2d, sq, inner, einner, gen)

    # ---- B-5 on planes above one block: expanded (512, 512), W = 3 --------
    # (kernel A's three passes with a plane index; the dense kernel refused
    # an expanded input above an axis of 432)
    grids = [torch.linspace(-1.0, 1.0, 256, device=dev)] * 2
    s512 = bttb.make_spectrum(grids, lambda a, b: torch.exp(
        -0.5 * torch.sum(((a[:, None, :] - b[None, :, :]) / 0.05) ** 2, -1)), jitter=1e-3)
    w1 = bttb._full_weights(s512.eigs, s512.edims[-1])
    w3 = torch.stack([w1, torch.sqrt(w1), 1.0 / w1]).contiguous()
    big = tuple(s512.edims)
    check(big == (512, 512), f"(256, 256) embeds at {big}")
    x = torch.randn((2, 3) + big, generator=gen, device=dev)
    call = lambda: mxu2d.sandwich_apply_wp(x, w3, (256, 256), big, in_expanded=True,
                                           out_expanded=True)
    got = call()
    t32 = mxu2d._tables((256, 256), big, True, True, torch.float32, dev)
    t64 = mxu2d._tables((256, 256), big, True, True, torch.float64, dev)
    msg, _ = compare("B-5", "(512, 512) expanded, W = 3", got,
                     mxu2d.sandwich_wp_plain(x, w3, *t32[:4]),
                     mxu2d.sandwich_wp_plain(x.double(), w3.double(), *t64[:4]), False)
    same_again("B-5", "(512, 512) expanded, W = 3", got, call)
    route = mxu2d._wp_route(big, big, big)[0]
    check(route == "three-pass", f"B-5 expanded (512, 512) route {route}")
    log(f"[kernels-3d] B-5 (2, 3) + {big} -> {big} expanded in and out: {msg}; route "
        f"{route}; kernel {cuda_ms(torch, call, warmup=1, reps=5):.4f} ms")
    del x, got, w3

    # ---- B-6 at the self-dot shape ----------------------------------------
    label = "PCG self-dot apply, w = wK"
    x = torch.randn((512,) + pdims, generator=gen, device=dev)
    call = lambda: mxu3d.sandwich_apply_wp3(x, wK, pdims, pedims, selfdot=True)
    got = call()
    want32 = mxu3d.sandwich_wp3_plain(x, wK, pdims, pedims, selfdot=True)
    want64 = mxu3d.sandwich_wp3_plain(x.double(), wK.double(), pdims, pedims,
                                      selfdot=True)
    msg, abs_err = compare("B-6", label, got, want32, want64, True)
    same_again("B-6", label, got, call)
    del want32
    ms = cuda_ms(torch, call)
    plain_ms = cuda_ms(torch, lambda: mxu3d.sandwich_wp3_plain(x, wK, pdims, pedims,
                                                               selfdot=True),
                       warmup=1, reps=5)
    lib = lambda: fft_chain(torch, x, wK, pedims, pdims)
    lib_err = rel(lib(), want64[0])
    check(lib_err <= 1e-4, f"B-6 torch.fft chain rel err {lib_err:.3e}")
    del want64
    lib_ms = cuda_ms(torch, lib, warmup=1, reps=5)
    bound = wp3_bound_ms(512, pdims, pedims, True)
    # the same function through the outer products and kernel B-5, in turns
    # (pipeline, B-6, B-6, pipeline)
    saved = mxu3d.USE_WP3
    mxu3d.USE_WP3 = False
    pipe = lambda: mxu3d.sandwich_apply_3d_selfdot(x, wK, pdims, pedims)
    try:
        pipe_before = cuda_ms(torch, pipe)
        wp3_a, wp3_b = cuda_ms(torch, call), cuda_ms(torch, call)
        pipe_after = cuda_ms(torch, pipe)
    finally:
        mxu3d.USE_WP3 = saved
    pipe_ms, wp3_ms = 0.5 * (pipe_before + pipe_after), 0.5 * (wp3_a + wp3_b)
    clusters = mxu3d._wp3_clusters(pdims, pedims, x.device)
    log(f"[kernels-3d] B-6 (512,) + {pdims} through {pedims} {label}: {msg}; a second "
        f"call bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.fft chain "
        f"{lib_ms:.4f} ms (rel err vs f64 {lib_err:.3e}, no self-dot), bound "
        f"{bound[0]:.4f} ms ({bound[1]}; operations {bound[2]:.4f} ms by the pruned FFT "
        f"count, bytes {bound[3]:.4f} ms), kernel at {100 * bound[0] / ms:.1f} % of it; "
        f"clusters of {mxu3d.WP3_CLUSTER} CTAs, {clusters} active at once "
        f"(cudaOccupancyMaxActiveClusters), the persistent grid {min(512, clusters)} "
        f"clusters")
    log(f"[kernels-3d] the whole self-dot apply: B-6 {wp3_ms:.4f} ms ({wp3_a:.4f}, "
        f"{wp3_b:.4f}) against the B-5 pipeline (outer matmul + B-5 + outer matmul) "
        f"{pipe_ms:.4f} ms ({pipe_before:.4f}, {pipe_after:.4f}), in turns; USE_WP3 = "
        f"{mxu3d.USE_WP3}")
    results["B-6"] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms)
    log(f"[kernels-3d] done; {time.perf_counter() - t0:.2f} s")
    return results


def phase_main_3d(torch):
    """run_domain (section 5.5) at the main-path settings, with the counts
    zeroed just before and read just after; returns the launches."""
    import tempfile

    from hipgp_tpu_torch.experiments import run_domain
    from hipgp_tpu_torch.ops import mxu2d, mxu3d, solve

    t0 = time.perf_counter()
    argv = ["--nx", str(DOMAIN["nx"]), "--nz", str(DOMAIN["nz"]), "--ell", str(DOMAIN_ELL),
            "--nobs", str(DOMAIN["nobs"]), "--ntest", str(DOMAIN["ntest"]),
            "--noise-std", str(DOMAIN["noise_std"]), "--batch-size", str(DOMAIN_BATCH),
            "--maxiter-cg", "20", "--lr", "1e-2", "--epochs", "1",
            "--fit-method", "natgrad"]
    log(f"[main-3d] run_domain {' '.join(argv)} (cut from the section 14d protocol: "
        f"--nobs 10240 from 100 000, --ntest 1000 from 2 000, one epoch)")
    with tempfile.TemporaryDirectory() as tmp:
        mxu2d.reset_launches()
        mxu3d.reset_launches()
        solve.PCG_STATS.update(solves=0, iterations=0)
        out = run_domain.main(argv + ["--output-dir", tmp])
        torch.cuda.synchronize()
        lc = {**mxu2d.LAUNCHES, **mxu3d.LAUNCHES}
        st = dict(solve.PCG_STATS)
    wall = time.perf_counter() - t0
    steps = out["steps"]
    log(f"[main-3d] {steps} natgrad steps at {out['step_ms']:.1f} ms/step (host clock "
        f"over the epoch, ending in a sync); warm start {out['warmstart_s']:.2f} s; "
        f"rho {out['natgrad_rho']:.2f}, lr used {out['lr_used']:.4g}; ELBO "
        f"{out['first_elbo']:.4f} -> {out['last_elbo']:.4f}; predict "
        f"{out['predict_s']:.2f} s; e post-RMSE {out['e_post_rmse']:.5f} vs rms(e_test) "
        f"{out['e_rms']:.5f}; latent RMSE {out['latent_rmse']:.5f}, slice corr "
        f"{out['latent_corr']:.4f}")
    check(steps == DOMAIN["nobs"] // DOMAIN_BATCH, f"{steps} steps")
    check(math.isfinite(out["first_elbo"]) and math.isfinite(out["last_elbo"]),
          "non-finite ELBO")
    rho = out["natgrad_rho"]
    check(rho is not None and math.isfinite(rho) and rho > 1, f"rho {rho}")
    check(abs(out["lr_used"] - min(1e-2, 1.0 / rho)) <= 1e-9 * out["lr_used"],
          f"lr used {out['lr_used']} is not min(1e-2, 1/rho)")
    check(math.isfinite(out["e_post_rmse"]) and out["e_post_rmse"] < out["e_rms"],
          f"e post-RMSE {out['e_post_rmse']} not below rms(e_test) {out['e_rms']}")
    chunks = -(-DOMAIN["ntest"] // DOMAIN_BATCH) + -(-400 // DOMAIN_BATCH)
    check(st["solves"] == 2 * steps + 1 + chunks,
          f"{st['solves']} solves: expected a warm-start batch, a step and a "
          f"prediction chunk each, and the rho estimate")
    applies = st["solves"] + 2 * st["iterations"]
    use_wp3 = mxu3d.USE_WP3
    want = {"sandwich_apply_wp_selfdot": 0 if use_wp3 else applies,
            "sandwich_apply_wp3": applies if use_wp3 else 0,
            "sandwich_apply_wp": st["solves"],
            "sandwich_apply": 0, "sandwich_apply_selfdot": 0}
    log(f"[main-3d] {st['solves']} PCG solves, {st['iterations']} iterations -> "
        f"expect {applies} self-dot applies through {'B-6' if use_wp3 else 'B-5'} and "
        f"{st['solves']} R^T launches of B-5; counted {lc}; {wall:.2f} s")
    check(lc == want, f"3-D launches {lc}, expected {want}")
    return lc


@contextlib.contextmanager
def plain_3d_stages(mxu2d, mxu3d):
    """Route the 3-D applies through the plain versions of B-5 and B-6, on
    whatever device their tensors are (the reference of [accuracy-3d];
    nothing is launched or counted meanwhile)."""
    saved = mxu3d.sandwich_apply_wp, mxu3d.sandwich_apply_wp3

    def wp(x, w, dims, edims, *, in_expanded=False, out_expanded=False, selfdot=False):
        t = mxu2d._tables(dims, edims, in_expanded, out_expanded, x.dtype, x.device)
        return mxu2d.sandwich_wp_plain(x, w, *t[:4], selfdot=selfdot)

    def wp3(x, w, dims, edims, selfdot=False):
        return mxu3d.sandwich_wp3_plain(x, w, dims, edims, selfdot=selfdot)

    mxu3d.sandwich_apply_wp, mxu3d.sandwich_apply_wp3 = wp, wp3
    try:
        yield
    finally:
        mxu3d.sandwich_apply_wp, mxu3d.sandwich_apply_wp3 = saved


def phase_accuracy_3d(torch, dev):
    """64 rows of the main path's integrated Knm, 20 iterations: the f32
    kernel-path whiten against the f32 path with the plain stages (limit
    1e-4) and the f64 plain path (limit 5e-3 at ell 0.07; logged at 0.2)."""
    from hipgp_tpu_torch.ops import mxu2d, mxu3d, solve

    t0 = time.perf_counter()
    k = 20
    for ell in (DOMAIN_ELL, 0.2):
        out = {}
        for key, dt in (("kernel", torch.float32), ("plain32", torch.float32),
                        ("plain64", torch.float64)):
            prob, model, state, spec = domain_setup(torch, dev, ell, dt)
            x = torch.as_tensor(prob["xobs"][:64], dtype=dt, device=dev)
            knm, _ = model.make_grams(state, x, integrated_obs=True)
            before = {**mxu2d.LAUNCHES, **mxu3d.LAUNCHES}
            run = lambda: solve.whiten(spec, knm, maxiter=k, tol=0.0, fixed_iters=True)
            if key == "plain32":
                with plain_3d_stages(mxu2d, mxu3d):
                    out[key] = run()
            else:
                out[key] = run()
            torch.cuda.synchronize()
            after = {**mxu2d.LAUNCHES, **mxu3d.LAUNCHES}
            moved = {n: after[n] - before[n] for n in after if after[n] != before[n]}
            applies = "sandwich_apply_wp3" if mxu3d.USE_WP3 else "sandwich_apply_wp_selfdot"
            want = ({applies: 2 * k + 1, "sandwich_apply_wp": 1} if key == "kernel" else {})
            check(moved == want, f"ell {ell} {key} whiten launched {moved}, expected {want}")
        k32 = out["kernel"]
        check(k32.shape == out["plain64"].shape == (64, spec.Mprime),
              f"whiten shape {tuple(k32.shape)}")
        check(bool(torch.isfinite(k32).all()), f"ell {ell}: non-finite f32 whiten")
        err32, err64 = rel(k32, out["plain32"]), rel(k32, out["plain64"])
        log(f"[accuracy-3d] whiten {model.dims}, ell {ell}, 64 integrated rows, {k} "
            f"iterations: f32 kernel path vs f32 plain stages rel err {err32:.3e}, vs f64 "
            f"plain path {err64:.3e}" + ("" if ell == DOMAIN_ELL else
                                         " (logged, not limited: the f32 spectrum's "
                                         "floor dominates it)"))
        check(err32 <= 1e-4, f"ell {ell} 3-D whiten rel err vs f32 plain {err32}")
        if ell == DOMAIN_ELL:
            check(err64 <= 5e-3, f"ell {ell} 3-D whiten rel err vs f64 plain {err64}")
        del out, k32
    log(f"[accuracy-3d] done; {time.perf_counter() - t0:.2f} s")


def phase_full_batch_3d(torch):
    """run_domain's paper-scale full-batch fit, 'matfree', at [main-3d]'s
    settings (the 64 x 64 x 32 grid, ell 0.07, batch 512, maxiter_cg 20, the
    cut of 10 240 observations and 1 000 test stars), the mean PCG at the
    driver's defaults (200 iterations, tol 1e-8 relative); the counts zeroed
    just before and read just after: the sweep's and the prediction's PCG
    solves make 1 + 2k B-6 self-dot applies and one B-5 R^T each, the mean
    PCG (float64, the einsum chain) launches nothing.  Peak memory under
    FB3_PEAK_LIMIT.  Returns the launches and the fit's (qm, ELBO, sweep
    seconds), which [full-batch-3d-block] holds the block family to."""
    import tempfile

    import numpy as np

    from hipgp_tpu_torch.experiments import run_domain
    from hipgp_tpu_torch.infer import FitConfig
    from hipgp_tpu_torch.ops import mxu2d, mxu3d, solve

    t0 = time.perf_counter()
    argv = ["--nx", str(DOMAIN["nx"]), "--nz", str(DOMAIN["nz"]), "--ell", str(DOMAIN_ELL),
            "--nobs", str(DOMAIN["nobs"]), "--ntest", str(DOMAIN["ntest"]),
            "--noise-std", str(DOMAIN["noise_std"]), "--batch-size", str(DOMAIN_BATCH),
            "--maxiter-cg", "20", "--fit-method", "full-batch", "--mean-solver", "matfree",
            "--mean-solver-maxiter", str(FB3_MEAN["mean_solver_maxiter"]),
            "--mean-solver-tol", str(FB3_MEAN["mean_solver_tol"])]
    log(f"[full-batch-3d] run_domain {' '.join(argv)} (cut from the section 14 "
        f"protocol: --nobs 10240 from 100 000, --ntest 1000 from 2 000)")
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        mxu2d.reset_launches()
        mxu3d.reset_launches()
        solve.PCG_STATS.update(solves=0, iterations=0)
        out = run_domain.main(argv + ["--output-dir", tmp])
        torch.cuda.synchronize()
        lc = {**mxu2d.LAUNCHES, **mxu3d.LAUNCHES}
        st = dict(solve.PCG_STATS)
        peak = torch.cuda.max_memory_allocated()
        saved = np.load(f"{tmp}/state.npz")   # theta1, theta2, ... in field order
        qm = torch.as_tensor(-0.5 / saved["arr_1"] * saved["arr_0"])   # on the host
    wall = time.perf_counter() - t0
    its = out["mean_pcg_iterations"]
    log(f"[full-batch-3d] matfree fit {out['fit_s']:.2f} s: sweep {out['fit_sweep_s']:.3f} "
        f"s, mean stage {out['fit_mean_s']:.3f} s ({its} iterations, "
        f"{out['fit_mean_s'] / max(its, 1):.4f} s an iteration, ||r||/||b_m|| "
        f"{out['mean_pcg_relres']:.3e}, tol {FB3_MEAN['mean_solver_tol']:g}), ELBO stage "
        f"{out['fit_elbo_s']:.3f} s; peak torch.cuda.max_memory_allocated over the fit "
        f"{out['fit_peak_gb']:.3f} GB, over fit and predict {peak / 1e9:.3f} GB "
        f"({base / 1e9:.3f} GB allocated before); ELBO {out['last_elbo']:.6f}; predict "
        f"{out['predict_s']:.2f} s; e post-RMSE {out['e_post_rmse']:.5f} vs rms(e_test) "
        f"{out['e_rms']:.5f}; latent RMSE {out['latent_rmse']:.5f}, slice corr "
        f"{out['latent_corr']:.4f}")
    check(math.isfinite(out["last_elbo"]), f"non-finite ELBO {out['last_elbo']}")
    check(math.isfinite(out["e_post_rmse"]) and out["e_post_rmse"] < out["e_rms"],
          f"e post-RMSE {out['e_post_rmse']} not below rms(e_test) {out['e_rms']}")
    check(peak < FB3_PEAK_LIMIT, f"peak {peak / 1e9:.3f} GB")
    check(0 < its <= FB3_MEAN["mean_solver_maxiter"], f"{its} mean iterations")
    sweep = -(-DOMAIN["nobs"] // DOMAIN_BATCH)
    chunks = -(-DOMAIN["ntest"] // DOMAIN_BATCH) + -(-400 // DOMAIN_BATCH)
    check(st["solves"] == sweep + chunks,
          f"{st['solves']} solves: expected {sweep} sweep batches and {chunks} "
          f"prediction chunks")
    # the sweep's solves stop by maxiter_cg 20, the prediction's by its 50
    check(st["iterations"] <= 20 * sweep + FitConfig().predict_maxiter_cg * chunks,
          f"{st['iterations']} iterations: a solve exceeded its maxiter")
    applies = st["solves"] + 2 * st["iterations"]
    use_wp3 = mxu3d.USE_WP3
    want = {"sandwich_apply_wp_selfdot": 0 if use_wp3 else applies,
            "sandwich_apply_wp3": applies if use_wp3 else 0,
            "sandwich_apply_wp": st["solves"],
            "sandwich_apply": 0, "sandwich_apply_selfdot": 0}
    log(f"[full-batch-3d] {st['solves']} PCG solves, {st['iterations']} iterations -> "
        f"expect {applies} self-dot applies through {'B-6' if use_wp3 else 'B-5'} and "
        f"{st['solves']} R^T launches of B-5; counted {lc}; {wall:.2f} s")
    check(lc == want, f"3-D full-batch launches {lc}, expected {want}")
    return lc, dict(qm=qm, elbo=out["last_elbo"], sweep_s=out["fit_sweep_s"])


FB3_ACC_SOLVE = dict(batch_size=DOMAIN_BATCH, maxiter_cg=200, integrated_obs=True,
                     mean_solver_maxiter=3000, mean_solver_tol=1e-10, compute_elbo=True)


def phase_accuracy_full_batch_3d(torch, dev):
    """'matfree' on the 32 x 32 x 16 grid (FB3_ACC), ell 0.07, 2 048 line
    integrals, the whitening converged (maxiter_cg 200) and the mean PCGs
    run out: float32 'matfree' on the kernel path against float32 'gram'
    from the same state (theta2 <= 1e-6, the same sweep; theta1 <= 5e-3,
    ELBO <= 1e-4 relative) and against float64 'matfree' on the plain path
    (theta1 <= 5e-3, ELBO <= 1e-4)."""
    from hipgp_tpu_torch.models.hipgp import MEAN_PCG_STATS
    from hipgp_tpu_torch.ops import mxu2d, mxu3d, solve

    t0 = time.perf_counter()
    res = {}
    for key, dt, solver in (("f32 matfree", torch.float32, "matfree"),
                            ("f32 gram", torch.float32, "gram"),
                            ("f64 matfree", torch.float64, "matfree")):
        prob, model, state, _ = domain_setup(torch, dev, DOMAIN_ELL, dt, FB3_ACC)
        mxu2d.reset_launches()
        mxu3d.reset_launches()
        solve.PCG_STATS.update(solves=0, iterations=0)
        timings = {}
        torch.cuda.reset_peak_memory_stats()
        new, elbo = model.batch_solve(state, prob["xobs"], prob["aobs"], prob["sobs"],
                                      mean_solver=solver, timings=timings, **FB3_ACC_SOLVE)
        torch.cuda.synchronize()
        lc = {k: v for k, v in {**mxu2d.LAUNCHES, **mxu3d.LAUNCHES}.items() if v}
        st, ms = dict(solve.PCG_STATS), dict(MEAN_PCG_STATS)
        res[key] = (new, float(elbo))
        log(f"[accuracy-full-batch-3d] {key}: grid {model.dims} -> {model.edims}, "
            f"{len(prob['xobs'])} rows; {_stages(timings)}; peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; ELBO {float(elbo):.8f}; "
            f"launches {lc}")
        _log_mean_pcg("accuracy-full-batch-3d", f"{key}", ms,
                      FB3_ACC_SOLVE["mean_solver_maxiter"], FB3_ACC_SOLVE["mean_solver_tol"])
        check(math.isfinite(float(elbo)), f"{key}: ELBO {float(elbo)}")
        if dt == torch.float32:
            applies = st["solves"] + 2 * st["iterations"]
            want = {"sandwich_apply_wp_selfdot": applies, "sandwich_apply_wp": st["solves"]}
            check(lc == want, f"{key}: launches {lc}, expected {want}")
        else:
            check(not lc, f"{key}: the float64 path launched {lc}")
        del model, new
    (m32, e32), (g32, eg), (m64, e64) = (res["f32 matfree"], res["f32 gram"],
                                        res["f64 matfree"])
    dev_g = [rel(m32.theta2, g32.theta2), rel(m32.theta1, g32.theta1), abs(e32 - eg) / abs(eg)]
    dev_64 = [rel(m32.theta1, m64.theta1), abs(e32 - e64) / abs(e64),
              rel(m32.theta2, m64.theta2)]
    log(f"[accuracy-full-batch-3d] f32 matfree vs f32 gram: theta2 rel {dev_g[0]:.3e} "
        f"(limit 1e-6), theta1 rel {dev_g[1]:.3e} (limit 5e-3), ELBO rel {dev_g[2]:.3e} "
        f"(limit 1e-4); f32 matfree (kernel path) vs f64 matfree (plain path): theta1 rel "
        f"{dev_64[0]:.3e} (limit 5e-3), ELBO rel {dev_64[1]:.3e} (limit 1e-4), theta2 rel "
        f"{dev_64[2]:.3e}; {time.perf_counter() - t0:.2f} s")
    check(dev_g[0] <= 1e-6, f"theta2 matfree vs gram {dev_g[0]}")
    check(dev_g[1] <= 5e-3, f"theta1 matfree vs gram {dev_g[1]}")
    check(dev_g[2] <= 1e-4, f"ELBO matfree vs gram {dev_g[2]}")
    check(dev_64[0] <= 5e-3, f"theta1 f32 vs f64 {dev_64[0]}")
    check(dev_64[1] <= 1e-4, f"ELBO f32 vs f64 {dev_64[1]}")


HYPERS = ("log_sig2", "log_ell", "log_noise2")
TRAIN_K = 10   # maxiter_cg of the protocol


def _hypers(torch, state):
    """(sig2, ell, noise2) of a state, as floats."""
    return tuple(float(torch.exp(getattr(state, k))) for k in HYPERS)


def phase_train(torch, d, model, state0, main_step_ms):
    """The flagship training step: one epoch of the 2-D protocol with
    learn_kernel and learn_noise (Adam at kernel_lr 1e-3 on the three
    log-hyperparameters beside natgrad on theta), from the theta2 warm start,
    through svigp_fit, then batch_predict; the counters zeroed just before
    and read just after.  Returns (state, kernel A launches)."""
    import numpy as np

    from hipgp_tpu_torch.infer import FitConfig, batch_predict, svigp_fit
    from hipgp_tpu_torch.ops import mxu2d, pallas_transform, solve

    t0 = time.perf_counter()
    cfg = FitConfig(epochs=1, batch_size=256, lr=1e-2, maxiter_cg=TRAIN_K,
                    learn_kernel=True, learn_noise=True)
    mxu2d.reset_launches()
    pallas_transform.reset_launches()
    solve.PCG_STATS.update(solves=0, iterations=0)
    state, report = svigp_fit(model, state0, d["xobs"], d["yobs"], d["sobs"], cfg,
                              verbose=False, theta2_warmstart=True)
    torch.cuda.synchronize()
    lc, st = dict(mxu2d.LAUNCHES), dict(solve.PCG_STATS)
    b8 = pallas_transform.LAUNCHES["circulant_apply_2d"]
    steps = report["steps"]
    nb = -(-len(d["xobs"]) // cfg.batch_size)
    step_ms = 1e3 * report["epoch_times"][0] / steps
    trace = np.asarray(report["elbo_trace"])
    before, after = _hypers(torch, state0), _hypers(torch, state)
    log(f"[train] {steps} training steps (natgrad + Adam on the hypers, gradients "
        f"through the whitening) at {step_ms:.2f} ms/step against the forward-only "
        f"step's {main_step_ms:.2f} ms ([main]); warm start {report['warmstart_s']:.2f} s")
    log(f"[train] (sig2, ell, noise2) {before} -> {after}")
    log(f"[train] ELBO first {trace[0]:.4f}, last {trace[-1]:.4f}; mean of first 10 "
        f"{trace[:10].mean():.4f}, of last 10 {trace[-10:].mean():.4f}")
    check(steps == nb == 79, f"{steps} steps of {nb} batches, expected 79")
    check(bool(np.isfinite(trace).all()), "non-finite training ELBO")
    check(trace[-10:].mean() > trace[:10].mean(), "the training ELBO did not rise")
    check(all(math.isfinite(v) for v in after), f"non-finite hypers {after}")
    check(all(a != b for a, b in zip(after, before)), f"hypers did not move: {after}")
    # warm start (one whitening per batch) and the rho estimate (one) run
    # forward only; every step solves twice (K^{-1} Knm and, in the
    # backward, K^{-1} of the cotangent) and launches R^T and its pullback
    want_solves = nb + 1 + 2 * steps
    check(st["solves"] == want_solves, f"{st['solves']} solves, expected {want_solves}")
    check(st["iterations"] == TRAIN_K * st["solves"],
          f"{st['iterations']} iterations: every solve should run {TRAIN_K}")
    want = {"sandwich_apply_selfdot": st["solves"] * (1 + 2 * TRAIN_K),
            "sandwich_apply": nb + 1 + 2 * steps,
            "sandwich_apply_wp": 0, "sandwich_apply_wp_selfdot": 0}
    log(f"[train] {st['solves']} PCG solves, {st['iterations']} iterations; per step "
        f"{2 * (1 + 2 * TRAIN_K)} self-dot launches, one R^T and one pullback; expect "
        f"{want}, counted {lc}; B-8 launches {b8} (USE_PALLAS_TRANSFORM gates it)")
    check(lc == want, f"training launches {lc}, expected {want}")
    t1 = time.perf_counter()
    mu, sig = batch_predict(model, state, d["xtest"], batch_size=4096,
                            maxiter_cg=cfg.predict_maxiter_cg)
    mu, sig = mu.cpu().numpy(), sig.cpu().numpy()
    rmse = float(np.sqrt(np.mean((mu - d["ftest"]) ** 2)))
    fstd = float(np.std(d["ftest"]))
    check(bool(np.isfinite(mu).all() and np.isfinite(sig).all()), "non-finite prediction")
    check(rmse < fstd, f"trained test RMSE {rmse} not below std(ftest) {fstd}")
    log(f"[train] predict: test RMSE {rmse:.5f} vs std(ftest) {fstd:.5f} "
        f"({time.perf_counter() - t1:.2f} s); {time.perf_counter() - t0:.2f} s")
    return state, lc


def phase_train_grad(torch, dev, d, model, model64, state):
    """One batch from one state: the f32 kernel-path hyper-gradients against
    the f64 plain path (limit 1e-2 relative each), then with
    USE_PALLAS_TRANSFORM on (B-8 launches counted, gradients within 1e-4 of
    the flag-off run).  Returns the B-8 launches of the flag-on step."""
    from hipgp_tpu_torch.infer.fit import prepare_batches
    from hipgp_tpu_torch.ops import bttb, mxu2d, pallas_transform, solve

    t0 = time.perf_counter()
    out = {}
    for key, m, dt in (("kernel", model, torch.float32), ("b8", model, torch.float32),
                       ("plain64", model64, torch.float64)):
        as_t = lambda a: torch.as_tensor(a).to(dtype=dt, device=dev)
        xb, yb, _, wb = prepare_batches(as_t(d["xobs"]), as_t(d["yobs"]), None, 256)
        st = state.__class__(**{f: getattr(state, f).to(dt) for f in
                                ("theta1", "theta2") + HYPERS})
        saved = bttb.USE_PALLAS_TRANSFORM
        bttb.USE_PALLAS_TRANSFORM = key == "b8"
        mxu2d.reset_launches()
        pallas_transform.reset_launches()
        solve.PCG_STATS.update(solves=0, iterations=0)
        try:
            elbo, g = m.elbo_and_grads(st, xb[0], yb[0], None, maxiter_cg=TRAIN_K,
                                       weights=wb[0], compute_hyper_grads=True)
        finally:
            bttb.USE_PALLAS_TRANSFORM = saved
        torch.cuda.synchronize()
        lc = {**mxu2d.LAUNCHES, **pallas_transform.LAUNCHES}
        out[key] = (float(elbo), [float(getattr(g, k)) for k in HYPERS])
        log(f"[train-grad] {key}: ELBO {out[key][0]:.6f}, -d elbo / d (log_sig2, "
            f"log_ell, log_noise2) = {out[key][1]}; launches "
            f"{ {n: v for n, v in lc.items() if v} }, PCG {dict(solve.PCG_STATS)}")
        fused = {"sandwich_apply_selfdot": 2 * (1 + 2 * TRAIN_K), "sandwich_apply": 2}
        want = {"kernel": fused, "b8": {**fused, "circulant_apply_2d": 1},
                "plain64": {}}[key]
        check({n: v for n, v in lc.items() if v} == want,
              f"[train-grad] {key} launches {lc}, expected {want}")
        if key == "b8":
            b8_launches = lc["circulant_apply_2d"]
    for key, limit in (("plain64", 1e-2), ("b8", 1e-4)):
        errs = [abs(a - b) / abs(b) for a, b in zip(out["kernel"][1], out[key][1])]
        log(f"[train-grad] f32 kernel path vs {key}: rel err per hyper-gradient "
            f"{[f'{e:.3e}' for e in errs]} (limit {limit:g})")
        check(all(math.isfinite(e) and e <= limit for e in errs),
              f"hyper-gradients vs {key}: {errs}")
    log(f"[train-grad] done; {time.perf_counter() - t0:.2f} s")
    return b8_launches


TRAIN_1D = dict(M=HEADLINE_M, nobs=5120, noise_std=0.1, batch=256, steps=10)
TRAIN_3D_STEPS = 10
TRAIN_GRAD_1D_ROWS = 32
TRAIN_LONG_K = 20   # maxiter_cg of the 1-D and 3-D training phases


def radix_train_launches(st, forward_only, steps):
    """The radix launches of ``forward_only`` whitenings without a gradient
    and ``steps`` learn-kernel steps, with st = PCG_STATS over them (solves
    = forward_only + 2 steps): every solve's 1 + 2k self-dot applies are a
    B-2 forward, a B-4 and a B-3 each; every R^T a B-2 forward, a B-4 and
    a B-2 inverse; a step adds the R^T's backward (gx: B-2, B-4, B-2; gd:
    two B-2 forwards and radix_middle_wgrad) and the dK term (the apply
    forward, B-2, B-4, B-2, and its gd, two B-2 forwards and
    radix_middle_wgrad)."""
    applies = st["solves"] + 2 * st["iterations"]
    return {"stage1": applies + 2 * forward_only + 10 * steps,
            "stage1_inv_dot": applies,
            "middle": applies + forward_only + 3 * steps,
            "middle_dual": 0, "middle_wgrad": 2 * steps}


def wp_train_launches(st, forward_only, steps, use_wp3):
    """The 3-D launches of ``forward_only`` whitenings and ``steps``
    learn-kernel steps (st = PCG_STATS): every solve's 1 + 2k self-dot
    applies through B-6 (or B-5 with USE_WP3 off), every R^T a B-5 launch,
    every step's R^T backward one more (gx; gw is PyTorch, the dK term the
    einsum chain)."""
    applies = st["solves"] + 2 * st["iterations"]
    return {"sandwich_apply_wp3": applies if use_wp3 else 0,
            "sandwich_apply_wp_selfdot": 0 if use_wp3 else applies,
            "sandwich_apply_wp": forward_only + 2 * steps,
            "sandwich_apply": 0, "sandwich_apply_selfdot": 0}


def train_1d_setup(torch, dev, dtype):
    """[train-1d]'s model and data (`profile_train_1d.train_1d_problem`):
    HIPGP mean-field on the section 5.2 operator at M = 2^20 (Matern-5/2,
    sig2 0.1, ell one grid spacing on [0, 1], jitter 1e-3, as
    protocol_spectrum_1d builds it), learning its hyperparameters; 5 120
    observations of make_one_dim_function(seed=0) taken on [-1, 1] and
    rescaled onto [0, 1], plus noise 0.1, drawn from seed 42."""
    from hipgp_tpu_torch.experiments.profile_train_1d import train_1d_problem

    return train_1d_problem(TRAIN_1D["M"], TRAIN_1D["nobs"], TRAIN_1D["noise_std"],
                            dtype=dtype, device=dev)


def phase_train_1d(torch, dev):
    """The 1-D long axis learning its hyperparameters: the theta2 warm start,
    then TRAIN_1D['steps'] svigp_fit steps at batch 256 and maxiter_cg 20
    with learn_kernel and learn_noise (kernel_lr 1e-3), gradients through the
    planes PCG, the R^T's and the dK term's radix backward; the counters
    zeroed just before and read just after, checked exactly.  Returns
    (model, state, launches)."""
    import numpy as np

    from hipgp_tpu_torch.infer import FitConfig, svigp_fit
    from hipgp_tpu_torch.ops import radix_fft, solve

    t0 = time.perf_counter()
    model, x, y = train_1d_setup(torch, dev, torch.float32)
    state0 = model.init_state()
    spec = model.spectrum(state0)
    check(solve._planes_solver_ok(spec, torch.float32, dev),
          "[train-1d] the model's solve is not the planes path")
    del spec
    steps, bsz = TRAIN_1D["steps"], TRAIN_1D["batch"]
    cfg = FitConfig(epochs=1, batch_size=bsz, lr=1e-2, maxiter_cg=TRAIN_LONG_K,
                    learn_kernel=True, learn_noise=True, kernel_lr=1e-3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    radix_fft.reset_launches()
    solve.PCG_STATS.update(solves=0, iterations=0)
    state, report = svigp_fit(model, state0, x, y, None, cfg, verbose=False,
                              theta2_warmstart=True, max_steps=steps)
    torch.cuda.synchronize()
    lc, st = dict(radix_fft.LAUNCHES), dict(solve.PCG_STATS)
    peak = torch.cuda.max_memory_allocated()
    nb = -(-TRAIN_1D["nobs"] // bsz)
    step_ms = 1e3 * report["epoch_times"][0] / report["steps"]
    trace = np.asarray(report["elbo_trace"])
    before, after = _hypers(torch, state0), _hypers(torch, state)
    log(f"[train-1d] M = {model.M} (L = {model.Mprime}), {TRAIN_1D['nobs']} observations, "
        f"{report['steps']} steps at batch {bsz}, maxiter_cg {TRAIN_LONG_K}: "
        f"{step_ms:.2f} ms/step (host clock over the steps, ending in a sync); warm "
        f"start {report['warmstart_s']:.2f} s; peak torch.cuda.max_memory_allocated "
        f"{peak / 1e9:.3f} GB")
    log(f"[train-1d] (sig2, ell, noise2) {before} -> {after}")
    log(f"[train-1d] ELBO trace {[round(float(e), 4) for e in trace]}")
    check(report["steps"] == steps, f"[train-1d] {report['steps']} steps")
    check(bool(np.isfinite(trace).all()), "[train-1d] non-finite ELBO")
    check(all(math.isfinite(v) for v in after), f"[train-1d] non-finite hypers {after}")
    check(all(a != b for a, b in zip(after, before)), f"[train-1d] hypers did not move")
    # the warm start (one whitening per batch) and the rho estimate (one) run
    # forward only; every step solves twice
    check(st["solves"] == nb + 1 + 2 * steps, f"[train-1d] {st['solves']} solves")
    want = radix_train_launches(st, nb + 1, steps)
    log(f"[train-1d] {st['solves']} PCG solves ({nb} warm-start batches, the rho "
        f"estimate, 2 per step), {st['iterations']} iterations; launches expected "
        f"{want} = per solve 1 + 2k applies (a B-2 forward, a B-4 and a B-3 each), per "
        f"whitening an R^T (B-2, B-4, B-2), per step the R^T's backward (gx: B-2, B-4, "
        f"B-2; gd: 2 B-2 and radix_middle_wgrad) and the dK term (B-2, B-4, B-2 and its "
        f"gd: 2 B-2 and radix_middle_wgrad); counted {lc}; "
        f"{time.perf_counter() - t0:.2f} s")
    check(lc == want, f"[train-1d] launches {lc}, expected {want}")
    return model, state, lc


def _grad_run(torch, model, st, x, y, integrated, tag, counters, reset):
    """One elbo_and_grads with compute_hyper_grads at TRAIN_LONG_K
    iterations: (elbo, [-d elbo / d hypers], launches, PCG_STATS)."""
    from hipgp_tpu_torch.ops import solve

    reset()
    solve.PCG_STATS.update(solves=0, iterations=0)
    elbo, g = model.elbo_and_grads(st, x, y, None, maxiter_cg=TRAIN_LONG_K,
                                   integrated_obs=integrated, compute_hyper_grads=True)
    torch.cuda.synchronize()
    lc = {k: v for c in counters for k, v in c.items()}
    out = (float(elbo), [float(getattr(g, k)) for k in HYPERS], lc, dict(solve.PCG_STATS))
    log(f"[{tag}] ELBO {out[0]:.6f}, -d elbo / d (log_sig2, log_ell, log_noise2) = "
        f"{out[1]}; launches { {k: v for k, v in lc.items() if v} }, PCG {out[3]}")
    return out


def _compare_grads(tag, out):
    """The f32 kernel path's hyper-gradients against the f64 plain path
    (limit 1e-2 relative each) and, logged, against the f32 plain path."""
    for key, limit in (("plain64", 1e-2), ("plain32", None)):
        errs = [abs(a - b) / abs(b) for a, b in zip(out["kernel"][1], out[key][1])]
        log(f"[{tag}] f32 kernel path vs {key}: rel err per hyper-gradient "
            f"{[f'{e:.3e}' for e in errs]}" + (f" (limit {limit:g})" if limit else
                                                " (logged)"))
        if limit:
            check(all(math.isfinite(e) and e <= limit for e in errs),
                  f"[{tag}] hyper-gradients vs {key}: {errs}")


def _state_as(state, dtype):
    return state.__class__(**{f: getattr(state, f).to(dtype) for f in
                              ("theta1", "theta2") + HYPERS})


def phase_train_grad_1d(torch, dev, state):
    """One batch of TRAIN_GRAD_1D_ROWS rows at M = 2^20 from [train-1d]'s
    state: the f32 kernel-path hyper-gradients against the f64 plain path on
    the card (limit 1e-2 relative each), and the f32 plain path
    (USE_RADIX_FFT off) logged; the kernel path's launches exact."""
    from hipgp_tpu_torch.ops import bttb, radix_fft

    t0 = time.perf_counter()
    out = {}
    for key, dt, flag in (("kernel", torch.float32, True), ("plain32", torch.float32, False),
                          ("plain64", torch.float64, False)):
        model, x, y = train_1d_setup(torch, dev, dt)
        n = TRAIN_GRAD_1D_ROWS
        as_t = lambda a: torch.as_tensor(a[:n], dtype=dt, device=dev)
        saved = bttb.USE_RADIX_FFT
        bttb.USE_RADIX_FFT = flag
        try:
            out[key] = _grad_run(torch, model, _state_as(state, dt), as_t(x), as_t(y),
                                 False, "train-grad-1d", (radix_fft.LAUNCHES,),
                                 radix_fft.reset_launches)
        finally:
            bttb.USE_RADIX_FFT = saved
        lc, st = out[key][2], out[key][3]
        want = (radix_train_launches(st, 0, 1) if key == "kernel"
                else dict.fromkeys(radix_fft.LAUNCHES, 0))
        check(lc == want, f"[train-grad-1d] {key} launches {lc}, expected {want}")
        del model
    _compare_grads("train-grad-1d", out)
    log(f"[train-grad-1d] done; {time.perf_counter() - t0:.2f} s")


def phase_train_3d(torch, dev):
    """The dust map learning its hyperparameters: [main-3d]'s model and data
    (64 x 64 x 32 grid, SqExp ell 0.07, the analytic semi-integrated
    estimator, 10 240 observations), the theta2 warm start, the clamped lr,
    then TRAIN_3D_STEPS svigp_fit steps at batch 512 and maxiter_cg 20 with
    learn_kernel and learn_noise (kernel_lr 1e-3); the counters zeroed just
    before and read just after, checked exactly.  Returns (state,
    launches)."""
    import numpy as np

    from hipgp_tpu_torch.infer import FitConfig, svigp_fit
    from hipgp_tpu_torch.ops import mxu2d, mxu3d, solve

    t0 = time.perf_counter()
    prob, model, state0, spec = domain_setup(torch, dev, DOMAIN_ELL, torch.float32)
    check(solve._mxu3d_solver_ok(spec, torch.float32, dev),
          "[train-3d] the model's solve is not the 3-D kernel path")
    del spec
    steps = TRAIN_3D_STEPS
    cfg = FitConfig(epochs=1, batch_size=DOMAIN_BATCH, lr=1e-2, maxiter_cg=TRAIN_LONG_K,
                    integrated_obs=True, semi_integrated_estimator="analytic",
                    learn_kernel=True, learn_noise=True, kernel_lr=1e-3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mxu2d.reset_launches()
    mxu3d.reset_launches()
    solve.PCG_STATS.update(solves=0, iterations=0)
    state, report = svigp_fit(model, state0, prob["xobs"], prob["aobs"], None, cfg,
                              verbose=False, theta2_warmstart=True,
                              natgrad_safe_lr="clamp", max_steps=steps)
    torch.cuda.synchronize()
    lc, st = {**mxu2d.LAUNCHES, **mxu3d.LAUNCHES}, dict(solve.PCG_STATS)
    peak = torch.cuda.max_memory_allocated()
    nb = -(-len(prob["xobs"]) // DOMAIN_BATCH)
    step_ms = 1e3 * report["epoch_times"][0] / report["steps"]
    trace = np.asarray(report["elbo_trace"])
    before, after = _hypers(torch, state0), _hypers(torch, state)
    log(f"[train-3d] grid {model.dims} -> {model.edims}, {len(prob['xobs'])} line "
        f"integrals, {report['steps']} steps at batch {DOMAIN_BATCH}, maxiter_cg "
        f"{TRAIN_LONG_K}, lr used {report['lr_used']:.4g}: {step_ms:.2f} ms/step (host "
        f"clock over the steps, ending in a sync) against [main-3d]'s natgrad step; warm "
        f"start {report['warmstart_s']:.2f} s; peak torch.cuda.max_memory_allocated "
        f"{peak / 1e9:.3f} GB")
    log(f"[train-3d] (sig2, ell, noise2) {before} -> {after}")
    log(f"[train-3d] ELBO trace {[round(float(e), 4) for e in trace]}")
    check(report["steps"] == steps, f"[train-3d] {report['steps']} steps")
    check(bool(np.isfinite(trace).all()), "[train-3d] non-finite ELBO")
    check(all(math.isfinite(v) for v in after), f"[train-3d] non-finite hypers {after}")
    check(all(a != b for a, b in zip(after, before)), "[train-3d] hypers did not move")
    check(st["solves"] == nb + 1 + 2 * steps, f"[train-3d] {st['solves']} solves")
    want = wp_train_launches(st, nb + 1, steps, mxu3d.USE_WP3)
    log(f"[train-3d] {st['solves']} PCG solves ({nb} warm-start batches, the rho "
        f"estimate, 2 per step), {st['iterations']} iterations; launches expected {want} "
        f"= per solve 1 + 2k self-dot applies through {'B-6' if mxu3d.USE_WP3 else 'B-5'}, "
        f"per whitening an R^T through B-5, per step its pullback (B-5's backward gx); "
        f"counted {lc}; {time.perf_counter() - t0:.2f} s")
    check(lc == want, f"[train-3d] launches {lc}, expected {want}")
    # B-5's launches beyond one R^T per whitening (solves less steps) are
    # its backward's, the pullbacks
    lc["B-5 backward"] = lc["sandwich_apply_wp"] - (st["solves"] - steps)
    return state, lc


def phase_train_grad_3d(torch, dev, state):
    """64 integrated rows of [main-3d]'s data from [train-3d]'s state, as
    [accuracy-3d] takes them: the f32 kernel-path hyper-gradients against the
    f64 plain path on the card (limit 1e-2 relative each), and the f32 plain
    path (USE_MXU3D_PCG off) logged; the kernel path's launches exact."""
    from hipgp_tpu_torch.ops import bttb, mxu2d, mxu3d

    t0 = time.perf_counter()
    out = {}
    reset = lambda: (mxu2d.reset_launches(), mxu3d.reset_launches())
    for key, dt, flag in (("kernel", torch.float32, True), ("plain32", torch.float32, False),
                          ("plain64", torch.float64, False)):
        prob, model, _, _ = domain_setup(torch, dev, DOMAIN_ELL, dt)
        as_t = lambda a: torch.as_tensor(a[:64], dtype=dt, device=dev)
        saved = bttb.USE_MXU3D_PCG
        bttb.USE_MXU3D_PCG = flag
        try:
            out[key] = _grad_run(torch, model, _state_as(state, dt), as_t(prob["xobs"]),
                                 as_t(prob["aobs"]), True, "train-grad-3d",
                                 (mxu2d.LAUNCHES, mxu3d.LAUNCHES), reset)
        finally:
            bttb.USE_MXU3D_PCG = saved
        lc, st = out[key][2], out[key][3]
        want = (wp_train_launches(st, 0, 1, mxu3d.USE_WP3) if key == "kernel"
                else dict.fromkeys(lc, 0))
        check(lc == want, f"[train-grad-3d] {key} launches {lc}, expected {want}")
        del model
    _compare_grads("train-grad-3d", out)
    log(f"[train-grad-3d] done; {time.perf_counter() - t0:.2f} s")


FB_SOLVE = dict(batch_size=-1, maxiter_cg=10, mean_solver_maxiter=200,
                mean_solver_tol=1e-8, compute_elbo=True)   # the JAX run_synthetic's settings
FB_PEAK_LIMIT = 40e9      # bytes: 'dense' holds its 62 500^2 matrix and factor
FB_ACC_GRID = 64          # [accuracy-full-batch]: inducing points per axis
FB_ACC_MEAN_MAXITER = 6000   # the K + A PCG to convergence (tol 1e-10)
FB_CONVERGED_MAXITER = 6000  # [full-batch]'s 'gram' once more, its mean PCG run out
FB_JAX_F32_JITTER = 1e-4   # [full-batch-factored]: the JAX package's float32 factor jitter
FB3_PEAK_LIMIT = 16e9        # bytes: [full-batch-3d]; 'gram''s A alone would be 68 GB
FB3_MEAN = dict(mean_solver_maxiter=200, mean_solver_tol=1e-8)   # run_domain's defaults


def _fb_launch_check(tag, lc, st, solves):
    """Kernel A's launches of one batch_solve: per whitening solve 1 + 2k
    self-dots (k from PCG_STATS) and one R^T, nothing else."""
    want = {"sandwich_apply_selfdot": st["solves"] + 2 * st["iterations"],
            "sandwich_apply": st["solves"], "sandwich_apply_wp": 0,
            "sandwich_apply_wp_selfdot": 0}
    log(f"[{tag}] {st['solves']} whitening solves, {st['iterations']} iterations -> "
        f"expect {want}; counted {lc}")
    check(st["solves"] == solves, f"{tag}: {st['solves']} whitening solves, expected "
          f"{solves}")
    check(lc == want, f"{tag}: kernel A launches {lc}, expected {want}")


def _stages(timings):
    return ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())


def _solve_counted(torch, counters, model, state, d, solver, **kw):
    """One batch_solve on [main]'s data with the launch counters and the
    stats zeroed just before and read just after, the warnings recorded.
    Returns (state, elbo, timings, launches, PCG_STATS, MEAN_PCG_STATS,
    FACTORED_STATS, peak bytes, warnings)."""
    import warnings

    from hipgp_tpu_torch.models.hipgp import FACTORED_STATS, MEAN_PCG_STATS
    from hipgp_tpu_torch.ops import solve

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    for c in counters:
        c.reset_launches()
    solve.PCG_STATS.update(solves=0, iterations=0)
    MEAN_PCG_STATS.update(iterations=0, resnorm=math.nan, bnorm=math.nan)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        new, elbo = model.batch_solve(state, d["xobs"], d["yobs"], d["sobs"],
                                      mean_solver=solver, timings=timings, **kw)
    torch.cuda.synchronize()
    lc = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    return (new, float(elbo), timings, lc, dict(solve.PCG_STATS), dict(MEAN_PCG_STATS),
            dict(FACTORED_STATS), torch.cuda.max_memory_allocated(),
            [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)])


def _log_mean_pcg(tag, label, ms, maxiter, tol):
    rule = "||r|| <= tol ||b_m||" if "matfree" in label else "||r|| <= tol"
    log(f"[{tag}] {label}: mean-stage PCG on K + A (float64, stops on {rule}) "
        f"{ms['iterations']} of {maxiter} iterations, final ||r|| {ms['resnorm']:.3e} "
        f"(tol {tol:g}), ||b_m|| {ms['bnorm']:.3e}, relative "
        f"{ms['resnorm'] / ms['bnorm']:.3e}")


def phase_full_batch(torch, d, model, state0):
    """The closed-form full-batch fit at M = 125^2 on [main]'s data: one batch
    of 20 000 rows, 'gram', 'dense' (the JAX run_synthetic's settings),
    'gram' once more with its mean PCG run to FB_CONVERGED_MAXITER
    iterations (not counted), 'factored' (kappa > 1e3 at this data: it warns
    and runs 'gram', which it must equal) and 'matfree' (theta2 as 'gram''s;
    its iterations and residual), each with the counters zeroed just before
    and read just after, then a prediction of the test points from each
    state.  Returns kernel A's launches of the 'gram' and 'dense' solves."""
    import numpy as np

    from hipgp_tpu_torch.infer import batch_predict
    from hipgp_tpu_torch.models.hipgp import FACTOR_CHUNK, FACTORED_F32_KAPPA_MAX
    from hipgp_tpu_torch.ops import mxu2d

    t_all = time.perf_counter()
    fstd = float(np.std(d["ftest"]))
    out, total = {}, {}
    runs = (("gram", FB_SOLVE), ("dense", FB_SOLVE),
            ("gram converged", {**FB_SOLVE, "mean_solver_maxiter": FB_CONVERGED_MAXITER}),
            ("factored", FB_SOLVE), ("matfree", FB_SOLVE))
    for solver, kw in runs:
        base = torch.cuda.memory_allocated()
        new, elbo, timings, lc, st, ms, fs, peak, warned = _solve_counted(
            torch, (mxu2d,), model, state0, d, solver.split()[0], **kw)
        if solver in ("gram", "dense"):
            for k, v in lc.items():
                total[k] = total.get(k, 0) + v
        t1 = time.perf_counter()
        mu, sig = batch_predict(model, new, d["xtest"], batch_size=4096,
                                maxiter_cg=50)
        mu, sig = mu.cpu().numpy(), sig.cpu().numpy()
        rmse = float(np.sqrt(np.mean((mu - d["ftest"]) ** 2)))
        log(f"[full-batch] {solver}: {_stages(timings)}; peak "
            f"torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB ({base / 1e9:.3f} GB "
            f"allocated before); ELBO {elbo:.6f}; test RMSE {rmse:.5f} vs std(ftest) "
            f"{fstd:.5f} (predict {time.perf_counter() - t1:.2f} s)")
        if solver != "dense":
            _log_mean_pcg("full-batch", solver, ms, kw["mean_solver_maxiter"],
                          kw["mean_solver_tol"])
        solves = 2 if solver == "dense" else 1
        if solver == "factored":
            fell_back = fs["kappa"] > FACTORED_F32_KAPPA_MAX
            log(f"[full-batch] factored: kappa of the spectrum {fs['kappa']:.4e} (trust "
                f"region {FACTORED_F32_KAPPA_MAX:g}); RuntimeWarnings {warned}")
            if fell_back:
                check(any("exactness check" in w for w in warned),
                      f"factored at kappa {fs['kappa']:.3e}: no fallback warning")
                check(set(timings) == {"sweep", "mean", "elbo"},
                      f"factored fell back at the pre-check, yet ran {sorted(timings)}")
            else:
                log("[full-batch] factored: kappa within the trust region here; held to "
                    "[full-batch-factored]'s checks")
                check(not warned, f"factored warned {warned}")
                solves = -(-model.M // FACTOR_CHUNK)
        _fb_launch_check("full-batch", lc, st, solves)
        check(math.isfinite(elbo), f"{solver}: non-finite ELBO {elbo}")
        check(bool(np.isfinite(mu).all() and np.isfinite(sig).all()),
              f"{solver}: non-finite prediction")
        check(rmse < fstd, f"{solver}: test RMSE {rmse} not below std(ftest) {fstd}")
        check(peak < FB_PEAK_LIMIT, f"{solver}: peak {peak / 1e9:.3f} GB")
        out[solver] = (new, elbo)
        del new
    (g, eg), (dn, _), (gc, _) = out["gram"], out["dense"], out["gram converged"]
    t2 = rel(g.theta2, dn.theta2)
    t1_ = rel(g.theta1, dn.theta1)
    t1c = rel(gc.theta1, dn.theta1)
    t1g = rel(g.theta1, gc.theta1)
    log(f"[full-batch] gram vs dense: theta2 rel {t2:.3e} (limit 1e-4; both sum "
        f"Lambda from the same whitening of the same rows, so this holds the two "
        f"accumulations to each other, not kernel A, which [kernels] holds at "
        f"B = 20 000); theta1 rel {t1_:.3e}, converged 'gram' vs dense {t1c:.3e}, "
        f"'gram' at {FB_SOLVE['mean_solver_maxiter']} iterations vs converged "
        f"{t1g:.3e} (not checked)")
    check(t2 <= 1e-4, f"theta2 gram vs dense {t2}")
    (f, ef), (mf, emf) = out["factored"], out["matfree"]
    if fell_back:
        dev_ = [rel(f.theta1, g.theta1), rel(f.theta2, g.theta2), abs(ef - eg) / abs(eg)]
        log(f"[full-batch] factored (fallen back) vs gram: theta1 rel {dev_[0]:.3e}, "
            f"theta2 rel {dev_[1]:.3e}, ELBO rel {dev_[2]:.3e} (limit 1e-6 each)")
        check(max(dev_) <= 1e-6, f"the fallback is not 'gram': {dev_}")
    mt2, mt1 = rel(mf.theta2, g.theta2), rel(mf.theta1, gc.theta1)
    log(f"[full-batch] matfree vs gram: theta2 rel {mt2:.3e} (limit 1e-4; the same "
        f"Lambda accumulation); theta1 vs 'gram converged' {mt1:.3e}, vs 'gram' "
        f"{rel(mf.theta1, g.theta1):.3e}; ELBO {emf:.6f} vs 'gram' {eg:.6f} (not "
        f"checked); {time.perf_counter() - t_all:.2f} s")
    check(mt2 <= 1e-4, f"theta2 matfree vs gram {mt2}")
    return total


FB_ACC_SOLVE = dict(batch_size=-1, maxiter_cg=200, mean_solver_maxiter=FB_ACC_MEAN_MAXITER,
                    mean_solver_tol=1e-10, compute_elbo=True)


def phase_accuracy_full_batch(torch, dev, d):
    """'gram' with ziggy whitening on a 64^2 grid, both converged (maxiter_cg
    200, mean_solver_tol 1e-10): the float32 kernel path against the float64
    plain path (theta1 <= 5e-3, ELBO <= 1e-4 relative); then one 'gram'
    solve with cholesky whitening (finite ELBO, RMSE below std(ftest)).
    Returns the float32 'gram' (state, ELBO)."""
    import numpy as np

    from hipgp_tpu_torch.experiments.harness import make_model
    from hipgp_tpu_torch.experiments.run_synthetic import build_model, marginal_sig2
    from hipgp_tpu_torch.infer import batch_predict
    from hipgp_tpu_torch.ops import mxu2d, solve

    t0 = time.perf_counter()
    sig2 = marginal_sig2(d["yobs"], d["sobs"])
    kw = dict(mean_solver="gram", **FB_ACC_SOLVE)
    res = {}
    for dt in (torch.float32, torch.float64):
        m = build_model("SqExp", FB_ACC_GRID, len(d["xobs"]), sig2, 0.05, 0.01,
                        dtype=dt, device=dev)
        mxu2d.reset_launches()
        solve.PCG_STATS.update(solves=0, iterations=0)
        timings = {}
        new, elbo = m.batch_solve(m.init_state(), d["xobs"], d["yobs"], d["sobs"],
                                  timings=timings, **kw)
        torch.cuda.synchronize()
        lc, st = dict(mxu2d.LAUNCHES), dict(solve.PCG_STATS)
        res[dt] = (new, float(elbo))
        log(f"[accuracy-full-batch] {dt}: ELBO {float(elbo):.8f}; sweep "
            f"{timings['sweep']:.3f} s, mean {timings['mean']:.3f} s; kernel A {lc}")
        if dt == torch.float32:
            _fb_launch_check("accuracy-full-batch", lc, st, 1)
        else:
            check(not any(lc.values()), f"the float64 path launched {lc}")
    (n32, e32), (n64, e64) = res[torch.float32], res[torch.float64]
    t1, t2 = rel(n32.theta1, n64.theta1), rel(n32.theta2, n64.theta2)
    de = abs(e32 - e64) / abs(e64)
    log(f"[accuracy-full-batch] 'gram' {FB_ACC_GRID}^2, f32 kernel path vs f64 plain "
        f"path: theta1 rel {t1:.3e} (limit 5e-3), theta2 rel {t2:.3e}, ELBO rel "
        f"{de:.3e} (limit 1e-4)")
    check(t1 <= 5e-3, f"theta1 f32 vs f64 {t1}")
    check(de <= 1e-4, f"ELBO f32 vs f64 {de}")
    mc = make_model("mean-field", "SqExp", [np.linspace(-1, 1, FB_ACC_GRID)] * 2,
                    len(d["xobs"]), sig2, 0.05, noise2_init=0.01 ** 2,
                    whitened_type="cholesky", dtype=torch.float32, device=dev)
    timings = {}
    new, elbo = mc.batch_solve(mc.init_state(), d["xobs"], d["yobs"], d["sobs"],
                               timings=timings, **FB_SOLVE, mean_solver="gram")
    mu, _ = batch_predict(mc, new, d["xtest"], batch_size=4096)
    rmse = float(np.sqrt(np.mean((mu.cpu().numpy() - d["ftest"]) ** 2)))
    fstd = float(np.std(d["ftest"]))
    log(f"[accuracy-full-batch] cholesky whitening, 'gram', {FB_ACC_GRID}^2 (M' = M): "
        f"ELBO {float(elbo):.6f}, test RMSE {rmse:.5f} vs std(ftest) {fstd:.5f}; "
        f"sweep {timings['sweep']:.3f} s, mean {timings['mean']:.3f} s; "
        f"{time.perf_counter() - t0:.2f} s")
    check(math.isfinite(float(elbo)), f"cholesky ELBO {float(elbo)}")
    check(rmse < fstd, f"cholesky test RMSE {rmse} not below std(ftest) {fstd}")
    return res[torch.float32]


def phase_full_batch_factored(torch, dev, d, gram_ref):
    """'factored' on [main]'s data at M = 64^2 (SqExp, ell 0.05, float32),
    inside the float32 trust region (kappa <= FACTORED_F32_KAPPA_MAX).
    First at FB_SOLVE's settings and an explicit factor_jitter of
    FB_JAX_F32_JITTER (1e-4 mean(diag A), the JAX package's float32 default):
    logged, and where it falls back, held to 'gram' on the same inputs.
    Then at FB_SOLVE's settings and the default jitter (keyed on the
    factor's dtype: 1e-10 for the float64 factor): no fallback warning (both
    guards pass), a finite ELBO, test RMSE below std(ftest), kernel-A
    launches exact against PCG_STATS (per g-stage solve of FACTOR_CHUNK
    factor rows, and per prediction chunk, 1 + 2k self-dots and one R^T; the
    sweep whitens nothing).  Then at [accuracy-full-batch]'s converged
    settings and the default jitter against its float32 'gram' ``gram_ref``:
    theta2 max-relative and the ELBO within 1e-2.  Returns kernel A's
    launches of the counted fit."""
    import numpy as np

    from hipgp_tpu_torch.infer import batch_predict
    from hipgp_tpu_torch.models.hipgp import FACTOR_CHUNK, FACTORED_F32_KAPPA_MAX
    from hipgp_tpu_torch.ops import mxu2d, solve

    t0 = time.perf_counter()
    m, st0, spec = factored_model(torch, dev, d)
    kappa = float(torch.max(spec.eigs) / torch.min(spec.eigs))
    log(f"[full-batch-factored] grid {spec.dims} -> {spec.edims}: kappa of the spectrum "
        f"{kappa:.4e} (trust region {FACTORED_F32_KAPPA_MAX:g})")
    check(kappa <= FACTORED_F32_KAPPA_MAX, f"kappa {kappa:.3e} outside the trust region")

    def checks_line(fs):
        return (f"jitter {fs['jitter']:.3e}; trace guard tr(K^-1 A) {fs['trKinvA']:.6e} vs "
                f"1.2 sum ivar Knn {1.2 * fs['sKnn']:.6e}; bracket {fs['bracket']:.6e} vs "
                f"-1e-3 sum ivar Knn {-1e-3 * fs['sKnn']:.6e}")

    # the JAX package's float32 jitter, 1e-4 mean(diag A): its shift enters
    # Lambda as eps diag(K^-1), which this spectrum's small eigenvalues make
    # large
    new, elbo, timings, _, _, _, fs, _, warned = _solve_counted(
        torch, (mxu2d,), m, st0, d, "factored", **FB_SOLVE, factor_jitter=FB_JAX_F32_JITTER)
    log(f"[full-batch-factored] factored at factor_jitter {FB_JAX_F32_JITTER:g} (JAX's "
        f"float32 default): {_stages(timings)}; ELBO {elbo:.6f}; {checks_line(fs)}; "
        f"RuntimeWarnings {warned}")
    if warned:
        check(all("exactness check" in w for w in warned), f"warnings {warned}")
        g, eg, *_ = _solve_counted(torch, (mxu2d,), m, st0, d, "gram", **FB_SOLVE)
        dev_ = [rel(new.theta1, g.theta1), rel(new.theta2, g.theta2), abs(elbo - eg) / abs(eg)]
        log(f"[full-batch-factored] it fell back: against 'gram' theta1 rel {dev_[0]:.3e}, "
            f"theta2 rel {dev_[1]:.3e}, ELBO rel {dev_[2]:.3e} (limit 1e-6 each)")
        check(max(dev_) <= 1e-6, f"the fallback is not 'gram': {dev_}")
        del g
    new, elbo, timings, lc, st, ms, fs, peak, warned = _solve_counted(
        torch, (mxu2d,), m, st0, d, "factored", **FB_SOLVE)
    solves = -(-m.M // FACTOR_CHUNK)
    log(f"[full-batch-factored] factored at the default jitter (the float64 factor's): "
        f"{_stages(timings)}; peak torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB; "
        f"ELBO {elbo:.6f}; {checks_line(fs)}; RuntimeWarnings {warned}")
    _log_mean_pcg("full-batch-factored", "factored", ms, FB_SOLVE["mean_solver_maxiter"],
                  FB_SOLVE["mean_solver_tol"])
    check(not warned, f"factored warned {warned}")
    check(fs["trKinvA"] <= 1.2 * fs["sKnn"] + 1e-6 and fs["bracket"] >= -1e-3 * fs["sKnn"],
          f"a guard's numbers fail: {fs}")
    check(set(timings) == {"sweep", "factor", "g", "mean", "elbo"}, f"stages {timings}")
    _fb_launch_check("full-batch-factored", lc, st, solves)
    fit_launches = dict(lc)
    mu, sig = batch_predict(m, new, d["xtest"], batch_size=4096, maxiter_cg=50)
    torch.cuda.synchronize()
    lc = dict(mxu2d.LAUNCHES)
    st = dict(solve.PCG_STATS)
    chunks = st["solves"] - solves
    log(f"[full-batch-factored] fit + predict: {chunks} prediction chunks")
    check(chunks >= 1, "the prediction made no solve")
    _fb_launch_check("full-batch-factored", lc, st, solves + chunks)
    mu, sig = mu.cpu().numpy(), sig.cpu().numpy()
    rmse = float(np.sqrt(np.mean((mu - d["ftest"]) ** 2)))
    fstd = float(np.std(d["ftest"]))
    log(f"[full-batch-factored] test RMSE {rmse:.5f} vs std(ftest) {fstd:.5f}")
    check(math.isfinite(elbo), f"factored ELBO {elbo}")
    check(bool(np.isfinite(mu).all() and np.isfinite(sig).all()), "non-finite prediction")
    check(rmse < fstd, f"factored test RMSE {rmse} not below std(ftest) {fstd}")
    # against 'gram' with converged whitening and mean PCG: the two differ in
    # where the whitening's truncation enters, so both run it out
    new, elbo, timings, _, _, ms, fs, _, warned = _solve_counted(
        torch, (mxu2d,), m, st0, d, "factored", **FB_ACC_SOLVE)
    g, eg = gram_ref
    t2, t1 = max_rel(new.theta2, g.theta2), rel(new.theta1, g.theta1)
    de = abs(elbo - eg) / abs(eg)
    _log_mean_pcg("full-batch-factored", "factored converged", ms,
                  FB_ACC_SOLVE["mean_solver_maxiter"], FB_ACC_SOLVE["mean_solver_tol"])
    log(f"[full-batch-factored] converged (maxiter_cg {FB_ACC_SOLVE['maxiter_cg']}, mean "
        f"tol {FB_ACC_SOLVE['mean_solver_tol']:g}): {_stages(timings)}; factored vs "
        f"[accuracy-full-batch]'s float32 'gram': theta2 max-relative {t2:.3e} (limit "
        f"1e-2), theta1 rel {t1:.3e}, ELBO {elbo:.8f} vs {eg:.8f}, rel {de:.3e} (limit "
        f"1e-2); {checks_line(fs)}; RuntimeWarnings {warned}; "
        f"{time.perf_counter() - t0:.2f} s")
    check(not warned, f"converged factored warned {warned}")
    check(t2 <= 1e-2, f"factored vs gram theta2 {t2}")
    check(de <= 1e-2, f"factored vs gram ELBO {de}")
    return fit_launches


# ---- A5: the block-diagonal and full-rank families ----------------------------
MAIN_BLOCK = (5, 5)        # [main-block]: 250^2 embedded -> 2 500 blocks of 25
MAIN_GRID = 125            # inducing points per axis of the 2-D protocol
FR_GRID = 64               # [full-rank]: 64^2, embedded 128^2: M' = 16 384
FB3_BLOCK_PEAK_LIMIT = 24e9   # [full-batch-3d-block]: a (512, nb, 8, 8) product alone is 17 GB
# [full-rank]: the float32 fit's ELBO against float64's.  The float32
# whitened kn sets it: the full-rank bound holds log det(I + ivar kn kn^T)
# at noise 0.01, so kn's float32 PCG floor (~1e-6) moves it by 1.4e-4 with
# Lambda, S, the data term and the KL all evaluated in float64 (1.6e-4),
# converged or not; the mean-field 'gram' bound moves by 4.7e-7
FR_ELBO_LIMIT = 5e-4


def phase_main_block(torch, dev, d, sig2, main_step_ms):
    """[main]'s 2-D protocol with the block family: M = 125^2 (embedded
    250^2) chunked into MAIN_BLOCK blocks (2 500 of 25; run_synthetic
    --xblock-size 5), batch 256, maxiter_cg 10, the theta2 warm start, the
    lr clamped to half the natgrad stability limit, one epoch of 79 steps,
    then prediction of the 2 000 test points.  Checks: ELBO finite and
    rising (mean of the last 10 steps above the first 10's), rho finite and
    > 1, test RMSE below std(ftest), kernel A's launches exact against
    PCG_STATS (per solve 1 + 2k self-dots and one R^T; a solve per warm-start
    batch, one for rho, one per step, one per prediction chunk).  Returns
    kernel A's launches of fit and prediction."""
    import numpy as np

    from hipgp_tpu_torch.experiments.harness import make_model
    from hipgp_tpu_torch.infer import FitConfig, batch_predict, svigp_fit
    from hipgp_tpu_torch.ops import mxu2d, solve

    t0 = time.perf_counter()
    model = make_model("block-diagonal", "SqExp", [np.linspace(-1, 1, MAIN_GRID)] * 2,
                       len(d["xobs"]), sig2, 0.05, noise2_init=0.01 ** 2,
                       block_sizes=MAIN_BLOCK, dtype=torch.float32, device=dev)
    check((model.num_blocks, model.block_size) == (2500, 25),
          f"blocks {model.num_blocks} of {model.block_size}")
    cfg = FitConfig(epochs=1, batch_size=256, lr=1e-2, maxiter_cg=10)
    mxu2d.reset_launches()
    solve.PCG_STATS.update(solves=0, iterations=0)
    state, report = svigp_fit(model, model.init_state(), d["xobs"], d["yobs"], d["sobs"],
                              cfg, verbose=False, theta2_warmstart=True,
                              natgrad_safe_lr="clamp")
    torch.cuda.synchronize()
    fit_lc, fit_st = dict(mxu2d.LAUNCHES), dict(solve.PCG_STATS)
    t1 = time.perf_counter()
    mu, sig = batch_predict(model, state, d["xtest"], batch_size=4096,
                            maxiter_cg=cfg.predict_maxiter_cg)
    mu, sig = mu.cpu().numpy(), sig.cpu().numpy()
    predict_s = time.perf_counter() - t1
    lc, st = dict(mxu2d.LAUNCHES), dict(solve.PCG_STATS)
    trace = np.asarray(report["elbo_trace"])
    steps, rho = report["steps"], report["natgrad_rho"]
    step_ms = 1e3 * report["epoch_times"][0] / steps
    log(f"[main-block] grid {model.dims} -> {model.edims}, blocks {model.block_sizes}: "
        f"{model.num_blocks} of {model.block_size}; warm start {report['warmstart_s']:.2f} s, "
        f"rho {rho:.2f}, lr used {report['lr_used']:.4g}; {steps} natgrad steps at "
        f"{step_ms:.2f} ms/step against the mean-field step's {main_step_ms:.2f} ms ([main])")
    log(f"[main-block] ELBO first {trace[0]:.4f}, last {trace[-1]:.4f}; mean of first 10 "
        f"{trace[:10].mean():.4f}, of last 10 {trace[-10:].mean():.4f}")
    check(steps == 79, f"{steps} steps, expected 79")
    check(bool(np.isfinite(trace).all()), "non-finite block ELBO")
    check(trace[-10:].mean() > trace[:10].mean(), "the block ELBO did not rise")
    check(rho is not None and math.isfinite(rho) and rho > 1.0, f"rho {rho}")
    nb = -(-len(d["xobs"]) // cfg.batch_size)
    check(fit_st["solves"] == nb + 1 + steps,
          f"{fit_st['solves']} solves: one per warm-start batch, one for rho, one a step")
    for tag, lcx, stx in (("fit", fit_lc, fit_st), ("fit+predict", lc, st)):
        want = {"sandwich_apply_selfdot": stx["solves"] + 2 * stx["iterations"],
                "sandwich_apply": stx["solves"], "sandwich_apply_wp": 0,
                "sandwich_apply_wp_selfdot": 0}
        log(f"[main-block] {tag}: {stx['solves']} PCG solves, {stx['iterations']} "
            f"iterations -> expect {want}; counted {lcx}")
        check(lcx == want, f"[main-block] {tag} launches {lcx}, expected {want}")
    rmse = float(np.sqrt(np.mean((mu - d["ftest"]) ** 2)))
    fstd = float(np.std(d["ftest"]))
    check(bool(np.isfinite(mu).all() and np.isfinite(sig).all()), "non-finite prediction")
    check(rmse < fstd, f"block test RMSE {rmse} not below std(ftest) {fstd}")
    log(f"[main-block] predict: 2000 points in {predict_s:.2f} s; test RMSE {rmse:.5f} vs "
        f"std(ftest) {fstd:.5f}; {time.perf_counter() - t0:.2f} s")
    return lc


def phase_full_rank(torch, dev, d, sig2):
    """The full-rank family on [main]'s data (20 000 rows) at M = FR_GRID^2,
    embedded 128^2 (M' = 16 384: Lambda and S 1.07 GB each in float32),
    built by the harness (`make_model('full-rank')`: the 'standard'
    parameterization) and fit in closed form (`batch_solve('dense')`, one
    batch, FB_SOLVE: maxiter_cg 10, with the ELBO), then the prediction of
    the test points and get_inducing_S.  Checks: ELBO finite, RMSE below
    std(ftest), kernel A's launches exact against PCG_STATS (two whitening
    solves, the sweep and the ELBO's, then the prediction's), R S R^T
    symmetric to 1e-4 (two passes of 16 384-term float32 sums apply R in
    different orders to its rows and columns: 3.8e-5 on the card) with a
    positive diagonal.  Then the same fit with the whitening converged
    (FB_ACC_SOLVE: maxiter_cg 200) in float32 on the kernel path and in
    float64 on the plain path: theta1 within 5e-3 and the ELBO within
    FR_ELBO_LIMIT relative (S and R S R^T logged).  Returns kernel A's
    launches of the counted fit and prediction."""
    import numpy as np

    from hipgp_tpu_torch.experiments.harness import make_model
    from hipgp_tpu_torch.infer import batch_predict
    from hipgp_tpu_torch.ops import mxu2d, solve

    t0 = time.perf_counter()
    grids = [np.linspace(-1, 1, FR_GRID)] * 2

    def build(dt):
        m = make_model("full-rank", "SqExp", grids, len(d["xobs"]), sig2, 0.05,
                       noise2_init=0.01 ** 2, dtype=dt, device=dev)
        check(m.parameterization == "standard", "the harness's full-rank is 'standard'")
        return m

    model = build(torch.float32)
    new, elbo, timings, lc, st, _, _, peak, _ = _solve_counted(
        torch, (mxu2d,), model, model.init_state(), d, "dense", **FB_SOLVE)
    t1 = time.perf_counter()
    mu, sig = batch_predict(model, new, d["xtest"], batch_size=4096, maxiter_cg=50)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t1
    all_lc, all_st = dict(mxu2d.LAUNCHES), dict(solve.PCG_STATS)
    mu, sig = mu.cpu().numpy(), sig.cpu().numpy()
    rmse = float(np.sqrt(np.mean((mu - d["ftest"]) ** 2)))
    fstd = float(np.std(d["ftest"]))
    log(f"[full-rank] grid {model.dims} -> {model.edims}, M' = {model.Mprime}; dense fit "
        f"{_stages(timings)}; peak torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB; "
        f"ELBO {elbo:.8f}; predict {predict_s:.2f} s, test RMSE {rmse:.5f} vs std(ftest) "
        f"{fstd:.5f}")
    check(math.isfinite(elbo), f"full-rank ELBO {elbo}")
    check(bool(np.isfinite(mu).all() and np.isfinite(sig).all()), "non-finite prediction")
    check(rmse < fstd, f"full-rank test RMSE {rmse} not below std(ftest) {fstd}")
    _fb_launch_check("full-rank", lc, st, 2)
    chunks = all_st["solves"] - st["solves"]
    check(chunks == 1, f"{chunks} prediction chunks")
    _fb_launch_check("full-rank", all_lc, all_st, 2 + chunks)
    t1 = time.perf_counter()
    G = model.get_inducing_S(new)
    torch.cuda.synchronize()
    asym = float(torch.linalg.norm(G - G.T) / torch.linalg.norm(G))
    dmin = float(torch.min(torch.diagonal(G)))
    log(f"[full-rank] get_inducing_S {tuple(G.shape)} in {time.perf_counter() - t1:.2f} s: "
        f"||G - G^T|| / ||G|| {asym:.3e} (limit 1e-4), min diag {dmin:.4e}")
    check(G.shape == (model.M, model.M), f"R S R^T shape {tuple(G.shape)}")
    check(asym <= 1e-4 and dmin > 0.0, f"R S R^T: asymmetry {asym}, min diag {dmin}")
    del G, new
    res = {}
    for dt in (torch.float32, torch.float64):
        m = model if dt == torch.float32 else build(dt)
        timings = {}
        torch.cuda.reset_peak_memory_stats()
        new, elbo = m.batch_solve(m.init_state(), d["xobs"], d["yobs"], d["sobs"],
                                  mean_solver="dense", timings=timings, **FB_ACC_SOLVE)
        G = m.get_inducing_S(new).cpu()
        torch.cuda.synchronize()
        log(f"[full-rank] converged (maxiter_cg {FB_ACC_SOLVE['maxiter_cg']}), {dt}: "
            f"{_stages(timings)}; peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB; "
            f"ELBO {float(elbo):.8f}")
        res[dt] = (new, float(elbo), G)
        del m, new
        torch.cuda.empty_cache()
    del model
    (n32, e32, g32), (n64, e64, g64) = res[torch.float32], res[torch.float64]
    t1, t2 = rel(n32.theta1, n64.theta1), rel(n32.theta2, n64.theta2)
    de, dg = abs(e32 - e64) / abs(e64), rel(g32, g64)
    log(f"[full-rank] converged, f32 kernel path vs f64 plain path: theta1 (m) rel "
        f"{t1:.3e} (limit 5e-3), theta2 (S) rel {t2:.3e}, ELBO rel {de:.3e} (limit "
        f"{FR_ELBO_LIMIT:g}), R S R^T rel {dg:.3e}; {time.perf_counter() - t0:.2f} s")
    check(t1 <= 5e-3, f"full-rank theta1 f32 vs f64 {t1}")
    check(de <= FR_ELBO_LIMIT, f"full-rank ELBO f32 vs f64 {de}")
    return all_lc


def _domain_block_model(torch, dev, prob, dtype):
    """The dust map's block 2 x 2 x 2 model on ``prob``'s data and grids, as
    run_domain --model-class block-diagonal builds it."""
    from hipgp_tpu_torch.experiments import run_domain

    sig2 = run_domain.empirical_sig2_init(prob["xobs"], prob["aobs"])
    return run_domain.domain_model("SqExp", prob["grids"], len(prob["xobs"]), sig2,
                                   DOMAIN_ELL, dtype=dtype, device=dev,
                                   model_class="block-diagonal", block_sizes=(2, 2, 2))


def phase_full_batch_3d_block(torch, dev, mf):
    """[full-batch-3d] with the block 2 x 2 x 2 family (run_domain
    --model-class block-diagonal): the 64 x 64 x 32 grid embedded
    (128, 128, 64), 131 072 blocks of 8, the same cut, 'matfree' and mean
    PCG.  Logs each stage's seconds and the block-Lambda accumulation's
    share of the sweep (one batch's get_lam timed by CUDA events on a
    (512, M') kn, times the batches) and the peak memory.  Checks: ELBO
    finite, e post-RMSE below rms(e_test), peak under FB3_BLOCK_PEAK_LIMIT,
    B-6 and B-5 launches exact against PCG_STATS; and against ``mf``, the
    mean-field [full-batch-3d] (qm, ELBO) on the same data and hypers: qm
    within 1e-5 relative (both run the same mean stage) and the block ELBO
    at least the mean-field one less 1e-6 |ELBO| (Fischer's inequality: S_b
    = blockinv(Lambda) with the same tr(Lambda S))."""
    import tempfile

    import numpy as np

    from hipgp_tpu_torch.experiments import run_domain
    from hipgp_tpu_torch.infer import FitConfig
    from hipgp_tpu_torch.infer.fit import PREDICT_CHUNK_BUDGET_BYTES
    from hipgp_tpu_torch.ops import mxu2d, mxu3d, solve
    from hipgp_tpu_torch.utils import checkpoint

    t0 = time.perf_counter()
    argv = ["--nx", str(DOMAIN["nx"]), "--nz", str(DOMAIN["nz"]), "--ell", str(DOMAIN_ELL),
            "--nobs", str(DOMAIN["nobs"]), "--ntest", str(DOMAIN["ntest"]),
            "--noise-std", str(DOMAIN["noise_std"]), "--batch-size", str(DOMAIN_BATCH),
            "--maxiter-cg", "20", "--fit-method", "full-batch", "--mean-solver", "matfree",
            "--mean-solver-maxiter", str(FB3_MEAN["mean_solver_maxiter"]),
            "--mean-solver-tol", str(FB3_MEAN["mean_solver_tol"]),
            "--model-class", "block-diagonal", "--xblock-size", "2", "--zblock-size", "2"]
    log(f"[full-batch-3d-block] run_domain {' '.join(argv)} (cut as [full-batch-3d])")
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        mxu2d.reset_launches()
        mxu3d.reset_launches()
        solve.PCG_STATS.update(solves=0, iterations=0)
        out = run_domain.main(argv + ["--output-dir", tmp])
        torch.cuda.synchronize()
        lc = {**mxu2d.LAUNCHES, **mxu3d.LAUNCHES}
        st = dict(solve.PCG_STATS)
        peak = torch.cuda.max_memory_allocated()
        prob = run_domain.domain_problem(**DOMAIN)
        model = _domain_block_model(torch, dev, prob, torch.float32)
        state = checkpoint.load_pytree(f"{tmp}/state.npz", model.init_state())
    wall = time.perf_counter() - t0
    check((model.num_blocks, model.block_size) == (131072, 8),
          f"blocks {model.num_blocks} of {model.block_size}")
    # the block Lambda of one sweep batch, timed alone: a (512, M') kn
    gen = torch.Generator(device=dev).manual_seed(3)
    kn = torch.randn((DOMAIN_BATCH, model.Mprime), generator=gen, device=dev)
    ivar = torch.rand((DOMAIN_BATCH,), generator=gen, device=dev) + 0.5
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lam_ms = cuda_ms(torch, lambda: model.get_lam(ivar, kn, add_identity=False),
                     warmup=2, reps=10)
    lam_peak = torch.cuda.max_memory_allocated() - held
    del kn
    sweep_batches = -(-DOMAIN["nobs"] // DOMAIN_BATCH)
    share = sweep_batches * lam_ms / 1e3 / out["fit_sweep_s"]
    its = out["mean_pcg_iterations"]
    log(f"[full-batch-3d-block] matfree fit {out['fit_s']:.2f} s: sweep "
        f"{out['fit_sweep_s']:.3f} s (mean-field {mf['sweep_s']:.3f} s), mean stage "
        f"{out['fit_mean_s']:.3f} s ({its} iterations, ||r||/||b_m|| "
        f"{out['mean_pcg_relres']:.3e}), ELBO stage {out['fit_elbo_s']:.3f} s; the block "
        f"Lambda of one batch (get_lam on (512, {model.Mprime})) {lam_ms:.3f} ms, "
        f"{lam_peak / 1e9:.3f} GB of temporaries, x {sweep_batches} batches = {share * 100:.1f} % "
        f"of the sweep; peak torch.cuda.max_memory_allocated over the fit "
        f"{out['fit_peak_gb']:.3f} GB, over fit and predict {peak / 1e9:.3f} GB "
        f"({base / 1e9:.3f} GB allocated before); ELBO {out['last_elbo']:.6f}; predict "
        f"{out['predict_s']:.2f} s; e post-RMSE {out['e_post_rmse']:.5f} vs rms(e_test) "
        f"{out['e_rms']:.5f}; latent RMSE {out['latent_rmse']:.5f}, slice corr "
        f"{out['latent_corr']:.4f}")
    check(math.isfinite(out["last_elbo"]), f"non-finite block ELBO {out['last_elbo']}")
    check(math.isfinite(out["e_post_rmse"]) and out["e_post_rmse"] < out["e_rms"],
          f"e post-RMSE {out['e_post_rmse']} not below rms(e_test) {out['e_rms']}")
    check(peak < FB3_BLOCK_PEAK_LIMIT, f"block peak {peak / 1e9:.3f} GB")
    check(0 < its <= FB3_MEAN["mean_solver_maxiter"], f"{its} mean iterations")
    # the block family's prediction chunk counts its block-ordered copy of kn
    chunk = PREDICT_CHUNK_BUDGET_BYTES // (2 * 4 * model.Mprime)
    chunks = -(-DOMAIN["ntest"] // chunk) + -(-400 // chunk)
    check(st["solves"] == sweep_batches + chunks,
          f"{st['solves']} solves: expected {sweep_batches} sweep batches and {chunks} "
          f"prediction chunks of {chunk}")
    check(st["iterations"] <= 20 * sweep_batches + FitConfig().predict_maxiter_cg * chunks,
          f"{st['iterations']} iterations: a solve exceeded its maxiter")
    applies = st["solves"] + 2 * st["iterations"]
    use_wp3 = mxu3d.USE_WP3
    want = {"sandwich_apply_wp_selfdot": 0 if use_wp3 else applies,
            "sandwich_apply_wp3": applies if use_wp3 else 0,
            "sandwich_apply_wp": st["solves"],
            "sandwich_apply": 0, "sandwich_apply_selfdot": 0}
    log(f"[full-batch-3d-block] {st['solves']} PCG solves, {st['iterations']} iterations "
        f"-> expect {want}; counted {lc}")
    check(lc == want, f"3-D block full-batch launches {lc}, expected {want}")
    qm = model.standard_params(state)[0].cpu()
    dqm = rel(qm, mf["qm"])
    gap = out["last_elbo"] - mf["elbo"]
    log(f"[full-batch-3d-block] against the mean-field [full-batch-3d] on the same data "
        f"and hypers: qm rel {dqm:.3e} (limit 1e-5), ELBO {out['last_elbo']:.6f} vs "
        f"{mf['elbo']:.6f} (block - mean-field {gap:.6f}, limit >= "
        f"{-1e-6 * abs(mf['elbo']):.3e}); {wall:.2f} s")
    check(dqm <= 1e-5, f"block qm vs mean-field qm {dqm}")
    check(gap >= -1e-6 * abs(mf["elbo"]), f"block ELBO below mean-field by {-gap}")
    return lc


def phase_accuracy_full_batch_3d_block(torch, dev):
    """[accuracy-full-batch-3d] with the block 2 x 2 x 2 family: 'matfree' at
    32 x 32 x 16 (embedded (64, 64, 30): 15 360 blocks of 8), 2 048 line
    integrals, ell 0.07, converged (FB3_ACC_SOLVE): float32 on the kernel
    path (B-5's route; B-6's gate does not take the embedding, launches
    exact) against float64 on the plain path: theta2 (the block Lambda)
    <= 1e-4, theta1 <= 5e-3, ELBO <= 1e-4 relative; catches TF32 or float32
    rounding in the block outer products."""
    from hipgp_tpu_torch.experiments import run_domain
    from hipgp_tpu_torch.ops import mxu2d, mxu3d, solve

    t0 = time.perf_counter()
    prob = run_domain.domain_problem(**FB3_ACC)
    res = {}
    for key, dt in (("f32", torch.float32), ("f64", torch.float64)):
        model = _domain_block_model(torch, dev, prob, dt)
        mxu2d.reset_launches()
        mxu3d.reset_launches()
        solve.PCG_STATS.update(solves=0, iterations=0)
        timings = {}
        torch.cuda.reset_peak_memory_stats()
        new, elbo = model.batch_solve(model.init_state(), prob["xobs"], prob["aobs"],
                                      prob["sobs"], mean_solver="matfree", timings=timings,
                                      **FB3_ACC_SOLVE)
        torch.cuda.synchronize()
        lc = {k: v for k, v in {**mxu2d.LAUNCHES, **mxu3d.LAUNCHES}.items() if v}
        st = dict(solve.PCG_STATS)
        log(f"[accuracy-full-batch-3d-block] {key}: grid {model.dims} -> {model.edims}, "
            f"{model.num_blocks} blocks of {model.block_size}, {len(prob['xobs'])} rows; "
            f"{_stages(timings)}; peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB; "
            f"ELBO {float(elbo):.8f}; launches {lc}")
        check(math.isfinite(float(elbo)), f"{key}: ELBO {float(elbo)}")
        if dt == torch.float32:
            applies = st["solves"] + 2 * st["iterations"]
            want = {"sandwich_apply_wp_selfdot": applies, "sandwich_apply_wp": st["solves"]}
            check(lc == want, f"{key}: launches {lc}, expected {want}")
        else:
            check(not lc, f"{key}: the float64 path launched {lc}")
        res[key] = (new, float(elbo))
        del model
    (b32, e32), (b64, e64) = res["f32"], res["f64"]
    dev_ = [rel(b32.theta2, b64.theta2), rel(b32.theta1, b64.theta1), abs(e32 - e64) / abs(e64)]
    log(f"[accuracy-full-batch-3d-block] f32 (kernel path) vs f64 (plain path): theta2 "
        f"(the block Lambda) rel {dev_[0]:.3e} (limit 1e-4), theta1 rel {dev_[1]:.3e} "
        f"(limit 5e-3), ELBO rel {dev_[2]:.3e} (limit 1e-4); {time.perf_counter() - t0:.2f} s")
    check(dev_[0] <= 1e-4, f"block theta2 f32 vs f64 {dev_[0]}")
    check(dev_[1] <= 5e-3, f"block theta1 f32 vs f64 {dev_[1]}")
    check(dev_[2] <= 1e-4, f"block ELBO f32 vs f64 {dev_[2]}")


# ---------------------------------------------------------------------------
# fit resume, the section 5.1 and appendix C.1 solver studies, the deposition
# ---------------------------------------------------------------------------

RESUME_TOL = 1e-5            # resumed state, hypers and ELBO trace, relative
SOLVE_KN_GRIDS = (25, 50, 100)
DEPOSIT_N = 4_194_304        # particles of the synthetic snapshot
DEPOSIT_CHECK_N = 262_144    # of them held to float64 on the CPU
DEPOSIT_DIMS = (128, 128, 64)
DEPOSIT_TOL = 1e-4           # card float32 against CPU float64: max cell and sum
DEPOSIT_MASS_TOL = 1e-5      # CIC mass against sum(q) / cell volume


def _dir_bytes(path):
    import os

    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def phase_resume(torch, d, model, state0):
    """Fit resume on the 2-D protocol at full width: two epochs of the
    learn-kernel, learn-noise training (schedule_lr, the theta2 warm start,
    natgrad_safe_lr 'warn') without a break; one epoch with a checkpoint
    every epoch, resumed for the second.  The resumed state, hypers and ELBO
    trace against the uninterrupted run's second epoch (RESUME_TOL), the
    optimizer at the resume (Adam's moments and count, the schedule's count
    and lr) against the uninterrupted run's after its first epoch, and
    kernel A's launches in the resumed epoch exact (no warm start, no rho: per
    step 2 (1 + 2k) self-dots, one R^T and one pullback).  Returns the
    launches of the resumed epoch."""
    import dataclasses
    import tempfile
    import warnings

    import numpy as np

    from hipgp_tpu_torch.infer import FitConfig, svigp_fit
    from hipgp_tpu_torch.infer.fit import make_optimizer
    from hipgp_tpu_torch.ops import mxu2d, solve
    from hipgp_tpu_torch.utils import checkpoint

    t0 = time.perf_counter()
    cfg2 = FitConfig(epochs=2, batch_size=256, lr=1e-2, maxiter_cg=TRAIN_K,
                     learn_kernel=True, learn_noise=True)
    cfg1 = dataclasses.replace(cfg2, epochs=1)
    data = (d["xobs"], d["yobs"], d["sobs"])
    nb = -(-len(d["xobs"]) // cfg2.batch_size)
    with tempfile.TemporaryDirectory() as tmp:
        full_dir, cdir, sdir = (f"{tmp}/{n}" for n in ("full", "part", "save"))
        seen = {}

        def after_first_epoch(epoch, *rest):
            # the uninterrupted run's epoch-0 checkpoint, read before epoch 1's
            if epoch == 1:
                opt = make_optimizer(state0, cfg2)
                seen["state"], _, seen["step"] = checkpoint.restore_checkpoint(
                    full_dir, state0, opt)
                seen["opt"] = opt

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            full, frep = svigp_fit(model, state0, *data, cfg2, after_first_epoch, False,
                                   checkpoint_dir=full_dir, checkpoint_every=1,
                                   theta2_warmstart=True)
            part, prep = svigp_fit(model, state0, *data, cfg1, verbose=False,
                                   checkpoint_dir=cdir, checkpoint_every=1,
                                   theta2_warmstart=True)
        torch.cuda.synchronize()
        log(f"[resume] uninterrupted: 2 epochs of {frep['steps'] // 2} steps in "
            f"{frep['epoch_times'][0]:.2f} + {frep['epoch_times'][1]:.2f} s (warm start "
            f"{frep['warmstart_s']:.2f} s, lr {frep['lr_used']:g}); interrupted: 1 epoch in "
            f"{prep['epoch_times'][0]:.2f} s; natgrad_safe_lr 'warn' warnings: "
            f"{len(caught)}")
        check(frep["steps"] == 2 * nb and prep["steps"] == nb, "steps of the two legs")
        # the save and the restore, timed on their own (the fit's own save is
        # the same call)
        t1 = time.perf_counter()
        checkpoint.save_checkpoint(sdir, part, seen["opt"], step=1)
        save_s = time.perf_counter() - t1
        opt = make_optimizer(state0, cfg2)
        t1 = time.perf_counter()
        st_r, opt_r, step = checkpoint.restore_checkpoint(cdir, state0, opt)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        nbytes = _dir_bytes(cdir)
        check(step == 1 and opt_r is opt, f"restored step {step}")
        check(seen["step"] == 1, "the uninterrupted run's first checkpoint")
        # the optimizer at the resume against the uninterrupted run's
        ref = seen["opt"]
        got_l, ref_l = opt.leaves(st_r), ref.leaves(seen["state"])
        check(len(got_l) == len(ref_l) == 8, f"{len(got_l)} optimizer leaves")
        check(int(got_l[0]) == int(ref_l[0]) == nb and int(got_l[-1]) == int(ref_l[-1]) == nb,
              f"counts {int(got_l[0])}, {int(got_l[-1])}: expected {nb}")
        mom = max(rel(a, b) for a, b in zip(got_l[1:7], ref_l[1:7]))
        lr_at = opt.current_lr()
        check(abs(lr_at - ref.current_lr()) <= 1e-15 * lr_at
              and abs(lr_at - cfg2.lr * cfg2.step_decay ** nb) <= 1e-12 * lr_at,
              f"schedule lr at the resume {lr_at}")
        check(mom <= RESUME_TOL, f"Adam moments at the resume: rel err {mom}")
        # the resumed epoch, counters zeroed just before and read just after
        mxu2d.reset_launches()
        solve.PCG_STATS.update(solves=0, iterations=0)
        res, rrep = svigp_fit(model, state0, *data, cfg2, verbose=False,
                              checkpoint_dir=cdir, resume=True, theta2_warmstart=True)
        torch.cuda.synchronize()
        lc, st = dict(mxu2d.LAUNCHES), dict(solve.PCG_STATS)
    steps = rrep["steps"]
    errs = {f: rel(getattr(res, f), getattr(full, f)) for f in ("theta1", "theta2") + HYPERS}
    trace, want = np.asarray(rrep["elbo_trace"]), np.asarray(frep["elbo_trace"][nb:])
    elbo_err = float(np.max(np.abs(trace - want) / np.abs(want)))
    log(f"[resume] resumed epoch: {steps} steps in {rrep['epoch_times'][0]:.2f} s "
        f"({1e3 * rrep['epoch_times'][0] / steps:.2f} ms/step), lr {rrep['lr_used']:g}, "
        f"rho {rrep['natgrad_rho']}; against the uninterrupted second epoch: rel err "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}, ELBO trace max "
        f"rel err {elbo_err:.3e}; optimizer at the resume: counts {nb}, lr {lr_at:.6g}, "
        f"Adam moments max rel err {mom:.3e}")
    log(f"[resume] checkpoint {nbytes} bytes; save {1e3 * save_s:.2f} ms, restore "
        f"{1e3 * restore_s:.2f} ms")
    check(steps == nb, f"{steps} resumed steps, expected {nb}")
    check(rrep["natgrad_rho"] is None and rrep["lr_used"] == cfg2.lr,
          "the resumed fit ran a warm start or a rho estimate")
    check(max(errs.values()) <= RESUME_TOL, f"resumed state rel err {errs}")
    check(elbo_err <= RESUME_TOL, f"resumed ELBO trace rel err {elbo_err}")
    want_lc = {"sandwich_apply_selfdot": 2 * steps * (1 + 2 * TRAIN_K),
               "sandwich_apply": 2 * steps, "sandwich_apply_wp": 0,
               "sandwich_apply_wp_selfdot": 0}
    log(f"[resume] {st['solves']} PCG solves, {st['iterations']} iterations; expect "
        f"{want_lc}, counted {lc}; {time.perf_counter() - t0:.2f} s")
    check(st["solves"] == 2 * steps and st["iterations"] == TRAIN_K * st["solves"],
          f"resumed epoch PCG stats {st}")
    check(lc == want_lc, f"resumed epoch launches {lc}, expected {want_lc}")
    return lc


def phase_solve_kn(torch):
    """Paper section 5.1 (run_solve_kn.main at its defaults: grids 25, 50,
    100; 2 000 iterations; batch 16; float32; --no-plots), one grid a call:
    the traces finite, PCG at the script's tolerance (10 x the least CG
    RMSE) in no more iterations than CG; the iterations, seconds and matvec
    route of each grid logged.  Returns the radix launches (none: the 2-D
    matvecs are the einsum chain or B-8)."""
    import tempfile

    import numpy as np

    from hipgp_tpu_torch.experiments import run_solve_kn
    from hipgp_tpu_torch.ops import radix_fft

    t0 = time.perf_counter()
    before = dict(radix_fft.LAUNCHES)
    with tempfile.TemporaryDirectory() as tmp:
        for g in SOLVE_KN_GRIDS:
            t1 = time.perf_counter()
            res = run_solve_kn.main(["--gridsizes", str(g), "--no-plots",
                                     "--output-dir", tmp])[g]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
            n = len(res["cg"]["rmse"])
            tol = max(res["cg"]["rmse"].min(), 1e-12) * 10
            it = {k: run_solve_kn.iters_to(res[k]["rmse"], tol, n) for k in ("cg", "pcg")}
            finite = all(np.isfinite(res[k][c]).all() for k in res for c in res[k])
            log(f"[solve-kn] grid {g}x{g} (its embedding and matvec route above): "
                f"{secs:.2f} s; iterations to RMSE < {tol:.3e}: CG {it['cg']}, PCG "
                f"{it['pcg']}; least RMSE CG {res['cg']['rmse'].min():.3e}, PCG "
                f"{res['pcg']['rmse'].min():.3e}")
            check(n == 2000, f"{n} iterations")
            check(finite, f"non-finite traces at grid {g}")
            check(it["pcg"] < n and it["pcg"] <= it["cg"],
                  f"grid {g}: PCG {it['pcg']} iterations, CG {it['cg']}")
    moved = {k: v - before[k] for k, v in radix_fft.LAUNCHES.items()}
    log(f"[solve-kn] radix launches {moved}; {time.perf_counter() - t0:.2f} s")
    return moved


def phase_precond(torch):
    """Paper appendix C.1 (preconditioner_analysis.main at its defaults, in
    float32 and with --f64): the whole table logged as found, each row's
    matvec route; r_pcg <= 1 in the JAX test's case (Mat52, ell 0.05, sizes
    16 and 64, f64, tol 1e-5, maxiter 500).  Returns the radix launches."""
    import tempfile

    import numpy as np

    from hipgp_tpu_torch.experiments import preconditioner_analysis
    from hipgp_tpu_torch.ops import radix_fft

    t0 = time.perf_counter()
    before = dict(radix_fft.LAUNCHES)
    with tempfile.TemporaryDirectory() as tmp:
        for label, extra in (("float32", []), ("float64", ["--f64"])):
            t1 = time.perf_counter()
            tab = preconditioner_analysis.main(["--output-dir", tmp] + extra)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
            worse = int(np.sum(tab["pcg_iters"] > tab["cg_iters"]))
            capped = int(np.sum(np.maximum(tab["cg_iters"], tab["pcg_iters"]) >= 2000))
            log(f"[precond] {label}: {len(tab['M'])} rows in {secs:.2f} s; rows where PCG "
                f"takes more iterations than CG: {worse}; rows at maxiter 2000: {capped}")
            for i in range(len(tab["M"])):
                log(f"[precond] {label} " + " ".join(f"{c}={tab[c][i]}" for c in tab))
            check(np.isfinite(tab["r_pcg"]).all(), f"{label}: non-finite r_pcg")
        tab = preconditioner_analysis.main(
            ["--sizes", "16", "64", "--kernels", "Mat52", "--ells", "0.05", "--tol", "1e-5",
             "--maxiter", "500", "--f64", "--output-dir", tmp])
    log(f"[precond] the JAX test's case: r_pcg {tab['r_pcg'].tolist()} (CG "
        f"{tab['cg_iters'].tolist()}, PCG {tab['pcg_iters'].tolist()})")
    check(bool((tab["r_pcg"] <= 1.0).all()), f"r_pcg {tab['r_pcg']} in the JAX test's case")
    moved = {k: v - before[k] for k, v in radix_fft.LAUNCHES.items()}
    log(f"[precond] radix launches {moved}; {time.perf_counter() - t0:.2f} s")
    return moved


def deposit_snapshot(n, dims, seed=0):
    """A synthetic SPH snapshot on the box [-1, 1]^2 x [-0.5, 0.5] cut into
    ``dims`` cubic cells: positions uniform at least one cell inside it,
    log-normal smoothing lengths of 0.3-3 cells, the latte npz fields."""
    import numpy as np

    rng = np.random.default_rng(seed)
    left, right = np.array([-1.0, -1.0, -0.5]), np.array([1.0, 1.0, 0.5])
    cell = (right - left) / np.array(dims)
    snap = dict(x=rng.uniform(left[0] + cell[0], right[0] - cell[0], n),
                y=rng.uniform(left[1] + cell[1], right[1] - cell[1], n),
                z=rng.uniform(left[2] + cell[2], right[2] - cell[2], n),
                density=rng.uniform(0.5, 1.5, n), mass=rng.uniform(0.5, 1.5, n),
                hydrogenneutralfraction=rng.uniform(0, 1, n),
                massfraction=rng.uniform(0.05, 0.3, (n, 2)),
                metallicitytotal=rng.uniform(-1, 0.5, n),
                smoothlength=np.clip(np.exp(rng.normal(0.0, 0.6, n)), 0.3, 3.0) * cell.min())
    return snap, left, right, cell


def phase_deposit(torch):
    """The dust-density deposition on the card: sph_deposit and cic_deposit
    of DEPOSIT_N particles onto DEPOSIT_DIMS cells (seconds, particles a
    second, peak memory); the first DEPOSIT_CHECK_N particles against the
    same function in float64 on the CPU (max cell and sum, DEPOSIT_TOL); CIC
    mass conservation at the full count (DEPOSIT_MASS_TOL); then run_domain
    --snapshot end to end at [main-3d]'s cut on a written observation table
    and snapshot, by sph and cic."""
    import os
    import tempfile

    import numpy as np

    from hipgp_tpu_torch.experiments import dust_density as dd
    from hipgp_tpu_torch.experiments import run_domain

    t0 = time.perf_counter()
    snap, left, right, cell = deposit_snapshot(DEPOSIT_N, DEPOSIT_DIMS)
    pos = np.column_stack([snap["x"], snap["y"], snap["z"]])
    dust = dd.metal_weighted_dust_density(snap)
    q = snap["mass"] / snap["density"] * dust
    args = {"sph": lambda n, **kw: dd.sph_deposit(pos[:n], dust[:n], snap["mass"][:n],
                                                   snap["density"][:n],
                                                   snap["smoothlength"][:n], left, right,
                                                   DEPOSIT_DIMS, **kw),
            "cic": lambda n, **kw: dd.cic_deposit(pos[:n], q[:n], left, right, DEPOSIT_DIMS,
                                                   **kw)}
    log(f"[deposit] {DEPOSIT_N} particles (h 0.3-3 cells, log-normal) onto "
        f"{DEPOSIT_DIMS} cells; setup {time.perf_counter() - t0:.2f} s")
    for method, fn in args.items():
        fn(DEPOSIT_CHECK_N)                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        grid = fn(DEPOSIT_N)
        secs = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated()
        sub = fn(DEPOSIT_CHECK_N)
        t1 = time.perf_counter()
        ref = fn(DEPOSIT_CHECK_N, device="cpu", dtype=torch.float64)
        cpu_s = time.perf_counter() - t1
        max_err = abs(float(sub.max()) / float(ref.max()) - 1)
        sum_err = abs(float(sub.sum(dtype=np.float64)) / float(ref.sum()) - 1)
        cell_err = float(np.max(np.abs(sub - ref))) / float(ref.max())
        log(f"[deposit] {method}: {secs:.3f} s on the card ({DEPOSIT_N / secs:.4g} "
            f"particles/s), peak {peak / 1e9:.3f} GB; first {DEPOSIT_CHECK_N} against "
            f"float64 on the CPU ({cpu_s:.2f} s): max cell rel err {max_err:.3e}, sum "
            f"{sum_err:.3e}, largest cell difference / max {cell_err:.3e}")
        check(grid.shape == DEPOSIT_DIMS and np.isfinite(grid).all() and grid.max() > 0,
              f"{method} grid")
        check(max_err <= DEPOSIT_TOL and sum_err <= DEPOSIT_TOL,
              f"{method} against float64: max {max_err}, sum {sum_err}")
        if method == "cic":
            mass = float(grid.sum(dtype=np.float64)) * float(np.prod(cell))
            mass_err = abs(mass / float(q.sum()) - 1)
            log(f"[deposit] cic mass {mass:.9g} against sum(q) {float(q.sum()):.9g}: rel "
                f"err {mass_err:.3e}")
            check(mass_err <= DEPOSIT_MASS_TOL, f"cic mass rel err {mass_err}")
    # run_domain --snapshot at [main-3d]'s cut: a reference-format table of
    # the synthetic stars (no density column) and a snapshot of
    # DEPOSIT_CHECK_N particles
    x, a, e, sobs, _ = run_domain.make_synthetic_domain_data(
        DOMAIN["nobs"] + DOMAIN["ntest"], DOMAIN["noise_std"])
    small = {k: v[:DEPOSIT_CHECK_N] for k, v in snap.items()}
    with tempfile.TemporaryDirectory() as tmp:
        table, npz = os.path.join(tmp, "obs.dat"), os.path.join(tmp, "latte.npz")
        np.savetxt(table, np.column_stack([x, e, sobs]), header="x y z e e_err",
                   comments="")
        np.savez(npz, **small)
        for method in ("sph", "cic"):
            argv = ["--data-path", table, "--snapshot", npz, "--deposit-method", method,
                    "--nx", str(DOMAIN["nx"]), "--nz", str(DOMAIN["nz"]),
                    "--ell", str(DOMAIN_ELL), "--ntest", str(DOMAIN["ntest"]),
                    "--batch-size", str(DOMAIN_BATCH), "--maxiter-cg", "20", "--lr", "1e-2",
                    "--epochs", "1", "--fit-method", "natgrad",
                    "--output-dir", os.path.join(tmp, method)]
            t1 = time.perf_counter()
            out = run_domain.main(argv)
            torch.cuda.synchronize()
            log(f"[deposit] run_domain --snapshot --deposit-method {method}: deposition "
                f"{out['deposit_s']:.3f} s, {out['steps']} natgrad steps, ELBO "
                f"{out['last_elbo']:.4f}, e post-RMSE {out['e_post_rmse']:.5f} vs rms(e_test) "
                f"{out['e_rms']:.5f}, latent corr against the deposited truth "
                f"{out['latent_corr']:.4f}; {time.perf_counter() - t1:.2f} s")
            check(out["steps"] == DOMAIN["nobs"] // DOMAIN_BATCH, f"{out['steps']} steps")
            check(math.isfinite(out["last_elbo"]) and math.isfinite(out["latent_rmse"]),
                  f"run_domain --snapshot ({method}) non-finite")
            check(out["e_post_rmse"] < out["e_rms"], f"e post-RMSE {out['e_post_rmse']}")
    log(f"[deposit] {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# the dense SVGP, the derivative GP, the studies and the support modules
# ---------------------------------------------------------------------------

SVGP_PEAK_LIMIT = 60e9     # bytes: [svgp]'s float64 M = 125^2 fits
SVGP_STEPS = 10            # [svgp]'s natgrad steps
# [svgp]: float64 predictions against svgp_plain_predict, relative; an H100
# reads 1.2e-10 (mean) and 3.0e-12 (std), the float32 fit 1.6e-5
SVGP_PLAIN_TOL = 1e-8
# RESULTS section 6 (JAX, float64, CPU): rough quality targets only
DERIV_RESULTS = {"latent_rmse": 0.046, "exact_gp_rmse": 0.041}
DERIV_COMPARE_RESULTS = ("ziggy yes 0.0219 / 0.535, ziggy no 0.0263 / 0.660, cholesky yes "
                         "0.0218 / 0.535, cholesky no 0.0264 / 0.663, exact yes 0.0216, "
                         "exact no 0.0265 (nlatent 100, nprime 20, derivative noise 0.2)")
# the TPU's results/natgrad-trajectory-paper/warm-ell0.2-clamped/jax.csv,
# epochs 0-2 (ELBO, test RMSE): quality targets only
TRAJ_TPU_ROWS = ((-2.316750, 0.239069), (-2.115184, 0.238619), (-2.023990, 0.239322))
PRECISION_FP32 = ("kernel-A", "einsum-fp32", "torch.fft", "B-8")   # 2-D rows held to 1e-5
PRECISION_TOL = 1e-5
TRACE_STEPS = 5


def _kernel_a_exact(tag, lc, st):
    """Kernel A's launches against PCG_STATS: 1 + 2k self-dots and one R^T
    per whitening solve, nothing else of mxu2d."""
    want = {"sandwich_apply_selfdot": st["solves"] + 2 * st["iterations"],
            "sandwich_apply": st["solves"], "sandwich_apply_wp": 0,
            "sandwich_apply_wp_selfdot": 0}
    log(f"[{tag}] {st['solves']} whitening solves, {st['iterations']} iterations -> "
        f"expect {want}; counted {lc}")
    check(lc == want, f"{tag}: kernel A launches {lc}, expected {want}")


def _npz(path):
    import numpy as np

    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def svgp_plain_predict(torch, xobs, yobs, sobs, xind, xtest, sig2, ell, jitter, dev):
    """The dense SVGP's optimal predictions by the textbook closed form, in
    float64 and independent of `models/svgp.py`: with P = Kmm + jitter I and
    B = P + Kmn diag(1/s^2) Knm, mean = K*m B^-1 Kmn (y / s^2) and variance
    = k** - |L_P^-1 Km*|^2 + |L_B^-1 Km*|^2 (SqExp written out here)."""
    f64 = dict(dtype=torch.float64, device=dev)

    def sqexp(a, b):
        a, b = torch.as_tensor(a, **f64), torch.as_tensor(b, **f64)
        d2 = sum((a[:, None, k] - b[None, :, k]) ** 2 for k in range(a.shape[1]))
        return sig2 * torch.exp(-0.5 * d2 / ell ** 2)

    ivar = 1.0 / torch.as_tensor(sobs, **f64).reshape(-1) ** 2
    y = torch.as_tensor(yobs, **f64).reshape(-1)
    Kmn = sqexp(xind, xobs)
    L_P = torch.linalg.cholesky(sqexp(xind, xind)
                                + jitter * torch.eye(len(xind), **f64))
    L_B = torch.linalg.cholesky(L_P @ L_P.T + (Kmn * ivar) @ Kmn.T)
    c = Kmn @ (ivar * y)
    del Kmn
    Kms = sqexp(xind, xtest)
    mean = Kms.T @ torch.cholesky_solve(c[:, None], L_B)[:, 0]
    var = (sig2 - torch.sum(torch.linalg.solve_triangular(L_P, Kms, upper=False) ** 2, 0)
           + torch.sum(torch.linalg.solve_triangular(L_B, Kms, upper=False) ** 2, 0))
    return mean.cpu().numpy(), torch.sqrt(var).cpu().numpy()


def phase_svgp(torch, d):
    """The dense SVGP at the 2-D protocol's M = 125^2 (15 625 inducing
    points, unwhitened, jitter 1e-3; run_synthetic's data): the closed form
    through run_synthetic --models SVGP --fit-method full-batch in float64
    and float32, then 10 natgrad steps through svigp_fit in float64 at batch
    256 and lr 1e-2 x 1000/N.  Seconds and peak memory of each; float64 test
    RMSE < std(ftest), finite ELBOs, theta moved, the float64 predictions
    within SVGP_PLAIN_TOL of `svgp_plain_predict`; the float32 gap logged."""
    import tempfile

    import numpy as np

    from hipgp_tpu_torch.experiments import harness, run_synthetic
    from hipgp_tpu_torch.infer import FitConfig, svigp_fit

    t0 = time.perf_counter()
    fstd = float(np.std(d["ftest"]))
    fits = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, extra in (("float64", ["--f64"]), ("float32", [])):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            odir = f"{tmp}/{label}"
            out = run_synthetic.main(["--models", "SVGP", "--fit-method", "full-batch",
                                      "--output-dir", odir] + extra)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            fits[label] = dict(out=out, peak=peak,
                               state=_npz(f"{odir}/SVGP-SqExp/state.npz"),
                               pred=_npz(f"{odir}/SVGP-SqExp/predictions.npz"))
            log(f"[svgp] closed form, {label}, M = 125^2 unwhitened, 20 000 rows: fit "
                f"{out['fit_s']:.2f} s, predict 2 000 points {out['predict_s']:.2f} s, "
                f"run {out['wall_s']:.2f} s; ELBO {out['last_elbo']:.6f}; test RMSE "
                f"{out['test_rmse']:.5f} (std(ftest) {fstd:.5f}); peak "
                f"{peak / 1e9:.2f} GB")
            check(peak < SVGP_PEAK_LIMIT, f"[svgp] {label} peak {peak / 1e9:.2f} GB")
        f64, f32 = fits["float64"], fits["float32"]
        check(math.isfinite(f64["out"]["last_elbo"]), "[svgp] float64 ELBO not finite")
        check(f64["out"]["test_rmse"] < fstd,
              f"[svgp] float64 test RMSE {f64['out']['test_rmse']} not below {fstd}")
        theta1 = f64["state"]["arr_0"]
        gap = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
        # the same posterior by the textbook closed form (the state's hypers)
        grid = np.linspace(-1, 1, 125)
        xind = np.stack([a.reshape(-1) for a in np.meshgrid(grid, grid, indexing="ij")], -1)
        t1 = time.perf_counter()
        mu, sd = svgp_plain_predict(
            torch, d["xobs"], d["yobs"], d["sobs"], xind, d["xtest"],
            float(np.exp(f64["state"]["arr_2"])), float(np.exp(f64["state"]["arr_3"])),
            1e-3, torch.device("cuda"))
        torch.cuda.synchronize()
        gm, gs = gap(f64["pred"]["fmu_test"], mu), gap(f64["pred"]["fsig_test"], sd)
        log(f"[svgp] float64 predictions against the plain float64 closed form "
            f"({time.perf_counter() - t1:.2f} s): mean {gm:.3e}, std {gs:.3e} (limit "
            f"{SVGP_PLAIN_TOL:g}); its RMSE "
            f"{float(np.sqrt(np.mean((mu - d['ftest']) ** 2))):.5f}")
        check(gm <= SVGP_PLAIN_TOL and gs <= SVGP_PLAIN_TOL,
              f"[svgp] float64 predictions against the plain closed form: mean {gm}, "
              f"std {gs}")
        log(f"[svgp] float32 against float64 (logged as found; the reference asserts "
            f"float64): theta1 {gap(f32['state']['arr_0'], theta1):.3e}, test mean "
            f"{gap(f32['pred']['fmu_test'], f64['pred']['fmu_test']):.3e}, test std "
            f"{gap(f32['pred']['fsig_test'], f64['pred']['fsig_test']):.3e}; ELBO "
            f"{f32['out']['last_elbo']:.6f}, RMSE {f32['out']['test_rmse']:.5f}")

        # natgrad: the reference's effective rate (natgrad_trajectory's SVGP leg)
        dev = torch.device("cuda")
        sig2 = run_synthetic.marginal_sig2(d["yobs"], d["sobs"])
        grids = [np.linspace(-1, 1, 125)] * 2
        model = harness.make_model("SVGP", "SqExp", grids, num_obs=len(d["xobs"]),
                                   sig2_init=sig2, ell_init=0.05, dtype=torch.float64,
                                   device=dev)
        state0 = model.init_state()
        dists = []
        orig = model.elbo_and_grads

        def recorded(st, *a, **k):   # theta1 before each step
            dists.append(float(torch.linalg.norm(st.theta1.cpu() - torch.as_tensor(theta1))))
            return orig(st, *a, **k)

        model.elbo_and_grads = recorded
        cfg = FitConfig(epochs=1, batch_size=256, lr=1e-2 * 1000.0 / len(d["xobs"]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        state, rep = svigp_fit(model, state0, d["xobs"], d["yobs"], d["sobs"], cfg,
                               verbose=False, max_steps=SVGP_STEPS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated()
        dists.append(float(torch.linalg.norm(state.theta1.cpu() - torch.as_tensor(theta1))))
        trace = np.asarray(rep["elbo_trace"])
        log(f"[svgp] natgrad, float64, batch 256, lr {cfg.lr:.3g}: {rep['steps']} steps "
            f"in {secs:.2f} s ({secs / max(rep['steps'], 1):.3f} s/step); peak "
            f"{peak / 1e9:.2f} GB; ELBO {trace.tolist()}")
        log(f"[svgp] ||theta1 - theta1*|| (theta1* the float64 closed form) before step 1 "
            f"and after each: {[f'{v:.4e}' for v in dists]} (||theta1*|| "
            f"{float(np.linalg.norm(theta1)):.4e})")
        check(rep["steps"] == SVGP_STEPS, f"[svgp] {rep['steps']} natgrad steps")
        check(bool(np.isfinite(trace).all()), "[svgp] non-finite natgrad ELBO")
        check(float(torch.linalg.norm(state.theta1 - state0.theta1)) > 0
              and float(torch.linalg.norm(state.theta2 - state0.theta2)) > 0,
              "[svgp] theta did not move")
        check(peak < SVGP_PEAK_LIMIT, f"[svgp] natgrad peak {peak / 1e9:.2f} GB")
    log(f"[svgp] {time.perf_counter() - t0:.2f} s")


def phase_derivative(torch):
    """Paper section 5.3: run_derivative_1d at its defaults with --f64, then
    --compare, on the card.  The latent RMSE finite and at most 1.25 x the
    exact joint GP's; the tables logged beside RESULTS section 6's."""
    import tempfile

    from hipgp_tpu_torch.experiments import run_derivative_1d

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        row = run_derivative_1d.main(["--f64", "--output-dir", tmp])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        log(f"[derivative] defaults (nlatent 1000, nprime 10, M = 128, 50 Adam steps, "
            f"maxiter_cg 50), float64: {t1 - t0:.2f} s; {row}")
        log(f"[derivative] latent RMSE {row['latent_rmse']:.4f} vs the exact joint GP's "
            f"{row['vs_exact_gp_rmse']:.4f} (RESULTS section 6, JAX float64 on the CPU: "
            f"{DERIV_RESULTS['latent_rmse']} vs {DERIV_RESULTS['exact_gp_rmse']})")
        check(math.isfinite(row["latent_rmse"]), "[derivative] non-finite latent RMSE")
        check(row["latent_rmse"] <= 1.25 * row["vs_exact_gp_rmse"],
              f"[derivative] latent RMSE {row['latent_rmse']} above 1.25 x the exact GP's "
              f"{row['vs_exact_gp_rmse']}")
        rows = run_derivative_1d.main(["--f64", "--compare", "--output-dir", tmp])
        torch.cuda.synchronize()
    for r in rows:
        log(f"[derivative] compare: {r}")
        check(math.isfinite(r["latent_rmse"]), f"[derivative] non-finite row {r}")
    log(f"[derivative] RESULTS section 6's table: {DERIV_COMPARE_RESULTS}")
    log(f"[derivative] --compare {time.perf_counter() - t1:.2f} s; "
        f"{time.perf_counter() - t0:.2f} s")


def phase_trajectory(torch):
    """natgrad_trajectory twice: (a) the reduced scale (N = 2 000, M = 16^2,
    10 epochs) with the legs torch, chol, solve and torch-svgp in float64;
    (b) --paper --warmstart --safe-lr clamp --ell 0.2 --epochs 3, legs torch
    (kernel A, float32; its launches exact against PCG_STATS, counted just
    around the leg) and solve.  Every row finite; the solve RMSE below
    std(ftest).  Returns kernel A's launches of (b)'s torch leg."""
    import tempfile

    import numpy as np

    from hipgp_tpu_torch.experiments import natgrad_trajectory as nt
    from hipgp_tpu_torch.experiments.synthetic_data import make_two_dim_data
    from hipgp_tpu_torch.ops import mxu2d, solve

    t0 = time.perf_counter()

    def finite(rows, tag):
        for r in rows:
            check(all(math.isfinite(r[k]) for k in ("rmse", "secs")) and
                  (r["epoch"] < 0 or math.isfinite(r["elbo"])), f"[trajectory] {tag}: {r}")

    with tempfile.TemporaryDirectory() as tmp:
        out = nt.main(["--modes", "torch", "chol", "solve", "torch-svgp", "--output-dir", tmp])
        torch.cuda.synchronize()
        for leg, rows in out.items():
            finite(rows, f"(a) {leg}")
            log(f"[trajectory] (a) {leg}: " + "; ".join(
                f"epoch {r['epoch']} ELBO {r['elbo']:.5f} RMSE {r['rmse']:.5f}" for r in rows))
        t1 = time.perf_counter()
        log(f"[trajectory] (a) reduced scale, float64: {t1 - t0:.2f} s")

        args = nt.parse_args(["--paper", "--warmstart", "--safe-lr", "clamp", "--ell", "0.2",
                              "--epochs", "3", "--modes", "torch", "solve",
                              "--output-dir", tmp])
        data = make_two_dim_data(Nobs=args.nobs, Ntest=args.ntest, noise_std=args.noise,
                                 gridnum=args.gridnum, seed=args.seed)
        args.sig2 = float(np.var(data["yobs"]) - args.noise ** 2)
        mxu2d.reset_launches()
        solve.PCG_STATS.update(solves=0, iterations=0)
        rows = nt.run_torch(data, args, "ziggy", "torch")
        torch.cuda.synchronize()
        lc, st = dict(mxu2d.LAUNCHES), dict(solve.PCG_STATS)
        t2 = time.perf_counter()
        _kernel_a_exact("trajectory", lc, st)
        finite(rows, "(b) torch")
        for r, (te, tr) in zip(rows, TRAJ_TPU_ROWS):
            log(f"[trajectory] (b) epoch {r['epoch']}: ELBO {r['elbo']:.5f} RMSE "
                f"{r['rmse']:.5f} (the TPU's warm-ell0.2-clamped jax.csv: ELBO {te:.5f} "
                f"RMSE {tr:.5f})")
        srow = nt.run_solve(data, args)[0]
        torch.cuda.synchronize()
        fstd = float(np.std(data["ftest"]))
        log(f"[trajectory] (b) paper scale, float32: torch leg {t2 - t1:.2f} s, solve "
            f"('gram') {time.perf_counter() - t2:.2f} s: RMSE {srow['rmse']:.5f} vs "
            f"std(ftest) {fstd:.5f}")
        finite([srow], "(b) solve")
        check(srow["rmse"] < fstd, f"[trajectory] solve RMSE {srow['rmse']} >= {fstd}")
    log(f"[trajectory] {time.perf_counter() - t0:.2f} s")
    return lc


def phase_precision(torch):
    """precision_study at its defaults (2-D batch 256 at 125^2; 1-D batch 8
    at L = 2^21; 5 reps): every float32 policy's apply within 1e-5 of the
    float64 oracle, TF32 and bfloat16 logged, each kernel policy's launches
    moved, every switch restored.  Returns the kernel launches by wrapper."""
    import tempfile

    from hipgp_tpu_torch.experiments import precision_study

    t0 = time.perf_counter()
    before = precision_study.switch_values()
    with tempfile.TemporaryDirectory() as tmp:
        out = precision_study.main(["--output-dir", tmp])
        torch.cuda.synchronize()
        for regime in ("2d", "1d"):
            check(os.path.exists(f"{tmp}/summary_{regime}.json"),
                  f"[precision] summary_{regime}.json not written")
    after = precision_study.switch_values()
    check(after == before, f"[precision] switches {after}, were {before}")
    launches = {}
    for r in out["2d"] + out["1d"]:
        log(f"[precision] {r['regime']} {r['policy']}: rel err vs f64 "
            f"{r['rel_err_vs_f64']:.3e}, apply {r['apply_ms']:.4f} ms, 20-iteration "
            f"whitening {r['whiten20_ms']:.3f} ms, generic route {r['generic_route']}, "
            f"launches {r['launches']}")
        fp32 = (r["regime"] == "1d" or r["policy"] in PRECISION_FP32)
        if fp32:
            check(r["rel_err_vs_f64"] <= PRECISION_TOL,
                  f"[precision] {r['regime']} {r['policy']} rel err {r['rel_err_vs_f64']}")
        kernel = {"kernel-A": "mxu2d.", "B-8": "pallas_transform.",
                  "radix": "radix_fft."}.get(r["policy"])
        if kernel:
            moved = {k: v for k, v in r["launches"].items() if k.startswith(kernel)}
            check(sum(moved.values()) > 0, f"[precision] {r['policy']} launched no kernel")
            for k, v in moved.items():
                launches[k.split(".", 1)[1]] = launches.get(k.split(".", 1)[1], 0) + v
    log(f"[precision] switches restored {after}; {time.perf_counter() - t0:.2f} s")
    return launches


def phase_uci(torch):
    """run_3droad and run_ukhousing on their synthetic data at their defaults
    (20 000 rows; 64^2 and 64 x 48 grids, Mat52; the 'dense' closed form);
    predictions finite, test RMSE below std(test targets); kernel A's
    launches exact against PCG_STATS where the embedding has a kernel-A plan
    (`solve._mxu2d_solver_ok`), zero where it has not.  Returns kernel A's
    launches."""
    import tempfile

    import numpy as np

    from hipgp_tpu_torch.experiments import run_3droad, run_ukhousing
    from hipgp_tpu_torch.ops import bttb, mxu2d, solve

    t0 = time.perf_counter()
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, mod in (("3droad", run_3droad), ("ukhousing", run_ukhousing)):
            t1 = time.perf_counter()
            mxu2d.reset_launches()
            solve.PCG_STATS.update(solves=0, iterations=0)
            model, state, rep = mod.main(["--output-dir", tmp])
            torch.cuda.synchronize()
            lc, st = dict(mxu2d.LAUNCHES), dict(solve.PCG_STATS)
            secs = time.perf_counter() - t1
            spec = model.spectrum(state)
            kernel = solve._mxu2d_solver_ok(spec, torch.float32, torch.device("cuda"))
            pd = rep["pdict"]
            mu, f = pd["fmu_test"], pd["ftest"]
            rmse, fstd = float(np.sqrt(np.mean((mu - f) ** 2))), float(np.std(f))
            route = "kernel A" if kernel else bttb.apply_route(spec, torch.float32, "cuda")
            log(f"[uci] {name}: grid {spec.dims} embedded {spec.edims}, plans_ok "
                f"{mxu2d.plans_ok(spec.edims)}, path {route}; {secs:.2f} s (fit "
                f"{rep['time_report']['fitting']:.2f} s); test RMSE {rmse:.5f} vs std "
                f"{fstd:.5f}")
            check(bool(np.isfinite(mu).all() and np.isfinite(pd["fsig_test"]).all()),
                  f"[uci] {name}: non-finite predictions")
            check(rmse < fstd, f"[uci] {name}: test RMSE {rmse} not below {fstd}")
            if kernel:
                _kernel_a_exact(f"uci {name}", lc, st)
            else:
                check(not any(lc.values()), f"[uci] {name}: kernel A launched {lc}")
            for k, v in lc.items():
                total[k] = total.get(k, 0) + v
    log(f"[uci] {time.perf_counter() - t0:.2f} s")
    return total


def phase_demo_1d(torch):
    """demo_1d's fit at its defaults on the card (float32, no plot): both
    RMSEs below 0.1."""
    from hipgp_tpu_torch.experiments import demo_1d

    t0 = time.perf_counter()
    results, _ = demo_1d.fit()
    torch.cuda.synchronize()
    for name, (_, _, rmse) in results.items():
        check(math.isfinite(rmse) and rmse < 0.1, f"[demo-1d] {name} RMSE {rmse}")
    log(f"[demo-1d] " + ", ".join(f"{k}: test RMSE {v[2]:.4f}" for k, v in results.items())
        + f"; {time.perf_counter() - t0:.2f} s")


def phase_trace(torch, d, model, state0, main_step_ms):
    """PhaseTimer and trace around 5 natgrad steps of [main]'s model (the fit
    loop's batch_step, after the warm start): the Chrome trace names kernel
    A's CUDA kernels, the timer counts 5 calls; its seconds a step beside
    [main]'s."""
    import json as _json
    import tempfile

    from hipgp_tpu_torch.infer import FitConfig
    from hipgp_tpu_torch.infer.fit import (_theta2_warmstart, batch_step, make_optimizer,
                                           prepare_batches)
    from hipgp_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    cfg = FitConfig(epochs=1, batch_size=256, lr=1e-2, maxiter_cg=10)
    as_t = lambda a: torch.as_tensor(a).to(dtype=model.dtype, device=model.device)
    xb, yb, sb, w = prepare_batches(as_t(d["xobs"]), as_t(d["yobs"]), as_t(d["sobs"]),
                                    cfg.batch_size)
    state = _theta2_warmstart(model, state0, xb, sb, w, cfg)
    opt = make_optimizer(state, cfg)
    timer = profiling.PhaseTimer()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            for b in range(TRACE_STEPS):
                with timer("natgrad step"):
                    state, elbo = batch_step(model, cfg, opt, state, xb[b], yb[b], sb[b],
                                             w[b])
        path = f"{tmp}/trace.json"
        check(os.path.exists(path) and os.path.getsize(path) > 0, "[trace] no trace file")
        with open(path) as f:
            events = _json.load(f)["traceEvents"]
        size = os.path.getsize(path)
    names = {str(e.get("name", "")) for e in events if e.get("cat") == "kernel"}
    ka = sorted(n for n in names if any(k in n for k in TRACE_KERNEL_A))
    rows = timer.report()
    log(f"[trace] {len(events)} events ({size} bytes); CUDA kernels {len(names)}, kernel "
        f"A's: {ka}; PhaseTimer {rows}")
    check(bool(ka), f"[trace] kernel A's kernels not in the trace ({sorted(names)[:20]})")
    check(len(rows) == 1 and rows[0]["calls"] == TRACE_STEPS,
          f"[trace] PhaseTimer rows {rows}")
    check(math.isfinite(float(elbo)), "[trace] non-finite ELBO")
    log(f"[trace] {rows[0]['mean_s'] * 1e3:.2f} ms a step under the profiler and the "
        f"timer's synchronisations, against [main]'s {main_step_ms:.2f} ms; "
        f"{time.perf_counter() - t0:.2f} s")


# kernel A's CUDA kernels in csrc/sandwich_fft.cu, as a trace names them
TRACE_KERNEL_A = ("rows_forward_kernel", "columns_kernel", "rows_inverse_kernel")

# the parallel phases: ranks on the one card (gloo; NCCL cannot put two ranks
# on one GPU) and a world of one over NCCL
PAR_RANKS = 2
PAR_TIMEOUT_S = 480
DP_TOL = 1e-4              # [dp]: theta, the ELBO trace, rho, lr against [main]
DP_NCCL_TOL = 1e-6         # [dp-nccl]: the world of one against [main]
DP_SOLVE = dict(grid=64, rows=19_999, batch_size=2000, maxiter_cg=10)
DP_SOLVE_ELBO_TOL = 1e-5   # [dp-solve]: the ELBO against the single-process solve
# [dp-solve]'s float32 theta1 against the single-process float32 solve: theta1
# = Lambda mhat with mhat from the float32 Cholesky of I + sum ivar kn kn^T,
# whose error is set by that matrix's conditioning, so two float32 solves
# summed in different orders differ far more than theta2 or the ELBO; about
# twice the 7.273e-4 read on an H100 80GB HBM3 at 700 W
DP_SOLVE_F32_THETA1_TOL = 1.5e-3
# [dp-solve] in float64: state and ELBO against the single-process float64
# solve at the ranks' micro-batch, which shows the data-parallel sums exact
DP_SOLVE_F64_TOL = 1e-8
GRID_FFT = {"2d": dict(rows=256, iters=10), "1d": dict(M=HEADLINE_M, rows=8, iters=PCG_ITERS)}
GRID_FFT_TOL = 5e-3        # [accuracy]'s limit against float64
# [mp]: [main]'s model at full width (M = 125^2, embedded at 250^2, which
# splits over two grid ranks as it is) on a (1, 2) ('dp', 'grid') mesh of
# the gloo world's two ranks, JAX's default mesh; the rows cut to 10 of
# [main]'s batches of 256 (warm start, rho, lr clamp, 10 natgrad steps) and
# the prediction to 500 of [main]'s 2 000 test points: every split whitening
# exchanges its planes through host memory ([grid-fft]: ~1.1 s a solve)
MP = dict(rows=2560, batch_size=256, maxiter_cg=10, predict_rows=500, predict_maxiter=50)
MP_TOL = 5e-3              # [accuracy]'s: theta, ELBO trace, rho, lr, predictions
MP_GRAD_TOL = 1e-2         # [train-grad]'s: f32 hyper-gradients against float64
# [mp-solve]: mp_batch_solve at 64^2 (M' = 16 384) on 2 000 rows, a world of
# four gloo ranks as a (2, 2) mesh; micro-batches of 1 000 rows, 500 a 'dp'
# position (the single-process references take 500: the same row groups).
# In float64 every mean solve converged (||r|| 1e-10: ~1 000 'cg' and ~1 900
# 'gram' iterations, 12-17 ms each over gloo), 'cg' against 'dense', 'gram'
# and 'factored' against themselves: at 300 iterations the truncated (K + A)
# PCGs of the split and the single-process apply stood 5.0e-5 apart in
# theta1 (PERF.md section 6)
MP_SOLVE = dict(grid=64, rows=2000, batch_size=1000, maxiter_cg=10, mean_maxiter=2500,
                cg_maxiter=2500, mean_tol=1e-10, factor_jitter=1e-10, ranks=4)
MP_SOLVE_F64_TOL = 1e-8    # [dp-solve]'s: the split sums are exact
# [mp-solve] in float32 against the single-process float32 solve by the same
# solver (the mean PCGs truncated at 200 iterations) and 'sharded' against
# 'host': about three times the first reading on an H100 80GB HBM3 at
# 700 W (theta1 1.498e-3, theta2 1.663e-6, ELBO 6.052e-5)
MP_SOLVE_F32_TOL = {"theta1": 5e-3, "theta2": 1e-5, "ELBO": 2e-4}
# [mp-solve]'s 'factored' decline at 125^2 (float32 kappa > 1e3): 1 000 rows
MP_SOLVE_125_ROWS = 1000
# the device of the model-parallel phases' ranks and models
CARD = "cuda"


def _rank_prelude(torch):
    """What chip_smoke.main sets for the parent, set in a rank."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rank_epoch(torch, d, sig2, mesh):
    """[main]'s epoch on this rank's columns of every batch: the state, the
    trace, rho, the counts, the bytes all-reduced in one more step, the
    peak."""
    import numpy as np

    from hipgp_tpu_torch.experiments.run_synthetic import build_model
    from hipgp_tpu_torch.infer import FitConfig, svigp_fit
    from hipgp_tpu_torch.ops import mxu2d, solve
    from hipgp_tpu_torch.parallel import make_dp_data_shard_fn, round_batch_to_mesh
    from hipgp_tpu_torch.parallel import mesh as pmesh

    dev = torch.device("cuda")
    model = build_model("SqExp", MAIN_GRID, len(d["xobs"]), sig2, 0.05, 0.01,
                        dtype=torch.float32, device=dev)
    cfg = round_batch_to_mesh(FitConfig(epochs=1, batch_size=256, lr=1e-2, maxiter_cg=10),
                              mesh, len(d["xobs"]))
    shard = make_dp_data_shard_fn(mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mxu2d.reset_launches()
    solve.PCG_STATS.update(solves=0, iterations=0)
    pmesh.reset_comm()
    t0 = time.perf_counter()
    state, rep = svigp_fit(model, model.init_state(), d["xobs"], d["yobs"], d["sobs"], cfg,
                           verbose=False, theta2_warmstart=True, data_shard_fn=shard)
    torch.cuda.synchronize()
    out = dict(fit_s=time.perf_counter() - t0, launches=dict(mxu2d.LAUNCHES),
               stats=dict(solve.PCG_STATS), comm_fit=dict(pmesh.COMM),
               peak=torch.cuda.max_memory_allocated(), steps=rep["steps"],
               step_ms=1e3 * rep["epoch_times"][0] / rep["steps"],
               theta1=state.theta1.cpu().numpy(), theta2=state.theta2.cpu().numpy(),
               trace=np.asarray(rep["elbo_trace"]), rho=rep["natgrad_rho"],
               lr_used=rep["lr_used"])
    # one more step's collectives, counted alone
    as_t = lambda a: torch.as_tensor(a[:cfg.batch_size]).to(dtype=model.dtype, device=dev)
    xb, yb, sb, w = shard(*(as_t(a)[None] for a in (d["xobs"], d["yobs"], d["sobs"])),
                          torch.ones((1, cfg.batch_size), dtype=model.dtype, device=dev))
    pmesh.reset_comm()
    model.elbo_and_grads(state, xb[0], yb[0], sb[0], maxiter_cg=10, weights=w[0],
                         group=shard.group)
    out["comm_step"] = dict(pmesh.COMM)
    return out


def mp_model(torch, grid, n, sig2, shards, dtype):
    """[main]'s model (SqExp at ell 0.05, noise 0.01) on a grid^2 grid of
    [-1, 1]^2, its embedding padded for ``shards`` grid ranks, on the card."""
    import numpy as np

    from hipgp_tpu_torch.kernels import kernel_from_name
    from hipgp_tpu_torch.models import HIPGP

    grids = [np.linspace(-1, 1, grid)] * 2
    return HIPGP(kernel_from_name("SqExp"), grids, num_obs=n, sig2_init=sig2, ell_init=0.05,
                 noise2_init=1e-4, init_Svar=1.0, jitter=1e-3, grid_shards=shards,
                 dtype=dtype, device=torch.device(CARD))


def mp_config():
    from hipgp_tpu_torch.infer import FitConfig

    return FitConfig(epochs=1, batch_size=MP["batch_size"], lr=1e-2, maxiter_cg=MP["maxiter_cg"])


def _rank_mp(torch, d, sig2, mesh, ckpt_dir):
    """[mp] on this rank: mp_svigp_fit of [main]'s model on the cut rows
    (warm start, rho, lr clamp, one epoch; the whole state checkpointed by
    rank 0 into ``ckpt_dir``), one more step's collectives, one batch's
    hyper-gradients, mp_predict of the cut test points; the whole state."""
    from hipgp_tpu_torch.parallel import (mp_elbo_and_grads, mp_gather_state, mp_predict,
                                          mp_svigp_fit)
    from hipgp_tpu_torch.parallel import mesh as pmesh

    dev = torch.device(CARD)
    n, ng = MP["rows"], pmesh.axis_size(mesh, "grid")
    model = mp_model(torch, MAIN_GRID, n, sig2, ng, torch.float32)
    rows = [d[k][:n] for k in ("xobs", "yobs", "sobs")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pmesh.reset_comm()
    t0 = time.perf_counter()
    st, rep = mp_svigp_fit(model, model.init_state(), *rows, mp_config(), mesh, verbose=False,
                           theta2_warmstart=True, natgrad_safe_lr="clamp",
                           checkpoint_dir=ckpt_dir, checkpoint_every=1)
    torch.cuda.synchronize()
    whole = mp_gather_state(st, mesh)
    out = dict(fit_s=time.perf_counter() - t0, steps=rep["steps"],
               step_ms=1e3 * rep["epoch_times"][0] / rep["steps"],
               warmstart_s=rep["warmstart_s"], trace=rep["elbo_trace"],
               rho=rep["natgrad_rho"], lr_used=rep["lr_used"], comm_fit=dict(pmesh.COMM),
               peak=torch.cuda.max_memory_allocated(), theta1=whole.theta1.cpu().numpy(),
               theta2=whole.theta2.cpu().numpy())
    b = MP["batch_size"]
    xb, yb, sb = (torch.as_tensor(a[:b]).to(dtype=model.dtype, device=dev) for a in rows)
    # one more step's collectives, counted alone
    pmesh.reset_comm()
    mp_elbo_and_grads(model, st, xb, yb, sb, mesh=mesh, maxiter_cg=MP["maxiter_cg"])
    out["comm_step"] = dict(pmesh.COMM)
    elbo, g = mp_elbo_and_grads(model, st, xb, yb, sb, mesh=mesh,
                                maxiter_cg=MP["maxiter_cg"], compute_hyper_grads=True)
    out["hyper"] = {k: float(getattr(g, k)) for k in ("log_sig2", "log_ell", "log_noise2")}
    out["hyper_elbo"] = float(elbo)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mu, sig = mp_predict(model, st, d["xtest"][:MP["predict_rows"]], mesh,
                         batch_size=MP["predict_rows"], maxiter_cg=MP["predict_maxiter"])
    torch.cuda.synchronize()
    out.update(predict_s=time.perf_counter() - t0, mu=mu.cpu().numpy(), sig=sig.cpu().numpy())
    return out


def _mp_solve_mean(torch, dt, solver):
    """[mp-solve]'s mean-solve settings: float64 converged; float32 at the
    defaults."""
    c = MP_SOLVE
    if dt != torch.float64:
        return {}
    return dict(mean_solver_maxiter=c["cg_maxiter"] if solver == "cg" else c["mean_maxiter"],
                mean_solver_tol=c["mean_tol"])


def mp_solve_ranks(d, sig2):
    """[mp-solve] in one rank of the world of four: mp_batch_solve with
    'cg', 'gram' and 'factored' at 64^2 in float64 and float32, 'gram' with
    the split spectrum, and 'factored' declining at 125^2; the whole states
    (rank 0's), the ELBOs, stage seconds, peaks and warnings."""
    import warnings

    import torch
    import torch.distributed as dist

    from hipgp_tpu_torch import _build
    from hipgp_tpu_torch.models.hipgp import MEAN_PCG_STATS
    from hipgp_tpu_torch.parallel import make_mesh, mp_batch_solve, mp_gather_state

    _rank_prelude(torch)
    mesh = make_mesh(axis_names=("dp", "grid"), shape=(2, 2))
    c = MP_SOLVE
    rank = dist.get_rank()

    def run(model, n, key, **kw):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timings = {}
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            st, elbo = mp_batch_solve(model, model.init_state(), d["xobs"][:n], d["yobs"][:n],
                                      d["sobs"][:n], mesh, maxiter_cg=c["maxiter_cg"],
                                      compute_elbo=True, timings=timings, **kw)
        whole = mp_gather_state(st, mesh)
        out[key] = dict(elbo=float(elbo), timings=timings, peak=torch.cuda.max_memory_allocated(),
                        mean_iters=MEAN_PCG_STATS["iterations"],
                        warned=[str(w.message) for w in ws
                                if issubclass(w.category, RuntimeWarning)],
                        theta1=whole.theta1.cpu().numpy() if rank == 0 else None,
                        theta2=whole.theta2.cpu().numpy() if rank == 0 else None)

    out = {}
    n = c["rows"]
    for dt in (torch.float64, torch.float32):
        name = str(dt).split(".")[-1]
        model = mp_model(torch, c["grid"], n, sig2, 2, dt)
        for solver in ("cg", "gram", "factored"):
            jit = {"factor_jitter": c["factor_jitter"]} if solver == "factored" else {}
            run(model, n, f"{name}/{solver}", batch_size=c["batch_size"], mean_solver=solver,
                **_mp_solve_mean(torch, dt, solver), **jit)
        if dt == torch.float32:
            run(model, n, "float32/gram-sharded", batch_size=c["batch_size"],
                mean_solver="gram", spectrum_mode="sharded")
        del model
    model = mp_model(torch, MAIN_GRID, MP_SOLVE_125_ROWS, sig2, 2, torch.float32)
    for solver in ("factored", "gram"):
        run(model, MP_SOLVE_125_ROWS, f"125/{solver}", batch_size=MP_SOLVE_125_ROWS,
            mean_solver=solver)
    out["nvcc"] = sorted(_build.LOGS)
    out["backend"] = dist.get_backend()
    return out


def _rank_dp_solve(torch, d, sig2, mesh):
    """[dp-solve] on this rank: its block of the 19 999 rows, solved in
    float32 and again in float64."""
    from hipgp_tpu_torch.experiments.run_synthetic import build_model
    from hipgp_tpu_torch.parallel import dp_batch_solve, multihost

    n = DP_SOLVE["rows"]
    sl = multihost.process_slice(n)
    wg = multihost.global_row_weights(mesh, n)
    out = dict(rows=(sl.start, sl.stop), pad_rows=int((wg.local == 0).sum()))
    for dt in (torch.float32, torch.float64):
        model = build_model("SqExp", DP_SOLVE["grid"], n, sig2, 0.05, 0.01, dtype=dt,
                            device=torch.device("cuda"))
        xg, yg = (multihost.global_batch(mesh, d[k][:n][sl], n_global=n)
                  for k in ("xobs", "yobs"))
        sg = multihost.global_batch(mesh, d["sobs"][:n][sl], n_global=n, fill=1.0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timings = {}
        new, elbo = dp_batch_solve(model, model.init_state(), xg, yg, sg, mesh,
                                   batch_size=DP_SOLVE["batch_size"],
                                   maxiter_cg=DP_SOLVE["maxiter_cg"], row_weights=wg,
                                   compute_elbo=True, timings=timings)
        out[str(dt).split(".")[-1]] = dict(
            theta1=new.theta1.cpu().numpy(), theta2=new.theta2.cpu().numpy(),
            elbo=float(elbo), timings=timings, peak=torch.cuda.max_memory_allocated())
        del model, new
    return out


def grid_fft_problem(torch, case, dtype, d=None, sig2=None):
    """[grid-fft]'s (spectrum, right-hand side): '2d', [main]'s kernel on the
    125^2 grid with the embedding padded for two shards, Knm of [main]'s
    first 256 rows; '1d', the section 5.2 operator at M = 2^20 (its 2^21
    embedding splits for two shards as it is) and 8 rows from seed 0."""
    import numpy as np

    from hipgp_tpu_torch.kernels import kernel_from_name
    from hipgp_tpu_torch.models import HIPGP
    from hipgp_tpu_torch.parallel import shard_multiples

    dev = torch.device("cuda")
    if case == "2d":
        grids = [np.linspace(-1, 1, MAIN_GRID)] * 2
        model = HIPGP(kernel_from_name("SqExp"), grids, num_obs=len(d["xobs"]),
                      sig2_init=sig2, ell_init=0.05, noise2_init=1e-4, init_Svar=1.0,
                      jitter=1e-3, grid_shards=PAR_RANKS, dtype=dtype, device=dev)
        st = model.init_state()
        check(model._spec_multiple == shard_multiples(model.dims, PAR_RANKS),
              "the 2-D spectrum is not padded for the shards")
        x = torch.as_tensor(d["xobs"][:GRID_FFT["2d"]["rows"]]).to(dtype=dtype, device=dev)
        return model.spectrum(st), model.make_grams(st, x)[0]
    c = GRID_FFT["1d"]
    spec = protocol_spectrum_1d(c["M"], dtype, dev)
    check(spec.edims[0] % shard_multiples((c["M"],), PAR_RANKS)[0] == 0,
          f"the 1-D embedding {spec.edims} does not split for {PAR_RANKS} shards")
    b = np.random.default_rng(0).standard_normal((c["rows"], c["M"]))
    return spec, torch.as_tensor(b, dtype=dtype, device=dev)


def _rank_grid_fft(torch, d, sig2, cases):
    """[grid-fft] on this rank: each case's sharded_gram_solve, timed
    (one solve before the timed one for the 2-D case; the 1-D one once),
    with its all_to_all bytes; the result from rank 0 only."""
    import torch.distributed as dist

    from hipgp_tpu_torch.parallel import make_mesh, sharded_gram_solve
    from hipgp_tpu_torch.parallel import mesh as pmesh

    mesh = make_mesh(axis_names=("grid",))
    out = {}
    for case in cases:
        spec, b = grid_fft_problem(torch, case, torch.float32, d, sig2)
        iters = GRID_FFT[case]["iters"]
        run = lambda: sharded_gram_solve(spec, b, mesh, maxiter=iters, tol=0.0)
        if case == "2d":
            run()
        torch.cuda.synchronize()
        pmesh.reset_comm()
        t0 = time.perf_counter()
        kn = run()
        torch.cuda.synchronize()
        out[case] = dict(ms=1e3 * (time.perf_counter() - t0), comm=dict(pmesh.COMM),
                         kn=kn.cpu().numpy() if dist.get_rank() == 0 else None,
                         shape=tuple(kn.shape))
        del kn
    return out


def _rank_collectives(torch):
    """The collectives the port calls (all_reduce, all_to_all_single,
    all_gather), each on CUDA tensors of float32, float64 and complex64,
    checked against the sums and pieces they must give; and the ms of an
    all_reduce of 0.5 MB and 32 MB and of an all_to_all of 32 MB (mean of 5
    after one)."""
    import torch.distributed as dist

    dev = torch.device("cuda")
    rank, n = dist.get_rank(), dist.get_world_size()
    took = []
    for dt in (torch.float32, torch.float64, torch.complex64):
        ramp = lambda r: (torch.arange(4 * n, device=dev) + 100 * r).to(dt)
        y = ramp(rank).clone()
        dist.all_reduce(y)
        check(torch.equal(y, sum(ramp(r) for r in range(n))), f"all_reduce {dt}")
        x = ramp(rank)
        send = torch.view_as_real(x) if x.is_complex() else x
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send.contiguous())
        recv = torch.view_as_complex(recv) if x.is_complex() else recv
        want = torch.cat([ramp(r).chunk(n)[rank] for r in range(n)])
        check(torch.equal(recv, want), f"all_to_all_single {dt}")
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x)
        check(all(torch.equal(p, ramp(r)) for r, p in enumerate(parts)), f"all_gather {dt}")
        took.append(str(dt).replace("torch.", ""))
    # the model-parallel path's reductions: MAX and MIN, and the
    # differentiable sum (its gradient each rank's share: the identity)
    from hipgp_tpu_torch.parallel import mesh as pmesh

    for dt in (torch.float32, torch.float64):
        v = (torch.arange(3, device=dev) + 10.0 * rank).to(dt)
        (hi,) = pmesh.all_reduce([v], op="max")
        (lo,) = pmesh.all_reduce([v], op="min")
        check(torch.equal(hi, v - 10.0 * rank + 10.0 * (n - 1))
              and torch.equal(lo, v - 10.0 * rank), f"all_reduce max / min {dt}")
        w = v.clone().requires_grad_()
        (tot,) = pmesh.sum_over([w * w], None)
        (g,) = torch.autograd.grad(torch.sum(tot * 3.0), w)
        check(torch.equal(tot.detach(), sum((torch.arange(3, device=dev) + 10.0 * r).to(dt) ** 2
                                           for r in range(n)))
              and torch.equal(g, 6.0 * v), f"sum_over {dt}")
    took.append("max / min / sum_over")
    ms = {}
    for name, nbytes in (("all_reduce", 1 << 19), ("all_reduce", 1 << 25),
                         ("all_to_all", 1 << 25)):
        a = torch.ones(nbytes // 4, device=dev)
        b = torch.empty_like(a)
        op = ((lambda: dist.all_reduce(a)) if name == "all_reduce"
              else (lambda: dist.all_to_all_single(b, a)))
        op()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            op()
        torch.cuda.synchronize()
        ms[f"{name} {nbytes} B"] = 1e3 * (time.perf_counter() - t0) / 5
    return {"took": took, "ms": ms}


def parallel_ranks(d, sig2, ckpt_dir):
    """The gloo world's phases, in one rank: the collectives, [dp],
    [dp-solve], [grid-fft], [mp] (on a (1, 2) ('dp', 'grid') mesh)."""
    import torch

    from hipgp_tpu_torch import _build
    from hipgp_tpu_torch.parallel import make_mesh

    _rank_prelude(torch)
    mesh = make_mesh()
    out = {"collectives": _rank_collectives(torch),
           "dp": _rank_epoch(torch, d, sig2, mesh)}
    torch.cuda.empty_cache()
    out["dp-solve"] = _rank_dp_solve(torch, d, sig2, mesh)
    torch.cuda.empty_cache()
    out["grid-fft"] = _rank_grid_fft(torch, d, sig2, ("2d", "1d"))
    torch.cuda.empty_cache()
    out["mp"] = _rank_mp(torch, d, sig2, make_mesh(axis_names=("dp", "grid"),
                                                   shape=(1, PAR_RANKS)), ckpt_dir)
    out["nvcc"] = sorted(_build.LOGS)
    out["backend"] = torch.distributed.get_backend()
    return out


def nccl_rank(d, sig2, ckpt_dir):
    """The NCCL world of one: [main]'s epoch, the 2-D [grid-fft] case and
    [mp]'s steps on a (1, 1) mesh."""
    import torch

    from hipgp_tpu_torch import _build
    from hipgp_tpu_torch.parallel import make_mesh

    _rank_prelude(torch)
    out = {"collectives": _rank_collectives(torch),
           "dp": _rank_epoch(torch, d, sig2, make_mesh()),
           "grid-fft": _rank_grid_fft(torch, d, sig2, ("2d",))}
    torch.cuda.empty_cache()
    out["mp"] = _rank_mp(torch, d, sig2, make_mesh(axis_names=("dp", "grid"), shape=(1, 1)),
                         ckpt_dir)
    out["nvcc"] = sorted(_build.LOGS)
    out["backend"] = torch.distributed.get_backend()
    return out


def _launches_exact(tag, rank, r):
    st, lc = r["stats"], r["launches"]
    want_sd = st["solves"] + 2 * st["iterations"]
    log(f"[{tag}] rank {rank}: {st['solves']} PCG solves, {st['iterations']} iterations -> "
        f"expect {want_sd} self-dot and {st['solves']} R^T launches; counted "
        f"{lc['sandwich_apply_selfdot']} / {lc['sandwich_apply']}")
    check(lc["sandwich_apply_selfdot"] == want_sd, f"[{tag}] rank {rank} self-dot launches")
    check(lc["sandwich_apply"] == st["solves"], f"[{tag}] rank {rank} R^T launches")
    check(st["solves"] == 2 * r["steps"] + 1,
          f"[{tag}] rank {rank}: one solve per warm-start batch and step, one for rho")


def _check_epoch(tag, r, main, tol):
    """One rank's epoch against [main]'s: (theta gap, trace gap, rho gap, lr gap)."""
    import numpy as np
    import torch

    on = lambda a: torch.as_tensor(a, device=main["theta1"].device)
    gaps = (rel(on(r["theta1"]), main["theta1"]), rel(on(r["theta2"]), main["theta2"]),
            float(np.max(np.abs(r["trace"] - main["trace"]) / np.abs(main["trace"]))),
            abs(r["rho"] - main["rho"]) / abs(main["rho"]),
            abs(r["lr_used"] - main["lr_used"]) / abs(main["lr_used"]))
    names = ("theta1", "theta2", "ELBO trace", "rho", "lr used")
    for name, g in zip(names, gaps):
        check(g <= tol, f"[{tag}] {name} {g:.3e} from [main]'s (limit {tol:g})")
    return dict(zip(names, gaps))


def phase_parallel(torch, dev, d, sig2, main, main_step_ms):
    """[dp], [dp-solve], [grid-fft] (two gloo ranks on the card) and
    [dp-nccl] (a world of one over NCCL); returns the kernel-A launches of
    the three epochs, summed."""
    import numpy as np

    from hipgp_tpu_torch.experiments.run_synthetic import build_model
    from hipgp_tpu_torch.ops import mxu2d, radix_fft, solve
    from hipgp_tpu_torch.parallel import launch

    import tempfile

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    data = {k: d[k] for k in ("xobs", "yobs", "sobs", "xtest")}
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    ckpt_dirs = {w: os.path.join(ckpt_root, w) for w in ("gloo", "nccl")}
    gloo = launch.run(parallel_ranks, PAR_RANKS, backend="gloo", device="cuda",
                      args=(data, sig2, ckpt_dirs["gloo"]), timeout_s=PAR_TIMEOUT_S)
    t_gloo = time.perf_counter() - t0
    t1 = time.perf_counter()
    (nccl,) = launch.run(nccl_rank, 1, backend="nccl", device="cuda",
                         args=(data, sig2, ckpt_dirs["nccl"]), timeout_s=PAR_TIMEOUT_S)
    t_nccl = time.perf_counter() - t1
    for r in gloo + [nccl]:
        check(not r["nvcc"], f"a rank ran nvcc for {r['nvcc']}")
    check([r["backend"] for r in gloo] == ["gloo"] * PAR_RANKS and nccl["backend"] == "nccl",
          "the worlds' backends")
    log(f"[dp] {PAR_RANKS} gloo ranks on one card in {t_gloo:.2f} s, the NCCL world of "
        f"one in {t_nccl:.2f} s (each start included); no rank ran nvcc")
    for tag, r in (("gloo rank 0", gloo[0]), ("nccl", nccl)):
        c = r["collectives"]
        log(f"[dp] {tag}: all_reduce, all_to_all_single and all_gather took CUDA tensors "
            f"of {', '.join(c['took'])} and gave the right sums and pieces; "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in c["ms"].items()))

    # [dp]: [main]'s epoch, 128 rows a rank a step
    total = dict.fromkeys(("sandwich_apply_selfdot", "sandwich_apply"), 0)
    for rank, r in enumerate(gloo):
        rd = r["dp"]
        _launches_exact("dp", rank, rd)
        gaps = _check_epoch("dp", rd, main, DP_TOL)
        for k in total:
            total[k] += rd["launches"][k]
        log(f"[dp] rank {rank}: {rd['steps']} steps at {rd['step_ms']:.2f} ms a step "
            f"(against [main]'s {main_step_ms:.2f} ms in one process; two processes "
            f"time-share the card and gloo reduces through host memory: no speed-up is "
            f"claimed); all-reduced {rd['comm_step']['all_reduce']} bytes a step, "
            f"{rd['comm_fit']['all_reduce']} in the fit (warm start and rho included); "
            f"peak {rd['peak'] / 1e9:.3f} GB; rel gaps to [main] "
            + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    check(gloo[0]["dp"]["trace"].tolist() == gloo[1]["dp"]["trace"].tolist(),
          "[dp] the ranks' ELBO traces differ")

    # [dp-nccl]: a world of one over NCCL, expected bit-equal to [main]
    rn = nccl["dp"]
    _launches_exact("dp-nccl", 0, rn)
    gaps = _check_epoch("dp-nccl", rn, main, DP_NCCL_TOL)
    bit = (np.array_equal(rn["theta1"], main["theta1"].cpu().numpy())
           and np.array_equal(rn["theta2"], main["theta2"].cpu().numpy()))
    for k in total:
        total[k] += rn["launches"][k]
    log(f"[dp-nccl] world of one over NCCL: {rn['steps']} steps at {rn['step_ms']:.2f} ms "
        f"a step; theta bit-equal to [main]'s: {bit}; rel gaps "
        + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
        + f"; peak {rn['peak'] / 1e9:.3f} GB")

    # [dp-solve]: in float32 against the single-process dense solve on the
    # same rows; in float64 against the single-process float64 solve at the
    # ranks' micro-batch (each rank sweeps its own block of rows 1 000 at a
    # time: the same groups of rows as that solve)
    n = DP_SOLVE["rows"]
    refs = {}
    for dt, bsz in ((torch.float32, DP_SOLVE["batch_size"]),
                    (torch.float64, DP_SOLVE["batch_size"] // PAR_RANKS)):
        model = build_model("SqExp", DP_SOLVE["grid"], n, sig2, 0.05, 0.01, dtype=dt,
                            device=dev)
        torch.cuda.reset_peak_memory_stats()
        t2 = time.perf_counter()
        ref, ref_elbo = model.batch_solve(
            model.init_state(), d["xobs"][:n], d["yobs"][:n], d["sobs"][:n],
            batch_size=bsz, maxiter_cg=DP_SOLVE["maxiter_cg"],
            compute_elbo=True, mean_solver="dense")
        torch.cuda.synchronize()
        refs[dt] = (ref, float(ref_elbo), time.perf_counter() - t2,
                    torch.cuda.max_memory_allocated())
        del model
        torch.cuda.empty_cache()
    (ref, ref_elbo, ref_s, ref_peak) = refs[torch.float32]
    (ref64, ref64_elbo, ref64_s, _) = refs[torch.float64]
    single64 = rel(ref.theta1, ref64.theta1)
    for rank, r in enumerate(gloo):
        rs, r64 = r["dp-solve"]["float32"], r["dp-solve"]["float64"]
        t1 = torch.as_tensor(rs["theta1"], device=dev)
        e1 = rel(t1, ref.theta1)
        e2 = rel(torch.as_tensor(rs["theta2"], device=dev), ref.theta2)
        e64 = rel(t1, ref64.theta1)
        ee = abs(rs["elbo"] - ref_elbo) / abs(ref_elbo)
        f64 = {"theta1": rel(torch.as_tensor(r64["theta1"], device=dev), ref64.theta1),
               "theta2": rel(torch.as_tensor(r64["theta2"], device=dev), ref64.theta2),
               "ELBO": abs(r64["elbo"] - ref64_elbo) / abs(ref64_elbo)}
        log(f"[dp-solve] rank {rank} rows {r['dp-solve']['rows']} (pad rows "
            f"{r['dp-solve']['pad_rows']}): M' = {DP_SOLVE['grid'] * 2}^2, micro-batch "
            f"{DP_SOLVE['batch_size']}; float32 "
            + ", ".join(f"{k} {v:.3f} s" for k, v in rs["timings"].items())
            + f"; peak {rs['peak'] / 1e9:.3f} GB; against the single-process dense solve "
            f"({ref_s:.2f} s, peak {ref_peak / 1e9:.3f} GB): theta2 {e2:.3e}, ELBO "
            f"{ee:.3e} ({rs['elbo']:.6f} vs {ref_elbo:.6f}), theta1 {e1:.3e} (limit "
            f"{DP_SOLVE_F32_THETA1_TOL:g}); theta1 against float64 {e64:.3e}, the "
            f"single-process float32 solve's {single64:.3e}")
        log(f"[dp-solve] rank {rank} float64: "
            + ", ".join(f"{k} {v:.3f} s" for k, v in r64["timings"].items())
            + f"; peak {r64['peak'] / 1e9:.3f} GB; against the single-process float64 "
            f"dense solve at micro-batch {DP_SOLVE['batch_size'] // PAR_RANKS} "
            f"({ref64_s:.2f} s): "
            + ", ".join(f"{k} {v:.3e}" for k, v in f64.items())
            + f" (limit {DP_SOLVE_F64_TOL:g})")
        check(e2 <= DP_TOL, f"[dp-solve] rank {rank} theta2 gap {e2}")
        check(ee <= DP_SOLVE_ELBO_TOL, f"[dp-solve] rank {rank} ELBO gap {ee}")
        check(e1 <= DP_SOLVE_F32_THETA1_TOL, f"[dp-solve] rank {rank} float32 theta1 gap {e1}")
        for k, v in f64.items():
            check(v <= DP_SOLVE_F64_TOL, f"[dp-solve] rank {rank} float64 {k} gap {v}")
    check(gloo[-1]["dp-solve"]["pad_rows"] == 1, "[dp-solve] the pad row was not exercised")

    # [grid-fft]: against float64 and the single-device float32 kernel path
    for case in ("2d", "1d"):
        c = GRID_FFT[case]
        spec64, b64 = grid_fft_problem(torch, case, torch.float64, d, sig2)
        want = solve.gram_solve(spec64, b64, maxiter=c["iters"], tol=0.0, fixed_iters=True)
        del spec64, b64
        spec32, b32 = grid_fft_problem(torch, case, torch.float32, d, sig2)
        lc = dict(mxu2d.LAUNCHES) if case == "2d" else dict(radix_fft.LAUNCHES)
        run = lambda: solve.gram_solve(spec32, b32, maxiter=c["iters"], tol=0.0,
                                       fixed_iters=True)
        kern = run()
        moved = ({k: v - lc[k] for k, v in mxu2d.LAUNCHES.items()} if case == "2d"
                 else {k: v - lc[k] for k, v in radix_fft.LAUNCHES.items()})
        check(moved["sandwich_apply"] == 1 if case == "2d" else moved["middle"] > 0,
              f"[grid-fft] {case}: the float32 single-device solve took no kernel path")
        kern_ms = cuda_ms(torch, run, warmup=1, reps=3)
        worlds = [("gloo", g) for g in gloo] + ([("nccl", nccl)] if case == "2d" else [])
        got = torch.as_tensor(gloo[0]["grid-fft"][case]["kn"], device=dev)
        check(tuple(got.shape) == tuple(want.shape), f"[grid-fft] {case} shape {got.shape}")
        check(bool(torch.isfinite(got).all()), f"[grid-fft] {case} non-finite")
        e64, ek = rel(got, want), rel(got, kern)
        ek64 = rel(kern, want)
        check(e64 <= GRID_FFT_TOL, f"[grid-fft] {case} rel err vs float64 {e64}")
        log(f"[grid-fft] {case} ({tuple(spec32.dims)} -> {tuple(spec32.edims)}, "
            f"{c['rows']} rows, {c['iters']} iterations): sharded over {PAR_RANKS} gloo "
            f"ranks vs float64 plain {e64:.3e} (limit {GRID_FFT_TOL:g}), vs the float32 "
            f"kernel path {ek:.3e} (kernel path vs float64 {ek64:.3e}); "
            + "; ".join(f"{w} rank {i if w == 'gloo' else 0}: {r['grid-fft'][case]['ms']:.1f} "
                        f"ms a solve, {r['grid-fft'][case]['comm']['all_to_all']} bytes "
                        f"through all_to_all"
                        for i, (w, r) in enumerate(worlds))
            + f"; the single-device float32 kernel path {kern_ms:.3f} ms a solve")
        if case == "2d":
            gn = torch.as_tensor(nccl["grid-fft"]["2d"]["kn"], device=dev)
            en = rel(gn, want)
            check(en <= GRID_FFT_TOL, f"[grid-fft] 2d NCCL world of one vs float64 {en}")
            log(f"[grid-fft] 2d NCCL world of one vs float64 plain {en:.3e}, vs the gloo "
                f"ranks {rel(gn, got):.3e}")
        del got, want, kern, spec32, b32
        torch.cuda.empty_cache()
    log(f"[dp] kernel-A launches of the three epochs {total}; {time.perf_counter() - t0:.2f} s")
    t2 = time.perf_counter()
    try:
        _check_mp(torch, dev, d, sig2, gloo, nccl, ckpt_dirs)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    log(f"[mp] checked in {time.perf_counter() - t2:.2f} s")
    phase_mp_solve(torch, dev, d, sig2)
    return total


def _check_mp(torch, dev, d, sig2, gloo, nccl, ckpt_dirs):
    """[mp]: the split fit of each rank (two gloo ranks, the NCCL world of
    one) against the single-process fit of the same steps on the card (the
    kernel-A path), its predictions against the single-process predict of
    its own state, its checkpoint against a single-process checkpoint of
    the gathered state, one batch's hyper-gradients against float64."""
    import tempfile

    import numpy as np

    from hipgp_tpu_torch.infer import batch_predict, svigp_fit
    from hipgp_tpu_torch.ops import mxu2d
    from hipgp_tpu_torch.utils import checkpoint as ckpt

    n, b = MP["rows"], MP["batch_size"]
    rows = [d[k][:n] for k in ("xobs", "yobs", "sobs")]
    model = mp_model(torch, MAIN_GRID, n, sig2, PAR_RANKS, torch.float32)
    check(model.edims == (2 * MAIN_GRID, 2 * MAIN_GRID), f"[mp] embedded at {model.edims}")
    before = dict(mxu2d.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref, rep = svigp_fit(model, model.init_state(), *rows, mp_config(), verbose=False,
                         theta2_warmstart=True, natgrad_safe_lr="clamp")
    torch.cuda.synchronize()
    ref_s, ref_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    moved = {k: v - before[k] for k, v in mxu2d.LAUNCHES.items()}
    check(moved["sandwich_apply"] > 0, "[mp] the single-process fit took no kernel-A path")
    ref_step_ms = 1e3 * rep["epoch_times"][0] / rep["steps"]
    ref_trace = np.asarray(rep["elbo_trace"])
    on = lambda a: torch.as_tensor(a, device=dev)
    log(f"[mp] single-process reference on the card (kernel A): {rep['steps']} steps at "
        f"{ref_step_ms:.2f} ms a step, warm start {rep['warmstart_s']:.2f} s, rho "
        f"{rep['natgrad_rho']:.2f}, lr {rep['lr_used']:.4g}, peak {ref_peak / 1e9:.3f} GB; "
        f"{ref_s:.2f} s; kernel-A launches {moved}")
    worlds = [(f"gloo rank {i}", g["mp"]) for i, g in enumerate(gloo)] + [("nccl", nccl["mp"])]
    for tag, r in worlds:
        trace = np.asarray(r["trace"])
        check(r["steps"] == rep["steps"] and bool(np.isfinite(trace).all()),
              f"[mp] {tag}: {r['steps']} steps, finite trace")
        gaps = {"theta1": rel(on(r["theta1"]), ref.theta1),
                "theta2": rel(on(r["theta2"]), ref.theta2),
                "ELBO trace": float(np.max(np.abs(trace - ref_trace) / np.abs(ref_trace))),
                "rho": abs(r["rho"] - rep["natgrad_rho"]) / abs(rep["natgrad_rho"]),
                "lr used": abs(r["lr_used"] - rep["lr_used"]) / abs(rep["lr_used"])}
        for k, v in gaps.items():
            check(v <= MP_TOL, f"[mp] {tag} {k} {v:.3e} from the single-process fit "
                               f"(limit {MP_TOL:g})")
        log(f"[mp] {tag}: {r['steps']} steps at {r['step_ms']:.2f} ms a step a rank (warm "
            f"start {r['warmstart_s']:.2f} s, fit {r['fit_s']:.2f} s); a step's collectives: "
            f"{r['comm_step']['all_to_all']} bytes through all_to_all, "
            f"{r['comm_step']['all_reduce']} through all_reduce ({r['comm_fit']} in the fit); "
            f"peak {r['peak'] / 1e9:.3f} GB; rel gaps to the single-process fit "
            + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    check(list(gloo[0]["mp"]["trace"]) == list(gloo[1]["mp"]["trace"]),
          "[mp] the gloo ranks' ELBO traces differ")
    # the split predict against the single-process predict of the same state
    for tag, r in worlds[:1] + worlds[-1:]:
        st = ref.replace(theta1=on(r["theta1"]), theta2=on(r["theta2"]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mu, sig = batch_predict(model, st, d["xtest"][:MP["predict_rows"]],
                                batch_size=MP["predict_rows"], maxiter_cg=MP["predict_maxiter"])
        torch.cuda.synchronize()
        p_s = time.perf_counter() - t0
        emu, esig = rel(on(r["mu"]), mu), rel(on(r["sig"]), sig)
        check(emu <= MP_TOL and esig <= MP_TOL,
              f"[mp] {tag} predictions: mu {emu:.3e}, sigma {esig:.3e} (limit {MP_TOL:g})")
        log(f"[mp] {tag} mp_predict of {MP['predict_rows']} points, maxiter "
            f"{MP['predict_maxiter']}: {r['predict_s']:.2f} s (single process {p_s:.3f} s); "
            f"rel gaps mu {emu:.3e}, sigma {esig:.3e} (limit {MP_TOL:g})")
    # the checkpoint: rank 0 wrote the gathered state, as a single process
    # writes it
    for w, r in (("gloo", gloo[0]["mp"]), ("nccl", nccl["mp"])):
        path = os.path.join(ckpt_dirs[w], "state.npz")
        got = ckpt.load_pytree(path, ref)
        same = (np.array_equal(got.theta1.cpu().numpy(), r["theta1"])
                and np.array_equal(got.theta2.cpu().numpy(), r["theta2"]))
        with tempfile.TemporaryDirectory() as tmp:
            ckpt.save_checkpoint(tmp, got)
            single = ckpt.load_pytree(os.path.join(tmp, "state.npz"), ref)
        same_file = all(torch.equal(getattr(single, k), getattr(got, k))
                        for k in ("theta1", "theta2", "log_sig2", "log_ell", "log_noise2"))
        check(same and same_file, f"[mp] {w}: the checkpoint is not the gathered state")
        log(f"[mp] {w}: the checkpoint holds the whole state ({got.theta1.numel()} + "
            f"{got.theta2.numel()} entries), equal to the gathered state and to a "
            f"single-process checkpoint of it")
    # one batch's hyper-gradients against the float64 plain single-process step
    m64 = mp_model(torch, MAIN_GRID, n, sig2, PAR_RANKS, torch.float64)
    r = gloo[0]["mp"]
    st64 = m64.init_state().replace(theta1=on(r["theta1"]).double(),
                                    theta2=on(r["theta2"]).double())
    xb, yb, sb = (torch.as_tensor(a[:b]).to(dtype=torch.float64, device=dev) for a in rows)
    _, g64 = m64.elbo_and_grads(st64, xb, yb, sb, maxiter_cg=MP["maxiter_cg"],
                                compute_hyper_grads=True)
    # the per-point noise drives the likelihood: log_noise2 has no gradient
    check(r["hyper"]["log_noise2"] == 0.0 and float(g64.log_noise2) == 0.0,
          "[mp] a log_noise2 gradient under per-point noise")
    gaps = {k: abs(r["hyper"][k] - float(getattr(g64, k))) / abs(float(getattr(g64, k)))
            for k in ("log_sig2", "log_ell")}
    for k, v in gaps.items():
        check(v <= MP_GRAD_TOL, f"[mp] hyper-gradient {k} {v:.3e} from float64")
    log("[mp] one batch's float32 split hyper-gradients against the float64 plain "
        "single-process step: " + ", ".join(f"{k} {r['hyper'][k]:.6g} (rel {v:.3e})"
                                            for k, v in gaps.items())
        + f" (limit {MP_GRAD_TOL:g})")
    del m64, model


def phase_mp_solve(torch, dev, d, sig2):
    """[mp-solve]: a world of four gloo ranks on the card as a (2, 2) mesh,
    mp_batch_solve with 'cg', 'gram' and 'factored' against the
    single-process solve by the same solver at the same row groups and
    iterations (float64: limit 1e-8, the split sums exact; float32); the
    split spectrum against the whole one; 'factored' declining at 125^2."""
    import numpy as np

    from hipgp_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    c = MP_SOLVE
    data = {k: d[k] for k in ("xobs", "yobs", "sobs")}
    out = launch.run(mp_solve_ranks, c["ranks"], backend="gloo", device=CARD,
                     args=(data, sig2), timeout_s=PAR_TIMEOUT_S)
    t_world = time.perf_counter() - t0
    for r in out:
        check(not r["nvcc"] and r["backend"] == "gloo", "[mp-solve] a rank ran nvcc or not gloo")
    keys = [k for k in out[0] if "/" in k]
    for k in keys:
        check(len({r[k]["elbo"] for r in out}) == 1, f"[mp-solve] {k}: the ranks' ELBOs differ")
    log(f"[mp-solve] {c['ranks']} gloo ranks on one card as a (2, 2) ('dp', 'grid') mesh in "
        f"{t_world:.2f} s (start included)")
    n, on = c["rows"], (lambda a: torch.as_tensor(a, device=dev))
    rows = [d[k][:n] for k in ("xobs", "yobs", "sobs")]
    failed = []   # every reading is logged before a failed limit ends the run
    for dt in (torch.float64, torch.float32):
        name = str(dt).split(".")[-1]
        model = mp_model(torch, c["grid"], n, sig2, 2, dt)
        for solver in ("cg", "gram", "factored"):
            ref_solver = "dense" if solver == "cg" and dt == torch.float64 else solver
            mean = _mp_solve_mean(torch, dt, solver)
            jit = {"factor_jitter": c["factor_jitter"]} if solver == "factored" else {}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ref, ref_elbo = model.batch_solve(model.init_state(), *rows,
                                              batch_size=c["batch_size"] // 2,
                                              maxiter_cg=c["maxiter_cg"], compute_elbo=True,
                                              mean_solver=ref_solver, **mean, **jit)
            torch.cuda.synchronize()
            ref_s = time.perf_counter() - t1
            r = out[0][f"{name}/{solver}"]
            gaps = {"theta1": rel(on(r["theta1"]), ref.theta1),
                    "theta2": rel(on(r["theta2"]), ref.theta2),
                    "ELBO": abs(r["elbo"] - float(ref_elbo)) / abs(float(ref_elbo))}
            tol = ({k: MP_SOLVE_F64_TOL for k in gaps} if dt == torch.float64
                   else MP_SOLVE_F32_TOL)
            for k, v in gaps.items():
                if v > tol[k]:
                    failed.append(f"[mp-solve] {name} {solver} {k} {v:.3e} from the "
                                  f"single-process '{ref_solver}' (limit {tol[k]:g})")
            if r["warned"]:
                failed.append(f"[mp-solve] {name} {solver} warned {r['warned']}")
            log(f"[mp-solve] {name} '{solver}' at {c['grid']}^2 (M' = {model.Mprime}), {n} rows: "
                + "; ".join(f"rank {i} " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                                       o[f'{name}/{solver}']['timings'].items())
                            + f", peak {o[f'{name}/{solver}']['peak'] / 1e9:.3f} GB"
                            for i, o in enumerate(out))
                + f"; mean PCG {r['mean_iters']} iterations; against the single-process "
                f"'{ref_solver}' ({ref_s:.2f} s): "
                + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
                + f" (limits {tol})")
        del model
        torch.cuda.empty_cache()
    g, s = out[0]["float32/gram"], out[0]["float32/gram-sharded"]
    gaps = {"theta1": rel(on(s["theta1"]), on(g["theta1"])),
            "theta2": rel(on(s["theta2"]), on(g["theta2"])),
            "ELBO": abs(s["elbo"] - g["elbo"]) / abs(g["elbo"])}
    failed += [f"[mp-solve] sharded spectrum {k} {v:.3e} from host"
               for k, v in gaps.items() if v > MP_SOLVE_F32_TOL[k]]
    log("[mp-solve] float32 'gram' with spectrum_mode='sharded' against 'host': "
        + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    check(not failed, "; ".join(failed))
    f, g = out[0]["125/factored"], out[0]["125/gram"]
    check(len(f["warned"]) == 1 and "declined" in f["warned"][0]
          and "falling back" in f["warned"][0], f"[mp-solve] 125^2 'factored' warned {f['warned']}")
    check(np.array_equal(f["theta1"], g["theta1"]) and np.array_equal(f["theta2"], g["theta2"])
          and f["elbo"] == g["elbo"], "[mp-solve] 125^2: the declined 'factored' is not 'gram'")
    log(f"[mp-solve] float32 'factored' at {MAIN_GRID}^2 ({MP_SOLVE_125_ROWS} rows): "
        f"{f['warned'][0][:90]}...; its state and ELBO equal 'gram''s "
        f"(sweep {f['timings'].get('sweep', float('nan')):.2f} s, mean "
        f"{f['timings'].get('mean', float('nan')):.2f} s, peak {f['peak'] / 1e9:.3f} GB); "
        f"{time.perf_counter() - t0:.2f} s")


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
    from hipgp_tpu_torch.ops import bttb, mxu2d, mxu3d, solve

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
        ("sandwich_apply", 256, torch.sqrt(wK).contiguous(), "R^T pullback"),
        # [full-batch]'s one batch of 20 000 rows (checked, not timed)
        ("sandwich_apply_selfdot", 20_000, wK, "full-batch PCG apply, w = wK"),
        ("sandwich_apply", 20_000, torch.sqrt(wK).contiguous(), "full-batch R^T"),
    ]
    for name, B, w, label in cases:
        selfdot = name == "sandwich_apply_selfdot"
        # R^T: cropped in, expanded out; its pullback (the training step's
        # backward): expanded in, cropped out
        in_exp = label == "R^T pullback"
        out_exp = not selfdot and not in_exp
        first = B == 256 and name not in results   # the natgrad-step shape
        r = phase_kernel_a_case(torch, dev, mxu2d, gen, name, B, w, label, dims, edims,
                                in_exp, out_exp, timed=B <= 2000, with_library=first)
        if first:
            results[name] = r
    # the largest embedding kernel A takes: M = 256^2 through (512, 512), where
    # the dense kernel's slab did not fit a block for an expanded input
    m512 = build_model("SqExp", 256, len(d["xobs"]), sig2, 0.05, 0.01,
                       dtype=torch.float32, device=dev)
    s512 = m512.spectrum(m512.init_state())
    w512 = bttb._full_weights(s512.eigs, s512.edims[-1]).contiguous()
    check(s512.edims == (512, 512), f"M = 256^2 embeds at {s512.edims}")
    for name, in_exp, label in (("sandwich_apply_selfdot", False, "(512, 512) PCG apply"),
                                ("sandwich_apply", True, "(512, 512) R^T pullback")):
        phase_kernel_a_case(torch, dev, mxu2d, gen, name, 64, w512, label, s512.dims,
                            s512.edims, in_exp, False, timed=False)
    results["B-8"] = phase_kernels_b8(torch, dev, wK, edims, gen)
    results.update(phase_kernels_factored(torch, dev, mxu2d, gen, d))
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
    # the warm start also enables the step-size estimate (natgrad_safe_lr,
    # 'warn' by default): one more whitening, of the first batch
    check(fit_stats["solves"] == 2 * steps + 1,
          "one solve per warm-start batch and per step, and one for rho")
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
        f"plain path rel err {err:.3e}")
    check(err <= 5e-3, f"whiten rel err {err}")
    # the same whitening with USE_MXU2D_PCG off and USE_PALLAS_TRANSFORM on:
    # the generic PCG, every apply and the R^T through B-8 (10 fixed
    # iterations: 2k + 1 applies and one R^T)
    from hipgp_tpu_torch.ops import pallas_transform

    kn64f = solve.whiten(m64.spectrum(s64), knm64, maxiter=10, tol=0.0, fixed_iters=True)
    saved = bttb.USE_MXU2D_PCG, bttb.USE_PALLAS_TRANSFORM
    bttb.USE_MXU2D_PCG, bttb.USE_PALLAS_TRANSFORM = False, True
    before = {**mxu2d.LAUNCHES, **pallas_transform.LAUNCHES}
    try:
        kn_b8 = solve.whiten(spec, knm32, maxiter=10, tol=0.0, fixed_iters=True)
    finally:
        bttb.USE_MXU2D_PCG, bttb.USE_PALLAS_TRANSFORM = saved
    torch.cuda.synchronize()
    moved = {n: v - before[n] for n, v in {**mxu2d.LAUNCHES,
                                            **pallas_transform.LAUNCHES}.items()
             if v != before[n]}
    check(moved == {"circulant_apply_2d": 2 * 10 + 2},
          f"the B-8 whitening launched {moved}, expected 22 B-8 launches only")
    err_b8 = rel(kn_b8, kn64f)
    log(f"[accuracy] the same whitening through the generic PCG over B-8 "
        f"(USE_MXU2D_PCG off, USE_PALLAS_TRANSFORM on), 10 fixed iterations: rel err "
        f"vs f64 plain path {err_b8:.3e}; launches {moved}; "
        f"{time.perf_counter() - t0:.2f} s")
    check(err_b8 <= 5e-3, f"B-8 whiten rel err {err_b8}")

    # ---- the parallel phases: ranks on the one card ------------------------------
    dp_launches = phase_parallel(
        torch, dev, d, sig2, {"theta1": state.theta1, "theta2": state.theta2,
                              "trace": trace, "rho": report["natgrad_rho"],
                              "lr_used": report["lr_used"]}, step_s * 1e3)

    # ---- the training step -------------------------------------------------------
    state_tr, train_launches = phase_train(torch, d, model, state0, step_s * 1e3)
    b8_launches = phase_train_grad(torch, dev, d, model, m64, state_tr)
    resume_launches = phase_resume(torch, d, model, state0)

    # ---- the closed-form full-batch fit ----------------------------------------
    fb_launches = phase_full_batch(torch, d, model, state0)
    gram_64 = phase_accuracy_full_batch(torch, dev, d)
    fbf_launches = phase_full_batch_factored(torch, dev, d, gram_64)
    del gram_64

    # ---- the block-diagonal and full-rank families (2-D) -----------------------
    block_launches = phase_main_block(torch, dev, d, sig2, step_s * 1e3)
    fr_launches = phase_full_rank(torch, dev, d, sig2)
    torch.cuda.empty_cache()

    # ---- 5.-7. the 1-D long-axis path ----------------------------------------
    radix_results = phase_kernels_1d(torch, dev)
    radix_launches = phase_main_1d(torch)
    phase_accuracy_1d(torch, dev)
    _, state_1d, train_1d_launches = phase_train_1d(torch, dev)
    phase_train_grad_1d(torch, dev, state_1d)
    del state_1d
    torch.cuda.empty_cache()

    # ---- the section 5.1 and appendix C.1 solver studies ----------------------
    study_radix = phase_solve_kn(torch)
    for k, v in phase_precond(torch).items():
        study_radix[k] += v

    # ---- 8.-10. the 3-D dust map ----------------------------------------------
    results_3d = phase_kernels_3d(torch, dev)
    launches_3d = phase_main_3d(torch)
    phase_accuracy_3d(torch, dev)
    fb3_launches, fb3_mf = phase_full_batch_3d(torch)
    phase_accuracy_full_batch_3d(torch, dev)
    torch.cuda.empty_cache()
    fb3_block_launches = phase_full_batch_3d_block(torch, dev, fb3_mf)
    del fb3_mf
    phase_accuracy_full_batch_3d_block(torch, dev)
    torch.cuda.empty_cache()
    state_3d, train_3d_launches = phase_train_3d(torch, dev)
    phase_train_grad_3d(torch, dev, state_3d)
    del state_3d
    torch.cuda.empty_cache()
    phase_deposit(torch)

    # ---- the dense SVGP, the derivative GP, the studies, the support modules --
    torch.cuda.empty_cache()
    phase_svgp(torch, d)
    torch.cuda.empty_cache()
    phase_derivative(torch)
    traj_launches = phase_trajectory(torch)
    precision_launches = phase_precision(torch)
    uci_launches = phase_uci(torch)
    phase_demo_1d(torch)
    phase_trace(torch, d, model, state0, step_s * 1e3)

    kernels = []
    for name in ("sandwich_apply_selfdot", "sandwich_apply"):
        r = results[name]
        # the main path's launches: [main], [main-block], [full-rank],
        # [resume]'s resumed epoch, [trajectory]'s paper-scale torch leg,
        # [uci], [precision]'s kernel-A policy and the ranks' epochs of [dp]
        # and [dp-nccl]
        n = (launches[name] + block_launches[name] + fr_launches[name]
             + resume_launches[name] + traj_launches[name] + uci_launches[name]
             + precision_launches.get(name, 0) + dp_launches[name])
        kernels.append({
            "name": f"mxu2d.{name}", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": TPU_KERNEL, "launches": n,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
        check(launches[name] > 0, f"{name} never launched on the main path")
        check(block_launches[name] > 0 and fr_launches[name] > 0,
              f"{name} never launched on the block or full-rank path")
        check(dp_launches[name] > 0, f"{name} never launched on the data-parallel path")
    for name in ("stage1", "stage1_inv_dot", "middle"):
        r = radix_results[name]
        # the 1-D main path's launches: [main-1d], the solver studies and
        # [precision]'s radix policy
        kernels.append({
            "name": f"radix_fft.{name}", "route": "cuda", "source": RADIX_SOURCE,
            "replaces": RADIX_TPU_KERNELS[name],
            "launches": radix_launches[name] + study_radix[name]
            + precision_launches.get(name, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], **{k: r[k] for k in GRAPH_KEYS},
        })
        check(radix_launches[name] > 0, f"{name} never launched on the 1-D main path")
    # B-4's weight cotangent: its launches on the 1-D training path [train-1d]
    r = radix_results["middle_wgrad"]
    kernels.append({
        "name": "radix_fft.middle_wgrad", "route": "cuda", "source": RADIX_SOURCE,
        "replaces": RADIX_TPU_KERNELS["middle"], "launches": train_1d_launches["middle_wgrad"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], **{k: r[k] for k in GRAPH_KEYS},
    })
    for name in ("stage1", "stage1_inv_dot", "middle", "middle_wgrad"):
        check(train_1d_launches[name] > 0, f"{name} never launched on the 1-D training path")
    for key, name, source, tpu, counts in (
            ("B-5", "mxu2d.sandwich_apply_wp", WP_SOURCE, WP_TPU_KERNEL,
             ("sandwich_apply_wp", "sandwich_apply_wp_selfdot")),
            ("B-6", "mxu3d.sandwich_apply_wp3", WP3_SOURCE, WP3_TPU_KERNEL,
             ("sandwich_apply_wp3",))):
        r = results_3d[key]
        # the 3-D main path's launches: [main-3d] and [full-batch-3d-block]
        n = sum(launches_3d[c] + fb3_block_launches[c] for c in counts)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": tpu,
            "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
        # B-6 is on the main path only where USE_WP3 selects it for the PCG
        # applies (set by the B-6 / B-5-pipeline measurement of [kernels-3d])
        if key == "B-5" or mxu3d.USE_WP3:
            check(n > 0, f"{name} never launched on the 3-D main path")
    # B-5's backward (its launch at the R^T's swapped crops, the pullback):
    # its launches on the 3-D training path [train-3d]
    r = results_3d["B-5 backward"]
    n = train_3d_launches["B-5 backward"]
    kernels.append({
        "name": "mxu2d.sandwich_apply_wp.backward", "route": "cuda", "source": WP_SOURCE,
        "replaces": WP_TPU_KERNEL, "launches": n, "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    })
    check(n > 0, "B-5's backward never launched on the 3-D training path")
    r = radix_results["middle_dual"]
    kernels.append({
        "name": "radix_fft.middle_dual", "route": "cuda", "source": RADIX_SOURCE,
        "replaces": DUAL_TPU_KERNEL, "launches": radix_launches["middle_dual"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        **{k: r[k] for k in GRAPH_KEYS},
    })
    # B-7 is on no solver path, as in the JAX package: [kernels-1d] holds it
    r = results["B-8"]
    kernels.append({
        "name": "pallas_transform.circulant_apply_2d", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": B8_TPU_KERNEL,
        "launches": b8_launches + precision_launches.get("circulant_apply_2d", 0),
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    })
    # B-8's launches: the training step of [train-grad] with USE_PALLAS_TRANSFORM
    # on, and [precision]'s B-8 policy
    check(b8_launches > 0, "B-8 never launched on the training path")
    check(precision_launches.get("circulant_apply_2d", 0) > 0,
          "B-8 never launched in the precision study")
    for name in ("sandwich_apply_selfdot", "sandwich_apply"):
        check(traj_launches[name] > 0, f"{name} never launched in [trajectory]")
    for name in ("sandwich_apply_selfdot", "sandwich_apply"):
        check(fb_launches[name] > 0, f"{name} never launched on the full-batch path")
        # kernel A at the 'factored' g-stage's shape: its launches in
        # [full-batch-factored]'s fit, which whitens nothing but the factor
        r = results[f"factored {name}"]
        kernels.append({
            "name": f"mxu2d.{name}[factored g-stage]", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": fbf_launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
        check(fbf_launches[name] > 0, f"{name} never launched on the factored path")
    for name in ("sandwich_apply_wp", "sandwich_apply_wp3" if mxu3d.USE_WP3
                 else "sandwich_apply_wp_selfdot"):
        check(fb3_launches[name] > 0, f"{name} never launched on the 3-D full-batch path")
        check(fb3_block_launches[name] > 0,
              f"{name} never launched on the 3-D block full-batch path")
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
