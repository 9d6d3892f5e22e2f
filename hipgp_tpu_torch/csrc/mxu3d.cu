// Kernel B-6: the whole cropped 3-D real-Fourier sandwich of one sample in one
// launch, hand-written for Hopper (sm_90a) as a cluster-resident FFT sandwich.
//
// Replaces the Pallas TPU kernel hipgp_tpu/ops/mxu3d.py:_make_kernel_wp3
// (launched in `_get_wp3` at its pl.pallas_call).  For every sample b of a
// (B, d0, d1, d2) stack it computes
//
//     y[b] = P (Q0 x Q1 x Q2) diag(w) (Q0 x Q1 x Q2)^T P^T x[b]
//
// cropped in and out (the PCG apply), with w the (W, L1, L2) spectrum in the
// same axis order (any w, even or not: the weighting below is the real
// basis's), and, when `dots` is given, dots[b] = <x[b], y[b]>.
//
// Bound on this card.  At the 3-D main path's shape, (512, 32, 64, 64)
// through a (64, 128, 128) embedding, the pruned FFT formulation is 31.3 GFLOP
// (0.467 ms at the 67 TFLOP/s FP32 peak) against 0.54 GB of x, y and w (0.16
// ms at 3.35 TB/s): bound by operations.  This kernel's own count, at 5 n
// log2 n a complex n-point FFT, is 34.3 GFLOP, 1.10 times the bound's (the
// row passes 4.7, the column slabs 25.5, the weighting 3.9 at 56 operations
// a group of four positions; the pruned halves of the first and last steps
// not subtracted).  The dense real-DFT contractions it replaces did 206
// GFLOP.
//
// What the design does about it.  The TPU kernel holds a sample's embedded
// volume in VMEM.  Here one sample lives in the shared memory of a thread-
// block cluster of CL = 8 CTAs (one per SM): after the minor-axis real FFT its
// half spectrum is d0 x d1 x L2/2 complex values (1 MiB at the main path),
// and CTA r holds the planes j0 in [r P, r P + P), P = ceil(d0 / 8) (128 KiB).
// A persistent grid of clusters walks the batch, one sample per cluster at a
// time, in three phases with a cluster barrier between them:
//   1. row pass, on the CTA's own planes: two real rows of x as one complex
//      row, its L2-point DFT (the first step reads x and skips the zero upper
//      half), and the split into the two rows' half spectra by units that hold
//      both k and L2 - k in registers; bins 0 and L2/2 (both real) share
//      packed column 0, so the half spectrum is L2/2 columns;
//   2. column slabs: every packed column c is a 2-D problem over (j0, j1).
//      CTA r owns the columns [r L2/16, (r + 1) L2/16).  For each, the first
//      L1 step gathers the column's d0 x d1 slab from the eight CTAs over
//      distributed shared memory (cluster.map_shared_rank) into the local
//      working buffer; then the L1 steps, the W steps, the weighting, the
//      inverse W steps and the inverse L1 steps, whose last writes the
//      cropped slab back in place, over distributed shared memory.  A slab
//      enters the buffer's upper W/2 rows and leaves from its lower ones, so
//      half of the threads scatter one column while the other half gather
//      the next, in one phase.  The weighting needs only the slab: for each group (g0 <= W/2, g1 <= L1/2)
//      the Hermitian partner (-k0, -k1) separates the minor axis's cosine
//      and sine parts, the mirror pair (k0, -k1) each part's cc, ss, sc and
//      cs terms, and each is weighed by w at its real-basis index;
//   3. row pass back, on the CTA's own planes: each complex row's spectrum
//      read from the two half spectra, its inverse DFT, the real part to one
//      row of y and the imaginary part to the other, the self-dot summed as
//      y is written; the eight CTAs' partial dots summed in rank order by
//      rank 0 over distributed shared memory (no atomics, no second launch:
//      a repeated call is bit-equal).
// No intermediate goes through device memory: the kernel reads x and the
// weights and writes y and the dots.  A small first launch lays w out group
// by group, the eight weights of each group of four mirror positions (their
// cosine and sine parts) in one 32-byte record with 1 / (4 W L1 L2) folded in (a
// power of two: exact), so that each slab reads its 67 KiB of weights in one
// run from L2.
//
// Every n-point DFT is two register-radix steps (Rad<n>: 128 = 16 x 8,
// 64 = 8 x 8, 32 = 8 x 4, 16 = 4 x 4; csrc/fft_steps.cuh), in place, with one
// shared-memory exchange and one barrier between them: the forward steps
// leave frequency k1 + R1 k2 at position k1 R2 + k2, the inverse steps run
// mirrored from there back to natural order, so no reordering pass exists.
// Each axis's data is at most half its embedded length (the wrapper's gate),
// so every first forward step reads R1/2 inputs and every last inverse step
// forms R1/2 outputs.  The twiddles e^{-2 pi i m / L} come from float64
// tables the wrapper builds (`mxu3d._wp3_tables`), copied once a launch into
// shared memory as [a][k] tables of the second steps; no sincosf, no fast
// math.  Rows of the working buffer carry a pad after every 16 values and a
// stride of 8 mod 16 (float2), columns of the half spectrum a stride of 2 mod
// 16, so the steps' shared-memory accesses are free of bank conflicts (the
// weighting's scattered mirror positions are not: 1.6 times the ideal
// wavefronts).  On an NVIDIA H100 80GB HBM3 at 700 W the kernel runs at ~18 %
// of its bound; its
// phases' clocks are `experiments/profile_wp3_phases.py`'s.  All
// arithmetic is FP32 FMA on the CUDA cores.  The numpy model of these passes
// is tests/test_torch_wp3_plan.py.
//
// Interface: plain C, returns the cudaError_t of the first failing call (0 on
// success).  Launches on `stream` with cudaLaunchKernelEx and a cluster
// dimension of CL, never synchronises, allocates nothing: the caller passes
// the output, the dots and the laid-out weights' buffer.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

#include "fft_steps.cuh"

constexpr int CL = 8;             // CTAs of a cluster (portable size)
constexpr int NT = 512;           // threads of a CTA
constexpr int SMEM_MAX = 232448;  // shared memory a block may use (sm_90)

// The two register-radix steps of an L-point DFT, L = R1 * R2.
template <int L> struct Rad;
template <> struct Rad<16> { static constexpr int R1 = 4, R2 = 4; };
template <> struct Rad<32> { static constexpr int R1 = 8, R2 = 4; };
template <> struct Rad<64> { static constexpr int R1 = 8, R2 = 8; };
template <> struct Rad<128> { static constexpr int R1 = 16, R2 = 8; };

// The embeddings (W, L1, L2) the kernel is built for (`mxu3d._WP3_SHAPES`).
#define WP3_FOR_EACH_SHAPE(X) X(64, 128, 128) X(64, 64, 128) X(32, 64, 64) X(16, 32, 32)

// Float2 stride of one packed column of the half spectrum (2 mod 16).
__host__ __device__ constexpr int col_stride(int rows) { return rows + (18 - rows % 16) % 16; }
// Float2 stride of one working-buffer row of L values (a pad after every 16;
// 8 mod 16).
__host__ __device__ constexpr int row_stride(int L) { return L + L / 16 + (24 - (L + L / 16) % 16) % 16; }
// Dynamic shared memory of a CTA: its L2/2 columns of ceil(d0 / CL) planes of
// d1 rows, the working buffer of one (W, L1) slab, and the three axes'
// twiddle tables (`mxu3d._wp3_smem_bytes`).
__host__ __device__ constexpr size_t smem_bytes(int d0, int d1, int W, int L1, int L2) {
  return 8 * ((size_t)(L2 / 2) * col_stride((d0 + CL - 1) / CL * d1) + (size_t)W * row_stride(L1) + W + L1 + L2);
}

// Groups of four mirror positions of one (W, L1) slab: (g0 <= W/2, g1 <= L1/2).
template <int W, int L1>
__host__ __device__ constexpr int groups() { return (W / 2 + 1) * (L1 / 2 + 1); }
// Group e's (g0, g1): first the rows g0 of g1 < L1/2, then g1 = L1/2, so that
// 16 consecutive groups share g0 and run over 16 aligned g1 (their positions
// then lie in distinct banks).
template <int W, int L1>
__host__ __device__ __forceinline__ void group_of(int e, int& g0, int& g1) {
  constexpr int H = L1 / 2, HEAD = (W / 2 + 1) * H;
  g0 = e < HEAD ? e / H : e - HEAD;
  g1 = e < HEAD ? e % H : H;
}

#ifdef WP3_PHASE_CLOCKS
// Per-phase clocks for experiments/profile_wp3_phases.py, built only with
// -DWP3_PHASE_CLOCKS (the kernel's own build has no marks): thread 0 of each
// CTA adds the clocks since its last mark to phase i.
__device__ unsigned long long wp3_phase_clocks[16];
#define PHASE_START() unsigned long long phase_t0 = clock64()
#define PHASE_RESET() phase_t0 = clock64()
#define PHASE(i)                                                       \
  do {                                                                 \
    if (threadIdx.x == 0) {                                            \
      const unsigned long long phase_t = clock64();                    \
      atomicAdd(&wp3_phase_clocks[i], phase_t - phase_t0);             \
      phase_t0 = phase_t;                                              \
    }                                                                  \
  } while (0)
#else
#define PHASE_START()
#define PHASE_RESET()
#define PHASE(i)
#endif

// Position of element p of a working-buffer row (one pad every 16).
__device__ __forceinline__ int phys(int p) { return p + (p >> 4); }
// Position of frequency k after the forward steps of an L-point DFT.
template <int L>
__device__ __forceinline__ int spos(int k) {
  return (k % Rad<L>::R1) * Rad<L>::R2 + k / Rad<L>::R1;
}

struct Args {
  const float* x;
  const float4* wq;   // (L2/2, groups, 2) weights of the groups, scale folded in
  const float2* tw;   // twiddles of W, then L1, then L2
  float* y;
  float* dots;
  int B, d0, d1, d2;
};

// The twiddles of an L-point DFT's second steps as a shared-memory table,
// T[a R1 + k] = tw[a k] = e^{-2 pi i a k / L} (a < R2, k < R1): threads that
// run consecutive k read consecutive entries, threads with one k the same.
template <int L>
__device__ void load_twiddles(float2* T, const float2* __restrict__ tw) {
  constexpr int R1 = Rad<L>::R1;
  for (int e = threadIdx.x; e < L; e += NT) T[e] = __ldg(tw + (e / R1) * (e % R1));
}

// Half spectra of row a and row b from bin k of a complex row's spectrum
// (z) and bin L - k (zr): A = (Z_k + conj Z_{L-k}) / 2, B = (Z_k - conj
// Z_{L-k}) / (2i).
__device__ __forceinline__ void split(float2 z, float2 zr, float2* col, int ra, int rb, bool hb) {
  col[ra] = make_float2(0.5f * (z.x + zr.x), 0.5f * (z.y - zr.y));
  if (hb) col[rb] = make_float2(0.5f * (z.y + zr.y), 0.5f * (zr.x - z.x));
}

// The inputs of the forward row pass's step 1 for the round at q0, a
// thread's IA items: x at a1 + R2 b, b < R1/2, of rows q0 + q (real part)
// and q0 + q + npr (imaginary part).
template <int L, int IA>
__device__ __forceinline__ void load_rows(float2 (&xin)[IA][Rad<L>::R1 / 2],
                                          const float* __restrict__ xb, int q0, int nq, int nr,
                                          int npr, int d2) {
  constexpr int R1 = Rad<L>::R1, R2 = Rad<L>::R2;
#pragma unroll
  for (int i = 0; i < IA; ++i) {
    const int e = threadIdx.x + i * NT;
    const int ra = q0 + e / R2, rb = ra + npr, a1 = e % R2;
#pragma unroll
    for (int b = 0; b < R1 / 2; ++b) {
      const int n = a1 + R2 * b;
      const bool in = e < nq * R2 && n < d2;
      xin[i][b] = make_float2(in ? __ldg(xb + (size_t)ra * d2 + n) : 0.f,
                              in && rb < nr ? __ldg(xb + (size_t)rb * d2 + n) : 0.f);
    }
  }
}

// 1. The row pass over the CTA's nr real rows of xb (d2 values each): rows
// q and q + npr as one complex row, its forward L-point DFT, the split into
// S (L/2 packed columns of stride CS).  Rounds of CAP complex rows through
// the working buffer; the next round's x is loaded while step 2 runs.
template <int L, int CAP>
__device__ void row_forward(const float* __restrict__ xb, float2* S, float2* buf, int CS,
                            int nr, int npr, int d2, const float2* tw) {
  constexpr int R1 = Rad<L>::R1, R2 = Rad<L>::R2, SL = row_stride(L);
  constexpr int IA = (CAP * R2 + NT - 1) / NT;   // step-1 items a thread
  float2 xin[IA][R1 / 2];
  load_rows<L, IA>(xin, xb, 0, min(CAP, npr), nr, npr, d2);
  for (int q0 = 0; q0 < npr; q0 += CAP) {
    const int nq = min(CAP, npr - q0);
    // step 1: items (q, a1), the inputs a1 + R2 b, b < R1/2, into k1
#pragma unroll
    for (int i = 0; i < IA; ++i) {
      const int e = threadIdx.x + i * NT;
      if (e >= nq * R2) break;
      const int q = e / R2, a1 = e % R2;
      float2 v[R1];
#pragma unroll
      for (int b = 0; b < R1; ++b) v[b] = b < R1 / 2 ? xin[i][b] : make_float2(0.f, 0.f);
      dft<R1, -1, true>(v);
      float2* row = buf + q * SL;
#pragma unroll
      for (int k1 = 0; k1 < R1; ++k1) row[phys(a1 + R2 * k1)] = v[k1];
    }
    __syncthreads();
    if (q0 + CAP < npr) load_rows<L, IA>(xin, xb, q0 + CAP, min(CAP, npr - q0 - CAP), nr, npr, d2);
    // step 2 and the split: unit u holds items u and R1 - u (unit 0: 0 and
    // R1/2), whose frequencies k1 + R1 k2 are closed under k -> L - k
    for (int e = threadIdx.x; e < nq * (R1 / 2); e += NT) {
      const int q = e / (R1 / 2), u = e % (R1 / 2);
      const int ra = q0 + q, rb = ra + npr;
      const bool hb = rb < nr;
      const int kA = u, kB = u ? R1 - u : R1 / 2;
      const float2* row = buf + q * SL;
      float2 zA[R2], zB[R2];
#pragma unroll
      for (int a = 0; a < R2; ++a) {
        zA[a] = cmul(row[phys(R2 * kA + a)], tw[a * R1 + kA]);
        zB[a] = cmul(row[phys(R2 * kB + a)], tw[a * R1 + kB]);
      }
      dft<R2, -1>(zA);
      dft<R2, -1>(zB);
      if (u) {
#pragma unroll
        for (int k2 = 0; k2 < R2 / 2; ++k2) {
          split(zA[k2], zB[R2 - 1 - k2], S + (size_t)(u + R1 * k2) * CS, ra, rb, hb);
          split(zB[k2], zA[R2 - 1 - k2], S + (size_t)(R1 - u + R1 * k2) * CS, ra, rb, hb);
        }
      } else {
        // bins 0 and L/2 into column 0: (A_0, A_{L/2}) and (B_0, B_{L/2})
        const float2 z0 = zA[0], zn = zA[R2 / 2];
        S[ra] = make_float2(z0.x, zn.x);
        if (hb) S[rb] = make_float2(z0.y, zn.y);
#pragma unroll
        for (int k2 = 1; k2 < R2 / 2; ++k2)
          split(zA[k2], zA[R2 - k2], S + (size_t)(R1 * k2) * CS, ra, rb, hb);
#pragma unroll
        for (int k2 = 0; k2 < R2 / 2; ++k2)
          split(zB[k2], zB[R2 - 1 - k2], S + (size_t)(R1 / 2 + R1 * k2) * CS, ra, rb, hb);
      }
    }
    __syncthreads();
  }
}

// 2. The packed columns.  S is this CTA's half spectrum (the peers' are
// reached through the cluster).  A column's slab enters the working buffer
// in its upper W/2 rows (gather) and leaves from its lower W/2 rows
// (scatter), so the scatter of one column and the gather of the next run in
// one phase on two halves of the threads, t0 + [0, nt).
//
// The gather, the forward L1 step 1: items (j0, a1), the slab's j1 = a1 +
// RA2 b read from the CTA that holds plane j0, into row W/2 + j0.
template <int W, int L1>
__device__ void gather(const cg::cluster_group& cluster, int c, const float2* S, float2* buf,
                       int CS, int P, int d0, int d1, int t0, int nt) {
  constexpr int RA1 = Rad<L1>::R1, RA2 = Rad<L1>::R2, SL = row_stride(L1);
  for (int e = threadIdx.x - t0; e < d0 * RA2; e += nt) {
    const int j0 = e / RA2, a1 = e % RA2;
    const float2* src = cluster.map_shared_rank(S, j0 / P) + (size_t)c * CS + (j0 % P) * d1;
    float2 v[RA1];
#pragma unroll
    for (int b = 0; b < RA1; ++b) v[b] = make_float2(0.f, 0.f);
#pragma unroll
    for (int b = 0; b < RA1 / 2; ++b) {
      const int j1 = a1 + RA2 * b;
      if (j1 < d1) v[b] = src[j1];
    }
    dft<RA1, -1, true>(v);
    float2* row = buf + (W / 2 + j0) * SL;
#pragma unroll
    for (int k1 = 0; k1 < RA1; ++k1) row[phys(a1 + RA2 * k1)] = v[k1];
  }
}

// The scatter, the inverse L1 step B: items (j0, a1), j1 = a1 + RA2 b < d1
// from row j0 written back to the CTA that holds plane j0.
template <int W, int L1>
__device__ void scatter(const cg::cluster_group& cluster, int c, float2* S, const float2* buf,
                        int CS, int P, int d0, int d1, int t0, int nt) {
  constexpr int RA1 = Rad<L1>::R1, RA2 = Rad<L1>::R2, SL = row_stride(L1);
  for (int e = threadIdx.x - t0; e < d0 * RA2; e += nt) {
    const int j0 = e / RA2, a1 = e % RA2;
    const float2* row = buf + j0 * SL;
    float2 v[RA1];
#pragma unroll
    for (int k = 0; k < RA1; ++k) v[k] = row[phys(a1 + RA2 * k)];
    dft<RA1, 1>(v);
    float2* dst = cluster.map_shared_rank(S, j0 / P) + (size_t)c * CS + (j0 % P) * d1;
#pragma unroll
    for (int b = 0; b < RA1 / 2; ++b) {
      const int j1 = a1 + RA2 * b;
      if (j1 < d1) dst[j1] = v[b];
    }
  }
}

// Between them, the rest of the column's 2-D problem: the L1 and W forward
// steps, the weighting (wc: the column's weights, two float4 a group), the inverse W
// steps and the inverse L1 step A; a barrier after each.
template <int W, int L1>
__device__ void transform(float2* buf, int d0, const float2* twW, const float2* twA,
                          const float4* __restrict__ wc) {
  PHASE_START();
  constexpr int RA1 = Rad<L1>::R1, RA2 = Rad<L1>::R2, RW1 = Rad<W>::R1, RW2 = Rad<W>::R2;
  constexpr int SL = row_stride(L1);
  // forward L1 step 2: items (j0, k), block k times W_L1^{a k}
  for (int e = threadIdx.x; e < d0 * RA1; e += NT) {
    const int j0 = e / RA1, k = e % RA1;
    float2* row = buf + (W / 2 + j0) * SL;
    float2 v[RA2];
#pragma unroll
    for (int a = 0; a < RA2; ++a) v[a] = cmul(row[phys(RA2 * k + a)], twA[a * RA1 + k]);
    dft<RA2, -1>(v);
#pragma unroll
    for (int a = 0; a < RA2; ++a) row[phys(RA2 * k + a)] = v[a];
  }
  __syncthreads();
  PHASE(3);
  // forward W step 1: items (p1, a0), the rows j0 = a0 + RW2 b < d0 (held
  // in rows W/2 + j0, the upper half of the same residue class)
  for (int e = threadIdx.x; e < L1 * RW2; e += NT) {
    const int a0 = e / L1, col = phys(e % L1);
    float2 v[RW1];
#pragma unroll
    for (int b = 0; b < RW1; ++b) v[b] = make_float2(0.f, 0.f);
#pragma unroll
    for (int b = 0; b < RW1 / 2; ++b) {
      const int j0 = a0 + RW2 * b;
      if (j0 < d0) v[b] = buf[(W / 2 + j0) * SL + col];
    }
    dft<RW1, -1, true>(v);
#pragma unroll
    for (int k = 0; k < RW1; ++k) buf[(a0 + RW2 * k) * SL + col] = v[k];
  }
  __syncthreads();
  PHASE(4);
  // forward W step 2: items (p1, k)
  for (int e = threadIdx.x; e < L1 * RW1; e += NT) {
    const int k = e / L1, col = phys(e % L1);
    float2 v[RW2];
#pragma unroll
    for (int a = 0; a < RW2; ++a) v[a] = cmul(buf[(RW2 * k + a) * SL + col], twW[a * RW1 + k]);
    dft<RW2, -1>(v);
#pragma unroll
    for (int a = 0; a < RW2; ++a) buf[(RW2 * k + a) * SL + col] = v[a];
  }
  __syncthreads();
  PHASE(5);
  // the weighting: groups (g0, g1) and their mirror positions (group e of
  // group_of), each group's eight weights one 32-byte record
  for (int e = threadIdx.x; e < groups<W, L1>(); e += NT) {
    const float4 wa = __ldg(wc + 2 * e), wb = __ldg(wc + 2 * e + 1);
    int g0, g1;
    group_of<W, L1>(e, g0, g1);
    const int k0m = (W - g0) & (W - 1), k1m = (L1 - g1) & (L1 - 1);
    const int p0 = spos<W>(g0) * SL, p0m = spos<W>(k0m) * SL;
    const int p1 = phys(spos<L1>(g1)), p1m = phys(spos<L1>(k1m));
    // V at (k0, k1), (k0m, k1m), (k0, k1m), (k0m, k1).  The cosine part of
    // the minor axis is Rc = (V + conj V(-k)) / 2, the sine part Rs =
    // i (V - conj V(-k)) / 2; each part's cc, ss, sc, cs are sums and
    // differences of its values at (k0, k1) and (k0, -k1), halved again (the
    // two halvings are the 1/4 in the weights)
    const float2 a = buf[p0 + p1], b = buf[p0m + p1m], c = buf[p0 + p1m], d = buf[p0m + p1];
    const float s1 = a.x + b.x, s2 = c.x + d.x, t1 = a.x - b.x, t2 = c.x - d.x;
    const float u1 = a.y + b.y, u2 = c.y + d.y, v1 = a.y - b.y, v2 = c.y - d.y;
    const float cc = (s1 + s2) * wa.x, ss = (s2 - s1) * wa.z;
    const float sc = -(v1 + v2) * wb.x, cs = (v2 - v1) * wb.z;
    const float ccs = -(u1 + u2) * wa.y, sss = (u1 - u2) * wa.w;
    const float scs = -(t1 + t2) * wb.y, css = (t2 - t1) * wb.w;
    // rebuilt: Rc = (cc - ss, -(sc + cs)) at (k0, k1) and (cc + ss, -(sc -
    // cs)) at (k0, -k1), likewise Rs; V = Rc - i Rs, conjugates at -k
    const float P1 = cc - ss, P2 = cc + ss, Q1 = sc + cs, Q2 = sc - cs;
    const float S1 = scs + css, S2 = scs - css, T1 = ccs - sss, T2 = ccs + sss;
    buf[p0 + p1] = make_float2(P1 - S1, -(Q1 + T1));
    buf[p0m + p1m] = make_float2(P1 + S1, Q1 - T1);
    buf[p0 + p1m] = make_float2(P2 - S2, -(Q2 + T2));
    buf[p0m + p1] = make_float2(P2 + S2, Q2 - T2);
  }
  __syncthreads();
  PHASE(6);
  // inverse W step A: items (p1, k), the R2-point DFT over k2, times conj W_W^{a k}
  for (int e = threadIdx.x; e < L1 * RW1; e += NT) {
    const int k = e / L1, col = phys(e % L1);
    float2 v[RW2];
#pragma unroll
    for (int a = 0; a < RW2; ++a) v[a] = buf[(RW2 * k + a) * SL + col];
    dft<RW2, 1>(v);
#pragma unroll
    for (int a = 0; a < RW2; ++a) buf[(RW2 * k + a) * SL + col] = cmulc(v[a], twW[a * RW1 + k]);
  }
  __syncthreads();
  PHASE(7);
  // inverse W step B: items (p1, a0), the rows j0 = a0 + RW2 b < d0 formed
  for (int e = threadIdx.x; e < L1 * RW2; e += NT) {
    const int a0 = e / L1, col = phys(e % L1);
    float2 v[RW1];
#pragma unroll
    for (int k = 0; k < RW1; ++k) v[k] = buf[(a0 + RW2 * k) * SL + col];
    dft<RW1, 1>(v);
#pragma unroll
    for (int b = 0; b < RW1 / 2; ++b) {
      const int j0 = a0 + RW2 * b;
      if (j0 < d0) buf[j0 * SL + col] = v[b];
    }
  }
  __syncthreads();
  PHASE(8);
  // inverse L1 step A: items (j0, k)
  for (int e = threadIdx.x; e < d0 * RA1; e += NT) {
    const int j0 = e / RA1, k = e % RA1;
    float2* row = buf + j0 * SL;
    float2 v[RA2];
#pragma unroll
    for (int a = 0; a < RA2; ++a) v[a] = row[phys(RA2 * k + a)];
    dft<RA2, 1>(v);
#pragma unroll
    for (int a = 0; a < RA2; ++a) row[phys(RA2 * k + a)] = cmulc(v[a], twA[a * RA1 + k]);
  }
  __syncthreads();
  PHASE(9);
}

// 3. The row pass back: complex row q's spectrum A + i B from the half
// spectra of rows q and q + npr, its inverse L-point DFT, the real part to
// row q of yb and the imaginary part to row q + npr.  Returns the thread's
// sum of x * y over what it wrote (when `dot`); the x it needs for that is
// loaded at the start of each round, so that its latency overlaps step A.
// Rounds of CAP complex rows.
template <int L, int CAP>
__device__ float row_inverse(const float* __restrict__ xb, float* __restrict__ yb,
                             const float2* S, float2* buf, int CS, int nr, int npr, int d2,
                             const float2* tw, bool dot) {
  constexpr int R1 = Rad<L>::R1, R2 = Rad<L>::R2, SL = row_stride(L), N = L / 2;
  constexpr int IB = (CAP * R2 + NT - 1) / NT;   // step-B items a thread
  float sum = 0.f;
  for (int q0 = 0; q0 < npr; q0 += CAP) {
    const int nq = min(CAP, npr - q0);
    float xa[IB][R1 / 2], xr[IB][R1 / 2];
#pragma unroll
    for (int i = 0; i < IB; ++i) {
      const int e = threadIdx.x + i * NT;
      const int q = e / R2, a1 = e % R2;
      const int ra = q0 + q, rb = ra + npr;
#pragma unroll
      for (int b = 0; b < R1 / 2; ++b) {
        const int n = a1 + R2 * b;
        const bool in = dot && e < nq * R2 && n < d2;
        xa[i][b] = in ? __ldg(xb + (size_t)ra * d2 + n) : 0.f;
        xr[i][b] = in && rb < nr ? __ldg(xb + (size_t)rb * d2 + n) : 0.f;
      }
    }
    // step A: items (q, k1), the frequencies k1 + R1 k2 read from S (bins
    // 0 and L/2 from column 0, bins above L/2 as their mirrors' conjugates)
    for (int e = threadIdx.x; e < nq * R1; e += NT) {
      const int q = e / R1, k1 = e % R1;
      const int ra = q0 + q, rb = ra + npr;
      const bool hb = rb < nr;
      float2 v[R2];
#pragma unroll
      for (int k2 = 0; k2 < R2; ++k2) {
        const int k = k1 + R1 * k2;
        const bool edge = k == 0 || k == N, mirror = k > N;
        const float2* col = S + (size_t)(edge ? 0 : mirror ? L - k : k) * CS;
        float2 a = col[ra];
        float2 b = hb ? col[rb] : make_float2(0.f, 0.f);
        if (edge) {
          a = make_float2(k ? a.y : a.x, 0.f);
          b = make_float2(k ? b.y : b.x, 0.f);
        } else if (mirror) {
          a.y = -a.y;
          b.y = -b.y;
        }
        v[k2] = make_float2(a.x - b.y, a.y + b.x);
      }
      dft<R2, 1>(v);
      float2* row = buf + q * SL;
#pragma unroll
      for (int a = 0; a < R2; ++a) row[phys(R2 * k1 + a)] = cmulc(v[a], tw[a * R1 + k1]);
    }
    __syncthreads();
    // step B: items (q, a1), the outputs n = a1 + R2 b < d2
#pragma unroll
    for (int i = 0; i < IB; ++i) {
      const int e = threadIdx.x + i * NT;
      if (e >= nq * R2) break;
      const int q = e / R2, a1 = e % R2;
      const int ra = q0 + q, rb = ra + npr;
      const bool hb = rb < nr;
      const float2* row = buf + q * SL;
      float2 v[R1];
#pragma unroll
      for (int k = 0; k < R1; ++k) v[k] = row[phys(a1 + R2 * k)];
      dft<R1, 1>(v);
#pragma unroll
      for (int b = 0; b < R1 / 2; ++b) {
        const int n = a1 + R2 * b;
        if (n >= d2) continue;
        yb[(size_t)ra * d2 + n] = v[b].x;
        if (hb) yb[(size_t)rb * d2 + n] = v[b].y;
        sum = fmaf(xa[i][b], v[b].x, sum);
        sum = fmaf(xr[i][b], v[b].y, sum);
      }
    }
    __syncthreads();
  }
  return sum;
}

template <int W, int L1, int L2>
__global__ void __launch_bounds__(NT, 1) wp3_kernel(Args a) {
  constexpr int C = L2 / 2, CPC = C / CL;
  static_assert(C % CL == 0, "each CTA owns C / CL columns");
  extern __shared__ float4 smem4[];
  __shared__ float red[NT / 32];
  __shared__ float part;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / CL, ncl = gridDim.x / CL;
  const int d0 = a.d0, d1 = a.d1, d2 = a.d2;
  const int P = (d0 + CL - 1) / CL, CS = col_stride(P * d1);
  const int lo = min(rank * P, d0), np = min(P, d0 - lo);
  const int nr = np * d1, npr = (nr + 1) / 2;
  constexpr int CAP = (W * row_stride(L1)) / row_stride(L2);   // complex rows a round
  float2* S = reinterpret_cast<float2*>(smem4);
  float2* buf = S + (size_t)C * CS;
  float2* twW = buf + W * row_stride(L1);
  float2* twA = twW + W;
  float2* twM = twA + L1;
  load_twiddles<W>(twW, a.tw);
  load_twiddles<L1>(twA, a.tw + W);
  load_twiddles<L2>(twM, a.tw + W + L1);
  __syncthreads();
  PHASE_START();
  for (int b = cid; b < a.B; b += ncl) {
    const size_t off = ((size_t)b * d0 + lo) * d1 * d2;
    PHASE_RESET();
    row_forward<L2, CAP>(a.x + off, S, buf, CS, nr, npr, d2, twM);
    PHASE(0);
    cluster.sync();
    PHASE(1);
    gather<W, L1>(cluster, rank * CPC, S, buf, CS, P, d0, d1, 0, NT);
    __syncthreads();
    PHASE(2);
    for (int i = 0; i < CPC; ++i) {
      const int c = rank * CPC + i;
      transform<W, L1>(buf, d0, twW, twA, a.wq + (size_t)c * 2 * groups<W, L1>());
      PHASE_RESET();
      if (threadIdx.x < NT / 2)
        scatter<W, L1>(cluster, c, S, buf, CS, P, d0, d1, 0, NT / 2);
      else if (i + 1 < CPC)
        gather<W, L1>(cluster, c + 1, S, buf, CS, P, d0, d1, NT / 2, NT / 2);
      __syncthreads();
      PHASE(10);
    }
    cluster.sync();
    PHASE(11);
    float dot = row_inverse<L2, CAP>(a.x + off, a.y + off, S, buf, CS, nr, npr, d2, twM,
                                     a.dots != nullptr);
    if (a.dots) {
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, m);
      if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = dot;
      __syncthreads();
      if (threadIdx.x == 0) {
        float s = 0.f;
        for (int w = 0; w < NT / 32; ++w) s += red[w];
        part = s;
      }
    }
    PHASE(12);
    // the partial dots are complete, and the next sample's row pass may
    // overwrite S only after every slab of this one is back
    cluster.sync();
    PHASE(13);
    if (a.dots && rank == 0 && threadIdx.x == 0) {
      float s = 0.f;
      for (int r = 0; r < CL; ++r) s += *cluster.map_shared_rank(&part, r);
      a.dots[b] = s;
    }
  }
  // no CTA leaves while rank 0 may still read its partial dot
  cluster.sync();
}

// The weights laid out group by group (`group_of`'s order): for packed
// column c and group (g0, g1) of its slab, with k0m = -g0 mod W and k1m = -g1 mod L1, the record
// (w00c, w00s, w11c, w11s), (w10c, w10s, w01c, w01s), where wXYc and wXYs are
// w[k0, k1, c] and w[k0, k1, c'] at k0 = g0 (X = 0) or k0m (X = 1), k1 = g1
// (Y = 0) or k1m (Y = 1), times scale / 4 (the weighting's two halvings);
// c' = L2 - c (c > 0) or L2/2 (c = 0), the real-basis indices of the minor
// axis's cosine and sine parts.
__global__ void __launch_bounds__(256) weights_kernel(const float* __restrict__ w,
                                                      float4* __restrict__ wq, int W, int L1,
                                                      int L2, float scale) {
  const int H = L1 / 2, head = (W / 2 + 1) * H, ngr = head + W / 2 + 1;
  const int total = L2 / 2 * ngr;
  for (int e = blockIdx.x * 256 + threadIdx.x; e < total; e += gridDim.x * 256) {
    const int c = e / ngr, g = e % ngr;
    const int g0 = g < head ? g / H : g - head, g1 = g < head ? g % H : H;
    const int k0m = (W - g0) % W, k1m = (L1 - g1) % L1, cs = c ? L2 - c : L2 / 2;
    auto at = [&](int k0, int k1, int m) { return w[((size_t)k0 * L1 + k1) * L2 + m] * scale; };
    wq[2 * e] = make_float4(at(g0, g1, c), at(g0, g1, cs), at(k0m, k1m, c), at(k0m, k1m, cs));
    wq[2 * e + 1] = make_float4(at(k0m, g1, c), at(k0m, g1, cs), at(g0, k1m, c), at(g0, k1m, cs));
  }
}

// The opt-in to more than 48 KB of dynamic shared memory, once per process
// and shape: all a block may use, less the kernel's static shared memory.
template <int W, int L1, int L2>
cudaError_t configure_once() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, wp3_kernel<W, L1, L2>);
  if (err) return err;
  err = cudaFuncSetAttribute(wp3_kernel<W, L1, L2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX - (int)attr.sharedSizeBytes);
  if (err) return err;
  done = true;
  return cudaSuccess;
}

template <int W, int L1, int L2>
void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int clusters,
                    size_t smem, cudaStream_t stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(clusters * CL, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

template <int W, int L1, int L2>
int launch(const Args& a, int clusters, cudaStream_t stream) {
  cudaError_t err = configure_once<W, L1, L2>();
  if (err) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config<W, L1, L2>(cfg, attr, clusters, smem_bytes(a.d0, a.d1, W, L1, L2), stream);
  if ((err = cudaLaunchKernelEx(&cfg, wp3_kernel<W, L1, L2>, a))) return (int)err;
  return (int)cudaGetLastError();
}

template <int W, int L1, int L2>
int max_clusters(int d0, int d1, int* out) {
  cudaError_t err = configure_once<W, L1, L2>();
  if (err) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config<W, L1, L2>(cfg, attr, 1, smem_bytes(d0, d1, W, L1, L2), 0);
  return (int)cudaOccupancyMaxActiveClusters(out, wp3_kernel<W, L1, L2>, &cfg);
}

}  // namespace

extern "C" {

#ifdef WP3_PHASE_CLOCKS
// The per-phase clocks (16) into out; zeroed after when `reset`.
int mxu3d_wp3_phase_clocks(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, wp3_phase_clocks, sizeof(wp3_phase_clocks));
  if (err || !reset) return (int)err;
  unsigned long long zero[16] = {0};
  return (int)cudaMemcpyToSymbol(wp3_phase_clocks, zero, sizeof(zero));
}
#endif

// Dynamic shared memory, in bytes, of one CTA (204 288 at the main path).
size_t mxu3d_wp3_smem_bytes(int d0, int d1, int W, int L1, int L2) {
  return smem_bytes(d0, d1, W, L1, L2);
}

// Floats of the laid-out weights: eight a group, (W/2 + 1)(L1/2 + 1) groups
// a packed column, L2/2 columns.
size_t mxu3d_wp3_weight_floats(int W, int L1, int L2) {
  return (size_t)8 * (L2 / 2) * (W / 2 + 1) * (L1 / 2 + 1);
}

// *out = the clusters of the kernel the card keeps resident at once for this
// shape (cudaOccupancyMaxActiveClusters); the persistent grid's size.
int mxu3d_wp3_max_clusters(int d0, int d1, int W, int L1, int L2, int* out) {
#define WP3_CLUSTERS(w, l1, l2) \
  if (W == w && L1 == l1 && L2 == l2) return max_clusters<w, l1, l2>(d0, d1, out);
  WP3_FOR_EACH_SHAPE(WP3_CLUSTERS)
#undef WP3_CLUSTERS
  return (int)cudaErrorInvalidValue;
}

// x, y (B, d0, d1, d2); w (W, L1, L2); tw the twiddles of W, L1 and L2 as
// (re, im) pairs; wq (mxu3d_wp3_weight_floats) the laid-out weights' buffer;
// dots (B) or null; `clusters` persistent clusters of CL CTAs.
int mxu3d_wp3(const float* x, const float* w, const float* tw, float* wq, float* y,
              float* dots, int B, int d0, int d1, int d2, int W, int L1, int L2, int clusters,
              void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int total = L2 / 2 * (W / 2 + 1) * (L1 / 2 + 1);
  weights_kernel<<<(total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024, 256, 0, stream>>>(
      w, reinterpret_cast<float4*>(wq), W, L1, L2, (float)(0.25 / ((double)W * L1 * L2)));
  cudaError_t err = cudaGetLastError();
  if (err) return (int)err;
  Args a;
  a.x = x;
  a.wq = reinterpret_cast<const float4*>(wq);
  a.tw = reinterpret_cast<const float2*>(tw);
  a.y = y;
  a.dots = dots;
  a.B = B;
  a.d0 = d0;
  a.d1 = d1;
  a.d2 = d2;
#define WP3_LAUNCH(w, l1, l2) \
  if (W == w && L1 == l1 && L2 == l2) return launch<w, l1, l2>(a, clusters, stream);
  WP3_FOR_EACH_SHAPE(WP3_LAUNCH)
#undef WP3_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
