// Kernel B-5: the cropped 2-D real-Fourier sandwich over a stack of weight
// planes, hand-written for Hopper (sm_90a), as dense real-DFT contractions.
// Kernel A (and B-8), the same sandwich on single planes, moved to the
// FFT-structured csrc/sandwich_fft.cu; the four launches below were first
// written for it and are B-5's with a plane index.
//
// For every plane it computes
//
//     y = P_o (Q0 x Q1) diag(w) (Q0 x Q1)^T P_i^T x
//
// with the rectangular real-Fourier tables of `_tables`:
//     q1a = Q1[:i1]    (i1, L1)   minor-axis analysis
//     q0a = Q0[:i0].T  (L0, i0)   leading-axis analysis
//     q0s = Q0[:o0]    (o0, L0)   leading-axis synthesis
//     q1s = Q1[:o1].T  (L1, o1)   minor-axis synthesis
// and, when `dots` is given, the PCG self-dots.
//
// Bound on this card.  The sandwich is a circulant apply, so the least work it
// needs is the FFT formulation on the embedding, pruned to the rows that hold
// data (per (125, 125) plane through (250, 250): ~3.9 MFLOP against ~47 MFLOP
// of the dense contractions done here, twelve times the least work).  Within
// its own formulation the kernel is bound by operations, not bytes.
//
// What the design does about it.  The TPU kernel holds the whole embedded
// (L0, L1) plane of a sample in VMEM; at 250^2 in f32 that plane (250,000 bytes)
// is larger than the 232,448 bytes of shared memory a Hopper block may use.  So
// the sandwich runs as four launches on the caller's stream, none of which holds
// a whole plane:
//   1. minor-axis analysis, a row GEMM  u = x . q1a, written in the layout
//      (i0, B, L1) so that the middle pass sees one (i0, B*L1) matrix;
//   2. the middle pass: one block per slab of 64 columns of (B*L1) keeps the
//      (i0 x 64) input slab and the (L0 x 64) embedded slab in shared memory,
//      forms A = (q0a . u) * w there, and writes c = q0s . A as (o0, B, L1);
//   3. minor-axis synthesis, a row GEMM  y = c . q1s, written back as
//      (B, o0, o1); its epilogue forms the per-row self-dot partials;
//   4. with dots, a reduction of those partials per sample in a fixed order, so
//      the result is deterministic (no atomics).
// All arithmetic is full-FP32 FMA on the CUDA cores, no TF32 (one-pass reduced
// precision breaks these DFT-like sums).  Being bound by operations, the
// passes keep the FMA units fed from registers: each thread owns an 8 x 8 tile
// of outputs in the row GEMMs and an 8 x 4 tile in the middle pass, and reads
// its operands from shared memory as float4, so a shared-memory wavefront
// feeds at least 64 FMAs; the tiles staged from device memory are double-
// buffered behind the FMAs.  The embedded planes live only in shared memory; the
// two (B*d, L1) intermediates of the minor-axis passes go through device
// memory (and mostly L2).  The middle pass's (i0 + L0) x 64 slab caps the
// embedded axis at 432 for an expanded input.
//
// Kernel B-5 replaces the Pallas TPU kernel hipgp_tpu/ops/mxu2d.py:_make_kernel_wp
// (launched by `_pallas_sandwich_wp` at its pl.pallas_call), the building
// block of the 3-D sandwich: after the outer-axis analysis a 3-D sample is W
// independent 2-D plane problems, plane l with its own spectrum w[l].  On a
// (B, W, i0, i1) stack it computes y[b, l] = P_o (Q0 x Q1) diag(w[l]) (.)^T
// P_i^T x[b, l] and, with dots, dots[b] = sum_l <x[b, l], y[b, l]>.  The
// four launches carry a plane index: the row GEMMs treat the stack
// as B*W samples, the intermediates are laid out (W, i0, B, L1) and
// (W, o0, B, L1) so that plane l's columns stay together, the middle pass
// runs one grid row per plane with that plane's spectrum, and the self-dots
// are summed per plane and then over the planes in order.  Its bound is the
// the FFT count per plane: at the 3-D main path's shape, (512, 64, 64, 64)
// through (128, 128) planes, the dense contractions are ~206 GFLOP
// (3.1 ms at the FP32 peak) against a pruned FFT count of ~29 GFLOP.
//
// Interface: plain C, returns the cudaError_t of the first failing call
// (0 on success).  Launches on `stream`, never synchronises, allocates nothing:
// the caller passes every output and scratch buffer.

#include "sandwich.cuh"

namespace {

using namespace sandwich;

constexpr int BN = 128;   // columns of an output tile of the row GEMM
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block may use (sm_90)
static_assert(BM == BN, "row and column tiles share one staging size");

// out[(r % P) * Q + r / P, n] = sum_k in[r, k] * t[k, n]  for r < R, n < N.
// With `partial`, also partial[r * gridDim.x + blockIdx.x] =
//     sum over this block's columns n of xdot[orow, n] * out[orow, n].
__global__ void __launch_bounds__(NT, 2) row_gemm_kernel(
    const float* __restrict__ in, const float* __restrict__ t, float* __restrict__ out,
    int R, int K, int N, int P, int Q,
    const float* __restrict__ xdot, float* __restrict__ partial) {
  __shared__ __align__(16) float As[2 * TILE];
  __shared__ __align__(16) float Bs[2 * TILE];
  __shared__ float red[BM][17];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float pa[PER], pb[PER];
  fetch_rows_tile(pa, in, r0, 0, R, K, K);
  fetch_cols_tile<BN>(pb, t, 0, n0, K, N);
  store_rows_tile(As, pa);
  store_cols_tile<BN>(Bs, pb);
  __syncthreads();
  for (int k0 = 0, buf = 0; k0 < K; k0 += BK, buf ^= 1) {
    const bool more = k0 + BK < K;
    if (more) {
      fetch_rows_tile(pa, in, r0, k0 + BK, R, K, K);
      fetch_cols_tile<BN>(pb, t, k0 + BK, n0, K, N);
    }
    const float* as = As + buf * TILE;
    const float* bs = Bs + buf * TILE;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk * (BM + PAD) + ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk * (BM + PAD) + 64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk * (BN + PAD) + tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk * (BN + PAD) + 64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      store_rows_tile(As + (buf ^ 1) * TILE, pa);
      store_cols_tile<BN>(Bs + (buf ^ 1) * TILE, pb);
    }
    __syncthreads();
  }

  float rowdot[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    rowdot[i] = 0.f;
    const int r = r0 + tile_idx(ty, i);
    if (r >= R) continue;
    const size_t orow = (size_t)(r % P) * Q + r / P;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tile_idx(tx, j);
      if (n < N) {
        out[orow * N + n] = acc[i][j];
        if (partial) rowdot[i] = fmaf(xdot[orow * N + n], acc[i][j], rowdot[i]);
      }
    }
  }
  if (partial) {
#pragma unroll
    for (int i = 0; i < 8; ++i) red[tile_idx(ty, i)][tx] = rowdot[i];
    __syncthreads();
    if (tid < BM) {
      float s = 0.f;
      for (int c = 0; c < 16; ++c) s += red[tid][c];
      const int r = r0 + tid;
      if (r < R) partial[(size_t)r * gridDim.x + blockIdx.x] = s;
    }
  }
}

// One block per slab of SLAB columns of the (B*L1)-column intermediates of
// plane blockIdx.y (planes lie i0*ncols, L0*L1 and o0*ncols floats apart in
// u, w and c; a single plane W = 1):
//   A (L0 x SLAB) = (q0a . u[:, slab]) * w[:, col % L1]   (shared memory only)
//   c[:, slab] = q0s . A                                   (o0 x SLAB, to device memory)
__global__ void __launch_bounds__(NT, 2) middle_kernel(
    const float* __restrict__ u, const float* __restrict__ q0a,
    const float* __restrict__ w, const float* __restrict__ q0s,
    float* __restrict__ c, int i0, int L0, int L1, int o0, int ncols) {
  extern __shared__ float4 smem4[];
  const size_t plane = blockIdx.y;
  middle_slab(u + plane * i0 * ncols, q0a, w + plane * L0 * L1, L1, 0, q0s,
              c + plane * o0 * ncols, i0, L0, o0, blockIdx.x * SLAB, ncols,
              reinterpret_cast<float*>(smem4));
}

// dots[b] = sum_{o < o0} sum_{t < nct} partial[(o * B + b) * nct + t], in a fixed order.
__global__ void __launch_bounds__(NT) dots_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ dots, int B, int o0, int nct) {
  __shared__ float red[NT];
  const int b = blockIdx.x;
  float s = 0.f;
  for (int o = threadIdx.x; o < o0; o += NT)
    for (int t = 0; t < nct; ++t) s += partial[((size_t)o * B + b) * nct + t];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = NT / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) dots[b] = red[0];
}

// Weight-plane self-dots: dots[b] = sum_{l < W} (sum_{o < o0} sum_{t < nct}
// partial[((l * o0 + o) * B + b) * nct + t]), each plane's sum and then the sum
// over planes in order (no atomics).  One block per sample, W floats of
// dynamic shared memory.
__global__ void __launch_bounds__(NT) wp_dots_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ dots, int B, int W, int o0,
    int nct) {
  extern __shared__ float planedot[];
  const int b = blockIdx.x;
  for (int l = threadIdx.x; l < W; l += NT) {
    float s = 0.f;
    for (int o = 0; o < o0; ++o)
      for (int t = 0; t < nct; ++t) s += partial[(((size_t)l * o0 + o) * B + b) * nct + t];
    planedot[l] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int l = 0; l < W; ++l) s += planedot[l];
    dots[b] = s;
  }
}

size_t middle_smem_bytes(int i0, int L0) { return middle_smem_floats(i0, L0) * sizeof(float); }

// The sandwich of every (b, l) plane of a (B, W, i0, i1) stack, plane l with
// its own (L0, L1) spectrum w + l * L0 * L1.  The
// intermediates keep each plane's columns together, u as (W, i0, B, L1) and c
// as (W, o0, B, L1), so the middle pass of plane l sees one (i0, B*L1) matrix.
int sandwich_launch(const float* x, const float* q0a, const float* q1a, const float* q0s,
                    const float* q1s, const float* w, float* y, float* dots, float* u,
                    float* c, float* partial, int B, int W, int i0, int i1, int L0, int L1,
                    int o0, int o1, cudaStream_t stream) {
  cudaError_t err;
  const int ncols = B * L1;

  // 1. u (W, i0, B, L1) = x (B*W*i0, i1) . q1a
  {
    const int R = B * W * i0;
    dim3 grid((L1 + BN - 1) / BN, (R + BM - 1) / BM);
    row_gemm_kernel<<<grid, NT, 0, stream>>>(x, q1a, u, R, i1, L1, W * i0, B, nullptr,
                                             nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // 2. c (W, o0, B, L1) = q0s . ((q0a . u) * w), slab by slab and plane by plane
  {
    // the opt-in to more than 48 KB of dynamic shared memory, once per process
    static bool configured = false;
    if (!configured) {
      if ((err = cudaFuncSetAttribute(middle_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      SMEM_MAX)) != cudaSuccess)
        return (int)err;
      configured = true;
    }
    const size_t smem = middle_smem_bytes(i0, L0);
    dim3 grid((ncols + SLAB - 1) / SLAB, W);
    middle_kernel<<<grid, NT, smem, stream>>>(u, q0a, w, q0s, c, i0, L0, L1, o0, ncols);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // 3. y (B, W, o0, o1) = c (W*o0*B, L1) . q1s, with the self-dot partials
  const int R = W * o0 * B;
  const int nct = (o1 + BN - 1) / BN;
  {
    dim3 grid(nct, (R + BM - 1) / BM);
    row_gemm_kernel<<<grid, NT, 0, stream>>>(c, q1s, y, R, L1, o1, B, W * o0,
                                             dots ? x : nullptr, dots ? partial : nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // 4. dots[b], summed in a fixed order
  if (dots) {
    if (W == 1)
      dots_reduce_kernel<<<B, NT, 0, stream>>>(partial, dots, B, o0, nct);
    else
      wp_dots_reduce_kernel<<<B, NT, W * sizeof(float), stream>>>(partial, dots, B, W, o0, nct);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Shared memory the middle pass needs (98 KB at i0 = 125, L0 = 250; up to
// 207 KB for a cropped input at L0 = 512); the wrapper refuses shapes above
// the card's 227 KB before it launches.
size_t mxu2d_middle_smem_bytes(int i0, int L0) { return middle_smem_bytes(i0, L0); }

// Floats of the self-dot partials buffer: one per output row and column tile
// (for a weight-plane stack, pass B * W as B).
size_t mxu2d_partial_floats(int B, int o0, int o1) {
  return (size_t)o0 * B * ((o1 + BN - 1) / BN);
}

// Rows of output tiles of the larger row GEMM; the wrapper keeps it within
// the 65535 blocks a grid's y dimension may have.
int mxu2d_row_tiles(int B, int W, int i0, int o0) {
  const long long R = (long long)B * W * (i0 > o0 ? i0 : o0);
  return (int)((R + BM - 1) / BM);
}

// Kernel B-5, the weight-plane sandwich: x (B, W, i0, i1), w (W, L0, L1),
// y (B, W, o0, o1), dots[b] = sum_l <x[b, l], y[b, l]>.  Scratch: u
// (W*i0*B*L1 floats), c (W*o0*B*L1) and, with dots, partial
// (mxu2d_partial_floats(B * W, o0, o1)).
int mxu2d_sandwich_wp(const float* x, const float* q0a, const float* q1a, const float* q0s,
                      const float* q1s, const float* w, float* y, float* dots, float* u,
                      float* c, float* partial, int B, int W, int i0, int i1, int L0, int L1,
                      int o0, int o1, void* stream_ptr) {
  return sandwich_launch(x, q0a, q1a, q0s, q1s, w, y, dots, u, c, partial, B, W, i0, i1,
                         L0, L1, o0, o1, (cudaStream_t)stream_ptr);
}

}  // extern "C"
