// Kernel B-6: the whole cropped 3-D real-Fourier sandwich of one sample in one
// kernel, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hipgp_tpu/ops/mxu3d.py:_make_kernel_wp3
// (launched in `_get_wp3` at its pl.pallas_call).  For every sample b of a
// (B, d0, d1, d2) stack it computes
//
//     y[b] = P (Q0 x Q1 x Q2) diag(w) (Q0 x Q1 x Q2)^T P^T x[b]
//
// cropped in and out (the PCG apply), with w the (W, L1, L2) spectrum in the
// same axis order, and, when `dots` is given, dots[b] = <x[b], y[b]>.  The
// tables are the rectangular slabs of the orthonormal real Fourier bases:
//     q1a  = Q2[:d2]     (d2, L2)   minor analysis
//     q0os = Q0[:d0]     (d0, W)    outer analysis (as B) and synthesis
//     q0oa = Q0[:d0].T   (W, d0)    outer synthesis (as B)
//     q0a  = Q1[:d1].T   (L1, d1)   inner analysis
//     q0s  = Q1[:d1]     (d1, L1)   inner synthesis
//     q1s  = Q2[:d2].T   (L2, d2)   minor synthesis
//
// Bound on this card.  Like kernels A and B-5 it does the dense real-DFT
// contractions: at the 3-D main path's shape, (512, 32, 64, 64) through a
// (64, 128, 128) embedding, 206 GFLOP (3.1 ms at the 67 TFLOP/s FP32 peak),
// against ~40 GFLOP for the pruned FFT formulation and 0.54 GB of input and
// output (0.16 ms at 3.35 TB/s): bound by operations.
//
// What the design does about it.  The TPU kernel holds a sample's whole
// embedded volume in VMEM; at the main-path shape that volume is 4 MiB, far
// above the 227 KB of shared memory a block may use.  So each block owns one
// sample at a time (a persistent grid of two blocks per SM walks the batch)
// and runs its five phases through its own slice of a device scratch buffer
// (3 MiB per block at that shape), which the phases write once and read once
// while it is still in L2 or on its way out:
//   1. minor analysis      U (d0*d1, L2)  = x (d0*d1, d2) . q1a
//   2. outer analysis      V (d1, W*L2)   with V[k, l*L2 + c] = sum_j Q0[j, l] U[j*d1 + k, c],
//                          a GEMM over (m = k*L2 + c, l) reading U by columns
//   3. inner analysis, scale by w, inner synthesis, one 64-column slab of V at a
//      time in shared memory (B-5's middle pass), written back in place
//   4. outer synthesis     Y (d0, d1*L2)  with Y[j, k*L2 + c] = sum_l Q0[j, l] V[k, l*L2 + c],
//                          a GEMM over (m = k*L2 + c, j), stored by columns into U
//   5. minor synthesis     y (d0*d1, d2)  = Y (d0*d1, L2) . q1s, and the self-dot.
// No phase needs a transpose pass: phases 2 and 4 read and write the
// intermediates through index maps, with the large extent (d1*L2) as the GEMM
// rows and the small ones (W, d0) as its columns.  Every GEMM runs 128-row
// output tiles with an 8 x RN register tile per thread (RN = 8, 4 or 2 for
// 128-, 64- or 32-column tiles) over double-buffered BK-deep stages
// (sandwich.cuh).  The self-dot is each thread's sum over its outputs in a
// fixed order, then a fixed tree over the block: deterministic, no atomics.
// All arithmetic is full-FP32 FMA, no TF32.
//
// Interface: plain C, returns the cudaError_t of the first failing call
// (0 on success).  Launches on `stream`, never synchronises, allocates
// nothing: the caller passes the output, the dots and the scratch buffer.

#include "sandwich.cuh"

namespace {

using namespace sandwich;

// How a GEMM reads its A operand (M x K) and writes its output (M x N).
enum AMode { A_ROWS = 0, A_COLS = 1, A_COLS_SWAP = 2 };
enum OMode { O_ROWS = 0, O_ROWS_SWAP = 1, O_COLS = 2 };

// Index of A[m, k]: row-major with leading dimension ld; column-major with
// leading dimension ld; or (A_COLS_SWAP) element (m / P, k, m % P) of a
// (*, W, P) array.
template <int AM>
__device__ inline size_t a_index(int m, int k, int ld, int P, int W) {
  if constexpr (AM == A_ROWS) return (size_t)m * ld + k;
  else if constexpr (AM == A_COLS) return (size_t)k * ld + m;
  else return (size_t)(m / P) * W * P + (size_t)k * P + m % P;
}

// Index of C[m, n]: row-major; (O_ROWS_SWAP) element (m / P, n, m % P) of a
// (*, W, P) array; or column-major.
template <int OM>
__device__ inline size_t o_index(int m, int n, int ld, int P, int W) {
  if constexpr (OM == O_ROWS) return (size_t)m * ld + n;
  else if constexpr (OM == O_ROWS_SWAP) return (size_t)(m / P) * W * P + (size_t)n * P + m % P;
  else return (size_t)n * ld + m;
}

// This thread's part of the (BM x BK) A tile at (r0, k0); a row-major A is
// read along k, the other layouts along m, so neighbouring threads read
// neighbouring addresses.
template <int AM>
__device__ inline void fetch_a(float (&p)[PER], const float* A, int r0, int k0, int M, int K,
                               int ld, int P, int W) {
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int e = threadIdx.x + t * NT;
    const int r = r0 + (AM == A_ROWS ? e / BK : e % BM);
    const int k = k0 + (AM == A_ROWS ? e % BK : e / BM);
    p[t] = (r < M && k < K) ? A[a_index<AM>(r, k, ld, P, W)] : 0.f;
  }
}

// ... stored as ts[BK][BM + PAD].
template <int AM>
__device__ inline void store_a(float* ts, const float (&p)[PER]) {
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int e = threadIdx.x + t * NT;
    if constexpr (AM == A_ROWS) ts[(e % BK) * (BM + PAD) + e / BK] = p[t];
    else ts[(e / BM) * (BM + PAD) + e % BM] = p[t];
  }
}

// C = A (M x K) . Bt (K x N, row-major), all tiles by the whole block, in
// order; with xdot, dot += sum over the outputs of xdot[i] * C[i] (this
// thread's outputs, in a fixed order).  smem holds the two staged stages of A
// and of B.
template <int RN, int AM, int OM>
__device__ void block_gemm(int M, int N, int K, const float* A, int lda, int aP, int aW,
                           const float* __restrict__ Bt, float* C, int ldc, int cP, int cW,
                           const float* xdot, float& dot, float* smem) {
  constexpr int TN = 16 * RN;
  constexpr int PB = BK * TN / NT;
  constexpr int TILEB = BK * (TN + PAD);
  float* As = smem;
  float* Bs = smem + 2 * TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ntn = (N + TN - 1) / TN, ntiles = ((M + BM - 1) / BM) * ntn;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int r0 = (tile / ntn) * BM, n0 = (tile % ntn) * TN;
    float acc[8][RN];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
    float pa[PER], pb[PB];
    fetch_a<AM>(pa, A, r0, 0, M, K, lda, aP, aW);
    fetch_cols_tile<TN>(pb, Bt, 0, n0, K, N);
    store_a<AM>(As, pa);
    store_cols_tile<TN>(Bs, pb);
    __syncthreads();
    for (int k0 = 0, buf = 0; k0 < K; k0 += BK, buf ^= 1) {
      const bool more = k0 + BK < K;
      if (more) {
        fetch_a<AM>(pa, A, r0, k0 + BK, M, K, lda, aP, aW);
        fetch_cols_tile<TN>(pb, Bt, k0 + BK, n0, K, N);
      }
      const float* as = As + buf * TILE;
      const float* bs = Bs + buf * TILEB;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[8], b[RN];
        load_a8(a, as, kk, ty);
        load_b<RN>(b, &bs[kk * (TN + PAD)], tx);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (more) {
        store_a<AM>(As + (buf ^ 1) * TILE, pa);
        store_cols_tile<TN>(Bs + (buf ^ 1) * TILEB, pb);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + tile_idx(ty, i);
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int n = n0 + col_idx<RN>(tx, j);
        if (n >= N) continue;
        const size_t idx = o_index<OM>(r, n, ldc, cP, cW);
        C[idx] = acc[i][j];
        if (xdot) dot = fmaf(xdot[idx], acc[i][j], dot);
      }
    }
  }
}

// Floats of one block's scratch: U (d0*d1*L2) and V (d1*W*L2).
__host__ __device__ inline size_t scratch_floats(int d0, int d1, int W, int L2) {
  return (size_t)d1 * L2 * (d0 + W);
}

__host__ __device__ inline size_t smem_floats(int d1, int L1) {
  const size_t gemm = 2 * TILE + 2 * BK * (128 + PAD);
  const size_t middle = middle_smem_floats(d1, L1);
  return gemm > middle ? gemm : middle;
}

__global__ void __launch_bounds__(NT, 2) wp3_kernel(
    const float* __restrict__ x, const float* __restrict__ q1a,
    const float* __restrict__ q0os, const float* __restrict__ q0oa,
    const float* __restrict__ q0a, const float* __restrict__ q0s,
    const float* __restrict__ q1s, const float* __restrict__ w, float* __restrict__ y,
    float* __restrict__ dots, float* scratch, int B, int d0, int d1, int d2, int W, int L1,
    int L2) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[NT];
  float* U = scratch + blockIdx.x * scratch_floats(d0, d1, W, L2);
  float* V = U + (size_t)d0 * d1 * L2;
  const int ncols = W * L2;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const float* xb = x + (size_t)b * d0 * d1 * d2;
    float* yb = y + (size_t)b * d0 * d1 * d2;
    float dot = 0.f;
    // 1. minor analysis
    block_gemm<8, A_ROWS, O_ROWS>(d0 * d1, L2, d2, xb, d2, 0, 0, q1a, U, L2, 0, 0, nullptr,
                                  dot, smem);
    __syncthreads();
    // 2. outer analysis, into V laid out (d1, W, L2)
    block_gemm<4, A_COLS, O_ROWS_SWAP>(d1 * L2, W, d0, U, d1 * L2, 0, 0, q0os, V, 0, L2, W,
                                       nullptr, dot, smem);
    __syncthreads();
    // 3. inner analysis, spectrum, inner synthesis, slab by slab, in place
    for (int c0 = 0; c0 < ncols; c0 += SLAB) {
      middle_slab(V, q0a, w, L2, (size_t)L1 * L2, q0s, V, d1, L1, d1, c0, ncols, smem);
      __syncthreads();
    }
    // 4. outer synthesis, into U laid out (d0, d1, L2)
    block_gemm<2, A_COLS_SWAP, O_COLS>(d1 * L2, d0, W, V, 0, L2, W, q0oa, U, d1 * L2, 0, 0,
                                       nullptr, dot, smem);
    __syncthreads();
    // 5. minor synthesis and the self-dot
    block_gemm<4, A_ROWS, O_ROWS>(d0 * d1, d2, L2, U, L2, 0, 0, q1s, yb, d2, 0, 0,
                                  dots ? xb : nullptr, dot, smem);
    if (dots) {
      red[threadIdx.x] = dot;
      __syncthreads();
      for (int h = NT / 2; h > 0; h >>= 1) {
        if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
        __syncthreads();
      }
      if (threadIdx.x == 0) dots[b] = red[0];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs (57.6 KB at the main-path shape d1 = 64,
// L1 = 128); the wrapper refuses shapes above the card's 227 KB.
size_t mxu3d_wp3_smem_bytes(int d1, int L1) { return smem_floats(d1, L1) * sizeof(float); }

// Floats of scratch for `blocks` blocks.
size_t mxu3d_wp3_scratch_floats(int blocks, int d0, int d1, int W, int L2) {
  return (size_t)blocks * scratch_floats(d0, d1, W, L2);
}

// x, y (B, d0, d1, d2); w (W, L1, L2); dots (B) or null; scratch
// (mxu3d_wp3_scratch_floats(blocks, ...)); `blocks` persistent blocks.
int mxu3d_wp3(const float* x, const float* q1a, const float* q0os, const float* q0oa,
              const float* q0a, const float* q0s, const float* q1s, const float* w, float* y,
              float* dots, float* scratch, int B, int d0, int d1, int d2, int W, int L1, int L2,
              int blocks, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err;
  const size_t smem = smem_floats(d1, L1) * sizeof(float);
  if ((err = cudaFuncSetAttribute(wp3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  wp3_kernel<<<blocks, NT, smem, stream>>>(x, q1a, q0os, q0oa, q0a, q0s, q1s, w, y, dots,
                                           scratch, B, d0, d1, d2, W, L1, L2);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return 0;
}

}  // extern "C"
