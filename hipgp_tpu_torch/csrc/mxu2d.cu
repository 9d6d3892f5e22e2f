// Kernel A: the cropped 2-D real-Fourier sandwich, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hipgp_tpu/ops/mxu2d.py:_make_kernel (launched by
// `_pallas_sandwich` at its pl.pallas_call).  For every sample b it computes
//
//     y[b] = P_o (Q0 x Q1) diag(w) (Q0 x Q1)^T P_i^T x[b]
//
// with the rectangular real-Fourier tables of `_tables`:
//     q1a = Q1[:i1]    (i1, L1)   minor-axis analysis
//     q0a = Q0[:i0].T  (L0, i0)   leading-axis analysis
//     q0s = Q0[:o0]    (o0, L0)   leading-axis synthesis
//     q1s = Q1[:o1].T  (L1, o1)   minor-axis synthesis
// and, when `dots` is given, the PCG self-dot dots[b] = <x[b], y[b]>.
//
// Bound on this card.  The sandwich is a circulant apply, so the least work it
// needs is the FFT formulation on the embedding, pruned to the rows that hold
// data.  At the PCG shape of the paper's 2-D protocol, (256, 125, 125) ->
// (256, 125, 125) through a (250, 250) embedding, that is 0.99 GFLOP of FP32
// work (0.015 ms at the 67 TFLOP/s FP32 non-tensor-core peak) against 32 MB of
// input and output (0.010 ms at 3.35 TB/s); at the R^T shape, out to
// (256, 250, 250), the 80 MB of bytes bound it (0.024 ms).  This kernel does
// the dense real-DFT contractions instead: 12.0 GFLOP at the PCG shape, 0.18 ms
// at the peak, twelve times the least work.  Dense contractions keep a first
// version simple and sum every output in order; reaching the bound needs an
// FFT-structured kernel.  Within its own formulation the kernel is bound by
// operations, not bytes.
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
// memory (and mostly L2).
//
// Interface: plain C, returns the cudaError_t of the first failing call
// (0 on success).  Launches on `stream`, never synchronises, allocates nothing:
// the caller passes every output and scratch buffer.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 256;   // threads per block, as 16 x 16 (ty, tx)
constexpr int BM = 128;   // rows of an output tile
constexpr int BN = 128;   // columns of an output tile of the row GEMM
constexpr int BK = 8;     // depth of one shared-memory stage
constexpr int PAD = 4;    // keeps float4 alignment and spreads the transposed stores
constexpr int SLAB = 64;  // columns of (B*L1) per middle-pass block: 4 per thread

__host__ __device__ inline int round_up(int a, int m) { return (a + m - 1) / m * m; }

// Row (or column) owned by slot ii (0..7) of thread index t within a 128-wide
// tile: two groups of four consecutive indices, 64 apart, each one float4.
__device__ inline int tile_idx(int t, int ii) { return (ii < 4 ? 0 : 64) + t * 4 + (ii & 3); }

static_assert(BM == BN, "row and column tiles share one staging size");
constexpr int TILE = BK * (BM + PAD);   // floats of one staged (BK x 128) tile
constexpr int PER = BM * BK / NT;        // elements of a tile each thread moves

// Tiles are double-buffered: while a block computes on one shared-memory
// stage, each thread holds its part of the next tile in registers and stores
// it into the other stage afterwards, so one barrier per stage suffices and
// the device-memory (mostly L2) latency hides behind the FMAs.

// This thread's part of the (BM x BK) tile src[r0:r0+BM, k0:k0+BK] of a
// row-major (rows x cols) matrix with leading dimension ld; zero outside it.
__device__ inline void fetch_rows_tile(float (&p)[PER], const float* __restrict__ src,
                                       int r0, int k0, int rows, int cols, int ld) {
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int e = threadIdx.x + t * NT, r = r0 + e / BK, k = k0 + e % BK;
    p[t] = (r < rows && k < cols) ? src[(size_t)r * ld + k] : 0.f;
  }
}

// ... stored transposed into ts[BK][BM + PAD].
__device__ inline void store_rows_tile(float* ts, const float (&p)[PER]) {
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int e = threadIdx.x + t * NT;
    ts[(e % BK) * (BM + PAD) + e / BK] = p[t];
  }
}

// This thread's part of the (BK x BN) tile src[k0:k0+BK, n0:n0+BN] of a
// row-major (K x N) matrix; zero outside it.
__device__ inline void fetch_cols_tile(float (&p)[PER], const float* __restrict__ src,
                                       int k0, int n0, int K, int N) {
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int e = threadIdx.x + t * NT, k = k0 + e / BN, n = n0 + e % BN;
    p[t] = (k < K && n < N) ? src[(size_t)k * N + n] : 0.f;
  }
}

// ... stored as ts[BK][BN + PAD].
__device__ inline void store_cols_tile(float* ts, const float (&p)[PER]) {
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int e = threadIdx.x + t * NT;
    ts[(e / BN) * (BN + PAD) + e % BN] = p[t];
  }
}

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
  fetch_cols_tile(pb, t, 0, n0, K, N);
  store_rows_tile(As, pa);
  store_cols_tile(Bs, pb);
  __syncthreads();
  for (int k0 = 0, buf = 0; k0 < K; k0 += BK, buf ^= 1) {
    const bool more = k0 + BK < K;
    if (more) {
      fetch_rows_tile(pa, in, r0, k0 + BK, R, K, K);
      fetch_cols_tile(pb, t, k0 + BK, n0, K, N);
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
      store_cols_tile(Bs + (buf ^ 1) * TILE, pb);
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

// acc (8 x 4) = tab[r0:r0+BM, :kdim] . Bsm[:kdim, tx*4 : tx*4+4], the table
// streamed through the two stages of ts in BK-deep tiles, Bsm resident (rows
// padded with zeros to a multiple of BK).
__device__ inline void slab_product(float (&acc)[8][4], float* ts,
                                    const float* __restrict__ tab, int r0, int rows,
                                    int kdim, const float* Bsm) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float p[PER];
  fetch_rows_tile(p, tab, r0, 0, rows, kdim, kdim);
  store_rows_tile(ts, p);
  __syncthreads();
  for (int k0 = 0, buf = 0; k0 < kdim; k0 += BK, buf ^= 1) {
    const bool more = k0 + BK < kdim;
    if (more) fetch_rows_tile(p, tab, r0, k0 + BK, rows, kdim, kdim);
    const float* t = ts + buf * TILE;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&t[kk * (BM + PAD) + ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&t[kk * (BM + PAD) + 64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bsm[(k0 + kk) * SLAB + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store_rows_tile(ts + (buf ^ 1) * TILE, p);
    __syncthreads();
  }
}

// One block per slab of SLAB columns of the (B*L1)-column intermediates:
//   A (L0 x SLAB) = (q0a . u[:, slab]) * w[:, col % L1]   (shared memory only)
//   c[:, slab] = q0s . A                                   (o0 x SLAB, to device memory)
__global__ void __launch_bounds__(NT, 2) middle_kernel(
    const float* __restrict__ u, const float* __restrict__ q0a,
    const float* __restrict__ w, const float* __restrict__ q0s,
    float* __restrict__ c, int i0, int L0, int L1, int o0, int ncols) {
  constexpr int S = SLAB;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int i0p = round_up(i0, BK), L0p = round_up(L0, BK);
  float* Us = smem;            // [i0p][S]
  float* As = Us + i0p * S;    // [L0p][S]
  float* Ts = As + L0p * S;    // two stages of [BK][BM + PAD]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c0 = blockIdx.x * S;

  for (int e = tid; e < i0p * S; e += NT) {
    const int k = e / S, col = c0 + e % S;
    Us[e] = (k < i0 && col < ncols) ? u[(size_t)k * ncols + col] : 0.f;
  }
  for (int e = L0 * S + tid; e < L0p * S; e += NT) As[e] = 0.f;
  __syncthreads();

  float acc[8][4];
  // stage 1: the embedded slab, scaled by the spectrum
  for (int r0 = 0; r0 < L0; r0 += BM) {
    slab_product(acc, Ts, q0a, r0, L0, i0, Us);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + tile_idx(ty, i);
      if (r >= L0) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = tx * 4 + j;
        As[r * S + cc] = acc[i][j] * w[(size_t)r * L1 + (c0 + cc) % L1];
      }
    }
  }
  __syncthreads();

  // stage 2: leading-axis synthesis of the slab
  for (int r0 = 0; r0 < o0; r0 += BM) {
    slab_product(acc, Ts, q0s, r0, o0, L0, As);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + tile_idx(ty, i);
      if (r >= o0) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx * 4 + j;
        if (col < ncols) c[(size_t)r * ncols + col] = acc[i][j];
      }
    }
  }
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

size_t middle_smem_bytes(int i0, int L0) {
  return ((size_t)(round_up(i0, BK) + round_up(L0, BK)) * SLAB + 2 * TILE) * sizeof(float);
}

}  // namespace

extern "C" {

// Shared memory the middle pass needs (98 KB at i0 = 125, L0 = 250; up to
// 207 KB for a cropped input at L0 = 512); the wrapper refuses shapes above
// the card's 227 KB before it launches.
size_t mxu2d_middle_smem_bytes(int i0, int L0) { return middle_smem_bytes(i0, L0); }

// Floats of the self-dot partials buffer: one per output row and column tile.
size_t mxu2d_partial_floats(int B, int o0, int o1) {
  return (size_t)o0 * B * ((o1 + BN - 1) / BN);
}

// Scratch the caller passes: u (i0*B*L1 floats), c (o0*B*L1) and, with dots,
// partial (mxu2d_partial_floats).
int mxu2d_sandwich(const float* x, const float* q0a, const float* q1a, const float* q0s,
                   const float* q1s, const float* w, float* y, float* dots, float* u,
                   float* c, float* partial, int B, int i0, int i1, int L0, int L1, int o0,
                   int o1, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err;
  const int ncols = B * L1;

  // 1. u (i0, B, L1) = x (B*i0, i1) . q1a
  {
    const int R = B * i0;
    dim3 grid((L1 + BN - 1) / BN, (R + BM - 1) / BM);
    row_gemm_kernel<<<grid, NT, 0, stream>>>(x, q1a, u, R, i1, L1, i0, B, nullptr, nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // 2. c (o0, B, L1) = q0s . ((q0a . u) * w), slab by slab
  {
    const size_t smem = middle_smem_bytes(i0, L0);
    if ((err = cudaFuncSetAttribute(middle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return (int)err;
    middle_kernel<<<(ncols + SLAB - 1) / SLAB, NT, smem, stream>>>(u, q0a, w, q0s, c, i0, L0,
                                                                   L1, o0, ncols);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // 3. y (B, o0, o1) = c (o0*B, L1) . q1s, with the self-dot partials
  const int R = o0 * B;
  const int nct = (o1 + BN - 1) / BN;
  {
    dim3 grid(nct, (R + BM - 1) / BM);
    row_gemm_kernel<<<grid, NT, 0, stream>>>(c, q1s, y, R, L1, o1, B, o0,
                                             dots ? x : nullptr, dots ? partial : nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // 4. dots[b], summed in a fixed order
  if (dots) {
    dots_reduce_kernel<<<B, NT, 0, stream>>>(partial, dots, B, o0, nct);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
