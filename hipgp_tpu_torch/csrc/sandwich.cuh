// Tile primitives of the dense real-Fourier sandwich: the whole-sample 3-D
// kernel B-6 (mxu3d.cu).  Kernels A, B-5 and B-8 are FFT-structured
// (sandwich_fft.cu, sandwich_wp.cu) and do not use them.
//
// Every contraction is a dense product with a rectangular slab of the
// orthonormal real Fourier basis, in full FP32 FMA on the CUDA cores (no
// TF32: one-pass reduced precision breaks these DFT-like sums).  A block of
// NT = 256 threads computes one output tile at a time: each thread owns an
// 8 x RN register tile (RN = 8, 4 or 2), reads its operands from shared
// memory as float4 (or float2), and the BK-deep operand tiles staged from
// device memory are double-buffered: while the block multiplies one shared-
// memory stage, each thread holds its part of the next tile in registers and
// stores it into the other stage afterwards, so one barrier per stage
// suffices and the device-memory (mostly L2) latency hides behind the FMAs.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace sandwich {

constexpr int NT = 256;   // threads per block, as 16 x 16 (ty, tx)
constexpr int BM = 128;   // rows of an output tile
constexpr int BK = 8;     // depth of one shared-memory stage
constexpr int PAD = 4;    // keeps float4 alignment and spreads the transposed stores
constexpr int SLAB = 64;  // columns per middle-pass slab: 4 per thread

__host__ __device__ inline int round_up(int a, int m) { return (a + m - 1) / m * m; }

// Row (or column) owned by slot ii (0..7) of thread index t within a 128-wide
// tile: two groups of four consecutive indices, 64 apart, each one float4.
__device__ inline int tile_idx(int t, int ii) { return (ii < 4 ? 0 : 64) + t * 4 + (ii & 3); }

// Column owned by slot j of thread tx in a tile 16 * RN wide.
template <int RN>
__device__ inline int col_idx(int tx, int j) {
  if constexpr (RN == 8) return tile_idx(tx, j);
  else return tx * RN + j;
}

constexpr int TILE = BK * (BM + PAD);   // floats of one staged (BK x 128) tile
constexpr int PER = BM * BK / NT;        // elements of an A tile each thread moves

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

// This thread's part of the (BK x TN) tile src[k0:k0+BK, n0:n0+TN] of a
// row-major (K x N) matrix; zero outside it.
template <int TN>
__device__ inline void fetch_cols_tile(float (&p)[BK * TN / NT], const float* __restrict__ src,
                                       int k0, int n0, int K, int N) {
#pragma unroll
  for (int t = 0; t < BK * TN / NT; ++t) {
    const int e = threadIdx.x + t * NT, k = k0 + e / TN, n = n0 + e % TN;
    p[t] = (k < K && n < N) ? src[(size_t)k * N + n] : 0.f;
  }
}

// ... stored as ts[BK][TN + PAD].
template <int TN>
__device__ inline void store_cols_tile(float* ts, const float (&p)[BK * TN / NT]) {
#pragma unroll
  for (int t = 0; t < BK * TN / NT; ++t) {
    const int e = threadIdx.x + t * NT;
    ts[(e / TN) * (TN + PAD) + e % TN] = p[t];
  }
}

// The eight A operands of one depth step kk of a staged tile: the thread's
// rows tile_idx(ty, 0..7).
__device__ inline void load_a8(float (&a)[8], const float* as, int kk, int ty) {
  const float4 a0 = *reinterpret_cast<const float4*>(&as[kk * (BM + PAD) + ty * 4]);
  const float4 a1 = *reinterpret_cast<const float4*>(&as[kk * (BM + PAD) + 64 + ty * 4]);
  a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
  a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
}

// The RN B operands of one depth step from a row of width ld: columns
// col_idx<RN>(tx, 0..RN-1).
template <int RN>
__device__ inline void load_b(float (&b)[RN], const float* row, int tx) {
  if constexpr (RN == 8) {
    const float4 b0 = *reinterpret_cast<const float4*>(&row[tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&row[64 + tx * 4]);
    b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
    b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
  } else if constexpr (RN == 4) {
    const float4 b0 = *reinterpret_cast<const float4*>(&row[tx * 4]);
    b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
  } else {
    const float2 b0 = *reinterpret_cast<const float2*>(&row[tx * 2]);
    b[0] = b0.x; b[1] = b0.y;
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
      float a[8], b[4];
      load_a8(a, t, kk, ty);
      load_b<4>(b, &Bsm[(k0 + kk) * SLAB], tx);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store_rows_tile(ts + (buf ^ 1) * TILE, p);
    __syncthreads();
  }
}

// Floats of shared memory the middle pass needs for i0 input and L0 embedded rows.
__host__ __device__ inline size_t middle_smem_floats(int i0, int L0) {
  return (size_t)(round_up(i0, BK) + round_up(L0, BK)) * SLAB + 2 * TILE;
}

// One slab of SLAB columns c0 .. c0+SLAB-1 of the (i0, ncols) matrix u
// (leading dimension ncols), all of it in shared memory:
//   A (L0 x SLAB) = (q0a . u[:, slab]) * w            (shared memory only)
//   c[:, slab]    = q0s . A                            (o0 x SLAB)
// Column col of the slab takes its spectrum column from
//   w[(col / wlm) * wplane + r * wlm + col % wlm]
// (one spectrum: wlm = L1, wplane = 0; a weight-plane stack of (L0, wlm) planes:
// wplane = L0 * wlm).  u is read whole into shared memory before c is
// written, so c may be u itself (o0 <= i0 rows, same leading dimension).
__device__ inline void middle_slab(const float* u, const float* __restrict__ q0a,
                                   const float* __restrict__ w, int wlm, size_t wplane,
                                   const float* __restrict__ q0s, float* c, int i0,
                                   int L0, int o0, int c0, int ncols, float* smem) {
  constexpr int S = SLAB;
  const int i0p = round_up(i0, BK), L0p = round_up(L0, BK);
  float* Us = smem;            // [i0p][S]
  float* As = Us + i0p * S;    // [L0p][S]
  float* Ts = As + L0p * S;    // two stages of [BK][BM + PAD]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

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
        const int cc = tx * 4 + j, col = c0 + cc;
        As[r * S + cc] = acc[i][j] * w[(size_t)(col / wlm) * wplane + (size_t)r * wlm + col % wlm];
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

}  // namespace sandwich
