// Kernel A and kernel B-8: the cropped 2-D real-Fourier sandwich, FFT-structured,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels hipgp_tpu/ops/mxu2d.py:_make_kernel (kernel A,
// launched by `_pallas_sandwich` at its pl.pallas_call, mxu2d.py:201) and
// hipgp_tpu/ops/pallas_transform.py:_kernel (B-8, launched by `_pallas_apply`,
// pallas_transform.py:99).  For every sample b it computes
//
//     y[b] = P_o (Q0 x Q1) diag(w) (Q0 x Q1)^T P_i^T x[b]
//
// (the real-basis sandwich of the TPU kernels) and, when `dots` is given,
// dots[b] = <x[b], y[b]>, through the DFT of the zero-padded (L0, L1) plane.
// With a plane index (W > 1) it is also kernel B-5's route for planes whose
// half spectrum does not fit one block (csrc/sandwich_wp.cu): x is a stack of
// B * W planes, plane s weighted by w[s % W], and dots sum each sample's W
// planes.
// Column k of the real Fourier basis is the cosine (k <= L/2) or the sine
// (k > L/2) of frequency min(k, L-k), so for a w even in each axis,
// w[k0][k1] = w[L0-k0][k1] = w[k0][L1-k1], this is the circulant apply
//     y[b] = crop( irfft2( w[:, :L1/2+1] * rfft2( pad(x[b]) ) ) ).
// The spectra the solver passes are even only up to rounding (a float32
// spectrum's smallest entries are off by up to ~1e-4 relative, which 1/wK
// turns into a 1e-5 change of y), so the scale step below applies w exactly
// as the real basis does, with its odd parts: y is the sandwich for any w.
// Crops: the input (i0, i1) and the output (o0, o1) are each either the grid
// (d0, d1) or the embedding (L0, L1): the self-dot apply d -> d, R^T d -> L,
// its pullback L -> d, and B-8 L -> L.
//
// Bound on this card.  At the PCG shape, (256, 125, 125) -> (256, 125, 125)
// through (250, 250), a pruned radix-2 FFT count is 0.99 GFLOP (0.015 ms at
// the 67 TFLOP/s FP32 peak) against 32 MB of input and output (0.010 ms at
// 3.35 TB/s).  This kernel does ~4.4 GFLOP (one Cooley-Tukey step per axis,
// below) and moves x in, two round trips of the (B, L1/2+1, .) complex half
// spectrum and y out, ~180 MB (part of it in the 50 MB L2): ~0.065 ms by
// either count.  It is bound by its operations: the DFT steps take most of
// its time, and the whole runs at ~19 % of the FP32 peak at that shape.  A
// dense formulation would do 12.0 GFLOP of real-DFT contractions and hold
// an (i0 + L0) x 64 slab in shared memory, capping the embedded axis at 432;
// here a block holds 32 rows or 16 columns of one axis, so every axis up to
// 512 fits.
//
// Each length-L DFT is one Cooley-Tukey step L = P * Q with P, Q <= 32 (every
// {2,3,5}-smooth L <= 512 splits so): input n = Q n1 + n2, output k = k1 + P k2,
//     A[k1][n2]    = tw^{n2 k1} sum_{n1} x[Q n1 + n2] tP^{k1 n1}     (step 1)
//     X[k1 + P k2] = sum_{n2} A[k1][n2] tQ^{k2 n2}                   (step 2)
// with the P- and Q-point DFT matrices and the twiddles read from a table the
// wrapper builds in float64 and rounds to float32 (no sincosf, no fast math).
// Zero inputs are skipped in step 1 (n < nin) and outputs past the crop are
// never formed in step 2 (k < nout), so the work is P * nin + Q * nout complex
// multiply-adds; the wrapper orients each transform, (P, Q) or (Q, P), to the
// smaller count.  Each step is a small complex matrix product per column: a
// thread owns a 2-column x 4-output tile, its sums in registers, and reads
// two table entries at a time as one float4 broadcast from shared memory,
// with no branch between the reads (the table rows are padded with zeros).
// All arithmetic is full FP32 FMA on the CUDA cores.
//
// The passes, on the caller's stream:
//   1. rows_forward: 32 input rows per block, staged in shared memory; the
//      real-input DFT along the minor axis, half spectrum bins k < L1/2 + 1,
//      written as s1 (B, L1/2+1, i0) complex (coalesced across rows);
//   2. columns: 16 spectrum columns (b, k1) per block, each a contiguous run
//      of i0 values of s1; the forward length-L0 DFT, the scale by
//      w[:, k1] and w[:, L1-k1] / (L0 L1) (frequency pairs k0, L0-k0
//      together), the inverse DFT to the o0 output rows, all in shared
//      memory (a column is at most 512 complex values); written as s2
//      (B, L1/2+1, o0);
//   3. rows_inverse: 32 output rows per block read from s2 (coalesced); the
//      inverse real DFT from the half spectrum (bins 0 < k < L1/2 count twice,
//      the real part kept), o1 outputs; y written through shared memory; with
//      dots, each row's <x, y> summed by one warp in a fixed order;
//   4. with dots, dots_reduce: the o0 row dots of each sample in a fixed order
//      (no atomics, so the self-dots are deterministic).
//
// Interface: plain C, returns the cudaError_t of the first failing call (0 on
// success).  Launches on `stream`, never synchronises, allocates nothing: the
// caller passes every output and scratch buffer.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Block and tile sizes, chosen by timing variants at the 2-D main path's
// shapes on the card: tiles of 2 x 4 beat 1 x all, 2 x 8, 4 x 2, 4 x 4 and
// 8 x 2; 32 rows and 16 columns per block beat 16 or 64 rows and 32 columns;
// the tables in shared memory beat reading them through L1.
constexpr int NT = 256;      // threads per block
constexpr int ROWS = 32;     // rows per block of the minor-axis passes
constexpr int COLS = 16;     // spectrum columns per block of the leading-axis pass
constexpr int TR = 2;        // columns of a thread's tile in the DFT steps
constexpr int TC = 4;        // outputs of a thread's tile in the DFT steps
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use (sm_90)
static_assert(NT % ROWS == 0 && NT % COLS == 0, "a thread keeps its row or column");
static_assert(ROWS % TR == 0 && COLS % TR == 0, "tiles divide the rows and columns");
static_assert(TC % 2 == 0 && 8 % TC == 0, "tiles read the tables two entries at a time");

__host__ __device__ inline int pad8(int n) { return (n + 7) & ~7; }

// One oriented split L = P * Q of one direction: input n = Q n1 + n2
// (n1 < P), output k = k1 + P k2 (k2 < Q).  `tab` points at its block of the
// table, laid out as the kernel keeps it in shared memory:
//   tp[n1 * pp + k1]  the P x P DFT matrix (symmetric), rows padded to pp = pad8(P)
//   tq[n2 * qp + k2]  the Q x Q DFT matrix, rows padded to qp = pad8(Q)
//   tw[n2 * pp + k1]  the twiddles e^{+-2 pi i n2 k1 / L}
// the padding zero, so that a thread reads every entry of its tile with no
// branch between the reads (the zeros feed sums that are never stored).
struct Split {
  const float2* tab;
  int P, Q;
};

__host__ __device__ inline int split_float2s(int P, int Q) {
  return P * pad8(P) + Q * pad8(Q) + Q * pad8(P);
}

// The table of a length L = a * b (a <= b), as the wrapper builds it: for the
// forward and then the inverse direction, the splits (P, Q) = (a, b) and
// (b, a).  `swap` takes the second.
__host__ Split make_split(const float2* tab, int a, int b, int inverse, int swap) {
  const int sab = split_float2s(a, b), sba = split_float2s(b, a);
  const float2* base = tab + (size_t)inverse * (sab + sba) + (swap ? sab : 0);
  return swap ? Split{base, b, a} : Split{base, a, b};
}

// Strides of the step-1 output A[col][k1][n2] of a split (P, Q): a k1 row
// every Q | 1 entries, a column every a_stride; both odd, so that the 8-byte
// accesses of consecutive columns fall in distinct banks.
__host__ __device__ inline int a_stride(int P, int Q) { return (P * (Q | 1)) | 1; }
__host__ __device__ inline int a_stride(const Split& s) { return a_stride(s.P, s.Q); }

// e / d for 0 <= e < 2^16 and 0 < d <= 2^10 (the indices within one block's
// rows or columns) through a float reciprocal: (e + 1/2) / d is at least
// 1 / (2 d) from an integer, far more than the float rounding of the product.
struct FastDiv {
  int d;
  float inv;
  __device__ explicit FastDiv(int d_) : d(d_), inv(1.0f / (float)d_) {}
  __device__ int div(int e) const { return (int)(((float)e + 0.5f) * inv); }
};

// For e < n: put(e, get(e)), UNROLL loads in flight per thread before their
// stores (the block's copies between device and shared memory).
template <int UNROLL, class Get, class Put>
__device__ inline void block_copy(int n, Get get, Put put) {
  for (int e0 = threadIdx.x; e0 < n; e0 += UNROLL * blockDim.x) {
    decltype(get(0)) v[UNROLL];
#pragma unroll
    for (int q = 0; q < UNROLL; ++q) {
      const int e = e0 + q * blockDim.x;
      if (e < n) v[q] = get(e);
    }
#pragma unroll
    for (int q = 0; q < UNROLL; ++q) {
      const int e = e0 + q * blockDim.x;
      if (e < n) put(e, v[q]);
    }
  }
}

// put(e, src[e]) for e < n, the loads four floats wide where src is 16-byte
// aligned.
template <class Put>
__device__ inline void load_floats(const float* src, int n, Put put) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    block_copy<4>(n / 4, [&](int e) { return s4[e]; }, [&](int e, float4 v) {
      put(4 * e, v.x);
      put(4 * e + 1, v.y);
      put(4 * e + 2, v.z);
      put(4 * e + 3, v.w);
    });
    done = 4 * (n / 4);
  }
  block_copy<8>(n - done, [&](int e) { return src[done + e]; },
                [&](int e, float v) { put(done + e, v); });
}

// The shared-memory copy of one split's table block (contiguous, a multiple
// of 8 float2, 16-byte aligned).
struct Tables {
  const float2 *tp, *tq, *tw;
  int P, Q, pp, qp;
};

__device__ inline Tables load_tables(const Split& s, float2* buf) {
  const int n4 = split_float2s(s.P, s.Q) / 2;
  const float4* src = reinterpret_cast<const float4*>(s.tab);
  float4* dst = reinterpret_cast<float4*>(buf);
  block_copy<4>(n4, [&](int e) { return __ldg(src + e); }, [&](int e, float4 v) { dst[e] = v; });
  const int pp = pad8(s.P), qp = pad8(s.Q);
  return Tables{buf, buf + s.P * pp, buf + s.P * pp + s.Q * qp, s.P, s.Q, pp, qp};
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// acc += v * t (complex, or real v)
__device__ __forceinline__ void cmac(float2& acc, float v, float tx, float ty) {
  acc.x = fmaf(v, tx, acc.x);
  acc.y = fmaf(v, ty, acc.y);
}
__device__ __forceinline__ void cmac(float2& acc, float2 v, float tx, float ty) {
  acc.x = fmaf(v.x, tx, acc.x);
  acc.x = fmaf(-v.y, ty, acc.x);
  acc.y = fmaf(v.x, ty, acc.y);
  acc.y = fmaf(v.y, tx, acc.y);
}

// Step 1 for `ncols` columns: A[c][k1][n2] for every k1 < P, n2 < Q from the
// inputs in(c, n) for n < nin (float when REAL_IN, else float2); n1 runs to
// ceil(nin / Q) only, and in() is not asked for n >= nin (those inputs are
// zero).  A thread owns a tile: TR columns (ncols / TR apart) of one n2 and
// TC outputs k1, so that each table entry it reads serves TR columns and each
// input TC outputs.
template <bool REAL_IN, class In>
__device__ inline void dft_step1(const Tables& t, int nin, int ncols, float2* A, In in) {
  using V = typename std::conditional<REAL_IN, float, float2>::type;
  const int qs = t.Q | 1, rs = a_stride(t.P, t.Q);
  const int cnt = min(t.P, (nin + t.Q - 1) / t.Q);
  const int ng = ncols / TR, nch = (t.P + TC - 1) / TC;
  for (int it = threadIdx.x; it < ng * nch * t.Q; it += blockDim.x) {
    const int cg = it % ng, g = (it / ng) % nch, n2 = it / ng / nch;
    float2 acc[TR][TC];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int k = 0; k < TC; ++k) acc[r][k] = make_float2(0.f, 0.f);
    for (int n1 = 0; n1 < cnt; ++n1) {
      const int n = t.Q * n1 + n2;
      V v[TR];
#pragma unroll
      for (int r = 0; r < TR; ++r) v[r] = n < nin ? in(cg + r * ng, n) : V{};
      const float4* row = reinterpret_cast<const float4*>(t.tp + n1 * t.pp + g * TC);
#pragma unroll
      for (int j = 0; j < TC / 2; ++j) {
        const float4 q = row[j];
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          cmac(acc[r][2 * j], v[r], q.x, q.y);
          cmac(acc[r][2 * j + 1], v[r], q.z, q.w);
        }
      }
    }
    const float4* tw = reinterpret_cast<const float4*>(t.tw + n2 * t.pp + g * TC);
#pragma unroll
    for (int j = 0; j < TC / 2; ++j) {
      const float4 q = tw[j];
      const int k = g * TC + 2 * j;
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        float2* a = A + (cg + r * ng) * rs + n2;
        if (k < t.P) a[k * qs] = cmul(acc[r][2 * j], make_float2(q.x, q.y));
        if (k + 1 < t.P) a[(k + 1) * qs] = cmul(acc[r][2 * j + 1], make_float2(q.z, q.w));
      }
    }
  }
}

// Step 2 for `ncols` columns: X[c][k] for k < nout, handed to out(c, k, X);
// with REAL_OUT only the real part is formed (its .y is 0).  A thread owns a
// tile: TR columns of one k1 and TC of its outputs k1 + P k2 < nout.
template <bool REAL_OUT, class Out>
__device__ inline void dft_step2(const Tables& t, int nout, int ncols, const float2* A,
                                 Out out) {
  const int qs = t.Q | 1, rs = a_stride(t.P, t.Q);
  const int ng = ncols / TR, nch = ((nout + t.P - 1) / t.P + TC - 1) / TC;
  for (int it = threadIdx.x; it < ng * nch * t.P; it += blockDim.x) {
    const int cg = it % ng, g = (it / ng) % nch, k1 = it / ng / nch;
    const int nk = k1 < nout ? (nout - k1 + t.P - 1) / t.P : 0;   // outputs of this k1
    if (g * TC >= nk) continue;
    float2 acc[TR][TC];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int k = 0; k < TC; ++k) acc[r][k] = make_float2(0.f, 0.f);
    for (int n2 = 0; n2 < t.Q; ++n2) {
      float2 v[TR];
#pragma unroll
      for (int r = 0; r < TR; ++r) v[r] = A[(cg + r * ng) * rs + k1 * qs + n2];
      const float4* row = reinterpret_cast<const float4*>(t.tq + n2 * t.qp + g * TC);
#pragma unroll
      for (int j = 0; j < TC / 2; ++j) {
        const float4 q = row[j];
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          if constexpr (REAL_OUT) {
            acc[r][2 * j].x = fmaf(v[r].x, q.x, fmaf(-v[r].y, q.y, acc[r][2 * j].x));
            acc[r][2 * j + 1].x = fmaf(v[r].x, q.z, fmaf(-v[r].y, q.w, acc[r][2 * j + 1].x));
          } else {
            cmac(acc[r][2 * j], v[r], q.x, q.y);
            cmac(acc[r][2 * j + 1], v[r], q.z, q.w);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < TC; ++k)
      if (g * TC + k < nk)
#pragma unroll
        for (int r = 0; r < TR; ++r) out(cg + r * ng, k1 + t.P * (g * TC + k), acc[r][k]);
  }
}

// Pass 1.  Rows R < nrows = B * i0 of x, each i1 floats (zero-padded to L1):
// s1[(b * H + k) * i0 + r] = sum_n x[b][r][n] e^{-2 pi i k n / L1}, k < H.
__global__ void __launch_bounds__(NT) rows_forward_kernel(
    const float* __restrict__ x, float2* __restrict__ s1, Split sp, int nrows, int i0,
    int i1, int H) {
  extern __shared__ float4 smem4[];
  float2* as = reinterpret_cast<float2*>(smem4);              // [ROWS][a_stride]
  float2* tb = as + ROWS * a_stride(sp);                       // the table block
  // row R0 + c = (b, r) starts at s1 + rowbase[c], its bins i0 apart
  size_t* rowbase = reinterpret_cast<size_t*>(tb + split_float2s(sp.P, sp.Q));
  float* xs = reinterpret_cast<float*>(rowbase + ROWS);        // [ROWS][xst]
  const int xst = i1 | 1;
  const int R0 = blockIdx.x * ROWS;
  const Tables t = load_tables(sp, tb);
  // the block's rows are one contiguous run of x
  const FastDiv d1(i1);
  load_floats(x + (size_t)R0 * i1, min(ROWS, nrows - R0) * i1, [&](int e, float v) {
    const int r = d1.div(e);
    xs[r * xst + e - r * i1] = v;
  });
  __syncthreads();
  dft_step1<true>(t, i1, ROWS, as, [&](int c, int n) { return xs[c * xst + n]; });
  __syncthreads();
  if (threadIdx.x < ROWS) {
    const int R = R0 + threadIdx.x;
    rowbase[threadIdx.x] = (size_t)(R / i0) * H * i0 + R % i0;
  }
  __syncthreads();
  dft_step2<false>(t, H, ROWS, as, [&](int c, int k, float2 v) {
    if (R0 + c < nrows) s1[rowbase[c] + (size_t)k * i0] = v;
  });
}

// Pass 2.  Columns j < ncols = B * H of s1 (column j = (b, k1) with
// k1 = j % H, i0 values each; plane b weighted by w[b % W]):
//   s2[j * o0 + m] = (1 / L0) sum_{k0 < L0} e^{+2 pi i k0 m / L0} Z[k0]  (m < o0),
//   U[k0] = sum_{n < i0} s1[j * i0 + n] e^{-2 pi i k0 n / L0},
// Z = U scaled by w as the real basis applies it (see the scale step), / L1.
__global__ void __launch_bounds__(NT) columns_kernel(
    const float2* __restrict__ s1, float2* __restrict__ s2, const float* __restrict__ w,
    Split fw, Split iv, int ncols, int H, int L1, int i0, int L0, int o0, int W, float scale) {
  extern __shared__ float4 smem4[];
  const int cst = L0 | 1;
  const int rs = a_stride(fw) > a_stride(iv) ? a_stride(fw) : a_stride(iv);
  float2* as = reinterpret_cast<float2*>(smem4);   // [COLS][rs]
  float2* tb = as + COLS * rs;                     // the two table blocks
  float2* cb = tb + split_float2s(fw.P, fw.Q) + split_float2s(iv.P, iv.Q);   // [COLS][cst]
  const int j0 = blockIdx.x * COLS;
  const Tables tf = load_tables(fw, tb);
  const Tables ti = load_tables(iv, tb + split_float2s(fw.P, fw.Q));
  // the block's columns are one contiguous run of s1, and of s2
  const int nc = min(COLS, ncols - j0);
  const float2* s1b = s1 + (size_t)j0 * i0;
  const FastDiv di(i0);
  block_copy<8>(nc * i0, [&](int e) { return s1b[e]; }, [&](int e, float2 v) {
    const int c = di.div(e);
    cb[c * cst + e - c * i0] = v;
  });
  __syncthreads();
  dft_step1<false>(tf, i0, COLS, as, [&](int c, int n) { return cb[c * cst + n]; });
  __syncthreads();
  dft_step2<false>(tf, L0, COLS, as, [&](int c, int k, float2 v) { cb[c * cst + k] = v; });
  __syncthreads();
  // The scale, as the real basis applies it (any w, even or not): the column
  // U = FFT(Cx) - i FFT(Sx) carries the cosine (Cx) and sine (Sx) parts of
  // minor-axis frequency k1, which the real basis weighs with w[:, k1] and
  // w[:, L1-k1]; each part is the spectrum R of a real column, whose
  // frequency pair (k, L0-k) the real basis weighs as Re R_k w[k] and
  // Im R_k w[L0-k].  Both parts are recovered from U_k and U_{L0-k}.  A
  // thread keeps its column c; its pairs k are blockDim / COLS apart.
  {
    const int c = threadIdx.x % COLS, kstep = blockDim.x / COLS;
    const int k1 = (j0 + c) % H, k1s = k1 ? L1 - k1 : 0;
    const float* wl = w + (size_t)(((j0 + c) / H) % W) * L0 * L1;
    const float *wc = wl + k1, *ws = wl + k1s;
    float2* col = cb + c * cst;
    for (int k0 = threadIdx.x / COLS; k0 <= L0 / 2; k0 += 4 * kstep) {
      float4 g[4];   // (w[k][k1], w[kr][k1], w[k][k1s], w[kr][k1s])
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + q * kstep, kr = k ? L0 - k : 0;
        if (k <= L0 / 2)
          g[q] = make_float4(__ldg(wc + (size_t)k * L1), __ldg(wc + (size_t)kr * L1),
                             __ldg(ws + (size_t)k * L1), __ldg(ws + (size_t)kr * L1));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + q * kstep, kr = k ? L0 - k : 0;
        if (k > L0 / 2) break;
        const float2 u = col[k], v = col[kr];
        // Rc = (U_k + conj U_kr) / 2, Rs = i (U_k - conj U_kr) / 2
        const float rcx = 0.5f * (u.x + v.x), rcy = 0.5f * (u.y - v.y);
        const float rsx = -0.5f * (u.y + v.y), rsy = 0.5f * (u.x - v.x);
        const float zcx = rcx * g[q].x * scale, zcy = rcy * g[q].y * scale;
        const float zsx = rsx * g[q].z * scale, zsy = rsy * g[q].w * scale;
        // Z_k = Zc - i Zs, Z_kr = conj Zc - i conj Zs
        col[k] = make_float2(zcx + zsy, zcy - zsx);
        if (kr != k) col[kr] = make_float2(zcx - zsy, -zcy - zsx);
      }
    }
  }
  __syncthreads();
  dft_step1<false>(ti, L0, COLS, as, [&](int c, int n) { return cb[c * cst + n]; });
  __syncthreads();
  dft_step2<false>(ti, o0, COLS, as, [&](int c, int m, float2 v) { cb[c * cst + m] = v; });
  __syncthreads();
  float2* s2b = s2 + (size_t)j0 * o0;
  const FastDiv dout(o0);
  block_copy<8>(nc * o0, [&](int e) {
    const int c = dout.div(e);
    return cb[c * cst + e - c * o0];
  }, [&](int e, float2 v) { s2b[e] = v; });
}

// Pass 3.  Output rows R < nrows = B * o0 (R = (b, m)):
//   y[R * o1 + n] = Re sum_{k < H} c_k s2[(b * H + k) * o0 + m] e^{+2 pi i k n / L1},
// c_k = 1 at k = 0 and k = L1/2, else 2 (the half spectrum's mirror); with
// xdot, rowdot[R] = sum_n xdot[R * o1 + n] y[R * o1 + n].
__global__ void __launch_bounds__(NT) rows_inverse_kernel(
    const float2* __restrict__ s2, float* __restrict__ y, const float* __restrict__ xdot,
    float* __restrict__ rowdot, Split sp, int nrows, int o0, int H, int L1, int o1) {
  extern __shared__ float4 smem4[];
  float2* as = reinterpret_cast<float2*>(smem4);              // [ROWS][a_stride]
  float2* tb = as + ROWS * a_stride(sp);                       // the table block
  // the input rows [ROWS][ist]; then the output rows [ROWS][yst]
  float2* ins = tb + split_float2s(sp.P, sp.Q);
  float* ys = reinterpret_cast<float*>(ins);
  const int ist = H | 1, yst = o1 | 1;
  const int R0 = blockIdx.x * ROWS;
  const Tables t = load_tables(sp, tb);
  {
    // thread (c, k0) with c = threadIdx.x % ROWS reads k = k0, k0 + kstep, ...
    // of row R0 + c: the rows of one k are consecutive in s2, so a warp's
    // reads are coalesced; 8 of them in flight per thread
    const int c = threadIdx.x % ROWS, R = R0 + c, kstep = blockDim.x / ROWS;
    if (R < nrows) {
      const float2* src = s2 + (size_t)(R / o0) * H * o0 + R % o0;
      for (int k0 = threadIdx.x / ROWS; k0 < H; k0 += 8 * kstep) {
        float2 v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (k0 + q * kstep < H) v[q] = src[(size_t)(k0 + q * kstep) * o0];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int k = k0 + q * kstep;
          if (k >= H) break;
          const float g = (k == 0 || 2 * k == L1) ? 1.f : 2.f;
          ins[c * ist + k] = make_float2(g * v[q].x, g * v[q].y);
        }
      }
    }
  }
  __syncthreads();
  dft_step1<false>(t, H, ROWS, as, [&](int c, int k) { return ins[c * ist + k]; });
  __syncthreads();
  dft_step2<true>(t, o1, ROWS, as, [&](int c, int n, float2 v) { ys[c * yst + n] = v.x; });
  __syncthreads();
  // the block's rows are one contiguous run of y (and of xdot)
  const int nr = min(ROWS, nrows - R0);
  float* yb = y + (size_t)R0 * o1;
  const FastDiv d1(o1);
  for (int e = threadIdx.x; e < nr * o1; e += blockDim.x) {
    const int r = d1.div(e);
    yb[e] = ys[r * yst + e - r * o1];
  }
  if (!xdot) return;
  __syncthreads();
  load_floats(xdot + (size_t)R0 * o1, nr * o1, [&](int e, float v) {
    const int r = d1.div(e);
    ys[r * yst + e - r * o1] *= v;
  });
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < nr; c += blockDim.x >> 5) {
    float s = 0.f;
    for (int n = lane; n < o1; n += 32) s += ys[c * yst + n];
#pragma unroll
    for (int h = 16; h > 0; h >>= 1) s += __shfl_xor_sync(0xffffffffu, s, h);
    if (lane == 0) rowdot[R0 + c] = s;
  }
}

// Pass 4.  dots[b] = sum_{m < o0} rowdot[b * o0 + m], in a fixed order (o0
// counts the rows of all W planes of a sample).
__global__ void __launch_bounds__(NT) dots_reduce_kernel(const float* __restrict__ rowdot,
                                                         float* __restrict__ dots, int o0) {
  __shared__ float red[NT];
  const int b = blockIdx.x;
  float s = 0.f;
  for (int m = threadIdx.x; m < o0; m += NT) s += rowdot[(size_t)b * o0 + m];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = NT / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) dots[b] = red[0];
}

// Shared memory of each pass, with SLACK bytes past the last row (a step-1
// read of an input past nin, which it never uses, stays inside the block's
// shared memory).
constexpr size_t SLACK = 32 * sizeof(float2);
size_t rows_forward_smem(const Split& s, int i1) {
  return (ROWS * a_stride(s) + split_float2s(s.P, s.Q)) * sizeof(float2) +
         ROWS * sizeof(size_t) + ROWS * (i1 | 1) * sizeof(float) + SLACK;
}
size_t columns_smem(const Split& fw, const Split& iv, int L0) {
  const int rs = a_stride(fw) > a_stride(iv) ? a_stride(fw) : a_stride(iv);
  return (COLS * ((L0 | 1) + rs) + split_float2s(fw.P, fw.Q) +
          split_float2s(iv.P, iv.Q)) * sizeof(float2) + SLACK;
}
size_t rows_inverse_smem(const Split& s, int H, int o1) {
  const size_t in = ROWS * (H | 1) * sizeof(float2), out = ROWS * (o1 | 1) * sizeof(float);
  return (ROWS * a_stride(s) + split_float2s(s.P, s.Q)) * sizeof(float2) +
         (in > out ? in : out) + SLACK;
}

// The opt-in to more than 48 KB of dynamic shared memory, once per process:
// all a block may use, less the kernel's static shared memory.
template <class K>
cudaError_t allow_smem(K kernel) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_MAX - (int)attr.sharedSizeBytes);
}

cudaError_t configure_once() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err;
  if ((err = allow_smem(rows_forward_kernel))) return err;
  if ((err = allow_smem(columns_kernel))) return err;
  if ((err = allow_smem(rows_inverse_kernel))) return err;
  done = true;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Floats of the table of a length L = a * b: for the forward and then the
// inverse direction, the blocks of the splits (a, b) and (b, a).
int fft_table_floats(int a, int b) { return 4 * (split_float2s(a, b) + split_float2s(b, a)); }

// Largest dynamic shared memory, in bytes, the three passes ask for at this
// shape and orientation (the wrapper refuses a shape above the card's limit).
size_t fft_sandwich_smem_bytes(int i1, int L0, int o1, int a0, int b0, int a1, int b1,
                               int swap1, int swap2f, int swap2i, int swap3) {
  const float2* none = nullptr;
  const size_t s1 = rows_forward_smem(make_split(none, a1, b1, 0, swap1), i1);
  const size_t s2 = columns_smem(make_split(none, a0, b0, 0, swap2f),
                                 make_split(none, a0, b0, 1, swap2i), L0);
  const size_t s3 = rows_inverse_smem(make_split(none, a1, b1, 1, swap3), a1 * b1 / 2 + 1, o1);
  return s1 > s2 ? (s1 > s3 ? s1 : s3) : (s2 > s3 ? s2 : s3);
}
// Kernels A and B-8, and B-5's route for large planes.  x (B, W, i0, i1), w
// (W, L0, L1) full spectra (W = 1 for A and B-8), y (B, W, o0, o1), dots (B);
// tab0 and tab1 the tables of L0 = a0 * b0 and L1 = a1 * b1; swap* the
// orientations of pass 1, the forward and inverse transforms of pass 2, and
// pass 3.  Scratch: s1 (B*W*H*i0 complex), s2 (B*W*H*o0 complex) and, with
// dots, rowdot (B*W*o0 floats), H = L1/2 + 1.
int fft_sandwich(const float* x, const float* w, const float* tab0, const float* tab1,
                 float* y, float* dots, float* s1, float* s2, float* rowdot, int B, int W, int i0,
                 int i1, int L0, int L1, int o0, int o1, int a0, int b0, int a1, int b1,
                 int swap1, int swap2f, int swap2i, int swap3, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err;
  if ((err = configure_once())) return (int)err;
  const float2* t0 = reinterpret_cast<const float2*>(tab0);
  const float2* t1 = reinterpret_cast<const float2*>(tab1);
  const Split p1 = make_split(t1, a1, b1, 0, swap1);
  const Split p2f = make_split(t0, a0, b0, 0, swap2f);
  const Split p2i = make_split(t0, a0, b0, 1, swap2i);
  const Split p3 = make_split(t1, a1, b1, 1, swap3);
  const int H = L1 / 2 + 1;
  const int P = B * W;   // planes
  float2* c1 = reinterpret_cast<float2*>(s1);
  float2* c2 = reinterpret_cast<float2*>(s2);
  {
    const int nrows = P * i0;
    rows_forward_kernel<<<(nrows + ROWS - 1) / ROWS, NT, rows_forward_smem(p1, i1), stream>>>(
        x, c1, p1, nrows, i0, i1, H);
    if ((err = cudaGetLastError())) return (int)err;
  }
  {
    const int ncols = P * H;
    columns_kernel<<<(ncols + COLS - 1) / COLS, NT, columns_smem(p2f, p2i, L0), stream>>>(
        c1, c2, w, p2f, p2i, ncols, H, L1, i0, L0, o0, W,
        (float)(1.0 / ((double)L0 * (double)L1)));
    if ((err = cudaGetLastError())) return (int)err;
  }
  {
    const int nrows = P * o0;
    rows_inverse_kernel<<<(nrows + ROWS - 1) / ROWS, NT, rows_inverse_smem(p3, H, o1), stream>>>(
        c2, y, dots ? x : nullptr, dots ? rowdot : nullptr, p3, nrows, o0, H, L1, o1);
    if ((err = cudaGetLastError())) return (int)err;
  }
  if (dots) {
    dots_reduce_kernel<<<B, NT, 0, stream>>>(rowdot, dots, W * o0);
    if ((err = cudaGetLastError())) return (int)err;
  }
  return 0;
}

}  // extern "C"
