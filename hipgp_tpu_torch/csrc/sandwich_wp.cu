// Kernel B-5: the cropped 2-D real-Fourier sandwich over a stack of weight
// planes, hand-written for Hopper (sm_90a) as a plane-resident FFT sandwich.
//
// Replaces the Pallas TPU kernel hipgp_tpu/ops/mxu2d.py:_make_kernel_wp
// (launched by `_pallas_sandwich_wp` at its pl.pallas_call), the building
// block of the 3-D sandwich: after the outer-axis analysis a 3-D sample is W
// independent 2-D plane problems, plane l with its own spectrum w[l].  On a
// (B, W, i0, i1) stack it computes
//
//     y[b, l] = P_o (Q0 x Q1) diag(w[l]) (Q0 x Q1)^T P_i^T x[b, l]
//
// and, when `dots` is given, dots[b] = sum_l <x[b, l], y[b, l]>, through the
// DFT of the zero-padded (L0, L1) plane, with w applied as the real basis
// applies it (its odd parts too, so the result is the sandwich for any w; see
// the scale step, the same as kernel A's in csrc/sandwich_fft.cu).
//
// Bound on this card.  At the 3-D main path's self-dot shape, (512, 64, 64, 64)
// through (128, 128) planes, the pruned FFT count is 29.3 GFLOP (0.437 ms at
// the 67 TFLOP/s FP32 peak) against 1.07 GB of x and y (0.32 ms at 3.35 TB/s):
// bound by operations.  The dense kernel this replaces did ~206 GFLOP of
// real-DFT contractions in four launches with two 1.07 GB intermediates in
// device memory (10.9 ms).
//
// What the design does about it.  A 64 x 64 input plane padded to (128, 128)
// has a half spectrum of 64 x 65 complex values (33 KB): the whole plane stays
// in one block's shared memory from x to y.  One block owns one (b, l) plane:
//   1. row pass: pairs of input rows (r, r + ceil(i0/2)) as the real and
//      imaginary parts of one complex row; its length-L1 DFT, read straight
//      from x (the first stage's threads run along the row, so a warp reads
//      consecutive floats); the two half spectra split off into S, the
//      resident (max(i0, o0), (L1 + 1) / 2) complex plane, with bins 0 and
//      L1/2 (both real) as one complex value in column 0, so that the
//      main path's 65 bins make 64 columns;
//   2. column pass, a group of columns at a time: the length-L0 DFT of the i0
//      rows of S that hold data, the scale by w[l] (frequency pairs k0, L0-k0
//      and the columns' cosine and sine parts together), the inverse DFT to
//      the o0 output rows, written back into S;
//   3. row pass back: pairs of output rows as one complex row whose first
//      inverse stage reads its spectrum straight from S (the Hermitian
//      mirror; the imaginary parts of bins 0 and L1/2 dropped, as the real
//      basis does), the real part of the inverse DFT to one row of y and the
//      imaginary part to the other (the last stage's threads run along the
//      row, so a warp writes consecutive floats); with dots, each thread sums
//      x * y of what it writes;
//   4. with dots, the block's sums in a fixed tree order to the plane's dot;
//      a second launch sums each sample's W plane dots in order (no atomics:
//      a second identical call is bit-equal).
// No intermediate goes through device memory beyond the B * W plane dots.
// The grid runs the planes of one weight plane l together (block index
// l * B + b), so w[l] is read from L2 by blocks that run at the same time.
// 70 KB of shared memory and at most 80 registers a thread (the launch
// bounds) give three blocks per SM at the main path's self-dot shape.
//
// Each DFT is a sequence of radix-16, 8, 4, 2, 3 and 5 butterflies
// (`mxu2d.wp_fft_plan`: a length-128 DFT is 16 x 8), in place in shared
// memory: the forward transforms decimate in frequency and leave the spectrum
// in digit-reversed order, the inverse ones decimate in time from that order,
// so no reordering pass is needed; tables map each frequency to its position
// and back for the split, the scale and the row pass back.  A thread keeps
// the R values of one butterfly in registers; twiddles come from the table
// e^{-2 pi i m / L} (m < L) that the wrapper builds in float64 and rounds to
// float32 (no sincosf, no fast math), and are skipped where they are all 1
// (the stage on blocks of R positions).  Pruning: the first forward stage
// reads no input past the crop, and where every input past L/2 is zero (an
// even first radix and a crop <= L/2) it runs the half butterfly (two DFTs of
// R/2); the last inverse stage stores no output past the crop.  Groups of
// transforms lie position-major in shared memory with an odd stride, so
// consecutive threads (consecutive transforms, or consecutive positions of
// one transform) touch distinct banks.  All arithmetic is FP32 FMA on the
// CUDA cores.
//
// Planes whose resident spectrum does not fit one block (an expanded input or
// output above an axis of ~256) take kernel A's three passes with a plane
// index (csrc/sandwich_fft.cu); the wrapper chooses by shape only.
//
// Interface: plain C, returns the cudaError_t of the first failing call (0 on
// success).  Launches on `stream`, never synchronises, allocates nothing: the
// caller passes every output and scratch buffer.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int MAXST = 8;          // stages of a plan (every {2,3,5}-smooth L <= 512 needs <= 6)
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use (sm_90)

// The radices of one length-N DFT, the first (the decimation-in-frequency
// stage on the whole transform) first.
struct Plan {
  int N, nst;
  int R[MAXST];
};

// The launch's shape.
struct Shape {
  int B, W, i0, i1, L0, L1, o0, o1, C, SH;   // C columns of S, SH its row stride
  int G, RGi, RGo;   // columns per group, input and output row pairs per group
  float scale;       // 1 / (L0 L1)
};

// e / d for 0 <= e < 2^22 and 0 < d < 2^22 through a float reciprocal:
// (e + 1/2) / d is at least 1 / (2 d) from an integer, more than the float
// rounding of the product.
struct FastDiv {
  float inv;
  __device__ explicit FastDiv(int d) : inv(1.0f / (float)d) {}
  __device__ int div(int e) const { return (int)(((float)e + 0.5f) * inv); }
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cscale(float2 a, float s) { return make_float2(a.x * s, a.y * s); }
// a * b and a * conj(b)
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, a.y * b.y), fmaf(a.y, b.x, -a.x * b.y));
}
// a * (s i), s = -1 for the forward (e^-) and +1 for the inverse direction
template <bool INV>
__device__ __forceinline__ float2 rot(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// Butterflies in place: v[k] = sum_j v[j] e^{s 2 pi i j k / R}.  HALF: v[j]
// is zero for j >= R/2 (never read), so the even outputs are the R/2-point
// DFT of the inputs and the odd ones that of the inputs times e^{s 2 pi i j / R}.
constexpr float SQRT_HALF = 0.70710678118654752440f;
constexpr float COS_22 = 0.92387953251128675613f;   // cos(pi / 8)
constexpr float SIN_22 = 0.38268343236508977173f;   // sin(pi / 8)
constexpr float SIN_60 = 0.86602540378443864676f;
constexpr float COS_72 = 0.30901699437494742410f;
constexpr float COS_144 = -0.80901699437494742410f;
constexpr float SIN_72 = 0.95105651629515357212f;
constexpr float SIN_144 = 0.58778525229247312917f;

template <bool INV>
__device__ __forceinline__ void dft2(float2& a, float2& b) {
  const float2 t = a;
  a = cadd(t, b);
  b = csub(t, b);
}

// outputs in v0..v3 in natural order
template <bool INV>
__device__ __forceinline__ void dft4(float2& v0, float2& v1, float2& v2, float2& v3) {
  const float2 a = cadd(v0, v2), b = csub(v0, v2), c = cadd(v1, v3), d = rot<INV>(csub(v1, v3));
  v0 = cadd(a, c);
  v2 = csub(a, c);
  v1 = cadd(b, d);
  v3 = csub(b, d);
}

// z * e^{s 2 pi i / 8} and z * e^{s 2 pi i 3 / 8}
template <bool INV>
__device__ __forceinline__ float2 w8_1(float2 z) {
  return INV ? make_float2(SQRT_HALF * (z.x - z.y), SQRT_HALF * (z.x + z.y))
             : make_float2(SQRT_HALF * (z.x + z.y), SQRT_HALF * (z.y - z.x));
}
template <bool INV>
__device__ __forceinline__ float2 w8_3(float2 z) {
  return INV ? make_float2(-SQRT_HALF * (z.x + z.y), SQRT_HALF * (z.x - z.y))
             : make_float2(SQRT_HALF * (z.y - z.x), -SQRT_HALF * (z.x + z.y));
}

// z * (c + s i d), s = -1 for the forward and +1 for the inverse direction
template <bool INV>
__device__ __forceinline__ float2 cmul_const(float2 z, float c, float d) {
  return INV ? make_float2(fmaf(z.x, c, -z.y * d), fmaf(z.x, d, z.y * c))
             : make_float2(fmaf(z.x, c, z.y * d), fmaf(z.y, c, -z.x * d));
}

// z * e^{s 2 pi i m / 16}
template <bool INV, int M>
__device__ __forceinline__ float2 w16(float2 z) {
  if constexpr (M == 0) return z;
  else if constexpr (M == 1) return cmul_const<INV>(z, COS_22, SIN_22);
  else if constexpr (M == 2) return w8_1<INV>(z);
  else if constexpr (M == 3) return cmul_const<INV>(z, SIN_22, COS_22);
  else if constexpr (M == 4) return rot<INV>(z);
  else if constexpr (M == 6) return w8_3<INV>(z);
  else return cmul_const<INV>(z, -COS_22, -SIN_22);   // M == 9
}

// the 16-point DFT as 4 x 4: X[k1 + 4 k2] = sum_n2 w16^{n2 k1} w4^{n2 k2}
// sum_n1 x[4 n1 + n2] w4^{n1 k1}; HALF: x[n] = 0 for n >= 8
template <bool INV, bool HALF>
__device__ __forceinline__ void dft16(float2 (&v)[16]) {
  float2 a[4][4];
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) {
    float2 x0 = v[n2], x1 = v[4 + n2];
    if constexpr (HALF) {
      const float2 r = rot<INV>(x1);
      a[n2][0] = cadd(x0, x1);
      a[n2][2] = csub(x0, x1);
      a[n2][1] = cadd(x0, r);
      a[n2][3] = csub(x0, r);
    } else {
      float2 x2 = v[8 + n2], x3 = v[12 + n2];
      dft4<INV>(x0, x1, x2, x3);
      a[n2][0] = x0;
      a[n2][1] = x1;
      a[n2][2] = x2;
      a[n2][3] = x3;
    }
  }
  a[1][1] = w16<INV, 1>(a[1][1]);
  a[1][2] = w16<INV, 2>(a[1][2]);
  a[1][3] = w16<INV, 3>(a[1][3]);
  a[2][1] = w16<INV, 2>(a[2][1]);
  a[2][2] = w16<INV, 4>(a[2][2]);
  a[2][3] = w16<INV, 6>(a[2][3]);
  a[3][1] = w16<INV, 3>(a[3][1]);
  a[3][2] = w16<INV, 6>(a[3][2]);
  a[3][3] = w16<INV, 9>(a[3][3]);
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    dft4<INV>(a[0][k1], a[1][k1], a[2][k1], a[3][k1]);
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) v[k1 + 4 * k2] = a[k2][k1];
  }
}

template <int R, bool INV, bool HALF>
__device__ __forceinline__ void butterfly(float2 (&v)[R]) {
  if constexpr (R == 2) {
    if constexpr (HALF) v[1] = v[0];
    else dft2<INV>(v[0], v[1]);
  } else if constexpr (R == 4) {
    if constexpr (HALF) {
      const float2 a = v[0], b = v[1], r = rot<INV>(v[1]);
      v[0] = cadd(a, b);
      v[2] = csub(a, b);
      v[1] = cadd(a, r);
      v[3] = csub(a, r);
    } else {
      dft4<INV>(v[0], v[1], v[2], v[3]);
    }
  } else if constexpr (R == 8) {
    if constexpr (HALF) {
      float2 e0 = v[0], e1 = v[1], e2 = v[2], e3 = v[3];
      float2 o0 = v[0], o1 = w8_1<INV>(v[1]), o2 = rot<INV>(v[2]), o3 = w8_3<INV>(v[3]);
      dft4<INV>(e0, e1, e2, e3);
      dft4<INV>(o0, o1, o2, o3);
      v[0] = e0; v[2] = e1; v[4] = e2; v[6] = e3;
      v[1] = o0; v[3] = o1; v[5] = o2; v[7] = o3;
    } else {
      float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
      float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
      dft4<INV>(e0, e1, e2, e3);
      dft4<INV>(o0, o1, o2, o3);
      o1 = w8_1<INV>(o1);
      o2 = rot<INV>(o2);
      o3 = w8_3<INV>(o3);
      v[0] = cadd(e0, o0); v[4] = csub(e0, o0);
      v[1] = cadd(e1, o1); v[5] = csub(e1, o1);
      v[2] = cadd(e2, o2); v[6] = csub(e2, o2);
      v[3] = cadd(e3, o3); v[7] = csub(e3, o3);
    }
  } else if constexpr (R == 16) {
    dft16<INV, HALF>(v);
  } else if constexpr (R == 3) {
    const float2 t = cadd(v[1], v[2]);
    const float2 u = cscale(rot<INV>(csub(v[1], v[2])), SIN_60);
    const float2 m = make_float2(fmaf(-0.5f, t.x, v[0].x), fmaf(-0.5f, t.y, v[0].y));
    v[0] = cadd(v[0], t);
    v[1] = cadd(m, u);
    v[2] = csub(m, u);
  } else if constexpr (R == 5) {
    const float2 t1 = cadd(v[1], v[4]), t2 = cadd(v[2], v[3]);
    const float2 u1 = csub(v[1], v[4]), u2 = csub(v[2], v[3]);
    const float2 x0 = v[0];
    const float2 a1 = make_float2(fmaf(COS_72, t1.x, fmaf(COS_144, t2.x, x0.x)),
                                  fmaf(COS_72, t1.y, fmaf(COS_144, t2.y, x0.y)));
    const float2 a2 = make_float2(fmaf(COS_144, t1.x, fmaf(COS_72, t2.x, x0.x)),
                                  fmaf(COS_144, t1.y, fmaf(COS_72, t2.y, x0.y)));
    const float2 b1 = rot<INV>(make_float2(fmaf(SIN_72, u1.x, SIN_144 * u2.x),
                                           fmaf(SIN_72, u1.y, SIN_144 * u2.y)));
    const float2 b2 = rot<INV>(make_float2(fmaf(SIN_144, u1.x, -SIN_72 * u2.x),
                                           fmaf(SIN_144, u1.y, -SIN_72 * u2.y)));
    v[0] = cadd(x0, cadd(t1, t2));
    v[1] = cadd(a1, b1);
    v[4] = csub(a1, b1);
    v[2] = cadd(a2, b2);
    v[3] = csub(a2, b2);
  }
  // R == 1: the identity
}

// One stage of a batch of nt length-N transforms, the butterflies of radix R
// on blocks of Lt positions (stride S = Lt / R between a butterfly's values):
// position p = blk * Lt + nl + S * j.  Forward (decimation in frequency):
// load, butterfly, output k times tw[nl * k * N / Lt].  Inverse (the adjoint,
// decimation in time): input j times conj tw[nl * j * N / Lt], butterfly.
// MAP 0: consecutive threads take consecutive transforms t (the butterfly's
// twiddles are one broadcast); MAP 1: consecutive butterflies of one
// transform (the first forward and last inverse row stages, whose values go
// to and from device memory along a row).  ld(t, p) and st(t, p, v) read and
// write the values.
template <int R, bool INV, bool HALF, int MAP, class Ld, class St>
__device__ __forceinline__ void stage(int N, int Lt, int nt, const float2* __restrict__ tw,
                                      Ld ld, St st) {
  const int S = Lt / R, nb = N / R, tws = N / Lt, items = nt * nb;
  const FastDiv dS(S), dm(MAP == 0 ? nt : nb);
  for (int e = threadIdx.x; e < items; e += NT) {
    int t, bf;
    if (MAP == 0) {
      bf = dm.div(e);
      t = e - bf * nt;
    } else {
      t = dm.div(e);
      bf = e - t * nb;
    }
    const int blk = dS.div(bf), nl = bf - blk * S;
    const int base = blk * Lt + nl, twb = nl * tws;
    float2 v[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (HALF && 2 * j >= R) continue;
      v[j] = ld(t, base + S * j);
    }
    // (on blocks of R positions, S = 1, every twiddle is 1)
    if constexpr (INV) {
      if (S > 1) {
#pragma unroll
        for (int j = 1; j < R; ++j) v[j] = cmulc(v[j], tw[twb * j]);
      }
    }
    butterfly<R, INV, HALF>(v);
    if constexpr (!INV) {
      if (S > 1) {
#pragma unroll
        for (int k = 1; k < R; ++k) v[k] = cmul(v[k], tw[twb * k]);
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) st(t, base + S * k, v[k]);
  }
}

template <bool INV, int MAP, class Ld, class St>
__device__ __forceinline__ void stage_any(int R, bool half, int N, int Lt, int nt,
                                          const float2* tw, Ld ld, St st) {
  switch (R) {
    case 16:
      if (!INV && half) stage<16, INV, true, MAP>(N, Lt, nt, tw, ld, st);
      else stage<16, INV, false, MAP>(N, Lt, nt, tw, ld, st);
      break;
    case 8:
      if (!INV && half) stage<8, INV, true, MAP>(N, Lt, nt, tw, ld, st);
      else stage<8, INV, false, MAP>(N, Lt, nt, tw, ld, st);
      break;
    case 4:
      if (!INV && half) stage<4, INV, true, MAP>(N, Lt, nt, tw, ld, st);
      else stage<4, INV, false, MAP>(N, Lt, nt, tw, ld, st);
      break;
    case 2:
      if (!INV && half) stage<2, INV, true, MAP>(N, Lt, nt, tw, ld, st);
      else stage<2, INV, false, MAP>(N, Lt, nt, tw, ld, st);
      break;
    case 3: stage<3, INV, false, MAP>(N, Lt, nt, tw, ld, st); break;
    case 5: stage<5, INV, false, MAP>(N, Lt, nt, tw, ld, st); break;
    default: stage<1, INV, false, MAP>(N, Lt, nt, tw, ld, st); break;
  }
}

// The forward DFT of nt transforms into buf (position p of transform t at
// buf[p * bs + t], digit-reversed order): the first stage reads in(t, n) for
// n < nin only (the rest is zero).  Ends with a barrier.
template <int MAP0, class In>
__device__ void fft_forward(const Plan& pl, int nt, float2* buf, int bs, const float2* tw,
                            int nin, In in) {
  auto bld = [&](int t, int p) { return buf[p * bs + t]; };
  auto bst = [&](int t, int p, float2 v) { buf[p * bs + t] = v; };
  int Lt = pl.N;
  for (int s = 0; s < pl.nst; ++s) {
    const int R = pl.R[s];
    if (s == 0) {
      const bool half = R % 2 == 0 && 2 * nin <= pl.N;
      stage_any<false, MAP0>(R, half, pl.N, Lt, nt, tw, [&](int t, int n) {
        return n < nin ? in(t, n) : make_float2(0.f, 0.f);
      }, bst);
    } else {
      stage_any<false, 0>(R, false, pl.N, Lt, nt, tw, bld, bst);
    }
    __syncthreads();
    Lt /= R;
  }
}

// The inverse DFT (unnormalised, e^+) of nt transforms from their spectrum in
// digit-reversed order: the first stage reads it as in(t, p) by position,
// the later ones from buf; the last stage hands out(t, n, v) the outputs
// n < nout in natural order.  Ends with a barrier.
template <int MAPL, class In, class Out>
__device__ void fft_inverse(const Plan& pl, int nt, float2* buf, int bs, const float2* tw,
                            int nout, In in, Out out) {
  auto bld = [&](int t, int p) { return buf[p * bs + t]; };
  auto bst = [&](int t, int p, float2 v) { buf[p * bs + t] = v; };
  auto ost = [&](int t, int n, float2 v) {
    if (n < nout) out(t, n, v);
  };
  int Lt = 1;
  for (int s = pl.nst - 1; s >= 0; --s) {
    const int R = pl.R[s];
    Lt *= R;
    const bool first = s == pl.nst - 1;
    if (s == 0 && first) stage_any<true, MAPL>(R, false, pl.N, Lt, nt, tw, in, ost);
    else if (s == 0) stage_any<true, MAPL>(R, false, pl.N, Lt, nt, tw, bld, ost);
    else if (first) stage_any<true, 0>(R, false, pl.N, Lt, nt, tw, in, bst);
    else stage_any<true, 0>(R, false, pl.N, Lt, nt, tw, bld, bst);
    __syncthreads();
  }
}

// Shared memory of the resident route: the two tables (twiddles as float2,
// then the position of each frequency and the frequency at each position, as
// floats), the resident plane S (max(i0, o0) x SH float2), the transform
// buffer (WB float2).
__host__ __device__ inline size_t table_floats(int L) { return 4 * (size_t)L; }
__host__ __device__ inline size_t tables_bytes(int L0, int L1) {
  return ((table_floats(L0) + table_floats(L1)) * sizeof(float) + 15) / 16 * 16;
}
size_t resident_smem(int L0, int L1, int SR, int SH, int WB) {
  return tables_bytes(L0, L1) + ((size_t)SR * SH + WB) * sizeof(float2);
}

// One block per (b, l) plane, block index l * B + b.
__global__ void __launch_bounds__(NT, 3) wp_resident_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ tab0,
    const float* __restrict__ tab1, float* __restrict__ y, float* __restrict__ planedot,
    Plan p0, Plan p1, Shape sh) {
  extern __shared__ float4 smem4[];
  __shared__ float red[NT];
  const int L0 = sh.L0, L1 = sh.L1, C = sh.C, SH = sh.SH;
  const bool nyq = L1 % 2 == 0;   // column 0 of S carries bins 0 and L1/2
  const int l = blockIdx.x / sh.B, b = blockIdx.x - l * sh.B;
  const size_t plane = (size_t)b * sh.W + l;
  const float* xp = x + plane * sh.i0 * sh.i1;
  float* yp = y + plane * sh.o0 * sh.o1;
  const float* wl = w + (size_t)l * L0 * L1;

  // the tables as [twiddles of L0 | of L1 | positions, frequencies of L0 |
  // of L1], so that both twiddle tables are 8-byte aligned
  float* tb = reinterpret_cast<float*>(smem4);
  float* tp = tb + 2 * (L0 + L1);
  for (int e = threadIdx.x; e < 4 * L0; e += NT) {
    const float v = __ldg(tab0 + e);
    if (e < 2 * L0) tb[e] = v;
    else tp[e - 2 * L0] = v;
  }
  for (int e = threadIdx.x; e < 4 * L1; e += NT) {
    const float v = __ldg(tab1 + e);
    if (e < 2 * L1) tb[2 * L0 + e] = v;
    else tp[2 * L0 + e - 2 * L1] = v;
  }
  const float2* tw0 = reinterpret_cast<const float2*>(tb);
  const float2* tw1 = reinterpret_cast<const float2*>(tb + 2 * L0);
  const float* pos0 = tp;
  const float* pos1 = tp + 2 * L0;
  const float* freq1 = pos1 + L1;
  float2* S = reinterpret_cast<float2*>(smem4 + tables_bytes(L0, L1) / 16);
  const int SR = sh.i0 > sh.o0 ? sh.i0 : sh.o0;
  float2* buf = S + (size_t)SR * SH;
  __syncthreads();

  // 1. rows: pair (r, r + npi) as one complex row; its DFT; the two half
  // spectra into rows r and r + npi of S, bins 0 and L1/2 (both real) as one
  // complex value in column 0
  const int npi = (sh.i0 + 1) / 2;
  for (int t0 = 0; t0 < npi; t0 += sh.RGi) {
    const int nt = min(sh.RGi, npi - t0), bs = nt | 1;
    fft_forward<1>(p1, nt, buf, bs, tw1, sh.i1, [&](int t, int n) {
      const int ra = t0 + t, rb = ra + npi;
      return make_float2(__ldg(xp + (size_t)ra * sh.i1 + n),
                         rb < sh.i0 ? __ldg(xp + (size_t)rb * sh.i1 + n) : 0.f);
    });
    const FastDiv dnt(nt);
    for (int e = threadIdx.x; e < nt * C; e += NT) {
      const int k = dnt.div(e), t = e - k * nt;
      const int ra = t0 + t, rb = ra + npi;
      const float2 z = buf[(int)pos1[k] * bs + t];
      float2 a, b;
      if (k == 0) {
        // A_0 = Re Z_0, B_0 = Im Z_0, and the same at L1/2
        const float2 zn = nyq ? buf[(int)pos1[L1 / 2] * bs + t] : make_float2(0.f, 0.f);
        a = make_float2(z.x, zn.x);
        b = make_float2(z.y, zn.y);
      } else {
        // A = (Z_k + conj Z_{-k}) / 2, B = (Z_k - conj Z_{-k}) / (2i)
        const float2 zr = buf[(int)pos1[L1 - k] * bs + t];
        a = make_float2(0.5f * (z.x + zr.x), 0.5f * (z.y - zr.y));
        b = make_float2(0.5f * (z.y + zr.y), 0.5f * (zr.x - z.x));
      }
      S[ra * SH + k] = a;
      if (rb < sh.i0) S[rb * SH + k] = b;
    }
    __syncthreads();
  }

  // 2. columns, G at a time: forward DFT of the i0 rows, scale, inverse DFT
  // to the o0 rows, in place in S
  for (int k0 = 0; k0 < C; k0 += sh.G) {
    const int nt = min(sh.G, C - k0), bs = nt | 1;
    fft_forward<0>(p0, nt, buf, bs, tw0, sh.i0,
                   [&](int t, int n) { return S[n * SH + k0 + t]; });
    // The scale, as the real basis applies it (any w, even or not): the column
    // U = FFT(Cx) - i FFT(Sx) carries the cosine (Cx) and sine (Sx) parts of
    // minor-axis frequency k1, which the real basis weighs with w[:, k1] and
    // w[:, L1-k1]; each part is the spectrum R of a real column, whose
    // frequency pair (k, L0-k) the real basis weighs as Re R_k w[k] and
    // Im R_k w[L0-k].  Both parts are recovered from U_k and U_{L0-k}.
    // Column 0 is bin 0 plus i times bin L1/2, both real: the same as a
    // cosine part of bin 0 and a sine part weighed with w[:, L1/2].
    const FastDiv dnt(nt);
    for (int e = threadIdx.x; e < nt * (L0 / 2 + 1); e += NT) {
      const int k = dnt.div(e), t = e - k * nt;
      const int kr = k ? L0 - k : 0;
      const int k1 = k0 + t, k1s = k1 ? L1 - k1 : (nyq ? L1 / 2 : 0);
      const float g0 = __ldg(wl + (size_t)k * L1 + k1), g1 = __ldg(wl + (size_t)kr * L1 + k1);
      const float g2 = __ldg(wl + (size_t)k * L1 + k1s), g3 = __ldg(wl + (size_t)kr * L1 + k1s);
      float2* pu = buf + (int)pos0[k] * bs + t;
      float2* pv = buf + (int)pos0[kr] * bs + t;
      const float2 u = *pu, v = *pv;
      // Rc = (U_k + conj U_kr) / 2, Rs = i (U_k - conj U_kr) / 2
      const float rcx = 0.5f * (u.x + v.x), rcy = 0.5f * (u.y - v.y);
      const float rsx = -0.5f * (u.y + v.y), rsy = 0.5f * (u.x - v.x);
      const float zcx = rcx * g0 * sh.scale, zcy = rcy * g1 * sh.scale;
      const float zsx = rsx * g2 * sh.scale, zsy = rsy * g3 * sh.scale;
      // Z_k = Zc - i Zs, Z_kr = conj Zc - i conj Zs
      *pu = make_float2(zcx + zsy, zcy - zsx);
      if (kr != k) *pv = make_float2(zcx - zsy, -zcy - zsx);
    }
    __syncthreads();
    fft_inverse<0>(p0, nt, buf, bs, tw0, sh.o0,
                   [&](int t, int p) { return buf[p * bs + t]; },
                   [&](int t, int m, float2 v) { S[m * SH + k0 + t] = v; });
  }

  // 3. rows back: pair (m, m + npo) as one complex row from the two half
  // spectra (bins 0 and L1/2 real, from column 0; bin k > L1/2 the
  // conjugate of bin L1 - k); its inverse DFT; the real part to row m of y,
  // the imaginary part to row m + npo; with dots, each thread's sum of x * y
  const int npo = (sh.o0 + 1) / 2;
  float dot = 0.f;
  for (int t0 = 0; t0 < npo; t0 += sh.RGo) {
    const int nt = min(sh.RGo, npo - t0), bs = nt | 1;
    // the first stage reads frequency k = freq1[p] of the complex row A + i C
    // at position p straight from S
    fft_inverse<1>(p1, nt, buf, bs, tw1, sh.o1, [&](int t, int p) {
      const int k = (int)freq1[p];
      const int ma = t0 + t, mb = ma + npo;
      const bool mirror = 2 * k > L1, edge = k == 0 || 2 * k == L1;
      const int kk = edge ? 0 : mirror ? L1 - k : k;
      float2 a = S[ma * SH + kk];
      float2 c = mb < sh.o0 ? S[mb * SH + kk] : make_float2(0.f, 0.f);
      if (edge) {
        a = make_float2(k ? a.y : a.x, 0.f);
        c = make_float2(k ? c.y : c.x, 0.f);
      } else if (mirror) {
        a.y = -a.y;
        c.y = -c.y;
      }
      return make_float2(a.x - c.y, a.y + c.x);
    }, [&](int t, int n, float2 v) {
      const int ma = t0 + t, mb = ma + npo;
      const size_t ea = (size_t)ma * sh.o1 + n, eb = (size_t)mb * sh.o1 + n;
      yp[ea] = v.x;
      if (mb < sh.o0) yp[eb] = v.y;
      if (planedot) {
        dot = fmaf(__ldg(xp + ea), v.x, dot);
        if (mb < sh.o0) dot = fmaf(__ldg(xp + eb), v.y, dot);
      }
    });
  }

  // 4. the plane's dot, in a fixed order
  if (!planedot) return;
  red[threadIdx.x] = dot;
  __syncthreads();
  for (int h = NT / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) planedot[plane] = red[0];
}

// dots[b] = sum_{l < W} planedot[b * W + l], in order.
__global__ void __launch_bounds__(NT) planedots_reduce_kernel(
    const float* __restrict__ planedot, float* __restrict__ dots, int B, int W) {
  const int b = blockIdx.x * NT + threadIdx.x;
  if (b >= B) return;
  float s = 0.f;
  for (int l = 0; l < W; ++l) s += planedot[(size_t)b * W + l];
  dots[b] = s;
}

// The opt-in to more than 48 KB of dynamic shared memory, once per process:
// all a block may use, less the kernel's static shared memory.
cudaError_t configure_once() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, wp_resident_kernel);
  if (err) return err;
  err = cudaFuncSetAttribute(wp_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX - (int)attr.sharedSizeBytes);
  if (err) return err;
  done = true;
  return cudaSuccess;
}

Plan make_plan(int N, const int* radices, int nst) {
  Plan p;
  p.N = N;
  p.nst = nst;
  for (int s = 0; s < MAXST; ++s) p.R[s] = s < nst ? radices[s] : 1;
  return p;
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, the resident route asks for: the tables
// of L0 and L1, SR x SH float2 of resident plane and WB float2 of transform
// buffer (the wrapper's route choice computes the same).
size_t wp_resident_smem_bytes(int L0, int L1, int SR, int SH, int WB) {
  return resident_smem(L0, L1, SR, SH, WB);
}

// Kernel B-5, the resident route: x (B, W, i0, i1), w (W, L0, L1), y
// (B, W, o0, o1); tab0 and tab1 the tables of L0 and L1 (4 L floats each:
// the twiddles e^{-2 pi i m / L} as (re, im), the position of each frequency,
// the frequency at each position); rad0 and rad1 the plans' radices (nst0, nst1 of them); G, RGi,
// RGo the columns and row pairs per group, WB the transform buffer's float2
// (each group's transforms times their odd stride fit it).  With dots:
// planedot (B * W floats of scratch) and dots (B).
int wp_resident(const float* x, const float* w, const float* tab0, const float* tab1,
                float* y, float* planedot, float* dots, int B, int W, int i0, int i1,
                int L0, int L1, int o0, int o1, const int* rad0, int nst0, const int* rad1,
                int nst1, int G, int RGi, int RGo, int WB, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err;
  if (nst0 > MAXST || nst1 > MAXST) return (int)cudaErrorInvalidValue;
  if ((err = configure_once())) return (int)err;
  Shape sh;
  sh.B = B; sh.W = W; sh.i0 = i0; sh.i1 = i1; sh.L0 = L0; sh.L1 = L1; sh.o0 = o0; sh.o1 = o1;
  sh.C = (L1 + 1) / 2;
  sh.SH = sh.C | 1;
  sh.G = G; sh.RGi = RGi; sh.RGo = RGo;
  sh.scale = (float)(1.0 / ((double)L0 * (double)L1));
  const int SR = i0 > o0 ? i0 : o0;
  const size_t smem = resident_smem(L0, L1, SR, sh.SH, WB);
  wp_resident_kernel<<<B * W, NT, smem, stream>>>(x, w, tab0, tab1, y, dots ? planedot : nullptr,
                                                  make_plan(L0, rad0, nst0),
                                                  make_plan(L1, rad1, nst1), sh);
  if ((err = cudaGetLastError())) return (int)err;
  if (dots) {
    planedots_reduce_kernel<<<(B + NT - 1) / NT, NT, 0, stream>>>(planedot, dots, B, W);
    if ((err = cudaGetLastError())) return (int)err;
  }
  return 0;
}

}  // extern "C"
