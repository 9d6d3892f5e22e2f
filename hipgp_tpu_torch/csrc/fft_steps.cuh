// Complex arithmetic and the register-radix DFT shared by the radix kernels
// (csrc/radix.cu) and kernel B-6 (csrc/mxu3d.cu).
//
// A thread holds the R values of one R-point DFT (R <= 16, a power of two)
// in registers and runs the whole transform there, by radix-2 decimation in
// time, unrolled, with the factors exp(+-2 pi i m / 16) as literals (no
// sincosf).  Include inside the source's anonymous namespace.
#pragma once

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
    return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * conj(b)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
    return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}
// cos(2 pi m / 16) for m in [0, 4]
__host__ __device__ constexpr float cos16(int m) {
    return m == 0 ? 1.0f : m == 1 ? 0.92387953251128674f
         : m == 2 ? 0.70710678118654752f : m == 3 ? 0.38268343236508977f : 0.0f;
}

// x * exp(SIGN 2 pi i k / R) for k < R / 2, R <= 16 (k is a constant once the
// loops are unrolled, so the factor is a literal).
template <int R, int SIGN>
__device__ __forceinline__ float2 rot(int k, float2 x) {
    const int m = k * (16 / R);   // the angle is 2 pi m / 16, m < 8
    if (m == 0) return x;
    if (m == 4) return SIGN < 0 ? make_float2(x.y, -x.x) : make_float2(-x.y, x.x);
    const float c = m <= 4 ? cos16(m) : -cos16(8 - m);
    const float s = SIGN * (m <= 4 ? cos16(4 - m) : cos16(m - 4));
    return make_float2(x.x * c - x.y * s, x.x * s + x.y * c);
}

// y[k] = sum_n x[O + S n] exp(SIGN 2 pi i n k / R), by radix-2 decimation in
// time.  HALF: the inputs of the top-level transform at n >= R_top / 2 are
// zero, so every 2-point butterfly at the bottom has a zero second input.
template <int R, int S, int O, int SIGN, bool HALF, int N>
__device__ __forceinline__ void dft_rec(const float2 (&x)[N], float2 (&y)[R]) {
    if constexpr (R == 1) {
        y[0] = x[O];
    } else if constexpr (R == 2 && HALF) {
        y[0] = x[O];
        y[1] = x[O];
    } else {
        float2 e[R / 2], o[R / 2];
        dft_rec<R / 2, 2 * S, O, SIGN, HALF>(x, e);
        dft_rec<R / 2, 2 * S, O + S, SIGN, HALF>(x, o);
#pragma unroll
        for (int k = 0; k < R / 2; ++k) {
            const float2 t = rot<R, SIGN>(k, o[k]);
            y[k] = cadd(e[k], t);
            y[k + R / 2] = csub(e[k], t);
        }
    }
}

// The R-point DFT of v in place, natural order in and out.
template <int R, int SIGN, bool HALF = false>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
    if constexpr (R > 1) {
        float2 y[R];
        dft_rec<R, 1, 0, SIGN, HALF>(v, y);
#pragma unroll
        for (int k = 0; k < R; ++k) v[k] = y[k];
    }
}
