// Kernels B-2, B-3 and B-4: the packed radix circulant apply on a long 1-D
// axis, hand-written for Hopper (sm_90a).
//
// The apply y = F^{-1}(d * F x) on L = A * B * C points (C = 128, B in [8, 128],
// A in [8, 2048], powers of two) runs as three stages on V complex planes,
// each plane packing two real right-hand sides:
//
//   radix_stage1      replaces hipgp_tpu/ops/radix_fft.py:_make_s1_kernel
//                     (pl.pallas_call in `_stage1_pallas`): the A-point DFT over
//                     the outer axis of (V, rows, N = B*C) planes, forward
//                     (exp(-2 pi i k a / A)) or inverse (its conjugate, no
//                     scale), input rows >= in_rows taken as zero, only the
//                     first out_rows output rows formed;
//   radix_stage1_dot  replaces _make_s1_dot_kernel (`_stage1_inv_dot_pallas`):
//                     the inverse stage 1 plus the per-v self-dots
//                     dr[v] = sum ur[v] * yr[v], di[v] = sum ui[v] * yi[v];
//   radix_middle      replaces _make_middle_kernel (`_middle_pallas`): per
//                     (B, C) plane ka of (V, A, B, C), the T1 twiddle
//                     exp(-2 pi i ka (b C + c) / L), the B-point DFT over b,
//                     the T2 twiddle exp(-2 pi i kb c / (B C)), the C-point DFT
//                     over c, the product with d[ka, kb, kc] (stage order, 1/L
//                     folded in), then the conjugate chain back;
//   radix_middle_dual replaces _make_middle_kernel_dual (`_middle_pallas_dual`,
//                     kernel B-7): the same chain with two diagonals dA, dB on
//                     one forward half, giving both products (the core of
//                     `fused_circulant_apply_cropped_dual`: C_dA x and C_dB x
//                     for one x).
//
// Bound on this card.  At the headline shape (V = 4, L = 2^21, A = B = C = 128,
// 64 rows of data) every stage is bound by bytes: each moves its planes once
// through device memory (100-143 MB, 0.030-0.043 ms at 3.35 TB/s), while its
// least work, the FFT formulation (5 n log2 n per complex n-point FFT), is
// 0.29 GFLOP for stage 1 and 1.3 GFLOP for the middle (0.004 and 0.019 ms at
// the 67 TFLOP/s FP32 peak).  The TPU kernels do the DFTs as dense 128 x 128
// table products on the MXU; on the CUDA cores that formulation is the trap:
// 3.2 GFLOP for stage 1 and 25.8 GFLOP for the middle, 0.385 ms at peak and 9x
// the middle's bound.
//
// What the design does about it.  No dense table: every DFT here is a radix-2
// FFT in shared memory (about 1/20 of the dense work at n = 128), with its
// twiddles computed once per block by sincospif into small shared tables, so
// the kernels stay near the byte bound in operations and read no table from
// device memory.
//   * Stage 1: one block owns T consecutive columns of one plane and all A rows
//     (A * T = 8192 complex values, 64 KB), loads them once (coalesced along
//     the columns), runs log2(A) decimation-in-frequency stages down the
//     columns, and stores the rows k < out_rows from the bit-reversed positions.
//     The rider's self-dot partials are summed per block in a fixed tree order
//     and a second launch sums the blocks of each v in a fixed order: the dots
//     are deterministic, with no atomics.
//   * Middle: one block owns one (B, C) plane (128 KB of complex f32 at
//     B = C = 128, within the 227 KB a block may use), reads it once, and
//     keeps it in shared memory for the whole chain.  The forward DFTs are
//     decimation in frequency (natural order in, bit-reversed out) and the
//     inverse ones decimation in time (bit-reversed in, natural out), so the
//     chain needs no reordering pass: T2 and d are read at the bit-reversed
//     indices.  T1 is a product of a per-plane row and column factor,
//     T2 a product of two small tables, so no per-element sincos is taken.
//   * Dual middle (B-7): one plane of forward spectrum is all a block's shared
//     memory holds, so the forward spectrum is parked in the second output
//     (each thread stores, and later reloads, only the elements it owns, so no
//     other thread's writes need to be visible), the first inverse half runs
//     with dA in place, and the second with dB from the reloaded copy: one
//     forward half instead of two, at the price of one extra write and read
//     of the plane (5 passes of the plane through device memory against 4 for two
//     single middles; 3 half chains of work against 4).  Bytes bind it, as they
//     bind the single middle.
// All arithmetic is full FP32 on the CUDA cores (no TF32).  This first version
// does one shared-memory pass per radix-2 stage (28 passes of the plane in the
// middle), so shared-memory bandwidth, not device memory, is expected to
// bind it; higher radices in registers are the next step.
//
// Interface: plain C, returns the cudaError_t of the first failing call (0 on
// success).  Launches on `stream`, never synchronises, allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int S1_THREADS = 256;      // threads of a stage-1 block
constexpr int S1_ELEMS = 8192;       // complex values of a stage-1 tile (64 KB)
constexpr int S1_MAX_COLS = 64;      // columns of a stage-1 tile at most
constexpr int MID_THREADS = 1024;    // threads of a middle block at most
constexpr int RED_THREADS = 256;     // threads of the dot-reduction block
constexpr int SMEM_LIMIT = 232448;   // shared memory one block may use (sm_90)

__host__ __device__ inline int ilog2(int n) {
    int l = 0;
    while ((1 << l) < n) ++l;
    return l;
}

__host__ inline bool is_pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

// Columns of a stage-1 tile: A * T = S1_ELEMS, at most S1_MAX_COLS and N.
__host__ inline int s1_cols(int A, int N) {
    int t = S1_ELEMS / A;
    if (t > S1_MAX_COLS) t = S1_MAX_COLS;
    if (t < 1) t = 1;
    if (t > N) t = N;
    return t;
}

__host__ inline size_t s1_smem_bytes(int A, int T) {
    return (size_t)2 * A * T * sizeof(float) + (size_t)(A / 2) * sizeof(float2);
}

// p with its low `bits` bits reversed.
__device__ inline int bitrev(int p, int bits) {
    return bits ? (int)(__brev((unsigned)p) >> (32 - bits)) : 0;
}

// exp(2 pi i num / den * sign); num / den is exact for a power-of-two den and
// |num| < 2^24, and sincospif is accurate to an ulp.
__device__ inline float2 unit(int num, int den, float sign) {
    float s, c;
    sincospif(2.0f * (float)num / (float)den, &s, &c);
    return make_float2(c, sign * s);
}

__device__ inline float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ inline float2 cconj(float2 a) { return make_float2(a.x, -a.y); }

// One radix-2 stage of span h = 2^lh on 2^lntr transforms of length n = 2^ln
// held in shared memory (re, im): element i of transform t sits at
// t * ts + i * es.  Butterflies are numbered so that consecutive threads touch
// consecutive addresses: across transforms for columns (es > 1), along the
// transform for rows (es == 1).  tw[k] = exp(-2 pi i k / n) for k < n / 2;
// wsign = -1 takes its conjugate.
//   DIF (natural in, bit-reversed out): (u, v) -> (u + v, (u - v) w)
//   DIT (bit-reversed in, natural out): (u, v) -> (u + w v, u - w v)
template <bool DIF>
__device__ void fft_stage(float* re, float* im, int ln, int lntr, int ts, int es,
                          int lh, const float2* tw, float wsign) {
    const int lhalf = ln - 1;
    const int total = 1 << (lhalf + lntr);
    const int h = 1 << lh;
    for (int q = threadIdx.x; q < total; q += blockDim.x) {
        int t, p;
        if (es == 1) {
            p = q & ((1 << lhalf) - 1);
            t = q >> lhalf;
        } else {
            t = q & ((1 << lntr) - 1);
            p = q >> lntr;
        }
        const int j = p & (h - 1);
        const int i0 = ((p >> lh) << (lh + 1)) + j;
        const int a0 = t * ts + i0 * es;
        const int a1 = a0 + h * es;
        float2 w = tw[j << (lhalf - lh)];
        w.y *= wsign;
        const float ur = re[a0], ui = im[a0], vr = re[a1], vi = im[a1];
        if (DIF) {
            re[a0] = ur + vr;
            im[a0] = ui + vi;
            const float dr = ur - vr, di = ui - vi;
            re[a1] = dr * w.x - di * w.y;
            im[a1] = dr * w.y + di * w.x;
        } else {
            const float tr = vr * w.x - vi * w.y, ti = vr * w.y + vi * w.x;
            re[a0] = ur + tr;
            im[a0] = ui + ti;
            re[a1] = ur - tr;
            im[a1] = ui - ti;
        }
    }
}

// A whole transform: log2(n) stages, each followed by a barrier.  The caller
// puts a barrier between its writes of the data and this call.
template <bool DIF>
__device__ void fft(float* re, float* im, int ln, int lntr, int ts, int es,
                    const float2* tw, float wsign) {
    for (int s = 0; s < ln; ++s) {
        fft_stage<DIF>(re, im, ln, lntr, ts, es, DIF ? ln - 1 - s : s, tw, wsign);
        __syncthreads();
    }
}

// Sums a and b over the block in a fixed tree order into out_a, out_b
// (thread 0 writes).  red holds 2 * blockDim.x floats; blockDim.x is a power
// of two.
__device__ void block_sum2(float a, float b, float* red, float* out_a, float* out_b) {
    const int n = blockDim.x, t = threadIdx.x;
    red[t] = a;
    red[n + t] = b;
    __syncthreads();
    for (int s = n >> 1; s > 0; s >>= 1) {
        if (t < s) {
            red[t] += red[t + s];
            red[n + t] += red[n + t + s];
        }
        __syncthreads();
    }
    if (t == 0) {
        *out_a = red[0];
        *out_b = red[n];
    }
}

// Stage 1 on one tile: blockIdx.x = column tile (T columns), blockIdx.y = v.
// x: (V, in_rows, N), y: (V, out_rows, N), re/im.  With ur (the rider, shaped
// like y) the block also writes its partial self-dots to pr/pi[v * tiles + tile].
__global__ void __launch_bounds__(S1_THREADS)
stage1_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
              float* __restrict__ yr, float* __restrict__ yi,
              const float* __restrict__ ur, const float* __restrict__ ui,
              float* __restrict__ pr, float* __restrict__ pi,
              int N, int lA, int lT, int in_rows, int out_rows, float sign) {
    extern __shared__ float smem[];
    const int A = 1 << lA, T = 1 << lT;
    float* re = smem;
    float* im = re + A * T;
    float2* tw = reinterpret_cast<float2*>(im + A * T);
    const int v = blockIdx.y, j0 = blockIdx.x * T;

    for (int k = threadIdx.x; k < A / 2; k += blockDim.x) tw[k] = unit(k, A, -1.0f);
    const size_t ibase = (size_t)v * in_rows * N + j0;
    for (int idx = threadIdx.x; idx < A * T; idx += blockDim.x) {
        const int a = idx >> lT, t = idx & (T - 1);
        float r = 0.0f, i = 0.0f;
        if (a < in_rows) {
            const size_t g = ibase + (size_t)a * N + t;
            r = xr[g];
            i = xi[g];
        }
        re[idx] = r;
        im[idx] = i;
    }
    __syncthreads();
    // columns: transform t at t, element a at a * T; sign -1 forward, +1 inverse
    fft<true>(re, im, lA, lT, 1, T, tw, -sign);

    const size_t obase = (size_t)v * out_rows * N + j0;
    float sr = 0.0f, si = 0.0f;
    for (int idx = threadIdx.x; idx < out_rows * T; idx += blockDim.x) {
        const int k = idx >> lT, t = idx & (T - 1);
        const int src = (bitrev(k, lA) << lT) + t;
        const float r = re[src], i = im[src];
        const size_t g = obase + (size_t)k * N + t;
        yr[g] = r;
        yi[g] = i;
        if (ur != nullptr) {
            sr += ur[g] * r;
            si += ui[g] * i;
        }
    }
    if (ur != nullptr) {
        __syncthreads();   // re is reused for the reduction
        const int tile = v * gridDim.x + blockIdx.x;
        block_sum2(sr, si, re, pr + tile, pi + tile);
    }
}

// dr[v] = sum over tiles of pr[v * tiles + tile], in a fixed order; likewise di.
__global__ void __launch_bounds__(RED_THREADS)
dot_reduce_kernel(const float* __restrict__ pr, const float* __restrict__ pi,
                  float* __restrict__ dr, float* __restrict__ di, int tiles) {
    __shared__ float red[2 * RED_THREADS];
    const int v = blockIdx.x;
    float a = 0.0f, b = 0.0f;
    for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
        a += pr[v * tiles + t];
        b += pi[v * tiles + t];
    }
    block_sum2(a, b, red, dr + v, di + v);
}

// Twiddle tables of a middle block, in shared memory after its plane.
struct MiddleTables {
    float2* twB;   // exp(-2 pi i k / B), k < B/2
    float2* twC;   // exp(-2 pi i k / C), k < C/2
    float2* t1r;   // exp(-2 pi i ka b / (A B)), b < B
    float2* t1c;   // exp(-2 pi i ka c / L), c < C
    float2* t2h;   // exp(-2 pi i k / B), k < B
    float2* t2l;   // exp(-2 pi i k / (B C)), k < C
};

// Fills the tables of plane ka (ends with a barrier).
__device__ MiddleTables middle_setup(float2* tw, int ka, int A, int B, int C) {
    const int P = B * C;
    MiddleTables t;
    t.twB = tw;
    t.twC = t.twB + B / 2;
    t.t1r = t.twC + C / 2;
    t.t1c = t.t1r + B;
    t.t2h = t.t1c + C;
    t.t2l = t.t2h + B;
    for (int k = threadIdx.x; k < B; k += blockDim.x) {
        if (k < B / 2) t.twB[k] = unit(k, B, -1.0f);
        t.t1r[k] = unit((ka * k) & (A * B - 1), A * B, -1.0f);
        t.t2h[k] = unit(k, B, -1.0f);
    }
    for (int k = threadIdx.x; k < C; k += blockDim.x) {
        if (k < C / 2) t.twC[k] = unit(k, C, -1.0f);
        t.t1c[k] = unit(ka * k, A * P, -1.0f);
        t.t2l[k] = unit(k, P, -1.0f);
    }
    __syncthreads();
    return t;
}

// The forward half on the plane at y + base: T1, F_B over b, T2, F_C over c,
// into shared memory (re, im) in bit-reversed (kb, kc) order (ends with a
// barrier).
__device__ void middle_forward(const float* __restrict__ yr, const float* __restrict__ yi,
                               size_t base, float* re, float* im, const MiddleTables& t,
                               int lB, int lC) {
    const int C = 1 << lC, P = 1 << (lB + lC);
    // T1 on the way in
    for (int idx = threadIdx.x; idx < P; idx += blockDim.x) {
        const int b = idx >> lC, c = idx & (C - 1);
        const float2 w = cmul(t.t1r[b], t.t1c[c]);
        const float r = yr[base + idx], i = yi[base + idx];
        re[idx] = r * w.x - i * w.y;
        im[idx] = r * w.y + i * w.x;
    }
    __syncthreads();
    // F_B over b (columns; row p then holds kb = bitrev(p))
    fft<true>(re, im, lB, lC, 1, C, t.twB, 1.0f);
    // T2 at (kb, c)
    for (int idx = threadIdx.x; idx < P; idx += blockDim.x) {
        const int p = idx >> lC, c = idx & (C - 1);
        const int r = (bitrev(p, lB) * c) & (P - 1);
        const float2 w = cmul(t.t2h[r >> lC], t.t2l[r & (C - 1)]);
        const float x = re[idx], y = im[idx];
        re[idx] = x * w.x - y * w.y;
        im[idx] = x * w.y + y * w.x;
    }
    __syncthreads();
    // F_C over c (rows; position q then holds kc = bitrev(q))
    fft<true>(re, im, lC, lB, C, 1, t.twC, 1.0f);
}

// The inverse half: the product with the diagonal dp of this plane, read at
// (kb, kc), conj F_C, conj T2, conj F_B, and conj T1 on the way out to
// z + base.  Each thread first scales the elements it holds, so the caller
// needs no barrier between its own writes of those elements and this call.
__device__ void middle_inverse(float* re, float* im, const float* __restrict__ dp,
                               float* zr, float* zi, size_t base, const MiddleTables& t,
                               int lB, int lC) {
    const int C = 1 << lC, P = 1 << (lB + lC);
    for (int idx = threadIdx.x; idx < P; idx += blockDim.x) {
        const int p = idx >> lC, q = idx & (C - 1);
        const float s = __ldg(dp + (bitrev(p, lB) << lC) + bitrev(q, lC));
        re[idx] *= s;
        im[idx] *= s;
    }
    __syncthreads();
    // conj F_C: bit-reversed kc in, natural c out
    fft<false>(re, im, lC, lB, C, 1, t.twC, -1.0f);
    // conj T2
    for (int idx = threadIdx.x; idx < P; idx += blockDim.x) {
        const int p = idx >> lC, c = idx & (C - 1);
        const int r = (bitrev(p, lB) * c) & (P - 1);
        const float2 w = cconj(cmul(t.t2h[r >> lC], t.t2l[r & (C - 1)]));
        const float x = re[idx], y = im[idx];
        re[idx] = x * w.x - y * w.y;
        im[idx] = x * w.y + y * w.x;
    }
    __syncthreads();
    // conj F_B: bit-reversed kb in, natural b out
    fft<false>(re, im, lB, lC, 1, C, t.twB, -1.0f);
    // conj T1 on the way out
    for (int idx = threadIdx.x; idx < P; idx += blockDim.x) {
        const int b = idx >> lC, c = idx & (C - 1);
        const float2 w = cconj(cmul(t.t1r[b], t.t1c[c]));
        const float x = re[idx], y = im[idx];
        zr[base + idx] = x * w.x - y * w.y;
        zi[base + idx] = x * w.y + y * w.x;
    }
}

// The middle stages on plane ka = blockIdx.x of sample v = blockIdx.y.
__global__ void __launch_bounds__(MID_THREADS)
middle_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
              const float* __restrict__ d, float* __restrict__ zr,
              float* __restrict__ zi, int lA, int lB, int lC) {
    extern __shared__ float smem[];
    const int P = 1 << (lB + lC);
    float* re = smem;
    float* im = re + P;
    const int ka = blockIdx.x, v = blockIdx.y;
    const MiddleTables t = middle_setup(reinterpret_cast<float2*>(im + P), ka, 1 << lA,
                                        1 << lB, 1 << lC);
    const size_t base = ((size_t)v * (1 << lA) + ka) * P;
    middle_forward(yr, yi, base, re, im, t, lB, lC);
    middle_inverse(re, im, d + (size_t)ka * P, zr, zi, base, t, lB, lC);
}

// Kernel B-7: the middle stages with two diagonals on one forward half.  The
// forward spectrum is parked in zB (each thread stores and later reloads the
// elements it holds), the inverse half runs with dA into zA, then with dB from
// the reloaded spectrum into zB.
__global__ void __launch_bounds__(MID_THREADS)
middle_dual_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                   const float* __restrict__ dA, const float* __restrict__ dB,
                   float* __restrict__ zAr, float* __restrict__ zAi, float* zBr,
                   float* zBi, int lA, int lB, int lC) {
    extern __shared__ float smem[];
    const int P = 1 << (lB + lC);
    float* re = smem;
    float* im = re + P;
    const int ka = blockIdx.x, v = blockIdx.y;
    const MiddleTables t = middle_setup(reinterpret_cast<float2*>(im + P), ka, 1 << lA,
                                        1 << lB, 1 << lC);
    const size_t base = ((size_t)v * (1 << lA) + ka) * P;
    middle_forward(yr, yi, base, re, im, t, lB, lC);
    for (int idx = threadIdx.x; idx < P; idx += blockDim.x) {
        zBr[base + idx] = re[idx];
        zBi[base + idx] = im[idx];
    }
    middle_inverse(re, im, dA + (size_t)ka * P, zAr, zAi, base, t, lB, lC);
    __syncthreads();   // every thread is done with the plane before it is reloaded
    for (int idx = threadIdx.x; idx < P; idx += blockDim.x) {
        re[idx] = zBr[base + idx];
        im[idx] = zBi[base + idx];
    }
    middle_inverse(re, im, dB + (size_t)ka * P, zBr, zBi, base, t, lB, lC);
}

size_t middle_smem_bytes(int B, int C) {
    return (size_t)2 * B * C * sizeof(float)
         + (size_t)(B / 2 + C / 2 + 2 * B + 2 * C) * sizeof(float2);
}

bool middle_args_ok(int V, int A, int B, int C) {
    return V > 0 && is_pow2(A) && is_pow2(B) && is_pow2(C) && B >= 2 && C >= 2
        && (size_t)A * B * C <= ((size_t)1 << 25)
        && middle_smem_bytes(B, C) <= (size_t)SMEM_LIMIT;
}

int middle_threads(int B, int C) {
    const int threads = B * C / 2;
    return threads > MID_THREADS ? MID_THREADS : threads;
}

int set_smem(const void* kernel, size_t bytes) {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
}

bool s1_args_ok(int V, int N, int A, int in_rows, int out_rows) {
    return V > 0 && is_pow2(N) && N >= 1024 && is_pow2(A) && A >= 2 && A <= 2048
        && in_rows >= 1 && in_rows <= A && out_rows >= 1 && out_rows <= A;
}

int launch_stage1(const float* xr, const float* xi, float* yr, float* yi,
                  const float* ur, const float* ui, float* pr, float* pi,
                  int V, int N, int A, int in_rows, int out_rows, float sign,
                  cudaStream_t stream) {
    const int T = s1_cols(A, N);
    const size_t smem = s1_smem_bytes(A, T);
    int err = set_smem((const void*)stage1_kernel, smem);
    if (err) return err;
    dim3 grid(N / T, V);
    stage1_kernel<<<grid, S1_THREADS, smem, stream>>>(
        xr, xi, yr, yi, ur, ui, pr, pi, N, ilog2(A), ilog2(T), in_rows, out_rows, sign);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of one partial-dot array for radix_stage1_dot (the caller passes 2x).
size_t radix_dot_partials(int V, int N, int A) {
    if (V <= 0 || A <= 0 || N <= 0) return 0;
    return (size_t)V * (N / s1_cols(A, N));
}

// y = the A-point DFT over the rows of x, forward (sign -1) or inverse (+1),
// rows >= in_rows of x zero, rows < out_rows of y formed.
// x: (V, in_rows, N), y: (V, out_rows, N).
int radix_stage1(const float* xr, const float* xi, float* yr, float* yi, int V,
                 int N, int A, int in_rows, int out_rows, int sign,
                 cudaStream_t stream) {
    if (!s1_args_ok(V, N, A, in_rows, out_rows) || (sign != 1 && sign != -1))
        return (int)cudaErrorInvalidValue;
    return launch_stage1(xr, xi, yr, yi, nullptr, nullptr, nullptr, nullptr, V, N, A,
                         in_rows, out_rows, (float)sign, stream);
}

// The inverse stage 1 of z (V, A, N) to y (V, out_rows, N), plus
// dr[v] = sum ur[v] * yr[v] and di[v] = sum ui[v] * yi[v] (u like y).
// partial: 2 * radix_dot_partials(V, N, A) floats of scratch.
int radix_stage1_dot(const float* zr, const float* zi, const float* ur,
                     const float* ui, float* yr, float* yi, float* dr, float* di,
                     float* partial, int V, int N, int A, int out_rows,
                     cudaStream_t stream) {
    if (!s1_args_ok(V, N, A, A, out_rows)) return (int)cudaErrorInvalidValue;
    const int tiles = N / s1_cols(A, N);
    float* pr = partial;
    float* pi = partial + (size_t)V * tiles;
    int err = launch_stage1(zr, zi, yr, yi, ur, ui, pr, pi, V, N, A, A, out_rows,
                            1.0f, stream);
    if (err) return err;
    dot_reduce_kernel<<<V, RED_THREADS, 0, stream>>>(pr, pi, dr, di, tiles);
    return (int)cudaGetLastError();
}

// The middle stages on y (V, A, B, C) with the stage-order diagonal d (A, B, C)
// into z (V, A, B, C).
int radix_middle(const float* yr, const float* yi, const float* d, float* zr,
                 float* zi, int V, int A, int B, int C, cudaStream_t stream) {
    if (!middle_args_ok(V, A, B, C)) return (int)cudaErrorInvalidValue;
    const size_t smem = middle_smem_bytes(B, C);
    int err = set_smem((const void*)middle_kernel, smem);
    if (err) return err;
    middle_kernel<<<dim3(A, V), middle_threads(B, C), smem, stream>>>(
        yr, yi, d, zr, zi, ilog2(A), ilog2(B), ilog2(C));
    return (int)cudaGetLastError();
}

// Kernel B-7: the middle stages on y (V, A, B, C) with two stage-order
// diagonals dA, dB (A, B, C) sharing one forward half, into zA and zB
// (V, A, B, C) each.
int radix_middle_dual(const float* yr, const float* yi, const float* dA,
                      const float* dB, float* zAr, float* zAi, float* zBr, float* zBi,
                      int V, int A, int B, int C, cudaStream_t stream) {
    if (!middle_args_ok(V, A, B, C)) return (int)cudaErrorInvalidValue;
    const size_t smem = middle_smem_bytes(B, C);
    int err = set_smem((const void*)middle_dual_kernel, smem);
    if (err) return err;
    middle_dual_kernel<<<dim3(A, V), middle_threads(B, C), smem, stream>>>(
        yr, yi, dA, dB, zAr, zAi, zBr, zBi, ilog2(A), ilog2(B), ilog2(C));
    return (int)cudaGetLastError();
}

}  // extern "C"
