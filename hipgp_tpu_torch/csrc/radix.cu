// Kernels B-2, B-3, B-4 and B-7: the packed radix circulant apply on a long
// 1-D axis, hand-written for Hopper (sm_90a) as register-radix FFTs.
//
// The apply y = F^{-1}(d * F x) on L = A * B * C points (C = 128, B in
// {8, ..., 128}, A in {8, ..., 2048}, powers of two) runs as three stages on V
// complex planes, each plane packing two real right-hand sides:
//
//   radix_stage1      replaces hipgp_tpu/ops/radix_fft.py:_make_s1_kernel
//                     (pl.pallas_call in `_stage1_pallas`, kernel B-2): the
//                     A-point DFT over the outer axis of (V, rows, N = B*C)
//                     planes, forward (exp(-2 pi i k a / A)) or inverse (its
//                     conjugate, no scale), input rows >= in_rows zero, only
//                     the first out_rows output rows formed;
//   radix_stage1_dot  replaces _make_s1_dot_kernel (`_stage1_inv_dot_pallas`,
//                     B-3): the inverse stage 1 plus the per-v self-dots
//                     dr[v] = sum ur[v] * yr[v], di[v] = sum ui[v] * yi[v];
//   radix_middle      replaces _make_middle_kernel (`_middle_pallas`, B-4): per
//                     (B, C) plane ka of (V, A, B, C), the T1 twiddle
//                     exp(-2 pi i ka (b C + c) / L), the B-point DFT over b,
//                     the T2 twiddle exp(-2 pi i kb c / (B C)), the C-point DFT
//                     over c, the product with d[ka, kb, kc] (stage order, 1/L
//                     folded in), then the conjugate chain back;
//   radix_middle_dual replaces _make_middle_kernel_dual (`_middle_pallas_dual`,
//                     B-7): the same chain with two diagonals dA, dB on one
//                     forward half;
//   radix_middle_wgrad B-4's weight cotangent, the d-cotangent of the JAX
//                     package's custom VJP of the apply (`_get_apply`'s bwd,
//                     hipgp_tpu/ops/radix_fft.py:818, computed there by XLA
//                     einsums in `_forward_stages`): dbar[ka, kb, kc] =
//                     sum_v Re[X conj(G)] with X, G the forward middle (T1,
//                     B-DFT, T2, C-DFT) of the two stage-1 outputs.
//
// Bound on this card.  At the headline shape (V = 4, L = 2^21, A = B = C = 128,
// 64 rows of data) every stage is bound by bytes: each moves its planes once
// through device memory (100-143 MB, 0.030-0.043 ms at 3.35 TB/s), while its
// least work, the FFT formulation (5 n log2 n per complex n-point FFT), is
// 0.29 GFLOP for stage 1 and 1.3 GFLOP for the middle (0.004 and 0.019 ms at
// the 67 TFLOP/s FP32 peak).  The TPU kernels do the DFTs as dense 128 x 128
// table products on the MXU; on the CUDA cores that formulation would be 9x
// the middle's bound, so every DFT here is an FFT.
//
// What the design does about it.  Every n-point DFT is at most three
// register-radix steps (n = 128 is 16 x 8): a thread holds the R values of one
// butterfly in registers, runs the whole R-point DFT there (radix-2 decimation
// in time, unrolled, with constant twiddles), and one shared-memory exchange
// separates two steps.  The steps run in place (a thread writes back to the
// positions it read), so each exchange costs one barrier.  The forward
// transforms decimate in frequency and leave the spectrum digit-reversed
// (position k2 + R2 k1 holds frequency k1 + R1 k2); the inverse transforms
// run the same steps mirrored from that order back to natural order, so no
// reordering pass exists.  Twiddles and the T1/T2 factors are float64 tables
// the wrapper builds once per plan (`radix_fft._kernel_table`), read through
// the read-only cache.
//   * Stage 1: a block owns T columns (32 at 32 <= A <= 128, 256 at A <= 16)
//     and all A rows of one plane; a warp's lanes run along the columns, so at
//     A <= 128 every device-memory access is a coalesced 128-byte row segment.
//     The first step reads x straight from device memory and the last writes
//     y, so a two-step A (32 ... 256) makes one exchange through shared memory
//     (A * T * 8 bytes, 32 KB at A = 128), a three-step A (512 ... 2048) two,
//     and A <= 16 none.  Pruned: input rows >= in_rows are
//     never loaded, and where in_rows <= A/2 the first step's upper half is
//     known zero and its first butterfly layer is skipped; where
//     out_rows <= A/2 the last step forms only its lower half (the high digit
//     of the frequency).  The rider's self-dots are summed in registers, by
//     warp shuffles, then by thread 0 over the warps in order; a second launch
//     sums the tiles of each v in order: deterministic, no atomics.
//   * Middle: one block owns one (B, C) plane, kept in shared memory (rows of
//     128 complex values padded to 137, 140 KB at B = 128), through seven
//     phases with six barriers:
//       1. column step 1 over b, read from y with T1's row factor (a warp reads
//          consecutive c);   2. column step 2 with its twiddles, then T2 times
//          T1's column factor (both depend on c only within a column);
//       3. row step 1 over c;   4. row step 2, the product with d (read in
//          runs of 16 consecutive kc of d's stage order, 64 bytes), and the
//          inverse row step 2 on the same registers;   5. inverse row step 1;
//       6. inverse column step 2 with conj T2;   7. inverse column step 1,
//          conj T1, written to z (a warp writes consecutive c).
//     The padding (one complex value after every 16 of a row, an odd row
//     stride) makes every phase's shared-memory access free of bank conflicts
//     at B >= 16.  Dual middle (B-7): phase 4 parks the forward spectrum in
//     zB (each thread reloads only what it wrote), phases 4-7 run with dA into
//     zA and again with dB from the reloaded spectrum into zB.
//   * Weight cotangent: the forward half only, of x and of g, for every
//     (v, ka).  Bound by bytes like the middle: x and g are read once, 16
//     bytes a point per v (4.3 GB, 1.2846 ms at the training step's 128
//     planes, A = B = C = 128), against 0.58 ms of FFT operations.  One
//     plane fills a block's shared memory, so a two-CTA cluster per
//     (ka, split) holds the pair: rank 0 transforms x_v in its shared memory
//     while rank 1 transforms g_v in its own, each leaves its spectrum in
//     place (phase 4's forward half written back), and after a cluster
//     barrier each CTA forms Re[X conj G] for half of the rows, reading the
//     partner's plane over distributed shared memory; a second cluster
//     barrier comes before the next v's forward.  No spectrum goes to device
//     memory.  Each thread's sums (16 at B = 128, 8 below) stay in registers
//     over the v loop (ptxas: 128 registers, no spills at B = 128).  Each
//     plane's real half (64 KB at B = 128) arrives in the shared memory
//     left beside the plane by one 1-D bulk copy (TMA, completing on an
//     mbarrier), issued by one thread as soon as phase 1 of the previous
//     plane has read it, so it lands while that plane's phases 2-4 and the
//     product run; phase 1 reads only the imaginary half from device
//     memory.  A ka's V planes are split over
//     wgrad_splits(V, A, SMs) = min(V, max(1, SMs / 2 / A)) clusters (one
//     wave of clusters at A <= 64), in contiguous runs of v, whose sums a
//     second launch adds in split order: deterministic, no atomics.  On an
//     H100 80GB HBM3 at 700 W it takes 3.28 ms at the headline, 39 % of its
//     byte bound: the loads are hidden, and the four transform phases (70 %
//     of a CTA's cycles, `experiments/profile_wgrad_phases.py`) and the
//     product over distributed shared memory (19 %) set the time.
// Overlap with device memory.  The middle's plane fills one SM (140 KB of
// shared memory, 512 threads), so a second plane cannot be resident on it, and
// prefetching the next plane into registers would double the 64 values a
// thread already holds.  The traffic overlaps the transforms across SMs
// instead: the blocks (about four waves at the headline, 512 planes on 132
// SMs) drift out of step, so at any time some SMs load or store while the
// rest compute; each block starts all its loads at once (64 per thread in
// phase 1, 32 d values in phase 4), and its stores drain while the next block
// on its SM loads.  Within one SM, loads, transforms and stores still take
// turns: that is what stands between the middle and its byte bound.  Stage
// 1's tiles are small (32 KB), so several blocks share an SM and overlap one
// another directly.
// All arithmetic is full FP32 on the CUDA cores (no TF32).
//
// Interface: plain C, returns the cudaError_t of the first failing call (0 on
// success).  Launches on `stream`, never synchronises, allocates nothing.  The
// shared-memory opt-in of every kernel is set once per process.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int RED_THREADS = 256;     // threads of the dot-reduction block
constexpr int MC = 128;              // C
constexpr int MC1 = 16, MC2 = 8;     // C = MC1 * MC2: the row steps' radices
constexpr int MS = MC + MC / 16 + 1; // row stride of a middle plane (complex)
constexpr int WCL = 2;               // CTAs of a weight-cotangent cluster

// ---------------------------------------------------------------------------
// Complex arithmetic and the register DFT (csrc/fft_steps.cuh)
// ---------------------------------------------------------------------------

#include "fft_steps.cuh"

template <bool CONJ>
__device__ __forceinline__ float2 cmul_by(float2 a, float2 b) {
    return CONJ ? cmulc(a, b) : cmul(a, b);
}
__device__ __forceinline__ float2 ld2(const float* re, const float* im, size_t i) {
    return make_float2(re[i], im[i]);
}

// ---------------------------------------------------------------------------
// Stage 1 (B-2, B-3)
// ---------------------------------------------------------------------------

// The A-point DFT as up to three in-place steps of radices R1 >= R2 >= R3
// (1 = absent), T columns a tile, NT = T * A / R1 threads a block.  The
// wrapper's numpy model (tests/test_torch_radix_plan.py) uses the same
// radices (`radix_fft._S1_RADICES`).
template <int A> struct S1Plan;
template <> struct S1Plan<8>    { static constexpr int R1 = 8,  R2 = 1,  R3 = 1, T = 256; };
template <> struct S1Plan<16>   { static constexpr int R1 = 16, R2 = 1,  R3 = 1, T = 256; };
template <> struct S1Plan<32>   { static constexpr int R1 = 8,  R2 = 4,  R3 = 1, T = 32; };
template <> struct S1Plan<64>   { static constexpr int R1 = 8,  R2 = 8,  R3 = 1, T = 32; };
template <> struct S1Plan<128>  { static constexpr int R1 = 16, R2 = 8,  R3 = 1, T = 32; };
template <> struct S1Plan<256>  { static constexpr int R1 = 16, R2 = 16, R3 = 1, T = 16; };
template <> struct S1Plan<512>  { static constexpr int R1 = 8,  R2 = 8,  R3 = 8, T = 8; };
template <> struct S1Plan<1024> { static constexpr int R1 = 16, R2 = 8,  R3 = 8, T = 8; };
template <> struct S1Plan<2048> { static constexpr int R1 = 16, R2 = 16, R3 = 8, T = 4; };

template <int A> __host__ __device__ constexpr int s1_threads() { return S1Plan<A>::T * A / S1Plan<A>::R1; }
template <int A> __host__ __device__ constexpr int s1_levels() {
    return 1 + (S1Plan<A>::R2 > 1) + (S1Plan<A>::R3 > 1);
}
template <int A> constexpr size_t s1_smem() {
    return s1_levels<A>() > 1 ? (size_t)A * S1Plan<A>::T * sizeof(float2) : 0;
}

enum { FWD = 0, INV = 1, INV_DOT = 2 };

// Stage 1 on one tile: blockIdx.x = column tile, blockIdx.y = v.  x: (V,
// in_rows, N), y: (V, out_rows, N), re/im; twA[m] = exp(-2 pi i m / A).  With
// KIND == INV_DOT the rider u (shaped like y) gives the block's self-dot
// partials pr/pi[v * tiles + tile].  HALF: the forward's in_rows, the
// inverse's out_rows, is at most A / 2.
template <int A, int KIND, bool HALF>
__global__ void __launch_bounds__(s1_threads<A>())
stage1_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
              float* __restrict__ yr, float* __restrict__ yi,
              const float* __restrict__ ur, const float* __restrict__ ui,
              const float2* __restrict__ twA, float* __restrict__ pr,
              float* __restrict__ pi, int N, int in_rows, int out_rows) {
    using P = S1Plan<A>;
    constexpr int R1 = P::R1, R2 = P::R2, R3 = P::R3, T = P::T, NT = s1_threads<A>();
    constexpr int LEVELS = s1_levels<A>();
    constexpr int RL = LEVELS == 3 ? R3 : LEVELS == 2 ? R2 : R1;   // last radix
    constexpr int SIGN = KIND == FWD ? -1 : 1;
    constexpr bool CONJ = SIGN > 0;
    constexpr bool HALF_IN = HALF && KIND == FWD, HALF_OUT = HALF && KIND != FWD;
    constexpr int KEEP = HALF_OUT ? RL / 2 : RL;   // outputs formed per item
    extern __shared__ float2 tile[];
    const int v = blockIdx.y, j0 = blockIdx.x * T;
    const size_t xo = (size_t)v * in_rows * N + j0, yo = (size_t)v * out_rows * N + j0;
    float sr = 0.0f, si = 0.0f;

    // The last step's output: frequency pre + (A / RL) kL in register kL.
    auto emit = [&](const float2 (&w)[RL], int t, int pre) {
#pragma unroll
        for (int kl = 0; kl < KEEP; ++kl) {
            const int k = pre + (A / RL) * kl;
            if (k < out_rows) {
                const size_t g = yo + (size_t)k * N + t;
                yr[g] = w[kl].x;
                yi[g] = w[kl].y;
                if constexpr (KIND == INV_DOT) {
                    sr += ur[g] * w[kl].x;
                    si += ui[g] * w[kl].y;
                }
            }
        }
    };

    // step 1: rows a1 + (A / R1) b of x, b < R1, into frequency k1 at the
    // same rows
    constexpr int NB = HALF_IN ? R1 / 2 : R1;
#pragma unroll
    for (int it = 0; it < (A / R1) * T / NT; ++it) {
        const int q = threadIdx.x + it * NT;
        const int t = q % T, a1 = q / T;
        float2 w[R1];
#pragma unroll
        for (int b = 0; b < R1; ++b) {
            const int row = a1 + (A / R1) * b;
            w[b] = make_float2(0.0f, 0.0f);
            if (b < NB && row < in_rows) w[b] = ld2(xr, xi, xo + (size_t)row * N + t);
        }
        dft<R1, SIGN, HALF_IN>(w);
        if constexpr (LEVELS == 1) {
            emit(w, t, a1);
        } else {
#pragma unroll
            for (int k1 = 0; k1 < R1; ++k1) tile[(a1 + (A / R1) * k1) * T + t] = w[k1];
        }
    }
    if constexpr (LEVELS > 1) {
        __syncthreads();
        if constexpr (LEVELS == 3) {
            // step 2 in each block k1 of n2 = A / R1 positions: items a2 <
            // m2 = n2 / R2 over the positions a2 + m2 b2, with the pending
            // twiddle W_A^{(a2 + m2 b2) k1}
            constexpr int n2 = A / R1, m2 = n2 / R2;
#pragma unroll
            for (int it = 0; it < R1 * m2 * T / NT; ++it) {
                const int q = threadIdx.x + it * NT;
                const int t = q % T, r = q / T, a2 = r % m2, k1 = r / m2;
                float2 w[R2];
#pragma unroll
                for (int b = 0; b < R2; ++b) {
                    const int a = a2 + m2 * b;
                    w[b] = cmul_by<CONJ>(tile[(k1 * n2 + a) * T + t], twA[(a * k1) & (A - 1)]);
                }
                dft<R2, SIGN>(w);
#pragma unroll
                for (int k2 = 0; k2 < R2; ++k2) tile[(k1 * n2 + a2 + m2 * k2) * T + t] = w[k2];
            }
            __syncthreads();
        }
        // the last step: blocks of RL contiguous positions; block blk holds
        // (k1) or (k1, k2) and the pending twiddle of its previous step
#pragma unroll
        for (int it = 0; it < (A / RL) * T / NT; ++it) {
            const int q = threadIdx.x + it * NT;
            const int t = q % T, blk = q / T;
            int pre, twk;
            if constexpr (LEVELS == 2) {
                pre = blk;            // k1
                twk = blk;            // W_A^{a k1}
            } else {
                const int k1 = blk / R2, k2 = blk % R2;
                pre = k1 + R1 * k2;
                twk = k2 * R1;        // W_{A / R1}^{a k2} = W_A^{a k2 R1}
            }
            float2 w[RL];
#pragma unroll
            for (int a = 0; a < RL; ++a)
                w[a] = cmul_by<CONJ>(tile[(blk * RL + a) * T + t], twA[(a * twk) & (A - 1)]);
            dft<RL, SIGN>(w);
            emit(w, t, pre);
        }
    }
    if constexpr (KIND == INV_DOT) {
        __shared__ float red[2][NT / 32];
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) {
            sr += __shfl_xor_sync(0xffffffffu, sr, m);
            si += __shfl_xor_sync(0xffffffffu, si, m);
        }
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        if (lane == 0) {
            red[0][warp] = sr;
            red[1][warp] = si;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            float a = 0.0f, b = 0.0f;
            for (int w = 0; w < NT / 32; ++w) {
                a += red[0][w];
                b += red[1][w];
            }
            const int tile_id = v * gridDim.x + blockIdx.x;
            pr[tile_id] = a;
            pi[tile_id] = b;
        }
    }
}

// dr[v] = sum over tiles of pr[v * tiles + tile], in a fixed order; likewise di.
__global__ void __launch_bounds__(RED_THREADS)
dot_reduce_kernel(const float* __restrict__ pr, const float* __restrict__ pi,
                  float* __restrict__ dr, float* __restrict__ di, int tiles) {
    __shared__ float red[2][RED_THREADS / 32];
    const int v = blockIdx.x;
    float a = 0.0f, b = 0.0f;
    for (int t = threadIdx.x; t < tiles; t += RED_THREADS) {
        a += pr[(size_t)v * tiles + t];
        b += pi[(size_t)v * tiles + t];
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, m);
        b += __shfl_xor_sync(0xffffffffu, b, m);
    }
    if ((threadIdx.x & 31) == 0) {
        red[0][threadIdx.x >> 5] = a;
        red[1][threadIdx.x >> 5] = b;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float s = 0.0f, u = 0.0f;
        for (int w = 0; w < RED_THREADS / 32; ++w) {
            s += red[0][w];
            u += red[1][w];
        }
        dr[v] = s;
        di[v] = u;
    }
}

// ---------------------------------------------------------------------------
// The middle (B-4, B-7)
// ---------------------------------------------------------------------------

// The radices over b: B = R1 * R2 (R2 = 1: one step); `radix_fft._MID_RADICES`.
template <int B> struct MidPlan;
template <> struct MidPlan<128> { static constexpr int R1 = 16, R2 = 8; };
template <> struct MidPlan<64>  { static constexpr int R1 = 8,  R2 = 8; };
template <> struct MidPlan<32>  { static constexpr int R1 = 8,  R2 = 4; };
template <> struct MidPlan<16>  { static constexpr int R1 = 16, R2 = 1; };
template <> struct MidPlan<8>   { static constexpr int R1 = 8,  R2 = 1; };

// The plan's tables (complex), in the order of the wrapper's table after
// stage 1's twA (A values):
struct MidTab {
    const float2* tw4;   // [a][k1] = W_C^{a k1}, a < 8, k1 < 16
    const float2* twB;   // [m] = W_B^m, m < B
    const float2* base;  // [k1][c] = W_{BC}^{k1 c}, k1 < R1
    const float2* fac;   // [k2][c] = W_{BC}^{R1 k2 c}, k2 < R2
    const float2* t1r;   // [ka][b] = W_{AB}^{ka b}
    const float2* t1c;   // [ka][c] = W_L^{ka c}
};
// with W_n^m = exp(-2 pi i m / n).

// Position of element p of a row in shared memory (one pad every 16).
__device__ __forceinline__ int phys(int p) { return p + (p >> 4); }

// The smem-to-smem phases (2, 3, 5, 6) take their items one at a time (the
// compiler would otherwise hoist every item's loads and spill); phases 1 and
// 7 (device memory) and 4 (d) unroll theirs, so all their loads are in flight
// together.  128 registers a thread at 512 threads, no spills.  The weight
// cotangent keeps 16 sums a thread in registers and reads phase 1's real
// half from shared memory: it takes phase 1's items one at a time (unrolled,
// they spilled 272 bytes at B = 128) and phase 2's two at a time.
template <int B>
struct Mid {
    static constexpr int R1 = MidPlan<B>::R1, R2 = MidPlan<B>::R2;
    static constexpr int NT = B * MC / 16 < 512 ? B * MC / 16 : 512;
    static constexpr int P = B * MC;

    // Phase 1 (with phase 2 when R2 == 1): items (c, a1), the rows
    // a1 + R2 b of y times T1's row factor, the R1-point DFT over b into k1 at
    // rows a1 + R2 k1.  SERIAL: the items one at a time (the weight
    // cotangent, whose sums stay in registers beside them).
    template <bool SERIAL = false>
    __device__ static void fwd_b1(const float* __restrict__ yr, const float* __restrict__ yi,
                                  float2* s, const MidTab& t, int ka) {
        constexpr int ITEMS = R2 * MC;
        static_assert(ITEMS % NT == 0, "phase 1 items");
        auto item = [&](int it) {
            const int q = threadIdx.x + it * NT;
            const int c = q % MC, a1 = q / MC;
            float2 w[R1];
#pragma unroll
            for (int b = 0; b < R1; ++b) {
                const int row = a1 + R2 * b;
                w[b] = cmul(ld2(yr, yi, (size_t)row * MC + c), __ldg(t.t1r + ka * B + row));
            }
            dft<R1, -1>(w);
            if constexpr (R2 == 1) {
                const float2 tc = __ldg(t.t1c + ka * MC + c);
#pragma unroll
                for (int kb = 0; kb < R1; ++kb)
                    s[kb * MS + phys(c)] = cmul(w[kb], cmul(__ldg(t.base + kb * MC + c), tc));
            } else {
#pragma unroll
                for (int k1 = 0; k1 < R1; ++k1) s[(a1 + R2 * k1) * MS + phys(c)] = w[k1];
            }
        };
        if constexpr (SERIAL) {
#pragma unroll 1
            for (int it = 0; it < ITEMS / NT; ++it) item(it);
        } else {
#pragma unroll
            for (int it = 0; it < ITEMS / NT; ++it) item(it);
        }
    }

    // Phase 2: items (c, k1), the rows k1 R2 + a times W_B^{a k1}, the
    // R2-point DFT over a into k2, times T2[kb, c] T1's column factor, kb =
    // k1 + R1 k2 (row k1 R2 + k2 holds kb).  PAIRS: two items at a time (the
    // weight cotangent, whose phase 1 leaves the registers for it).
    template <bool PAIRS = false>
    __device__ static void fwd_b2(float2* s, const MidTab& t, int ka) {
        constexpr int ITEMS = R1 * MC;
        static_assert(ITEMS % NT == 0, "phase 2 items");
        auto item = [&](int it) {
            const int q = threadIdx.x + it * NT;
            const int c = q % MC, k1 = q / MC;
            float2 w[R2];
#pragma unroll
            for (int a = 0; a < R2; ++a)
                w[a] = cmul(s[(k1 * R2 + a) * MS + phys(c)], __ldg(t.twB + a * k1));
            dft<R2, -1>(w);
            const float2 tt = cmul(__ldg(t.base + k1 * MC + c), __ldg(t.t1c + ka * MC + c));
#pragma unroll
            for (int k2 = 0; k2 < R2; ++k2)
                s[(k1 * R2 + k2) * MS + phys(c)] = cmul(w[k2], cmul(tt, __ldg(t.fac + k2 * MC + c)));
        };
        if constexpr (PAIRS) {
#pragma unroll 2
            for (int it = 0; it < ITEMS / NT; ++it) item(it);
        } else {
#pragma unroll 1
            for (int it = 0; it < ITEMS / NT; ++it) item(it);
        }
    }

    // Phase 3: items (row, a), a < 8, the positions a + 8 m of the row, the
    // 16-point DFT over m into k1 at positions a + 8 k1.
    __device__ static void fwd_c1(float2* s) {
        constexpr int ITEMS = MC2 * B;
        static_assert(ITEMS % NT == 0, "phase 3 items");
#pragma unroll 1
        for (int it = 0; it < ITEMS / NT; ++it) {
            const int q = threadIdx.x + it * NT;
            const int row = q % B, a = q / B;
            float2* r = s + row * MS;
            float2 w[MC1];
#pragma unroll
            for (int m = 0; m < MC1; ++m) w[m] = r[phys(a + MC2 * m)];
            dft<MC1, -1>(w);
#pragma unroll
            for (int k1 = 0; k1 < MC1; ++k1) r[phys(a + MC2 * k1)] = w[k1];
        }
    }

    // Phase 4: items (row, k1), k1 < 16, the positions 8 k1 + a times
    // W_C^{a k1}, the 8-point DFT over a into k2 (kc = k1 + 16 k2), times
    // d[kb, kc], the inverse 8-point DFT back over a, times conj W_C^{a k1}.
    // PARK: the spectrum is also written to (zr, zi) at (row, kc); RELOAD: it
    // is read from there instead of formed (each thread reads back only what
    // it wrote).
    template <bool PARK, bool RELOAD>
    __device__ static void c_mid(float2* s, const MidTab& t, const float* __restrict__ dp,
                                 float* zr, float* zi) {
        constexpr int ITEMS = MC1 * B;
        static_assert(ITEMS % NT == 0, "phase 4 items");
#pragma unroll
        for (int it = 0; it < ITEMS / NT; ++it) {
            const int q = threadIdx.x + it * NT;
            const int k1 = q % MC1, row = q / MC1;
            const int kb = row / R2 + R1 * (row % R2);
            float2* r = s + row * MS;
            float dv[MC2];
#pragma unroll
            for (int k2 = 0; k2 < MC2; ++k2) dv[k2] = __ldg(dp + kb * MC + k1 + MC1 * k2);
            float2 w[MC2];
            if constexpr (RELOAD) {
#pragma unroll
                for (int k2 = 0; k2 < MC2; ++k2) w[k2] = ld2(zr, zi, row * MC + k1 + MC1 * k2);
            } else {
#pragma unroll
                for (int a = 0; a < MC2; ++a)
                    w[a] = cmul(r[phys(MC2 * k1 + a)], __ldg(t.tw4 + a * MC1 + k1));
                dft<MC2, -1>(w);
                if constexpr (PARK) {
#pragma unroll
                    for (int k2 = 0; k2 < MC2; ++k2) {
                        zr[row * MC + k1 + MC1 * k2] = w[k2].x;
                        zi[row * MC + k1 + MC1 * k2] = w[k2].y;
                    }
                }
            }
#pragma unroll
            for (int k2 = 0; k2 < MC2; ++k2) w[k2] = make_float2(w[k2].x * dv[k2], w[k2].y * dv[k2]);
            dft<MC2, 1>(w);
#pragma unroll
            for (int a = 0; a < MC2; ++a)
                r[phys(MC2 * k1 + a)] = cmulc(w[a], __ldg(t.tw4 + a * MC1 + k1));
        }
    }

    // Phase 4's forward half alone, for item `it` of this thread: the
    // positions 8 k1 + a of its row times W_C^{a k1}, the 8-point DFT over a
    // into w[k2], kc = k1 + 16 k2; the row holds kb = row / R2 + R1 (row % R2).
    __device__ static void c_spectrum(const float2* s, const MidTab& t, int it, int& row,
                                      int& k1, float2 (&w)[MC2]) {
        const int q = threadIdx.x + it * NT;
        k1 = q % MC1;
        row = q / MC1;
        const float2* r = s + row * MS;
#pragma unroll
        for (int a = 0; a < MC2; ++a) w[a] = cmul(r[phys(MC2 * k1 + a)], __ldg(t.tw4 + a * MC1 + k1));
        dft<MC2, -1>(w);
    }

    // Phase 5: items (row, a), the positions a + 8 k1, the inverse 16-point
    // DFT over k1 into c = a + 8 m (natural order).
    __device__ static void inv_c1(float2* s) {
        constexpr int ITEMS = MC2 * B;
#pragma unroll 1
        for (int it = 0; it < ITEMS / NT; ++it) {
            const int q = threadIdx.x + it * NT;
            const int row = q % B, a = q / B;
            float2* r = s + row * MS;
            float2 w[MC1];
#pragma unroll
            for (int k1 = 0; k1 < MC1; ++k1) w[k1] = r[phys(a + MC2 * k1)];
            dft<MC1, 1>(w);
#pragma unroll
            for (int m = 0; m < MC1; ++m) r[phys(a + MC2 * m)] = w[m];
        }
    }

    // Phase 6 (R2 > 1): items (c, k1), the rows k1 R2 + k2 times conj T2 and
    // conj T1's column factor, the inverse R2-point DFT over k2 into a, times
    // conj W_B^{a k1}.
    __device__ static void inv_b2(float2* s, const MidTab& t, int ka) {
        constexpr int ITEMS = R1 * MC;
#pragma unroll 1
        for (int it = 0; it < ITEMS / NT; ++it) {
            const int q = threadIdx.x + it * NT;
            const int c = q % MC, k1 = q / MC;
            const float2 tt = cmul(__ldg(t.base + k1 * MC + c), __ldg(t.t1c + ka * MC + c));
            float2 w[R2];
#pragma unroll
            for (int k2 = 0; k2 < R2; ++k2)
                w[k2] = cmulc(s[(k1 * R2 + k2) * MS + phys(c)], cmul(tt, __ldg(t.fac + k2 * MC + c)));
            dft<R2, 1>(w);
#pragma unroll
            for (int a = 0; a < R2; ++a)
                s[(k1 * R2 + a) * MS + phys(c)] = cmulc(w[a], __ldg(t.twB + a * k1));
        }
    }

    // Phase 7 (with phase 6 when R2 == 1): items (c, a1), the rows a1 + R2 k1,
    // the inverse R1-point DFT over k1 into b = a1 + R2 m, times conj T1's row
    // factor, into z.
    __device__ static void inv_b1(const float2* s, const MidTab& t, int ka,
                                  float* zr, float* zi) {
        constexpr int ITEMS = R2 * MC;
#pragma unroll
        for (int it = 0; it < ITEMS / NT; ++it) {
            const int q = threadIdx.x + it * NT;
            const int c = q % MC, a1 = q / MC;
            float2 w[R1];
            if constexpr (R2 == 1) {
                const float2 tc = __ldg(t.t1c + ka * MC + c);
#pragma unroll
                for (int kb = 0; kb < R1; ++kb)
                    w[kb] = cmulc(s[kb * MS + phys(c)], cmul(__ldg(t.base + kb * MC + c), tc));
            } else {
#pragma unroll
                for (int k1 = 0; k1 < R1; ++k1) w[k1] = s[(a1 + R2 * k1) * MS + phys(c)];
            }
            dft<R1, 1>(w);
#pragma unroll
            for (int m = 0; m < R1; ++m) {
                const int row = a1 + R2 * m;
                const float2 o = cmulc(w[m], __ldg(t.t1r + ka * B + row));
                zr[(size_t)row * MC + c] = o.x;
                zi[(size_t)row * MC + c] = o.y;
            }
        }
    }

    // The forward half through phase 3 (ends with a barrier).
    __device__ static void forward(const float* yr, const float* yi, float2* s,
                                   const MidTab& t, int ka) {
        fwd_b1(yr, yi, s, t, ka);
        __syncthreads();
        if constexpr (R2 > 1) {
            fwd_b2(s, t, ka);
            __syncthreads();
        }
        fwd_c1(s);
        __syncthreads();
    }

    // Phases 5-7 after phase 4 (begins with a barrier).
    __device__ static void inverse(float2* s, const MidTab& t, int ka, float* zr, float* zi) {
        __syncthreads();
        inv_c1(s);
        __syncthreads();
        if constexpr (R2 > 1) {
            inv_b2(s, t, ka);
            __syncthreads();
        }
        inv_b1(s, t, ka, zr, zi);
    }
};

template <int B> constexpr size_t mid_smem() { return (size_t)B * MS * sizeof(float2); }
// the weight cotangent's: the plane, the staged real half of the next plane
// and the staging mbarrier (205 840 bytes at B = 128)
template <int B> constexpr size_t wgrad_smem() {
    return mid_smem<B>() + (size_t)B * MC * sizeof(float) + 16;
}

// The middle on plane ka of sample v, blockIdx.x = ka * V + v (the V planes
// of one ka, which share d, run together).
template <int B>
__global__ void __launch_bounds__(Mid<B>::NT, 1)
middle_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
              const float* __restrict__ d, MidTab t, float* __restrict__ zr,
              float* __restrict__ zi, int V) {
    extern __shared__ float2 plane[];
    constexpr int P = Mid<B>::P;
    const int ka = blockIdx.x / V, v = blockIdx.x % V;
    const int A = gridDim.x / V;
    const size_t base = ((size_t)v * A + ka) * P;
    Mid<B>::forward(yr + base, yi + base, plane, t, ka);
    Mid<B>::template c_mid<false, false>(plane, t, d + (size_t)ka * P, nullptr, nullptr);
    Mid<B>::inverse(plane, t, ka, zr + base, zi + base);
}

// Kernel B-7: the middle with two diagonals on one forward half.  The forward
// spectrum is parked in zB, the inverse half runs with dA into zA, then with
// dB from the reloaded spectrum into zB.
template <int B>
__global__ void __launch_bounds__(Mid<B>::NT, 1)
middle_dual_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                   const float* __restrict__ dA, const float* __restrict__ dB, MidTab t,
                   float* __restrict__ zAr, float* __restrict__ zAi, float* zBr,
                   float* zBi, int V) {
    extern __shared__ float2 plane[];
    constexpr int P = Mid<B>::P;
    const int ka = blockIdx.x / V, v = blockIdx.x % V;
    const int A = gridDim.x / V;
    const size_t base = ((size_t)v * A + ka) * P;
    Mid<B>::forward(yr + base, yi + base, plane, t, ka);
    Mid<B>::template c_mid<true, false>(plane, t, dA + (size_t)ka * P, zBr + base, zBi + base);
    Mid<B>::inverse(plane, t, ka, zAr + base, zAi + base);
    __syncthreads();   // every thread is done with the plane before phase 4 rewrites it
    Mid<B>::template c_mid<false, true>(plane, t, dB + (size_t)ka * P, zBr + base, zBi + base);
    Mid<B>::inverse(plane, t, ka, zBr + base, zBi + base);
}

// The staging of the weight cotangent's planes: a 1-D bulk copy (TMA) from
// device memory into shared memory that completes on an mbarrier.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// One thread: the barrier, one arrival a phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One thread, after a block barrier that ends every read of dst: bytes
// (a multiple of 16, both addresses 16-byte aligned) from src to dst,
// completing the barrier's next phase.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];"
                 ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Every thread: wait until the barrier's phase of this parity is complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}"
                     : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    } while (!done);
}

#ifdef WGRAD_PHASE_CLOCKS
// Per-phase clocks of the weight cotangent for
// experiments/profile_wgrad_phases.py, built only with -DWGRAD_PHASE_CLOCKS
// (the kernel's own build has no marks): thread 0 of each CTA sums the
// clocks since its last mark by phase and adds them to the device counters
// when it is done.
__device__ unsigned long long wgrad_phase_clocks[8];
#define WG_PHASE_START() unsigned long long wg_t0 = clock64(), wg_c[8] = {0}
#define WG_PHASE(i)                                      \
    do {                                                 \
        if (threadIdx.x == 0) {                          \
            const unsigned long long wg_t = clock64();   \
            wg_c[i] += wg_t - wg_t0;                     \
            wg_t0 = wg_t;                                \
        }                                                \
    } while (0)
#define WG_PHASE_END()                                                   \
    do {                                                                 \
        if (threadIdx.x == 0)                                            \
            for (int i = 0; i < 8; ++i) atomicAdd(&wgrad_phase_clocks[i], wg_c[i]); \
    } while (0)
#else
#define WG_PHASE_START()
#define WG_PHASE(i)
#define WG_PHASE_END()
#endif

// B-4's weight cotangent: out[ka, kb, kc] = sum over the cluster's v of
// Re[X_v conj(G_v)], X = M x and G = M g the forward middle (phases 1-4's
// forward half) of the stage-1 outputs x and g, in d's stage order.  A
// cluster of WCL = 2 CTAs, cluster p = blockIdx.x / 2 = s * A + ka, takes
// the v of split s of `splits` (a contiguous run, in order) and writes its
// sum to out + p * P; rank 0 transforms x, rank 1 g.  Each CTA's items of
// the product are the rows [rank B/2, (rank + 1) B/2) of the planes, thread
// q's i-th item row rank B/2 + j / 128 and position j % 128, j = q + i NT:
// a warp reads 32 consecutive positions of a row (conflict-free, and one
// run of the partner's plane a request, 256 bytes and a pad).
template <int B>
__global__ void __launch_bounds__(Mid<B>::NT, 1)
middle_wgrad_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    const float* __restrict__ gr, const float* __restrict__ gi, MidTab t,
                    float* __restrict__ out, int V, int A, int splits) {
    extern __shared__ float2 plane[];
    using Mb = Mid<B>;
    constexpr int P = Mb::P, NT = Mb::NT, NI = MC1 * B / NT, PER = B / 2 * MC / NT;
    float* stage = reinterpret_cast<float*>(plane + B * MS);   // the next plane's real half
    uint64_t* full = reinterpret_cast<uint64_t*>(stage + P);
    const cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int p = blockIdx.x / WCL, ka = p % A, s = p / A;
    const float* yr = rank ? gr : xr;
    const float* yi = rank ? gi : xi;
    const float2* peer = cluster.map_shared_rank(plane, rank ^ 1);
    const int v0 = (int)((long long)s * V / splits), v1 = (int)((long long)(s + 1) * V / splits);
    float acc[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] = 0.0f;
    if (threadIdx.x == 0) {
        mbar_init(full);
        if (v0 < v1) bulk_load(stage, yr + ((size_t)v0 * A + ka) * P, P * sizeof(float), full);
    }
    __syncthreads();   // the barrier is initialised before anyone waits on it
    WG_PHASE_START();
    for (int v = v0; v < v1; ++v) {
        const size_t base = ((size_t)v * A + ka) * P;
        mbar_wait(full, (v - v0) & 1);
        WG_PHASE(0);
        Mb::template fwd_b1<true>(stage, yi + base, plane, t, ka);
        __syncthreads();
        WG_PHASE(1);
        // the stage is read: the next plane's real half lands while this
        // one is transformed
        if (threadIdx.x == 0 && v + 1 < v1)
            bulk_load(stage, yr + base + (size_t)A * P, P * sizeof(float), full);
        if constexpr (Mb::R2 > 1) {
            Mb::template fwd_b2<true>(plane, t, ka);
            __syncthreads();
        }
        WG_PHASE(2);
        Mb::fwd_c1(plane);
        __syncthreads();
        WG_PHASE(3);
        // phase 4's forward half, written back in place: row r holds
        // kb = r / R2 + R1 (r % R2), position 8 k1 + k2 holds kc = k1 + 16 k2
#pragma unroll
        for (int it = 0; it < NI; ++it) {
            int row, k1;
            float2 w[MC2];
            Mb::c_spectrum(plane, t, it, row, k1, w);
#pragma unroll
            for (int k2 = 0; k2 < MC2; ++k2) plane[row * MS + phys(MC2 * k1 + k2)] = w[k2];
        }
        WG_PHASE(4);
        cluster.sync();   // both spectra are complete
        WG_PHASE(5);
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int j = threadIdx.x + i * NT;
            const int at = (rank * (B / 2) + j / MC) * MS + phys(j % MC);
            const float2 a = plane[at], b = peer[at];
            acc[i] += a.x * b.x + a.y * b.y;
        }
        WG_PHASE(6);
        cluster.sync();   // both planes are read before the next v's forward
        WG_PHASE(7);
    }
    WG_PHASE_END();
    float* o = out + (size_t)p * P;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        const int j = threadIdx.x + i * NT;
        const int row = rank * (B / 2) + j / MC, pos = j % MC;
        o[(row / Mb::R2 + Mb::R1 * (row % Mb::R2)) * MC + pos / MC2 + MC1 * (pos % MC2)] = acc[i];
    }
}

// out[i] = sum over s < S of part[s * n + i], in order.
__global__ void __launch_bounds__(RED_THREADS)
wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, size_t n, int S) {
    for (size_t i = (size_t)blockIdx.x * RED_THREADS + threadIdx.x; i < n;
         i += (size_t)gridDim.x * RED_THREADS) {
        float a = 0.0f;
        for (int s = 0; s < S; ++s) a += part[(size_t)s * n + i];
        out[i] = a;
    }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

__host__ inline bool is_pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }
__host__ inline int clampi(int x, int lo, int hi) { return x < lo ? lo : x > hi ? hi : x; }

int mid_radix1(int B) {
    switch (B) {
        case 128: return MidPlan<128>::R1;
        case 64: return MidPlan<64>::R1;
        case 32: return MidPlan<32>::R1;
        case 16: return MidPlan<16>::R1;
        case 8: return MidPlan<8>::R1;
    }
    return 0;
}

// Complex values of the plan table: twA, then the middle's tables.
size_t table_complex(int A, int B) {
    const int R1 = mid_radix1(B), R2 = R1 ? B / R1 : 0;
    return (size_t)A + MC1 * MC2 + B + (size_t)(R1 + R2) * MC + (size_t)A * B + (size_t)A * MC;
}

MidTab mid_tables(const float* tab, int A, int B) {
    const int R1 = mid_radix1(B), R2 = B / R1;
    const float2* p = reinterpret_cast<const float2*>(tab) + A;
    MidTab t;
    t.tw4 = p;
    t.twB = t.tw4 + MC1 * MC2;
    t.base = t.twB + B;
    t.fac = t.base + (size_t)R1 * MC;
    t.t1r = t.fac + (size_t)R2 * MC;
    t.t1c = t.t1r + (size_t)A * B;
    return t;
}

// Calls of cudaFuncSetAttribute, and kernels configured (both once each).
int g_attribute_sets = 0;
int g_kernels = 0;

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
    ++g_kernels;
    if (bytes <= 48 * 1024) return cudaSuccess;
    ++g_attribute_sets;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int A>
cudaError_t configure_stage1() {
    cudaError_t err;
    constexpr size_t s = s1_smem<A>();
    if ((err = allow_smem(stage1_kernel<A, FWD, false>, s))) return err;
    if ((err = allow_smem(stage1_kernel<A, FWD, true>, s))) return err;
    if ((err = allow_smem(stage1_kernel<A, INV, false>, s))) return err;
    if ((err = allow_smem(stage1_kernel<A, INV, true>, s))) return err;
    if ((err = allow_smem(stage1_kernel<A, INV_DOT, false>, s))) return err;
    return allow_smem(stage1_kernel<A, INV_DOT, true>, s);
}

template <int B>
cudaError_t configure_middle() {
    cudaError_t err;
    if ((err = allow_smem(middle_kernel<B>, mid_smem<B>()))) return err;
    if ((err = allow_smem(middle_wgrad_kernel<B>, wgrad_smem<B>()))) return err;
    return allow_smem(middle_dual_kernel<B>, mid_smem<B>());
}

// The shared-memory opt-in of every kernel of this file, once per process.
cudaError_t configure_once() {
    static bool done = false;
    if (done) return cudaSuccess;
    cudaError_t err;
    if ((err = configure_stage1<8>()) || (err = configure_stage1<16>()) ||
        (err = configure_stage1<32>()) || (err = configure_stage1<64>()) ||
        (err = configure_stage1<128>()) || (err = configure_stage1<256>()) ||
        (err = configure_stage1<512>()) || (err = configure_stage1<1024>()) ||
        (err = configure_stage1<2048>()))
        return err;
    if ((err = configure_middle<8>()) || (err = configure_middle<16>()) ||
        (err = configure_middle<32>()) || (err = configure_middle<64>()) ||
        (err = configure_middle<128>()))
        return err;
    done = true;
    return cudaSuccess;
}

template <int A, int KIND, bool HALF>
int launch_s1(const float* xr, const float* xi, float* yr, float* yi, const float* ur,
              const float* ui, const float* tab, float* pr, float* pi, int V, int N,
              int in_rows, int out_rows, cudaStream_t stream) {
    constexpr int T = S1Plan<A>::T;
    dim3 grid(N / T, V);
    stage1_kernel<A, KIND, HALF><<<grid, s1_threads<A>(), s1_smem<A>(), stream>>>(
        xr, xi, yr, yi, ur, ui, reinterpret_cast<const float2*>(tab), pr, pi, N, in_rows,
        out_rows);
    return (int)cudaGetLastError();
}

template <int A, int KIND>
int launch_s1_half(bool half, const float* xr, const float* xi, float* yr, float* yi,
                   const float* ur, const float* ui, const float* tab, float* pr, float* pi,
                   int V, int N, int in_rows, int out_rows, cudaStream_t stream) {
    if (half)
        return launch_s1<A, KIND, true>(xr, xi, yr, yi, ur, ui, tab, pr, pi, V, N, in_rows,
                                        out_rows, stream);
    return launch_s1<A, KIND, false>(xr, xi, yr, yi, ur, ui, tab, pr, pi, V, N, in_rows,
                                     out_rows, stream);
}

template <int A>
int launch_s1_kind(int kind, const float* xr, const float* xi, float* yr, float* yi,
                   const float* ur, const float* ui, const float* tab, float* pr, float* pi,
                   int V, int N, int in_rows, int out_rows, cudaStream_t stream) {
    const bool half = 2 * (kind == FWD ? in_rows : out_rows) <= A;
    if (kind == FWD)
        return launch_s1_half<A, FWD>(half, xr, xi, yr, yi, ur, ui, tab, pr, pi, V, N,
                                      in_rows, out_rows, stream);
    if (kind == INV)
        return launch_s1_half<A, INV>(half, xr, xi, yr, yi, ur, ui, tab, pr, pi, V, N,
                                      in_rows, out_rows, stream);
    return launch_s1_half<A, INV_DOT>(half, xr, xi, yr, yi, ur, ui, tab, pr, pi, V, N,
                                      in_rows, out_rows, stream);
}

int s1_cols(int A) {
    switch (A) {
        case 8: return S1Plan<8>::T;
        case 16: return S1Plan<16>::T;
        case 32: return S1Plan<32>::T;
        case 64: return S1Plan<64>::T;
        case 128: return S1Plan<128>::T;
        case 256: return S1Plan<256>::T;
        case 512: return S1Plan<512>::T;
        case 1024: return S1Plan<1024>::T;
        case 2048: return S1Plan<2048>::T;
    }
    return 0;
}

template <int A>
int s1_radices_of(int* r) {
    r[0] = S1Plan<A>::R1;
    r[1] = S1Plan<A>::R2;
    r[2] = S1Plan<A>::R3;
    return 1;
}

int s1_radices(int A, int* r) {
    switch (A) {
        case 8: return s1_radices_of<8>(r);
        case 16: return s1_radices_of<16>(r);
        case 32: return s1_radices_of<32>(r);
        case 64: return s1_radices_of<64>(r);
        case 128: return s1_radices_of<128>(r);
        case 256: return s1_radices_of<256>(r);
        case 512: return s1_radices_of<512>(r);
        case 1024: return s1_radices_of<1024>(r);
        case 2048: return s1_radices_of<2048>(r);
    }
    return 0;
}

bool s1_args_ok(int V, int N, int A, int in_rows, int out_rows) {
    return V > 0 && is_pow2(N) && N >= 1024 && s1_cols(A) > 0 && N % s1_cols(A) == 0
        && in_rows >= 1 && in_rows <= A && out_rows >= 1 && out_rows <= A;
}

int launch_stage1(int kind, const float* xr, const float* xi, float* yr, float* yi,
                  const float* ur, const float* ui, const float* tab, float* pr, float* pi,
                  int V, int N, int A, int in_rows, int out_rows, cudaStream_t stream) {
    cudaError_t err = configure_once();
    if (err) return (int)err;
#define S1_CASE(n)                                                                     \
    case n:                                                                            \
        return launch_s1_kind<n>(kind, xr, xi, yr, yi, ur, ui, tab, pr, pi, V, N, in_rows, \
                                 out_rows, stream);
    switch (A) {
        S1_CASE(8) S1_CASE(16) S1_CASE(32) S1_CASE(64) S1_CASE(128) S1_CASE(256)
        S1_CASE(512) S1_CASE(1024) S1_CASE(2048)
    }
#undef S1_CASE
    return (int)cudaErrorInvalidValue;
}

bool middle_args_ok(int V, int A, int B, int C) {
    return V > 0 && is_pow2(A) && A >= 8 && A <= 2048 && mid_radix1(B) > 0 && C == MC;
}

template <int B>
int launch_middle_b(bool dual, const float* yr, const float* yi, const float* dA,
                    const float* dB, const MidTab& t, float* zAr, float* zAi, float* zBr,
                    float* zBi, int V, int A, cudaStream_t stream) {
    const dim3 grid(A * V);
    if (dual)
        middle_dual_kernel<B><<<grid, Mid<B>::NT, mid_smem<B>(), stream>>>(
            yr, yi, dA, dB, t, zAr, zAi, zBr, zBi, V);
    else
        middle_kernel<B><<<grid, Mid<B>::NT, mid_smem<B>(), stream>>>(yr, yi, dA, t, zAr, zAi, V);
    return (int)cudaGetLastError();
}

int launch_middle(bool dual, const float* yr, const float* yi, const float* dA,
                  const float* dB, const float* tab, float* zAr, float* zAi, float* zBr,
                  float* zBi, int V, int A, int B, int C, cudaStream_t stream) {
    if (!middle_args_ok(V, A, B, C)) return (int)cudaErrorInvalidValue;
    cudaError_t err = configure_once();
    if (err) return (int)err;
    const MidTab t = mid_tables(tab, A, B);
#define MID_CASE(n) \
    case n: return launch_middle_b<n>(dual, yr, yi, dA, dB, t, zAr, zAi, zBr, zBi, V, A, stream);
    switch (B) {
        MID_CASE(8) MID_CASE(16) MID_CASE(32) MID_CASE(64) MID_CASE(128)
    }
#undef MID_CASE
    return (int)cudaErrorInvalidValue;
}

// V planes of a ka over this many clusters: one wave of the SMs / WCL
// clusters the card holds at A <= 64 (one cluster a ka above), at most one
// a plane (`radix_fft.wgrad_splits`).
int wgrad_splits(int V, int A, int sms) { return clampi(sms / WCL / A, 1, V); }

template <int B>
void wgrad_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int clusters,
                  cudaStream_t stream) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(clusters * WCL, 1, 1);
    cfg.blockDim = dim3(Mid<B>::NT, 1, 1);
    cfg.dynamicSmemBytes = wgrad_smem<B>();
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = WCL;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
}

template <int B>
int launch_wgrad_b(const float* xr, const float* xi, const float* gr, const float* gi,
                   const MidTab& t, float* out, int V, int A, int splits,
                   cudaStream_t stream) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    wgrad_config<B>(cfg, attr, A * splits, stream);
    cudaError_t err = cudaLaunchKernelEx(&cfg, middle_wgrad_kernel<B>, xr, xi, gr, gi, t, out,
                                         V, A, splits);
    if (err) return (int)err;
    return (int)cudaGetLastError();
}

template <int B>
int wgrad_clusters_b(int* n) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    wgrad_config<B>(cfg, attr, 1, 0);
    return (int)cudaOccupancyMaxActiveClusters(n, middle_wgrad_kernel<B>, &cfg);
}

}  // namespace

extern "C" {

#ifdef WGRAD_PHASE_CLOCKS
// The weight cotangent's per-phase clocks (8) into out; zeroed after when
// `reset`.
int radix_wgrad_phase_clocks(unsigned long long* out, int reset) {
    cudaError_t err = cudaMemcpyFromSymbol(out, wgrad_phase_clocks, sizeof(wgrad_phase_clocks));
    if (err || !reset) return (int)err;
    unsigned long long zero[8] = {0};
    return (int)cudaMemcpyToSymbol(wgrad_phase_clocks, zero, sizeof(zero));
}
#endif

// Floats of the plan table the kernels read (float64 values rounded to
// float32, built by the wrapper): 2 * table_complex(A, B), 0 for a B the
// middle does not take.
size_t radix_table_floats(int A, int B) {
    if (A <= 0 || mid_radix1(B) == 0) return 0;
    return 2 * table_complex(A, B);
}

// The register radices of plan (A, B), which the wrapper's tables and its CPU
// model follow: r[0..2] stage 1's A-point DFT (1 past its last step), r[3..4]
// the middle's B-point DFT over b (r[4] = 1: one step), r[5..6] its C-point
// DFT over c.  Returns 1, or 0 (r untouched) for a plan the kernels do not take.
int radix_plan(int A, int B, int* r) {
    int s1[3];
    const int R1 = mid_radix1(B);
    if (R1 == 0 || !s1_radices(A, s1)) return 0;
    r[0] = s1[0];
    r[1] = s1[1];
    r[2] = s1[2];
    r[3] = R1;
    r[4] = B / R1;
    r[5] = MC1;
    r[6] = MC2;
    return 1;
}

// Floats of one partial-dot array for radix_stage1_dot (the caller passes 2x).
size_t radix_dot_partials(int V, int N, int A) {
    if (V <= 0 || N <= 0 || s1_cols(A) == 0) return 0;
    return (size_t)V * (N / s1_cols(A));
}

// cudaFuncSetAttribute calls made so far, and kernels configured: each kernel
// is configured once per process, on the first launch of any.
int radix_attribute_sets(void) { return g_attribute_sets; }
int radix_kernels_configured(void) { return g_kernels; }

// y = the A-point DFT over the rows of x, forward (sign -1) or inverse (+1),
// rows >= in_rows of x zero, rows < out_rows of y formed.
// x: (V, in_rows, N), y: (V, out_rows, N); tab: the plan table.
int radix_stage1(const float* xr, const float* xi, float* yr, float* yi, const float* tab,
                 int V, int N, int A, int in_rows, int out_rows, int sign, void* stream) {
    if (!s1_args_ok(V, N, A, in_rows, out_rows) || (sign != 1 && sign != -1))
        return (int)cudaErrorInvalidValue;
    return launch_stage1(sign < 0 ? FWD : INV, xr, xi, yr, yi, nullptr, nullptr, tab,
                         nullptr, nullptr, V, N, A, in_rows, out_rows, (cudaStream_t)stream);
}

// The inverse stage 1 of z (V, A, N) to y (V, out_rows, N), plus
// dr[v] = sum ur[v] * yr[v] and di[v] = sum ui[v] * yi[v] (u like y).
// partial: 2 * radix_dot_partials(V, N, A) floats of scratch.
int radix_stage1_dot(const float* zr, const float* zi, const float* ur, const float* ui,
                     const float* tab, float* yr, float* yi, float* dr, float* di,
                     float* partial, int V, int N, int A, int out_rows, void* stream) {
    if (!s1_args_ok(V, N, A, A, out_rows)) return (int)cudaErrorInvalidValue;
    const int tiles = N / s1_cols(A);
    float* pr = partial;
    float* pi = partial + (size_t)V * tiles;
    cudaStream_t st = (cudaStream_t)stream;
    int err = launch_stage1(INV_DOT, zr, zi, yr, yi, ur, ui, tab, pr, pi, V, N, A, A,
                            out_rows, st);
    if (err) return err;
    dot_reduce_kernel<<<V, RED_THREADS, 0, st>>>(pr, pi, dr, di, tiles);
    return (int)cudaGetLastError();
}

// The middle stages on y (V, A, B, C) with the stage-order diagonal d (A, B, C)
// into z (V, A, B, C).
int radix_middle(const float* yr, const float* yi, const float* d, const float* tab,
                 float* zr, float* zi, int V, int A, int B, int C, void* stream) {
    return launch_middle(false, yr, yi, d, nullptr, tab, zr, zi, nullptr, nullptr, V, A, B,
                         C, (cudaStream_t)stream);
}

// Kernel B-7: the middle stages on y (V, A, B, C) with two stage-order
// diagonals dA, dB (A, B, C) sharing one forward half, into zA and zB
// (V, A, B, C) each.
int radix_middle_dual(const float* yr, const float* yi, const float* dA, const float* dB,
                      const float* tab, float* zAr, float* zAi, float* zBr, float* zBi,
                      int V, int A, int B, int C, void* stream) {
    return launch_middle(true, yr, yi, dA, dB, tab, zAr, zAi, zBr, zBi, V, A, B, C,
                         (cudaStream_t)stream);
}

// B-4's weight cotangent: dbar (A, B, C) = sum over v of Re[(M x)(v) conj
// (M g)(v)], M the forward middle, of the stage-1 outputs x and g
// (V, A, B, C; xr and gr 16-byte aligned, the bulk copies' rule).  The V
// planes of a ka are split over wgrad_splits(V, A, sms) clusters; when that
// is more than one, partial (partial_floats >= splits * A * B * C) takes
// their sums, added in order into dbar by a second launch (else partial is
// unused and may be null: the clusters write dbar).
int radix_middle_wgrad(const float* xr, const float* xi, const float* gr, const float* gi,
                       const float* tab, float* partial, size_t partial_floats, float* dbar,
                       int V, int A, int B, int C, int sms, void* stream) {
    if (!middle_args_ok(V, A, B, C) || sms < 1 ||
        ((uintptr_t)xr | (uintptr_t)gr) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const int splits = wgrad_splits(V, A, sms);
    const size_t n = (size_t)A * B * C;
    if (splits > 1 && (partial == nullptr || partial_floats < (size_t)splits * n))
        return (int)cudaErrorInvalidValue;
    cudaError_t cerr = configure_once();
    if (cerr) return (int)cerr;
    const MidTab t = mid_tables(tab, A, B);
    cudaStream_t st = (cudaStream_t)stream;
    float* out = splits == 1 ? dbar : partial;
    int err = (int)cudaErrorInvalidValue;
#define WG_CASE(n) \
    case n: err = launch_wgrad_b<n>(xr, xi, gr, gi, t, out, V, A, splits, st); break;
    switch (B) {
        WG_CASE(8) WG_CASE(16) WG_CASE(32) WG_CASE(64) WG_CASE(128)
    }
#undef WG_CASE
    if (err || splits == 1) return err;
    const int blocks = (int)((n + RED_THREADS - 1) / RED_THREADS < 4096
                                 ? (n + RED_THREADS - 1) / RED_THREADS : 4096);
    wgrad_reduce_kernel<<<blocks, RED_THREADS, 0, st>>>(partial, dbar, n, splits);
    return (int)cudaGetLastError();
}

// The weight cotangent at plan B: its dynamic shared memory a CTA (bytes),
// and *clusters the card keeps resident at once (cudaOccupancyMaxActiveClusters).
size_t radix_wgrad_smem_bytes(int B) {
    switch (B) {
        case 8: return wgrad_smem<8>();
        case 16: return wgrad_smem<16>();
        case 32: return wgrad_smem<32>();
        case 64: return wgrad_smem<64>();
        case 128: return wgrad_smem<128>();
    }
    return 0;
}

int radix_wgrad_max_clusters(int B, int* clusters) {
    cudaError_t err = configure_once();
    if (err) return (int)err;
    switch (B) {
        case 8: return wgrad_clusters_b<8>(clusters);
        case 16: return wgrad_clusters_b<16>(clusters);
        case 32: return wgrad_clusters_b<32>(clusters);
        case 64: return wgrad_clusters_b<64>(clusters);
        case 128: return wgrad_clusters_b<128>(clusters);
    }
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
