// K4: the rate-distortion loop's outer iterations, one frame a block.
//
// Replaces the `jax.lax.while_loop`s of the JAX package's batched RD search,
// which XLA runs on the TPU (no Pallas kernel): the outer distortion loop
// (mrcaudiocodec_tpu/ops/rd.py:255-269), the staged refine search inside it
// (:189) and its GAIN_MAX fallback `lax.cond` (:200). Its plain version is
// rd_loop_plain in ops/rd.py, which runs the same loop over the whole batch
// with a host sync at each exit test. Here each frame runs it to its own
// exit; a frame whose noise is under its mask is a fixed point of the loop
// body, so that exit is the batch's.
//
// Contract, per frame f, from the inner sweep's (gain0, bits0), amp = 0:
//   q = quantize(x, gain0); over = over_mask(q)
//   for it = 1 .. OUTER_MAX - 1 while any(over):
//     amp = min(amp + AMP_STEP * over, AMP_MAX); amp_bin = amp of each bin
//     fixed = BLOCK_TYPE_BITS + GAIN_BITS + CB_BITS * real bands + the
//             scale-factor delta bits of amp (entropy.fixed_and_sf_bits)
//     refine: blocks b = 0 .. 3 of candidates min(prev + 4b + w, GAIN_MAX),
//             w = 0 .. 3, bits = payload + fixed; the lowest fitting
//             (bits <= budget) candidate of the first block that has one;
//             none: GAIN_MAX and its own bits
//     q = quantize(x, gain); over = over_mask(q)
//   over_mask: xhat = dequantize(q, e) (xlog2 / xexp2 op for op as
//   xpsy.py's, mag == 0 -> 0, the clamp at 1, the sign by q < 0), d = x -
//   xhat, the band sums of d * d by the pinned segmented scan (xpsy.seg_scan
//   over the frame family's band edges: p[i] += p[i - s] where i - s >=
//   seg_start(i), s = 1, 2, 4, ... below the widest band; a band reads its
//   last bin, a zero-width band 0); over = noise > allowed & width > 0 &
//   amp < AMP_MAX.
// Out: q [F, 1024], amp [F, nb], gain [F], bits [F], int32. Every f32 op is
// a single correctly-rounded __f*_rn op in the order of the torch DAG, and
// the library is built with --fmad=false: no contraction, no flush to zero.
//
// Bound on this card: f32 ALU work, as K2's. A refine candidate costs what a
// K2 task does (54 f32 ops a bin, held by the integer work beside them);
// each over-mask adds a quantize (54 ops a bin), a dequantize (~53), d and
// d * d, and one add a bin per scan stage (8 long, 6 short at 44.1 kHz).
// The candidates and outer iterations depend on the data: profiling's bound
// counts what rd_loop_plain reaches on the same input. A frame's loop is a
// chain of dependent steps with a barrier each, so what also bounds it is
// latency: the card needs many frames in flight.
//
// Design: one block of 4 warps a frame; no atomic, no host sync.
//  * Set-up stages the frame's x (swizzled float4, as K2), the code tables,
//    the tuple -> band map and the band edges of the frame's block type, and
//    keeps x, q of the thread's 8 bins (t + 128 k) in registers. Thread b <
//    nb owns band b: its allowed noise, amp, width and last bin. The widest
//    band (a warp max) sets the scan's stages.
//  * Refine: warp w takes candidate w of each block of REFINE_BLOCK = 4, so
//    K2's warp routine (quant_cost_warp.cuh) runs as it is on the staged x
//    and amp_bin; lane 0 writes its bits to a double-buffered slot, and
//    after one barrier every thread reads the 4 and takes the same first
//    fit, so the exit is block-uniform. The fallback's payload at GAIN_MAX
//    is computed by every warp alike (no barrier).
//  * Over-mask: each thread quantizes, dequantizes and squares its 8 bins
//    into shared memory; the scan runs double-buffered over the 1024 bins,
//    one barrier a stage; thread b reads band b's sum.
//  * The loop test is __syncthreads_or of the band flags, so every exit is
//    block-uniform and no barrier diverges. No integer division or modulo
//    by a variable (it would compile to F2I.FTZ). Static shared memory
//    about 27 KB a block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_cost_warp.cuh"

namespace {

using namespace quant_warp;

constexpr int kWarps = 4;                  // = REFINE_BLOCK
constexpr int kThreads = 32 * kWarps;
constexpr int kBinsPerThread = kCoeffs / kThreads;
constexpr int kRefineBlocks = 4;           // (REFINE_WINDOW + 1) / 4
constexpr int kOuterMax = 8;               // config.OUTER_MAX
constexpr int kAmpStep = 2;                // config.AMP_STEP
constexpr int kAmpMax = 24;                // config.AMP_MAX
constexpr int kGainMax = 255;              // config.GAIN_MAX
constexpr int kFixedBits = 3 + 8;          // BLOCK_TYPE_BITS + GAIN_BITS
constexpr int kCbBits = 2;                 // config.CB_BITS
constexpr int kSfDeltaMax = 60;            // config.SF_DELTA_MAX
constexpr int kLenSf = 2 * kSfDeltaMax + 1;
// rd_loop.consts(): K2's kConsts, then these offsets
constexpr int kFrac = 11, kLog2P = 15, kExpK = 28, kC43 = 36, kLn2 = 37,
              kSqrt2 = 38, kAllConsts = 39;

// xpsy.xlog2: exponent by bitcast, mantissa in [sqrt2/2, sqrt2), degree-12
// Horner in t = m - 1
__device__ __forceinline__ float xlog2(float x, const float* c) {
    const int bits = __float_as_int(x);
    int e = (bits >> 23) - 127;
    float m = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
    const bool big = m >= c[kSqrt2];
    m = big ? __fmul_rn(m, 0.5f) : m;
    e = big ? e + 1 : e;
    const float t = __fsub_rn(m, 1.0f);
    const float* L = c + kLog2P;
    float p = __fadd_rn(__fmul_rn(L[12], t), L[11]);
#pragma unroll
    for (int i = 10; i >= 0; --i) p = __fadd_rn(__fmul_rn(p, t), L[i]);
    return __fadd_rn((float)e, p);
}

// xpsy.xexp2: k = round half to even, f = x - k, Taylor-Horner of f * ln2,
// scaled by 2^k through the exponent bits
__device__ __forceinline__ float xexp2(float x, const float* c) {
    int k = (int)rintf(x);
    k = k < -126 ? -126 : (k > 126 ? 126 : k);
    const float f = __fsub_rn(x, (float)k);
    const float v = __fmul_rn(f, c[kLn2]);
    const float* K = c + kExpK;
    float p = __fadd_rn(__fmul_rn(K[0], v), K[1]);
#pragma unroll
    for (int i = 2; i < 8; ++i) p = __fadd_rn(__fmul_rn(p, v), K[i]);
    return __fmul_rn(p, __int_as_float((k + 127) << 23));
}

// quantize.dequantize of one bin at exponent e
__device__ __forceinline__ float dequant(int q, int e, const float* c) {
    const float mag = (float)(q < 0 ? -q : q);
    float p43 = xexp2(__fmul_rn(c[kC43], xlog2(fmaxf(mag, 1.0f), c)), c);
    p43 = mag == 0.0f ? 0.0f : p43;
    const int d = e - 128;
    const float step = __fmul_rn(c[kFrac + (d & 3)],
                                 __int_as_float(((d >> 2) + 127) << 23));
    const float val = __fmul_rn(p43, step);
    return q < 0 ? -val : val;
}

// The thread's 8 bins quantized at `gain` into qr, then the over flag of
// band tid: dequantize, d * d into s_p[0], the pinned scan, band tid's sum.
// Called by every thread (barriers inside; maxw is block-uniform).
__device__ __forceinline__ bool quantize_over(
    const float (&xr)[kBinsPerThread], int (&qr)[kBinsPerThread], int gain,
    const int* s_ab_bin, float (*s_p)[kCoeffs], const unsigned char* s_band,
    const int* s_edge, int maxw, const float* P, float magic,
    const float* c, bool band_over_ok, int end_b, float allowed_b) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int k = 0; k < kBinsPerThread; ++k) {
        const int i = tid + kThreads * k;
        const int e = exponent_of(gain, s_ab_bin[4 * swz(i >> 2) + (i & 3)]);
        const int mag = quant_mag(xr[k], inv_step(e, c), P, magic);
        qr[k] = xr[k] < 0.0f ? -mag : mag;
        const float d = __fsub_rn(xr[k], dequant(qr[k], e, c));
        s_p[0][i] = __fmul_rn(d, d);
    }
    __syncthreads();
    int cur = 0;
    for (int s = 1; s < maxw; s <<= 1) {
#pragma unroll
        for (int k = 0; k < kBinsPerThread; ++k) {
            const int i = tid + kThreads * k;
            const float v = s_p[cur][i];
            s_p[cur ^ 1][i] = i - s >= s_edge[s_band[i >> 2]]
                                  ? __fadd_rn(v, s_p[cur][i - s]) : v;
        }
        __syncthreads();
        cur ^= 1;
    }
    // band_over_ok: the thread owns a real band whose amp is below AMP_MAX
    return band_over_ok && s_p[cur][end_b] > allowed_b;
}

__global__ void __launch_bounds__(kThreads)
rd_loop_kernel(const float* __restrict__ x, const float* __restrict__ allowed,
               const int* __restrict__ budget, const int* __restrict__ bt,
               const int* __restrict__ gain0, const int* __restrict__ bits0,
               const int* __restrict__ band_tuples,
               const int* __restrict__ len_small,
               const int* __restrict__ pair_em,
               const int* __restrict__ pair_sf,
               const int* __restrict__ len_sf,
               const float* __restrict__ consts, int* __restrict__ q_out,
               int* __restrict__ amp_out, int* __restrict__ gain_out,
               int* __restrict__ bits_out, int nb) {
    __shared__ float4 s_x[kTuples];            // swizzled
    __shared__ int4 s_amp[kTuples];            // amp_bin, swizzled
    __shared__ float s_p[2][kCoeffs];          // the scan's two buffers
    __shared__ int s_small[81];
    __shared__ int s_em[kPairs];
    __shared__ int s_sf[kPairs];
    __shared__ int s_lsf[kLenSf];
    __shared__ float s_consts[kAllConsts];
    __shared__ unsigned char s_band[kTuples];  // tuple -> band
    __shared__ int s_edge[kNbMax + 1];         // band edges in bins
    __shared__ int s_ab[kNbMax];               // amp of each band
    __shared__ int s_red[kWarps];
    __shared__ int s_bits[2][kWarps];          // a refine block's bits

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const long long f = blockIdx.x;
    for (int i = tid; i < 81; i += kThreads) s_small[i] = len_small[i];
    for (int i = tid; i < kPairs; i += kThreads) {
        s_em[i] = pair_em[i];
        s_sf[i] = pair_sf[i];
    }
    for (int i = tid; i < kLenSf; i += kThreads) s_lsf[i] = len_sf[i];
    if (tid < kAllConsts) s_consts[tid] = consts[tid];
    const float4* xf = reinterpret_cast<const float4*>(x + f * kCoeffs);
    for (int i = tid; i < kTuples; i += kThreads) {
        s_x[swz(i)] = xf[i];
        s_amp[i] = make_int4(0, 0, 0, 0);
    }
    const int* te = band_tuples + bt[f] * (nb + 1);
    for (int b = tid; b < nb; b += kThreads)
        for (int u = te[b]; u < te[b + 1]; ++u) s_band[u] = (unsigned char)b;
    for (int b = tid; b <= nb; b += kThreads) s_edge[b] = 4 * te[b];
    float xr[kBinsPerThread];
    int qr[kBinsPerThread];
#pragma unroll
    for (int k = 0; k < kBinsPerThread; ++k)
        xr[k] = x[f * kCoeffs + tid + kThreads * k];
    const bool has_band = tid < nb;
    const float allowed_b = has_band ? allowed[f * nb + tid] : 0.0f;
    const int budget_f = budget[f];
    __syncthreads();

    // band tid's facts, the real bands' count and the widest band
    const int width_b = has_band ? s_edge[tid + 1] - s_edge[tid] : 0;
    const bool real_b = width_b > 0;
    const bool real_prev =
        has_band && tid > 0 && s_edge[tid] > s_edge[tid - 1];
    const int end_b = real_b ? s_edge[tid + 1] - 1 : 0;
    const int wmax = __reduce_max_sync(kFull, width_b);
    if (lane == 0) s_red[warp] = wmax;
    const int nreal = __syncthreads_count(real_b);
    int maxw = s_red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) maxw = s_red[w] > maxw ? s_red[w] : maxw;
    const LaneBands lb = lane_bands(s_band, lane);
    float P[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) P[i] = s_consts[i];
    const float magic = s_consts[10];
    const int* s_ab_bin = reinterpret_cast<const int*>(s_amp);

    // entry: amp = 0, the inner sweep's gain
    int gain = gain0[f], bits = bits0[f];
    int amp_b = 0;
    bool over = quantize_over(xr, qr, gain, s_ab_bin, s_p, s_band, s_edge,
                              maxw, P, magic, s_consts, real_b, end_b,
                              allowed_b);
    for (int it = 1; it < kOuterMax; ++it) {
        if (!__syncthreads_or(over)) break;
        amp_b += over ? kAmpStep : 0;
        amp_b = amp_b < kAmpMax ? amp_b : kAmpMax;
        if (has_band) s_ab[tid] = amp_b;
        __syncthreads();
        for (int u = tid; u < kTuples; u += kThreads) {
            const int a = s_ab[s_band[u]];
            s_amp[swz(u)] = make_int4(a, a, a, a);
        }
        // scale-factor deltas: prev - amp + SF_DELTA_MAX over the real
        // bands, a non-real band's amp counting as 0
        const int prev = real_prev ? s_ab[tid - 1] : 0;
        const int sf = real_b ? s_lsf[prev - amp_b + kSfDeltaMax] : 0;
        const int sf_w = __reduce_add_sync(kFull, sf);
        if (lane == 0) s_red[warp] = sf_w;
        __syncthreads();
        int fixed = kFixedBits + kCbBits * nreal;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) fixed += s_red[w];

        // refine: warp w evaluates candidate w of each block
        const int prev_gain = gain;
        bool found = false;
        for (int b = 0; b < kRefineBlocks && !found; ++b) {
            const int cw = prev_gain + kWarps * b + warp;
            const int mine = warp_payload(
                s_x, s_amp, lb, cw < kGainMax ? cw : kGainMax, lane, P, magic,
                s_consts, s_small, s_em, s_sf) + fixed;
            if (lane == 0) s_bits[b & 1][warp] = mine;
            __syncthreads();
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
                const int bw = s_bits[b & 1][w];
                if (!found && bw <= budget_f) {
                    const int c = prev_gain + kWarps * b + w;
                    gain = c < kGainMax ? c : kGainMax;
                    bits = bw;
                    found = true;
                }
            }
        }
        if (!found) {                  // no fit in the window: GAIN_MAX
            gain = kGainMax;
            bits = warp_payload(s_x, s_amp, lb, kGainMax, lane, P, magic,
                                s_consts, s_small, s_em, s_sf) + fixed;
        }
        over = quantize_over(xr, qr, gain, s_ab_bin, s_p, s_band, s_edge,
                             maxw, P, magic, s_consts,
                             real_b && amp_b < kAmpMax, end_b, allowed_b);
    }

#pragma unroll
    for (int k = 0; k < kBinsPerThread; ++k)
        q_out[f * kCoeffs + tid + kThreads * k] = qr[k];
    if (has_band) amp_out[f * nb + tid] = amp_b;
    if (tid == 0) {
        gain_out[f] = gain;
        bits_out[f] = bits;
    }
}

}  // namespace

extern "C" {

// x [F,1024] f32 (16-byte aligned), allowed [F,nb] f32, budget, bt, gain0,
// bits0 [F] i32, band_tuples [5, nb+1] i32 (tuple edges of each block type's
// bands), len_small [81], pair_em [33*33], pair_sf [33*33], len_sf [121]
// i32, consts [39] f32 -> q [F,1024], amp [F,nb], gain [F], bits [F] i32.
// Returns cudaGetLastError() after the launch (0 = launched),
// cudaErrorInvalidValue for nb outside 1..128.
int mrc_rd_loop(const float* x, const float* allowed, const int* budget,
                const int* bt, const int* gain0, const int* bits0,
                const int* band_tuples, const int* len_small,
                const int* pair_em, const int* pair_sf, const int* len_sf,
                const float* consts, int* q, int* amp, int* gain, int* bits,
                long long n_frames, int nb, void* stream) {
    if (nb < 1 || nb > kNbMax || n_frames < 1 || n_frames > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    rd_loop_kernel<<<(unsigned)n_frames, kThreads, 0,
                     (cudaStream_t)stream>>>(
        x, allowed, budget, bt, gain0, bits0, band_tuples, len_small,
        pair_em, pair_sf, len_sf, consts, q, amp, gain, bits, nb);
    return (int)cudaGetLastError();
}

}  // extern "C"
