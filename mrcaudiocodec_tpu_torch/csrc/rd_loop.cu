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
//   over_mask: xhat = dequantize(q, e) (|q|^(4/3) as xlog2 / xexp2 give it,
//   0 at q = 0, times the step, the sign by q < 0), d = x - xhat, the band
//   sums of d * d by the pinned segmented scan (xpsy.seg_scan over the frame
//   family's band edges: p[i] += p[i - s] where i - s >= seg_start(i), s =
//   1, 2, 4, ... below the widest band; a band reads its last bin, a
//   zero-width band 0); over = noise > allowed & width > 0 & amp < AMP_MAX.
// Out: q [F, 1024], amp [F, nb], gain [F], bits [F], int32. Every f32 op is
// a single correctly-rounded __f*_rn op in the order of the torch DAG, and
// the library is built with --fmad=false: no contraction, no flush to zero.
//
// What bounds it. A refine candidate costs what a K2 task does (54 f32 ops
// a bin, held by the integer work beside them, as K2 is); the candidates and
// outer iterations depend on the data, and profiling's bound counts what
// rd_loop_plain reaches on the same input (profiling.rd_loop_ops). The
// first design (one block of 4 warps a frame, 96 registers, 5 blocks an
// SM) was measured first (chip_smoke.py phase 4, k4_locate): on the
// 30 s chunk's rows with every frame at OUTER_MAX, one block an SM took
// 0.103 ms, two 0.108, four 0.145, five (one wave of 660 frames) 0.167, and
// 2586 rows 0.636 ms, in proportion to the waves. So across waves it was
// bound by issue, but inside a wave latency still showed: five blocks an SM
// ran only 3.1 times the work of one in the same time. A block's own chain
// was long: each refine warp quantizes all 1024 bins (32 a lane, in turn),
// then the over-mask quantized and dequantized the 1024 bins again (xlog2
// and xexp2, about 93 f32 ops a bin) and scanned them with one block
// barrier a stage. This design cuts both the work and the chain, and keeps
// 7 blocks an SM (6 ran 4% slower, 8 with spills no faster); what is left
// is the refine's integer-bound quantize, about three quarters of an outer
// iteration, and the latency of each frame's chain of iterations, which
// shows in the last wave.
//
// Design: one block of 4 warps a frame; no atomic, no host sync; 3 block
// barriers an outer iteration (the exit test, the amps, each refine block).
//  * Set-up stages the frame's x (swizzled float4, as K2), the code tables
//    (each thread's loads unrolled, so they are in flight together), the
//    tuple -> band map, each tuple's offset in its band and its amp (one
//    byte each), the band edges, allowed noise, amps and over flags. The
//    frame's bins are cut into 4 warp regions at the first band edge at or
//    above 256 w, so that no band crosses a region.
//  * Refine: warp w takes candidate w of each block of REFINE_BLOCK = 4 on
//    K2's routine (quant_cost_warp.cuh) in a K4 form that reads a tuple's
//    amp as one byte and keeps the candidate's magnitudes in its own slot
//    of shared memory (1024 uint16); lane 0 writes its payload, and after
//    one barrier every thread adds the fixed bits and takes the same first
//    fit, so the exit is block-uniform. The GAIN_MAX fallback is computed
//    once, by warp 0, which keeps its magnitudes in slot 0.
//  * Over-mask, warp by warp over its own region, with no block barrier:
//    the winner's kept magnitudes (only the entry quantizes, at gain0 with
//    amp 0), |q|^(4/3) read from a 4096-entry table through the read-only
//    cache (quantize.dequantize's chain at step 1, built by the wrapper with
//    the port's own ops: the same bits by construction), times the step,
//    the sign from x; d * d a tuple as a float4; then the pinned scan in
//    place, stage by stage up to the region's widest band, 32 tuples at a
//    time from the region's top down (each lane reads its tuple and the
//    shifted one, __syncwarp, writes; from s = 4 on a tuple that adds
//    nothing is neither read nor written), the adds of each stage those of
//    xpsy.seg_scan; the lanes then set the region's band flags.
//  * The loop test is __syncthreads_or of the flags, so every exit is
//    block-uniform and no barrier diverges. No integer division or modulo
//    by a variable (it would compile to F2I.FTZ). Static shared memory
//    28120 B a block; __launch_bounds__ asks for 7 blocks (28 warps) an SM,
//    so at most 72 registers a thread; the region bounds and the band
//    before's amp live in shared memory, so that no register holds them
//    through the refine.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_cost_warp.cuh"

namespace {

using namespace quant_warp;

constexpr int kWarps = 4;                  // = REFINE_BLOCK
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 7;              // resident blocks an SM
constexpr int kRefineBlocks = 4;           // (REFINE_WINDOW + 1) / 4
constexpr int kOuterMax = 8;               // config.OUTER_MAX
constexpr int kAmpStep = 2;                // config.AMP_STEP
constexpr int kAmpMax = 24;                // config.AMP_MAX
constexpr int kGainMax = 255;              // config.GAIN_MAX
constexpr int kFixedBits = 3 + 8;          // BLOCK_TYPE_BITS + GAIN_BITS
constexpr int kCbBits = 2;                 // config.CB_BITS
constexpr int kSfDeltaMax = 60;            // config.SF_DELTA_MAX
constexpr int kLenSf = 2 * kSfDeltaMax + 1;
constexpr int kRegion = kCoeffs / kWarps;  // a warp region's nominal bins
// rd_loop.consts(): K2's kConsts, then the step fractions
constexpr int kFrac = 11, kAllConsts = 15;

// tuple u's slot in a warp's kept magnitudes: x's swizzle, bit 0 flipped
// in the upper half of each 64 tuples, so that the refine's 8-byte stores
// (lane l, step s: tuple 8l + s) and the over-mask's reads of consecutive
// tuples are free of bank conflicts
__device__ __forceinline__ int kslot(int u) {
    return swz(u) ^ ((u >> 6) & 1);
}

// K2's tuple_values for a tuple of one amp, keeping its 4 magnitudes
__device__ __forceinline__ Sums k4_tuple(float4 xv, int amp, int gain,
                                         const float* P, float magic,
                                         const float* s_consts,
                                         const int* s_small, const int* s_em,
                                         const int* s_sf, uint2& keep) {
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
    const float inv = inv_step_of(gain, amp, s_consts);
    int m[4];
    bool neg[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        m[k] = quant_mag(xs[k], inv, P, magic);
        neg[k] = xs[k] < 0.0f;
    }
    keep = make_uint2(m[0] | m[1] << 16, m[2] | m[3] << 16);
    return tuple_sums(m, neg, s_small, s_em, s_sf);
}

// K2's warp_payload with a byte of amp a tuple (s_tamp, tuple order) and
// the magnitudes kept in `keep` (at kslot); the same sums in the same order
__device__ __forceinline__ int k4_payload(const float4* s_x,
                                          const unsigned char* s_tamp,
                                          uint2* keep, const LaneBands& lb,
                                          int gain, int lane,
                                          const float* s_consts,
                                          const int* s_small, const int* s_em,
                                          const int* s_sf) {
    float P[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) P[i] = s_consts[i];
    const float magic = s_consts[10];
    int cost = 0;
    walk_bands(
        lb,
        [&](int s) {
            const int u = 8 * lane + s;
            uint2 m;
            const Sums t = k4_tuple(s_x[8 * lane + (s ^ (lane & 7))],
                                    s_tamp[u], gain, P, magic, s_consts,
                                    s_small, s_em, s_sf, m);
            keep[kslot(u)] = m;
            return t;
        },
        [&](bool on, int, const Sums& sums) {
            cost += on ? band_cost(sums) : 0;
        });
    return __reduce_add_sync(kFull, cost);
}

// (x - dequantize(q))^2 of one bin, q = sign(x) * mag (q < 0 only where
// x < 0 and mag > 0)
__device__ __forceinline__ float sq_err(float x, unsigned mag, float step,
                                        const float* __restrict__ pow43) {
    const float val = __fmul_rn(__ldg(pow43 + mag), step);
    const float xhat = x < 0.0f && mag != 0u ? -val : val;
    const float d = __fsub_rn(x, xhat);
    return __fmul_rn(d, d);
}

// The over flags of warp w's region's bands into s_over -> whether any is
// set in this lane. The region (read from shared memory, so that it holds
// no register through the refine): tuples [s_cut[w] / 4, s_cut[w + 1] / 4),
// the bands [s_bfirst[w], s_bfirst[w + 1]) that lie in it, its widest band
// s_maxw[w] in bins. kEntry: quantize at gain with amp 0 and keep the
// magnitudes; else read them from `keep`.
template <bool kEntry>
__device__ __forceinline__ bool region_over(
    int w, int lane, int gain, const int* s_cut, const int* s_bfirst,
    const int* s_maxw, const float4* s_x, const unsigned char* s_tamp,
    uint2* keep, float4* s_p, const unsigned char* s_toff, const int* s_edge,
    const float* s_allowed, unsigned char* s_over, const float* c,
    const float* __restrict__ pow43) {
    const int t0 = s_cut[w] >> 2, t1 = s_cut[w + 1] >> 2;
    for (int u = t0 + lane; u < t1; u += 32) {
        const float4 xv = s_x[swz(u)];
        const int e = exponent_of(gain, s_tamp[u]);
        uint2 m;
        if (kEntry) {
            float P[6];
#pragma unroll
            for (int i = 0; i < 6; ++i) P[i] = c[i];
            const float inv = inv_step(e, c);
            m = make_uint2(quant_mag(xv.x, inv, P, c[10])
                               | quant_mag(xv.y, inv, P, c[10]) << 16,
                           quant_mag(xv.z, inv, P, c[10])
                               | quant_mag(xv.w, inv, P, c[10]) << 16);
            keep[kslot(u)] = m;
        } else {
            m = keep[kslot(u)];
        }
        const int d = e - 128;
        const float step = __fmul_rn(c[kFrac + (d & 3)],
                                     __int_as_float(((d >> 2) + 127) << 23));
        s_p[u] = make_float4(sq_err(xv.x, m.x & 0xFFFFu, step, pow43),
                             sq_err(xv.y, m.x >> 16, step, pow43),
                             sq_err(xv.z, m.y & 0xFFFFu, step, pow43),
                             sq_err(xv.w, m.y >> 16, step, pow43));
    }
    __syncwarp();
    // the pinned scan in place: stage s adds p[i - s] where the bin's offset
    // in its band is at least s; a tuple's 4 bins are one float4, so below
    // s = 4 the shifted bins lie in the tuple before, from s = 4 on whole
    // tuples shift by s / 4. Chunks of 32 tuples from the top down, so a
    // chunk's reads come before any write of the bins they read.
    const int top = t0 + ((t1 - t0 - 1) & ~31), maxw = s_maxw[w];
    for (int s = 1; s < maxw; s <<= 1) {
        const int st = s < 4 ? 1 : s >> 2;
        for (int base = top; base >= t0; base -= 32) {
            const int u = base + lane;
            const bool in = u < t1;
            const bool take = in && s_toff[u] >= st;
            float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f), sh = v;
            if (take || (in && s < 4)) v = s_p[u];
            if (take) sh = s_p[u - st];
            __syncwarp();
            if (s >= 4) {                  // a tuple that takes nothing stays
                if (take)
                    s_p[u] = make_float4(
                        __fadd_rn(v.x, sh.x), __fadd_rn(v.y, sh.y),
                        __fadd_rn(v.z, sh.z), __fadd_rn(v.w, sh.w));
            } else if (in) {
                float4 o;
                if (s == 1) {
                    o.x = take ? __fadd_rn(v.x, sh.w) : v.x;
                    o.y = __fadd_rn(v.y, v.x);
                    o.z = __fadd_rn(v.z, v.y);
                    o.w = __fadd_rn(v.w, v.z);
                } else {
                    o.x = take ? __fadd_rn(v.x, sh.z) : v.x;
                    o.y = take ? __fadd_rn(v.y, sh.w) : v.y;
                    o.z = __fadd_rn(v.z, v.x);
                    o.w = __fadd_rn(v.w, v.y);
                }
                s_p[u] = o;
            }
        }
        __syncwarp();
    }
    // band b's noise is its last bin's sum
    const float* p = reinterpret_cast<const float*>(s_p);
    bool any = false;
    for (int b = s_bfirst[w] + lane; b < s_bfirst[w + 1]; b += 32) {
        const int lo = s_edge[b], hi = s_edge[b + 1];
        if (hi > lo) {
            const bool o =
                p[hi - 1] > s_allowed[b] && s_tamp[lo >> 2] < kAmpMax;
            s_over[b] = (unsigned char)o;
            any = any || o;
        }
    }
    return any;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
rd_loop_kernel(const float* __restrict__ x, const float* __restrict__ allowed,
               const int* __restrict__ budget, const int* __restrict__ bt,
               const int* __restrict__ gain0, const int* __restrict__ bits0,
               const int* __restrict__ band_tuples,
               const int* __restrict__ len_small,
               const int* __restrict__ pair_em,
               const int* __restrict__ pair_sf,
               const int* __restrict__ len_sf,
               const float* __restrict__ consts,
               const float* __restrict__ pow43, int* __restrict__ q_out,
               int* __restrict__ amp_out, int* __restrict__ gain_out,
               int* __restrict__ bits_out, int nb) {
    __shared__ float4 s_x[kTuples];            // swizzled
    __shared__ uint2 s_keep[kWarps][kTuples];  // kept magnitudes, at kslot
    __shared__ float4 s_p[kTuples];            // d * d, scanned in place
    __shared__ int s_small[81];
    __shared__ int s_em[kPairs];
    __shared__ int s_sf[kPairs];
    __shared__ int s_lsf[kLenSf];
    __shared__ float s_consts[kAllConsts];
    __shared__ float s_allowed[kNbMax];
    __shared__ int s_edge[kNbMax + 1];         // band edges in bins
    __shared__ unsigned char s_band[kTuples];  // tuple -> band
    __shared__ unsigned char s_toff[kTuples];  // tuple's offset in its band
    __shared__ unsigned char s_tamp[kTuples];  // tuple's amp
    __shared__ unsigned char s_over[kNbMax];   // band over its allowed noise
    __shared__ unsigned char s_ab[kNbMax];     // band's amp
    __shared__ int s_cut[kWarps + 1];          // regions' first bin
    __shared__ int s_bfirst[kWarps + 1];       // regions' first band
    __shared__ int s_maxw[kWarps];             // regions' widest band
    __shared__ int s_red[kWarps];              // sf bits a warp
    __shared__ int s_bits[2][kWarps];          // a refine block's payloads

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const long long f = blockIdx.x;
    // the copies unrolled, so that a thread's loads are all in flight at once
    if (tid < 81) s_small[tid] = len_small[tid];
#pragma unroll
    for (int k = 0; k < (kPairs + kThreads - 1) / kThreads; ++k) {
        const int i = tid + kThreads * k;
        if (i < kPairs) {
            s_em[i] = pair_em[i];
            s_sf[i] = pair_sf[i];
        }
    }
    if (tid < kLenSf) s_lsf[tid] = len_sf[tid];
    if (tid < kAllConsts) s_consts[tid] = consts[tid];
    const float4* xf = reinterpret_cast<const float4*>(x + f * kCoeffs);
#pragma unroll
    for (int k = 0; k < kTuples / kThreads; ++k) {
        const int i = tid + kThreads * k;
        s_x[swz(i)] = xf[i];
        s_tamp[i] = 0;
    }
    const int* te = band_tuples + bt[f] * (nb + 1);
    for (int b = tid; b < nb; b += kThreads) {
        for (int u = te[b]; u < te[b + 1]; ++u) {
            s_band[u] = (unsigned char)b;
            s_toff[u] = (unsigned char)(u - te[b]);
        }
        s_allowed[b] = allowed[f * nb + b];
        s_over[b] = 0;
        s_ab[b] = 0;
    }
    for (int b = tid; b <= nb; b += kThreads) s_edge[b] = 4 * te[b];
    const int budget_f = budget[f];
    __syncthreads();

    // the regions: cut at the first band edge at or above 256 w
    for (int b = tid; b <= nb; b += kThreads) {
        const int e = s_edge[b], ep = b > 0 ? s_edge[b - 1] : -1;
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
            if (e >= kRegion * w && ep < kRegion * w) {
                s_cut[w] = e;
                s_bfirst[w] = b;
            }
        }
    }
    if (tid == 0) {
        s_cut[0] = 0;
        s_bfirst[0] = 0;
        s_cut[kWarps] = kCoeffs;
        s_bfirst[kWarps] = nb;
    }
    // band tid's facts and the real bands' count
    const bool has_band = tid < nb;
    const bool real_b = has_band && s_edge[tid + 1] > s_edge[tid];
    const int nreal = __syncthreads_count(real_b);
    int mw = 0;
    for (int b = s_bfirst[warp] + lane; b < s_bfirst[warp + 1]; b += 32) {
        const int wb = s_edge[b + 1] - s_edge[b];
        mw = wb > mw ? wb : mw;
    }
    mw = __reduce_max_sync(kFull, mw);
    if (lane == 0) s_maxw[warp] = mw;
    const LaneBands lb = lane_bands(s_band, lane);
    __syncwarp();

    // entry: amp = 0, the inner sweep's gain
    int gain = gain0[f], bits = bits0[f], win = 0;
    int amp_b = 0;                          // band tid's amp
    bool any = region_over<true>(warp, lane, gain, s_cut, s_bfirst, s_maxw,
                                 s_x, s_tamp, s_keep[0], s_p, s_toff, s_edge,
                                 s_allowed, s_over, s_consts, pow43);
    for (int it = 1; it < kOuterMax; ++it) {
        if (!__syncthreads_or(any)) break;
        // amp += AMP_STEP where over, capped: band tid's and each tuple's
        if (has_band) {
            const int a = amp_b + kAmpStep * s_over[tid];
            amp_b = a < kAmpMax ? a : kAmpMax;
            s_ab[tid] = (unsigned char)amp_b;
        }
        for (int u = tid; u < kTuples; u += kThreads) {
            const int a = s_tamp[u] + kAmpStep * s_over[s_band[u]];
            s_tamp[u] = (unsigned char)(a < kAmpMax ? a : kAmpMax);
        }
        __syncthreads();
        // scale-factor deltas: prev - amp + SF_DELTA_MAX over the real
        // bands (a zero-width band is never over, so its amp stays 0)
        const int prev = has_band && tid > 0 ? s_ab[tid - 1] : 0;
        const int sf = real_b ? s_lsf[prev - amp_b + kSfDeltaMax] : 0;
        const int sf_w = __reduce_add_sync(kFull, sf);
        if (lane == 0) s_red[warp] = sf_w;

        // refine: warp w evaluates candidate w of each block; after the
        // window, warp 0 alone the fallback (block kRefineBlocks)
        const int prev_gain = gain;
        int fixed = 0;
        bool found = false;
        for (int b = 0; !found; ++b) {
            const bool fallback = b == kRefineBlocks;
            if (!fallback || warp == 0) {
                const int cw = prev_gain + kWarps * b + warp;
                const int mine = k4_payload(
                    s_x, s_tamp, s_keep[warp], lb,
                    fallback || cw >= kGainMax ? kGainMax : cw, lane,
                    s_consts, s_small, s_em, s_sf);
                if (lane == 0) s_bits[b & 1][warp] = mine;
            }
            __syncthreads();
            if (b == 0) {
                fixed = kFixedBits + kCbBits * nreal;
#pragma unroll
                for (int w = 0; w < kWarps; ++w) fixed += s_red[w];
            }
            if (fallback) {                // no fit in the window
                gain = kGainMax;
                bits = s_bits[b & 1][0] + fixed;
                win = 0;
                found = true;
            }
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
                const int bw = s_bits[b & 1][w] + fixed;
                if (!found && bw <= budget_f) {
                    const int c = prev_gain + kWarps * b + w;
                    gain = c < kGainMax ? c : kGainMax;
                    bits = bw;
                    win = w;
                    found = true;
                }
            }
        }
        any = region_over<false>(warp, lane, gain, s_cut, s_bfirst, s_maxw,
                                 s_x, s_tamp, s_keep[win], s_p, s_toff,
                                 s_edge, s_allowed, s_over, s_consts, pow43);
    }

    __syncthreads();
    int4* qf = reinterpret_cast<int4*>(q_out + f * kCoeffs);
    for (int u = tid; u < kTuples; u += kThreads) {
        const float4 xv = s_x[swz(u)];
        const uint2 m = s_keep[win][kslot(u)];
        const int m0 = m.x & 0xFFFF, m1 = m.x >> 16;
        const int m2 = m.y & 0xFFFF, m3 = m.y >> 16;
        qf[u] = make_int4(xv.x < 0.0f ? -m0 : m0, xv.y < 0.0f ? -m1 : m1,
                          xv.z < 0.0f ? -m2 : m2, xv.w < 0.0f ? -m3 : m3);
    }
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
// i32, consts [15] f32, pow43 [4096] f32 -> q [F,1024] (16-byte aligned),
// amp [F,nb], gain [F], bits [F] i32. Returns cudaGetLastError() after the
// launch (0 = launched), cudaErrorInvalidValue for nb outside 1..128.
int mrc_rd_loop(const float* x, const float* allowed, const int* budget,
                const int* bt, const int* gain0, const int* bits0,
                const int* band_tuples, const int* len_small,
                const int* pair_em, const int* pair_sf, const int* len_sf,
                const float* consts, const float* pow43, int* q, int* amp,
                int* gain, int* bits, long long n_frames, int nb,
                void* stream) {
    if (nb < 1 || nb > kNbMax || n_frames < 1 || n_frames > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    rd_loop_kernel<<<(unsigned)n_frames, kThreads, 0,
                     (cudaStream_t)stream>>>(
        x, allowed, budget, bt, gain0, bits0, band_tuples, len_small,
        pair_em, pair_sf, len_sf, consts, pow43, q, amp, gain, bits, nb);
    return (int)cudaGetLastError();
}

// The blocks of K4 an SM holds at once on the current card (the occupancy
// calculator: registers and static shared memory), or -1 on an error.
int mrc_rd_loop_blocks_per_sm(void) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rd_loop_kernel,
                                                      kThreads, 0) !=
        cudaSuccess)
        return -1;
    return n;
}

}  // extern "C"
