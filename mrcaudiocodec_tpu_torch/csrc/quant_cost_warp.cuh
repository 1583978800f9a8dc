// K2's warp routine: one warp computes the exact Huffman payload of one
// frame quantized at one gain. Shared by K2 (quant_cost.cu, a warp per
// (frame, gain) task) and K4 (rd_loop.cu, a warp per refine candidate);
// its tuple lookup and band walk also by K13 (codebook_choice.cu, a warp
// a frame); quant_cost.cu's note describes the design. Everything here is inlined
// into the kernel that includes it: each .cu is its own library.
//
// Every f32 op is a single correctly-rounded __f*_rn op and the libraries
// are built with --fmad=false: no FMA contraction, no flush to zero.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace quant_warp {

constexpr int kCoeffs = 1024;
constexpr int kTuples = kCoeffs / 4;
constexpr int kNbMax = 128;
constexpr int kConsts = 11;     // rsqrt poly [6], inv_frac [4], QUANT_MAGIC
constexpr int kPairs = 33 * 33;  // signed magnitude pairs clamped to [-16, 16]
constexpr int kQmax = 4095;
constexpr unsigned kFull = 0xffffffffu;

// x and amp_bin are staged with tuple u at swz(u), so that a lane's float4
// and int4 reads of its 8 tuples are free of bank conflicts
__device__ __forceinline__ int swz(int u) { return u ^ ((u >> 3) & 7); }

// xpsy.xsqrt's f32 ops in its order; its integer exponent split (eb =
// E - 127, odd = eb & 1, scale bits (((eb - odd) >> 1) + 127) << 23) is
// written for x >= 2^-126, where E = bits >> 23 and (E + 127 - odd) is even;
// below that the select returns 0 whatever the split gave.
__device__ __forceinline__ float xsqrt(float x, const float* P) {
    const int bits = __float_as_int(x);
    const int E = bits >> 23;
    const int odd = (E & 1) ^ 1;                                  // eb odd
    const float m1 = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
    const float m2 = __fmul_rn(m1, 2.0f);
    const float m = odd ? m2 : m1;                                // [1, 4)
    float r = __fadd_rn(__fmul_rn(P[5], m), P[4]);
    r = __fadd_rn(__fmul_rn(r, m), P[3]);
    r = __fadd_rn(__fmul_rn(r, m), P[2]);
    r = __fadd_rn(__fmul_rn(r, m), P[1]);
    r = __fadd_rn(__fmul_rn(r, m), P[0]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const float mr = __fmul_rn(m, r);
        const float h = __fmul_rn(mr, r);
        const float w = __fsub_rn(1.5f, __fmul_rn(0.5f, h));
        r = __fmul_rn(r, w);
    }
    const float s = __fmul_rn(m, r);
    const float scale = __int_as_float((E + 127 - odd) << 22);    // 2^(eb/2)
    return x < __int_as_float(0x00800000) ? 0.0f : __fmul_rn(s, scale);
}

__device__ __forceinline__ int esc_bits(int mag) {
    const int e = 31 - __clz(mag);          // floor(log2(mag)), mag <= 4095
    return mag < 16 ? 0 : 2 * e - 3;
}

// a run of tuples' code lengths: CB_SMALL, and CB_ESC | CB_MID << 16 in
// one word (a band's esc sum is at most 126 pairs x 60 bits < 2^16, its mid
// sum at most 126 x 12), and its flags (bit 0: a mag > 0, bit 1: a mag > 1,
// bit 2: a mag > 4)
struct Sums {
    int small, em;
    unsigned flags;
};

// a band's payload from its sums
__device__ __forceinline__ int band_cost(const Sums& s) {
    const int esc = s.em & 0xFFFF, mid = s.em >> 16;
    int cost = esc;
    cost = !(s.flags & 4u) && mid < cost ? mid : cost;
    cost = !(s.flags & 2u) && s.small < cost ? s.small : cost;
    return s.flags & 1u ? cost : 0;
}

__device__ __forceinline__ Sums operator+(const Sums& a, const Sums& b) {
    return {a.small + b.small, a.em + b.em, a.flags | b.flags};
}

__device__ __forceinline__ Sums pick(bool c, const Sums& a, const Sums& b) {
    return {c ? a.small : b.small, c ? a.em : b.em, c ? a.flags : b.flags};
}

__device__ __forceinline__ Sums shfl_up(const Sums& s, int d) {
    return {__shfl_up_sync(kFull, s.small, d), __shfl_up_sync(kFull, s.em, d),
            __shfl_up_sync(kFull, s.flags, d)};
}

// the per-bin exponent clip(gain - amp_bin, 0, 255)
__device__ __forceinline__ int exponent_of(int gain, int ab) {
    const int e = gain - ab;
    return e < 0 ? 0 : (e > 255 ? 255 : e);
}

// 1 / step = inv_frac[d & 3] * 2^-(d >> 2), d = e - 128
__device__ __forceinline__ float inv_step(int e, const float* s_consts) {
    const int d = e - 128;
    return __fmul_rn(s_consts[6 + (d & 3)],
                     __int_as_float((127 - (d >> 2)) << 23));
}

__device__ __forceinline__ float inv_step_of(int gain, int ab,
                                             const float* s_consts) {
    return inv_step(exponent_of(gain, ab), s_consts);
}

// the quantized magnitude min(floor(xsqrt(a * xsqrt(a)) + magic), QMAX) of
// a = |x| * inv; x = -0.0 is not negative (x < 0)
__device__ __forceinline__ int quant_mag(float x, float inv, const float* P,
                                         float magic) {
    const float a = __fmul_rn(fabsf(x), inv);
    const float p = xsqrt(__fmul_rn(a, xsqrt(a, P)), P);
    return (int)fminf(floorf(__fadd_rn(p, magic)), (float)kQmax);
}

// one tuple's sums from its 4 magnitudes and signs: each pair of signed
// magnitudes, clamped to [-16, 16], looked up in the pair tables pair_em
// (CB_ESC pair length + sign bits | CB_MID length << 16) and pair_sf
// (CB_SMALL half-symbol | flags << 4); the escape suffixes of magnitudes
// >= 16 are added to esc. Shared by K2, K4 and K13 (codebook_choice.cu).
__device__ __forceinline__ Sums tuple_sums(const int mag[4],
                                           const bool neg[4],
                                           const int* s_small,
                                           const int* s_em,
                                           const int* s_sf) {
    int v[4], suffix = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int m16 = mag[k] < 16 ? mag[k] : 16;
        v[k] = neg[k] ? 16 - m16 : 16 + m16;
        suffix += esc_bits(mag[k]);
    }
    const int i01 = v[0] * 33 + v[1], i23 = v[2] * 33 + v[3];
    const unsigned sf01 = s_sf[i01], sf23 = s_sf[i23];
    return {s_small[(sf01 & 15u) * 9 + (sf23 & 15u)],
            s_em[i01] + s_em[i23] + suffix, (sf01 | sf23) >> 4};
}

// one tuple's values: quantize its 4 bins (the step once when the tuple's
// amp_bin agree, as they do wherever amp_bin comes from band amps), then
// its sums (tuple_sums)
__device__ __forceinline__ Sums tuple_values(float4 xv, int4 av, int gain,
                                             const float* P, float magic,
                                             const float* s_consts,
                                             const int* s_small,
                                             const int* s_em,
                                             const int* s_sf) {
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
    const int ab[4] = {av.x, av.y, av.z, av.w};
    float inv[4];
    if (av.x == av.y && av.x == av.z && av.x == av.w) {
        inv[0] = inv[1] = inv[2] = inv[3] = inv_step_of(gain, av.x, s_consts);
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) inv[k] = inv_step_of(gain, ab[k], s_consts);
    }
    int mag[4];
    bool neg[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        mag[k] = quant_mag(xs[k], inv[k], P, magic);
        neg[k] = xs[k] < 0.0f;
    }
    return tuple_sums(mag, neg, s_small, s_em, s_sf);
}

// the facts of lane l's tuples 8l .. 8l+7 in one frame's tuple -> band map
struct LaneBands {
    unsigned brk;       // bit s (1..7): tuple 8l + s begins a new band
    unsigned seg;       // bit r: lane l - 2^r ends in the same band as lane l
    bool cont_in;       // the head's band began in an earlier lane
    bool cont_out;      // the tail's band goes on in a later lane
};

__device__ __forceinline__ LaneBands lane_bands(const unsigned char* band,
                                                int lane) {
    const unsigned char* mine = band + 8 * lane;
    LaneBands lb = {0, 0, false, false};
#pragma unroll
    for (int s = 1; s < 8; ++s)
        lb.brk |= (unsigned)(mine[s] != mine[s - 1]) << s;
    const int head = mine[0], tail = mine[7];
    lb.cont_in = lane > 0 && band[lane > 0 ? 8 * lane - 1 : 0] == head;
    lb.cont_out = lane < 31 && band[lane < 31 ? 8 * lane + 8 : 0] == tail;
#pragma unroll
    for (int r = 0; r < 5; ++r) {
        const int other = __shfl_up_sync(kFull, tail, 1 << r);
        lb.seg |= (unsigned)(lane >= (1 << r) && other == tail) << r;
    }
    return lb;
}

// The band walk of one frame, warp-wide, lb the lane's band facts: lane l
// sums its tuples 8l .. 8l+7 in turn (tuple(s), s = 0 .. 7, gives the
// sums of tuple 8l + s) by runs of one band in registers; a run that ends
// inside the lane and began inside it is a whole band. One segmented scan
// over the lanes joins the bands that span lanes. Each band's sums reach
// band_end(on, s, sums) once, with on set, in the lane where the band
// ends, s the lane's tuple in that band; the calls with on clear are to
// be ignored (they keep the walk free of branches). K2 and K4 add the
// band's cost, K13 writes its codebook choice.
template <class Tuple, class BandEnd>
__device__ __forceinline__ void walk_bands(const LaneBands& lb, Tuple tuple,
                                           BandEnd band_end) {
    const Sums zero = {0, 0, 0u};
    Sums run = zero, head = zero;
    bool first = true;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
        run = run + tuple(s);
        if (s < 7) {
            // a run that ends here is the head if it is the lane's
            // first, else a whole band
            const bool end = (lb.brk >> (s + 1)) & 1u;
            band_end(end && !first, s, run);
            head = pick(end && first, run, head);
            first = first && !end;
            run = pick(end, zero, run);
        }
    }
    // run is the tail: the inclusive segmented scan joins the lanes of
    // a band that spans lanes
#pragma unroll
    for (int r = 0; r < 5; ++r)
        run = pick((lb.seg >> r) & 1u, run + shfl_up(run, 1 << r), run);
    const Sums before = shfl_up(run, 1);
    band_end(!first, 0, head + pick(lb.cont_in, before, zero));
    band_end(!lb.cont_out, 7, run);
}

// The payload of one frame at one gain, warp-wide: s_x / s_amp are the
// frame's swizzled x and amp_bin, lb the lane's band facts. Lane l
// quantizes its 8 tuples in turn, walk_bands sums them by band, and a
// band's cost is added once, by the lane where it ends. Every lane gets
// the warp's sum (integer: exact in any order).
__device__ __forceinline__ int warp_payload(const float4* s_x,
                                            const int4* s_amp,
                                            const LaneBands& lb, int gain,
                                            int lane, const float* P,
                                            float magic,
                                            const float* s_consts,
                                            const int* s_small,
                                            const int* s_em,
                                            const int* s_sf) {
    const float4* xs = s_x + 8 * lane;
    const int4* as = s_amp + 8 * lane;
    int cost = 0;
    walk_bands(
        lb,
        [&](int s) {
            const int q = s ^ (lane & 7);
            return tuple_values(xs[q], as[q], gain, P, magic, s_consts,
                                s_small, s_em, s_sf);
        },
        [&](bool on, int, const Sums& sums) {
            cost += on ? band_cost(sums) : 0;
        });
    return __reduce_add_sync(kFull, cost);
}

}  // namespace quant_warp
