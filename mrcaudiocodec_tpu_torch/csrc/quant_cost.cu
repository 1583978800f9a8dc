// K2: the quantization-cost sweep of the rate-distortion loop.
//
// Replaces the Pallas TPU kernel `_quant_kernel` / `payload_bits_for_gains`
// of mrcaudiocodec_tpu/ops/pallas/quant_kernel.py. For each frame f and each
// gain candidate g it computes the exact Huffman payload bits
//
//   out[f, g] = sum over bands of min(valid codebook costs)
//
// of the frame quantized at per-bin exponent e = clip(gain - amp_bin, 0, 255):
//   * the rev-4 quantizer (spec/quantize.py): inv_step = inv_frac[d & 3] *
//     2^-(d >> 2) (d = e - 128), a = |x| * inv_step,
//     mag = min(floor(xsqrt(a * xsqrt(a)) + QUANT_MAGIC), QMAX),
//     xsqrt exactly as xpsy.xsqrt (bitcast exponent split, degree-5 start,
//     two Newton steps r*(1.5 - 0.5*(m*r)*r), s*scale; 0 below 2^-126).
//     Every f32 op is a single correctly-rounded __f*_rn op and the library
//     is built with --fmad=false: no FMA contraction, no flush to zero (no
//     sqrtf, rsqrtf, __fdividef or *_ftz intrinsic). x = -0.0 is not
//     negative (x < 0);
//   * per 4-tuple: the CB_SMALL 4-tuple length, the CB_MID pair lengths,
//     the CB_ESC pair lengths plus sign bits and escape bits 2e-3 for
//     mag >= 16, and flags for mag > 0, > 1, > 4 anywhere in the tuple;
//   * per band: the tuples' sums and flags; 0 if no mag > 0, else
//     min(small if no mag > 1, mid if no mag > 4, esc). Zero-width bands
//     hold no tuple and cost 0.
//
// The band map. Band edges are multiples of 4 bins, so no 4-tuple straddles
// a band, and each band is a range of whole tuples. The wrapper passes
// those ranges, tables.unified_layout(fs)["edges"] / 4 as [5, nb + 1]
// tuple edges, one row per block type (long-family types: the long bands
// then zero-width bands; SHORT: the 8 groups' bands in group-major order,
// coeff[g*128 + k]); the kernel expands the row of bt[f] into a tuple ->
// band map in shared memory. nb <= 128 (32 kHz: 96, 44.1 and 48 kHz: 88).
//
// Bound on this card: f32 ALU work, 54 f32 ops per bin per gain (two xsqrt
// of 24 ops each, 2 multiplies for the step and |x| * step, 1 multiply
// a*sqrt(a), add, floor, min). What sets the pace is the integer work
// beside them (xsqrt's exponent splits, clamps, table indices, the run
// bookkeeping): about 60 integer-class SASS instructions a bin against 56
// f32-class ones, and the card issues integer ops at half the f32 rate (64
// against 128 a clock per SM). chip_smoke.py prints the mix.
//
// Design: one warp per (frame, gain), no block barrier and no atomic in
// the gain loop.
//  * A block of 4 warps takes 1 frame when G >= 4, else 4 / G frames, so
//    that G = 1 and G = 4 fill the card too. It stages its frames' x and
//    amp_bin (8 KB a frame), the code tables and the tuple -> band map in
//    shared memory, then waits at its only barrier. x and amp_bin are
//    staged with tuple u at u ^ ((u >> 3) & 7), so that the lanes' float4
//    and int4 reads below are free of bank conflicts.
//  * Warp w takes tasks w, w + 4, ... of the block's frames x gains. Lane l
//    owns the 8 consecutive tuples 8l .. 8l+7 (32 bins). It quantizes them
//    in turn and sums the values of each run of tuples in one band in
//    registers: a run that ends inside the lane and began inside it is a
//    whole band, whose cost the lane adds to its total; the lane's first
//    run (its head) may have begun in an earlier lane and its last (its
//    tail) may go on in a later one.
//  * Per task, one segmented scan over the lanes joins the bands that span
//    lanes: an inclusive scan of the tails, five __shfl_up_sync rounds,
//    segments keyed by the tail's band. A lane's head then gets the scan of
//    the lane before it when that lane's tail is the same band; a tail that
//    does not go on into the next lane is a whole band. A band's cost is
//    added once, by the lane where it ends, and one warp sum
//    (__reduce_add_sync) gives out[f, g]. Integer sums are exact in any
//    order, so the result is bitwise.
//  * The lane's band facts (where its runs break, whether its head and tail
//    go on, the scan's segments) depend on the frame's block type only and
//    are set up once per frame.
//  * Fewer instructions a bin: the step is computed once per tuple when its
//    4 amp_bin agree (always on the codec's path, where amp_bin is a band
//    amp per bin; else per bin). Two lookups a pair in host-built pair
//    tables, indexed by the pair's signed magnitudes clamped to [-16, 16],
//    give the CB_ESC pair length with sign bits and the CB_MID length in
//    one word, and the CB_SMALL half-symbol with the flags; the escape
//    suffixes are added per bin. A run's sums are three words.
//  * The run bookkeeping and the band cost are selects, so lanes do not
//    diverge on them. The compiler predicates xsqrt's odd-exponent multiply
//    and branches around an xsqrt whose input is below 2^-126 (its result
//    is 0): a warp whose bins are all zero skips that work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCoeffs = 1024;
constexpr int kTuples = kCoeffs / 4;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kNbMax = 128;
constexpr int kConsts = 11;     // rsqrt poly [6], inv_frac [4], QUANT_MAGIC
constexpr int kPairs = 33 * 33;  // signed magnitude pairs clamped to [-16, 16]
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float inv_step_of(int gain, int ab,
                                             const float* s_consts) {
    int e = gain - ab;
    e = e < 0 ? 0 : (e > 255 ? 255 : e);
    const int d = e - 128;
    return __fmul_rn(s_consts[6 + (d & 3)],
                     __int_as_float((127 - (d >> 2)) << 23));
}

// one tuple's values: quantize its 4 bins (the step once when the tuple's
// amp_bin agree, as they do wherever amp_bin comes from band amps), then
// look each pair of signed magnitudes, clamped to [-16, 16], up in the pair
// tables: pair_em (CB_ESC pair length + sign bits | CB_MID length << 16)
// and pair_sf (CB_SMALL half-symbol | flags << 4); the escape suffixes of
// magnitudes >= 16 are added to esc
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
    int v[4], suffix = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float a = __fmul_rn(fabsf(xs[k]), inv[k]);
        const float p = xsqrt(__fmul_rn(a, xsqrt(a, P)), P);
        const int mag = (int)fminf(floorf(__fadd_rn(p, magic)), 4095.0f);
        const int m16 = mag < 16 ? mag : 16;
        v[k] = xs[k] < 0.0f ? 16 - m16 : 16 + m16;
        suffix += esc_bits(mag);
    }
    const int i01 = v[0] * 33 + v[1], i23 = v[2] * 33 + v[3];
    const unsigned sf01 = s_sf[i01], sf23 = s_sf[i23];
    return {s_small[(sf01 & 15u) * 9 + (sf23 & 15u)],
            s_em[i01] + s_em[i23] + suffix, (sf01 | sf23) >> 4};
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

__global__ void __launch_bounds__(kThreads)
quant_cost_kernel(const float* __restrict__ x,
                  const int* __restrict__ amp_bin,
                  const int* __restrict__ gains,
                  const int* __restrict__ bt,
                  const int* __restrict__ band_tuples,
                  const int* __restrict__ len_small,
                  const int* __restrict__ pair_em,
                  const int* __restrict__ pair_sf,
                  const float* __restrict__ consts,
                  int* __restrict__ out, long long n_frames, int n_gains,
                  int nb, int frames_per_block) {
    extern __shared__ float4 s_dyn[];
    float4* s_x = s_dyn;                                   // [fpb][256]
    int4* s_amp = reinterpret_cast<int4*>(s_dyn + frames_per_block * kTuples);
    unsigned char* s_band = reinterpret_cast<unsigned char*>(
        s_amp + frames_per_block * kTuples);               // [fpb][256]
    __shared__ int s_small[81];
    __shared__ int s_em[kPairs];
    __shared__ int s_sf[kPairs];
    __shared__ float s_consts[kConsts];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const long long f0 = (long long)blockIdx.x * frames_per_block;
    for (int i = tid; i < 81; i += kThreads) s_small[i] = len_small[i];
    for (int i = tid; i < kPairs; i += kThreads) {
        s_em[i] = pair_em[i];
        s_sf[i] = pair_sf[i];
    }
    if (tid < kConsts) s_consts[tid] = consts[tid];
    for (int lf = 0; lf < frames_per_block && f0 + lf < n_frames; ++lf) {
        const long long f = f0 + lf;
        const float4* xf = reinterpret_cast<const float4*>(x + f * kCoeffs);
        const int4* af = reinterpret_cast<const int4*>(amp_bin + f * kCoeffs);
        for (int i = tid; i < kTuples; i += kThreads) {
            const int q = lf * kTuples + (i ^ ((i >> 3) & 7));
            s_x[q] = xf[i];
            s_amp[q] = af[i];
        }
        const int* edges = band_tuples + bt[f] * (nb + 1);
        for (int b = tid; b < nb; b += kThreads)
            for (int u = edges[b]; u < edges[b + 1]; ++u)
                s_band[lf * kTuples + u] = (unsigned char)b;
    }
    __syncthreads();

    float P[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) P[i] = s_consts[i];
    const float magic = s_consts[10];
    const Sums zero = {0, 0, 0u};

    // this warp's tasks w, w + 4, ... as (frame lf, gain g), no division
    int lf = 0, g = tid >> 5;
    while (g >= n_gains) {
        g -= n_gains;
        ++lf;
    }
    int have = -1;
    LaneBands lb;
    while (lf < frames_per_block && f0 + lf < n_frames) {
        const long long f = f0 + lf;
        if (lf != have) {
            lb = lane_bands(s_band + lf * kTuples, lane);
            have = lf;
        }
        const int gain = gains[f * n_gains + g];
        const float4* xs = s_x + lf * kTuples + 8 * lane;
        const int4* as = s_amp + lf * kTuples + 8 * lane;
        Sums run = zero, head = zero;
        bool first = true;
        int cost = 0;
#pragma unroll
        for (int s = 0; s < 8; ++s) {
            const int q = s ^ (lane & 7);
            run = run + tuple_values(xs[q], as[q], gain, P, magic, s_consts,
                                     s_small, s_em, s_sf);
            if (s < 7) {
                // a run that ends here is the head if it is the lane's
                // first, else a whole band
                const bool end = (lb.brk >> (s + 1)) & 1u;
                cost += end && !first ? band_cost(run) : 0;
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
        cost += first ? 0 : band_cost(head + pick(lb.cont_in, before, zero));
        cost += lb.cont_out ? 0 : band_cost(run);
        cost = __reduce_add_sync(kFull, cost);
        if (lane == 0) out[f * n_gains + g] = cost;
        g += kWarps;
        while (g >= n_gains) {
            g -= n_gains;
            ++lf;
        }
    }
}

}  // namespace

extern "C" {

// x [F,1024] f32, amp_bin [F,1024] i32 (both 16-byte aligned), gains [F,G]
// i32, bt [F] i32, band_tuples [5, nb+1] i32 (tuple edges of each block
// type's bands), len_small [81], pair_em [33*33], pair_sf [33*33] i32,
// consts [11] f32 -> out [F,G] i32. Returns cudaGetLastError() after the
// launch (0 = launched), cudaErrorInvalidValue for nb > 128.
int mrc_quant_cost(const float* x, const int* amp_bin, const int* gains,
                   const int* bt, const int* band_tuples,
                   const int* len_small, const int* pair_em,
                   const int* pair_sf, const float* consts, int* out,
                   long long n_frames, int n_gains, int nb, void* stream) {
    if (nb > kNbMax || n_gains < 1) return (int)cudaErrorInvalidValue;
    const int fpb = n_gains >= kWarps ? 1 : kWarps / n_gains;
    const long long blocks = (n_frames + fpb - 1) / fpb;
    const size_t smem = (size_t)fpb * kTuples * (sizeof(float4) + sizeof(int4) + 1);
    quant_cost_kernel<<<(unsigned)blocks, kThreads, smem,
                        (cudaStream_t)stream>>>(
        x, amp_bin, gains, bt, band_tuples, len_small, pair_em, pair_sf,
        consts, out, n_frames, n_gains, nb, fpb);
    return (int)cudaGetLastError();
}

}  // extern "C"
