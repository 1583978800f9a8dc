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
// the gain loop. The device functions of that warp routine live in
// quant_cost_warp.cuh (`warp_payload`), which K4 (rd_loop.cu) shares.
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

#include "quant_cost_warp.cuh"

namespace {

using namespace quant_warp;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

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
            const int q = lf * kTuples + swz(i);
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
        const int cost = warp_payload(s_x + lf * kTuples,
                                      s_amp + lf * kTuples, lb, gain, lane,
                                      P, magic, s_consts, s_small, s_em,
                                      s_sf);
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
