// K13: the decide layer's tail, the per-band codebook choice and the
// decisions' narrow types, in one launch a chunk.
//
// Replaces no Pallas kernel: the JAX package's choice is
// mrcaudiocodec_tpu/ops/entropy.py:199 `payload_costs_and_choice`, whose
// bf16 mask matmuls XLA runs. The port ran it as ~65 torch launches of
// gathers, band sums (scatter_add_) and selects over [F, 256] and [F, 512]
// (ops/entropy.payload_costs_and_choice), then five casts; that is now the
// CPU path and this kernel's plain version
// (ops/kernels/codebook_choice.codebook_choice_plain).
//
// Input: K4's q [F, 1024], amp [F, NB], gain [F] and the block types bt
// [F], all int32 (|q| <= QMAX, bt in 0..4); the band map of each block
// type [5, 256] uint8 (the band of each 4-tuple; SHORT in group-major
// order), K2's code tables. Output, bit for bit what the casts give:
//   q16 [F, 1024] int16, amp8 [F, NB] int8, gain16 [F] int16, bt8 [F] int8,
//   cb8 [F, NB] int8: for each band of width > 0 the FIRST cheapest of the
//     codebooks valid for it, in the spec's order: 0 all zero, 1 CB_SMALL
//     (every |q| <= 1), 2 CB_MID (every |q| <= 4), 3 CB_ESC (always);
//     0 for a band of width 0.
// A band's costs are those of K2's warp routine (quant_cost_warp.cuh), whose
// tuple lookup (tuple_sums) and band walk (walk_bands) this kernel calls:
// the CB_SMALL 4-tuple lengths, CB_ESC pair lengths with sign bits and
// escape suffixes | CB_MID pair lengths << 16 in one word, and the flags of
// a magnitude > 0, > 1, > 4, all from the same pair tables.
//
// Bound on this card: HBM bytes. Each frame reads 4096 B of q, 4 NB of amp
// and 8 of gain and bt, and writes 2048 B of q16, 2 NB of amp8 and cb8 and
// 3 of gain16 and bt8: 6,683 B at NB = 88, so 5.2 us at the 30 s clip's
// 2,586 frame rows and 16.3 us at the batch's 8,192, at 3.35 TB/s. The
// integer work is ~16 instructions a bin, far under the HBM time at the
// card's integer rate. So the design reads q once, in 16-byte loads, and
// does everything else in registers and shared memory:
//  * a warp takes a frame (a block of 8 warps shares the code tables and
//    the band maps in shared memory, loaded once a block; the warps walk
//    the frames with a stride of the grid's warps, so any F is covered);
//  * lane l owns the 8 consecutive tuples 8l .. 8l+7 (bins 32l .. 32l+31,
//    128 bytes): 8 int4 loads, all issued before any is used, and the
//    int16 copy written back as 4 int4 stores;
//  * walk_bands sums each run of the lane's tuples in one band in
//    registers and joins the bands that span lanes by one segmented scan
//    (five __shfl_up_sync rounds of three words); the lane where a band
//    ends writes its choice into the warp's row of shared memory, which
//    was zeroed first (so bands of width 0 read 0), and the warp writes
//    the row out with amp8 beside it;
//  * integer arithmetic only, sums exact in any order; no atomic, no
//    block barrier after the tables' one, no host sync. No float
//    instruction, so no FFMA and no .FTZ.
// On an H100 SXM at 700 W (80 registers, 3 blocks an SM) it takes 0.0105
// ms at 2,586 frame rows and 0.0324 at 8,192 (the profiler's device time),
// 2.0x the bound at both. A grid of the resident blocks (132 SMs x 3)
// walking the frames, so that each block loads the ~11 KB of tables once,
// was only 0.7% and 1.4% faster, and twice that grid no faster: the
// tables' reloads are not what holds it, so the grid stays a block per 8
// frames. Against the ~0.48 and ~1.38 ms of the torch code it replaced,
// the rest is left.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_cost_warp.cuh"

namespace {

using namespace quant_warp;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTypes = 5;
constexpr int kMaxBlocks = 1 << 16;

// the first cheapest valid codebook of a band from its sums: the spec's
// argmin over (0, small, mid, esc), invalid ones left out; taken from the
// last to the first with <=, so a tie goes to the earlier codebook
__device__ __forceinline__ int choice(const Sums& s) {
    const int esc = s.em & 0xFFFF, mid = s.em >> 16;
    int cb = 3, cost = esc;
    if (!(s.flags & 4u) && mid <= cost) {
        cb = 2;
        cost = mid;
    }
    if (!(s.flags & 2u) && s.small <= cost) cb = 1;
    return s.flags & 1u ? cb : 0;
}

// one tuple's sums from its 4 values of q (tuple_sums)
__device__ __forceinline__ Sums q_sums(int4 v, const int* s_small,
                                       const int* s_em, const int* s_sf) {
    const int qs[4] = {v.x, v.y, v.z, v.w};
    int mag[4];
    bool neg[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        mag[k] = qs[k] < 0 ? -qs[k] : qs[k];
        neg[k] = qs[k] < 0;
    }
    return tuple_sums(mag, neg, s_small, s_em, s_sf);
}

__device__ __forceinline__ int pack16(int a, int b) {
    return (int)(((unsigned)a & 0xFFFFu) | ((unsigned)b << 16));
}

__global__ void __launch_bounds__(kThreads)
codebook_choice_kernel(const int* __restrict__ q,
                       const int* __restrict__ amp,
                       const int* __restrict__ gain,
                       const int* __restrict__ bt,
                       const unsigned* __restrict__ band_map,
                       const int* __restrict__ len_small,
                       const int* __restrict__ pair_em,
                       const int* __restrict__ pair_sf,
                       int16_t* __restrict__ q16, int8_t* __restrict__ amp8,
                       int16_t* __restrict__ gain16,
                       int8_t* __restrict__ bt8, int8_t* __restrict__ cb8,
                       long long n_frames, int nb) {
    __shared__ int s_small[81];
    __shared__ int s_em[kPairs];
    __shared__ int s_sf[kPairs];
    __shared__ unsigned s_map[kTypes * kTuples / 4];
    __shared__ int8_t s_cb[kWarps][kNbMax];

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    for (int i = tid; i < 81; i += kThreads) s_small[i] = len_small[i];
    for (int i = tid; i < kPairs; i += kThreads) {
        s_em[i] = pair_em[i];
        s_sf[i] = pair_sf[i];
    }
    for (int i = tid; i < kTypes * kTuples / 4; i += kThreads)
        s_map[i] = band_map[i];
    __syncthreads();
    const unsigned char* bands = reinterpret_cast<const unsigned char*>(s_map);
    int8_t* row = s_cb[warp];

    const long long stride = (long long)gridDim.x * kWarps;
    for (long long f = (long long)blockIdx.x * kWarps + warp; f < n_frames;
         f += stride) {
        const int4* qf = reinterpret_cast<const int4*>(q + f * kCoeffs)
                         + 8 * lane;
        int4 v[8];
#pragma unroll
        for (int s = 0; s < 8; ++s) v[s] = qf[s];
        const int t = bt[f];
        const unsigned char* band = bands + t * kTuples + 8 * lane;
        const LaneBands lb = lane_bands(bands + t * kTuples, lane);
        for (int b = lane; b < nb; b += 32) row[b] = 0;
        __syncwarp();

        int4* of = reinterpret_cast<int4*>(q16 + f * kCoeffs) + 4 * lane;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int4 a = v[2 * k], b = v[2 * k + 1];
            of[k] = make_int4(pack16(a.x, a.y), pack16(a.z, a.w),
                              pack16(b.x, b.y), pack16(b.z, b.w));
        }
        walk_bands(
            lb, [&](int s) { return q_sums(v[s], s_small, s_em, s_sf); },
            [&](bool on, int s, const Sums& sums) {
                if (on) row[band[s]] = choice(sums);
            });
        __syncwarp();

        const long long o = f * nb;
        for (int b = lane; b < nb; b += 32) {
            cb8[o + b] = row[b];
            amp8[o + b] = (int8_t)amp[o + b];
        }
        if (lane == 0) {
            gain16[f] = (int16_t)gain[f];
            bt8[f] = (int8_t)t;
        }
        __syncwarp();       // the row is read before the next frame zeroes it
    }
}

}  // namespace

extern "C" {

// q [F, 1024] i32 (16-byte aligned), amp [F, nb], gain [F], bt [F] i32,
// band_map [5, 256] u8 (4-byte aligned), len_small [81], pair_em and
// pair_sf [33 * 33] i32 -> q16 [F, 1024] i16 (16-byte aligned), amp8 [F, nb]
// i8, gain16 [F] i16, bt8 [F] i8, cb8 [F, nb] i8. Returns
// cudaGetLastError() after the launch (0 = launched),
// cudaErrorInvalidValue for nb outside 1 .. 128 or F < 1.
int mrc_codebook_choice(const int* q, const int* amp, const int* gain,
                        const int* bt, const void* band_map,
                        const int* len_small, const int* pair_em,
                        const int* pair_sf, void* q16, void* amp8,
                        void* gain16, void* bt8, void* cb8,
                        long long n_frames, int nb, void* stream) {
    if (nb < 1 || nb > kNbMax || n_frames < 1)
        return (int)cudaErrorInvalidValue;
    long long blocks = (n_frames + kWarps - 1) / kWarps;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    codebook_choice_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
        q, amp, gain, bt, static_cast<const unsigned*>(band_map), len_small,
        pair_em, pair_sf, static_cast<int16_t*>(q16),
        static_cast<int8_t*>(amp8), static_cast<int16_t*>(gain16),
        static_cast<int8_t*>(bt8), static_cast<int8_t*>(cb8), n_frames, nb);
    return (int)cudaGetLastError();
}

}  // extern "C"
