// K5: transient detection and block types straight from the hop rows.
//
// Replaces the framing, transient detection and block-type selection of
// the JAX encoder's analysis program, jit A
// (mrcaudiocodec_tpu/models/encoder.py:65-120, `_analyze_chunk`: the
// framing :93-104, dsp.detect_transients :105 -> xpsy.transient_detect,
// `_block_types_dev` :51), which the JAX package leaves to XLA; it has no
// Pallas counterpart. The port's plain version is
// ops/kernels/transients.transients_plain: the eager framing,
// xpsy.transient_detect and dsp.block_types.
//
// Input: R rows of (s + 3) hops (HOP = 1024 samples, int16 or f32, row
// stride given), covering frames f0 - 1 .. f0 + s + 1 of the clip; the
// extended frame j (0 .. s + 1) of a row is its samples [j * HOP,
// j * HOP + 2048). Output: bt [R, s] int32, bt[f] from the flags of the
// extended frames f, f + 1, f + 2 (the true neighbours).
//
// Per extended frame, the ops of xpsy.transient_detect, each a single
// correctly-rounded f32 op (__f*_rn, --fmad=false):
//   x = int16 * 2^-15 (exact) or the f32 sample
//   d[k] = x[k] - x[k-1], d[0] = 0
//   e[g] = the segmented scan's value at the end of sub-block g (16 of
//          128 bins) over d * d. The sub-blocks are aligned powers of two,
//          so that value is the pairwise tree of aligned halves:
//          (q1 + q0) + (q3 + q2) within a lane's 4 bins, then 5 rounds of
//          shuffle-xor adds (a + b == b + a in IEEE, so the order inside
//          a pair does not matter). tests/test_torch_analysis.py holds a
//          numpy model of this order against seg_sums.
//   csum: the 1-2-4-8 Hillis-Steele ladder, csum[j] + (j >= s ? csum[j-s]
//          : 0) (the zero is added, as torch's concat of zeros does)
//   attack = any over j < 15 of e[j+1] > (csum[j] + EPS*(j+1)) * (1/(j+1))
//            * ATTACK_RATIO and e[j+1] > ATTACK_ABS
// then dsp.block_types: SHORT where the frame attacks, else STARTSTOP /
// STOP / START / LONG by the left and right neighbours; all LONG (0)
// without window switching (then no flag is computed).
//
// Bound on this card: HBM bytes, the rows read once (2 B or 4 B a
// sample) and bt written; about 3 f32 ops a sample, far below the byte
// time. Design: one warp an extended frame; a block of T + 2 warps
// computes the flags of T + 2 consecutive extended frames into shared
// memory and writes the block types of the T frames they surround
// (neighbour flags recomputed at tile edges: 2 a tile, reread from L2).
// T comes from the wrapper (transients.tile_outputs): a tile of at most
// 14 block types, and at least two blocks an SM over the chunk, so the
// 30 s chunk's 2 rows spread over the whole card and the batch's 64
// frames a row split into tiles of 13 and 12 (no warp of a full tile
// idle). A lane reads 4 consecutive samples of each of the 16 sub-blocks
// (coalesced; one 8 or 16 B load each where the rows are aligned), all 64
// before any reduction; the sample before a lane's 4 comes from the lane
// below (from lane 31 of the sub-block before, for lane 0).

#include <cuda_runtime.h>
#include <stdint.h>

#include "xpsy_dev.cuh"

namespace {

constexpr int kHop = 1024;
constexpr int kMaxWarps = 16;                 // T <= 14
constexpr unsigned kAll = 0xffffffffu;
// config.py's block types
constexpr int kLong = 0, kStart = 1, kShort = 2, kStop = 3, kStartStop = 4;

__device__ __forceinline__ float sample(int16_t v) {
    return __fmul_rn(xpsy::exact_float(v), 3.0517578125e-05f);   // 2^-15
}

// lane's 4 samples of each sub-block g: x[g][c] = sample g * 128 + 4 lane + c
__device__ __forceinline__ void load4(const int16_t* p, bool vec,
                                      float (&x)[16][4]) {
    if (vec) {
#pragma unroll
        for (int g = 0; g < 16; ++g) {
            const int2 v = __ldg(reinterpret_cast<const int2*>(p + g * 128) +
                                 (threadIdx.x & 31));
            x[g][0] = sample((int16_t)(v.x & 0xffff));
            x[g][1] = sample((int16_t)(v.x >> 16));
            x[g][2] = sample((int16_t)(v.y & 0xffff));
            x[g][3] = sample((int16_t)(v.y >> 16));
        }
    } else {
#pragma unroll
        for (int g = 0; g < 16; ++g)
#pragma unroll
            for (int c = 0; c < 4; ++c)
                x[g][c] = sample(p[g * 128 + 4 * (threadIdx.x & 31) + c]);
    }
}
__device__ __forceinline__ void load4(const float* p, bool vec,
                                      float (&x)[16][4]) {
    if (vec) {
#pragma unroll
        for (int g = 0; g < 16; ++g) {
            const float4 v = __ldg(
                reinterpret_cast<const float4*>(p + g * 128) + (threadIdx.x & 31));
            x[g][0] = v.x;
            x[g][1] = v.y;
            x[g][2] = v.z;
            x[g][3] = v.w;
        }
    } else {
#pragma unroll
        for (int g = 0; g < 16; ++g)
#pragma unroll
            for (int c = 0; c < 4; ++c)
                x[g][c] = __ldg(p + g * 128 + 4 * (threadIdx.x & 31) + c);
    }
}

// The attack flag of the 2048 samples at `p` (one warp, every lane gets it)
template <typename T>
__device__ __forceinline__ bool attack(const T* p, bool vec, int lane,
                                      const xpsy::Consts& c) {
    float x[16][4];
    load4(p, vec, x);
    float e[16];
#pragma unroll
    for (int g = 0; g < 16; ++g) {
        // the sample before this lane's 4: lane - 1's last, for lane 0 lane
        // 31's last of the sub-block before (none before the frame's first)
        const float below = __shfl_up_sync(kAll, x[g][3], 1);
        const float wrap = __shfl_sync(kAll, x[g > 0 ? g - 1 : 0][3], 31);
        const float xm = lane > 0 ? below : wrap;
        const float d0 = (g == 0 && lane == 0) ? 0.0f : __fsub_rn(x[g][0], xm);
        const float d1 = __fsub_rn(x[g][1], x[g][0]);
        const float d2 = __fsub_rn(x[g][2], x[g][1]);
        const float d3 = __fsub_rn(x[g][3], x[g][2]);
        e[g] = __fadd_rn(__fadd_rn(__fmul_rn(d1, d1), __fmul_rn(d0, d0)),
                         __fadd_rn(__fmul_rn(d3, d3), __fmul_rn(d2, d2)));
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
#pragma unroll
        for (int g = 0; g < 16; ++g)
            e[g] = __fadd_rn(e[g], __shfl_xor_sync(kAll, e[g], o));
    float cs[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) cs[j] = e[j];
#pragma unroll
    for (int step = 1; step < 16; step <<= 1) {
        float nx[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
            nx[j] = __fadd_rn(cs[j], j >= step ? cs[j - step] : 0.0f);
#pragma unroll
        for (int j = 0; j < 16; ++j) cs[j] = nx[j];
    }
    bool any = false;
#pragma unroll
    for (int j = 0; j < 15; ++j) {
        const float pm = __fmul_rn(__fadd_rn(cs[j], c.eps_i[j]), c.inv_i[j]);
        const float thr = __fmul_rn(pm, c.attack_ratio);
        any |= (e[j + 1] > thr) & (e[j + 1] > c.attack_abs);
    }
    return any;
}

// block (x, r): row r's extended frames x T .. x T + T + 1, a warp each,
// and the block types of its frames x T .. x T + T - 1
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
transients_kernel(const T* __restrict__ audio, long long row_stride, int s,
                  int tile, int vec, int window_switching, xpsy::Consts c,
                  int* __restrict__ bt) {
    __shared__ int s_flag[kMaxWarps];
    const int r = blockIdx.y;
    const int f0 = blockIdx.x * tile;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const T* row = audio + (long long)r * row_stride;
    if (window_switching) {
        const int fe = f0 + warp;
        if (fe < s + 2) {
            const bool a = attack(row + (long long)fe * kHop, vec != 0, lane,
                                  c);
            if (lane == 0) s_flag[warp] = a;
        }
        __syncthreads();
    }
    const int t = threadIdx.x;
    const int f = f0 + t;
    if (t < tile && f < s) {
        int v = kLong;
        if (window_switching) {
            const bool ls = s_flag[t], tr = s_flag[t + 1],
                       rs = s_flag[t + 2];
            v = tr ? kShort
                   : (ls && rs ? kStartStop
                               : (ls ? kStop : (rs ? kStart : kLong)));
        }
        bt[(long long)r * s + f] = v;
    }
}

}  // namespace

extern "C" {

// audio [R, row_stride] (int16 if is_int16, else f32), each row holding
// (s + 3) * 1024 samples from its start; tile the block types a block
// writes (1 .. 14; transients.tile_outputs); consts [66] f32 on the host
// (xpsy.kernel_consts()) -> bt [R, s] int32. Returns cudaGetLastError()
// after the launch (0 = launched), cudaErrorInvalidValue for bad sizes.
int mrc_transients(const void* audio, int is_int16, long long row_stride,
                   int rows, int s, int tile, int window_switching,
                   const float* consts, int* bt, void* stream) {
    if (rows < 1 || rows > 65535 || s < 1 || tile < 1
        || tile > kMaxWarps - 2 || row_stride < (long long)(s + 3) * kHop)
        return (int)cudaErrorInvalidValue;
    xpsy::Consts c;
    const float* src = consts;
    float* dst = reinterpret_cast<float*>(&c);
    for (int i = 0; i < xpsy::kConsts; ++i) dst[i] = src[i];
    // one load a lane's 4 samples where every row starts on its width
    const long long size = is_int16 ? 2 : 4;
    const int vec = (reinterpret_cast<uintptr_t>(audio) % (4 * size) == 0)
                    && ((row_stride * size) % (4 * size) == 0);
    const dim3 grid((unsigned)((s + tile - 1) / tile), (unsigned)rows);
    const unsigned threads = 32u * (unsigned)(tile + 2);
    if (is_int16)
        transients_kernel<int16_t><<<grid, threads, 0, (cudaStream_t)stream>>>(
            static_cast<const int16_t*>(audio), row_stride, s, tile, vec,
            window_switching, c, bt);
    else
        transients_kernel<float><<<grid, threads, 0, (cudaStream_t)stream>>>(
            static_cast<const float*>(audio), row_stride, s, tile, vec,
            window_switching, c, bt);
    return (int)cudaGetLastError();
}

}  // extern "C"
