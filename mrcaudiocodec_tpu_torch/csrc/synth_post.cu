// K10: the decoder's synthesis after its FFTs: the IMDCT's post-twiddle,
// unfold and window, the short sub-blocks' overlap, the select by block
// type, the overlap-add of a chunk's frames, the seam onto the previous
// chunk and the int16 conversion, written time-major as the decode's
// [n, channels] PCM.
//
// Replaces the back half of the JAX package's decoder jit
// (mrcaudiocodec_tpu/models/decoder.py:64-102, `_synth_chunk` :91-101:
// dsp.synthesize, mrcaudiocodec_tpu/ops/dsp.py:274-291, whose IMDCT the
// CPU runs as native/xmath_ffi.cpp mode 2 after its FFT, unfold_row :157;
// then the overlap-add and the int16 conversion) and the host's seam add
// of its decode; no Pallas counterpart. The port's plain version is
// ops/kernels/synth_post.synth_post_plain: xmath.dct_iv_post,
// xmath.unfold, the window multiply, the sub-blocks added onto zeros,
// torch.where on bt, first + prev, round and clamp, a transpose.
//
// A chunk holds R rows of s frames. Output hop f of row r is frame f's
// first half plus frame f-1's second half. Frame f's first half reads its
// coefficients c[512..1023] (long) or its sub-blocks 0..4 (SHORT), its
// second half c[0..511] or sub-blocks 3..7, each coefficient at two
// samples (the unfold maps M coefficients to 2M samples). So a block owns
// one hop f of a group of up to kRows = 2 rows (more rows are more row
// groups), 256 threads; grid (s + 1, groups), block s writes the tail. A
// block is a chain of latencies, so it starts every load before it waits
// on any, and its per-sample work is kept free of index arithmetic:
//   pass 1: each thread's post-twiddles (registers) and the block types
//     of frames f-1 and f; then the transform values of the coefficient
//     pairs it owns (registers) and, by cp.async, the long window halves
//     the hop reads and the short window (shared memory). Thread t owns
//     the pairs (c[2m], c[2m+1]), which read A[m] and A[H-1-m]: m = t
//     (c[0..511], frame f-1's) or t + 256 (c[512..1023], frame f's) of a
//     long frame; m = t & 63 of sub-blocks t >> 6 and (t >> 6) + 4 of a
//     SHORT one, those of the half the hop reads;
//   barrier (the windows);
//   pass 2: each of those coefficients computed once, then the two
//     samples the unfold gives each (its index map, the negation, the
//     window) into the half's sample buffer in shared memory: a long
//     frame's 1024 samples of the half, a SHORT frame's 256 windowed
//     samples of each sub-block that meets the half;
//   barrier;
//   sample phase: thread t takes samples 4t .. 4t + 3 of every row of
//     the group (16-byte shared loads): a long frame's samples as staged,
//     a SHORT frame's sub-blocks added onto +0 in group order, then the
//     overlap-add, the seam and the int16 step; it writes the group's
//     rows of the four samples side by side (one 32-byte or 16-byte run
//     when the group is all R rows). Every shared access of a warp is
//     consecutive words, forward or reversed (pairs as 8-byte words): no
//     bank conflict.
// Each f32 op is a single correctly-rounded __f*_rn op (--fmad=false), in
// the torch DAG's order, the same ops for each sample as the plain
// version's, computed once:
//   coefficient k of the size-M DCT-IV (dct_iv_post, as K7), H = M / 2:
//     k = 2m:      A_re[m] * post_re[m] - A_im[m] * post_im[m]
//     k = 2m + 1:  -(A_re[i] * post_im[i] + A_im[i] * post_re[i]),
//                  i = H - 1 - m
//     then * scale
//   unfold (M = 1024, h = 512): j < h: +c[h + j]; j < 3h: -c[3h - 1 - j];
//     else -c[j - 3h] (each negation flips a sign: +0 becomes -0), so
//     c[k] lands at j = k - 512 (+) and 1535 - k (-) for k >= 512, at
//     1535 - k (-) and 1536 + k (-) for k < 512
//   long frames: that * lw[bt][j]
//   SHORT frames: +0.0f, plus each sub-block g = 0 .. 7 whose span
//     448 + 128 g ... + 256 holds j, in group order (the plain version's
//     zeros_like then +=: a lone -0 comes out +0, and a sample outside
//     every sub-block is +0); a sub-block's value is the same at M = 128
//     on its 64 transform values, times the short window
// Then hop = first + prev, where prev is frame f-1's second half, and for
// hop 0 the previous chunk's tail if the caller gives one, else +0.0f
// (one f32 add: the seam of a chunked decode, bit for bit); for int16
// output round-half-even(hop * 32767) clamped to [-32768, 32767] (a NaN
// stays NaN through the clamp, as torch.clamp) and converted by the cast
// torch uses. `first` is frame 0's first half as it is (not first + 0),
// `tail` frame s-1's second half, both [R, 1024] f32.
//
// Bound on this card: HBM bytes. A frame reads the 4 KB of the transform
// its block type selects (a frame is read by two blocks, the second time
// from L2) and its block type, and writes its hop, 4 KB as f32 or 2 KB
// as int16; the seam reads the previous tail, R x 4 KB. What holds it
// instead is each block's latency (chip_smoke.py's k10_locate: one wave
// of blocks takes about as long as one block), so registers are capped
// at 64 a thread for 4 blocks of 256 an SM, and the 2048-row chunk takes
// two waves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;            // registers capped at 64 a thread
constexpr int kHop = 1024;
constexpr int kFrame = 2048;
constexpr int kRows = 2;                   // rows a block (a row group)
constexpr int kShort = 2;                  // config.SHORT
constexpr int kShortOffset = 448;          // config.SHORT_OFFSET
constexpr int kSubs = 5;                   // sub-blocks meeting a half

struct In {
    const float *l_re, *l_im, *s_re, *s_im;
    const int8_t* bt;
    const float* lw;                       // [5, 2048] long windows
    const float* sw;                       // [256] short window
    const float* dct_l;                    // xmath.dct4_blob(1024)
    const float* dct_s;                    // xmath.dct4_blob(128)
    const float* prev;                     // [R, 1024] or null
};

struct Out {
    void* pcm;                             // [s * 1024, R] f32 or int16
    float* first;                          // [R, 1024]
    float* tail;                           // [R, 1024]
};

// a thread's post-twiddles (pr[m], pi[m], pr[i], pi[i]), i = h - 1 - m
__device__ __forceinline__ float4 twiddles(const float* tab, int m, int h) {
    const int i = h - 1 - m;
    return make_float4(__ldg(tab + 2 * h + m), __ldg(tab + 3 * h + m),
                       __ldg(tab + 2 * h + i), __ldg(tab + 3 * h + i));
}

// the pair (c[2m], c[2m+1]) of a DCT-IV (dct_iv_post) from A[m] = (a.x,
// a.y), A[h-1-m] = (a.z, a.w) and their twiddles w
__device__ __forceinline__ float2 coeff_pair(float4 a, float4 w,
                                             float scale) {
    const float even = __fsub_rn(__fmul_rn(a.x, w.x), __fmul_rn(a.y, w.y));
    const float odd = -__fadd_rn(__fmul_rn(a.z, w.w), __fmul_rn(a.w, w.z));
    return make_float2(__fmul_rn(even, scale), __fmul_rn(odd, scale));
}

// (A_re[m], A_im[m], A_re[i], A_im[i]) of a transform at re, im
__device__ __forceinline__ float4 pair_inputs(const float* re,
                                              const float* im, int m,
                                              int i) {
    return make_float4(__ldg(re + m), __ldg(im + m), __ldg(re + i),
                       __ldg(im + i));
}

// 16 bytes global -> shared, asynchronously (cp.async, sm_80 and later)
__device__ __forceinline__ void copy16(float* smem, const float* gmem) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
}

// a pair's two coefficients c[k], c[k+1] (k = 2m even) of a frame's half
// as windowed samples into y (the half's 1024 samples): the unfold's
// index map relative to the half (`first`: the frame's first half, else
// its second), each sample's sign, times its staged window value w
__device__ __forceinline__ void long_samples(float2 c, int k, bool first,
                                             float* y, const float* w) {
    // a: c[k] at a, c[k+1] at a + 1; b: c[k+1] at b, c[k] at b + 1 (the
    // reversed image, negated). First half, k >= 512: j = k - 512 (+) and
    // 1535 - k; second half, k < 512: i = 512 + k (-) and 511 - k
    const int a = first ? k - 512 : 512 + k;
    const int b = first ? 1534 - k : 510 - k;
    const float ca = first ? c.x : -c.x, cb = first ? c.y : -c.y;
    const float2 wa = *reinterpret_cast<const float2*>(w + a);
    const float2 wb = *reinterpret_cast<const float2*>(w + b);
    *reinterpret_cast<float2*>(y + a) =
        make_float2(__fmul_rn(ca, wa.x), __fmul_rn(cb, wa.y));
    *reinterpret_cast<float2*>(y + b) =
        make_float2(__fmul_rn(-c.y, wb.x), __fmul_rn(-c.x, wb.y));
}

// a pair c[k], c[k+1] (k = 2m) of a sub-block (M = 128) as its windowed
// samples q (0 .. 255) into y: k >= 64: q = k - 64 (+), 191 - k (-);
// k < 64: q = 191 - k (-), 192 + k (-)
__device__ __forceinline__ void short_samples(float2 c, int k, float* y,
                                              const float* sw) {
    const int a = k >= 64 ? k - 64 : 192 + k;
    const float ca = k >= 64 ? c.x : -c.x, cb = k >= 64 ? c.y : -c.y;
    const int b = 190 - k;
    const float2 wa = *reinterpret_cast<const float2*>(sw + a);
    const float2 wb = *reinterpret_cast<const float2*>(sw + b);
    *reinterpret_cast<float2*>(y + a) =
        make_float2(__fmul_rn(ca, wa.x), __fmul_rn(cb, wa.y));
    *reinterpret_cast<float2*>(y + b) =
        make_float2(__fmul_rn(-c.y, wb.x), __fmul_rn(-c.x, wb.y));
}

// a SHORT frame's sample j: +0.0f plus each sub-block g whose span holds
// j, in group order, from the half's staged sub-blocks y (sub-block g at
// y + 256 (g - g_base))
__device__ __forceinline__ float short_value(const float* y, int g_base,
                                             int j) {
    float v = 0.0f;
    const int p = j - kShortOffset;
    if (p >= 0) {
        const int g_hi = p >> 7;           // the sub-block starting last
        const int g0 = g_hi > 0 ? g_hi - 1 : 0;
        const int g1 = g_hi < 7 ? g_hi : 7;
        for (int g = g0; g <= g1; ++g)
            v = __fadd_rn(v, y[256 * (g - g_base) + p - 128 * g]);
    }
    return v;
}

__device__ __forceinline__ int16_t to_pcm16(float hop) {
    const float r = rintf(__fmul_rn(hop, 32767.0f));   // half to even
    const float c = isnan(r) ? r : fminf(fmaxf(r, -32768.0f), 32767.0f);
    return static_cast<int16_t>(c);
}

// four consecutive samples i .. i + 3 of a staged half: a long frame's
// as staged, a SHORT frame's sub-blocks added onto +0 (short_value; j =
// i or 1024 + i, g_base 0 or 3)
__device__ __forceinline__ float4 half_samples(const float* y, int b,
                                               bool first, int i) {
    if (b != kShort) return *reinterpret_cast<const float4*>(y + i);
    const int j = first ? i : kHop + i, gb = first ? 0 : 3;
    return make_float4(short_value(y, gb, j), short_value(y, gb, j + 1),
                       short_value(y, gb, j + 2), short_value(y, gb, j + 3));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

template <bool kPcm16>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
synth_post_kernel(In in, Out o, int rows, int s) {
    // the half's samples: frame f-1's second half (k = 0), frame f's
    // first half (k = 1); a SHORT frame's 5 sub-blocks of 256
    __shared__ __align__(16) float ybuf[2][kRows][kSubs * 256];
    // long windows: frame f-1's second half (k = 0), f's first half (1)
    __shared__ __align__(16) float wbuf[2][kRows][kHop];
    __shared__ __align__(16) float swin[256];
    const int t = threadIdx.x;
    const int h = blockIdx.x;                  // the hop (s: the tail)
    const int r0 = blockIdx.y * kRows;
    const int g = rows - r0 < kRows ? rows - r0 : kRows;
    const int sub = t >> 6, ms = t & 63;       // SHORT: sub-blocks sub, +4
    // pass 1: twiddles and block types, nothing waited on yet
    const float4 wl0 = twiddles(in.dct_l, t, 512);
    const float4 wl1 = twiddles(in.dct_l, t + 256, 512);
    const float4 ws = twiddles(in.dct_s, ms, 64);
    const float scale_l = __ldg(in.dct_l + 2048);
    const float scale_s = __ldg(in.dct_s + 256);
    if (t < 64) copy16(swin + 4 * t, in.sw + 4 * t);
    int bts[2][kRows];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            const int fr = h - 1 + k;
            const bool valid = r < g && fr >= 0 && fr < s;
            bts[k][r] = valid ? __ldg(in.bt + (long long)(r0 + r) * s + fr)
                              : -1;
        }
    // then every transform load: long, the pair m = t (frame f-1's
    // c[0..511]) or t + 256 (frame f's c[512..1023]); SHORT, sub-blocks
    // sub (0..3) and sub + 4 where the half meets them (the first half
    // sub-blocks 0..4, the second 3..7)
    float4 a[2][kRows][2];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            const int b = bts[k][r];
            if (b < 0) continue;
            const long long at = ((long long)(r0 + r) * s + h - 1 + k) * 512;
            if (b != kShort) {
                copy16(&wbuf[k][r][4 * t],
                       in.lw + b * kFrame + (k ? 0 : kHop) + 4 * t);
                const int m = k ? t + 256 : t;
                a[k][r][0] = pair_inputs(in.l_re + at, in.l_im + at, m,
                                         511 - m);
            } else {
                if (k || sub == 3)
                    a[k][r][0] = pair_inputs(in.s_re + at + 64 * sub,
                                             in.s_im + at + 64 * sub, ms,
                                             63 - ms);
                if (!k || sub == 0)
                    a[k][r][1] = pair_inputs(in.s_re + at + 64 * (sub + 4),
                                             in.s_im + at + 64 * (sub + 4),
                                             ms, 63 - ms);
            }
        }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // pass 2: each pair computed once, then its samples
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            const int b = bts[k][r];
            if (b < 0) continue;
            if (b != kShort) {
                long_samples(coeff_pair(a[k][r][0], k ? wl1 : wl0, scale_l),
                             2 * (k ? t + 256 : t), k == 1, ybuf[k][r],
                             wbuf[k][r]);
            } else {
                // sub-block g at slot g (first half) or g - 3 (second)
                const int g_base = k ? 0 : 3;
                if (k || sub == 3)
                    short_samples(coeff_pair(a[k][r][0], ws, scale_s),
                                  2 * ms, ybuf[k][r] + 256 * (sub - g_base),
                                  swin);
                if (!k || sub == 0)
                    short_samples(coeff_pair(a[k][r][1], ws, scale_s),
                                  2 * ms,
                                  ybuf[k][r] + 256 * (sub + 4 - g_base),
                                  swin);
            }
        }
    __syncthreads();
    // sample phase: thread t takes samples 4t .. 4t + 3 of each row
    const int i = 4 * t;
    float4 v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        v[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r >= g) continue;
        const long long rr = (long long)(r0 + r) * kHop + i;
        float4 pv;
        if (h > 0)
            pv = half_samples(ybuf[0][r], bts[0][r], false, i);
        else if (in.prev)
            pv = *reinterpret_cast<const float4*>(in.prev + rr);
        else
            pv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (h == s) {
            *reinterpret_cast<float4*>(o.tail + rr) = pv;
            continue;
        }
        const float4 fv = half_samples(ybuf[1][r], bts[1][r], true, i);
        if (h == 0) *reinterpret_cast<float4*>(o.first + rr) = fv;
        v[r] = add4(fv, pv);
    }
    if (h == s) return;
    const long long at = ((long long)h * kHop + i) * rows + r0;
    if (kPcm16) {
        int16_t* pcm = static_cast<int16_t*>(o.pcm) + at;
        if (g == 2 && rows == 2) {     // 8 samples, 16 bytes
            const short2 p0 = make_short2(to_pcm16(v[0].x), to_pcm16(v[1].x));
            const short2 p1 = make_short2(to_pcm16(v[0].y), to_pcm16(v[1].y));
            const short2 p2 = make_short2(to_pcm16(v[0].z), to_pcm16(v[1].z));
            const short2 p3 = make_short2(to_pcm16(v[0].w), to_pcm16(v[1].w));
            uint4 w;
            w.x = (uint16_t)p0.x | ((uint32_t)(uint16_t)p0.y << 16);
            w.y = (uint16_t)p1.x | ((uint32_t)(uint16_t)p1.y << 16);
            w.z = (uint16_t)p2.x | ((uint32_t)(uint16_t)p2.y << 16);
            w.w = (uint16_t)p3.x | ((uint32_t)(uint16_t)p3.y << 16);
            *reinterpret_cast<uint4*>(pcm) = w;
        } else {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                if (r >= g) continue;
                pcm[r] = to_pcm16(v[r].x);
                pcm[rows + r] = to_pcm16(v[r].y);
                pcm[2 * rows + r] = to_pcm16(v[r].z);
                pcm[3 * rows + r] = to_pcm16(v[r].w);
            }
        }
    } else {
        float* pcm = static_cast<float*>(o.pcm) + at;
        if (g == 2 && rows == 2) {     // 8 samples, 32 bytes
            *reinterpret_cast<float4*>(pcm) =
                make_float4(v[0].x, v[1].x, v[0].y, v[1].y);
            *reinterpret_cast<float4*>(pcm + 4) =
                make_float4(v[0].z, v[1].z, v[0].w, v[1].w);
        } else {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                if (r >= g) continue;
                pcm[r] = v[r].x;
                pcm[rows + r] = v[r].y;
                pcm[2 * rows + r] = v[r].z;
                pcm[3 * rows + r] = v[r].w;
            }
        }
    }
}

}  // namespace

extern "C" {

// l_re, l_im [R * s, 512], s_re, s_im [R * s, 8, 64] f32 (K1's outputs),
// bt [R, s] int8 (0..4), lw [5, 2048], sw [256], dct_l [2049], dct_s [257]
// f32, prev [R, 1024] f32 or null (the previous chunk's tail) -> pcm
// [s * 1024, R] (int16 if pcm16, else f32), first, tail [R, 1024] f32;
// every pointer 16-byte aligned. Returns cudaGetLastError() after the
// launch (0 = launched), cudaErrorInvalidValue for bad sizes or
// alignments.
int mrc_synth_post(const float* l_re, const float* l_im, const float* s_re,
                   const float* s_im, const int8_t* bt, const float* lw,
                   const float* sw, const float* dct_l, const float* dct_s,
                   const float* prev, int rows, int s, int pcm16, void* pcm,
                   float* first, float* tail, void* stream) {
    const uintptr_t any = reinterpret_cast<uintptr_t>(pcm) |
                          reinterpret_cast<uintptr_t>(lw) |
                          reinterpret_cast<uintptr_t>(sw) |
                          reinterpret_cast<uintptr_t>(prev) |
                          reinterpret_cast<uintptr_t>(first) |
                          reinterpret_cast<uintptr_t>(tail);
    if (rows < 1 || rows > 65535 || s < 1 || s >= 0x7fffffff ||
        (any & 15) != 0)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)s + 1, (unsigned)((rows + kRows - 1) / kRows));
    const In in{l_re, l_im, s_re, s_im, bt, lw, sw, dct_l, dct_s, prev};
    const Out o{pcm, first, tail};
    if (pcm16)
        synth_post_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            in, o, rows, s);
    else
        synth_post_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            in, o, rows, s);
    return (int)cudaGetLastError();
}

}  // extern "C"
