// K6: everything of the analysis before its FFTs, written in K1's input
// layouts.
//
// Replaces the front halves of the JAX package's fused native chains:
// native/xmath_ffi.cpp mode 1 (mdct_windowed: window, TDAC fold, the
// DCT-IV's even / flipped-odd split and pre-twiddle) and
// native/xpsy_ffi.cpp modes 0 and 1 (psycho long and short: Hann window,
// even / odd de-interleave), which jit A
// (mrcaudiocodec_tpu/models/encoder.py:65-120) runs; no Pallas
// counterpart. The port's plain version is
// ops/kernels/analysis_pre.analysis_pre_plain: xmath.fold,
// xmath.dct_iv_pre and xpsy.rfft_pre on the eager frames.
//
// One block (256 threads) a frame, the grid (rows, frames a row). The
// frame's 2048 samples (int16 * 2^-15, exact, or f32) are staged in shared
// memory; then, each a single correctly-rounded f32 op (__f*_rn,
// --fmad=false), in the torch DAG's order:
//   MDCT long (M = 1024, h = 512), v = x * lw[bt]:
//     u[q] = (-v[1535 - q]) - v[1536 + q]        q < 512 (fold's a:
//            negate, then subtract; -(a + b) would flip signed zeros)
//     u[q] = v[q - 512] - v[1535 - q]           q >= 512 (fold's b)
//     z[m] = (u[2m] * pre_re - u[1023 - 2m] * pre_im,
//             u[2m] * pre_im + u[1023 - 2m] * pre_re), m < 512
//   MDCT short: the same at M = 128 on each sub-block g (samples
//     448 + 128 g ..., window sw), z [8, 64]
//   psycho long: (x[2k] * hann[2k], x[2k+1] * hann[2k+1]), k < 1024
//   psycho short: the same on each sub-block with the 256-point hann,
//     [8, 128]
// Outputs, each (re, im) f32 planes: MDCT long [F, 512], MDCT short
// [F, 8, 64], psycho long [F, 1024], psycho short [F, 8, 128]: K1's
// contiguous input layouts (8 short FFTs side by side a row). A null
// pointer pair skips its part (dsp.analyze wants the MDCT parts,
// psycho.analyze the psycho parts).
//
// Bound on this card: HBM bytes. Each frame reads 2048 samples (the
// overlap makes every sample read twice; the second read is an L2 hit,
// and the bound counts it once) and writes 3072 complex values, 24 KB:
// the writes dominate. Ops: about 14 a written value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrame = 2048;
constexpr int kShortOffset = 448;   // config.SHORT_OFFSET

struct Tables {                     // device pointers
    const float* lw;                // [5, 2048] long windows by block type
    const float* sw;                // [256] short window
    const float* hann_l;            // [2048]
    const float* hann_s;            // [256]
    const float* dct_l;             // xmath.dct4_blob(1024): pre_re, pre_im [512]
    const float* dct_s;             // xmath.dct4_blob(128): pre_re, pre_im [64]
};

struct Out {
    float *ml_re, *ml_im, *ms_re, *ms_im, *pl_re, *pl_im, *ps_re, *ps_im;
};

__device__ __forceinline__ float sample(const int16_t* p, long long i) {
    // int16 -> f32 exactly (1.5 * 2^23 trick), then * 2^-15 (exact)
    return __fmul_rn(__fsub_rn(__int_as_float(0x4B400000 + p[i]),
                               12582912.0f),
                     3.0517578125e-05f);
}
__device__ __forceinline__ float sample(const float* p, long long i) {
    return p[i];
}

// z[m] of the size-M MDCT of the 2M windowed samples x[0 .. 2M) * w
template <int M>
__device__ __forceinline__ void mdct_pre(const float* x, const float* w,
                                         const float* pre, int m, float* re,
                                         float* im) {
    constexpr int H = M / 2;
    auto v = [&](int k) { return __fmul_rn(x[k], __ldg(w + k)); };
    auto u = [&](int q) {
        return q < H ? __fsub_rn(-v(3 * H - 1 - q), v(3 * H + q))
                     : __fsub_rn(v(q - H), v(3 * H - 1 - q));
    };
    const float ue = u(2 * m), uo = u(M - 1 - 2 * m);
    const float pr = __ldg(pre + m), pi = __ldg(pre + H + m);
    *re = __fsub_rn(__fmul_rn(ue, pr), __fmul_rn(uo, pi));
    *im = __fadd_rn(__fmul_rn(ue, pi), __fmul_rn(uo, pr));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
analysis_pre_kernel(const T* __restrict__ audio, long long row_stride,
                    long long frame_stride, long long offset, int s,
                    const int* __restrict__ bt, Tables tb, Out o) {
    __shared__ float x[kFrame];
    const int r = blockIdx.x, f = blockIdx.y;      // no divide: grid (R, s)
    const long long fi = (long long)r * s + f;
    const T* src = audio + (long long)r * row_stride + offset
        + (long long)f * frame_stride;
    const int t = threadIdx.x;
#pragma unroll
    for (int j = 0; j < kFrame / kThreads; ++j)
        x[t + kThreads * j] = sample(src, t + kThreads * j);
    __syncthreads();
    if (o.ml_re) {
        const float* w = tb.lw + bt[fi] * kFrame;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int m = t + kThreads * j;
            float re, im;
            mdct_pre<1024>(x, w, tb.dct_l, m, &re, &im);
            o.ml_re[fi * 512 + m] = re;
            o.ml_im[fi * 512 + m] = im;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int q = t + kThreads * j;        // g * 64 + m
            const int g = q >> 6, m = q & 63;
            float re, im;
            mdct_pre<128>(x + kShortOffset + 128 * g, tb.sw, tb.dct_s, m,
                          &re, &im);
            o.ms_re[fi * 512 + q] = re;
            o.ms_im[fi * 512 + q] = im;
        }
    }
    if (o.pl_re) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int k = t + kThreads * j;
            o.pl_re[fi * 1024 + k] = __fmul_rn(x[2 * k], __ldg(tb.hann_l + 2 * k));
            o.pl_im[fi * 1024 + k] =
                __fmul_rn(x[2 * k + 1], __ldg(tb.hann_l + 2 * k + 1));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int q = t + kThreads * j;        // g * 128 + k
            const int g = q >> 7, k = q & 127;
            const float* sub = x + kShortOffset + 128 * g;
            o.ps_re[fi * 1024 + q] = __fmul_rn(sub[2 * k], __ldg(tb.hann_s + 2 * k));
            o.ps_im[fi * 1024 + q] =
                __fmul_rn(sub[2 * k + 1], __ldg(tb.hann_s + 2 * k + 1));
        }
    }
}

}  // namespace

extern "C" {

// audio: frame f of row r is the 2048 samples at r * row_stride + offset +
// f * frame_stride (int16 if is_int16, else f32); bt [rows * s] int32
// (0..4); lw [5, 2048], sw [256], hann_l [2048], hann_s [256], dct_l
// [2049], dct_s [257] f32 -> the eight planes above (a null ml_re skips the
// MDCT parts, a null pl_re the psycho parts). Returns cudaGetLastError()
// after the launch (0 = launched), cudaErrorInvalidValue for bad sizes.
int mrc_analysis_pre(const void* audio, int is_int16, long long row_stride,
                     long long frame_stride, long long offset, int rows,
                     int s, const int* bt, const float* lw, const float* sw,
                     const float* hann_l, const float* hann_s,
                     const float* dct_l, const float* dct_s, float* ml_re,
                     float* ml_im, float* ms_re, float* ms_im, float* pl_re,
                     float* pl_im, float* ps_re, float* ps_im, void* stream) {
    if (rows < 1 || s < 1 || s > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)rows, (unsigned)s);
    const Tables tb{lw, sw, hann_l, hann_s, dct_l, dct_s};
    const Out o{ml_re, ml_im, ms_re, ms_im, pl_re, pl_im, ps_re, ps_im};
    if (is_int16)
        analysis_pre_kernel<int16_t><<<grid, kThreads, 0,
                                       (cudaStream_t)stream>>>(
            static_cast<const int16_t*>(audio), row_stride, frame_stride,
            offset, s, bt, tb, o);
    else
        analysis_pre_kernel<float><<<grid, kThreads, 0,
                                     (cudaStream_t)stream>>>(
            static_cast<const float*>(audio), row_stride, frame_stride,
            offset, s, bt, tb, o);
    return (int)cudaGetLastError();
}

}  // extern "C"
