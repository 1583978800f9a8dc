// K7: the MDCT after its FFTs, and the block type's choice of the long or
// the short transform.
//
// Replaces the back half of the JAX package's native/xmath_ffi.cpp mode 1
// (mdct_windowed: the DCT-IV's post-twiddle, interleave and scale) and
// dsp.analyze's select by block type, which jit A
// (mrcaudiocodec_tpu/models/encoder.py:65-120) runs; no Pallas
// counterpart. The port's plain version is
// ops/kernels/mdct_post.mdct_post_plain: xmath.dct_iv_post on both
// transforms and torch.where on bt. It is a kernel of its own, not K8's
// prologue: dsp.analyze needs the coefficients without the psycho chain.
//
// Input: K1's natural-order outputs of the two MDCT layouts, A_long
// [F, 512] and A_short [F, 8, 64] (re, im planes), and bt [F]. One thread
// an output coefficient j of frame f; SHORT frames take the short
// transform in group-major order (coeff[g * 128 + k]), every other frame
// the long one. With H = M / 2 and the post table of size M, each a single
// correctly-rounded f32 op (__f*_rn, --fmad=false), as dct_iv_post:
//   j = 2m:      b_re[m] = A_re[m] * post_re[m] - A_im[m] * post_im[m]
//   j = 2m + 1:  -b_im[H-1-m], b_im[i] = A_re[i] * post_im[i]
//                                      + A_im[i] * post_re[i]
//   out = that * scale
// Only the selected transform is computed: torch.where discards the other,
// so the bits are the same.
//
// Bound on this card: HBM bytes, the selected transform's 4 KB a frame
// read and 4 KB written; about 5 ops a coefficient.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kShort = 2;                  // config.SHORT

template <int M>
__device__ __forceinline__ float post(const float* ar, const float* ai,
                                      const float* tab, int jj) {
    constexpr int H = M / 2;
    const float* pr = tab + 2 * H;         // xmath.dct4_blob: post_re
    const float* pi = tab + 3 * H;         // post_im
    const float scale = __ldg(tab + 4 * H);
    const int m = jj >> 1;
    float v;
    if ((jj & 1) == 0) {
        v = __fsub_rn(__fmul_rn(ar[m], __ldg(pr + m)),
                      __fmul_rn(ai[m], __ldg(pi + m)));
    } else {
        const int i = H - 1 - m;
        v = -__fadd_rn(__fmul_rn(ar[i], __ldg(pi + i)),
                       __fmul_rn(ai[i], __ldg(pr + i)));
    }
    return __fmul_rn(v, scale);
}

__global__ void __launch_bounds__(kThreads)
mdct_post_kernel(const float* __restrict__ l_re, const float* __restrict__ l_im,
                 const float* __restrict__ s_re, const float* __restrict__ s_im,
                 const int* __restrict__ bt, const float* __restrict__ tab_l,
                 const float* __restrict__ tab_s, float* __restrict__ out) {
    const long long f = blockIdx.x;
    const int t = threadIdx.x;
    const bool is_short = bt[f] == kShort;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int j = t + kThreads * q;
        float v;
        if (is_short) {
            const long long base = f * 512 + (j >> 7) * 64;
            v = post<128>(s_re + base, s_im + base, tab_s, j & 127);
        } else {
            v = post<1024>(l_re + f * 512, l_im + f * 512, tab_l, j);
        }
        out[f * 1024 + j] = v;
    }
}

}  // namespace

extern "C" {

// l_re, l_im [F, 512], s_re, s_im [F, 8, 64] f32 (K1's outputs), bt [F]
// int32, tab_l = xmath.dct4_blob(1024) [2049], tab_s = dct4_blob(128)
// [257] -> coeffs [F, 1024] f32. Returns cudaGetLastError() after the
// launch (0 = launched), cudaErrorInvalidValue for bad sizes.
int mrc_mdct_post(const float* l_re, const float* l_im, const float* s_re,
                  const float* s_im, const int* bt, const float* tab_l,
                  const float* tab_s, float* coeffs, long long n_frames,
                  void* stream) {
    if (n_frames < 1 || n_frames > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    mdct_post_kernel<<<(unsigned)n_frames, kThreads, 0,
                       (cudaStream_t)stream>>>(l_re, l_im, s_re, s_im, bt,
                                               tab_l, tab_s, coeffs);
    return (int)cudaGetLastError();
}

}  // extern "C"
