// K9: the decoder's synthesis before its FFTs: dequantize and the IMDCT's
// DCT-IV split and pre-twiddle, written in K1's input layouts.
//
// Replaces the front half of the JAX package's decoder jit
// (mrcaudiocodec_tpu/models/decoder.py:64-102, `_synth_chunk`: the band
// -> bin exponent :85 and quantize.dequantize :90, which the CPU runs as
// native/xpsy_ffi.cpp mode 5) and of the IMDCT dsp.synthesize runs
// (native/xmath_ffi.cpp mode 2, before its FFT); no Pallas counterpart.
// The port's plain version is ops/kernels/synth_pre.synth_pre_plain: the
// bin_band gather, quantize.dequantize and xmath.dct_iv_pre of the whole
// [F, 1024] and of its [F, 8, 128] view.
//
// One block (256 threads) a frame f. Each thread dequantizes four bins
// into shared memory, in the torch DAG's order, each f32 op a single
// correctly-rounded __f*_rn op (--fmad=false):
//   mag = |q| (q widened to int32 first: |-32768| = 32768)
//   p43 = pow43[mag] for mag <= QMAX (rd_loop.pow43_table, built by
//         dequantize's own ops), else xexp2(C43 * xlog2(mag)) (the parser
//         lets an escape reach 2^31; the int16 slab wraps it, so mag can
//         exceed QMAX: the chain of xpsy_dev.cuh, as dequantize runs it)
//   e   = e_band[bin_band[bt][i]]
//   step = fracs[d & 3] * bits(((d >> 2) + 127) << 23), d = e - GAIN_BIAS
//          (the shift on an unsigned: the int32 wrap of the torch op)
//   x[i] = q < 0 ? -(p43 * step) : p43 * step   (-0 where a step underflows)
// Then both families' pre-twiddles from x, for every frame whatever its
// block type, so every output equals the plain version's bit for bit:
//   long (M = 1024):  z[m] = (x[2m] * pr[m] - x[1023 - 2m] * pi[m],
//                             x[2m] * pi[m] + x[1023 - 2m] * pr[m]), m < 512
//   short (M = 128, sub-block g = the bins 128 g ...): the same on each
//   sub-block, m < 64
// Outputs, (re, im) f32 planes: long [F, 512], short [F, 8, 64].
//
// Bound on this card: HBM bytes. A frame reads 2 KB of q, 2 NB bytes of
// exponents and its block type, and writes 8 KB; about 14 ops a bin
// (the table read, the step's two, the product, the sign, six of the
// pre-twiddle for each family's half a bin).

#include <cuda_runtime.h>
#include <stdint.h>

#include "xpsy_dev.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCoeffs = 1024;
constexpr int kQmax = 4095;          // config.QMAX
constexpr int kGainBias = 128;       // config.GAIN_BIAS

struct Params {
    xpsy::Consts c;                  // xpsy.kernel_consts()
    float c43;                       // quantize.C43
    float fracs[4];                  // quantize.FRACS
};

struct Out {
    float *l_re, *l_im, *s_re, *s_im;
};

__device__ __forceinline__ float dequant(int q, int e, const float* pow43,
                                         const Params& p) {
    const int mag = q < 0 ? -q : q;
    float p43;
    if (mag <= kQmax) {
        p43 = __ldg(pow43 + mag);
    } else {
        p43 = xpsy::xexp2(__fmul_rn(p.c43, xpsy::xlog2(
                              xpsy::exact_float(mag), p.c)), p.c);
    }
    const int d = e - kGainBias;
    const float two_k =
        __int_as_float((int)((unsigned)((d >> 2) + 127) << 23));
    const float v = __fmul_rn(p43, __fmul_rn(p.fracs[d & 3], two_k));
    return q < 0 ? -v : v;
}

// z[m] of the size-M DCT-IV of u[0 .. M): the even / flipped-odd split and
// the pre-twiddle (xmath.dct_iv_pre, _cmul's order)
template <int M>
__device__ __forceinline__ void pre(const float* u, const float* tab, int m,
                                    float* re, float* im) {
    constexpr int H = M / 2;
    const float ue = u[2 * m], uo = u[M - 1 - 2 * m];
    const float pr = __ldg(tab + m), pi = __ldg(tab + H + m);
    *re = __fsub_rn(__fmul_rn(ue, pr), __fmul_rn(uo, pi));
    *im = __fadd_rn(__fmul_rn(ue, pi), __fmul_rn(uo, pr));
}

__global__ void __launch_bounds__(kThreads)
synth_pre_kernel(const int16_t* __restrict__ q,
                 const int16_t* __restrict__ e_band,
                 const int8_t* __restrict__ bt,
                 const int* __restrict__ bin_band,
                 const float* __restrict__ pow43,
                 const float* __restrict__ dct_l,
                 const float* __restrict__ dct_s, int nb, Params p, Out o) {
    __shared__ float x[kCoeffs];
    const long long f = blockIdx.x;
    const int t = threadIdx.x;
    const int16_t* qf = q + f * kCoeffs;
    const int16_t* ef = e_band + f * nb;
    const int* band = bin_band + (int)bt[f] * kCoeffs;
#pragma unroll
    for (int j = 0; j < kCoeffs / kThreads; ++j) {
        const int i = t + kThreads * j;
        x[i] = dequant(qf[i], ef[__ldg(band + i)], pow43, p);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int m = t + kThreads * j;
        float re, im;
        pre<1024>(x, dct_l, m, &re, &im);
        o.l_re[f * 512 + m] = re;
        o.l_im[f * 512 + m] = im;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int k = t + kThreads * j;            // g * 64 + m
        float re, im;
        pre<128>(x + 128 * (k >> 6), dct_s, k & 63, &re, &im);
        o.s_re[f * 512 + k] = re;
        o.s_im[f * 512 + k] = im;
    }
}

}  // namespace

extern "C" {

// q [F, 1024] int16, e_band [F, nb] int16, bt [F] int8 (0..4), bin_band
// [5, 1024] int32 (entropy.dev_tables), pow43 [QMAX + 1] f32
// (rd_loop.pow43_table), dct_l = xmath.dct4_blob(1024) [2049], dct_s =
// dct4_blob(128) [257]; consts [66] f32 on the host (xpsy.kernel_consts()),
// c43, fracs [4] on the host -> l_re, l_im [F, 512], s_re, s_im [F, 8, 64]
// f32. Returns cudaGetLastError() after the launch (0 = launched),
// cudaErrorInvalidValue for bad sizes.
int mrc_synth_pre(const int16_t* q, const int16_t* e_band, const int8_t* bt,
                  const int* bin_band, const float* pow43,
                  const float* dct_l, const float* dct_s, int nb,
                  const float* consts, float c43, const float* fracs,
                  float* l_re, float* l_im, float* s_re, float* s_im,
                  long long n_frames, void* stream) {
    if (n_frames < 1 || n_frames > 0x7fffffffLL || nb < 1)
        return (int)cudaErrorInvalidValue;
    Params p;
    float* dst = reinterpret_cast<float*>(&p.c);
    for (int i = 0; i < xpsy::kConsts; ++i) dst[i] = consts[i];
    p.c43 = c43;
    for (int i = 0; i < 4; ++i) p.fracs[i] = fracs[i];
    synth_pre_kernel<<<(unsigned)n_frames, kThreads, 0,
                       (cudaStream_t)stream>>>(
        q, e_band, bt, bin_band, pow43, dct_l, dct_s, nb, p,
        Out{l_re, l_im, s_re, s_im});
    return (int)cudaGetLastError();
}

}  // extern "C"
