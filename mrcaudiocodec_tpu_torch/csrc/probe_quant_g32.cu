// P1 and P2: the quantizer's magnitudes and its elementwise ops with the
// card's native IEEE divide and square root.
//
// Replaces two Pallas kernels of scripts/tpu_quant_g32.py:
//   P1 `_mag_kernel` (:85, pallas_call in `mag_probe` at :110): quantized
//      magnitudes of one gain column,
//        e = clip(g - amp_bin, 0, 255), d = e - 128,
//        a = |x| / (frac[d & 3] * 2^(d >> 2)),
//        mag = min(floor(sqrt(a * sqrt(a)) + MAGIC), QMAX);
//   P2 `_op_kernel` (:149, pallas_call in `phase3` at :177): a = |x| / s,
//      sqrt(a) and sqrt(a * sqrt(a)), elementwise.
// These are the rev-3 quantizer's native ops, which the TPU probe held
// against XLA. The normative rev-4 chain (K2, csrc/quant_cost.cu) uses
// only multiplies, adds and the pinned xsqrt; these probes measure how far
// native IEEE divide and sqrt come from it.
//
// `/` and sqrtf are the IEEE round-to-nearest operations (div.rn.f32,
// sqrt.rn.f32: no --use_fast_math, no __fdividef, no rsqrtf). The
// multiplies and the add are __f*_rn intrinsics, and the library is built
// with --fmad=false. ptxas expands div.rn and sqrt.rn into a reciprocal or
// reciprocal-square-root estimate refined by fused multiply-adds (with a
// slow path for hard operands); the result is still the correctly rounded
// one, and the SASS audit of the FMA probe reports those FFMAs apart.
//
// Bound on this card: HBM bytes (P1: 12 B per bin for ~20 ops; P2: 8 B in
// and 12 B out per element for 5 ops). Design: one thread per element,
// 256 threads per block, no shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCoeffs = 1024;

__global__ void __launch_bounds__(kThreads)
mag_probe_kernel(const float* __restrict__ x, const int* __restrict__ amp_bin,
                 const int* __restrict__ gains, int gain_cols,
                 float frac1, float frac2, float frac3, float magic,
                 int* __restrict__ out, long long n) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const long long f = i / kCoeffs;
    int e = gains[f * gain_cols] - amp_bin[i];           // gain column 0
    e = e < 0 ? 0 : (e > 255 ? 255 : e);
    const int d = e - 128;
    const int r = d & 3;
    const float frac = r == 0 ? 1.0f : (r == 1 ? frac1 : (r == 2 ? frac2 : frac3));
    const float two_k = __int_as_float(((d >> 2) + 127) << 23);
    const float a = fabsf(x[i]) / __fmul_rn(frac, two_k);
    const float p = sqrtf(__fmul_rn(a, sqrtf(a)));
    out[i] = (int)fminf(floorf(__fadd_rn(p, magic)), 4095.0f);
}

__global__ void __launch_bounds__(kThreads)
op_probe_kernel(const float* __restrict__ x, const float* __restrict__ s,
                float* __restrict__ div_out, float* __restrict__ sqrt_out,
                float* __restrict__ p_out, long long n) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const float a = fabsf(x[i]) / s[i];
    const float sq = sqrtf(a);
    div_out[i] = a;
    sqrt_out[i] = sq;
    p_out[i] = sqrtf(__fmul_rn(a, sq));
}

unsigned blocks(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// x [F,1024] f32, amp_bin [F,1024] i32, gains [F,gain_cols] i32 (column 0
// read), frac1..3 = f32(2^0.25), f32(2^0.5), f32(2^0.75), magic =
// f32(QUANT_MAGIC) -> out [F,1024] i32. Returns cudaGetLastError().
int mrc_probe_mag(const float* x, const int* amp_bin, const int* gains,
                  int gain_cols, float frac1, float frac2, float frac3,
                  float magic, int* out, long long n_frames, void* stream) {
    const long long n = n_frames * kCoeffs;
    mag_probe_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        x, amp_bin, gains, gain_cols, frac1, frac2, frac3, magic, out, n);
    return (int)cudaGetLastError();
}

// x, s: n f32 -> |x| / s, sqrt(|x| / s), sqrt(a * sqrt(a)): n f32 each.
int mrc_probe_ops(const float* x, const float* s, float* div_out,
                  float* sqrt_out, float* p_out, long long n, void* stream) {
    op_probe_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        x, s, div_out, sqrt_out, p_out, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
