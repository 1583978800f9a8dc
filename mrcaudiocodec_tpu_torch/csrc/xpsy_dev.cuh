// Device math shared by the analysis kernels K5 (transients.cu) and K8
// (psycho.cu) and by the decoder's K9 (synth_pre.cu, the |q|^(4/3) chain
// beyond QMAX): the normative xlog2 / xexp2 of xpsy.py, each a copy of the
// op DAG of mrcaudiocodec_tpu_torch/xpsy.py (xlog2 :72, xexp2 :112).
//
// Every f32 op is a single correctly-rounded __f*_rn op, in the order of
// the torch DAG, and the libraries are built with --fmad=false: no
// multiply is contracted into an FMA. Every rounded f32 constant comes in
// from the port's xpsy.f32 roundings (`struct Consts`, filled from
// xpsy.kernel_consts() and passed by value, so it lives in the constant
// bank); the literals below (0.5, 1.0, 0x3F800000, the 1.5 * 2^23 of the
// integer conversions) are exact.
//
// No conversion instruction appears: float <-> int goes through the exact
// 1.5 * 2^23 trick (an add and integer work), so nothing here compiles to
// an F2I or I2F, and so to no .FTZ form either (an F2I.FTZ is what a
// division by a variable gives; none is written).

#pragma once

#include <stdint.h>

namespace xpsy {

// The order of xpsy.kernel_consts(); mrc_* entry points copy the host
// array into this struct (static_assert on its size there).
struct Consts {
    float tiny, ln2, sqrt2;
    float log2_p[13];           // xpsy._LOG2_P, c0 .. c12
    float exp_k[8];             // xpsy._EXP_K, 1/7! .. 1/0!
    float sfm_floor_rel, tmn_db, nmt_db, simple_factor;
    float ten_log10_2, inv_neg60, neg_l210_10, big;
    float log2_inv_smr_ceil, log2_inv_smr_floor;
    float attack_ratio, attack_abs;
    float eps_i[15], inv_i[15];  // EPS * i and 1 / i, i = 1 .. 15
};
constexpr int kConsts = 66;
static_assert(sizeof(Consts) == kConsts * sizeof(float), "Consts layout");

constexpr float kMagic = 12582912.0f;       // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;

// float(e) for |e| < 2^22, exactly (torch's int -> float32 cast)
__device__ __forceinline__ float exact_float(int e) {
    return __fsub_rn(__int_as_float(kMagicBits + e), kMagic);
}

// xpsy.xlog2: exponent by bitcast, mantissa in [sqrt2/2, sqrt2), the
// degree-12 Horner in t = m - 1, e + p. Positive normal inputs.
__device__ __forceinline__ float xlog2(float x, const Consts& c) {
    const int bits = __float_as_int(x);
    int e = (bits >> 23) - 127;
    float m = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
    if (m >= c.sqrt2) {
        m = __fmul_rn(m, 0.5f);
        e += 1;
    }
    const float t = __fsub_rn(m, 1.0f);
    float p = __fadd_rn(__fmul_rn(c.log2_p[12], t), c.log2_p[11]);
#pragma unroll
    for (int i = 10; i >= 0; --i) p = __fadd_rn(__fmul_rn(p, t), c.log2_p[i]);
    return __fadd_rn(exact_float(e), p);
}

// xpsy.xexp2: k = round-half-even(x) clamped to [-126, 126], f = x - k,
// the Taylor-Horner exp(f * ln2), times 2^k by bitcast. x + 1.5 * 2^23
// rounds x half-even to an integer for |x| <= 2^22 (torch.round); beyond
// that the clamp decides k.
__device__ __forceinline__ float xexp2(float x, const Consts& c) {
    int k;
    if (x > 4194304.0f) {
        k = 126;
    } else if (x < -4194304.0f) {
        k = -126;
    } else {
        k = __float_as_int(__fadd_rn(x, kMagic)) - kMagicBits;
    }
    k = k < -126 ? -126 : (k > 126 ? 126 : k);
    const float f = __fsub_rn(x, exact_float(k));
    const float cc = __fmul_rn(f, c.ln2);
    float p = __fadd_rn(__fmul_rn(c.exp_k[0], cc), c.exp_k[1]);
#pragma unroll
    for (int i = 2; i < 8; ++i) p = __fadd_rn(__fmul_rn(p, cc), c.exp_k[i]);
    return __fmul_rn(p, __int_as_float((k + 127) << 23));
}

}  // namespace xpsy
