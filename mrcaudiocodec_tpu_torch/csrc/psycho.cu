// K8: the psychoacoustic model after its FFTs, one block a frame.
//
// Replaces what jit A (mrcaudiocodec_tpu/models/encoder.py:65-120) runs
// of ops/psycho.analyze (:186 there) after the FFTs: the back halves of
// native/xpsy_ffi.cpp modes 0 and 1 (rfft_power's untwist and power,
// block_thresholds, band_pe / groups_pe) and its mode 2 (band energy of
// the MDCT coefficients), then allowed_noise; no Pallas counterpart. The
// port's plain version is ops/kernels/psycho.psycho_plain
// (ops/psycho.thresholds on xpsy.rfft_untwist_power's spectra).
//
// Input: K1's natural-order outputs of the two psycho layouts, A_long
// [F, 1024] and A_short [F, 8, 128] (re, im planes), the coefficients
// [F, 1024] (K7's) and bt [F]; the family blobs xpsy.kernel_blobs(fs,
// long) and (fs, short) on the card; the constants of
// xpsy.kernel_consts(). Output: allowed [F, NB], pe [F], e_mdct [F, NB].
//
// A block computes only the family its block type selects: the plain
// version computes both and torch.where discards the other, so the bits
// are the same. Long: 1024 bins, one group; short: 8 groups of 128. Both
// are 1024 bins, so one block shape serves both: 256 threads, thread t
// owning bins t + 256 j. In the torch DAG's order, every f32 op a single
// correctly-rounded __f*_rn op (--fmad=false):
//   untwist + power (xpsy.rfft_untwist_power), the floor at SFM_FLOOR_REL
//   x the group's max (max in any order is exact);
//   e_part and the sum of xlog2(p + TINY) over the partitions: the
//   segmented scan stage by stage in shared memory (xpsy_dev.cuh), each
//   sum the value the scan leaves at its segment's end;
//   per partition (thread g * NP + i): the spreading sum in masker order
//   i = 0 .. NP-1, one multiply and one add a term; the flatness in the
//   log2 domain, xexp2, the ATH max, the threshold density;
//   band energies of p and of the coefficients squared on the band
//   segments (the unified layout's bands are the family's, then bands of
//   width 0, whose energy is an exact 0; the wrapper checks this);
//   per band: the min of the densities of the partitions pb_mask maps to it
//   (BIG where none) x width, the PE term; allowed per unified band with
//   e_full = 0 and t_full = BIG beyond the family's bands;
//   PE: tree_sum over the bands padded with zeros to a power of two, then
//   (short) the fold over the 8 groups left to right.
//
// Bound on this card: HBM bytes, the selected spectrum (8 KB a frame),
// the coefficients (4 KB), allowed and e_mdct (4 NB B each) and pe; the ops
// (about 90 a bin with full psycho: two xlog2 a bin, 2 x 8 scan stages,
// the untwist) put it close to the byte time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "xpsy_dev.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 1024;
constexpr int kShort = 2;           // config.SHORT
constexpr int kSlots = 256;         // groups x partitions, at most
constexpr int kPeSlots = 128;       // groups x bands padded to a power of 2

struct Family {
    int npart, nb, part_stages, band_stages;
    const int *part_start, *part_ends, *band_start, *band_ends, *pb;
    const float *cr, *ci, *spread, *inv, *ath, *width;
};

// xpsy.kernel_blobs' layout
__device__ __forceinline__ Family parse(const int* ib, const float* fb) {
    Family m;
    const int n = ib[0], h = ib[1];
    m.npart = ib[2];
    m.nb = ib[3];
    m.part_stages = ib[4];
    m.band_stages = ib[5];
    const int* p = ib + 8;
    m.part_start = p;
    p += h;
    m.part_ends = p;
    p += m.npart;
    m.band_start = p;
    p += h;
    m.band_ends = p;
    p += m.nb;
    m.pb = p;
    const float* f = fb + n;        // past the hann window (K6's)
    m.cr = f;
    f += h;
    m.ci = f;
    f += h;
    m.spread = f;
    f += m.npart * m.npart;
    m.inv = f;
    f += m.npart;
    m.ath = f;
    f += m.npart;
    m.width = f;
    return m;
}

struct Smem {
    float p[kBins];                 // the group maxima's input
    float a[kBins], b[kBins];       // scan buffers
    float gmax[8];
    float ep[kSlots], dens[kSlots];
    float pev[kPeSlots], peg[8];
};

template <int H, int G>
__device__ __forceinline__ void family(long long f, const float* __restrict__ zr,
                       const float* __restrict__ zi,
                       const float* __restrict__ coeffs, const Family& m,
                       int nbu, bool full, const xpsy::Consts& c, Smem& sm,
                       float* allowed, float* pe, float* e_mdct) {
    const int t = threadIdx.x;
    const int warp = t >> 5, lane = t & 31;
    // power spectrum, xpsy.rfft_untwist_power
    float pv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int k = t + kThreads * j;
        const int g = k / H, kk = k % H;
        const float* ar = zr + f * kBins + g * H;
        const float* ai = zi + f * kBins + g * H;
        const int rk = kk == 0 ? 0 : H - kk;
        const float z_r = ar[kk], z_i = ai[kk], br = ar[rk], bi = ai[rk];
        const float a_re = __fmul_rn(__fadd_rn(z_r, br), 0.5f);
        const float a_im = __fmul_rn(__fsub_rn(z_i, bi), 0.5f);
        const float b_re = __fmul_rn(__fadd_rn(z_i, bi), 0.5f);
        const float b_im = __fmul_rn(__fsub_rn(br, z_r), 0.5f);
        const float cr = __ldg(m.cr + kk), ci = __ldg(m.ci + kk);
        const float x_re = __fadd_rn(a_re, __fsub_rn(__fmul_rn(b_re, cr),
                                                     __fmul_rn(b_im, ci)));
        const float x_im = __fadd_rn(a_im, __fadd_rn(__fmul_rn(b_re, ci),
                                                     __fmul_rn(b_im, cr)));
        pv[j] = __fadd_rn(__fmul_rn(x_re, x_re), __fmul_rn(x_im, x_im));
        sm.p[k] = pv[j];
    }
    __syncthreads();
    {   // the max of each 128 bins, a warp each
        float v = sm.p[warp * 128 + lane];
#pragma unroll
        for (int i = 1; i < 4; ++i) v = fmaxf(v, sm.p[warp * 128 + lane + 32 * i]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
        if (lane == 0) sm.gmax[warp] = v;
    }
    __syncthreads();
    int start[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int k = t + kThreads * j;
        const int g = k / H, kk = k % H;
        float pmax = sm.gmax[G == 1 ? 0 : g];
        if (G == 1) {
#pragma unroll
            for (int w = 1; w < 8; ++w) pmax = fmaxf(pmax, sm.gmax[w]);
        }
        const float fl = __fmul_rn(c.sfm_floor_rel, pmax);
        pv[j] = pv[j] > fl ? pv[j] : fl;               // torch.maximum
        sm.a[k] = pv[j];
        if (full) sm.b[k] = xpsy::xlog2(__fadd_rn(pv[j], c.tiny), c);
        start[j] = g * H + __ldg(m.part_start + kk);
    }
    __syncthreads();
    if (full)
        xpsy::seg_scan<kThreads, true>(sm.a, sm.b, start, m.part_stages);
    else
        xpsy::seg_scan<kThreads, false>(sm.a, sm.b, start, m.part_stages);

    // partitions: thread t = g * NP + i
    const int np = m.npart;
    const bool has_part = t < G * np;
    int pg = 0, pi = t;
    while (pi >= np && pg < G - 1) {
        pi -= np;
        ++pg;
    }
    float e = 0.0f;
    int pend = 0;
    if (has_part) {
        pend = pg * H + __ldg(m.part_ends + pi);
        e = sm.a[pend];
        sm.ep[t] = e;
    }
    __syncthreads();
    if (has_part) {
        const float inv = __ldg(m.inv + pi);
        float tp;
        if (full) {
            const float* ep = sm.ep + pg * np;
            float sp = __fmul_rn(ep[0], __ldg(m.spread + pi));
            for (int i = 1; i < np; ++i)
                sp = __fadd_rn(sp, __fmul_rn(ep[i], __ldg(m.spread + i * np + pi)));
            const float lg_geo = __fmul_rn(sm.b[pend], inv);
            const float lg_arith =
                xpsy::xlog2(__fadd_rn(__fmul_rn(e, inv), c.tiny), c);
            float sfm = __fmul_rn(c.ten_log10_2, __fsub_rn(lg_geo, lg_arith));
            sfm = sfm > 0.0f ? 0.0f : sfm;             // clamp(max=0)
            float alpha = __fmul_rn(sfm, c.inv_neg60);
            alpha = alpha > 1.0f ? 1.0f : alpha;       // clamp(max=1)
            const float t1 = __fmul_rn(alpha, c.tmn_db);
            const float t2 = __fsub_rn(1.0f, alpha);
            const float off = __fadd_rn(t1, __fmul_rn(t2, c.nmt_db));
            tp = __fmul_rn(sp, xpsy::xexp2(__fmul_rn(off, c.neg_l210_10), c));
        } else {
            tp = __fmul_rn(e, c.simple_factor);
        }
        const float ath = __ldg(m.ath + pi);
        tp = tp > ath ? tp : ath;                      // torch.maximum
        sm.dens[t] = __fmul_rn(tp, inv);
    }
    __syncthreads();

    // band energies of p and of the coefficients squared
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int k = t + kThreads * j;
        const int g = k / H, kk = k % H;
        const float cv = coeffs[f * kBins + k];
        sm.a[k] = pv[j];
        sm.b[k] = __fmul_rn(cv, cv);
        start[j] = g * H + __ldg(m.band_start + kk);
    }
    __syncthreads();
    xpsy::seg_scan<kThreads, true>(sm.a, sm.b, start, m.band_stages);

    // bands: thread t = unified band g * nb + b
    const int nbf = m.nb;
    int p2 = 1;
    while (p2 < nbf) p2 <<= 1;
    if (t < G * p2) {       // the tree's zero padding
        int bb = t;
        while (bb >= p2) bb -= p2;
        if (bb >= nbf) sm.pev[t] = 0.0f;
    }
    if (t < nbu) {
        float em = 0.0f, ef = 0.0f, tf = c.big;
        if (t < G * nbf) {
            int b = t, g = 0;
            while (b >= nbf) {
                b -= nbf;
                ++g;
            }
            const int end = g * H + __ldg(m.band_ends + b);
            const float be = sm.a[end];
            em = sm.b[end];
            float mn = c.big;
            const float* dens = sm.dens + g * np;
            for (int i = 0; i < np; ++i)
                if (__ldg(m.pb + i * nbf + b)) mn = dens[i] < mn ? dens[i] : mn;
            const float width = __ldg(m.width + b);
            const float bt_v = __fmul_rn(mn, width);
            const float s = xpsy::xexp2(
                __fmul_rn(0.5f, __fsub_rn(xpsy::xlog2(__fadd_rn(be, c.tiny), c),
                                          xpsy::xlog2(__fadd_rn(bt_v, c.tiny), c))),
                c);
            sm.pev[g * p2 + b] =
                __fmul_rn(width, xpsy::xlog2(__fadd_rn(1.0f, s), c));
            ef = be;
            tf = bt_v;
        }
        float il = __fsub_rn(xpsy::xlog2(__fadd_rn(tf, c.tiny), c),
                             xpsy::xlog2(__fadd_rn(ef, c.tiny), c));
        il = il < c.log2_inv_smr_ceil ? c.log2_inv_smr_ceil : il;
        il = il > c.log2_inv_smr_floor ? c.log2_inv_smr_floor : il;
        allowed[f * nbu + t] = __fmul_rn(em, xpsy::xexp2(il, c));
        e_mdct[f * nbu + t] = em;
    }
    __syncthreads();
    if (t < G) {            // xpsy.tree_sum of the group's band terms
        float* v = sm.pev + t * p2;
        for (int h = p2 >> 1; h >= 1; h >>= 1)
            for (int i = 0; i < h; ++i) v[i] = __fadd_rn(v[i], v[i + h]);
        sm.peg[t] = v[0];
    }
    __syncthreads();
    if (t == 0) {           // xpsy.groups_pe's fold over the groups
        float s = sm.peg[0];
#pragma unroll
        for (int g = 1; g < G; ++g) s = __fadd_rn(s, sm.peg[g]);
        pe[f] = s;
    }
}

__global__ void __launch_bounds__(kThreads)
psycho_kernel(const float* __restrict__ l_re, const float* __restrict__ l_im,
              const float* __restrict__ s_re, const float* __restrict__ s_im,
              const float* __restrict__ coeffs, const int* __restrict__ bt,
              const int* __restrict__ ib_l, const float* __restrict__ fb_l,
              const int* __restrict__ ib_s, const float* __restrict__ fb_s,
              int nbu, int full, xpsy::Consts c, float* __restrict__ allowed,
              float* __restrict__ pe, float* __restrict__ e_mdct) {
    __shared__ Smem sm;
    const long long f = blockIdx.x;
    if (bt[f] == kShort)
        family<128, 8>(f, s_re, s_im, coeffs, parse(ib_s, fb_s), nbu,
                       full != 0, c, sm, allowed, pe, e_mdct);
    else
        family<1024, 1>(f, l_re, l_im, coeffs, parse(ib_l, fb_l), nbu,
                        full != 0, c, sm, allowed, pe, e_mdct);
}

}  // namespace

extern "C" {

// l_re, l_im [F, 1024], s_re, s_im [F, 8, 128] (K1's psycho outputs),
// coeffs [F, 1024] f32, bt [F] int32; ib_l, fb_l, ib_s, fb_s: the long and
// short xpsy.kernel_blobs on the card; consts [66] f32 on the host
// (xpsy.kernel_consts()); nbu the unified band count (<= 256) -> allowed
// [F, nbu], pe [F], e_mdct [F, nbu] f32. Returns cudaGetLastError() after
// the launch (0 = launched), cudaErrorInvalidValue for bad sizes.
int mrc_psycho(const float* l_re, const float* l_im, const float* s_re,
               const float* s_im, const float* coeffs, const int* bt,
               const int* ib_l, const float* fb_l, const int* ib_s,
               const float* fb_s, const float* consts, int nbu, int full,
               float* allowed, float* pe, float* e_mdct, long long n_frames,
               void* stream) {
    if (n_frames < 1 || n_frames > 0x7fffffffLL || nbu < 1 || nbu > kThreads)
        return (int)cudaErrorInvalidValue;
    xpsy::Consts c;
    float* dst = reinterpret_cast<float*>(&c);
    for (int i = 0; i < xpsy::kConsts; ++i) dst[i] = consts[i];
    psycho_kernel<<<(unsigned)n_frames, kThreads, 0, (cudaStream_t)stream>>>(
        l_re, l_im, s_re, s_im, coeffs, bt, ib_l, fb_l, ib_s, fb_s, nbu, full,
        c, allowed, pe, e_mdct);
    return (int)cudaGetLastError();
}

}  // extern "C"
