// K8: the psychoacoustic model after its FFTs, one warp a frame.
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
// [F, 1024] (K7's) and bt [F]; per family (long, short) the f32 blob of
// xpsy.kernel_blobs(fs, long) and the lane tables xpsy.kernel_sched(fs,
// long) on the card, and its counts (NP, nb, the scans' stages) by value;
// the constants of xpsy.kernel_consts(). Output: allowed [F, NB], pe [F],
// e_mdct [F, NB].
//
// A warp computes only the family its frame's block type selects: the
// plain version computes both and torch.where discards the other, so the
// bits are the same. Long: 1024 bins, one group; short: 8 groups of 128.
// In the torch DAG's order, every f32 op a single correctly-rounded
// __f*_rn op (--fmad=false):
//   untwist + power (xpsy.rfft_untwist_power), Z staged in the warp's rows
//   of shared memory, a lane taking bin kk and its mirror H - kk together;
//   the floor at SFM_FLOOR_REL x the group's max (max in any order is
//   exact);
//   e_part and the sum of xlog2(p + TINY) over the partitions: seg_scan
//   stage by stage on the 1024 bins in registers (scan_row), each sum the
//   value the scan leaves at its segment's end;
//   per partition (slot g * NP + i = lane + 32 q): the spreading sum in
//   masker order i = 0 .. NP-1, one multiply and one add a term, a lane's
//   ceil(G NP / 32) chains interleaved; the flatness in the log2 domain,
//   xexp2, the ATH max, the density;
//   band energies of p and of the coefficients squared on the band
//   segments (the unified layout's bands are the family's, then bands of
//   width 0, whose energy is an exact 0; the wrapper checks this);
//   per band: the min of the densities over its partition range lo .. hi
//   (pb_mask's, 1 to 4 partitions; BIG where none) x width, the PE term;
//   allowed per unified band with e_full = 0 and t_full = BIG beyond the
//   family's bands;
//   PE: xpsy.tree_sum by levels (level h adds v[i] + v[i + h], i < h)
//   over the bands padded with zeros to a power of two, then (short) the
//   fold over the 8 groups left to right.
//
// Bound on this card: HBM bytes, the selected spectrum (8 KB a frame),
// the coefficients (4 KB), allowed and e_mdct (4 NB B each) and pe; the ops
// (about 90 a bin with full psycho: two xlog2 a bin, 2 x 8 scan stages,
// the untwist) put it close to the byte time. Design: no block barrier,
// so no frame waits for another: each warp takes frames in turn
// (grid-stride) with 10.25 KB of shared memory of its own (two rows of
// the 1024 bins, a row of partition values), 10 warps a block, 2 blocks
// an SM (20 frames in flight: the 30 s chunk's 2586 in one round); the
// spreading matrix, tables and constants come through L1. A scan stage d
// < 32 adds inside a lane's registers, the first d bins' partners coming
// from lane - 1 by __shfl_up; a stage d >= 32 takes every partner from d /
// 32 lanes up; one copy of the scan serves a frame's four. Which bins take
// a stage, where segments end and each band's partition range come from
// the lane tables. The loops are kept rolled where unrolling only grows
// the code (a lone frame is ~40k cycles, mostly latency chains).

#include <cuda_runtime.h>
#include <stdint.h>

#include "xpsy_dev.cuh"

namespace {

constexpr int kWarps = 10;          // frames in flight a block
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSm = 2;     // the design's occupancy
constexpr int kBins = 1024;
constexpr int kRow = kBins + kBins / 32;   // a row of bins: a pad word a 32
constexpr int kSmall = 512;         // a warp's third row
constexpr int kWarpWords = 2 * kRow + kSmall;
constexpr int kShort = 2;           // config.SHORT
constexpr int kStages = 8;          // xpsy.SCHED_STAGES
constexpr int kBandChains = 3;      // unified bands a lane: NB <= 96
constexpr unsigned kAll = 0xffffffffu;
// xpsy.kernel_sched's offsets (then part_end [NP], band_end, lo, hi [nb])
constexpr int kPartTake = 0, kBandTake = 256, kEnds = 512;
// the third row: partition sums (then the PE terms), densities
constexpr int kEp = 0, kPe = 0, kDens = 256;

struct Family {
    int npart, nb, part_stages, band_stages, p2, part_magic, band_magic;
    int hbits, groups;              // H = 2^hbits bins a group
    const float *cr, *ci, *spread, *inv, *ath, *width;
    const int* sched;
};

// bin k's word in a row: lane l's bins 32 l .. 32 l + 31 lie at 33 l ..
// 33 l + 31, so reads by lane and by bin (k = l + 32 i) are both free of
// bank conflicts
__device__ __forceinline__ int pad(int k) { return k + (k >> 5); }

// One stage of xpsy.seg_scan over 1024 bins in a warp's registers (lane
// l's bins 32 l + j in a[j]): p[k] = p[k] + p[k - D] where bit j of m says
// bin k - D lies in k's segment, every add on the previous stage's
// values: the partners from other lanes are read first (D < 32: lane -
// 1's last D bins by __shfl_up 1; D >= 32: the same bin D / 32 lanes up),
// and in a lane j runs down.
// v where bit j of m is set, else +0 (the bits ANDed with 0): every value a
// scan sees is a sum of squares, of their xlog2 or of such sums, never -0,
// so x + +0 == x bit for bit and adding the kept partner is seg_scan's
// `torch.where(mask, p + sh, p)`; a predicated add a bin would exhaust
// ptxas's 7 predicate registers
__device__ __forceinline__ float keep(float v, unsigned m, int j) {
    const int mask = (int)(m << (31 - j)) >> 31;       // bit j: 0 or ~0
    return __int_as_float(__float_as_int(v) & mask);
}

template <int D>
__device__ __forceinline__ void scan_stage(float (&a)[32], unsigned m) {
    if (D < 32) {
        constexpr int U = D < 32 ? D : 1;
        float ua[U];
#pragma unroll
        for (int j = 0; j < U; ++j)
            ua[j] = __shfl_up_sync(kAll, a[32 - U + j], 1);
#pragma unroll
        for (int j = 31; j >= U; --j)
            a[j] = __fadd_rn(a[j], keep(a[j - U], m, j));
#pragma unroll
        for (int j = 0; j < U; ++j) a[j] = __fadd_rn(a[j], keep(ua[j], m, j));
    } else {
#pragma unroll
        for (int j = 0; j < 32; ++j)
            a[j] = __fadd_rn(a[j], keep(__shfl_up_sync(kAll, a[j], D / 32),
                                        m, j));
    }
}

// xpsy.seg_scan of the row src into the row dst (either may be the
// other): the family's first `stages` stages, d = 1, 2, 4, ..., in
// registers; take[st * 32 + lane] is stage st's mask (xpsy.kernel_sched).
// One copy for the four scans of a frame. The caller syncs the warp after
// the last writes of src and the last reads of dst; ends with a sync.
__device__ __noinline__ void scan_row(float* dst, const float* src,
                                      const int* __restrict__ take,
                                      int stages) {
    const int lane = threadIdx.x & 31;
    unsigned m[kStages];
#pragma unroll
    for (int st = 0; st < kStages; ++st)
        m[st] = st < stages ? (unsigned)__ldg(take + st * 32 + lane) : 0u;
    float a[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) a[j] = src[33 * lane + j];
    if (stages > 0) scan_stage<1>(a, m[0]);
    if (stages > 1) scan_stage<2>(a, m[1]);
    if (stages > 2) scan_stage<4>(a, m[2]);
    if (stages > 3) scan_stage<8>(a, m[3]);
    if (stages > 4) scan_stage<16>(a, m[4]);
    if (stages > 5) scan_stage<32>(a, m[5]);
    if (stages > 6) scan_stage<64>(a, m[6]);
    if (stages > 7) scan_stage<128>(a, m[7]);
#pragma unroll
    for (int j = 0; j < 32; ++j) dst[33 * lane + j] = a[j];
    __syncwarp();
}

// xpsy.rfft_untwist_power of bin kk from Z[kk] and Z[-kk] (z, b)
__device__ __forceinline__ float untwist(float z_r, float z_i, float br,
                                         float bi, float cr, float ci) {
    const float a_re = __fmul_rn(__fadd_rn(z_r, br), 0.5f);
    const float a_im = __fmul_rn(__fsub_rn(z_i, bi), 0.5f);
    const float b_re = __fmul_rn(__fadd_rn(z_i, bi), 0.5f);
    const float b_im = __fmul_rn(__fsub_rn(br, z_r), 0.5f);
    const float x_re = __fadd_rn(a_re, __fsub_rn(__fmul_rn(b_re, cr),
                                                 __fmul_rn(b_im, ci)));
    const float x_im = __fadd_rn(a_im, __fadd_rn(__fmul_rn(b_re, ci),
                                                 __fmul_rn(b_im, cr)));
    return __fadd_rn(__fmul_rn(x_re, x_re), __fmul_rn(x_im, x_im));
}

// 1024 f32 from global memory to a row, 16 B a lane a load, all in
// flight at once and marked evict-first (they are read once; the tables
// stay in L1); `sq` squares them (the coefficients)
__device__ __forceinline__ void stage_row(float* row, const float* src,
                                          bool sq, int lane) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4 q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) q[i] = __ldcs(s4 + lane + 32 * i);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        if (sq) {
            q[i].x = __fmul_rn(q[i].x, q[i].x);
            q[i].y = __fmul_rn(q[i].y, q[i].y);
            q[i].z = __fmul_rn(q[i].z, q[i].z);
            q[i].w = __fmul_rn(q[i].w, q[i].w);
        }
        float* r = row + pad(4 * (lane + 32 * i));
        r[0] = q[i].x, r[1] = q[i].y, r[2] = q[i].z, r[3] = q[i].w;
    }
}

// the partitions of slots s = lane + 32 q (s = g * NP + i): the spreading
// sum in masker order, NCP chains interleaved, then the flatness, xexp2
// and the ATH max -> the densities to dens[s]; ep the partition sums, lg
// the row of xlog2 sums (read at the partition ends)
template <int NCP>
__device__ __forceinline__ void partitions(const Family& m, const float* ep,
                                           const float* lg, float* dens,
                                           int G, bool full,
                                           const xpsy::Consts& c, int lane) {
    const int np = m.npart, nslots = G * np;
    const int* ends = m.sched + kEnds;
    const float* S = m.spread;
    float sp[NCP];
    if (full) {
        int eo[NCP], so[NCP];
#pragma unroll
        for (int q = 0; q < NCP; ++q) {
            const int s = lane + 32 * q;
            const int s2 = s < nslots ? s : 0;
            const int g = G == 1 ? 0 : (s2 * m.part_magic) >> 16;  // s2 / np
            eo[q] = g * np;
            so[q] = s2 - g * np;
        }
#pragma unroll
        for (int q = 0; q < NCP; ++q)
            sp[q] = __fmul_rn(ep[eo[q]], __ldg(S + so[q]));
#pragma unroll 5
        for (int i = 1; i < np; ++i) {
            const float* row = S + i * np;
#pragma unroll
            for (int q = 0; q < NCP; ++q)
                sp[q] = __fadd_rn(sp[q], __fmul_rn(ep[eo[q] + i],
                                                   __ldg(row + so[q])));
        }
    }
#pragma unroll 1
    for (int q = 0; q < NCP; ++q) {
        const int s = lane + 32 * q;
        if (s >= nslots) break;
        const int g = G == 1 ? 0 : (s * m.part_magic) >> 16;
        const int pi = s - g * np;
        const float e = ep[s];
        const float inv = __ldg(m.inv + pi);
        float tp;
        if (full) {
            const float lsum = lg[pad((g << m.hbits) + __ldg(ends + pi))];
            const float lg_geo = __fmul_rn(lsum, inv);
            const float lg_arith =
                xpsy::xlog2(__fadd_rn(__fmul_rn(e, inv), c.tiny), c);
            float sfm = __fmul_rn(c.ten_log10_2, __fsub_rn(lg_geo, lg_arith));
            sfm = sfm > 0.0f ? 0.0f : sfm;             // clamp(max=0)
            float alpha = __fmul_rn(sfm, c.inv_neg60);
            alpha = alpha > 1.0f ? 1.0f : alpha;       // clamp(max=1)
            const float t1 = __fmul_rn(alpha, c.tmn_db);
            const float t2 = __fsub_rn(1.0f, alpha);
            const float off = __fadd_rn(t1, __fmul_rn(t2, c.nmt_db));
            float spq = sp[0];
#pragma unroll
            for (int r = 1; r < NCP; ++r) spq = q == r ? sp[r] : spq;
            tp = __fmul_rn(spq, xpsy::xexp2(__fmul_rn(off, c.neg_l210_10), c));
        } else {
            tp = __fmul_rn(e, c.simple_factor);
        }
        const float ath = __ldg(m.ath + pi);
        tp = tp > ath ? tp : ath;                      // torch.maximum
        dens[s] = __fmul_rn(tp, inv);
    }
}

// one frame on one warp; rows A, B [kRow] and C [kSmall] of shared memory
__device__ __forceinline__ void frame(long long f, const float* __restrict__ zr,
                                      const float* __restrict__ zi,
                                      const float* __restrict__ coeffs,
                                      const Family& m, float* A, float* B,
                                      float* C, int nbu,
                                      bool full, const xpsy::Consts& c,
                                      int lane, float* __restrict__ allowed,
                                      float* __restrict__ pe,
                                      float* __restrict__ e_mdct) {
    const int hb = m.hbits, H = 1 << hb, half = H >> 1, G = m.groups;
    const int* sc = m.sched;
    stage_row(A, zr + f * kBins, false, lane);
    stage_row(B, zi + f * kBins, false, lane);
    __syncwarp();
    // power spectrum, xpsy.rfft_untwist_power: a lane takes bin kk and its
    // mirror H - kk of a group together (they read each other's Z), so it
    // writes both powers over Z with no other lane between; unit u = lane
    // + 32 i (G H / 2 = 512 of them), then each group's middle bin H / 2,
    // its own mirror
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
        const int u = lane + 32 * i;
        const int g = u >> (hb - 1), kk = u & (half - 1);
        const int k1 = pad((g << hb) + kk);
        const int k2 = pad((g << hb) + (kk == 0 ? 0 : H - kk));
        const float zr1 = A[k1], zi1 = B[k1], zr2 = A[k2], zi2 = B[k2];
        const float p1 = untwist(zr1, zi1, zr2, zi2, __ldg(m.cr + kk),
                                 __ldg(m.ci + kk));
        if (kk != 0)
            A[k2] = untwist(zr2, zi2, zr1, zi1, __ldg(m.cr + H - kk),
                            __ldg(m.ci + H - kk));
        A[k1] = p1;
    }
    if (lane < G) {
        const int k = pad((lane << hb) + half);
        A[k] = untwist(A[k], B[k], A[k], B[k], __ldg(m.cr + half),
                       __ldg(m.ci + half));
    }
    __syncwarp();
    // the floor at SFM_FLOOR_REL x the group's max (lane l: bins l + 32 t)
    const int per = H >> 5;
#pragma unroll 1
    for (int g = 0; g < G; ++g) {
        float* grp = A + pad((g << hb) + lane);
        float mx = grp[0];
#pragma unroll 4
        for (int t = 1; t < per; ++t) mx = fmaxf(mx, grp[33 * t]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, o));
        const float fl = __fmul_rn(c.sfm_floor_rel, mx);
#pragma unroll 4
        for (int t = 0; t < per; ++t) {
            const float v = grp[33 * t];
            grp[33 * t] = v > fl ? v : fl;             // torch.maximum
        }
    }
    __syncwarp();

    // partition sums of p to C, then (full) of xlog2(p + TINY) in row B
    const int np = m.npart;
    scan_row(B, A, sc + kPartTake, m.part_stages);
    for (int s = lane; s < G * np; s += 32) {
        const int g = G == 1 ? 0 : (s * m.part_magic) >> 16;
        C[kEp + s] = B[pad((g << hb) + __ldg(sc + kEnds + s - g * np))];
    }
    __syncwarp();
    if (full) {
#pragma unroll 4
        for (int j = 0; j < 32; ++j)
            B[33 * lane + j] =
                xpsy::xlog2(__fadd_rn(A[33 * lane + j], c.tiny), c);
        scan_row(B, B, sc + kPartTake, m.part_stages);
    }
    if (G == 1)
        partitions<3>(m, C + kEp, B, C + kDens, 1, full, c, lane);
    else
        partitions<6>(m, C + kEp, B, C + kDens, G, full, c, lane);
    __syncwarp();

    // band sums of p (row B) and of the coefficients squared (row A)
    scan_row(B, A, sc + kBandTake, m.band_stages);
    stage_row(A, coeffs + f * kBins, true, lane);
    __syncwarp();
    scan_row(A, A, sc + kBandTake, m.band_stages);
    const int nbf = m.nb, p2 = m.p2;
    const int* bend = sc + kEnds + np;
    const int* blo = bend + nbf;
    const int* bhi = blo + nbf;
    float* pev = C + kPe;
    for (int i = lane; i < G * p2; i += 32)     // the tree's zero padding
        if ((i & (p2 - 1)) >= nbf) pev[i] = 0.0f;
    // unified bands t = lane + 32 q
#pragma unroll 1
    for (int q = 0; q < kBandChains; ++q) {
        const int t = lane + 32 * q;
        if (t >= nbu) break;
        float em = 0.0f, ef = 0.0f, tf = c.big;
        if (t < G * nbf) {
            const int g = G == 1 ? 0 : (t * m.band_magic) >> 16;   // t / nb
            const int b = t - g * nbf;
            const int end = pad((g << hb) + __ldg(bend + b));
            const float bev = B[end];
            em = A[end];
            const float* d = C + kDens + g * np;
            float mn = c.big;
            for (int i = __ldg(blo + b), hi = __ldg(bhi + b); i <= hi; ++i)
                mn = d[i] < mn ? d[i] : mn;
            const float width = __ldg(m.width + b);
            const float bt_v = __fmul_rn(mn, width);
            const float s = xpsy::xexp2(
                __fmul_rn(0.5f, __fsub_rn(xpsy::xlog2(__fadd_rn(bev, c.tiny), c),
                                          xpsy::xlog2(__fadd_rn(bt_v, c.tiny), c))),
                c);
            pev[g * p2 + b] =
                __fmul_rn(width, xpsy::xlog2(__fadd_rn(1.0f, s), c));
            ef = bev;
            tf = bt_v;
        }
        float il = __fsub_rn(xpsy::xlog2(__fadd_rn(tf, c.tiny), c),
                             xpsy::xlog2(__fadd_rn(ef, c.tiny), c));
        il = il < c.log2_inv_smr_ceil ? c.log2_inv_smr_ceil : il;
        il = il > c.log2_inv_smr_floor ? c.log2_inv_smr_floor : il;
        allowed[f * nbu + t] = __fmul_rn(em, xpsy::xexp2(il, c));
        e_mdct[f * nbu + t] = em;
    }
    __syncwarp();
    // xpsy.tree_sum of each group's terms by levels: v[i] + v[i + h], i < h
    for (int h = p2 >> 1; h >= 1; h >>= 1) {
        const int lh = __ffs(h) - 1;
        for (int i = lane; i < G * h; i += 32) {
            const int k = ((i >> lh) * p2) + (i & (h - 1));
            pev[k] = __fadd_rn(pev[k], pev[k + h]);
        }
        __syncwarp();
    }
    if (lane == 0) {        // xpsy.groups_pe's fold over the groups
        float s = pev[0];
        for (int g = 1; g < G; ++g) s = __fadd_rn(s, pev[g * p2]);
        pe[f] = s;
    }
    __syncwarp();           // the rows are the next frame's
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
psycho_kernel(const float* __restrict__ l_re, const float* __restrict__ l_im,
              const float* __restrict__ s_re, const float* __restrict__ s_im,
              const float* __restrict__ coeffs, const int* __restrict__ bt,
              Family fl, Family fs, int nbu, int full, xpsy::Consts c,
              float* __restrict__ allowed, float* __restrict__ pe,
              float* __restrict__ e_mdct, long long n_frames) {
    extern __shared__ float smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* A = smem + warp * kWarpWords;
    float* B = A + kRow;
    float* C = B + kRow;
    for (long long f = (long long)blockIdx.x * kWarps + warp; f < n_frames;
         f += (long long)gridDim.x * kWarps) {
        const bool sh = bt[f] == kShort;
        frame(f, sh ? s_re : l_re, sh ? s_im : l_im, coeffs, sh ? fs : fl, A,
              B, C, nbu, full != 0, c, lane, allowed, pe, e_mdct);
    }
}

constexpr int kSmem = sizeof(float) * kWarps * kWarpWords;   // > 48 KB

// blocks of the kernel one SM of the current card holds, after raising
// the kernel's dynamic shared-memory limit; -1 on a CUDA error
int blocks_per_sm() {
    if (cudaFuncSetAttribute(psycho_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem) != cudaSuccess)
        return -1;
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, psycho_kernel,
                                                      kThreads, kSmem)
        != cudaSuccess)
        return -1;
    return n;
}

}  // namespace

extern "C" {

// Warps a block, dynamic shared memory (bytes) a block and blocks an SM
// of the current card; returns 0, or a CUDA error.
int mrc_psycho_occupancy(int* warps, int* smem, int* blocks) {
    *warps = kWarps;
    *smem = kSmem;
    *blocks = blocks_per_sm();
    return *blocks < 0 ? (int)cudaGetLastError() : 0;
}

// l_re, l_im [F, 1024], s_re, s_im [F, 8, 128] (K1's psycho outputs),
// coeffs [F, 1024] f32 (each 16-byte aligned), bt [F] int32; fb_l, fb_s
// the long and short f32 xpsy.kernel_blobs and sched_l, sched_s their
// xpsy.kernel_sched, on the card; dims [8] int32 on the host: NP, nb,
// partition stages, band stages of the long family, then of the short
// (the i32 blobs' header); consts
// [66] f32 on the host (xpsy.kernel_consts()); nbu the unified band count
// (<= 96) -> allowed [F, nbu], pe [F], e_mdct [F, nbu] f32. Returns
// cudaGetLastError() after the launch (0 = launched),
// cudaErrorInvalidValue for sizes the kernel does not take.
int mrc_psycho(const float* l_re, const float* l_im, const float* s_re,
               const float* s_im, const float* coeffs, const int* bt,
               const float* fb_l, const float* fb_s, const int* sched_l,
               const int* sched_s, const int* dims, const float* consts,
               int nbu, int full, float* allowed, float* pe, float* e_mdct,
               long long n_frames, void* stream) {
    if (n_frames < 1 || nbu < 1 || nbu > 32 * kBandChains)
        return (int)cudaErrorInvalidValue;
    Family fam[2];
    const float* blobs[2] = {fb_l, fb_s};
    const int* scheds[2] = {sched_l, sched_s};
    for (int i = 0; i < 2; ++i) {
        const int h = i == 0 ? kBins : kBins / 8, groups = i == 0 ? 1 : 8;
        Family& m = fam[i];
        m.npart = dims[4 * i];
        m.nb = dims[4 * i + 1];
        m.part_stages = dims[4 * i + 2];
        m.band_stages = dims[4 * i + 3];
        m.p2 = 1;
        while (m.p2 < m.nb) m.p2 <<= 1;
        if (m.npart < 1 || m.nb < 1 || groups * m.npart > (i == 0 ? 96 : 192)
            || groups * m.nb > 128 || groups * m.p2 > 128
            || m.part_stages > kStages || m.band_stages > kStages)
            return (int)cudaErrorInvalidValue;
        m.hbits = i == 0 ? 10 : 7;
        m.groups = groups;
        m.part_magic = (65536 + m.npart - 1) / m.npart;
        m.band_magic = (65536 + m.nb - 1) / m.nb;
        m.cr = blobs[i] + 2 * h;    // past the hann window (K6's)
        m.ci = m.cr + h;
        m.spread = m.ci + h;
        m.inv = m.spread + m.npart * m.npart;
        m.ath = m.inv + m.npart;
        m.width = m.ath + m.npart;
        m.sched = scheds[i];
    }
    xpsy::Consts c;
    float* dst = reinterpret_cast<float*>(&c);
    for (int i = 0; i < xpsy::kConsts; ++i) dst[i] = consts[i];
    // the grid: every frame a warp, at most the blocks the card holds at
    // once (cached for the current card)
    static int cached_dev = -1, cached_grid = 0;
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev != cached_dev) {
        int sms = 0;
        const int per = blocks_per_sm();
        if (per < 1 || cudaDeviceGetAttribute(&sms,
                                              cudaDevAttrMultiProcessorCount,
                                              dev) != cudaSuccess)
            return per < 0 ? (int)cudaGetLastError()
                           : (int)cudaErrorInvalidConfiguration;
        cached_grid = per * sms;
        cached_dev = dev;
    }
    const long long want = (n_frames + kWarps - 1) / kWarps;
    const unsigned grid = (unsigned)(want < cached_grid ? want : cached_grid);
    psycho_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
        l_re, l_im, s_re, s_im, coeffs, bt, fam[0], fam[1], nbu, full, c,
        allowed, pe, e_mdct, n_frames);
    return (int)cudaGetLastError();
}

}  // extern "C"
