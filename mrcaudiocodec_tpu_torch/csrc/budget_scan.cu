// K12: every row's bit-reservoir budgets in one launch, a block a row.
//
// Replaces no TPU kernel: the JAX package runs this scan as
// `lax.associative_scan` over the clamped-add maps
// (mrcaudiocodec_tpu/ops/reservoir.py), which XLA fuses. The port ran it
// as a Hillis-Steele scan of torch ops (ops/reservoir.py scan_maps: about
// 134 launches and 100 slices a clip request, on a few KB of data), which
// is now the CPU path and the plain version of the sharded path. The plain
// version of this kernel's decomposition is
// ops/kernels/budget_scan.budget_scan_plain.
//
// Input: pe [R, F] float32, nf_row [R] int64 or null (every row F frames),
// mean_bits, lo, hi, cap (host ints, all >= 0; lo and hi from
// reservoir.desired_bounds). Output: budget [R, F] int64, for each row:
//   pe_q[f]   = floor(clamp(pe[f], 0, 65535)), 0 where f >= nf
//   mean_pe   = max(1, sum(pe_q) / nf)
//   desired   = clamp(mean_bits * pe_q[f] / mean_pe, lo, hi)
//   budget[f] = min(desired[f], mean_bits + r[f]),
//   r[0] = 0,  r[f + 1] = min(cap, max(0, r[f] + mean_bits - desired[f]))
// Every operand is non-negative, so each / is the floor division of the
// torch code. A NaN PE is outside the contract (the analysis gives none).
//
// Design: a block of 512 threads takes a row; thread t takes the run of
// frames [t * run, (t + 1) * run), run = ceil(F / 512).
//  (a) Each thread quantizes and masks its run and sums it in int64; a warp
//      shuffle, then every thread adds the 16 warp sums in one order.
//  (b) Each thread composes its run's clamped-add maps
//      r -> min(hi, max(lo, r + a)) in frame order.
//  (c) A block-wide exclusive scan of the threads' maps: an inclusive
//      shuffle scan in each warp, the warps' totals through shared memory,
//      each thread applying the totals of the warps before its own to 0
//      and then its lane's exclusive map. Composition is associative and
//      the arithmetic exact, so any tree gives the spec's levels.
//  (d) Each thread replays its run from its entering level and writes the
//      budgets.
// Integer work only, and no C division by a variable: nvcc builds that
// from a float reciprocal and a truncating F2I.FTZ. The quantization reads
// the float's bits (for a non-negative float the order of its bits is the
// order of its values), and each division is a multiply-high by a
// reciprocal that a restoring division computes once a row, then one
// correction. So the library holds no float instruction: no FFMA, no .FTZ.
//
// Bound on this card: latency, not bytes or operations. A row's data is 12
// bytes a frame (31 KB for the 30 s clip's [2, 1293]); its HBM time is
// nanoseconds. The record is one launch a request in place of ~134, and
// its device time: aimed at <= 0.02 ms at [2, 1293] and [128, 448], and
// <= 0.05 ms at [2, 12920].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr long long kInf = 1LL << 62;        // the identity map's bounds

struct Map {                                  // r -> min(hi, max(lo, r + a))
    long long a, lo, hi;
};

__device__ __forceinline__ Map compose(const Map& f, const Map& g) {
    // f first, then g
    return {f.a + g.a, min(g.hi, max(g.lo, f.lo + g.a)),
            min(g.hi, max(g.lo, f.hi + g.a))};
}

__device__ __forceinline__ long long apply(const Map& m, long long r) {
    return min(m.hi, max(m.lo, r + m.a));
}

__device__ __forceinline__ Map shfl_up(const Map& m, int d) {
    return {__shfl_up_sync(0xffffffffu, m.a, d),
            __shfl_up_sync(0xffffffffu, m.lo, d),
            __shfl_up_sync(0xffffffffu, m.hi, d)};
}

// floor(clamp(x, 0, 65535)) from x's bits
__device__ __forceinline__ long long quantize(float x) {
    const uint32_t u = __float_as_uint(x);
    if (u >> 31)                   // negative or -0
        return 0;
    if (u >= 0x477FFF00u)          // >= 65535.0f, +inf
        return 65535;
    if (u < 0x3F800000u)           // [0, 1)
        return 0;
    const int e = (int)(u >> 23) - 127;                // 0 .. 15
    return (long long)(((u & 0x7FFFFFu) | 0x800000u) >> (23 - e));
}

// n / d by restoring division, a bit at a time (d >= 1, d < 2^63)
__device__ __forceinline__ unsigned long long div_bits(unsigned long long n,
                                                       unsigned long long d) {
    unsigned long long q = 0, r = 0;
#pragma unroll 1
    for (int i = 63; i >= 0; --i) {
        r = (r << 1) | ((n >> i) & 1ull);
        q <<= 1;
        if (r >= d) {
            r -= d;
            q |= 1ull;
        }
    }
    return q;
}

struct Divider {                 // n / d as a multiply-high by m
    unsigned long long d, m;     // m = floor((2^64 - 1) / d)
};

// floor(n / d) for n < 2^63: q = mulhi(n, m) is q_exact or q_exact - 1
__device__ __forceinline__ long long divide(long long n, const Divider& v) {
    const unsigned long long un = (unsigned long long)n;
    unsigned long long q = __umul64hi(un, v.m);
    if (un - q * v.d >= v.d)
        ++q;
    return (long long)q;
}

__global__ void __launch_bounds__(kThreads)
budget_scan_kernel(const float* __restrict__ pe,
                   const long long* __restrict__ nf_row,
                   long long* __restrict__ out, int frames, int run,
                   long long mean_bits, long long lo, long long hi,
                   long long cap) {
    __shared__ long long s_sum[kWarps];
    __shared__ Map s_map[kWarps];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const float* p = pe + (long long)blockIdx.x * frames;
    long long* o = out + (long long)blockIdx.x * frames;
    const long long nf = nf_row ? __ldg(nf_row + blockIdx.x)
                                : (long long)frames;
    const long long f0 = (long long)t * run;
    const long long f1 = min((long long)frames, f0 + run);
    const long long fq = min(f1, nf);    // frames of the run that count

    // (a) the row's PE sum
    long long sum = 0;
    for (long long f = f0; f < fq; ++f)
        sum += quantize(__ldg(p + f));
#pragma unroll
    for (int d = 16; d; d >>= 1)
        sum += __shfl_down_sync(0xffffffffu, sum, d);
    if (lane == 0)
        s_sum[warp] = sum;
    __syncthreads();
    long long total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
        total += s_sum[w];
    long long mean_pe = (long long)div_bits(
        (unsigned long long)total, nf > 1 ? (unsigned long long)nf : 1ull);
    mean_pe = mean_pe > 1 ? mean_pe : 1;
    const Divider dm = {(unsigned long long)mean_pe,
                        div_bits(~0ull, (unsigned long long)mean_pe)};

    // (b) the run's map
    Map m = {0, -kInf, kInf};
    for (long long f = f0; f < f1; ++f) {
        const long long q = f < nf ? quantize(__ldg(p + f)) : 0;
        const long long want = min(hi, max(lo, divide(mean_bits * q, dm)));
        m = compose(m, {mean_bits - want, 0, cap});
    }

    // (c) the level entering the run
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const Map u = shfl_up(m, d);
        if (lane >= d)
            m = compose(u, m);
    }
    const Map before = shfl_up(m, 1);    // lane - 1's inclusive map
    if (lane == 31)
        s_map[warp] = m;
    __syncthreads();
    long long r = 0;
    for (int w = 0; w < warp; ++w)
        r = apply(s_map[w], r);
    if (lane > 0)
        r = apply(before, r);

    // (d) the budgets
    for (long long f = f0; f < f1; ++f) {
        const long long q = f < nf ? quantize(__ldg(p + f)) : 0;
        const long long want = min(hi, max(lo, divide(mean_bits * q, dm)));
        o[f] = min(want, mean_bits + r);
        r = min(cap, max(0LL, r + mean_bits - want));
    }
}

}  // namespace

extern "C" {

// pe [rows, frames] float32, nf_row [rows] int64 or null, out [rows,
// frames] int64; run = ceil(frames / 512); mean_bits, lo, hi, cap >= 0.
// Returns cudaGetLastError() after the launch (0 = launched),
// cudaErrorInvalidValue for bad sizes.
int mrc_budget_scan(const float* pe, const long long* nf_row, long long* out,
                    int rows, int frames, int run, long long mean_bits,
                    long long lo, long long hi, long long cap, void* stream) {
    if (rows < 1 || frames < 1 || run < 1
        || (long long)run * kThreads < frames
        || (long long)(run - 1) * kThreads >= frames
        || mean_bits < 0 || lo < 0 || hi < 0 || cap < 0)
        return (int)cudaErrorInvalidValue;
    budget_scan_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
        pe, nf_row, out, frames, run, mean_bits, lo, hi, cap);
    return (int)cudaGetLastError();
}

}  // extern "C"
