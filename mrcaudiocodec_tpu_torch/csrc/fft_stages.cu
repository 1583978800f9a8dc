// K1: the normative radix-2 DIF FFT, all stages fused, natural-order out.
//
// Replaces the Pallas TPU kernel `_stages_kernel` / `fft_classic` of
// mrcaudiocodec_tpu/ops/pallas/xmath_kernel.py (and its natural-order
// wrapper `fft_natural`): the same butterflies on the same operands, so the
// values are bitwise equal to the NumPy spec codec's FFT.
//
// Input: n_ffts independent FFTs of size N = 2^L (N in 1024, 512, 128, 64:
// psycho long, MDCT long, psycho short, MDCT short), each N contiguous
// complex values as re and im planes (f32). The wrapper's rows of 512 or
// 1024 lanes are lanes / N such FFTs side by side.
//
// Per stage with block size m (m = N, N/2, ..., 2), for each pair a
// (block-local index j = a mod m < m/2) and b = a + m/2, with w = the
// stage's twiddle j (xmath._fft_stages(N), rounded once from float64):
//   top    = a + b
//   d      = a - b
//   bottom = (d_re*w_re - d_im*w_im, d_re*w_im + d_im*w_re)
// Every op is a single correctly-rounded f32 op: written as __f*_rn
// intrinsics, and the library is built with --fmad=false, so no multiply is
// contracted into an FMA. The j = 0 twiddle (1, -0) is multiplied like any
// other: skipping it would flip signed zeros. No radix-4 algebra (a
// multiply by -i as a swap) either: that is another sequence of ops.
//
// Bound on this card: HBM bytes, 16 B per point (re and im read once and
// written once) plus the compact twiddle table, 8 (N - 1) B.
//
// Design (128 threads a block, N/8 threads an FFT, 128 / (N/8) FFTs a
// block: 1 at N=1024, 2 at 512, 8 at 128, 16 at 64; the ragged last block
// masks its loads and stores):
//  * Each thread holds 8 points in registers and runs the butterflies of
//    up to 3 consecutive stages on them: the stage bits b, b-1, b-2 of the
//    point index are the thread's 3 "owned" bits, so every pair of those
//    stages lies inside the thread. Stage groups from the top bit down:
//    L=10: {9,8,7} {6,5,4} {3,2,1} {0}; L=9: {8,7,6} {5,4,3} {2,1,0};
//    L=7: {6,5,4} {3,2,1} {0}; L=6: {5,4,3} {2,1,0}. A group of one stage
//    owns bits {2,1,0}. Between groups the block exchanges points through
//    shared memory, ping-pong between two buffers: one barrier per
//    exchange, plus one after the twiddle table is loaded. Barriers: 4 at
//    L=10, 3 at L=9 and L=7, 2 at L=6 (one per stage before: 11, 10, 8, 7).
//  * Which thread holds which points: with owned bits o..o-2, the thread's
//    index t gives the other bits: its low o-2 bits are the point's low
//    bits, its remaining bits, bit-reversed, the point's bits above o.
//    So the first group reads points t + k*N/8 straight from global memory
//    (coalesced), and in the last group (owned bits 2..0) thread t holds
//    points bitrev(t)*8 + k, whose natural-order positions are
//    bitrev3(k)*N/8 + t: the bit reversal is folded into coalesced global
//    stores, and the last exchange's shared-memory read is the
//    bit-reversed read.
//  * Shared-memory addresses are skewed, p + (p >> SKEW) (SKEW 5 at
//    L >= 9, 3 below), each FFT's plane N + N/2^SKEW words apart. Without
//    the skew the bit-reversed read has lanes bitrev(t)*8, which at N=1024
//    all fall in bank 0. With it every exchange is free of bank conflicts
//    except one 2-way exchange at L=9 and at L=7
//    (tests/test_torch_kernel_layout.py models the schedule and counts).
//  * Twiddles: one compact table of the N - 1 distinct values (stage with
//    block size m at offset N - m, index j), (re, im) interleaved, built on
//    the host from xmath._fft_stages and loaded once per block into shared
//    memory (8 KB at N=1024): one 8-byte read per twiddle.
//  * Addresses: a thread's points in a group are base | k << LO, with base
//    and k << LO on disjoint bits, so each skewed address and twiddle index
//    is a per-group value plus a compile-time offset of k: the 8 reads and
//    writes of an exchange cost no integer work beyond the first.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kThreads = 128;

template <int L>
struct Shape {
    static constexpr int N = 1 << L;
    static constexpr int TPF = N / 8;               // threads per FFT
    static constexpr int FPB = kThreads / TPF;      // FFTs per block
    static constexpr int SKEW = L >= 9 ? 5 : 3;
    static constexpr int STRIDE = N + (N >> SKEW);  // one FFT's plane
    static constexpr int PLANE = FPB * STRIDE;      // one re or im buffer
    static constexpr int GROUPS = (L + 2) / 3;
};

template <int L, int G>
struct Group {
    static constexpr int TOP = L - 1 - 3 * G;                   // first stage bit
    static constexpr int STAGES = L - 3 * G < 3 ? L - 3 * G : 3;
    static constexpr int O = TOP > 2 ? TOP : 2;                 // owned bits O..O-2
    static constexpr int LO = O - 2;
    static constexpr int NH = L - 1 - O;                        // bits above O
};

// point index of the thread's k = 0 point in group G (k adds k << LO)
template <int L, int G>
__device__ __forceinline__ int group_base(int t) {
    using Gr = Group<L, G>;
    int base = t & ((1 << Gr::LO) - 1);
    if constexpr (Gr::NH > 0)
        base |= (int)(__brev((unsigned)(t >> Gr::LO)) >> (32 - Gr::NH))
                << (Gr::O + 1);
    return base;
}

// skewed shared-memory address of point p
template <int L>
__host__ __device__ constexpr int skewed(int p) {
    return p + (p >> Shape<L>::SKEW);
}

// one stage group: read the thread's 8 points (after the first group), run
// the group's butterflies in registers, then write them for the next group
// and wait, or (last group) leave them for the store
template <int L, int G>
__device__ __forceinline__ void stage_group(float (&xr)[8], float (&xi)[8],
                                            int t, int f, float* buf,
                                            const float2* tw) {
    using S = Shape<L>;
    using Gr = Group<L, G>;
    const int base = group_base<L, G>(t);
    // skewed(base | k << LO) == skewed(base) + skewed(k << LO): disjoint bits
    const int a0 = skewed<L>(base) + f * S::STRIDE;
    if constexpr (G > 0) {
        const float* rr = buf + (((G - 1) & 1) * 2) * S::PLANE + a0;
        const float* ri = rr + S::PLANE;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            xr[k] = rr[skewed<L>(k << Gr::LO)];
            xi[k] = ri[skewed<L>(k << Gr::LO)];
        }
    }
#pragma unroll
    for (int s = 0; s < Gr::STAGES; ++s) {
        const int b = Gr::TOP - s;           // stage bit: block size 2 << b
        const int lb = b - Gr::LO;           // that bit among k's 3 bits
        const int mask = (1 << b) - 1;
        // twiddle j of this stage is (base | k << LO) & mask
        const float2* tws = tw + (S::N - (2 << b)) + (base & mask);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            if (k & (1 << lb)) continue;
            const int c = k | (1 << lb);
            const float2 w = tws[(k << Gr::LO) & mask];
            const float ar = xr[k], ai = xi[k];
            const float br = xr[c], bi = xi[c];
            const float dr = __fsub_rn(ar, br);
            const float di = __fsub_rn(ai, bi);
            xr[k] = __fadd_rn(ar, br);
            xi[k] = __fadd_rn(ai, bi);
            xr[c] = __fsub_rn(__fmul_rn(dr, w.x), __fmul_rn(di, w.y));
            xi[c] = __fadd_rn(__fmul_rn(dr, w.y), __fmul_rn(di, w.x));
        }
    }
    if constexpr (G < S::GROUPS - 1) {
        float* wr = buf + ((G & 1) * 2) * S::PLANE + a0;
        float* wi = wr + S::PLANE;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            wr[skewed<L>(k << Gr::LO)] = xr[k];
            wi[skewed<L>(k << Gr::LO)] = xi[k];
        }
        __syncthreads();
    }
}

template <int L, int... G>
__device__ __forceinline__ void all_groups(float (&xr)[8], float (&xi)[8],
                                           int t, int f, float* buf,
                                           const float2* tw,
                                           std::integer_sequence<int, G...>) {
    (stage_group<L, G>(xr, xi, t, f, buf, tw), ...);
}

template <int L>
__global__ void __launch_bounds__(kThreads)
fft_stages_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                  const float2* __restrict__ tw,
                  float* __restrict__ outr, float* __restrict__ outi,
                  long long n_ffts) {
    using S = Shape<L>;
    __shared__ float buf[4 * S::PLANE];      // [ping-pong][re, im][plane]
    __shared__ float2 s_tw[S::N - 1];
    const int f = threadIdx.x / S::TPF;
    const int t = threadIdx.x % S::TPF;
    const long long fft = (long long)blockIdx.x * S::FPB + f;
    const bool live = fft < n_ffts;
    const long long base = fft * S::N;

    // the first group's points t + k*N/8, coalesced; a masked-off FFT runs
    // on zeros and stores nothing (every thread reaches every barrier)
    float xr[8], xi[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        xr[k] = live ? zr[base + t + k * S::TPF] : 0.0f;
        xi[k] = live ? zi[base + t + k * S::TPF] : 0.0f;
    }
    for (int i = threadIdx.x; i < S::N - 1; i += kThreads) s_tw[i] = tw[i];
    __syncthreads();

    all_groups<L>(xr, xi, t, f, buf, s_tw,
                  std::make_integer_sequence<int, S::GROUPS>{});

    // thread t holds points bitrev(t)*8 + k: natural positions
    // bitrev3(k)*N/8 + t
    if (live) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const int r = ((k & 1) << 2) | (k & 2) | (k >> 2);
            outr[base + r * S::TPF + t] = xr[k];
            outi[base + r * S::TPF + t] = xi[k];
        }
    }
}

template <int L>
int launch(const float* zr, const float* zi, const float* tw, float* outr,
           float* outi, long long n_ffts, cudaStream_t stream) {
    using S = Shape<L>;
    const long long blocks = (n_ffts + S::FPB - 1) / S::FPB;
    fft_stages_kernel<L><<<(unsigned)blocks, kThreads, 0, stream>>>(
        zr, zi, reinterpret_cast<const float2*>(tw), outr, outi, n_ffts);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// zr/zi/outr/outi: n_ffts * fft_size f32 each; tw: the compact table,
// fft_size - 1 (re, im) f32 pairs, 8-byte aligned. Returns
// cudaGetLastError() after the launch (0 = launched), cudaErrorInvalidValue
// for a size the kernel does not take.
int mrc_fft_stages(const float* zr, const float* zi, const float* tw,
                   float* outr, float* outi, long long n_ffts, int fft_size,
                   void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (fft_size) {
        case 1024: return launch<10>(zr, zi, tw, outr, outi, n_ffts, s);
        case 512: return launch<9>(zr, zi, tw, outr, outi, n_ffts, s);
        case 128: return launch<7>(zr, zi, tw, outr, outi, n_ffts, s);
        case 64: return launch<6>(zr, zi, tw, outr, outi, n_ffts, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
