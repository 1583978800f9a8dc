// K3: MRC1 record bytes from the encoder's decisions.
//
// Replaces the record packing that the JAX package leaves to XLA
// (mrcaudiocodec_tpu/ops/device_pack.py: `_slots`, `_assemble_bytes`,
// `pack_records_device`). It has no Pallas counterpart. The JAX byte
// assembly is a broadcast-compare-reduce of every slot against every byte,
// about 2.7e9 compare elements for a 30 s stereo clip; here each record is
// one thread block that writes each slot's bits once.
//
// A record (models/packing.py of the JAX package, mrc_native.cpp) is, MSB
// first within each byte:
//   20-bit content length | block type (3) | gain (8)
//   | a 2-bit codebook id per real band | a scale-factor delta codeword per
//   real band | per pair of bins: main codeword | sign a | sign b
//   | escape a | escape b | zero bits up to the byte boundary.
// CB_SMALL codes a 4-tuple on the even pair only; CB_MID a pair clipped to
// [-4, 4]; CB_ESC the magnitudes clipped at 16, a sign bit per nonzero bin
// and, for a magnitude m >= 16 with e = floor(log2 m), (e - 4) ones, a zero
// and the e low bits of m, 2e - 3 bits in all. Bins follow the unified band
// layout, so band order is bin order and no 4-tuple straddles a band.
// nbytes = (20 + content + 7) / 8. Domain: |q| <= QMAX (4095), the
// quantizer's clamp, so every slot holds at most 20 bits and spans at most
// 4 bytes.
//
// Design (simple first; one block of 128 threads per record):
//  1. The block zeroes a shared buffer of cap bytes (32-bit words).
//  2. Thread t < nb takes band t's codebook id and scale-factor codeword;
//     thread t takes pairs 4t .. 4t+3 (bins 8t .. 8t+7, one 16-byte load of
//     q), 20 slots. Codewords come from one merged table, code | len << 24.
//  3. Two block-wide exclusive scans (warp __shfl_up_sync, then the four
//     warp totals through shared memory) give each thread the first bit of
//     its slots: one over the bands' (cb, sf) lengths packed in one int,
//     one over the pairs' lengths.
//  4. Each slot ORs its bits into the buffer with atomicOr on 32-bit shared
//     words, at most two words a slot (little-endian words: byte j sits at
//     shift 8 * (j & 3)). Slots never share a bit, so the order of the ORs
//     does not matter and the bytes are exact. Zero-length slots write
//     nothing; shifts stay in [0, 31].
//  5. A byte-wise coalesced copy to rec[r, 0:cap], and nbytes[r]. A record
//     longer than cap writes only its first cap bytes; the wrapper raises
//     when max(nbytes) > cap, so a truncated record never reaches a stream.
// No integer division (a division by a variable compiles to a float
// reciprocal with .FTZ, see chip_smoke.py's SASS audit).
//
// Bound on this card: bytes. Per record q 2048 B, amp and cb nb B each,
// gain 2 B and bt 1 B in; cap B of record and 4 B of nbytes out. A 30 s
// stereo encode (2586 records, cap 376) moves about 6.8 MB, 2 us at
// 3.35 TB/s. What this simple form spends instead: per record two block
// barriers of the scans, a dependent chain of loads (band -> codebook id
// -> codeword) and shared-memory atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCoeffs = 1024;
constexpr int kPairs = kCoeffs / 2;
constexpr int kNbMax = kThreads;         // thread t owns band t
constexpr int kHeadBits = 20 + 3 + 8;    // prefix, block type, gain
constexpr int kMaxCapBytes = 32 * 1024;  // under the 48 KB default
// offsets of the four codebooks in the merged table (code | len << 24)
constexpr int kSmall = 0, kMid = 81, kEsc = 162, kSf = 451;
constexpr int kEscMag = 16, kSfDeltaMax = 60;

__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    int base = 0, sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        const int s = warp_sums[w];
        base += w < warp ? s : 0;
        sum += s;
    }
    __syncthreads();                     // warp_sums is reused
    *total = sum;
    return base + x - v;
}

// OR `len` bits of `code` (MSB first) into the byte stream at bit `off`;
// bytes at or past `cap` are dropped (the wrapper raises for them).
__device__ __forceinline__ void put_bits(unsigned* words, int off,
                                         unsigned code, int len, int cap) {
    if (len <= 0) return;
    code &= len < 32 ? (1u << len) - 1u : 0xffffffffu;
    const int end = off + len;
    const int j0 = off >> 3, j1 = (end - 1) >> 3;
    int w = j0 >> 2;
    unsigned acc = 0u;
    for (int j = j0; j <= j1 && j < cap; ++j) {
        const int sh = end - 8 * (j + 1);        // in [-7, 24]
        const unsigned v = (sh >= 0 ? code >> sh : code << -sh) & 255u;
        if ((j >> 2) != w) {
            atomicOr(&words[w], acc);
            acc = 0u;
            w = j >> 2;
        }
        acc |= v << (8 * (j & 3));
    }
    if (acc) atomicOr(&words[w], acc);
}

__device__ __forceinline__ void lookup(const int* __restrict__ codes, int i,
                                       unsigned& code, int& len) {
    const int e = __ldg(codes + i);
    code = (unsigned)e & 0xffffffu;
    len = e >> 24;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads) record_pack_kernel(
        const int16_t* __restrict__ q, const int8_t* __restrict__ amp,
        const int16_t* __restrict__ gain, const int8_t* __restrict__ bt,
        const int8_t* __restrict__ cb, const int* __restrict__ codes,
        const int* __restrict__ pair_band, const int* __restrict__ width,
        uint8_t* __restrict__ rec, int* __restrict__ nbytes, int nb,
        int cap) {
    extern __shared__ unsigned words[];
    __shared__ int warp_sums[kWarps];
    const int t = threadIdx.x;
    const long long r = blockIdx.x;
    const int n_words = (cap + 3) >> 2;
    for (int i = t; i < n_words; i += kThreads) words[i] = 0u;

    const int b_t = bt[r];
    const int8_t* cb_r = cb + r * nb;
    const int8_t* amp_r = amp + r * nb;
    const int* width_r = width + b_t * nb;

    // band t: codebook id and scale-factor delta (previous band's amp, 0
    // where that band is not real)
    unsigned cb_code = 0u, sf_code = 0u;
    int cb_len = 0, sf_len = 0;
    if (t < nb && width_r[t] > 0) {
        cb_code = (unsigned)cb_r[t];
        cb_len = 2;
        const int a = amp_r[t];
        const int prev = (t > 0 && width_r[t - 1] > 0) ? amp_r[t - 1] : 0;
        lookup(codes, kSf + prev - a + kSfDeltaMax, sf_code, sf_len);
    }
    int band_total;
    const int band_excl = block_exclusive_scan(cb_len | (sf_len << 16),
                                               warp_sums, &band_total);
    const int cb_total = band_total & 0xffff;
    const int sf_total = band_total >> 16;

    // pairs 4t .. 4t+3: one 16-byte load of their 8 bins
    const int4 qv = reinterpret_cast<const int4*>(q + r * kCoeffs)[t];
    const int qw[4] = {qv.x, qv.y, qv.z, qv.w};
    int v[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        v[2 * i] = (int)(int16_t)(qw[i] & 0xffff);
        v[2 * i + 1] = (int)(int16_t)((unsigned)qw[i] >> 16);
    }
    unsigned code[20];
    int len[20];
    int my_bits = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int p = 4 * t + k;
        const int c = cb_r[__ldg(pair_band + b_t * kPairs + p)];
        const int v0 = v[2 * k], v1 = v[2 * k + 1];
        const int m0 = v0 < 0 ? -v0 : v0, m1 = v1 < 0 ? -v1 : v1;
#pragma unroll
        for (int s = 0; s < 5; ++s) {
            code[5 * k + s] = 0u;
            len[5 * k + s] = 0;
        }
        if (c == 1) {
            if ((k & 1) == 0) {              // the 4-tuple on the even pair
                int sym = 0;
#pragma unroll
                for (int d = 0; d < 4; ++d)
                    sym = sym * 3 + clampi(v[2 * k + d], -1, 1) + 1;
                lookup(codes, kSmall + sym, code[5 * k], len[5 * k]);
            }
        } else if (c == 2) {
            lookup(codes, kMid + (clampi(v0, -4, 4) + 4) * 9
                              + clampi(v1, -4, 4) + 4, code[5 * k],
                   len[5 * k]);
        } else if (c == 3) {
            lookup(codes, kEsc + min(m0, kEscMag) * (kEscMag + 1)
                              + min(m1, kEscMag), code[5 * k], len[5 * k]);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int m = i ? m1 : m0;
                if (m != 0) {
                    code[5 * k + 1 + i] = (i ? v1 : v0) < 0 ? 1u : 0u;
                    len[5 * k + 1 + i] = 1;
                }
                if (m >= kEscMag) {
                    const int e = 31 - __clz(m);
                    code[5 * k + 3 + i] = ((((1u << (e - 4)) - 1u) << (e + 1))
                                           | (unsigned)(m - (1 << e)));
                    len[5 * k + 3 + i] = 2 * e - 3;
                }
            }
        }
#pragma unroll
        for (int s = 0; s < 5; ++s) my_bits += len[5 * k + s];
    }
    int pay_total;
    const int pay_excl = block_exclusive_scan(my_bits, warp_sums, &pay_total);
    const int content = 11 + cb_total + sf_total + pay_total;

    if (t == 0) {
        put_bits(words, 0, (unsigned)content, 20, cap);
        put_bits(words, 20, (unsigned)b_t, 3, cap);
        put_bits(words, 23, (unsigned)gain[r], 8, cap);
    }
    put_bits(words, kHeadBits + (band_excl & 0xffff), cb_code, cb_len, cap);
    put_bits(words, kHeadBits + cb_total + (band_excl >> 16), sf_code,
             sf_len, cap);
    int off = kHeadBits + cb_total + sf_total + pay_excl;
#pragma unroll
    for (int s = 0; s < 20; ++s) {
        put_bits(words, off, code[s], len[s], cap);
        off += len[s];
    }
    __syncthreads();

    uint8_t* out = rec + r * cap;
    for (int i = t; i < cap; i += kThreads)
        out[i] = (uint8_t)(words[i >> 2] >> (8 * (i & 3)));
    if (t == 0) nbytes[r] = (20 + content + 7) >> 3;
}

}  // namespace

extern "C" {

// q [F,1024] i16 (16-byte aligned), amp [F,nb] i8, gain [F] i16, bt [F] i8,
// cb [F,nb] i8, codes [572] i32 (code | len << 24: small, mid, esc, sf),
// pair_band [5,512] i32, width [5,nb] i32 -> rec [F,cap] u8, nbytes [F] i32
// (a record with nbytes > cap holds only its first cap bytes).
// Returns cudaGetLastError() after the launch (0 = launched),
// cudaErrorInvalidValue for nb > 128 or cap outside [1, 48 KB].
int mrc_record_pack(const int16_t* q, const int8_t* amp, const int16_t* gain,
                    const int8_t* bt, const int8_t* cb, const int* codes,
                    const int* pair_band, const int* width, uint8_t* rec,
                    int* nbytes, long long n_records, int nb, int cap,
                    void* stream) {
    if (nb > kNbMax || nb < 1 || cap < 1 || cap > kMaxCapBytes)
        return (int)cudaErrorInvalidValue;
    if (n_records == 0) return 0;
    const size_t smem = (size_t)((cap + 3) >> 2) * sizeof(unsigned);
    record_pack_kernel<<<(unsigned)n_records, kThreads, smem,
                         (cudaStream_t)stream>>>(
        q, amp, gain, bt, cb, codes, pair_band, width, rec, nbytes, nb, cap);
    return (int)cudaGetLastError();
}

}  // extern "C"
