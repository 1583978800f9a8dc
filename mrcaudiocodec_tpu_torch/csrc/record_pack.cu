// K3: the MRC1 stream body from the encoder's decisions, records compacted
// in stream order on the card.
//
// Replaces the record packing that the JAX package leaves to XLA
// (mrcaudiocodec_tpu/ops/device_pack.py: `_slots`, `_assemble_bytes`,
// `pack_records_device`) and the host concatenation of the records behind
// the header (mrcaudiocodec_tpu/models/encoder.py `encode_device_packed`).
// It has no Pallas counterpart.
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
// quantizer's clamp, so every slot holds at most 20 bits.
//
// Output: the records order[0], order[1], ... back to back in `body` (the
// stream body of one chunk), nbytes in that order, and status = (total
// bytes, max nbytes). Records not named in `order` (the corpus batch's
// pad frames) are never packed.
//
// Bound on this card: bytes. Per record q 2048 B, amp and cb nb B each,
// gain 2 B, bt 1 B and its order entry 4 B in; its nbytes B of body and 4 B
// of nbytes out: about 2.4 KB a record at 177 B of body, 6.2 MB (1.9 us at
// 3.35 TB/s) for a 30 s stereo encode's 2586 records, 19.7 MB (5.9 us) for
// the 64-clip batch's 8192. What holds it instead is integer issue: some
// 4.6k SASS instructions a record's warp, all integer or control, two
// passes over 16 pairs a lane (chip_smoke.py prints the mix).
//
// Design, against the costs of the first form of this kernel (one
// 128-thread block per record):
//  - Five block barriers per record (zeroing, two block scans, the final
//    store) for ~177 bytes of output: here one warp packs one record with
//    __syncwarp only; the three block barriers of a round are shared by
//    its `warps` records.
//  - Register spill of code[20] / len[20]: two passes over a lane's slots.
//    Pass 1 finds each pair's main codeword and sign bits branch-free (one
//    table index chosen by select, no per-codebook branch to diverge on)
//    and keeps them as one register a pair, code | len << 27; pass 2 only
//    writes them. Escapes (rare in audio) are recomputed in pass 2 under a
//    branch the warp takes as one, from q read again through L1.
//  - The dependent chain band -> codebook id -> codeword in global memory:
//    the merged code table, the pair -> band map (bytes) and the real-band
//    flags are copied to shared memory once per block, 16 bytes a thread;
//    each warp stages its record's codebook ids in shared memory, a lane
//    reads its 16 pairs' bands in one 16-byte load and its bands' amp into
//    registers.
//  - Shared atomics per slot: a lane's slots form one contiguous bit run,
//    built MSB-first in a 32-bit word (a 64-bit shift places each code
//    after the bits already there) and stored as whole words. Only the
//    first and last word of a run can hold a neighbour's bits; those two
//    take atomicOr (slots never share a bit, so the bytes do not depend on
//    the order of the ORs), the interior words a store. Words are
//    little-endian with MSB-first bytes (byte j of the record at shift
//    8 * (j & 3)): the MSB-first word, byte swapped.
//  - Byte stores of the whole cap, then a host gather of each record's
//    nbytes: each record goes straight to its place in the stream body.
//    Its offset comes from a single-pass prefix scan with decoupled
//    look-back (Merrill and Garland, "Single-pass Parallel Prefix Scan with
//    Decoupled Look-back", NVIDIA NVR-2016-002): persistent blocks take
//    tiles of `warps` records in stream order from a global atomicAdd
//    counter (the counter, not blockIdx, sets the order, so every tile a
//    block waits on belongs to a block that is running). A block packs a
//    tile into one of its two staging buffers and publishes the tile's
//    byte total (flag 1; tile 0 its prefix, flag 2), then packs its next
//    tile into the other buffer before it resolves the first: one warp
//    reads the status words of 128 predecessors at once (4 a lane), sums
//    the aggregates back to the nearest inclusive prefix, publishes the
//    tile's own (flag 2) and the block copies the tile out. So the wait for
//    the predecessors overlaps the next tile's work. Status words are
//    64-bit, flag << 32 | value, stored with release and loaded with
//    acquire semantics; integer sums are exact in any order. The C entry
//    zeroes them and the counter before each launch, on the launch's
//    stream.
// Lane l owns pairs 16l .. 16l+15 (bins 32l .. 32l+31: four 16-byte loads,
// the warp's 2 KB of q read coalesced; CB_SMALL's 4-tuples start on even
// pairs, so none straddles two lanes) and bands K*l .. K*l+K-1, K =
// ceil(nb / 32) <= 4. Consecutive lanes copy consecutive bytes out. A
// record longer than cap writes only its first cap bytes; the wrapper
// raises when max nbytes > cap, so a truncated record never reaches a
// stream. No integer division by a variable (it compiles to a float
// reciprocal with .FTZ, see chip_smoke.py's SASS audit).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;             // records per tile, at most
constexpr int kCoeffs = 1024;
constexpr int kPairs = kCoeffs / 2;
constexpr int kPairsPerLane = kPairs / 32;
constexpr int kNbMax = 128;
constexpr int kBandsPerLaneMax = kNbMax / 32;
constexpr int kBlockTypes = 5;
constexpr int kTable = 81 + 81 + 289 + 121;
constexpr int kHeadBits = 20 + 3 + 8;    // prefix, block type, gain
constexpr int kMaxCapBytes = 32 * 1024;
constexpr int kMaxSmem = 48 * 1024;      // without the opt-in attribute
constexpr int kMaxSmemOptIn = 227 * 1024;  // with it (H100)
// offsets of the four codebooks in the merged table (code | len << 24)
constexpr int kSmall = 0, kMid = 81, kEsc = 162, kSf = 451;
constexpr int kEscMag = 16, kSfDeltaMax = 60;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
    asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(
        const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int warp_exclusive_scan(int v, int lane,
                                                   int* total) {
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
    }
    *total = __shfl_sync(0xffffffffu, x, 31);
    return x - v;
}

// One lane's contiguous bit run [off, off + len) of a record, written
// MSB-first into the warp's staging words. Words past n_words (the cap)
// are dropped.
struct Run {
    unsigned* words;
    int n_words, w, w0, w1, n;
    unsigned cur;                        // word w's first n bits, MSB first

    __device__ __forceinline__ Run(unsigned* words_, int n_words_, int off,
                                   int len)
        : words(words_), n_words(n_words_), w(off >> 5), w0(off >> 5),
          w1((off + len - 1) >> 5), n(off & 31), cur(0u) {}

    // word w is whole: its bytes (byte-swapped to little-endian words of
    // MSB-first bytes) ORed in at the run's two edges, stored inside it
    __device__ __forceinline__ void emit() {
        const unsigned v = __byte_perm(cur, 0u, 0x0123);
        const bool edge = w == w0 || w == w1;
        if (w < n_words && edge) atomicOr(words + w, v);
        if (w < n_words && !edge) words[w] = v;
        ++w;
    }

    // len in [0, 31]; the code is masked to its length
    __device__ __forceinline__ void put(unsigned code, int len) {
        const int total = n + len;       // <= 62
        // the code placed right after the word's n bits, in 64 bits
        const unsigned long long at =
            ((unsigned long long)(code & ((1u << len) - 1u))
             << (63 - total)) << 1;
        cur |= (unsigned)(at >> 32);
        if (total >= 32) {
            emit();
            cur = (unsigned)at;
        }
        n = total & 31;
    }

    __device__ __forceinline__ void finish() {
        if (n > 0) emit();
    }
};

__device__ __forceinline__ int escape_len(int m) {
    return m >= kEscMag ? 2 * (31 - __clz(m)) - 3 : 0;
}

// (e - 4) ones, a zero, the e low bits of m; meaningful for m >= 16
__device__ __forceinline__ unsigned escape_code(int m) {
    const int e = max(31 - __clz(m), 4);
    return (((1u << (e - 4)) - 1u) << (e + 1)) | (unsigned)(m - (1 << e));
}

// One pair of bins (v0, v1; v2, v3 the next pair's, for CB_SMALL's
// 4-tuple on an even pair) under codebook c, without a branch: its main
// codeword and sign bits as one code and length, and the length of its
// two escapes (0 where a slot is empty).
struct PairHead {
    unsigned code;
    int len, esc_len;
};

__device__ __forceinline__ PairHead pair_head(const int* codes, int c,
                                              bool even, int v0, int v1,
                                              int v2, int v3) {
    const int m0 = v0 < 0 ? -v0 : v0, m1 = v1 < 0 ? -v1 : v1;
    const bool small = c == 1 && even, mid = c == 2, esc = c == 3;
    int idx = kEsc + min(m0, kEscMag) * (kEscMag + 1) + min(m1, kEscMag);
    idx = mid ? kMid + (clampi(v0, -4, 4) + 4) * 9 + clampi(v1, -4, 4) + 4
              : idx;
    idx = small ? kSmall + ((clampi(v0, -1, 1) * 3 + clampi(v1, -1, 1)) * 3
                            + clampi(v2, -1, 1)) * 3 + clampi(v3, -1, 1)
                      + 40                // + 1 on each of 4 digits
                : idx;
    const int e = codes[idx];
    const int s0 = (esc && m0 != 0) ? 1 : 0, s1 = (esc && m1 != 0) ? 1 : 0;
    PairHead h;
    h.len = (small || mid || esc ? e >> 24 : 0) + s0 + s1;
    h.code = (((unsigned)e & 0xffffffu) << (s0 + s1))
             | ((unsigned)(s0 & (v0 < 0)) << s1) | (unsigned)(s1 & (v1 < 0));
    h.esc_len = esc ? escape_len(m0) + escape_len(m1) : 0;
    return h;
}

__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int bytes) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* g = reinterpret_cast<const uint4*>(src);
    for (int i = threadIdx.x; i < (bytes >> 4); i += blockDim.x)
        d[i] = __ldg(g + i);
}

// Band b's codebook id and scale-factor delta lengths (0 for a band that is
// not real), its amp a and the previous band's prev; with kWrite the id
// into cb_run and the codeword into sf_run.
template <bool kWrite>
__device__ __forceinline__ int band_bits(const int* codes,
                                         const uint8_t* real_t,
                                         const int8_t* cbs, int b, int a,
                                         int prev, Run* cb_run,
                                         Run* sf_run) {
    if (!real_t[b]) return 0;
    prev = (b > 0 && real_t[b - 1]) ? prev : 0;
    const int e = codes[kSf + prev - a + kSfDeltaMax];
    if (kWrite) {
        cb_run->put((unsigned)cbs[b], 2);
        sf_run->put((unsigned)e & 0xffffffu, e >> 24);
    }
    return 2 | ((e >> 24) << 16);        // cb bits | sf bits << 16
}

// One warp packs record r into its staging words -> nbytes (every lane).
__device__ __forceinline__ int pack_record(
        long long r, int lane, const int16_t* __restrict__ q,
        const int8_t* __restrict__ amp, const int16_t* __restrict__ gain,
        const int8_t* __restrict__ bt, const int8_t* __restrict__ cb,
        const int* codes, const uint8_t* pair_band, const uint8_t* real,
        int8_t* cbs, unsigned* words, int n_words, int nb) {
    for (int i = lane; i < n_words; i += 32) words[i] = 0u;
    const int8_t* cb_r = cb + r * nb;
    const int8_t* amp_r = amp + r * nb;
    for (int b = lane; b < nb; b += 32) cbs[b] = cb_r[b];
    const int per_lane = (nb + 31) >> 5;    // <= 4 bands a lane
    const int b0 = per_lane * lane;
    // amp of bands b0 - 1 .. b0 + 3 (0 outside the lane's bands)
    int av[kBandsPerLaneMax + 1];
#pragma unroll
    for (int t = 0; t <= kBandsPerLaneMax; ++t) {
        const int b = b0 - 1 + t;
        av[t] = (t <= per_lane && b >= 0 && b < nb) ? amp_r[b] : 0;
    }
    const int b_t = bt[r];
    const uint8_t* real_t = real + b_t * kNbMax;
    // the bands of the lane's 16 pairs, one 16-byte shared load
    const uint4 bands4 = *reinterpret_cast<const uint4*>(
        pair_band + b_t * kPairs + kPairsPerLane * lane);
    const unsigned band_w[4] = {bands4.x, bands4.y, bands4.z, bands4.w};
    // pairs 16l .. 16l+15: word k holds pair k's two bins
    const int4* q4 = reinterpret_cast<const int4*>(q + r * kCoeffs) + 4 * lane;
    int qw[kPairsPerLane];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int4 v = __ldg(q4 + i);
        qw[4 * i] = v.x;
        qw[4 * i + 1] = v.y;
        qw[4 * i + 2] = v.z;
        qw[4 * i + 3] = v.w;
    }
    __syncwarp();                        // cbs and the zeroed words

    // pass 1: lengths
    int band_len = 0;
#pragma unroll
    for (int t = 0; t < kBandsPerLaneMax; ++t)
        if (t < per_lane && b0 + t < nb)
            band_len += band_bits<false>(codes, real_t, cbs, b0 + t,
                                         av[t + 1], av[t], nullptr, nullptr);
    int pay_len = 0;
    unsigned escapes = 0u;               // bit k: pair k has an escape
    // pair k's main codeword and sign bits, code | len << 27 (<= 22 bits)
    unsigned heads[kPairsPerLane];
#pragma unroll
    for (int k = 0; k < kPairsPerLane; ++k) {
        const int c = cbs[(band_w[k >> 2] >> (8 * (k & 3))) & 0xffu];
        const int w = qw[k], w2 = qw[k | 1];
        const PairHead h = pair_head(
            codes, c, (k & 1) == 0, (int)(int16_t)(w & 0xffff), w >> 16,
            (int)(int16_t)(w2 & 0xffff), w2 >> 16);
        heads[k] = (h.code & ((1u << h.len) - 1u)) | ((unsigned)h.len << 27);
        pay_len += h.len + h.esc_len;
        escapes |= (h.esc_len != 0 ? 1u : 0u) << k;
    }
    // the pairs with an escape in any lane: a branch the warp takes as one
    escapes = __reduce_or_sync(0xffffffffu, escapes);
    int band_total, pay_total;
    const int band_excl = warp_exclusive_scan(band_len, lane, &band_total);
    const int pay_excl = warp_exclusive_scan(pay_len, lane, &pay_total);
    const int cb_total = band_total & 0xffff, sf_total = band_total >> 16;
    const int content = 11 + cb_total + sf_total + pay_total;

    // pass 2: the codes, each lane's runs in turn
    if (lane == 0) {
        Run head(words, n_words, 0, kHeadBits);
        head.put((unsigned)content, 20);
        head.put((unsigned)b_t, 3);
        head.put((unsigned)gain[r], 8);
        head.finish();
    }
    const int cb_len = band_len & 0xffff, sf_len = band_len >> 16;
    if (cb_len > 0) {
        Run cb_run(words, n_words, kHeadBits + (band_excl & 0xffff), cb_len);
        Run sf_run(words, n_words, kHeadBits + cb_total + (band_excl >> 16),
                   sf_len);
#pragma unroll
        for (int t = 0; t < kBandsPerLaneMax; ++t)
            if (t < per_lane && b0 + t < nb)
                band_bits<true>(codes, real_t, cbs, b0 + t, av[t + 1], av[t],
                                &cb_run, &sf_run);
        cb_run.finish();
        if (sf_len > 0) sf_run.finish();
    }
    if (pay_len > 0) {
        Run pay(words, n_words, kHeadBits + cb_total + sf_total + pay_excl,
                pay_len);
        const int* q_lane = reinterpret_cast<const int*>(q + r * kCoeffs)
                            + kPairsPerLane * lane;
#pragma unroll
        for (int k = 0; k < kPairsPerLane; ++k) {
            pay.put(heads[k] & 0x7ffffffu, (int)(heads[k] >> 27));
            if ((escapes >> k) & 1u) {   // rare: q again, from L1
                const int w = __ldg(q_lane + k);
                const int v0 = (int)(int16_t)(w & 0xffff), v1 = w >> 16;
                const int m0 = v0 < 0 ? -v0 : v0, m1 = v1 < 0 ? -v1 : v1;
                const bool esc = cbs[(band_w[k >> 2] >> (8 * (k & 3)))
                                     & 0xffu] == 3;
                pay.put(escape_code(m0), esc ? escape_len(m0) : 0);
                pay.put(escape_code(m1), esc ? escape_len(m1) : 0);
            }
        }
        pay.finish();
    }
    __syncwarp();
    return (20 + content + 7) >> 3;
}

// Decoupled look-back, in two steps. publish(): a tile's aggregate as
// soon as its records are packed (tile 0's is its inclusive prefix).
// resolve(), by one warp -> the tile's exclusive prefix (every lane): it
// reads the status words of its kWindow nearest unread predecessors at
// once (lane l the tiles 32i + l + 1 back, i < kWindow / 32), waiting while
// any is unset; the nearest inclusive prefix in the window ends the walk,
// else the window's aggregates are summed and it moves kWindow tiles back.
// Then it publishes the tile's inclusive prefix.
constexpr int kWindow = 128;

__device__ __forceinline__ void publish(unsigned long long* tile_status,
                                        int tile, int aggregate) {
    st_release(tile_status + tile,
               (tile == 0 ? kPrefix : kAggregate) | (unsigned)aggregate);
}

__device__ __forceinline__ int resolve(unsigned long long* tile_status,
                                       int tile, int aggregate, int lane) {
    if (tile == 0) return 0;
    int excl = 0;
    for (int base = tile - 1 - lane;; base -= kWindow) {
        unsigned long long s[kWindow / 32];
#pragma unroll
        for (int i = 0; i < kWindow / 32; ++i) {
            const int j = base - 32 * i;
            s[i] = kPrefix;              // before tile 0: a zero prefix
            if (j >= 0) {
                do {
                    s[i] = ld_acquire(tile_status + j);
                } while ((s[i] >> 32) == 0ull);
            }
        }
        bool done = false;
#pragma unroll
        for (int i = 0; i < kWindow / 32; ++i) {
            if (!done) {
                const unsigned prefix = __ballot_sync(
                    0xffffffffu, (s[i] & kPrefix) != 0ull);
                const int last = prefix ? __ffs(prefix) - 1 : 31;
                excl += (int)__reduce_add_sync(
                    0xffffffffu, lane <= last ? (unsigned)s[i] : 0u);
                done = prefix != 0u;
            }
        }
        if (done) break;
    }
    if (lane == 0)
        st_release(tile_status + tile,
                   kPrefix | (unsigned)(excl + aggregate));
    return excl;
}

// 3 blocks an SM: 80 registers and a small spill to L1 (chip_smoke.py
// prints both), which ran faster on the H100 than a spill-free build at 2
// blocks an SM
__global__ void __launch_bounds__(kMaxWarps * 32, 3) record_pack_kernel(
        const int16_t* __restrict__ q, const int8_t* __restrict__ amp,
        const int16_t* __restrict__ gain, const int8_t* __restrict__ bt,
        const int8_t* __restrict__ cb, const int* __restrict__ order,
        const int* __restrict__ codes_g,
        const uint8_t* __restrict__ pair_band_g,
        const uint8_t* __restrict__ real_g, uint8_t* __restrict__ body,
        int* __restrict__ nbytes, int* __restrict__ status,
        unsigned long long* __restrict__ tile_status, int* tile_counter,
        long long n, int nb, int cap, int n_tiles) {
    __shared__ __align__(16) int codes[kTable];
    __shared__ __align__(16) uint8_t pair_band[kBlockTypes * kPairs];
    __shared__ __align__(16) uint8_t real[kBlockTypes * kNbMax];
    __shared__ int s_tile, s_off;
    __shared__ int s_nb[kMaxWarps];
    __shared__ int s_excl[2][kMaxWarps];
    extern __shared__ unsigned char dyn[];
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n_words = (cap + 3) >> 2;
    int8_t* cbs = reinterpret_cast<int8_t*>(dyn) + kNbMax * warp;
    // two staging buffers a warp: one tile packs while the last copies out
    unsigned* staging = reinterpret_cast<unsigned*>(dyn + kNbMax * warps);
    // the first tile, then the tables, 16 bytes a thread (each a multiple
    // of 16 bytes)
    int next = 0;
    if (threadIdx.x == 0) next = atomicAdd(tile_counter, 1);
    copy16(codes, codes_g, kTable * 4);
    copy16(pair_band, pair_band_g, kBlockTypes * kPairs);
    copy16(real, real_g, kBlockTypes * kNbMax);

    // Each round packs tile `tile` into buffer `cur` and publishes its
    // aggregate, then resolves the previous tile's offset (its
    // predecessors have had a round to publish) and copies it out. The
    // next tile is taken a round ahead; no tile waits on one taken after
    // it, so the least tile not yet published always moves.
    int prev = -1, cur = 0, prev_len = 0, prev_aggregate = 0, prev_max = 0;
    for (;;) {
        if (threadIdx.x == 0) s_tile = next;
        __syncthreads();                 // s_tile; the tables, once
        const int tile = s_tile;
        if (threadIdx.x == 0 && tile < n_tiles)
            next = atomicAdd(tile_counter, 1);
        const bool have = tile < n_tiles;
        unsigned* words = staging + (cur * warps + warp) * n_words;
        const long long i = (long long)tile * warps + warp;
        int len = 0;
        if (have && i < n) {
            len = pack_record(order[i], lane, q, amp, gain, bt, cb, codes,
                              pair_band, real, cbs, words, n_words, nb);
            if (lane == 0) nbytes[i] = len;
        }
        if (lane == 0) s_nb[warp] = len;
        __syncthreads();                 // s_nb; the tile is packed
        if (warp == 0) {
            const int v = lane < warps ? s_nb[lane] : 0;
            int aggregate;
            const int excl = warp_exclusive_scan(v, lane, &aggregate);
            if (have) {
                if (lane < warps) s_excl[cur][lane] = excl;
                if (lane == 0) publish(tile_status, tile, aggregate);
            }
            if (prev >= 0) {
                const int off = resolve(tile_status, prev, prev_aggregate,
                                        lane);
                if (lane == 0) {
                    s_off = off;
                    atomicMax(status + 1, prev_max);
                    if (prev == n_tiles - 1)
                        status[0] = off + prev_aggregate;
                }
            }
            prev_aggregate = aggregate;
            prev_max = __reduce_max_sync(0xffffffffu, (unsigned)v);
        }
        __syncthreads();                 // s_off
        if (prev >= 0 && (long long)prev * warps + warp < n) {
            const long long base = (long long)s_off + s_excl[cur ^ 1][warp];
            const long long limit = n * cap;
            const int m = min(prev_len, cap);
            const uint8_t* src = reinterpret_cast<const uint8_t*>(
                staging + ((cur ^ 1) * warps + warp) * n_words);
            for (int j = lane; j < m; j += 32)
                if (base + j < limit) body[base + j] = src[j];
        }
        if (!have) break;
        prev = tile;
        prev_len = len;
        cur ^= 1;
    }
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block of `warps` warps at this cap: per warp
// its record's codebook ids (128 B) and two buffers of staging words.
static size_t dyn_smem(int cap, int warps) {
    return (size_t)warps * (kNbMax + 2 * 4 * ((cap + 3) >> 2));
}

// q [F,1024] i16 (16-byte aligned), amp [F,nb] i8, gain [F] i16, bt [F] i8,
// cb [F,nb] i8, order [n] i32 (record indices in stream order, each in
// [0, F)), codes [572] i32 (code | len << 24: small, mid, esc, sf),
// pair_band [5,512] u8, real [5,128] u8 (band is real) -> body [n*cap] u8
// (its first status[0] bytes written), nbytes [n] i32 in stream order,
// status [2] i32 (total bytes, max nbytes); scratch [n_tiles + 1] u64 (the
// tiles' status words and the tile counter), zeroed here on `stream`.
// warps in [1, 8] records per tile. Returns cudaGetLastError() after the
// launch (0 = launched), cudaErrorInvalidValue for arguments out of range.
int mrc_record_pack(const int16_t* q, const int8_t* amp, const int16_t* gain,
                    const int8_t* bt, const int8_t* cb, const int* order,
                    const int* codes, const uint8_t* pair_band,
                    const uint8_t* real, uint8_t* body, int* nbytes,
                    int* status, unsigned long long* scratch, long long n,
                    int nb, int cap, int warps, void* stream) {
    if (nb > kNbMax || nb < 1 || cap < 1 || cap > kMaxCapBytes
            || warps < 1 || warps > kMaxWarps || n < 0
            || n * (long long)cap > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const size_t smem = dyn_smem(cap, warps);
    const size_t fixed = (sizeof(int) * (kTable + 2 + 3 * kMaxWarps)
                          + kBlockTypes * (kPairs + kNbMax) + 15)
                         & ~(size_t)15;     // the static arrays, 5600 B
    if (smem + fixed > (size_t)kMaxSmemOptIn)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const long long n_tiles = (n + warps - 1) / warps;
    cudaError_t e = cudaMemsetAsync(status, 0, 2 * sizeof(int), s);
    if (e == cudaSuccess)
        e = cudaMemsetAsync(scratch, 0,
                            (size_t)(n_tiles + 1) * sizeof(*scratch), s);
    if (e != cudaSuccess) return (int)e;
    if (n == 0) return 0;
    // the grid: blocks resident on the device at this block shape, queried
    // once per (device, warps, cap) in each host thread (the current
    // device is a thread's own, and threads may drive different cards)
    static thread_local int last_device = -1, last_warps = 0, last_cap = 0,
                            resident = 0;
    int device = 0;
    e = cudaGetDevice(&device);
    if (e != cudaSuccess) return (int)e;
    if (device != last_device || warps != last_warps || cap != last_cap) {
        int sms = 0, per_sm = 0;
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
        // above 48 KB a block's dynamic shared memory needs the opt-in
        if (e == cudaSuccess && smem + fixed > (size_t)kMaxSmem)
            e = cudaFuncSetAttribute(
                record_pack_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, record_pack_kernel, warps * 32, smem);
        if (e != cudaSuccess) return (int)e;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        last_device = device;
        last_warps = warps;
        last_cap = cap;
        resident = per_sm * sms;
    }
    const unsigned grid =
        (unsigned)(n_tiles < resident ? n_tiles : resident);
    record_pack_kernel<<<grid, warps * 32, smem, s>>>(
        q, amp, gain, bt, cb, order, codes, pair_band, real, body, nbytes,
        status, scratch, reinterpret_cast<int*>(scratch + n_tiles), n, nb,
        cap, (int)n_tiles);
    return (int)cudaGetLastError();
}

}  // extern "C"
