// K11: one encode chunk's padded signal rows, built on the card from the
// clips' PCM as it was uploaded.
//
// Replaces no TPU kernel: the JAX package pads on the host
// (mrcaudiocodec_tpu/models/encoder.py _padded_rows) and hands XLA the
// rows. The port padded on the host too (encoder._padded_rows and
// corpus's batch pad: a zeroed [R, (nf + 6) * HOP] array, a transposed
// copy a clip, then a strided copy a chunk before a pageable upload) until
// that was most of a batch's time. Now the host copies each clip's
// interleaved samples once into a reused pinned buffer and uploads them
// as they are (encoder.upload_pcm); this kernel writes each chunk's rows,
// which K5 and K6 read in place. The plain version is
// ops/kernels/pad_rows.pad_rows_plain; both give the bytes of
// encoder.upload_chunk(encoder._padded_rows(...)).
//
// Input: pcm [sum n_j, nch] (int16 or float32, channels interleaved),
// clips [J, 2] int64 (clip j's first sample in pcm, its length), lo =
// (f0 - 2) * HOP. Output: out [J * nch, W], W = (s + 3) * HOP:
//   out[j * nch + c][u] = pcm[off_j + t][c], t = lo + u, if 0 <= t < n_j
//                         0                                 otherwise
//
// Bound on this card: HBM bytes, the rows written once and the samples in
// them read once; no arithmetic. A thread takes a run of 8 columns of one
// clip's rows. lo and the run's start are multiples of 8, so the run's 8
// samples are 16 * nch (int16) or 32 * nch (float32) contiguous bytes,
// 16-byte aligned whenever the clip's first sample is: the thread reads
// them with 16-byte loads (a warp reads 1 or 2 KB in a row), splits the
// channels in registers (for int16 stereo with byte permutes) and writes
// one or two 16-byte stores to each of its nch rows (a warp writes 512 B
// or 1 KB of each row in a row). A run that crosses the clip's end, or a
// clip whose first sample is not 16-byte aligned, is copied a sample at a
// time; a run wholly outside the clip writes zeros. Values move as bits:
// no floating-point instruction, so no FFMA and no .FTZ.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;                    // columns (samples) a thread

template <typename T, int NCH>
__global__ void __launch_bounds__(kThreads)
pad_rows_kernel(const T* __restrict__ pcm,
                const long long* __restrict__ clips, T* __restrict__ out,
                long long lo, int width) {
    constexpr int kWords = kRun * (int)sizeof(T) / 4;   // a row's run
    constexpr int kLoads = kRun * NCH * (int)sizeof(T) / 16;
    const int j = blockIdx.y;
    const int u0 = (blockIdx.x * kThreads + threadIdx.x) * kRun;
    if (u0 >= width)
        return;
    const long long off = __ldg(clips + 2 * j);
    const long long n = __ldg(clips + 2 * j + 1);
    const long long t0 = lo + u0;          // a multiple of 8, as lo is
    T* row = out + (long long)j * NCH * width + u0;
    uint32_t o[NCH][kWords];
    if (t0 < 0 || t0 >= n) {               // t0 < 0: so is t0 + 7
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
            for (int w = 0; w < kWords; ++w)
                o[c][w] = 0u;
    } else {
        const T* src = pcm + (off + t0) * NCH;
        if (t0 + kRun > n || (reinterpret_cast<uintptr_t>(src) & 15)) {
            // the clip's end, or a clip that starts unaligned
            const long long m = n - t0 < kRun ? n - t0 : kRun;
#pragma unroll
            for (int c = 0; c < NCH; ++c)
#pragma unroll
                for (int k = 0; k < kRun; ++k)
                    row[(long long)c * width + k] =
                        k < m ? src[k * NCH + c] : T(0);
            return;
        }
        uint32_t in[kLoads * 4];
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + i);
            in[4 * i] = v.x;
            in[4 * i + 1] = v.y;
            in[4 * i + 2] = v.z;
            in[4 * i + 3] = v.w;
        }
        if constexpr (sizeof(T) == 4 || NCH == 1) {
            // a word is one value (float32: sample k's channel c is word
            // k * NCH + c) or two of one row (int16 mono: samples 2w, 2w+1)
#pragma unroll
            for (int c = 0; c < NCH; ++c)
#pragma unroll
                for (int w = 0; w < kWords; ++w)
                    o[c][w] = in[w * NCH + c];
        } else {
            // int16 stereo: word k is sample k, channel 0 in its low half
#pragma unroll
            for (int w = 0; w < kWords; ++w) {
                o[0][w] = __byte_perm(in[2 * w], in[2 * w + 1], 0x5410);
                o[1][w] = __byte_perm(in[2 * w], in[2 * w + 1], 0x7632);
            }
        }
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
        uint4* dst = reinterpret_cast<uint4*>(row + (long long)c * width);
#pragma unroll
        for (int q = 0; q < kWords / 4; ++q)
            dst[q] = make_uint4(o[c][4 * q], o[c][4 * q + 1],
                                o[c][4 * q + 2], o[c][4 * q + 3]);
    }
}

template <typename T, int NCH>
void launch(const void* pcm, const long long* clips, void* out,
            int n_clips, long long lo, int width, cudaStream_t stream) {
    const int runs = width / kRun;
    const dim3 grid((unsigned)((runs + kThreads - 1) / kThreads),
                    (unsigned)n_clips);
    pad_rows_kernel<T, NCH><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(pcm), clips, static_cast<T*>(out), lo, width);
}

}  // namespace

extern "C" {

// pcm [sum n_j, nch] int16 (elem_bytes 2) or float32 (4), clips [J, 2]
// int64 (offset, length), lo = (f0 - 2) * HOP -> out [J * nch, width].
// out 16-byte aligned, width a multiple of 8, 1 <= J <= 65535, nch 1 or 2.
// Returns cudaGetLastError() after the launch (0 = launched),
// cudaErrorInvalidValue for bad sizes.
int mrc_pad_rows(const void* pcm, const long long* clips, void* out,
                 int n_clips, int nch, int elem_bytes, long long lo,
                 int width, void* stream) {
    if (n_clips < 1 || n_clips > 65535 || width < kRun || width % kRun
        || (reinterpret_cast<uintptr_t>(out) & 15))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (elem_bytes == 2 && nch == 1)
        launch<short, 1>(pcm, clips, out, n_clips, lo, width, s);
    else if (elem_bytes == 2 && nch == 2)
        launch<short, 2>(pcm, clips, out, n_clips, lo, width, s);
    else if (elem_bytes == 4 && nch == 1)
        launch<float, 1>(pcm, clips, out, n_clips, lo, width, s);
    else if (elem_bytes == 4 && nch == 2)
        launch<float, 2>(pcm, clips, out, n_clips, lo, width, s);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

}  // extern "C"
