// P5: five ways of pairing neighbouring lanes, then a row sum.
//
// Replaces the five Pallas kernels of scripts/tpu_primitive_probe.py
// (`run`, pallas_call at :34), each on x [F,1024] f32 -> [F, cols] f32
// (the row's value in every column):
//   p0 `p0_reshape` (:50):  sum over pairs of x[2p] + x[2p+1], read as the
//                           [F,512,2] reshape (one float2 per pair);
//   p1 `p1_strided` (:58):  the same sum, read as the strided even and odd
//                           lanes x[::2] + x[1::2];
//   p2 `p2_roll` (:66):     sum over the row of x[i] + x[i+1] at even i and
//                           0 at odd i (x[i+1] is the row rolled by -1);
//   p3 `p3_deint_mm` (:75): even = x @ E, odd = x @ O with the 0/1
//                           deinterleave matrices E, O [1024,512], then the
//                           sum of even + odd. The product is computed in
//                           this body; it is exact in any order, since each
//                           output has one nonzero term;
//   p4 `p4_evenmask` (:87): m = clip(int(|x|), 0, 8); the sum over even i of
//                           bf16(tab[m[i]*9 + m[i+1]]) (the script's bf16
//                           one-hot dot), tab [81] f32.
// The question the TPU script asked (which of these the Mosaic compiler
// accepts) has no meaning here; the values do, and these are they.
//
// Every row sum runs in the halving order of xpsy.tree_sum (v[:h] + v[h:])
// in shared memory, over 512 pair values (p0, p1, p3) or 1024 lane values
// (p2, p4), so the plain PyTorch version gives the same bits. Every add and
// multiply is an __f*_rn intrinsic and the library is built with
// --fmad=false.
//
// Bound on this card: HBM bytes for p0-p2 and p4 (4 B per element, about
// one add each); p3 by its dense product (2 x 1024 x 512 multiply-adds per
// row against 4 MB of matrices that stay in L2). Design: one block of 512
// threads per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kCoeffs = 1024;
constexpr int kPairs = 512;

// xpsy.tree_sum over s[0..n), n a power of two; all threads must have
// written s and synchronized. Returns s[0] to every thread.
__device__ float tree_sum(float* s, int n) {
    for (int h = n >> 1; h >= 1; h >>= 1) {
        for (int i = threadIdx.x; i < h; i += kThreads)
            s[i] = __fadd_rn(s[i], s[i + h]);
        __syncthreads();
    }
    return s[0];
}

__device__ __forceinline__ void store_row(float v, int cols, float* out) {
    if ((int)threadIdx.x < cols) out[(long long)blockIdx.x * cols + threadIdx.x] = v;
}

__global__ void __launch_bounds__(kThreads)
p0_kernel(const float* __restrict__ x, int cols, float* __restrict__ out) {
    __shared__ float s[kPairs];
    const int t = threadIdx.x;
    const float2 v = reinterpret_cast<const float2*>(
        x + (long long)blockIdx.x * kCoeffs)[t];
    s[t] = __fadd_rn(v.x, v.y);
    __syncthreads();
    store_row(tree_sum(s, kPairs), cols, out);
}

__global__ void __launch_bounds__(kThreads)
p1_kernel(const float* __restrict__ x, int cols, float* __restrict__ out) {
    __shared__ float s[kPairs];
    const int t = threadIdx.x;
    const float* row = x + (long long)blockIdx.x * kCoeffs;
    s[t] = __fadd_rn(row[2 * t], row[2 * t + 1]);
    __syncthreads();
    store_row(tree_sum(s, kPairs), cols, out);
}

__global__ void __launch_bounds__(kThreads)
p2_kernel(const float* __restrict__ x, int cols, float* __restrict__ out) {
    __shared__ float s[kCoeffs];
    const float* row = x + (long long)blockIdx.x * kCoeffs;
    for (int i = threadIdx.x; i < kCoeffs; i += kThreads)
        s[i] = (i & 1) ? 0.0f : __fadd_rn(row[i], row[(i + 1) & (kCoeffs - 1)]);
    __syncthreads();
    store_row(tree_sum(s, kCoeffs), cols, out);
}

__global__ void __launch_bounds__(kThreads)
p3_kernel(const float* __restrict__ x, const float* __restrict__ e_mat,
          const float* __restrict__ o_mat, int cols, float* __restrict__ out) {
    __shared__ float xs[kCoeffs];
    __shared__ float s[kPairs];
    const int j = threadIdx.x;
    const float* row = x + (long long)blockIdx.x * kCoeffs;
    for (int i = j; i < kCoeffs; i += kThreads) xs[i] = row[i];
    __syncthreads();
    float even = 0.0f, odd = 0.0f;
    for (int k = 0; k < kCoeffs; ++k) {
        even = __fadd_rn(even, __fmul_rn(xs[k], e_mat[k * kPairs + j]));
        odd = __fadd_rn(odd, __fmul_rn(xs[k], o_mat[k * kPairs + j]));
    }
    s[j] = __fadd_rn(even, odd);
    __syncthreads();
    store_row(tree_sum(s, kPairs), cols, out);
}

__device__ __forceinline__ int lane_level(float v) {
    const int m = (int)fabsf(v);
    return m < 0 ? 0 : (m > 8 ? 8 : m);
}

__global__ void __launch_bounds__(kThreads)
p4_kernel(const float* __restrict__ x, const float* __restrict__ tab,
          int cols, float* __restrict__ out) {
    __shared__ float s[kCoeffs];
    const float* row = x + (long long)blockIdx.x * kCoeffs;
    for (int i = threadIdx.x; i < kCoeffs; i += kThreads) {
        float v = 0.0f;
        if (!(i & 1)) {
            const int sym = lane_level(row[i]) * 9
                            + lane_level(row[(i + 1) & (kCoeffs - 1)]);
            v = __bfloat162float(__float2bfloat16_rn(tab[sym]));
        }
        s[i] = v;
    }
    __syncthreads();
    store_row(tree_sum(s, kCoeffs), cols, out);
}

}  // namespace

extern "C" {

// Every entry: F = n_rows blocks of 512 threads; x [F,1024] f32 -> out
// [F,cols] f32 (cols <= 512). Returns cudaGetLastError() after the launch.

int mrc_probe_p0(const float* x, int cols, float* out, long long n_rows,
                 void* stream) {
    if (cols > kThreads) return -1;
    p0_kernel<<<(unsigned)n_rows, kThreads, 0, (cudaStream_t)stream>>>(x, cols, out);
    return (int)cudaGetLastError();
}

int mrc_probe_p1(const float* x, int cols, float* out, long long n_rows,
                 void* stream) {
    if (cols > kThreads) return -1;
    p1_kernel<<<(unsigned)n_rows, kThreads, 0, (cudaStream_t)stream>>>(x, cols, out);
    return (int)cudaGetLastError();
}

int mrc_probe_p2(const float* x, int cols, float* out, long long n_rows,
                 void* stream) {
    if (cols > kThreads) return -1;
    p2_kernel<<<(unsigned)n_rows, kThreads, 0, (cudaStream_t)stream>>>(x, cols, out);
    return (int)cudaGetLastError();
}

// e_mat, o_mat [1024,512] f32.
int mrc_probe_p3(const float* x, const float* e_mat, const float* o_mat,
                 int cols, float* out, long long n_rows, void* stream) {
    if (cols > kThreads) return -1;
    p3_kernel<<<(unsigned)n_rows, kThreads, 0, (cudaStream_t)stream>>>(
        x, e_mat, o_mat, cols, out);
    return (int)cudaGetLastError();
}

// tab [81] f32.
int mrc_probe_p4(const float* x, const float* tab, int cols, float* out,
                 long long n_rows, void* stream) {
    if (cols > kThreads) return -1;
    p4_kernel<<<(unsigned)n_rows, kThreads, 0, (cudaStream_t)stream>>>(
        x, tab, cols, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
