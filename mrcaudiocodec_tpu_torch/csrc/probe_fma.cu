// P3: does the compiler contract a multiply and an add into one FMA?
//
// Replaces the Pallas kernels k1, k2, k3 of scripts/tpu_fma_probe.py
// (`main`, pallas_call at :82; bodies at :69, :72, :75):
//   k1: o = a*b - c      k2: o = a*b - c*d      k3: o = a*b + c*d
// elementwise on [8, 1024] f32.
//
// Unlike every other kernel of the port, these bodies use plain C++
// operators and NOT the __f*_rn intrinsics: the intrinsics are never
// contracted, and the point of the probe is to let the compiler choose.
// The same file is built twice:
//   libprobe_fma           --fmad=false, as every library of the port: the
//                          results must be the twice-rounded "plain" values
//                          and the SASS must hold no FFMA;
//   libprobe_fma_contract  --fmad=true, the positive control: the results
//                          must show a fused, once-rounded multiply-add and
//                          the SASS at least one FFMA. Only the FMA probe
//                          loads it.
//
// Bound on this card: HBM bytes (16 B read and 4 B written per element for
// 2-3 f32 ops). Design: one thread per element, 256 threads per block.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
k1_kernel(const float* __restrict__ a, const float* __restrict__ b,
          const float* __restrict__ c, float* __restrict__ o, long long n) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i < n) o[i] = a[i] * b[i] - c[i];
}

__global__ void __launch_bounds__(kThreads)
k2_kernel(const float* __restrict__ a, const float* __restrict__ b,
          const float* __restrict__ c, const float* __restrict__ d,
          float* __restrict__ o, long long n) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i < n) o[i] = a[i] * b[i] - c[i] * d[i];
}

__global__ void __launch_bounds__(kThreads)
k3_kernel(const float* __restrict__ a, const float* __restrict__ b,
          const float* __restrict__ c, const float* __restrict__ d,
          float* __restrict__ o, long long n) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i < n) o[i] = a[i] * b[i] + c[i] * d[i];
}

unsigned blocks(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// which = 1, 2, 3 selects k1, k2, k3 (k1 ignores d). a, b, c, d, out: n
// f32 each. Returns cudaGetLastError() after the launch.
int mrc_probe_fma(int which, const float* a, const float* b, const float* c,
                  const float* d, float* out, long long n, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (which == 1)
        k1_kernel<<<blocks(n), kThreads, 0, s>>>(a, b, c, out, n);
    else if (which == 2)
        k2_kernel<<<blocks(n), kThreads, 0, s>>>(a, b, c, d, out, n);
    else if (which == 3)
        k3_kernel<<<blocks(n), kThreads, 0, s>>>(a, b, c, d, out, n);
    else
        return -1;
    return (int)cudaGetLastError();
}

}  // extern "C"
