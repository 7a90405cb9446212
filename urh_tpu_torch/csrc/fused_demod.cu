// The four fused demod kernels for Hopper (sm_90a), one sample per thread.
//
// Each replaces a Pallas TPU kernel of urh_tpu/dsp/pallas_kernels.py:
//   urh_fsk_f32  <- fused_fsk_demod_symbolize (_fused_fsk_kernel)
//   urh_fsk_i8   <- fused_fsk_symbolize_i8    (_fused_fsk_i8_kernel)
//   urh_ask_f32  <- fused_ask_demod_symbolize (_fused_ask_kernel)
//   urh_ask_i8   <- fused_ask_symbolize_i8    (_fused_ask_i8_kernel)
//
// All four are bound by device memory: a few dozen flops per sample
// against 16 B/sample (float32 in, qad float32 + state int32 out) for the
// float32 kernels and 3 B/sample (int8 I/Q in, int8 state out) for the
// int8 ones.  At 2^24 samples and 3.35 TB/s that is 268 MB, about 80 us,
// and 50 MB, about 15 us.  The design moves no byte more than that: the
// interleaved capture is read in place (no planar split, no padding),
// x[i-1] comes from the neighbour's load (the same cache line almost
// always), and the ragged tail is masked.  The TPU kernels' (rows, 128)
// planes and their SMEM carry between sequential grid steps have no
// counterpart: blocks here run in no order and need no carry.  Vector
// loads and several samples per thread are left for later.
//
// Every launcher runs on the caller's stream and returns cudaGetLastError().
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (no fast math: K3/K4 need the
//        IEEE sqrtf and division, and -fmad=false keeps every product
//        rounded as the plain PyTorch versions round it).
#include <cuda_runtime.h>

#include "fused_demod.cuh"

namespace {

constexpr int kThreads = 256;

inline unsigned int grid_for(int64_t n) {
    return (unsigned int)((n + kThreads - 1) / kThreads);
}

__device__ inline int64_t thread_sample() {
    return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

__global__ void fsk_f32_kernel(const float* __restrict__ x, int64_t n,
                               float noise_sqrd, float thr,
                               float* __restrict__ qad,
                               int32_t* __restrict__ states) {
    const int64_t i = thread_sample();
    if (i < n) urh_fsk_f32_at(x, i, noise_sqrd, thr, qad + i, states + i);
}

__global__ void fsk_i8_kernel(const int8_t* __restrict__ x, int64_t n,
                              float noise_sqrd, float tan_thr, int thr_neg,
                              int8_t* __restrict__ states) {
    const int64_t i = thread_sample();
    if (i < n) states[i] = urh_fsk_i8_at(x, i, noise_sqrd, tan_thr, thr_neg);
}

__global__ void ask_f32_kernel(const float* __restrict__ x, int64_t n,
                               float noise_sqrd, float thr, float max_mag,
                               float* __restrict__ qad,
                               int32_t* __restrict__ states) {
    const int64_t i = thread_sample();
    if (i < n) urh_ask_f32_at(x, i, noise_sqrd, thr, max_mag, qad + i, states + i);
}

__global__ void ask_i8_kernel(const int8_t* __restrict__ x, int64_t n,
                              float noise_sqrd, float thr, float max_mag,
                              int8_t* __restrict__ states) {
    const int64_t i = thread_sample();
    if (i < n) states[i] = urh_ask_i8_at(x, i, noise_sqrd, thr, max_mag);
}

}  // namespace

extern "C" {

int urh_fsk_f32(const float* x, int64_t n, float noise_sqrd, float thr,
                float* qad, int32_t* states, void* stream) {
    fsk_f32_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        x, n, noise_sqrd, thr, qad, states);
    return (int)cudaGetLastError();
}

int urh_fsk_i8(const int8_t* x, int64_t n, float noise_sqrd, float tan_thr,
               int thr_neg, int8_t* states, void* stream) {
    fsk_i8_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        x, n, noise_sqrd, tan_thr, thr_neg, states);
    return (int)cudaGetLastError();
}

int urh_ask_f32(const float* x, int64_t n, float noise_sqrd, float thr,
                float max_mag, float* qad, int32_t* states, void* stream) {
    ask_f32_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        x, n, noise_sqrd, thr, max_mag, qad, states);
    return (int)cudaGetLastError();
}

int urh_ask_i8(const int8_t* x, int64_t n, float noise_sqrd, float thr,
               float max_mag, int8_t* states, void* stream) {
    ask_i8_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        x, n, noise_sqrd, thr, max_mag, states);
    return (int)cudaGetLastError();
}

}  // extern "C"
