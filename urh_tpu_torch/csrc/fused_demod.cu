// The four fused demod kernels for Hopper (sm_90a).
//
// Each replaces a Pallas TPU kernel of urh_tpu/dsp/pallas_kernels.py:
//   urh_fsk_f32  <- fused_fsk_demod_symbolize (_fused_fsk_kernel)
//   urh_fsk_i8   <- fused_fsk_symbolize_i8    (_fused_fsk_i8_kernel)
//   urh_ask_f32  <- fused_ask_demod_symbolize (_fused_ask_kernel)
//   urh_ask_i8   <- fused_ask_symbolize_i8    (_fused_ask_i8_kernel)
//
// All four are bound by device memory: a few dozen operations per sample
// against 16 B/sample (float32 in, qad float32 + state int32 out) for the
// float32 kernels and 3 B/sample (int8 I/Q in, int8 state out) for the
// int8 ones.  At 2^24 samples and 3.35 TB/s that is 268 MB, about 80 us,
// and 50 MB, about 15 us.  The design moves no byte more than that: the
// interleaved capture is read in place (no planar split, no padding), and
// the ragged tail is masked.  The TPU kernels' (rows, 128) planes and their
// SMEM carry between sequential grid steps have no counterpart: blocks here
// run in no order and need no carry.
//
// The float32 kernels take one sample per thread, x[i-1] from the
// neighbour's load (the same cache line almost always); 8 B in flight per
// thread keeps them near their bound.  At one sample per thread the int8
// kernels had 2 B in flight per thread, about a quarter of what the card's
// DRAM latency needs at 3.35 TB/s, and ran at a quarter of their bound.  So
// an int8 thread owns kChunk consecutive samples: it issues all its
// 16-byte loads before it uses any, writes its states with 16-byte stores,
// both with the streaming cache hint, and takes the previous sample of its
// first sample from the lane before it by a warp shuffle (lane 0 reads
// those 2 B from memory, in the sector the warp before reads anyway).  The
// one thread whose chunk crosses the end runs the same chunk code on the
// tail straight from memory.  K4 needs no float at all: its state is a step
// in the integer I^2 + Q^2 (fused_demod.cuh).  The vector loads need x
// 16-byte aligned; the wrappers copy an unaligned view first.
//
// Every launcher runs on the caller's stream and returns cudaGetLastError().
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (no fast math: K3 needs the
//        IEEE sqrtf and division, and -fmad=false keeps every product
//        rounded as the plain PyTorch versions round it).
#include <cuda_runtime.h>

#include "fused_demod.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = kUrhI8Chunk;    // int8 samples per thread
constexpr int kInWords = kChunk / 2;   // 32-bit words of I/Q per chunk
constexpr int kOutWords = kChunk / 4;  // 32-bit words of states per chunk
static_assert(kChunk % 16 == 0, "an int8 chunk is a multiple of 16 samples");

inline unsigned int grid_for(int64_t threads) {
    return (unsigned int)((threads + kThreads - 1) / kThreads);
}

__device__ inline int64_t thread_sample() {
    return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

// A chunk's I/Q bytes as 32-bit words: every 16-byte load is issued
// before any word is used.
__device__ inline void load_chunk(const int8_t* src, uint32_t (&w)[kInWords]) {
    const uint4* v = reinterpret_cast<const uint4*>(src);
    uint4 q[kInWords / 4];
#pragma unroll
    for (int j = 0; j < kInWords / 4; ++j) q[j] = __ldcs(v + j);
#pragma unroll
    for (int j = 0; j < kInWords / 4; ++j) {
        w[4 * j] = q[j].x;
        w[4 * j + 1] = q[j].y;
        w[4 * j + 2] = q[j].z;
        w[4 * j + 3] = q[j].w;
    }
}

__device__ inline void unpack_chunk(const uint32_t (&w)[kInWords],
                                    int8_t (&iq)[2 * kChunk]) {
#pragma unroll
    for (int b = 0; b < 2 * kChunk; ++b) iq[b] = (int8_t)(w[b / 4] >> (8 * (b % 4)));
}

__device__ inline void store_chunk(int8_t* dst, const int8_t (&s)[kChunk]) {
    uint32_t w[kOutWords];
#pragma unroll
    for (int j = 0; j < kOutWords; ++j)
        w[j] = (uint32_t)(uint8_t)s[4 * j] | (uint32_t)(uint8_t)s[4 * j + 1] << 8 |
               (uint32_t)(uint8_t)s[4 * j + 2] << 16 | (uint32_t)(uint8_t)s[4 * j + 3] << 24;
#pragma unroll
    for (int j = 0; j < kOutWords / 4; ++j)
        __stcs(reinterpret_cast<uint4*>(dst) + j,
               make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]));
}

__global__ void fsk_f32_kernel(const float* __restrict__ x, int64_t n,
                               float noise_sqrd, float thr,
                               float* __restrict__ qad,
                               int32_t* __restrict__ states) {
    const int64_t i = thread_sample();
    if (i < n) urh_fsk_f32_at(x, i, noise_sqrd, thr, qad + i, states + i);
}

__global__ void __launch_bounds__(kThreads)
fsk_i8_kernel(const int8_t* __restrict__ x, int64_t n, float noise_sqrd,
              float tan_thr, int thr_neg, int8_t* __restrict__ states) {
    const int64_t first = thread_sample() * kChunk;
    const bool full = first + kChunk <= n;
    uint32_t w[kInWords] = {};
    if (full) load_chunk(x + 2 * first, w);
    // every lane shuffles, those past the end too: the previous sample of
    // this chunk's first is the last of the lane before, as 16-bit I/Q
    uint32_t halo = __shfl_up_sync(0xffffffffu, w[kInWords - 1] >> 16, 1);
    if ((threadIdx.x & 31) == 0 && first < n)
        halo = *reinterpret_cast<const uint16_t*>(x + 2 * (first > 0 ? first - 1 : 0));
    const int8_t halo_re = (int8_t)(halo & 0xff), halo_im = (int8_t)(halo >> 8);
    if (full) {
        int8_t iq[2 * kChunk], s[kChunk];
        unpack_chunk(w, iq);
        urh_fsk_i8_chunk(halo_re, halo_im, iq, kChunk, noise_sqrd, tan_thr, thr_neg, s);
        if (first == 0) s[0] = -1;
        store_chunk(states + first, s);
    } else if (first < n) {  // the ragged tail, straight from memory
        urh_fsk_i8_chunk(halo_re, halo_im, x + 2 * first, (int)(n - first),
                         noise_sqrd, tan_thr, thr_neg, states + first);
        if (first == 0) states[0] = -1;
    }
}

__global__ void ask_f32_kernel(const float* __restrict__ x, int64_t n,
                               float noise_sqrd, float thr, float max_mag,
                               float* __restrict__ qad,
                               int32_t* __restrict__ states) {
    const int64_t i = thread_sample();
    if (i < n) urh_ask_f32_at(x, i, noise_sqrd, thr, max_mag, qad + i, states + i);
}

__global__ void __launch_bounds__(kThreads)
ask_i8_kernel(const int8_t* __restrict__ x, int64_t n, int gate_below, int cutoff,
              int above_from_cutoff, int8_t* __restrict__ states) {
    const int64_t first = thread_sample() * kChunk;
    if (first + kChunk <= n) {
        uint32_t w[kInWords];
        int8_t iq[2 * kChunk], s[kChunk];
        load_chunk(x + 2 * first, w);
        unpack_chunk(w, iq);
        urh_ask_i8_chunk(iq, kChunk, gate_below, cutoff, above_from_cutoff, s);
        if (first == 0) s[0] = -1;
        store_chunk(states + first, s);
    } else if (first < n) {  // the ragged tail, straight from memory
        urh_ask_i8_chunk(x + 2 * first, (int)(n - first), gate_below, cutoff,
                         above_from_cutoff, states + first);
        if (first == 0) states[0] = -1;
    }
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
    fsk_i8_kernel<<<grid_for((n + kChunk - 1) / kChunk), kThreads, 0,
                    (cudaStream_t)stream>>>(x, n, noise_sqrd, tan_thr, thr_neg, states);
    return (int)cudaGetLastError();
}

int urh_ask_f32(const float* x, int64_t n, float noise_sqrd, float thr,
                float max_mag, float* qad, int32_t* states, void* stream) {
    ask_f32_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        x, n, noise_sqrd, thr, max_mag, qad, states);
    return (int)cudaGetLastError();
}

int urh_ask_i8(const int8_t* x, int64_t n, int gate_below, int cutoff,
               int above_from_cutoff, int8_t* states, void* stream) {
    ask_i8_kernel<<<grid_for((n + kChunk - 1) / kChunk), kThreads, 0,
                    (cudaStream_t)stream>>>(x, n, gate_below, cutoff,
                                            above_from_cutoff, states);
    return (int)cudaGetLastError();
}

}  // extern "C"
