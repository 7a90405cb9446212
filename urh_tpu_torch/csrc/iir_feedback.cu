// The IIR feedback recursion (B8) for Hopper (sm_90a): urh_iir_feedback_f32.
//
// Replaces urh_tpu/dsp/filters.py:_iir_feedback (an XLA lax.scan), the
// feedback half of the reference's direct-form IIR filter
// (signal_functions.pyx:527-542): y[n] = ff[n] + sum_k b_rev[k] *
// y[n - N + k] over complex64 ff and N real taps, from a zero carry.
//
// Bound.  Every output depends on the one before, so a stream is one
// sequential chain; the taps are real, so the real and imaginary planes
// are two independent chains that run side by side.  In the fixed order of
// iir_feedback.cuh y[n-1] enters the sum last: one FMUL and two FADDs a
// sample on the loop-carried path, whatever N.  The chain bound is n times
// that latency at the SM clock (urh_iir_chain_cycles below measures it on
// the card: a loop of y = ff + (a + b * y) timed by clock64).  The bytes (8
// in and 8 out a sample at 3.35 TB/s) take about four hundred times less.
//
// Design.  One warp owns the stream.  Per tile of kTile samples, the warp
// copies the next tile into shared memory with cp.async (16-byte copies,
// neighbouring lanes on neighbouring addresses) before lanes 0 and 1 start
// on this one, so the copy lands while the chains run; lane 0 runs the real
// plane and lane 1 the imaginary one, the same instructions (one issue a
// sample step for both planes), each taking kGroup inputs from shared
// memory into registers ahead of its chain; the warp then stores the tile's
// outputs coalesced.  Up to
// kUrhIirRegTaps taps the last outputs live in registers (UrhIirRing, N a
// template argument: the taps too, every index constant); beyond that a
// ring in shared memory (UrhIirRingShared, up to kUrhIirMaxTaps), whose
// sum of N products is a dependent chain of N adds a sample.
//
// Build: as fused_demod.cu, -fmad=false and no fast math, so each product
// and sum rounds as the plain PyTorch loop's separate ops do.
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "iir_feedback.cuh"

namespace {

constexpr int kTile = 1024;  // complex samples a tile: 8 KB in (twice), 8 KB out
constexpr int kGroup = 32;   // samples a lane loads into registers ahead of its chain

// Issue the copies of tile t of ff (n interleaved complex samples, 16-byte
// aligned) into buf: 16 bytes (two samples) a copy, 8 for an odd last one.
__device__ inline void load_tile(const float* ff, int64_t t, int64_t n, float* buf) {
    const int64_t first = t * kTile;
    const int count = (int)(n - first < kTile ? n - first : kTile);
    for (int q = threadIdx.x; 2 * q < count; q += 32) {
        const float* src = ff + 2 * (first + 2 * q);
        if (2 * q + 1 < count)
            __pipeline_memcpy_async(buf + 4 * q, src, 16);
        else
            __pipeline_memcpy_async(buf + 4 * q, src, 8);
    }
    __pipeline_commit();
}

// The stream, tile by tile, through one ring a plane (lanes 0 and 1).
template <class Ring>
__device__ __forceinline__ void feedback_tiles(Ring& ring, const float* b_rev,
                                               const float* __restrict__ ff, int64_t n,
                                               float* __restrict__ y) {
    __shared__ __align__(16) float raw[2][2 * kTile];
    __shared__ __align__(16) float out[2 * kTile];
    const int lane = threadIdx.x;
    const int64_t tiles = (n + kTile - 1) / kTile;
    load_tile(ff, 0, n, raw[0]);
    for (int64_t t = 0; t < tiles; ++t) {
        if (t + 1 < tiles) {
            load_tile(ff, t + 1, n, raw[(t + 1) & 1]);  // that buffer's tile is done
            __pipeline_wait_prior(1);  // this lane's copies of tile t have landed
        } else {
            __pipeline_wait_prior(0);
        }
        __syncwarp();
        const int count = (int)(n - t * kTile < kTile ? n - t * kTile : kTile);
        if (lane < 2) {
            // a group's inputs come into registers before its chain runs:
            // the compiler cannot move a shared load above the store of the
            // output before it, which would put the load's latency on the chain
            const float* in = raw[t & 1] + lane;
            float* o = out + lane;
            int j = 0;
            for (; j + kGroup <= count; j += kGroup) {
                float v[kGroup];
#pragma unroll
                for (int u = 0; u < kGroup; ++u) v[u] = in[2 * (j + u)];
#pragma unroll
                for (int u = 0; u < kGroup; ++u) v[u] = ring.step(v[u], b_rev);
#pragma unroll
                for (int u = 0; u < kGroup; ++u) o[2 * (j + u)] = v[u];
            }
            for (; j < count; ++j) o[2 * j] = ring.step(in[2 * j], b_rev);
        }
        __syncwarp();
        float* dst = y + 2 * t * kTile;
        for (int q = lane; q < 2 * count; q += 32) dst[q] = out[q];
        __syncwarp();  // out is free for the next tile
    }
}

template <int N>
__global__ void __launch_bounds__(32)
iir_reg_kernel(const float* __restrict__ ff, int64_t n, const float* __restrict__ taps,
               float* __restrict__ y) {
    float b_rev[N > 0 ? N : 1];
#pragma unroll
    for (int k = 0; k < N; ++k) b_rev[k] = taps[k];
    UrhIirRing<N> ring;
    ring.clear();
    feedback_tiles(ring, b_rev, ff, n, y);
}

__global__ void __launch_bounds__(32)
iir_shared_kernel(const float* __restrict__ ff, int64_t n, const float* __restrict__ taps,
                  int n_taps, float* __restrict__ y) {
    __shared__ float b_rev[kUrhIirMaxTaps];
    __shared__ float history[2][2 * kUrhIirMaxTaps];
    for (int k = threadIdx.x; k < n_taps; k += 32) b_rev[k] = taps[k];
    UrhIirRingShared ring{history[threadIdx.x < 2 ? threadIdx.x : 0], n_taps, 0};
    if (threadIdx.x < 2) ring.clear();
    __syncwarp();
    feedback_tiles(ring, b_rev, ff, n, y);
}

// The loop-carried step alone: y = ff + (a + b * y), steps times, timed by
// the SM's cycle counter (one thread).
__global__ void chain_kernel(const float* __restrict__ c, int64_t steps,
                             long long* __restrict__ cycles, float* __restrict__ sink) {
    const float a = c[0], b = c[1], ff = c[2];
    float y = c[3];
    const long long t0 = clock64();
    for (int64_t i = 0; i < steps; i += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) y = ff + (a + b * y);
    }
    const long long t1 = clock64();
    cycles[0] = t1 - t0;
    sink[0] = y;
}

static_assert(kUrhIirRegTaps == 8, "urh_iir_feedback_f32's switch covers 0..8 taps");

template <int N>
void launch_reg(const float* ff, int64_t n, const float* taps, float* y, cudaStream_t s) {
    iir_reg_kernel<N><<<1, 32, 0, s>>>(ff, n, taps, y);
}

}  // namespace

extern "C" {

// ff, y: n interleaved complex float32 samples, 16-byte aligned; taps:
// n_taps float32, b reversed (the oldest output's tap first).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for more than
// kUrhIirMaxTaps taps.
int urh_iir_feedback_f32(const float* ff, int64_t n, const float* taps, int n_taps, float* y,
                         void* stream) {
    if (n_taps < 0 || n_taps > kUrhIirMaxTaps) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    switch (n_taps) {
        case 0: launch_reg<0>(ff, n, taps, y, s); break;
        case 1: launch_reg<1>(ff, n, taps, y, s); break;
        case 2: launch_reg<2>(ff, n, taps, y, s); break;
        case 3: launch_reg<3>(ff, n, taps, y, s); break;
        case 4: launch_reg<4>(ff, n, taps, y, s); break;
        case 5: launch_reg<5>(ff, n, taps, y, s); break;
        case 6: launch_reg<6>(ff, n, taps, y, s); break;
        case 7: launch_reg<7>(ff, n, taps, y, s); break;
        case 8: launch_reg<8>(ff, n, taps, y, s); break;
        default: iir_shared_kernel<<<1, 32, 0, s>>>(ff, n, taps, n_taps, y);
    }
    return (int)cudaGetLastError();
}

// The dependent latency of one FMUL and two FADDs, the chain's step:
// steps (a multiple of 8) of it from c = (a, b, ff, y0); cycles[0] gets
// the SM cycles they took, sink[0] the last y.
int urh_iir_chain_cycles(const float* c, int64_t steps, long long* cycles, float* sink,
                         void* stream) {
    chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(c, steps, cycles, sink);
    return (int)cudaGetLastError();
}

}  // extern "C"
