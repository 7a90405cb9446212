// The IIR feedback recursion (B8), one plane's per-sample step, shared by
// the CUDA kernel (iir_feedback.cu) and the g++ build of
// tests/test_torch_kernel_math.py.
//
// urh_tpu/dsp/filters.py:_iir_feedback computes, for each sample,
//     fb = sum_k b_rev[k] * y[n - N + k],   y[n] = ff[n] + fb,
// carry[0] the oldest output, from a zero carry.  The taps are real, so the
// real and imaginary planes are two independent float32 recurrences.  One
// fixed rounding order, the plain PyTorch loop's (dsp/iir_kernels.py):
//     fb = 0; for k = 0 .. N-1 (oldest output first): fb = fb + b_rev[k] * y_k;
//     y = ff + fb;
// every product and sum rounded on its own (nvcc -fmad=false, g++
// -ffp-contract=off).  y[n-1] enters last, so the loop-carried chain is one
// multiply and two adds a sample.
#pragma once

#include <stdint.h>

// Taps up to this many keep the last outputs in registers (UrhIirRing);
// more take UrhIirRingShared, a ring in shared memory.
constexpr int kUrhIirRegTaps = 8;
// The most taps the kernel takes (the shared ring's size).
constexpr int kUrhIirMaxTaps = 1024;

// One plane's last N outputs in registers, y[0] the oldest.  N is a
// template argument, so every index is a constant once the loops unroll.
template <int N>
struct UrhIirRing {
    float y[N > 0 ? N : 1];

    __host__ __device__ void clear() {
#pragma unroll
        for (int k = 0; k < N; ++k) y[k] = 0.0f;
    }

    // -> y[n] = ff + the feedback over the ring; y[n] then joins the ring
    __host__ __device__ float step(float ff, const float* b_rev) {
        float fb = 0.0f;
#pragma unroll
        for (int k = 0; k < N; ++k) fb = fb + b_rev[k] * y[k];
        const float out = ff + fb;
#pragma unroll
        for (int k = 0; k + 1 < N; ++k) y[k] = y[k + 1];
        if (N > 0) y[N > 0 ? N - 1 : 0] = out;
        return out;
    }
};

// One plane's last n outputs in a circular buffer of 2n floats (shared
// memory in the kernel), every output written twice, at slot s and s + n:
// the n outputs from the oldest on always lie together at y[head ..
// head + n), so the sum reads them in order without a wrap.  The same sum,
// in the same order.
struct UrhIirRingShared {
    float* y;
    int n;
    int head;

    __host__ __device__ void clear() {
        for (int k = 0; k < 2 * n; ++k) y[k] = 0.0f;
        head = 0;
    }

    __host__ __device__ float step(float ff, const float* b_rev) {
        const float* window = y + head;
        float fb = 0.0f;
#pragma unroll 4
        for (int k = 0; k < n; ++k) fb = fb + b_rev[k] * window[k];
        const float out = ff + fb;
        y[head] = out;  // the oldest output leaves, the newest takes its place
        y[head + n] = out;
        head = head + 1 == n ? 0 : head + 1;
        return out;
    }
};
