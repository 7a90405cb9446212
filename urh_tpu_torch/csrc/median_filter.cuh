// Per-element arithmetic of the forward-window median filter (B7).
//
// Shared by the CUDA kernel (median_filter.cu, built by nvcc) and by a host
// build (g++ with -D__host__= -D__device__=) in
// tests/test_torch_kernel_math.py, which holds the selection against
// np.sort.
//
// The filter sorts in one total order of the float32 values, held by
// signed 32-bit keys: -inf < ... < -0.0 < +0.0 < ... < +inf < NaN.  Every
// NaN takes one key above +inf, as np.sort puts NaN last (and comes back as
// the canonical quiet NaN).  -0.0 sorts below +0.0: urh_tpu's two routes
// leave the sign of a zero median to their sort (np.sort) or their min/max
// network, and disagree with each other there.  Equal keys are equal
// values, so an order statistic is one key whatever the order of ties, and
// the kernel, its plain PyTorch version (which sorts the same keys) and
// any correct selection give the same bits.
#pragma once

#include <stdint.h>
#include <string.h>

#define URH_MEDIAN_NAN_KEY ((int32_t)0x7FC00000)  // the key of every NaN
#define URH_MEDIAN_SIGN_FLIP ((int32_t)0x7FFFFFFF)

// The key of v: its bits for a non-negative float, the bits with all but
// the sign flipped for a negative one (so that a larger magnitude is a
// smaller integer), URH_MEDIAN_NAN_KEY for NaN.
__host__ __device__ inline int32_t urh_median_key(float v) {
    int32_t bits;
    memcpy(&bits, &v, sizeof bits);
    if (v != v) return URH_MEDIAN_NAN_KEY;
    return bits < 0 ? bits ^ URH_MEDIAN_SIGN_FLIP : bits;
}

// The float32 of a key (the inverse of urh_median_key but for NaN payloads).
__host__ __device__ inline float urh_median_value(int32_t key) {
    const int32_t bits = key < 0 ? key ^ URH_MEDIAN_SIGN_FLIP : key;
    float v;
    memcpy(&v, &bits, sizeof v);
    return v;
}

// The key at position m of the kk keys key(0) ... key(kk - 1) once sorted:
// the first key with fewer than m + 1 keys below it and more than m at or
// below it.  A rank count, kk * kk comparisons at most; key(i) is a
// callable, so the kernel reads shared memory or device memory through it.
template <typename Key>
__host__ __device__ inline int32_t urh_median_select(Key key, int kk, int m) {
    for (int j = 0; j < kk; ++j) {
        const int32_t v = key(j);
        int below = 0, at_or_below = 0;
        for (int i = 0; i < kk; ++i) {
            const int32_t u = key(i);
            below += u < v;
            at_or_below += u <= v;
        }
        if (below <= m && m < at_or_below) return v;
    }
    return key(0);  // not reached for 0 <= m < kk
}

// out[i] of one row of w values: the median of the window x[i, min(i + k,
// w)), the value at index kk / 2 of its kk sorted values (the upper median
// for an even kk, as urh_tpu takes it).  k >= 1.
__host__ __device__ inline float urh_median_at(const float* x, int64_t w, int64_t k,
                                               int64_t i) {
    const int kk = (int)(k < w - i ? k : w - i);
    return urh_median_value(
        urh_median_select([&](int j) { return urh_median_key(x[i + j]); }, kk, kk / 2));
}
