// The forward-window median filter (B7) for Hopper (sm_90a):
// urh_median_filter_f32.
//
// Replaces urh_tpu/ai/device.py:_median_full_windows_jax (an odd-even
// transposition network of about k^2 / 2 min/max passes over k shifted
// views) and _median_filtered_jax (the network plus k - 1 jnp.sort calls
// for the shrunk tail), which auto-interpretation runs on the Haar CWT
// magnitudes of every width bucket (classification_stats): out[r, i] is the
// median of rows[r, i : min(i + k, W)], the value at index kk / 2 of its kk
// sorted values.  Selection and key order are in median_filter.cuh.
//
// Bound.  The filter reads each float32 once and writes each output once,
// 8 bytes a cell: at 3.35 TB/s the main path's bucket (2 x 100 rows of
// 16,368, k = 11) takes 7.8 us.  A selection needs at least kk - 1
// comparisons an output (10 here), 0.5 us at the float32 rate.  The bytes
// bound it.
//
// Design: simple and exact first.  One thread an output, 256 outputs of one
// row a block (blocks walk rows, then tiles of a row, in one flat grid).
// The block converts its 256 + kk - 1 values (the tile and its halo) to
// keys in shared memory, one coalesced pass; each thread then runs the rank
// count over its window in shared memory (neighbouring threads read
// neighbouring words, so no bank conflicts): at most kk^2 integer
// comparisons, about 121 at k = 11, which makes the kernel bound by its
// comparisons, not by its bytes.  A sorting network or an incremental
// window would cut them; that is a later redesign.  Windows wider than the
// row shrink to it (kk = min(k, W)); a halo that does not fit in 48 KB of
// shared memory (kk above 12,033) is read from device memory instead.
#include <cuda_runtime.h>
#include <stdint.h>

#include "median_filter.cuh"

namespace {

constexpr int kThreads = 256;  // outputs a block
constexpr size_t kMaxShared = 48 * 1024;

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
median_kernel(const float* __restrict__ x, int64_t w, int64_t tiles, int k,
              float* __restrict__ out) {
    extern __shared__ int32_t keys[];
    const int64_t r = blockIdx.x / tiles;
    const int64_t i0 = (blockIdx.x % tiles) * kThreads;
    const float* row = x + r * w;
    const int64_t i = i0 + threadIdx.x;
    if (kStaged) {
        const int64_t span = kThreads + k - 1;
        for (int64_t t = threadIdx.x; t < span && i0 + t < w; t += kThreads)
            keys[t] = urh_median_key(row[i0 + t]);
        __syncthreads();
    }
    if (i >= w) return;
    const int kk = (int)(k < w - i ? k : w - i);
    int32_t key;
    if (kStaged) {
        const int32_t* win = keys + threadIdx.x;
        key = urh_median_select([&](int j) { return win[j]; }, kk, kk / 2);
    } else {
        const float* win = row + i;
        key = urh_median_select([&](int j) { return urh_median_key(win[j]); }, kk, kk / 2);
    }
    out[r * w + i] = urh_median_value(key);
}

}  // namespace

extern "C" {

// x: rows * w contiguous float32, one row after another; out: the same
// shape.  1 <= k <= w (the wrapper clamps k to the row).  Returns
// cudaGetLastError().
int urh_median_filter_f32(const float* x, int64_t rows, int64_t w, int64_t k, float* out,
                          void* stream) {
    if (rows <= 0 || w <= 0) return 0;
    const int64_t tiles = (w + kThreads - 1) / kThreads;
    const int64_t blocks = rows * tiles;
    if (k < 1 || k > w || blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    const size_t shared = (size_t)(kThreads + k - 1) * sizeof(int32_t);
    if (shared <= kMaxShared)
        median_kernel<true><<<(unsigned)blocks, kThreads, shared, (cudaStream_t)stream>>>(
            x, w, tiles, (int)k, out);
    else
        median_kernel<false><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
            x, w, tiles, (int)k, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
