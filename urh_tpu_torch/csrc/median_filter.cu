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
// 16,368, k = 11) takes 7.8 us.  But a selection is integer work, and
// Hopper's integer pipe (compares, selects, min/max) issues 64 lanes an SM
// a cycle, about 16.7 T operations a second on 132 SMs at 1.98 GHz: at the
// byte bound that leaves about 40 operations an output, loads and key
// conversion included.
//
// Design: the window kernel, for k <= kUrhMedianMaxK (16), k a template
// argument so that a thread's keys live in registers.  A block of
// kUrhMedianThreads (128) threads takes 128 * T consecutive outputs of one
// row (one launch, a grid of tiles by rows).  It loads its tile and the k -
// 1 halo columns in one coalesced pass (all of a thread's loads issued
// before any is used), converts them to keys in shared memory, padded past
// the row's end, and a thread then takes T = 5 consecutive outputs
// (kUrhMedianT).  Their windows share the k - T + 1 keys of columns T - 1
// ... k - 1: the thread sorts those once by a sorting network (16
// exchanges for k = 11) and merges each output's own T - 1 keys into them
// (urh_median_core_run), about 23 instructions an output against the rank
// count's k^2 comparisons.  Where the row ends in a thread's windows, it
// slides one sorted window instead (drop the outgoing key, insert the
// incoming one; padding keys sort last) and picks the shrunk window's
// place, in the same launch.  The tile's staging, indexing and copy out
// are UrhMedianTile's (median_filter.cuh), which the tests also run on the
// host.  On the H100 the bucket takes 0.016 ms, about half its byte bound,
// of which some 7 us are the launch, the first loads and the last wave;
// 2^25 cells run at 81-82% of the bound (PERF.md).
//
// Wider windows (k > 16) keep the first design, one thread an output by a
// rank count over the window in shared memory (at most kk^2 comparisons);
// a halo that does not fit in 48 KB of shared memory (kk above 12,033) is
// read from device memory instead.  Windows wider than the row shrink to it
// (the wrapper passes kk = min(k, W)).
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <utility>

#include "median_filter.cuh"

namespace {

constexpr int kThreads = 256;  // outputs a block of the rank-count kernel
constexpr size_t kMaxShared = 48 * 1024;

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
median_rank_kernel(const float* __restrict__ x, int64_t w, int64_t tiles, int k,
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

// Block (i, j, l) takes tile i of row l * gridDim.y + j.
template <int K, int T>
__global__ void __launch_bounds__(kUrhMedianThreads)
median_window_kernel(const float* __restrict__ x, int64_t rows, int64_t w,
                     float* __restrict__ out) {
    using Tile = UrhMedianTile<K, T>;
    __shared__ int32_t keys[Tile::kKeys];
    __shared__ int32_t res[Tile::kRes];
    const int64_t r = (int64_t)blockIdx.z * gridDim.y + blockIdx.y;
    if (r >= rows) return;  // the last layer's rows past the end
    const int64_t i0 = (int64_t)blockIdx.x * Tile::kOut;
    const int span = Tile::span(w - i0);
    const float* row = x + r * w + i0;
    float v[Tile::kLoads];
#pragma unroll
    for (int m = 0; m < Tile::kLoads; ++m) v[m] = Tile::load(row, m, threadIdx.x, span);
#pragma unroll
    for (int m = 0; m < Tile::kLoads; ++m) Tile::stage(keys, m, threadIdx.x, v[m], span);
    __syncthreads();
    Tile::run(keys, res, threadIdx.x, span);
    __syncthreads();
    float* dst = out + r * w + i0;
#pragma unroll
    for (int m = 0; m < T; ++m) Tile::write(dst, res, m, threadIdx.x, span);
}

// One launch: a grid of tiles by rows, in layers of 65,535 rows (the
// grid's height).
template <int K>
int launch_window(const float* x, int64_t rows, int64_t w, float* out, cudaStream_t stream) {
    constexpr int T = urh_median_outputs(K);
    const int64_t tiles = (w + UrhMedianTile<K, T>::kOut - 1) / UrhMedianTile<K, T>::kOut;
    const int64_t height = rows < 65535 ? rows : 65535;
    const int64_t layers = (rows + height - 1) / height;
    if (tiles > 0x7FFFFFFF || layers > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)tiles, (unsigned)height, (unsigned)layers);
    median_window_kernel<K, T><<<grid, kUrhMedianThreads, 0, stream>>>(x, rows, w, out);
    return (int)cudaGetLastError();
}

template <int K>
cudaError_t window_attributes(cudaFuncAttributes* attr) {
    return cudaFuncGetAttributes(attr, median_window_kernel<K, urh_median_outputs(K)>);
}

using WindowLaunch = int (*)(const float*, int64_t, int64_t, float*, cudaStream_t);
using WindowAttributes = cudaError_t (*)(cudaFuncAttributes*);

template <int... I>
std::array<WindowLaunch, sizeof...(I)> window_launches(std::integer_sequence<int, I...>) {
    return {{launch_window<I + 1>...}};
}

template <int... I>
std::array<WindowAttributes, sizeof...(I)> window_attribute_fns(
    std::integer_sequence<int, I...>) {
    return {{window_attributes<I + 1>...}};
}

// the window kernel for K = 1 ... kUrhMedianMaxK, at index K - 1
const auto kWindowLaunch =
    window_launches(std::make_integer_sequence<int, kUrhMedianMaxK>{});
const auto kWindowAttributes =
    window_attribute_fns(std::make_integer_sequence<int, kUrhMedianMaxK>{});

}  // namespace

extern "C" {

// x: rows * w contiguous float32, one row after another; out: the same
// shape.  1 <= k <= w (the wrapper clamps k to the row).  Returns
// cudaGetLastError().
int urh_median_filter_f32(const float* x, int64_t rows, int64_t w, int64_t k, float* out,
                          void* stream) {
    if (rows <= 0 || w <= 0) return 0;
    if (k < 1 || k > w) return (int)cudaErrorInvalidValue;
    if (k <= kUrhMedianMaxK) return kWindowLaunch[k - 1](x, rows, w, out, (cudaStream_t)stream);
    const int64_t tiles = (w + kThreads - 1) / kThreads;
    const int64_t blocks = rows * tiles;
    if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    const size_t shared = (size_t)(kThreads + k - 1) * sizeof(int32_t);
    if (shared <= kMaxShared)
        median_rank_kernel<true><<<(unsigned)blocks, kThreads, shared, (cudaStream_t)stream>>>(
            x, w, tiles, (int)k, out);
    else
        median_rank_kernel<false><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
            x, w, tiles, (int)k, out);
    return (int)cudaGetLastError();
}

// The kernel urh_median_filter_f32 launches for the window k (>= 1): 1 the
// window kernel, 0 the rank count; -1 if the CUDA runtime cannot say.
// Writes the consecutive outputs a thread takes at a time and the outputs
// a block, and the registers and local-memory bytes a thread of that kernel.
int urh_median_filter_variant(int64_t k, int* outputs, int* block_outputs, int* regs,
                              int* local_bytes) {
    cudaFuncAttributes attr;
    const bool window = k >= 1 && k <= kUrhMedianMaxK;
    const cudaError_t err = window ? kWindowAttributes[k - 1](&attr)
                                   : cudaFuncGetAttributes(&attr, median_rank_kernel<true>);
    if (err != cudaSuccess) return -1;
    *outputs = window ? urh_median_outputs((int)k) : 1;
    *block_outputs = window ? *outputs * kUrhMedianThreads : kThreads;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    return window ? 1 : 0;
}

}  // extern "C"
