// The power gate of estimation on the staged capture, for Hopper (sm_90a):
// urh_power_gate_stats and urh_power_gate_crossings.
//
// Replaces no Pallas kernel: urh_tpu runs these passes on the host
// (urh_tpu/ai/segmentation.py detect_noise_level and
// segment_messages_from_magnitudes over IQData.magnitudes, NumPy).  The
// port's estimate() ran them there too, two passes over a float64 copy of
// the capture's magnitudes, while the capture already lay on the card.
// Here they read the capture the card holds (IQData.staged_planes, (n, 2)
// in its ingest dtype, raw units), and only chunk statistics and crossing
// positions go back to the host, which settles the noise vote and the
// hysteresis (urh_tpu_torch/ai/power_gate.py).
//
// Bound.  Each pass reads the capture once: 2 * n * sizeof(T) bytes at
// 3.35 TB/s (40 us for 2^24 float32 samples, 10 us for int8); the
// crossings pass also writes 4 bytes a crossing.  A sample costs one
// float64 square root (power_gate.cuh), which the card's FP64 units take
// well inside that time.
//
// Statistics pass.  detect_noise_level's rows are the trailing full
// 1%-chunks (the first n % chunk samples skipped); for each it needs the
// float32 mean of float32(m) and their float32 max.  Block (s, r) of the
// grid (kUrhGateRowBlocks, rows) takes every kUrhGateRowBlocks *
// kUrhGateThreads-th sample of row r from s * kUrhGateThreads + thread on
// (neighbouring threads on neighbouring samples), each thread summing its
// samples' levels in float64 in order; the block halves its threads' sums
// in shared memory (v[t] += v[t + h], h = 128 .. 1), and the row's last
// block to finish (an integer ticket a row, no float atomics) adds the
// blocks' sums in block order.  The order is fixed by the geometry, so a
// run gives the same bits every time, and power_gate.gate_stats_plain
// repeats it.  The host decides on float32 pairwise means; the float64
// mean lies within a bound of it that power_gate.py derives, and the host
// recomputes the rows near a decision.  No per-sample array is written.
//
// Crossings pass.  above[i] = m[i] > noise in float64, as the host's
// comparison; the positions i in [1, n) where above[i] != above[i - 1]
// are compacted in order by a single-pass scan with decoupled look-back
// (Merrill and Garland, as stream_block.cu): a block takes the next tile
// of kUrhGateThreads * kUrhGateTileIters samples by an atomic ticket,
// finds its crossings (the sample before a warp's first from the lane
// before by a shuffle, lane 0 reading it), counts them by ballots per
// (step, warp) slot, publishes its count, looks back over its
// predecessors' published words to the nearest inclusive prefix, and
// writes its positions from there.  The last tile writes the count; tile
// 0 writes above[0].
//
// Build: as fused_demod.cu, -fmad=false and no fast math (the float64
// square root is IEEE in any case).
#include <cuda_runtime.h>
#include <stdint.h>

#include "power_gate.cuh"

namespace {

constexpr int kWarps = kUrhGateThreads / 32;
constexpr int kTile = kUrhGateThreads * kUrhGateTileIters;
constexpr int kSlots = kUrhGateTileIters * kWarps;  // (step, warp) slots a tile
static_assert(kSlots == 4 * 32, "warp 0 scans four slots a lane");
static_assert((kUrhGateThreads & (kUrhGateThreads - 1)) == 0, "the halving needs a power of 2");

// The vector type of one interleaved sample (both components, one load).
template <typename T> struct SampleOf;
template <> struct SampleOf<float> { using V = float2; };
template <> struct SampleOf<int8_t> { using V = char2; };
template <> struct SampleOf<uint8_t> { using V = uchar2; };
template <> struct SampleOf<int16_t> { using V = short2; };
template <> struct SampleOf<uint16_t> { using V = ushort2; };

// Sample i's magnitude in float64; x aligned to a sample.
template <typename T>
__device__ __forceinline__ double magnitude_at(const T* __restrict__ x, int64_t i) {
    const typename SampleOf<T>::V v = __ldg(reinterpret_cast<const typename SampleOf<T>::V*>(x) + i);
    return urh_gate_magnitude<T>((T)v.x, (T)v.y);
}

template <typename T>
__global__ void __launch_bounds__(kUrhGateThreads)
stats_kernel(const T* __restrict__ x, int64_t skip, int64_t chunk, double* partial,
             float* partial_max, unsigned* done, double* __restrict__ sums,
             float* __restrict__ maxes) {
    __shared__ double s_sum[kUrhGateThreads];
    __shared__ float s_max[kUrhGateThreads];
    __shared__ bool s_last;
    const int tid = threadIdx.x, s = blockIdx.x;
    const int64_t r = blockIdx.y;
    const int64_t stride = (int64_t)kUrhGateRowBlocks * kUrhGateThreads;
    const T* row = x + 2 * (skip + r * chunk);
    double acc = 0.0;
    float best = 0.0f;
#pragma unroll 4
    for (int64_t j = (int64_t)s * kUrhGateThreads + tid; j < chunk; j += stride) {
        const float level = urh_gate_level(magnitude_at(row, j));
        acc = acc + (double)level;
        best = urh_gate_max(best, level);
    }
    s_sum[tid] = acc;
    s_max[tid] = best;
    __syncthreads();
#pragma unroll
    for (int h = kUrhGateThreads / 2; h > 0; h >>= 1) {
        if (tid < h) {
            s_sum[tid] = s_sum[tid] + s_sum[tid + h];
            s_max[tid] = urh_gate_max(s_max[tid], s_max[tid + h]);
        }
        __syncthreads();
    }
    if (tid == 0) {
        partial[r * kUrhGateRowBlocks + s] = s_sum[0];
        partial_max[r * kUrhGateRowBlocks + s] = s_max[0];
        __threadfence();  // the partials are visible before the ticket
        s_last = atomicAdd(done + r, 1u) == kUrhGateRowBlocks - 1;
    }
    __syncthreads();
    if (s_last && tid == 0) {
        __threadfence();
        const volatile double* ps = partial + r * kUrhGateRowBlocks;
        const volatile float* pm = partial_max + r * kUrhGateRowBlocks;
        double total = 0.0;
        float m = 0.0f;
        for (int b = 0; b < kUrhGateRowBlocks; ++b) {
            total = total + ps[b];
            m = urh_gate_max(m, pm[b]);
        }
        sums[r] = total;
        maxes[r] = m;
    }
}

// A tile's published word: flag (1 its count, 2 the count of every sample
// up to its end) in the top two bits, the count below.  One aligned 64-bit
// store publishes both, so a reader never sees one without the other.
constexpr unsigned long long kCountMask = (1ull << 62) - 1;

__device__ inline void publish(unsigned long long* word, int64_t count, unsigned flag) {
    const unsigned long long v = (unsigned long long)count | (unsigned long long)flag << 62;
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(v) : "memory");
}

__device__ inline unsigned long long read_word(const unsigned long long* word) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(word) : "memory");
    return v;
}

// Warp 0 of tile t > 0: the crossings of tiles [0, t), from the
// predecessors' words back to the nearest inclusive prefix, 32 a round
// (lane l reads the predecessor at distance l + 1).
__device__ int64_t look_back(const unsigned long long* words, int64_t t) {
    const int lane = threadIdx.x & 31;
    int64_t prefix = 0;
    for (int64_t end = t;; end -= 32) {
        const int64_t q = end - 1 - lane;
        // before tile 0: an empty inclusive prefix
        unsigned long long v = q >= 0 ? read_word(words + q) : 2ull << 62;
        // the whole warp waits together for every lane's predecessor
        while (__any_sync(0xffffffffu, (v >> 62) == 0))
            if ((v >> 62) == 0) v = read_word(words + q);
        const unsigned inclusive = __ballot_sync(0xffffffffu, (v >> 62) == 2);
        const int nearest = inclusive ? __ffs(inclusive) - 1 : 32;
        int64_t mine = lane <= nearest ? (int64_t)(v & kCountMask) : 0;
#pragma unroll
        for (int off = 16; off; off >>= 1) mine += __shfl_xor_sync(0xffffffffu, mine, off);
        prefix += mine;
        if (nearest < 32) return prefix;
    }
}

template <typename T>
__global__ void __launch_bounds__(kUrhGateThreads)
crossings_kernel(const T* __restrict__ x, int64_t n, double noise, int64_t n_tiles,
                 unsigned long long* words, unsigned* ticket, int32_t* __restrict__ pos,
                 int64_t* __restrict__ meta) {
    __shared__ unsigned s_tile;
    __shared__ uint32_t s_ballot[kSlots];
    __shared__ int32_t s_off[kSlots];
    __shared__ int64_t s_base;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid == 0) s_tile = atomicAdd(ticket, 1u);
    __syncthreads();
    const int64_t t = s_tile;
    const int64_t first = t * kTile;

    uint32_t mine = 0;  // bit k: this thread's sample at step k is a crossing
#pragma unroll
    for (int k = 0; k < kUrhGateTileIters; ++k) {
        const int64_t i = first + (int64_t)k * kUrhGateThreads + tid;
        const bool above = i < n && magnitude_at(x, i) > noise;
        bool before = __shfl_up_sync(0xffffffffu, above, 1);
        if (lane == 0) before = i >= 1 && i - 1 < n && magnitude_at(x, i - 1) > noise;
        const bool crossing = i >= 1 && i < n && above != before;
        const uint32_t ballot = __ballot_sync(0xffffffffu, crossing);
        if (lane == 0) s_ballot[k * kWarps + warp] = ballot;
        mine |= (uint32_t)crossing << k;
    }
    __syncthreads();

    // warp 0: each slot's offset in the tile (slots in sample order), the
    // tile's count, the look-back
    if (warp == 0) {
        int c[4], local = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            c[q] = __popc(s_ballot[4 * lane + q]);
            local += c[q];
        }
        int inclusive = local;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, inclusive, off);
            if (lane >= off) inclusive += v;
        }
        int run = inclusive - local;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            s_off[4 * lane + q] = run;
            run += c[q];
        }
        const int64_t total = __shfl_sync(0xffffffffu, inclusive, 31);
        int64_t prefix = 0;
        if (lane == 0) publish(words + t, total, t == 0 ? 2 : 1);
        if (t > 0) {
            prefix = look_back(words, t);
            if (lane == 0) publish(words + t, prefix + total, 2);
        }
        if (lane == 0) {
            s_base = prefix;
            if (t == n_tiles - 1) meta[0] = prefix + total;
        }
        __syncwarp();  // bar.sync below is warp-aligned: meet it converged
    }
    __syncthreads();

    const int64_t base = s_base;
    const uint32_t lower = (1u << lane) - 1u;  // the lanes before this one
#pragma unroll
    for (int k = 0; k < kUrhGateTileIters; ++k) {
        if (mine >> k & 1u) {
            const int slot = k * kWarps + warp;
            pos[base + s_off[slot] + __popc(s_ballot[slot] & lower)] =
                (int32_t)(first + (int64_t)k * kUrhGateThreads + tid);
        }
    }
    if (t == 0 && tid == 0) meta[1] = n > 0 && magnitude_at(x, 0) > noise;
}

template <typename T>
int launch_stats(const void* x, int64_t skip, int64_t chunk, int64_t rows, double* partial,
                 float* partial_max, unsigned* done, double* sums, float* maxes,
                 cudaStream_t s) {
    const dim3 grid(kUrhGateRowBlocks, (unsigned)rows);
    stats_kernel<T><<<grid, kUrhGateThreads, 0, s>>>((const T*)x, skip, chunk, partial,
                                                     partial_max, done, sums, maxes);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_crossings(const void* x, int64_t n, double noise, int64_t n_tiles,
                     unsigned long long* work, int32_t* pos, int64_t* meta, cudaStream_t s) {
    crossings_kernel<T><<<(unsigned)n_tiles, kUrhGateThreads, 0, s>>>(
        (const T*)x, n, noise, n_tiles, work, reinterpret_cast<unsigned*>(work + n_tiles), pos,
        meta);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The ingest dtypes by code: 0 int8, 1 uint8, 2 int16, 3 uint16, 4 float32.

// x: (n, 2) samples aligned to a sample; rows (1 to 65,535) 1%-chunks of
// chunk samples from sample skip.  partial, partial_max: rows *
// kUrhGateRowBlocks each; done: rows zeros.  -> sums (float64) and maxes
// (float32) a row.  Returns cudaGetLastError(), or cudaErrorInvalidValue.
int urh_power_gate_stats(const void* x, int dtype, int64_t skip, int64_t chunk, int64_t rows,
                         double* partial, float* partial_max, unsigned* done, double* sums,
                         float* maxes, void* stream) {
    if (rows <= 0 || rows > 65535 || chunk <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
        case 0: return launch_stats<int8_t>(x, skip, chunk, rows, partial, partial_max, done, sums, maxes, s);
        case 1: return launch_stats<uint8_t>(x, skip, chunk, rows, partial, partial_max, done, sums, maxes, s);
        case 2: return launch_stats<int16_t>(x, skip, chunk, rows, partial, partial_max, done, sums, maxes, s);
        case 3: return launch_stats<uint16_t>(x, skip, chunk, rows, partial, partial_max, done, sums, maxes, s);
        case 4: return launch_stats<float>(x, skip, chunk, rows, partial, partial_max, done, sums, maxes, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// x: (n, 2) samples aligned to a sample, 1 <= n < 2^31; n_tiles = ceil(n /
// (kUrhGateThreads * kUrhGateTileIters)); work: n_tiles + 1 zeroed 64-bit
// words (the tiles' words, then the ticket).  -> pos: the crossings in
// order (room for n - 1), meta[0] their count, meta[1] above[0].
int urh_power_gate_crossings(const void* x, int dtype, int64_t n, double noise, int64_t n_tiles,
                             unsigned long long* work, int32_t* pos, int64_t* meta,
                             void* stream) {
    if (n <= 0 || n >= (1ll << 31) || n_tiles != (n + kTile - 1) / kTile)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
        case 0: return launch_crossings<int8_t>(x, n, noise, n_tiles, work, pos, meta, s);
        case 1: return launch_crossings<uint8_t>(x, n, noise, n_tiles, work, pos, meta, s);
        case 2: return launch_crossings<int16_t>(x, n, noise, n_tiles, work, pos, meta, s);
        case 3: return launch_crossings<uint16_t>(x, n, noise, n_tiles, work, pos, meta, s);
        case 4: return launch_crossings<float>(x, n, noise, n_tiles, work, pos, meta, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
