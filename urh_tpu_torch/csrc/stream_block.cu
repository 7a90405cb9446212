// The fused stream block (B6) for Hopper (sm_90a): urh_stream_block_f32
// and urh_stream_block_i8.
//
// Replaces urh_tpu/protocol/stream.py's XLA programs _runs_body,
// _block_runs, _block_runs_i8 and _device_rle (and, by the states its
// first pass leaves behind, _block_states).  Per chunk of a stream: an
// optional int8 ingest (x * 1/128), the ASK or FSK demod (fused_demod.cuh,
// with the previous chunk's last sample as sample 0, the halo, when there
// is one), the multi-threshold decision, drop_first, the runs packed as
// (len << state_bits) | (state + 1) into a zero-filled int32 bundle
// [n_runs, peak bits, packed[cap]], and peak = max I^2 + Q^2 over the
// whole block, halo included.  Only the bundle goes back to the host.
//
// Three launches on the caller's stream and no host sync:
//   (i)   one thread per state: demod and decide, write the int8 state to
//         scratch, take the previous state from the lane before (lane 0
//         decides it itself), find run starts by ballot, and write per
//         tile (256 states) the number of starts, the first start and the
//         peak;
//   (ii)  one block: exclusive scan of the tile counts (run ranks), for
//         each tile the first start of a later tile, the peak; writes the
//         bundle's head;
//   (iii) one thread per state again: each run start of rank r < cap
//         writes its packed entry, its length the next start (same warp
//         by ballot, same block by the warps' ballots, else the later
//         tile's first) minus its own, or the block's end; the rest of the
//         bundle is zeroed.
// When n_runs > cap the caller reads the per-sample states of pass (i)
// instead (urh_tpu's fallback, stream.py:464-474).  urh_tpu pads a block to
// 8,192-sample buckets only to bound XLA's compiled shapes; here cap is
// n // 4 + 8 of the true length and nothing is padded, and the segments
// come out the same once urh_tpu's _clip_runs has cut its padding off.
//
// Bound: the bytes, 8 (float32) or 2 (int8) B a sample in, the bundle
// out (4 B a run, plus 8); the scratch (1 B a sample written in (i) and
// read in (iii)) is this design's own traffic.  A single-pass decoupled
// look-back scan would drop it and two launches.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_block.cuh"

namespace {

constexpr int kTile = 256;      // states a block of passes (i) and (iii)
constexpr int kWarps = kTile / 32;
constexpr int kScanThreads = 1024;
constexpr int32_t kNone = 0x7fffffff;

struct Params {
    int64_t n;         // samples in the block, halo included
    int64_t n_states;  // n - drop
    int drop;          // 1 when sample 0 is the halo
    float noise_sqrd, max_mag, sentinel;
    int fsk;
    const float* thr;
    int n_thr;
    int64_t cap;
    int state_bits;
};

__device__ inline void sample_at(const float* x, int64_t i, float& re, float& im) {
    re = x[2 * i];
    im = x[2 * i + 1];
}

__device__ inline void sample_at(const int8_t* x, int64_t i, float& re, float& im) {
    re = urh_i8_to_f32(x[2 * i]);
    im = urh_i8_to_f32(x[2 * i + 1]);
}

template <typename T>
__device__ inline float mag2_at(const T* x, int64_t i) {
    float re, im;
    sample_at(x, i, re, im);
    return re * re + im * im;
}

// state of sample i (>= 0) of the block
template <typename T>
__device__ inline int8_t state_at(const T* x, int64_t i, const Params& p) {
    float re, im, pr = 0.0f, pi = 0.0f;
    sample_at(x, i, re, im);
    if (i > 0) sample_at(x, i - 1, pr, pi);
    const float q = urh_stream_qad(pr, pi, re, im, i, p.noise_sqrd, p.max_mag, p.fsk);
    return urh_stream_state(q, p.thr, p.n_thr, p.sentinel);
}

template <typename T>
__global__ void __launch_bounds__(kTile)
states_kernel(const T* __restrict__ x, Params p, int8_t* __restrict__ states,
              int32_t* __restrict__ tiles, int64_t n_tiles) {
    __shared__ int32_t w_count[kWarps], w_first[kWarps];
    __shared__ float w_peak[kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t k = (int64_t)blockIdx.x * kTile + threadIdx.x;
    const bool active = k < p.n_states;
    int8_t s = 0;
    float peak = 0.0f;
    if (active) {
        s = state_at(x, k + p.drop, p);
        states[k] = s;
        peak = mag2_at(x, k + p.drop);
    }
    if (k == 0)
        for (int64_t i = 0; i < p.drop && i < p.n; ++i) peak = fmaxf(peak, mag2_at(x, i));
    int prev = __shfl_up_sync(0xffffffffu, (int)s, 1);
    if (lane == 0 && active && k > 0) prev = state_at(x, k - 1 + p.drop, p);
    const unsigned mask = __ballot_sync(0xffffffffu, active && (k == 0 || s != prev));
#pragma unroll
    for (int off = 16; off; off >>= 1)
        peak = fmaxf(peak, __shfl_xor_sync(0xffffffffu, peak, off));
    if (lane == 0) {
        w_count[warp] = __popc(mask);
        w_first[warp] = mask ? (int32_t)(k + __ffs(mask) - 1) : kNone;
        w_peak[warp] = peak;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int32_t count = 0, first = kNone;
        float block_peak = 0.0f;
        for (int w = 0; w < kWarps; ++w) {
            count += w_count[w];
            if (first == kNone) first = w_first[w];
            block_peak = fmaxf(block_peak, w_peak[w]);
        }
        tiles[blockIdx.x] = count;
        tiles[n_tiles + blockIdx.x] = first;
        tiles[2 * n_tiles + blockIdx.x] = __float_as_int(block_peak);
    }
}

// Turns tile counts into exclusive offsets and tile firsts into "first
// start of a later tile" in place; writes the bundle's head.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int32_t* __restrict__ tiles, int64_t n_tiles, int64_t n_states,
            int32_t* __restrict__ bundle) {
    __shared__ int32_t s_sum[kScanThreads / 32], s_min[kScanThreads / 32];
    __shared__ float s_peak[kScanThreads / 32];
    int32_t* count = tiles;
    int32_t* first = tiles + n_tiles;
    const float* peak = reinterpret_cast<const float*>(tiles + 2 * n_tiles);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t per = (n_tiles + kScanThreads - 1) / kScanThreads;
    const int64_t lo = threadIdx.x * per;
    const int64_t hi = lo + per < n_tiles ? lo + per : n_tiles;
    int32_t sum = 0, fmin = kNone;
    float pmax = 0.0f;
    for (int64_t b = lo; b < hi; ++b) {
        sum += count[b];
        fmin = min(fmin, first[b]);
        pmax = fmaxf(pmax, peak[b]);
    }
    // exclusive prefix sum of sum and exclusive suffix min of fmin over threads
    int32_t incl = sum, suf = fmin;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int32_t a = __shfl_up_sync(0xffffffffu, incl, off);
        const int32_t m = __shfl_down_sync(0xffffffffu, suf, off);
        if (lane >= off) incl += a;
        if (lane + off < 32) suf = min(suf, m);
        pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
    }
    if (lane == 31) s_sum[warp] = incl;
    if (lane == 0) {
        s_min[warp] = suf;
        s_peak[warp] = pmax;
    }
    __syncthreads();
    int32_t before = 0, after = kNone;
    float total_peak = 0.0f;
    int32_t total = 0;
    for (int w = 0; w < kScanThreads / 32; ++w) {
        if (w < warp) before += s_sum[w];
        if (w > warp) after = min(after, s_min[w]);
        total += s_sum[w];
        total_peak = fmaxf(total_peak, s_peak[w]);
    }
    int32_t running = before + incl - sum;
    // the suffix min of the later lanes of this warp
    int32_t later = __shfl_down_sync(0xffffffffu, suf, 1);
    if (lane == 31) later = kNone;
    int32_t next = min(after, later);
    for (int64_t b = lo; b < hi; ++b) {
        const int32_t c = count[b];
        count[b] = running;
        running += c;
    }
    for (int64_t b = hi - 1; b >= lo; --b) {
        const int32_t f = first[b];
        first[b] = next;
        next = min(next, f);
    }
    if (threadIdx.x == 0) {
        bundle[0] = n_states > 0 ? total : 1;  // _device_rle counts 1 run of nothing
        bundle[1] = __float_as_int(total_peak);
    }
}

__global__ void __launch_bounds__(kTile)
pack_kernel(const int8_t* __restrict__ states, const int32_t* __restrict__ tiles,
            int64_t n_tiles, Params p, int32_t* __restrict__ bundle) {
    __shared__ unsigned w_mask[kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t k = (int64_t)blockIdx.x * kTile + threadIdx.x;
    const bool active = k < p.n_states;
    const int s = active ? states[k] : 0;
    const bool start = active && (k == 0 || s != states[k - 1]);
    const unsigned mask = __ballot_sync(0xffffffffu, start);
    if (lane == 0) w_mask[warp] = mask;
    __syncthreads();
    if (start) {
        int64_t rank = tiles[blockIdx.x] + __popc(mask & ((1u << lane) - 1));
        for (int w = 0; w < warp; ++w) rank += __popc(w_mask[w]);
        if (rank < p.cap) {
            int64_t next = p.n_states;  // the last entry runs to the end
            if (rank != p.cap - 1) {
                const unsigned later = lane == 31 ? 0u : mask & (~0u << (lane + 1));
                const int64_t base = (int64_t)blockIdx.x * kTile;
                if (later) {
                    next = base + warp * 32 + __ffs(later) - 1;
                } else {
                    int w = warp + 1;
                    while (w < kWarps && !w_mask[w]) ++w;
                    if (w < kWarps)
                        next = base + w * 32 + __ffs(w_mask[w]) - 1;
                    else if (tiles[n_tiles + blockIdx.x] != kNone)
                        next = tiles[n_tiles + blockIdx.x];
                }
            }
            bundle[2 + rank] = urh_pack_run(next - k, s, p.state_bits);
        }
    }
    // entries past the last run (or all, for no state) stay 0
    const int64_t runs = p.n_states > 0 ? bundle[0] : 0;
    const int64_t filled = runs < p.cap ? runs : p.cap;
    const int64_t stride = (int64_t)gridDim.x * kTile;
    for (int64_t j = filled + (int64_t)blockIdx.x * kTile + threadIdx.x; j < p.cap; j += stride)
        bundle[2 + j] = 0;
}

template <typename T>
int launch(const T* x, int64_t n, int drop, float noise_sqrd, float max_mag, int fsk,
           const float* thr, int n_thr, int64_t cap, int state_bits, int8_t* states,
           int32_t* tiles, int32_t* bundle, void* stream) {
    Params p{n, n - drop, drop, noise_sqrd, max_mag,
             fsk ? URH_FSK_SENTINEL : URH_ASK_SENTINEL, fsk, thr, n_thr, cap, state_bits};
    const int64_t n_tiles = (p.n_states > 0 ? p.n_states + kTile - 1 : kTile) / kTile;
    cudaStream_t s = (cudaStream_t)stream;
    states_kernel<T><<<(unsigned)n_tiles, kTile, 0, s>>>(x, p, states, tiles, n_tiles);
    scan_kernel<<<1, kScanThreads, 0, s>>>(tiles, n_tiles, p.n_states, bundle);
    pack_kernel<<<(unsigned)n_tiles, kTile, 0, s>>>(states, tiles, n_tiles, p, bundle);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: n interleaved samples; thr: n_thr ascending float32 thresholds on the
// card; states: n - drop int8 scratch; tiles: 3 * n_tiles int32 scratch
// (n_tiles = ceil(max(n - drop, 1) / 256)); bundle: 2 + cap int32.
int urh_stream_block_f32(const float* x, int64_t n, int drop, float noise_sqrd,
                         float max_mag, int fsk, const float* thr, int n_thr, int64_t cap,
                         int state_bits, int8_t* states, int32_t* tiles, int32_t* bundle,
                         void* stream) {
    return launch(x, n, drop, noise_sqrd, max_mag, fsk, thr, n_thr, cap, state_bits,
                  states, tiles, bundle, stream);
}

int urh_stream_block_i8(const int8_t* x, int64_t n, int drop, float noise_sqrd,
                        float max_mag, int fsk, const float* thr, int n_thr, int64_t cap,
                        int state_bits, int8_t* states, int32_t* tiles, int32_t* bundle,
                        void* stream) {
    return launch(x, n, drop, noise_sqrd, max_mag, fsk, thr, n_thr, cap, state_bits,
                  states, tiles, bundle, stream);
}

}  // extern "C"
