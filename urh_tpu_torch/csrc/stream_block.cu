// The fused stream block (B6) for Hopper (sm_90a): urh_stream_block_f32
// and urh_stream_block_i8, and the states-only urh_stream_states_{f32,i8}.
//
// Replaces urh_tpu/protocol/stream.py's XLA programs _runs_body,
// _block_runs, _block_runs_i8 and _device_rle (and, by the states-only
// launch, _block_states).  Per chunk of a stream: an optional int8 ingest
// (x * 1/128), the ASK or FSK demod (fused_demod.cuh, with the previous
// chunk's last sample as sample 0, the halo, when there is one), the
// multi-threshold decision, drop_first, the runs packed as
// (len << state_bits) | (state + 1) into a zero-filled int32 bundle
// [n_runs, peak bits, packed[cap]], and peak = max I^2 + Q^2 over the
// whole block, halo included.  Only the bundle goes back to the host.
// urh_tpu pads a block to 8,192-sample buckets only to bound XLA's compiled
// shapes; here cap is n // 4 + 8 of the true length and nothing is padded,
// and the segments come out the same once urh_tpu's _clip_runs has cut its
// padding off.
//
// Bound: the bytes, 8 (float32) or 2 (int8) B a sample in and the bundle
// out (4 B a run slot, plus 8).
//
// Design: one cudaMemsetAsync (the bundle's zero padding, the tile ticket
// and the tiles' published words) and one kernel, one pass over the
// samples, a single-pass scan with decoupled look-back (Merrill and
// Garland).  A tile is kThreads threads, each owning `groups` consecutive
// 32-byte groups of samples (stream_block.cuh).
//   - Each block takes the next tile by an atomic ticket, so every tile it
//     waits on belongs to a block already running, and stages it in shared
//     memory with cp.async, coalesced 16-byte copies all in flight at once.
//   - Each thread demodulates and decides its samples from the stage, a
//     32-byte group at a time (the sample before its first is its
//     neighbour's last; a group at an end of the block is read sample by
//     sample from memory), into states packed 4 to a word in shared memory;
//     its run starts are the bytes that differ from the byte before
//     (__vcmpne4), the state before its first its neighbour's last.  A
//     block scan gives each thread the run aggregate (UrhRunAgg: starts,
//     last start) of the threads before it.  The group loop stays rolled:
//     unrolled over four groups and two decision paths the int8 kernels
//     ran to 40,000-50,000 instructions, with calls and spills, and decided
//     at a third of the speed.
//   - Warp 0 publishes the tile's aggregate in one 64-bit word with its
//     flag, looks back over 128 predecessors a round, combining their words
//     up to the nearest inclusive prefix, and publishes its own.  Every
//     value travels in the words themselves, so no fence orders anything;
//     the peak goes into the bundle's head by atomicMax.
//   - Each start of global rank r writes the previous run's entry r - 1
//     (urh_start_entries), the holder of the last state writes the last
//     run's (urh_last_entry), and the last tile the run count.
// An FSK block with the one threshold +-0 (binary FSK centred on 0)
// decides by urh_fsk_state_zero, the same states without the arctangent.
// When n_runs > cap the caller asks for the per-sample states by the
// states-only launch (urh_tpu's fallback, stream.py:464-474): no
// per-sample state leaves the chip on the common path.
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_block.cuh"

namespace {

constexpr int kThreads = kUrhStreamThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kLookBack = 4;         // predecessors a lane reads in a look-back round
constexpr int kStatesThreads = 256;  // the states-only launch, one state a thread
constexpr int kGroupBytes = 32;

static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
static_assert(kUrhStreamMaxGroups == 4, "groups a thread: 1, 2 or 4 (the staging swizzle)");

template <typename T>
struct Ingest;
template <>
struct Ingest<float> {
    static constexpr int kGroup = kUrhStreamF32Group;
};
template <>
struct Ingest<int8_t> {
    static constexpr int kGroup = kUrhStreamI8Group;
};
static_assert(kUrhStreamF32Group * 8 == kGroupBytes && kUrhStreamI8Group * 2 == kGroupBytes,
              "a group is 32 bytes");

struct Params {
    int64_t n;         // samples in the block, halo included
    int64_t n_states;  // n - drop
    int drop;          // 1 when sample 0 is the halo
    float noise_sqrd, max_mag, sentinel;
    int fsk;
    int n_thr;
    int64_t cap;
    int state_bits;
    int64_t lead;     // slots before sample 0 (16-byte alignment)
    int groups;       // groups a thread
    int64_t n_tiles;
};

// The workspace, in int32 words: the bundle, the ticket, then (8-byte
// aligned) a published 64-bit word a tile: the flag (0 nothing yet, 1 the
// tile's aggregate, 2 its inclusive prefix) and the run starts in the
// high half, the last start + 1 in the low half.  One aligned 64-bit store
// publishes value and flag together, so no fence orders them and no
// reader sees one without the other.  The peak goes straight into the
// bundle's head by atomicMax (a non-negative float orders as its bits).
struct Work {
    int32_t* bundle;
    unsigned* ticket;
    unsigned long long* tiles;
};

inline int64_t tiles_offset(int64_t cap) { return (2 + cap + 1 + 1) / 2 * 2; }

constexpr unsigned kStartsMask = (1u << 30) - 1;  // run starts fit 30 bits: n < 2^30

__device__ inline unsigned long long pack_word(UrhRunAgg a, unsigned flag) {
    const unsigned hi = ((unsigned)a.count & kStartsMask) | flag << 30;
    return (unsigned long long)hi << 32 | (unsigned)(a.last + 1);
}

__device__ inline unsigned word_flag(unsigned long long v) { return (unsigned)(v >> 62); }

__device__ inline UrhRunAgg unpack_word(unsigned long long v) {
    return UrhRunAgg{(int32_t)((unsigned)(v >> 32) & kStartsMask), (int32_t)(unsigned)v - 1,
                     0.0f};
}

__device__ inline void publish(unsigned long long* word, UrhRunAgg a, unsigned flag) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(pack_word(a, flag))
                 : "memory");
}

__device__ inline unsigned long long read_word(const unsigned long long* word) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(word) : "memory");
    return v;
}

__device__ inline UrhRunAgg warp_total(UrhRunAgg a) {
#pragma unroll
    for (int off = 16; off; off >>= 1)
        a = urh_run_agg_combine(a, UrhRunAgg{__shfl_xor_sync(0xffffffffu, a.count, off),
                                             __shfl_xor_sync(0xffffffffu, a.last, off), 0.0f});
    return a;
}

// Warp 0 of tile t > 0: the combined aggregate of tiles [0, t), from the
// predecessors' published words back to the nearest inclusive prefix.
// Lane l reads the predecessors at distances l, l + 32, l + 64 and l + 96
// of each round.
__device__ UrhRunAgg look_back(const unsigned long long* words, int64_t t) {
    const int lane = threadIdx.x & 31;
    UrhRunAgg prefix = urh_run_agg_identity();
    for (int64_t end = t;; end -= 32 * kLookBack) {
        unsigned long long v[kLookBack];
        bool pending = false;  // a predecessor of this lane has published nothing yet
#pragma unroll
        for (int m = 0; m < kLookBack; ++m) {  // all reads in flight at once
            const int64_t q = end - 1 - lane - 32 * m;
            // before tile 0: an empty inclusive prefix
            v[m] = q >= 0 ? read_word(words + q) : pack_word(urh_run_agg_identity(), 2);
            pending |= word_flag(v[m]) == 0;
        }
        // the whole warp waits together: a lane left spinning alone would
        // miss the ballot and the shuffles below
        while (__any_sync(0xffffffffu, pending)) {
            pending = false;
#pragma unroll
            for (int m = 0; m < kLookBack; ++m) {
                if (word_flag(v[m]) == 0) v[m] = read_word(words + (end - 1 - lane - 32 * m));
                pending |= word_flag(v[m]) == 0;
            }
        }
        int nearest = 32 * kLookBack;  // distance of the nearest inclusive prefix
#pragma unroll
        for (int m = 0; m < kLookBack; ++m) {
            const unsigned inclusive = __ballot_sync(0xffffffffu, word_flag(v[m]) == 2);
            if (inclusive && nearest == 32 * kLookBack) nearest = 32 * m + __ffs(inclusive) - 1;
        }
        UrhRunAgg mine = urh_run_agg_identity();
#pragma unroll
        for (int m = 0; m < kLookBack; ++m)
            if (lane + 32 * m <= nearest) mine = urh_run_agg_combine(mine, unpack_word(v[m]));
        prefix = urh_run_agg_combine(prefix, warp_total(mine));
        if (nearest < 32 * kLookBack) return prefix;
    }
}

// Where 16-byte chunk c of a tile sits in shared memory: the chunk index
// with its low three bits XORed by the next three, so that the threads of
// a quarter warp, each reading its own consecutive 32, 64 or 128 bytes,
// hit eight different bank groups, and the copies of eight consecutive
// chunks land on a permutation of eight.
__device__ inline int chunk_slot(int c) { return c ^ ((c >> 3) & 7); }

// Issue the copies of tile t into stage: the 16-byte chunks of its slots
// that hold a sample of the block (the bytes of them before x or past its
// end are copied but never used).
template <typename T>
__device__ inline void stage_tile(const T* base, int64_t t, const Params& p, uint4* stage) {
    constexpr int kChunkSlots = 8 / (int)sizeof(T);  // slots a 16-byte chunk
    const int chunks = kThreads * 2 * p.groups;
    const int64_t first = t * chunks;  // chunk index from base
    const int64_t end = (p.lead + p.n + kChunkSlots - 1) / kChunkSlots;
    const uint4* src = reinterpret_cast<const uint4*>(base);
    for (int c = threadIdx.x; c < chunks && first + c < end; c += kThreads)
        __pipeline_memcpy_async(stage + chunk_slot(c), src + first + c, 16);
    __pipeline_commit();
}

// A staged group (32 bytes) -> its samples in float32 (the int8 ingest's
// exact 1/128 scale); the last argument picks the ingest.
__device__ inline void unpack(const uint4& a, const uint4& b, float (&re)[4], float (&im)[4],
                              float) {
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        re[k] = __uint_as_float(w[2 * k]);
        im[k] = __uint_as_float(w[2 * k + 1]);
    }
}

__device__ inline void unpack(const uint4& a, const uint4& b, float (&re)[16], float (&im)[16],
                              int8_t) {
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        re[k] = urh_i8_to_f32((int8_t)(w[k / 2] >> (16 * (k % 2))));
        im[k] = urh_i8_to_f32((int8_t)(w[k / 2] >> (16 * (k % 2) + 8)));
    }
}

// The last sample of a staged 16-byte chunk, as a neighbour's previous one.
__device__ inline void last_sample(const uint4& b, float& re, float& im, float) {
    re = __uint_as_float(b.z);
    im = __uint_as_float(b.w);
}

__device__ inline void last_sample(const uint4& b, float& re, float& im, int8_t) {
    re = urh_i8_to_f32((int8_t)(b.w >> 16));
    im = urh_i8_to_f32((int8_t)(b.w >> 24));
}

// The run starts among 4 states packed in w4 (byte b the state at offset
// o + b of a thread's samples, prev the state before byte 0): 0xff in each
// byte that differs from the byte before it, and in the block's first
// state (k0 + o + b == 0), for offsets inside [lo, hi) only.
__device__ inline uint32_t start_bytes(uint32_t w4, uint32_t prev, int o, int lo, int hi,
                                       int64_t k0) {
    uint32_t starts = __vcmpne4(w4, (w4 << 8) | prev);
    if (o >= lo && o + 4 <= hi && k0 + o > 0) return starts;  // the common case
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        if (o + b < lo || o + b >= hi) starts &= ~(0xffu << (8 * b));
        else if (k0 + o + b == 0) starts |= 0xffu << (8 * b);
    }
    return starts;
}

// The decision thresholds of a launch: Binary, the one threshold in a
// register; else n of them in shared memory.
template <bool Binary>
struct Levels {
    float one;
    const float* thr;
    int n;
};

// urh_stream_state for the launch's thresholds.
template <bool Binary>
__device__ inline int8_t decision(float q, const Levels<Binary>& lv, float sentinel) {
    if (Binary) return q == sentinel ? -1 : (q > lv.one ? 1 : 0);
    return urh_stream_state(q, lv.thr, lv.n, sentinel);
}

// The state of sample i from (pr, pi), the sample before it.  Zero: an
// FSK block with the one threshold +-0 (urh_fsk_state_zero).
template <bool Fsk, bool Binary, bool Zero>
__device__ inline int8_t state_of(float pr, float pi, float re, float im, int64_t i,
                                  const Params& p, const Levels<Binary>& lv) {
    if (Zero && i > 0) return urh_fsk_state_zero(pr, pi, re, im, p.noise_sqrd);
    return decision(urh_stream_qad(pr, pi, re, im, i, p.noise_sqrd, p.max_mag, Fsk), lv,
                    p.sentinel);
}

// The states of a group of G samples that all lie in the block after its
// sample 0, 4 to a word (byte b of word m the state of sample 4m + b), and
// their peak; (pr, pi): the sample before the group, left at its last.
template <typename T, bool Fsk, bool Binary, bool Zero>
__device__ inline void group_states(const uint4& a, const uint4& b, float& pr, float& pi,
                                    const Params& p, const Levels<Binary>& lv,
                                    uint32_t (&w)[Ingest<T>::kGroup / 4], float& peak) {
    constexpr int G = Ingest<T>::kGroup;
    float re[G], im[G];
    unpack(a, b, re, im, T{});
#pragma unroll
    for (int m = 0; m < G / 4; ++m) w[m] = 0;
#pragma unroll
    for (int k = 0; k < G; ++k) {
        const int8_t state = state_of<Fsk, Binary, Zero>(pr, pi, re[k], im[k], 1, p, lv);
        w[k / 4] |= (uint32_t)(uint8_t)state << (8 * (k % 4));
        peak = fmaxf(peak, re[k] * re[k] + im[k] * im[k]);
        pr = re[k];
        pi = im[k];
    }
}

// base: x aligned down to 16 bytes, p.lead samples before x.  Tile t holds
// slots [t * span, (t + 1) * span), span = kThreads * groups * G; thread
// tid the groups * G consecutive slots from t * span + tid * groups * G.
// Dynamic shared memory: the staged tile (groups * kThreads 32-byte
// groups), then the states (G / 4 words a group, group-major, so that a
// thread reads and writes its own without bank conflicts).
template <typename T, bool Fsk, bool Binary>
__global__ void __launch_bounds__(kThreads)
block_kernel(const T* __restrict__ base, Params p, const float* __restrict__ thr, Work w) {
    constexpr int G = Ingest<T>::kGroup, W = G / 4;
    extern __shared__ __align__(16) uint4 s_dyn[];
    __shared__ unsigned s_tile;
    __shared__ float s_thr[128];
    __shared__ uint8_t s_tail[kThreads];  // each thread's last state
    __shared__ UrhRunAgg s_warp[kWarps];
    __shared__ UrhRunAgg s_prefix, s_total;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    uint4* stage = s_dyn;
    uint32_t* states = reinterpret_cast<uint32_t*>(s_dyn + kThreads * 2 * p.groups);
    // the word m of group g of this thread, and its state at offset o
    auto word = [&](int g, int m) -> uint32_t& { return states[(g * kThreads + tid) * W + m]; };
    auto state_at = [&](int o) -> int8_t {
        return (int8_t)(word(o / G, o % G / 4) >> (8 * (o % 4)));
    };
    if (tid == 0) s_tile = atomicAdd(w.ticket, 1u);
    Levels<Binary> lv{0.0f, s_thr, Binary ? 1 : p.n_thr};
    if (Binary) lv.one = __ldg(thr);
    else
        for (int k = tid; k < p.n_thr; k += kThreads) s_thr[k] = thr[k];
    __syncthreads();
    const int64_t t = s_tile;
    stage_tile(base, t, p, stage);
    const T* x = base + 2 * p.lead;  // sample 0
    const int per = p.groups * G;    // samples a thread
    const int64_t i0 = (t * kThreads + tid) * per - p.lead;  // the thread's first sample
    const int64_t k0 = i0 - p.drop;  // state index of its first sample
    const int lo = k0 < 0 ? (int)-k0 : 0;                                // its states [lo, hi)
    const int hi = p.n_states - k0 < per ? (int)(p.n_states - k0) : per;  // (none if lo >= hi)

    // thread 0: the sample before the tile, and its state
    float pr = 0.0f, pi = 0.0f;
    uint32_t before = 0;
    if (tid == 0 && i0 >= 1 && i0 - 1 < p.n) {
        urh_stream_sample(x, i0 - 1, pr, pi);
        float qr = 0.0f, qi = 0.0f;
        if (i0 >= 2) urh_stream_sample(x, i0 - 2, qr, qi);
        before = (uint8_t)state_of<Fsk, Binary, false>(qr, qi, pr, pi, i0 - 1, p, lv);
    }
    __pipeline_wait_prior(0);
    __syncthreads();

    // the states, group by group from the stage (a group at an end of the
    // block sample by sample from memory); the sample before a thread's
    // first is its neighbour's last
    const int c0 = tid * 2 * p.groups;  // the thread's first chunk in the stage
    if (tid > 0) last_sample(stage[chunk_slot(c0 - 1)], pr, pi, T{});
    const bool zero = Fsk && Binary && lv.one == 0.0f;
    float peak = 0.0f;
#pragma unroll 1
    for (int g = 0; g < p.groups; ++g) {
        const int64_t first = i0 + g * G;
        if (first >= 1 && first + G <= p.n) {  // the common case
            const uint4 a = stage[chunk_slot(c0 + 2 * g)], b = stage[chunk_slot(c0 + 2 * g + 1)];
            uint32_t wd[W];
            if (zero)
                group_states<T, Fsk, Binary, true>(a, b, pr, pi, p, lv, wd, peak);
            else
                group_states<T, Fsk, Binary, false>(a, b, pr, pi, p, lv, wd, peak);
#pragma unroll
            for (int m = 0; m < W; ++m) word(g, m) = wd[m];
        } else {
#pragma unroll 1
            for (int k = 0; k < G; ++k) {
                const int64_t i = first + k;
                float re = 0.0f, im = 0.0f;
                if (i >= 0 && i < p.n) {
                    urh_stream_sample(x, i, re, im);
                    peak = fmaxf(peak, re * re + im * im);
                }
                reinterpret_cast<uint8_t*>(&word(g, 0))[k] =
                    (uint8_t)state_of<Fsk, Binary, false>(pr, pi, re, im, i, p, lv);
                pr = re;
                pi = im;
            }
        }
    }
    s_tail[tid] = (uint8_t)state_at(per - 1);
#pragma unroll
    for (int off = 16; off; off >>= 1) peak = fmaxf(peak, __shfl_xor_sync(0xffffffffu, peak, off));
    __syncthreads();
    if (tid > 0) before = s_tail[tid - 1];

    // the thread's run starts, and a block scan of them
    UrhRunAgg mine = urh_run_agg_identity();
    {
        uint32_t prev = before;
#pragma unroll 1
        for (int g = 0; g < p.groups; ++g) {
#pragma unroll
            for (int m = 0; m < W; ++m) {
                const uint32_t wv = word(g, m);
                const uint32_t starts = start_bytes(wv, prev, g * G + 4 * m, lo, hi, k0);
                mine.count += __popc(starts & 0x01010101u);
                if (starts) mine.last = (int32_t)(k0 + g * G + 4 * m + (31 - __clz(starts)) / 8);
                prev = wv >> 24;
            }
        }
    }
    UrhRunAgg incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int c = __shfl_up_sync(0xffffffffu, incl.count, off);
        const int l = __shfl_up_sync(0xffffffffu, incl.last, off);
        if (lane >= off) incl = urh_run_agg_combine(incl, UrhRunAgg{c, l, 0.0f});
    }
    if (lane == 31) s_warp[warp] = UrhRunAgg{incl.count, incl.last, 0.0f};
    if (lane == 0) s_warp[warp].peak = peak;
    UrhRunAgg excl{incl.count - mine.count, __shfl_up_sync(0xffffffffu, incl.last, 1), 0.0f};
    if (lane == 0) excl.last = -1;
    __syncthreads();
    UrhRunAgg tile = urh_run_agg_identity();
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
        if (v < warp) excl = urh_run_agg_combine(excl, s_warp[v]);
        tile = urh_run_agg_combine(tile, s_warp[v]);
    }

    // decoupled look-back; the peak into the head
    if (warp == 0) {
        UrhRunAgg prefix = urh_run_agg_identity();
        if (lane == 0) {
            publish(w.tiles + t, tile, t == 0 ? 2 : 1);
            atomicMax(reinterpret_cast<unsigned*>(w.bundle + 1), __float_as_uint(tile.peak));
        }
        if (t > 0) {
            prefix = look_back(w.tiles, t);
            if (lane == 0) publish(w.tiles + t, urh_run_agg_combine(prefix, tile), 2);
        }
        if (lane == 0) {
            s_prefix = prefix;
            s_total = urh_run_agg_combine(prefix, tile);
        }
        __syncwarp();  // bar.sync below is warp-aligned: meet it converged
    }
    __syncthreads();
    const UrhRunAgg prefix = s_prefix, total = s_total;
    if (tid == 0 && t == p.n_tiles - 1)
        w.bundle[0] = urh_stream_head_runs(total.count, p.n_states);

    // the entries of this thread's starts, and the last run's
    int32_t* out = w.bundle + 2;
    int64_t rank = (int64_t)prefix.count + excl.count;
    int64_t prev_k = prefix.last > excl.last ? prefix.last : excl.last;
    uint32_t prev = before;
#pragma unroll 1
    for (int g = 0; g < p.groups; ++g) {
#pragma unroll
        for (int m = 0; m < W; ++m) {
            const uint32_t wv = word(g, m);
            const int o = g * G + 4 * m;
            uint32_t starts = start_bytes(wv, prev, o, lo, hi, k0) & 0x01010101u;
            const uint32_t shifted = (wv << 8) | prev;  // byte b: the state before byte b
            while (starts) {
                const int b = (__ffs(starts) - 1) / 8;
                const int64_t k = k0 + o + b;
                urh_start_entries(rank, k, prev_k, (int8_t)(shifted >> (8 * b)),
                                  (int8_t)(wv >> (8 * b)), p.n_states, p.cap, p.state_bits, out);
                prev_k = k;
                ++rank;
                starts &= starts - 1;
            }
            prev = wv >> 24;
        }
    }
    if (lo < hi && k0 + hi == p.n_states)  // this thread holds the block's last state
        urh_last_entry(total.count, total.last, state_at(hi - 1), p.n_states, p.cap,
                       p.state_bits, out);
}

template <typename T>
__global__ void __launch_bounds__(kStatesThreads)
states_kernel(const T* __restrict__ x, Params p, const float* __restrict__ thr,
              int8_t* __restrict__ states) {
    const int64_t k = (int64_t)blockIdx.x * kStatesThreads + threadIdx.x;
    if (k < p.n_states)
        states[k] = urh_stream_state_at(x, k + p.drop, p.noise_sqrd, p.max_mag, p.fsk, thr,
                                        p.n_thr);
}

Params params(int64_t n, int drop, float noise_sqrd, float max_mag, int fsk, int n_thr,
              int64_t cap, int state_bits) {
    Params p{};
    p.n = n;
    p.n_states = n - drop;
    p.drop = drop;
    p.noise_sqrd = noise_sqrd;
    p.max_mag = max_mag;
    p.sentinel = fsk ? URH_FSK_SENTINEL : URH_ASK_SENTINEL;
    p.fsk = fsk;
    p.n_thr = n_thr;
    p.cap = cap;
    p.state_bits = state_bits;
    return p;
}

int sm_count() {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    return sms;
}

// slots a tile of one group a thread
template <typename T>
constexpr int64_t sub_span() {
    return (int64_t)kThreads * Ingest<T>::kGroup;
}

template <typename T>
int launch_block(const T* x, int64_t n, int drop, float noise_sqrd, float max_mag, int fsk,
                 const float* thr, int n_thr, int64_t cap, int state_bits, int32_t* work,
                 void* stream) {
    Params p = params(n, drop, noise_sqrd, max_mag, fsk, n_thr, cap, state_bits);
    p.lead = (int64_t)(((uintptr_t)x % 16) / (2 * sizeof(T)));
    const int64_t n_sub = (p.lead + n + sub_span<T>() - 1) / sub_span<T>();
    p.groups = urh_stream_groups(n_sub, sm_count());
    p.n_tiles = (n_sub + p.groups - 1) / p.groups;
    const Work w{work, reinterpret_cast<unsigned*>(work + 2 + cap),
                 reinterpret_cast<unsigned long long*>(work + tiles_offset(cap))};
    cudaStream_t s = (cudaStream_t)stream;
    const size_t zeroed = (size_t)(tiles_offset(cap) + 2 * p.n_tiles) * 4;
    const cudaError_t rc = cudaMemsetAsync(work, 0, zeroed, s);
    if (rc != cudaSuccess) return (int)rc;
    auto kernel = fsk ? (n_thr == 1 ? block_kernel<T, true, true> : block_kernel<T, true, false>)
                      : (n_thr == 1 ? block_kernel<T, false, true> : block_kernel<T, false, false>);
    const int smem = p.groups * kThreads * (kGroupBytes + Ingest<T>::kGroup);  // stage, states
    if (smem > 32 * 1024) {  // int8's four groups a thread take 48 KB, past the default
        const cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(unsigned)p.n_tiles, kThreads, smem, s>>>(x - 2 * p.lead, p, thr, w);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_states(const T* x, int64_t n, int drop, float noise_sqrd, float max_mag, int fsk,
                  const float* thr, int n_thr, int8_t* states, void* stream) {
    const Params p = params(n, drop, noise_sqrd, max_mag, fsk, n_thr, 1, 2);
    const int64_t blocks = (p.n_states + kStatesThreads - 1) / kStatesThreads;
    if (blocks > 0)
        states_kernel<T><<<(unsigned)blocks, kStatesThreads, 0, (cudaStream_t)stream>>>(
            x, p, thr, states);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// int32 words of the workspace that urh_stream_block_{f32,i8} take for n
// samples (at any alignment) and cap; the bundle is its first 2 + cap.
int64_t urh_stream_block_work_words(int64_t n, int64_t cap, int i8) {
    const int64_t span = i8 ? sub_span<int8_t>() : sub_span<float>();
    const int64_t max_lead = i8 ? 7 : 1;
    return tiles_offset(cap) + 2 * ((n + max_lead + span - 1) / span);
}

// x: n interleaved samples, aligned to a sample; thr: n_thr (< 128)
// ascending float32 thresholds on the card; work: the workspace, bundle
// first.  A memset and one kernel on the stream; returns the CUDA error.
int urh_stream_block_f32(const float* x, int64_t n, int drop, float noise_sqrd,
                         float max_mag, int fsk, const float* thr, int n_thr, int64_t cap,
                         int state_bits, int32_t* work, void* stream) {
    return launch_block(x, n, drop, noise_sqrd, max_mag, fsk, thr, n_thr, cap, state_bits,
                        work, stream);
}

int urh_stream_block_i8(const int8_t* x, int64_t n, int drop, float noise_sqrd,
                        float max_mag, int fsk, const float* thr, int n_thr, int64_t cap,
                        int state_bits, int32_t* work, void* stream) {
    return launch_block(x, n, drop, noise_sqrd, max_mag, fsk, thr, n_thr, cap, state_bits,
                        work, stream);
}

// states: the n - drop int8 states of the block after drop_first.
int urh_stream_states_f32(const float* x, int64_t n, int drop, float noise_sqrd,
                          float max_mag, int fsk, const float* thr, int n_thr, int8_t* states,
                          void* stream) {
    return launch_states(x, n, drop, noise_sqrd, max_mag, fsk, thr, n_thr, states, stream);
}

int urh_stream_states_i8(const int8_t* x, int64_t n, int drop, float noise_sqrd,
                         float max_mag, int fsk, const float* thr, int n_thr, int8_t* states,
                         void* stream) {
    return launch_states(x, n, drop, noise_sqrd, max_mag, fsk, thr, n_thr, states, stream);
}

}  // extern "C"
