// Per-sample arithmetic of the fused stream block (B6): ingest, demod,
// multi-threshold decision, run packing, and the run aggregate that the
// kernel's single-pass scan combines across tiles.
//
// Shared by the CUDA kernels (stream_block.cu) and a host build (g++,
// -D__host__= -D__device__= -ffp-contract=off) in
// tests/test_torch_kernel_math.py, which runs the kernel's tile scheme
// with these functions.  The demod itself is fused_demod.cuh's per-sample
// functions, so the stream decides exactly as the offline kernels do.
#pragma once

#include <stdint.h>

#include "fused_demod.cuh"

// The kernel's tiles.  A tile is kUrhStreamThreads threads, each owning
// `groups` consecutive groups of 32 bytes of I/Q (kUrhStreamF32Group
// float32 or kUrhStreamI8Group int8 samples a group), which the block
// stages in shared memory and decides into states there.
// urh_stream_groups picks `groups` from the block's size: 1 for a chunk of
// a stream, so that many SMs share its demod, up to kUrhStreamMaxGroups
// for a large block, so that a tile's fixed latency (its scans and its
// look-back) spreads over more bytes.
constexpr int kUrhStreamThreads = 256;
constexpr int kUrhStreamTilesPerSm = 8;
constexpr int kUrhStreamF32Group = 4;
constexpr int kUrhStreamI8Group = 16;
constexpr int kUrhStreamMaxGroups = 4;

// Groups a thread for n_sub tiles of one group a thread on a card of sms
// SMs: about kUrhStreamTilesPerSm tiles an SM, 1, 2 or kUrhStreamMaxGroups.
__host__ __device__ inline int urh_stream_groups(int64_t n_sub, int64_t sms) {
    const int64_t per = n_sub / (sms * kUrhStreamTilesPerSm);
    return per >= kUrhStreamMaxGroups ? kUrhStreamMaxGroups : per >= 2 ? 2 : 1;
}

// int8 ingest: the IQData int8 -> float32 scale, one exact product.
__host__ __device__ inline float urh_i8_to_f32(int8_t v) { return (float)v * 0.0078125f; }

// Sample i of an interleaved block in float32, after the ingest.
__host__ __device__ inline void urh_stream_sample(const float* x, int64_t i, float& re,
                                                  float& im) {
    re = x[2 * i];
    im = x[2 * i + 1];
}

__host__ __device__ inline void urh_stream_sample(const int8_t* x, int64_t i, float& re,
                                                  float& im) {
    re = urh_i8_to_f32(x[2 * i]);
    im = urh_i8_to_f32(x[2 * i + 1]);
}

// qad of sample i given (pr, pi) = sample i-1 and (re, im) = sample i;
// sample 0 of a block always gets the sentinel (urh_tpu's _afp_demod_vec).
__host__ __device__ inline float urh_stream_qad(float pr, float pi, float re, float im,
                                                int64_t i, float noise_sqrd,
                                                float max_mag, int fsk) {
    if (i == 0) return fsk ? URH_FSK_SENTINEL : URH_ASK_SENTINEL;
    const float v[4] = {pr, pi, re, im};
    float q;
    int32_t unused;
    if (fsk)
        urh_fsk_f32_at(v, 1, noise_sqrd, 0.0f, &q, &unused);
    else
        urh_ask_f32_at(v, 1, noise_sqrd, 0.0f, max_mag, &q, &unused);
    return q;
}

// urh_tpu's _symbol_states_device: -1 for the sentinel, else the number of
// (ascending) thresholds strictly below q.
__host__ __device__ inline int8_t urh_stream_state(float q, const float* thr, int n_thr,
                                                   float sentinel) {
    if (q == sentinel) return -1;
    int s = 0;
    for (int k = 0; k < n_thr; ++k) s += q > thr[k] ? 1 : 0;
    return (int8_t)s;
}

// urh_stream_state of an FSK sample (i > 0) for the one threshold +-0,
// without the arctangent: atan2f(y, x) > 0 exactly when y > 0, or y is +0
// and x is negative or -0 (the angle is +pi); but for x > 0 so much larger
// than y that y / x underflows, and for NaN and infinite operands, which
// take atan2f itself.  The products are urh_fsk_f32_at's.
__host__ __device__ inline int8_t urh_fsk_state_zero(float pr, float pi, float re, float im,
                                                     float noise_sqrd) {
    const float mag2 = re * re + im * im;
    if (mag2 <= noise_sqrd) return -1;
    const float x = pr * re + pi * im;
    const float y = pr * im - pi * re;
    const bool plain = !(fabsf(x) <= 0x1.fffffep127f && fabsf(y) <= 0x1.fffffep127f) ||
                       (y > 0.0f && x > 0.0f && y < x * 0x1p-100f);
    if (plain) return atan2f(y, x) > 0.0f ? 1 : 0;
    return y > 0.0f || (y == 0.0f && !urh_sign_bit(y) && urh_sign_bit(x)) ? 1 : 0;
}

// The state of sample i (>= 0) of the block x, read from memory.
template <typename T>
__host__ __device__ inline int8_t urh_stream_state_at(const T* x, int64_t i, float noise_sqrd,
                                                      float max_mag, int fsk, const float* thr,
                                                      int n_thr) {
    float re, im, pr = 0.0f, pi = 0.0f;
    urh_stream_sample(x, i, re, im);
    if (i > 0) urh_stream_sample(x, i - 1, pr, pi);
    return urh_stream_state(urh_stream_qad(pr, pi, re, im, i, noise_sqrd, max_mag, fsk), thr,
                            n_thr, fsk ? URH_FSK_SENTINEL : URH_ASK_SENTINEL);
}

// One run as urh_tpu's _device_rle packs it: (len << state_bits) |
// (state + 1).  The stream keeps len below 2^(31 - state_bits).
__host__ __device__ inline int32_t urh_pack_run(int64_t len, int state, int state_bits) {
    return (int32_t)(((uint32_t)len << state_bits) | (uint32_t)(state + 1));
}

// What a stretch of states contributes to the bundle: its run starts
// (state index k is a start when k == 0 or its state differs from k-1's),
// the index of its last start (-1: none) and its peak I^2 + Q^2.  Starts
// only grow along the block, so the later stretch's last start is the
// larger one, and the combine is associative and commutative.
struct UrhRunAgg {
    int32_t count;
    int32_t last;
    float peak;
};

__host__ __device__ inline UrhRunAgg urh_run_agg_identity() { return UrhRunAgg{0, -1, 0.0f}; }

__host__ __device__ inline UrhRunAgg urh_run_agg_combine(UrhRunAgg a, UrhRunAgg b) {
    return UrhRunAgg{a.count + b.count, a.last > b.last ? a.last : b.last,
                     fmaxf(a.peak, b.peak)};
}

// The bundle entries (packed = bundle + 2) that the run start at state
// index k, of global rank r, writes.  Only its predecessors are known to
// it, so it writes the previous run's entry r - 1 (from prev_k, in
// prev_state, the state just before k) when 1 <= r <= cap - 1; and, as
// _device_rle ends the last entry it keeps at n_states, its own entry with
// length n_states - k when r == cap - 1.
__host__ __device__ inline void urh_start_entries(int64_t r, int64_t k, int64_t prev_k,
                                                  int prev_state, int state, int64_t n_states,
                                                  int64_t cap, int state_bits,
                                                  int32_t* packed) {
    if (r >= 1 && r <= cap - 1) packed[r - 1] = urh_pack_run(k - prev_k, prev_state, state_bits);
    if (r == cap - 1) packed[r] = urh_pack_run(n_states - k, state, state_bits);
}

// The last run's entry (rank n_runs - 1, from last_k, in the last state),
// written by the holder of state n_states - 1, when no start wrote it.
__host__ __device__ inline void urh_last_entry(int64_t n_runs, int64_t last_k, int state,
                                               int64_t n_states, int64_t cap, int state_bits,
                                               int32_t* packed) {
    if (n_runs - 1 < cap - 1)
        packed[n_runs - 1] = urh_pack_run(n_states - last_k, state, state_bits);
}

// The bundle's n_runs: _device_rle counts one run of nothing.
__host__ __device__ inline int32_t urh_stream_head_runs(int64_t n_runs, int64_t n_states) {
    return n_states > 0 ? (int32_t)n_runs : 1;
}
