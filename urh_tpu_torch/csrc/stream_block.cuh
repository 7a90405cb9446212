// Per-sample arithmetic of the fused stream block (B6): ingest, demod,
// multi-threshold decision and run packing.
//
// Shared by the CUDA kernels (stream_block.cu) and a host build (g++,
// -D__host__= -D__device__= -ffp-contract=off) in
// tests/test_torch_kernel_math.py.  The demod itself is fused_demod.cuh's
// per-sample functions, so the stream decides exactly as the offline
// kernels do.
#pragma once

#include <stdint.h>

#include "fused_demod.cuh"

// int8 ingest: the IQData int8 -> float32 scale, one exact product.
__host__ __device__ inline float urh_i8_to_f32(int8_t v) { return (float)v * 0.0078125f; }

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

// One run as urh_tpu's _device_rle packs it: (len << state_bits) |
// (state + 1).  The stream keeps len below 2^(31 - state_bits).
__host__ __device__ inline int32_t urh_pack_run(int64_t len, int state, int state_bits) {
    return (int32_t)(((uint32_t)len << state_bits) | (uint32_t)(state + 1));
}
