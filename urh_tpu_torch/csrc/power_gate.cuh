// The power gate's per-sample arithmetic, shared by the CUDA kernel
// (power_gate.cu) and the g++ build of tests/test_torch_power_gate.py.
//
// A sample's magnitude is the host's (IQData.magnitudes, an einsum in
// float64): re and im in float64, each square exact (a float32 or 16-bit
// integer has at most 24 significant bits, its square at most 48), their
// sum rounded once, an IEEE square root.  So the card's float64 magnitudes
// equal the host's to the bit, with or without contraction into an FMA.
// detect_noise_level reads them as float32 (round to nearest).
#pragma once

#include <math.h>
#include <stdint.h>

// Threads a block, in both passes.
constexpr int kUrhGateThreads = 256;
// Blocks a 1%-chunk (row) of the statistics pass.
constexpr int kUrhGateRowBlocks = 8;
// Samples a thread of the crossings pass: a tile is kUrhGateThreads *
// kUrhGateTileIters samples, sample first + k * kUrhGateThreads + thread at
// step k.
constexpr int kUrhGateTileIters = 16;

template <typename T>
__host__ __device__ inline double urh_gate_magnitude(T re, T im) {
    const double r = (double)re, i = (double)im;
    return sqrt(r * r + i * i);
}

// The float32 level of a magnitude, as the host's astype(np.float32).
__host__ __device__ inline float urh_gate_level(double m) { return (float)m; }

// The larger level, NaN kept once met (as np.max and torch.amax).
__host__ __device__ inline float urh_gate_max(float best, float x) {
    return (x > best || x != x) ? x : best;
}
