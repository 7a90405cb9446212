// Per-sample arithmetic of the four fused demod kernels.
//
// Shared by the CUDA kernels (fused_demod.cu, built by nvcc) and by a host
// build (g++ with -D__host__= -D__device__= -ffp-contract=off), so the
// kernels' own sign-bit and comparison logic is testable without a card.
// Both builds must round every product and sum separately (nvcc
// -fmad=false, g++ -ffp-contract=off): the plain PyTorch versions in
// urh_tpu_torch/dsp/fused_kernels.py run each operation as its own
// rounded tensor op, and the states must match them exactly.
//
// Input is the interleaved (N, 2) capture: x[2i] = I, x[2i+1] = Q.
// Sample i's discriminator history is x[i-1] (x[-1] := x[0]); sample 0
// always gets the noise sentinel and state -1, as urh_tpu's host entries
// overwrite it.  The float32 kernels (K1, K3) take one sample per thread
// (the *_at functions); the int8 kernels (K2, K4) take kUrhI8Chunk
// consecutive samples per thread (the *_chunk functions).
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#define URH_FSK_SENTINEL (-4.0f)
#define URH_ASK_SENTINEL (0.0f)

// Samples per thread of the int8 kernels: 16 samples are 32 B of I/Q in
// (two 16-byte loads) and 16 B of states out (one 16-byte store).  16 timed
// faster than 32 (PERF.md).
constexpr int kUrhI8Chunk = 16;

// nvcc unrolls a chunk loop whose count is a constant after inlining, so
// the chunk's samples and states stay in registers.
#ifdef __CUDACC__
#define URH_UNROLL _Pragma("unroll")
#else
#define URH_UNROLL
#endif

// IEEE sign bit, so that -0.0 counts as negative.
__host__ __device__ inline bool urh_sign_bit(float v) {
#ifdef __CUDA_ARCH__
    return __float_as_int(v) < 0;
#else
    int32_t bits;
    memcpy(&bits, &v, sizeof bits);
    return bits < 0;
#endif
}

// K1: FSK quadrature discriminator atan2(conj(x[i-1]) * x[i]), noise gate
// (mag^2 <= noise^2 -> -4.0), state = qad > thr, -1 where gated.
__host__ __device__ inline void urh_fsk_f32_at(const float* x, int64_t i,
                                               float noise_sqrd, float thr,
                                               float* qad, int32_t* state) {
    if (i == 0) {
        *qad = URH_FSK_SENTINEL;
        *state = -1;
        return;
    }
    const float re = x[2 * i], im = x[2 * i + 1];
    const float pr = x[2 * i - 2], pi = x[2 * i - 1];
    const float mag2 = re * re + im * im;
    const float t_re = pr * re + pi * im;
    const float t_im = pr * im - pi * re;
    const float q = mag2 <= noise_sqrd ? URH_FSK_SENTINEL : atan2f(t_im, t_re);
    *qad = q;
    *state = q == URH_FSK_SENTINEL ? -1 : (q > thr ? 1 : 0);
}

// K2: FSK state of one int8 sample (re, im) after (pr, pi), without the
// arctangent.  For |thr| < pi/2, atan2(y, x) > thr reduces to
//   x < 0 (incl. -0):    angle is +-(pi/2, pi]  -> not sign(y)
//   x > 0 or +0, y != 0: y > x * tan(thr)
//   x == +0, y == +-0:   angle is +-0           -> thr < 0
// tan_thr is tan(thr) rounded to float32; thr_neg is (thr < 0).  The
// products stay float32 on purpose: products of int8 values give -0.0
// (e.g. -3.0f * 0.0f), and the sign-bit branches depend on it, so an
// integer form would change states.
__host__ __device__ inline int8_t urh_fsk_i8_one(float pr, float pi, float re,
                                                 float im, float noise_sqrd,
                                                 float tan_thr, int thr_neg) {
    const float mag2 = re * re + im * im;
    if (mag2 <= noise_sqrd) return -1;
    const float cx = pr * re + pi * im;
    const float cy = pr * im - pi * re;
    const bool sign_x = urh_sign_bit(cx);
    const bool sign_y = urh_sign_bit(cy);
    if (cx == 0.0f && !sign_x && cy == 0.0f) return thr_neg ? 1 : 0;
    if (sign_x) return sign_y ? 0 : 1;
    return cy > cx * tan_thr ? 1 : 0;
}

__host__ __device__ inline int8_t urh_fsk_i8_at(const int8_t* x, int64_t i,
                                                float noise_sqrd, float tan_thr,
                                                int thr_neg) {
    if (i == 0) return -1;
    return urh_fsk_i8_one((float)x[2 * i - 2], (float)x[2 * i - 1],
                          (float)x[2 * i], (float)x[2 * i + 1], noise_sqrd,
                          tan_thr, thr_neg);
}

// K2 over count consecutive samples x[0 .. 2*count) whose previous sample
// is (halo_re, halo_im).  Each sample is converted to float once and
// serves as the next one's previous.  Sample 0 of the capture is the
// caller's to overwrite with -1.
__host__ __device__ inline void urh_fsk_i8_chunk(int8_t halo_re, int8_t halo_im,
                                                 const int8_t* x, int count,
                                                 float noise_sqrd, float tan_thr,
                                                 int thr_neg, int8_t* states) {
    float pr = (float)halo_re, pi = (float)halo_im;
    URH_UNROLL
    for (int k = 0; k < count; ++k) {
        const float re = (float)x[2 * k], im = (float)x[2 * k + 1];
        states[k] = urh_fsk_i8_one(pr, pi, re, im, noise_sqrd, tan_thr, thr_neg);
        pr = re;
        pi = im;
    }
}

// K3: ASK envelope sqrt(mag^2) / max_mag (sqrt, then an IEEE division),
// gated to 0.0; state = val > thr, -1 where gated.
__host__ __device__ inline void urh_ask_f32_at(const float* x, int64_t i,
                                               float noise_sqrd, float thr,
                                               float max_mag, float* qad,
                                               int32_t* state) {
    if (i == 0) {
        *qad = URH_ASK_SENTINEL;
        *state = -1;
        return;
    }
    const float re = x[2 * i], im = x[2 * i + 1];
    const float mag2 = re * re + im * im;
    const float val = sqrtf(mag2) / max_mag;
    const bool gated = mag2 <= noise_sqrd;
    *qad = gated ? URH_ASK_SENTINEL : val;
    *state = gated ? -1 : (val > thr ? 1 : 0);
}

// K4: ASK state of one int8 sample by its integer decision.  mag2 = I^2 +
// Q^2 is an integer in [0, 32768], and the float32 state (gate, sqrt,
// division, threshold) is a step in it: -1 below gate_below, then
// above_from_cutoff (0 or 1) from cutoff on and its negation before.
// ask_i8_decision in dsp/fused_kernels.py reads the three integers off
// the plain version's own arithmetic.
__host__ __device__ inline int8_t urh_ask_i8_one(int re, int im, int gate_below,
                                                 int cutoff, int above_from_cutoff) {
    const int mag2 = re * re + im * im;
    if (mag2 < gate_below) return -1;
    return (int8_t)(mag2 >= cutoff ? above_from_cutoff : 1 - above_from_cutoff);
}

__host__ __device__ inline int8_t urh_ask_i8_at(const int8_t* x, int64_t i,
                                                int gate_below, int cutoff,
                                                int above_from_cutoff) {
    if (i == 0) return -1;
    return urh_ask_i8_one(x[2 * i], x[2 * i + 1], gate_below, cutoff,
                          above_from_cutoff);
}

// K4 over count consecutive samples x[0 .. 2*count); no history needed.
// Sample 0 of the capture is the caller's to overwrite with -1.
__host__ __device__ inline void urh_ask_i8_chunk(const int8_t* x, int count,
                                                 int gate_below, int cutoff,
                                                 int above_from_cutoff,
                                                 int8_t* states) {
    URH_UNROLL
    for (int k = 0; k < count; ++k)
        states[k] = urh_ask_i8_one(x[2 * k], x[2 * k + 1], gate_below, cutoff,
                                   above_from_cutoff);
}
