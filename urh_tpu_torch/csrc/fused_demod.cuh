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
// Sample i's discriminator history is x[i-1], read straight from memory
// (x[-1] := x[0]); sample 0 always gets the noise sentinel and state -1,
// as urh_tpu's host entries overwrite it.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#define URH_FSK_SENTINEL (-4.0f)
#define URH_ASK_SENTINEL (0.0f)

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

// K2: FSK states from int8 I/Q without the arctangent.  For |thr| < pi/2,
// atan2(y, x) > thr reduces to
//   x < 0 (incl. -0):    angle is +-(pi/2, pi]  -> not sign(y)
//   x > 0 or +0, y != 0: y > x * tan(thr)
//   x == +0, y == +-0:   angle is +-0           -> thr < 0
// tan_thr is tan(thr) rounded to float32; thr_neg is (thr < 0).
__host__ __device__ inline int8_t urh_fsk_i8_at(const int8_t* x, int64_t i,
                                                float noise_sqrd, float tan_thr,
                                                int thr_neg) {
    if (i == 0) return -1;
    const float re = (float)x[2 * i], im = (float)x[2 * i + 1];
    const float pr = (float)x[2 * i - 2], pi = (float)x[2 * i - 1];
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

// K4: ASK states from int8 I/Q, noise and max_mag in raw int8 units.
__host__ __device__ inline int8_t urh_ask_i8_at(const int8_t* x, int64_t i,
                                                float noise_sqrd, float thr,
                                                float max_mag) {
    if (i == 0) return -1;
    const float re = (float)x[2 * i], im = (float)x[2 * i + 1];
    const float mag2 = re * re + im * im;
    if (mag2 <= noise_sqrd) return -1;
    return sqrtf(mag2) / max_mag > thr ? 1 : 0;
}
