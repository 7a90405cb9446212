"""The plain Costas loop: PSK carrier recovery, one sample after another.

Written out again from URH's loop (urh/cythonext/signal_functions.pyx:252-330)
in the operation order of urh_tpu's ``_costa_demod_scan``: per sample the
gate at |x|^2 <= noise^2 on the raw values, the normalisation of int8
samples, (raw + 0.5) / 127.5, the mix with exp(-i phase), the 2nd-order
detector's error clipped to [-1, 1], the frequency and phase updates (the
phase wrapped by 2 pi once past it, the frequency clipped after the phase
took it), every product and sum rounded to float32, at URH's default loop
bandwidth 0.1.  A gated sample gives the sentinel -4 and leaves (phase,
freq) as they were.  A capture's sample 0 gives the sentinel; the loop
starts at sample 1 from phase 1.5 and frequency 0.

The loop is in C, built with the host's C compiler (no fused multiply-add,
no fast math) on first use into ``build/benchmark/`` of the checkout (one
file a source, flags, machine and C library) and loaded with ctypes: Python
would step 2^24 samples in minutes.  Its sine and cosine are the C
library's ``sinf`` and ``cosf``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import platform
import subprocess
import tempfile
import threading

import numpy as np

SENTINEL = np.float32(-4.0)
INIT_PHASE = 1.5  # signal_functions.pyx:261
DAMPING = math.sqrt(2.0) / 2.0  # signal_functions.pyx:349
BANDWIDTH = 0.1  # URH's default Costas loop bandwidth
# int8 samples' (scale, shift) in the normalisation (signal_functions.pyx:267-283)
INT8_SCALE, INT8_SHIFT = 127.5, 0.5

SOURCE = r"""
#include <math.h>
#include <stdint.h>

static float wrap(float phase) {
    const float two_pi = (float)(2.0 * 3.14159265358979323846);
    if (phase > two_pi) phase = fmodf(phase, two_pi);
    if (phase < -two_pi) phase = -fmodf(-phase, two_pi);
    return phase;
}

void costas_f32(const float* x, int64_t n, float noise_sqrd, float scale, float shift,
                float alpha, float beta, float* carry, float* out) {
    float phase = carry[0], freq = carry[1];
    for (int64_t i = 0; i < n; ++i) {
        const float raw_re = x[2 * i], raw_im = x[2 * i + 1];
        const float mag2 = raw_re * raw_re + raw_im * raw_im;
        if (mag2 <= noise_sqrd) {
            out[i] = -4.0f;
            continue;
        }
        const float re = (raw_re + shift) / scale;
        const float im = (raw_im + shift) / scale;
        const float cosn = cosf(-phase);
        const float sinn = sinf(-phase);
        const float mix_re = cosn * re - sinn * im;
        const float mix_im = cosn * im + sinn * re;
        float error = mix_im * mix_re;
        error = error < -1.0f ? -1.0f : (error > 1.0f ? 1.0f : error);
        const float new_freq = freq + beta * error;
        phase = wrap(phase + new_freq + alpha * error);
        freq = new_freq < -1.0f ? -1.0f : (new_freq > 1.0f ? 1.0f : new_freq);
        out[i] = mix_re;
    }
    carry[0] = phase;
    carry[1] = freq;
}
"""
FLAGS = ["-O2", "-std=c99", "-fno-builtin", "-ffp-contract=off", "-fno-fast-math", "-fPIC",
         "-shared"]
BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                     "build", "benchmark")

_lock = threading.Lock()
_lib = None


def library():
    """The built loop (built once a checkout, then loaded)."""
    global _lib
    with _lock:
        if _lib is None:
            host = f"{platform.machine()} {platform.libc_ver()}"
            key = hashlib.sha256("\n".join((SOURCE, *FLAGS, host)).encode()).hexdigest()[:16]
            path = os.path.join(BUILD, f"costas_ref_{key}.so")
            if not os.path.exists(path):
                os.makedirs(BUILD, exist_ok=True)
                with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
                    src = os.path.join(tmp, "costas_ref.c")
                    with open(src, "w") as f:
                        f.write(SOURCE)
                    built = os.path.join(tmp, "costas_ref.so")
                    subprocess.run(["cc", *FLAGS, "-o", built, src, "-lm"], check=True,
                                   capture_output=True, timeout=120)
                    os.replace(built, path)
            lib = ctypes.CDLL(path)
            f, p = ctypes.c_float, ctypes.c_void_p
            lib.costas_f32.argtypes = [p, ctypes.c_int64, f, f, f, f, f, p, p]
            lib.costas_f32.restype = None
            _lib = lib
    return _lib


def gains() -> tuple:
    """(alpha, beta) in float32, in _costa_demod_scan's operation order."""
    d, bw = np.float32(DAMPING), np.float32(BANDWIDTH)
    denom = np.float32(1.0) + np.float32(2.0) * d * bw + bw * bw
    return np.float32(4.0) * d * bw / denom, np.float32(4.0) * bw * bw / denom


def loop(x: np.ndarray, noise_sqrd: float, carry=(INIT_PHASE, 0.0)) -> tuple:
    """The loop over (n, 2) int8 samples -> (out (n,) float32, (phase, freq))."""
    if x.dtype != np.int8:
        raise ValueError(f"the reference loop normalises int8 samples, not {x.dtype}")
    xf = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(len(xf), np.float32)
    state = np.array(carry, np.float32)
    alpha, beta = gains()
    library().costas_f32(xf.ctypes.data, len(xf), np.float32(noise_sqrd),
                         np.float32(INT8_SCALE), np.float32(INT8_SHIFT), alpha, beta,
                         state.ctypes.data, out.ctypes.data)
    return out, (float(state[0]), float(state[1]))


def rectangular(x: np.ndarray, noise: float) -> np.ndarray:
    """A capture's PSK demodulation: (n, 2) int8 samples -> (n,) float32,
    sample 0 and the gated samples at the sentinel."""
    out = np.full(len(x), SENTINEL, np.float32)
    out[1:] = loop(x[1:], float(np.float32(noise * noise)))[0]
    return out
