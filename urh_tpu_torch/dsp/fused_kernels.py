"""Fused demod kernels: noise gate + demodulation + symbol decision in one pass.

Port of urh_tpu/dsp/pallas_kernels.py.  Each of its four Pallas TPU kernels
is a CUDA kernel written for Hopper in ``csrc/fused_demod.cu`` (per-sample
arithmetic in ``csrc/fused_demod.cuh``), built with nvcc and bound through
ctypes (:mod:`urh_tpu_torch._build`).  Beside each kernel sits its plain
PyTorch version, which repeats the kernel's arithmetic op by op.

A wrapper takes the interleaved (N, 2) capture as one contiguous tensor.
For a CUDA tensor it launches the kernel on the current stream, without
synchronizing, and counts the launch in :data:`LAUNCHES`; for a CPU tensor
it runs the plain version; anything else raises.  The TPU layout (planar
(rows, 128) tiles, padding, a carry between sequential grid steps) is not
carried over: the kernels read the interleaved capture in place, a float32
thread one sample and an int8 thread a chunk of consecutive samples.  The
int8 kernels load 16 bytes at a time, so their wrappers copy a capture
that is not 16-byte aligned first (counted in :data:`ALIGNMENT_COPIES`).
Sample 0 always gets the noise sentinel and state -1, as the urh_tpu host
entries set it.

The host entries (``fsk_demod_symbolize`` ...) keep urh_tpu's signatures
without ``block_rows``/``interpret``; they take (N, 2) numpy or a tensor
and return tensors on the device they ran on.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from urh_tpu_torch import _build
from urh_tpu_torch.core.iq import resolve_device
from urh_tpu_torch.dsp.demod import (afp_demod_vec, noise_sentinel, prev_sample,
                                     scalar_f32)
from urh_tpu_torch.dsp.symbols import symbol_states

# kernel name -> launches since the last reset; only a kernel launch counts
LAUNCHES = {"fsk_f32": 0, "fsk_i8": 0, "ask_f32": 0, "ask_i8": 0}
# int8 kernel name -> inputs copied to a 16-byte aligned tensor before a launch
ALIGNMENT_COPIES = {"fsk_i8": 0, "ask_i8": 0}
# I^2 + Q^2 of an int8 sample lies in [0, I8_MAG2_MAX]
I8_MAG2_MAX = 2 * 128 * 128


def _on_card(x: torch.Tensor, dtype: torch.dtype) -> bool:
    """Validate a kernel input; True for a CUDA tensor, False for CPU."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"expected {dtype} samples, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != 2:
        raise ValueError(f"expected (N, 2) interleaved I/Q, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("samples must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cuda"


def _launch(name: str, x: torch.Tensor, *args) -> None:
    """Launch kernel ``name`` on x's device and current stream; raises on a
    refused launch (cudaGetLastError != 0)."""
    fn = getattr(_build.library(), "urh_" + name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), x.shape[0], *args, stream)
    if rc != 0:
        raise RuntimeError(f"urh_{name} launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


def _aligned(name: str, x: torch.Tensor) -> torch.Tensor:
    """x, or a fresh (aligned) copy of it where the int8 kernel's 16-byte
    loads could not read it in place."""
    if x.data_ptr() % 16 == 0:
        return x
    ALIGNMENT_COPIES[name] += 1
    return x.clone()


def fsk_i8_supports(threshold: float) -> bool:
    """The int8 comparison kernel decides atan2 > threshold without the
    arctangent, which holds only for |threshold| < pi/2."""
    return abs(threshold) < math.pi / 2


def _tan_f32(threshold: float) -> float:
    """tan(threshold) rounded to float32, computed in float32 as jnp.tan."""
    return torch.tan(torch.tensor(threshold, dtype=torch.float32)).item()


def _demod_symbolize_plain(x, noise_sqrd, threshold, max_mag, mod_type):
    """The plain float32 versions (K1, K3, and K4 on the int8 capture as
    float32): urh_tpu's reference path, afp_demod + symbol_states, op by op
    the kernels' arithmetic."""
    qad = afp_demod_vec(x.to(torch.float32), noise_sqrd, max_mag, mod_type)
    return qad, symbol_states(qad, np.float32([threshold]), noise_sentinel(mod_type))


# ---------------------------------------------------------------------------
# K1: FSK float32 -> (qad, states)        urh_tpu fused_fsk_demod_symbolize
# ---------------------------------------------------------------------------


def fused_fsk_demod_symbolize_plain(x: torch.Tensor, noise_sqrd: float,
                                    threshold: float):
    return _demod_symbolize_plain(x, noise_sqrd, threshold, None, "FSK")


def fused_fsk_demod_symbolize(x: torch.Tensor, noise_sqrd: float, threshold: float):
    """(N, 2) float32 -> (qad float32, states int32), one fused pass."""
    if not _on_card(x, torch.float32):
        return fused_fsk_demod_symbolize_plain(x, noise_sqrd, threshold)
    n = x.shape[0]
    qad = torch.empty(n, dtype=torch.float32, device=x.device)
    states = torch.empty(n, dtype=torch.int32, device=x.device)
    if n:
        _launch("fsk_f32", x, noise_sqrd, threshold, qad.data_ptr(),
                states.data_ptr())
    return qad, states


# ---------------------------------------------------------------------------
# K2: FSK int8 -> int8 states              urh_tpu fused_fsk_symbolize_i8
# ---------------------------------------------------------------------------


def fused_fsk_symbolize_i8_plain(x: torch.Tensor, noise_sqrd: float,
                                 threshold: float):
    f = x.to(torch.float32)
    re, im = f[:, 0], f[:, 1]
    pr, pi = prev_sample(re), prev_sample(im)
    mag2 = re * re + im * im
    cx = pr * re + pi * im
    cy = pr * im - pi * re
    sign_x, sign_y = torch.signbit(cx), torch.signbit(cy)
    tan_thr = scalar_f32(_tan_f32(threshold), x.device)
    above = torch.where(sign_x, ~sign_y, cy > cx * tan_thr)
    both_zero = (cx == 0) & ~sign_x & (cy == 0)
    above = above | both_zero if threshold < 0 else above & ~both_zero
    states = above.to(torch.int8)
    states.masked_fill_(mag2 <= scalar_f32(noise_sqrd, x.device), -1)
    states[:1] = -1
    return states


def fused_fsk_symbolize_i8(x: torch.Tensor, noise_sqrd: float, threshold: float):
    """(N, 2) int8 -> int8 states with no arctangent; |threshold| < pi/2."""
    if not fsk_i8_supports(threshold):
        raise ValueError("comparison kernel requires |threshold| < pi/2")
    if not _on_card(x, torch.int8):
        return fused_fsk_symbolize_i8_plain(x, noise_sqrd, threshold)
    n = x.shape[0]
    states = torch.empty(n, dtype=torch.int8, device=x.device)
    if n:
        _launch("fsk_i8", _aligned("fsk_i8", x), noise_sqrd, _tan_f32(threshold),
                int(threshold < 0), states.data_ptr())
    return states


# ---------------------------------------------------------------------------
# K3: ASK float32 -> (qad, states)        urh_tpu fused_ask_demod_symbolize
# ---------------------------------------------------------------------------


def fused_ask_demod_symbolize_plain(x: torch.Tensor, noise_sqrd: float,
                                    threshold: float, max_mag: float):
    return _demod_symbolize_plain(x, noise_sqrd, threshold, max_mag, "ASK")


def fused_ask_demod_symbolize(x: torch.Tensor, noise_sqrd: float, threshold: float,
                              max_mag: float):
    """(N, 2) float32 -> (qad float32, states int32) for binary ASK."""
    if not _on_card(x, torch.float32):
        return fused_ask_demod_symbolize_plain(x, noise_sqrd, threshold, max_mag)
    n = x.shape[0]
    qad = torch.empty(n, dtype=torch.float32, device=x.device)
    states = torch.empty(n, dtype=torch.int32, device=x.device)
    if n:
        _launch("ask_f32", x, noise_sqrd, threshold, max_mag, qad.data_ptr(),
                states.data_ptr())
    return qad, states


# ---------------------------------------------------------------------------
# K4: ASK int8 -> int8 states              urh_tpu fused_ask_symbolize_i8
# ---------------------------------------------------------------------------


def fused_ask_symbolize_i8_plain(x: torch.Tensor, noise_sqrd: float,
                                 threshold: float, max_mag: float):
    _, states = _demod_symbolize_plain(x, noise_sqrd, threshold, max_mag, "ASK")
    return states.to(torch.int8)


def _all_i8_pairs() -> torch.Tensor:
    """Every int8 (I, Q) pair once, after a copy of the first (sample 0
    gets state -1 whatever it holds)."""
    v = torch.arange(-128, 128, dtype=torch.int8)
    pairs = torch.stack(torch.meshgrid(v, v, indexing="ij"), -1).reshape(-1, 2)
    return torch.cat((pairs[:1], pairs))


@functools.lru_cache(maxsize=64)  # a capture's repeated calls cost one table
def ask_i8_decision(noise_sqrd: float, threshold: float,
                    max_mag: float) -> tuple[int, int, int]:
    """K4's state as a function of the integer mag2 = I^2 + Q^2.

    -> (gate_below, cutoff, above_from_cutoff): state -1 for mag2 <
    gate_below, else above_from_cutoff (0 or 1) for mag2 >= cutoff and its
    negation below.  The plain version's state depends on mag2 alone: the
    gate mag2 <= noise_sqrd is monotone in mag2, and correctly rounded sqrt
    and division make sqrt(mag2) / max_mag > threshold a step in mag2, up
    for max_mag > 0 and down for max_mag < 0 (0, inf and NaN give a step or
    a constant).  The three integers are read off the plain version's
    states for every int8 (I, Q) pair and must reproduce each of them, or
    this raises.
    """
    x = _all_i8_pairs()
    states = fused_ask_symbolize_i8_plain(x, noise_sqrd, threshold, max_mag)[1:].numpy()
    iq = x[1:].to(torch.int32)
    mag2 = (iq * iq).sum(1).numpy()
    order = np.argsort(mag2, kind="stable")
    m, s = mag2[order], states[order]
    live = np.flatnonzero(s != -1)  # ungated, by rising mag2
    change = live[1:][s[live[1:]] != s[live[:-1]]]
    gate_below = int(m[live[0]]) if len(live) else I8_MAG2_MAX + 1
    cutoff = int(m[change[0]]) if len(change) else gate_below
    above = int(s[change[0]]) if len(change) else int(s[live[0]]) if len(live) else 1
    step = np.where(mag2 < gate_below, -1, np.where(mag2 >= cutoff, above, 1 - above))
    if not np.array_equal(step, states):
        raise ValueError(f"ASK int8 states for noise_sqrd={noise_sqrd}, threshold="
                         f"{threshold}, max_mag={max_mag} are no step in I^2 + Q^2")
    return gate_below, cutoff, above


def fused_ask_symbolize_i8(x: torch.Tensor, noise_sqrd: float, threshold: float,
                           max_mag: float):
    """(N, 2) int8 -> int8 ASK states; noise and max_mag in raw int8 units."""
    if not _on_card(x, torch.int8):
        return fused_ask_symbolize_i8_plain(x, noise_sqrd, threshold, max_mag)
    n = x.shape[0]
    states = torch.empty(n, dtype=torch.int8, device=x.device)
    if n:
        _launch("ask_i8", _aligned("ask_i8", x),
                *ask_i8_decision(noise_sqrd, threshold, max_mag), states.data_ptr())
    return states


# ---------------------------------------------------------------------------
# host entries (urh_tpu signatures)
# ---------------------------------------------------------------------------


def _samples(samples, device) -> torch.Tensor:
    """(N, 2) numpy or tensor -> contiguous tensor; numpy goes to ``device``
    (default: the card), a tensor stays where it is."""
    if isinstance(samples, torch.Tensor):
        return samples.contiguous()
    return torch.from_numpy(np.ascontiguousarray(samples)).to(resolve_device(device))


def _noise_sqrd(noise_mag: float) -> float:
    return float(np.float32(noise_mag * noise_mag))


def fsk_demod_symbolize(samples, noise_mag: float, threshold: float, device=None):
    """(N, 2) samples of any dtype, raw units -> (qad, states) via K1."""
    x = _samples(samples, device).to(torch.float32)
    return fused_fsk_demod_symbolize(x, _noise_sqrd(noise_mag), threshold)


def fsk_symbolize_i8(samples, noise_mag: float, threshold: float, device=None):
    """(N, 2) int8 -> int8 symbol states via K2 (no qad materialized)."""
    return fused_fsk_symbolize_i8(_samples(samples, device),
                                  _noise_sqrd(noise_mag), threshold)


def ask_demod_symbolize(samples, noise_mag: float, threshold: float, max_mag: float,
                        device=None):
    """(N, 2) samples of any dtype, raw units -> (qad, states) via K3."""
    x = _samples(samples, device).to(torch.float32)
    return fused_ask_demod_symbolize(x, _noise_sqrd(noise_mag), threshold, max_mag)


def ask_symbolize_i8(samples, noise_mag: float, threshold: float, max_mag: float,
                     device=None):
    """(N, 2) int8 -> int8 ASK symbol states via K4."""
    return fused_ask_symbolize_i8(_samples(samples, device),
                                  _noise_sqrd(noise_mag), threshold, max_mag)
