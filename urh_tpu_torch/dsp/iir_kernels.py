"""The IIR feedback recursion (B8) as a CUDA kernel.

Port of urh_tpu.dsp.filters._iir_feedback (an XLA ``lax.scan``): over
feed-forward sums ff (complex64, carried as (n, 2) interleaved float32) and
real taps b_rev (b reversed, the oldest output's tap first),

    y[n] = ff[n] + sum_k b_rev[k] * y[n - N + k],   from a zero carry.

Every output depends on the one before, so on the card one warp runs the
stream (``csrc/iir_feedback.cu``, per-sample step in
``csrc/iir_feedback.cuh``): lanes 0 and 1 run the real and the imaginary
plane, two independent float32 chains.

:func:`iir_feedback` launches the kernel for a CUDA tensor (counted in
:data:`LAUNCHES`) and runs :func:`iir_feedback_plain` for a CPU one.  The
plain version steps sample by sample with float32 torch ops in the
kernel's rounding order (fb = 0; fb = fb + b_rev[k] * y[n - N + k] for k
from the oldest output on; y = ff + fb), so the two agree to the bit; it
is slow by nature and serves the tests, the CPU path and the comparison
on the card.
"""

from __future__ import annotations

import torch

from urh_tpu_torch import _build

MAX_TAPS = 1024  # kUrhIirMaxTaps in csrc/iir_feedback.cuh
REGISTER_TAPS = 8  # kUrhIirRegTaps: more taps keep their ring in shared memory

# kernel name -> launches since the last reset; only a kernel launch counts
LAUNCHES = {"iir_feedback_f32": 0}


def _check(ff: torch.Tensor, b_rev: torch.Tensor) -> bool:
    """Validate the inputs; True for CUDA tensors, False for CPU ones."""
    if not isinstance(ff, torch.Tensor) or ff.dtype != torch.float32:
        raise TypeError("expected float32 feed-forward sums as a torch.Tensor")
    if ff.dim() != 2 or ff.shape[1] != 2 or not ff.is_contiguous():
        raise ValueError(f"expected contiguous (n, 2) interleaved complex, got {tuple(ff.shape)}")
    if (b_rev.dtype != torch.float32 or b_rev.dim() != 1 or not b_rev.is_contiguous()
            or b_rev.device != ff.device):
        raise ValueError("taps must be a contiguous 1-D float32 tensor on ff's device")
    if ff.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ff.device}")
    return ff.device.type == "cuda"


def iir_feedback_plain(ff: torch.Tensor, b_rev: torch.Tensor) -> torch.Tensor:
    """-> y, the kernel's arithmetic one float32 torch op at a time: the
    products of a step in one op (each rounded on its own), their sum one
    add at a time from the oldest output, then ff + the sum.  Both planes
    step together.  Outputs depend on earlier samples only, so the first n
    outputs are those of ff[:n]."""
    n, n_taps = len(ff), len(b_rev)
    history = torch.zeros((n + n_taps, 2), dtype=torch.float32, device=ff.device)
    taps = b_rev[:, None]
    zero = torch.zeros(2, dtype=torch.float32, device=ff.device)
    for i in range(n):
        products = history[i:i + n_taps] * taps  # oldest output first
        fb = zero
        for k in range(n_taps):
            fb = fb + products[k]
        history[i + n_taps] = ff[i] + fb
    return history[n_taps:]


def iir_feedback(ff: torch.Tensor, b_rev: torch.Tensor) -> torch.Tensor:
    """IIR feedback over ff ((n, 2) float32, interleaved complex) with real
    taps b_rev (float32, b reversed) -> y (n, 2) float32 on ff's device."""
    if not _check(ff, b_rev):
        return iir_feedback_plain(ff, b_rev)
    if len(b_rev) > MAX_TAPS:
        raise ValueError(f"{len(b_rev)} feedback taps: the kernel takes at most {MAX_TAPS}")
    if ff.data_ptr() % 16:
        raise ValueError("feed-forward sums must be 16-byte aligned")
    y = torch.empty_like(ff)
    if len(ff):
        with torch.cuda.device(ff.device):
            stream = torch.cuda.current_stream(ff.device).cuda_stream
            rc = _build.library().urh_iir_feedback_f32(ff.data_ptr(), len(ff), b_rev.data_ptr(),
                                                        len(b_rev), y.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"urh_iir_feedback_f32 launch failed with CUDA error {rc}")
        LAUNCHES["iir_feedback_f32"] += 1
    return y


def chain_cycles(device, steps: int = 1 << 22) -> float:
    """SM cycles a step of the feedback's loop-carried chain takes on the
    card (one FMUL and two FADDs, dependent), from a clock64-timed loop of
    ``steps`` steps in one thread: the latency behind B8's chain bound."""
    steps -= steps % 8
    c = torch.tensor([0.0, 0.5, 0.25, 0.0], dtype=torch.float32, device=device)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    sink = torch.zeros(1, dtype=torch.float32, device=device)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        rc = _build.library().urh_iir_chain_cycles(c.data_ptr(), steps, cycles.data_ptr(),
                                                   sink.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"urh_iir_chain_cycles launch failed with CUDA error {rc}")
    return cycles.item() / steps
