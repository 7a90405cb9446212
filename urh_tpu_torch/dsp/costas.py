"""The Costas loop (B5): PSK carrier recovery as a CUDA kernel.

Port of urh_tpu.dsp.demod._costa_demod_scan (an XLA ``lax.scan``).  The
loop is a sequential feedback recursion, so on the card one warp runs it
(``csrc/costas.cu``, per-sample step in ``csrc/costas.cuh``): the warp
gates and normalises each tile, and lane 0 runs only the loop-carried
chain.  The (phase, freq) carry is a 2-float device tensor that the
kernel reads at the start and writes at the end: blocks of a stream chain
on the device.

:func:`costa_demod_scan` launches the kernel for a CUDA tensor (counted in
:data:`LAUNCHES`) and runs :func:`costa_demod_scan_plain` for a CPU one.
The plain version steps sample by sample with float32 torch ops in the
kernel's operation order, so it is slow by nature; it serves the tests,
the CPU path and the comparison on the card.

:func:`costa_demod_scan_batch` runs C independent streams, each from its
own carry, in one launch of the same kernel (B9, one block a stream): the
block-parallel PSK of :mod:`urh_tpu_torch.parallel.sharded`.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from urh_tpu_torch import _build
from urh_tpu_torch.dsp.demod import NOISE_FSK_PSK, scalar_f32
from urh_tpu_torch.util.metrics import metrics

_COSTAS_INIT_PHASE = 1.5  # signal_functions.pyx:261
DAMPING = math.sqrt(2.0) / 2.0  # signal_functions.pyx:349 (afp_demod)

# kernel name -> launches since the last reset; only a kernel launch counts
LAUNCHES = {"costas_f32": 0, "costas_batch_f32": 0}


def costas_alpha_beta(bandwidth: float) -> tuple[float, float]:
    """The loop gains in float32, in _costa_demod_scan's operation order
    (urh_tpu/dsp/demod.py:135-137), with the reference's damping."""
    d, bw = np.float32(DAMPING), np.float32(bandwidth)
    one, two, four = np.float32(1.0), np.float32(2.0), np.float32(4.0)
    denom = one + two * d * bw + bw * bw
    return float(four * d * bw / denom), float(four * bw * bw / denom)


def new_carry(device, phase: float = _COSTAS_INIT_PHASE, freq: float = 0.0) -> torch.Tensor:
    """(phase, freq) as the 2-float tensor the loop reads and writes."""
    return torch.tensor([phase, freq], dtype=torch.float32, device=device)


def _check(x: torch.Tensor, carry: torch.Tensor, batch: bool = False) -> bool:
    """Validate the inputs ((N, 2) and (2,), or with ``batch`` (C, N, 2)
    and (C, 2)); True for CUDA tensors, False for CPU ones."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        raise TypeError("expected float32 samples as a torch.Tensor")
    if x.dim() != 2 + batch or x.shape[-1] != 2 or not x.is_contiguous():
        want = "(C, N, 2)" if batch else "(N, 2)"
        raise ValueError(f"expected contiguous {want} I/Q, got {tuple(x.shape)}")
    want = (x.shape[0], 2) if batch else (2,)
    if carry.dtype != torch.float32 or carry.shape != want or carry.device != x.device \
            or not carry.is_contiguous():
        raise ValueError(f"carry must be a contiguous {want} float32 tensor on the "
                         f"samples' device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda" and x.data_ptr() % 8:
        raise ValueError("samples must be 8-byte aligned")
    return x.device.type == "cuda"


def _launch(name: str, x: torch.Tensor, *args):
    """Launch the kernel library's ``name`` on x's device and current
    stream; RuntimeError if the launch fails."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(_build.library(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


def costa_demod_scan_plain(x: torch.Tensor, noise_sqrd: float, scale: float, shift: float,
                           loop_order: int, alpha: float, beta: float,
                           phase: torch.Tensor, freq: torch.Tensor):
    """-> (qad (N,), final phase, final freq), the kernel's arithmetic one
    float32 torch op at a time.  A gated sample gives the sentinel and
    leaves the carry as it was (the kernel skips its step).

    x may also be (C, N, 2): C independent streams stepped together, each
    from its own (phase, freq) of shape (C,) -> qad (C, N) and the final
    (C,) carries.  Cut one stream into C pieces and start each piece from
    the carry that the one before ends on, and the qad is the one stream's."""
    dev = x.device
    f32 = lambda v: scalar_f32(v, dev)  # noqa: E731
    two_pi, one, neg_one, zero, two = (f32(2 * math.pi), f32(1.0), f32(-1.0), f32(0.0),
                                       f32(2.0))
    alpha, beta = f32(alpha), f32(beta)
    batch = x.dim() == 3
    if not batch:
        x, phase, freq = x[None], phase.reshape(1), freq.reshape(1)
    raw_re, raw_im = x[..., 0], x[..., 1]
    gated = raw_re * raw_re + raw_im * raw_im <= f32(noise_sqrd)
    re = (raw_re + f32(shift)) / f32(scale)
    im = (raw_im + f32(shift)) / f32(scale)
    phase = phase.to(dev, torch.float32).clone()
    freq = freq.to(dev, torch.float32).clone()
    qad = torch.full(re.shape, NOISE_FSK_PSK, dtype=torch.float32, device=dev)
    for i in np.flatnonzero(~gated.all(0).cpu().numpy()).tolist():
        cosn = torch.cos(-phase)
        sinn = torch.sin(-phase)
        mix_re = cosn * re[:, i] - sinn * im[:, i]
        mix_im = cosn * im[:, i] + sinn * re[:, i]
        if loop_order == 2:
            error = mix_im * mix_re
            out = mix_re
        else:
            f1 = torch.where(mix_re > zero, one, neg_one)
            f2 = torch.where(mix_im > zero, one, neg_one)
            error = f1 * mix_im - f2 * mix_re
            out = two * mix_re + mix_im
        error = torch.clamp(error, -1.0, 1.0)
        new_freq = freq + beta * error
        new_phase = phase + new_freq + alpha * error
        new_phase = torch.where(new_phase > two_pi, torch.fmod(new_phase, two_pi), new_phase)
        new_phase = torch.where(new_phase < -two_pi, -torch.fmod(-new_phase, two_pi),
                                new_phase)
        g = gated[:, i]
        phase = torch.where(g, phase, new_phase)
        freq = torch.where(g, freq, torch.clamp(new_freq, -1.0, 1.0))
        qad[:, i] = torch.where(g, qad[:, i], out)
    if not batch:
        return qad[0], phase[0], freq[0]
    return qad, phase, freq


def costa_demod_scan(x: torch.Tensor, noise_sqrd: float, scale: float, shift: float,
                     loop_order: int, bandwidth: float, carry: torch.Tensor) -> torch.Tensor:
    """Costas loop over x ((N, 2) float32, raw units) -> qad (N,) float32.

    ``carry`` is the (phase, freq) float32 tensor on x's device; it is
    read at the start and overwritten with the final carry, so a stream's
    blocks chain by passing the same tensor.  ``loop_order`` 2 runs the
    2nd-order detector, every order above 2 the 4th-order one.  Each pass
    over samples (the kernel's launch, or the plain loop on the CPU) is a
    ``demod.costas`` span (args: the samples and the loop order) and adds
    its samples to the counter ``costas.samples``."""
    alpha, beta = costas_alpha_beta(bandwidth)
    on_card = _check(x, carry)
    if not len(x):
        return torch.empty(0, dtype=torch.float32, device=x.device)
    with metrics.span("demod.costas", samples=len(x), loop_order=int(loop_order)):
        metrics.count("costas.samples", len(x))
        if not on_card:
            qad, phase, freq = costa_demod_scan_plain(x, noise_sqrd, scale, shift, loop_order,
                                                      alpha, beta, carry[0], carry[1])
            carry[0], carry[1] = phase, freq
            return qad
        qad = torch.empty(len(x), dtype=torch.float32, device=x.device)
        _launch("urh_costas_f32", x, x.data_ptr(), len(x), noise_sqrd, scale, shift,
                int(loop_order != 2), alpha, beta, carry.data_ptr(), qad.data_ptr())
        LAUNCHES["costas_f32"] += 1
    return qad


def costa_demod_scan_batch(x: torch.Tensor, noise_sqrd: float, scale: float, shift: float,
                           loop_order: int, bandwidth: float,
                           carry: torch.Tensor) -> torch.Tensor:
    """C independent Costas streams (B9): x ((C, L, 2) float32, contiguous,
    raw units) -> qad (C, L) float32, row c as :func:`costa_demod_scan`
    gives it for x[c] from carry[c].

    ``carry`` is the (C, 2) float32 tensor of (phase, freq) pairs on x's
    device, read at the start and overwritten with each stream's final
    carry.  One kernel launch for a CUDA tensor (counted in
    ``LAUNCHES["costas_batch_f32"]``; none when C or L is 0), the plain
    loop with every stream stepped together for a CPU one."""
    alpha, beta = costas_alpha_beta(bandwidth)
    if not _check(x, carry, batch=True):
        qad, phase, freq = costa_demod_scan_plain(x, noise_sqrd, scale, shift, loop_order,
                                                  alpha, beta, carry[:, 0], carry[:, 1])
        carry[:, 0], carry[:, 1] = phase, freq
        return qad
    c, n = x.shape[0], x.shape[1]
    if c >= 1 << 31:
        raise ValueError(f"{c} streams: at most 2^31 - 1 a launch")
    qad = torch.empty((c, n), dtype=torch.float32, device=x.device)
    if c and n:
        _launch("urh_costas_batch_f32", x, x.data_ptr(), c, n, noise_sqrd, scale, shift,
                int(loop_order != 2), alpha, beta, carry.data_ptr(), qad.data_ptr())
        LAUNCHES["costas_batch_f32"] += 1
    return qad


def batch_resident_streams(device, loop_order: int = 2) -> int:
    """The streams of one B9 launch that ``device``'s card runs at once: the
    occupancy API's blocks an SM times the SMs (past it, streams wait for
    a free slot and the time grows by whole waves)."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _build.library().urh_costas_batch_resident(int(loop_order != 2),
                                                          ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"urh_costas_batch_resident failed with CUDA error {rc}")
    return blocks.value * torch.cuda.get_device_properties(device).multi_processor_count


def loop_sincos(x: torch.Tensor):
    """-> ((sin x, cos x), (sin x, cos x)) as the loop's step takes them:
    for a CUDA float32 tensor, the kernel's sincosf and its near version
    (one launch, not counted: it serves only the check of their bits
    against torch.sin and torch.cos); for a CPU one, torch.sin and torch.cos
    twice."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("expected a contiguous float32 tensor")
    if x.device.type == "cpu":
        return (torch.sin(x), torch.cos(x)), (torch.sin(x), torch.cos(x))
    out = [torch.empty_like(x) for _ in range(4)]
    _launch("urh_costas_sincos_f32", x, x.data_ptr(), x.numel(), *(o.data_ptr() for o in out))
    return (out[0], out[1]), (out[2], out[3])
