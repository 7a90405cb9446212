"""The fused stream block (B6): demod, decision and run-length packing per chunk.

Port of urh_tpu/protocol/stream.py's XLA programs ``_runs_body`` /
``_block_runs`` / ``_block_runs_i8`` / ``_device_rle``.  For a CUDA tensor
:func:`stream_block` launches ``csrc/stream_block.cu``'s single-pass
kernel (after a memset) on the current stream, without a host sync, and
:func:`stream_states` its states-only kernel; each launch is counted in
:data:`LAUNCHES`.  For a CPU tensor both run :func:`stream_block_plain`,
urh_tpu's program in torch ops.

The bundle is int32 ``[n_runs, peak bits, packed[cap]]`` with each run
packed as ``(len << state_bits) | (state + 1)`` and 0 past the last; the
states are the per-sample int8 states after ``drop_first``, which the
stream asks for only when ``n_runs > cap``.
"""

from __future__ import annotations

import torch

from urh_tpu_torch import _build
from urh_tpu_torch.dsp.demod import afp_demod_vec, noise_sentinel, scalar_f32
from urh_tpu_torch.dsp.symbols import _symbol_states_device

# kernel name -> launches since the last reset; only a kernel launch counts
LAUNCHES = {"stream_block_f32": 0, "stream_block_i8": 0, "stream_states_f32": 0,
            "stream_states_i8": 0}
I8_SCALE = 1.0 / 128.0  # IQData's int8 -> float32 scale


def _ingest(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.int8:
        return x.to(torch.float32) * scalar_f32(I8_SCALE, x.device)
    return x


def stream_block_plain(x: torch.Tensor, noise_sqrd: float, max_mag: float,
                       thresholds: torch.Tensor, mod: str, drop_first: bool, cap: int,
                       state_bits: int):
    """urh_tpu's _runs_body (with _device_rle) in torch ops -> (bundle,
    states)."""
    xf = _ingest(x)
    qad = afp_demod_vec(xf, noise_sqrd, max_mag, mod)
    states = _symbol_states_device(qad, thresholds, noise_sentinel(mod))
    if drop_first:
        states = states[1:]
    n = len(states)
    edges = torch.cat((torch.ones(1, dtype=torch.bool, device=x.device),
                       states[1:] != states[:-1]))
    n_runs = edges.sum().to(torch.int32).reshape(1)
    starts = torch.nonzero(edges).flatten()[:cap]
    starts = torch.cat((starts, starts.new_full((cap - len(starts),), n)))
    ends = torch.cat((starts[1:], starts.new_full((1,), n)))
    lens = (ends - starts).to(torch.int32)
    if n:
        run_states = torch.where(starts < n, states[starts.clamp(max=n - 1)], -1)
    else:
        run_states = torch.full_like(lens, -1)
    packed = torch.where(lens > 0, (lens << state_bits) | (run_states.to(torch.int32) + 1), 0)
    peak = torch.max(xf[:, 0] * xf[:, 0] + xf[:, 1] * xf[:, 1]).reshape(1)
    bundle = torch.cat((n_runs, peak.view(torch.int32), packed.to(torch.int32)))
    return bundle, states.to(torch.int8)


def _check(x: torch.Tensor, thresholds: torch.Tensor, mod: str, drop_first: bool) -> bool:
    """Validate a block; True for CUDA tensors, False for CPU ones."""
    if not isinstance(x, torch.Tensor) or x.dtype not in (torch.float32, torch.int8):
        raise TypeError("expected float32 or int8 samples as a torch.Tensor")
    if x.dim() != 2 or x.shape[1] != 2 or not x.is_contiguous():
        raise ValueError(f"expected contiguous (N, 2) I/Q, got {tuple(x.shape)}")
    if mod not in ("ASK", "FSK"):
        raise ValueError(f"the stream block demodulates ASK or FSK, not {mod}")
    if len(x) <= int(bool(drop_first)) or len(x) >= 1 << 30:
        raise ValueError(f"a block needs more than {int(bool(drop_first))} and fewer than "
                         "2^30 samples")
    if (thresholds.dtype != torch.float32 or thresholds.device != x.device
            or thresholds.dim() != 1 or len(thresholds) >= 127):
        raise ValueError("thresholds: fewer than 127 float32 values on the samples' device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda" and x.data_ptr() % (2 * x.element_size()):
        raise ValueError("samples must be aligned to a whole (I, Q) sample")
    return x.device.type == "cuda"


def _launch(name: str, x: torch.Tensor, *args) -> None:
    fn = getattr(_build.library(), "urh_" + name)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.device.index == torch.cuda.current_device():
        rc = fn(x.data_ptr(), *args, stream)
    else:  # the launch goes to the current device: make it x's
        with torch.cuda.device(x.device):
            rc = fn(x.data_ptr(), *args, stream)
    if rc != 0:
        raise RuntimeError(f"urh_{name} launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


def _ingest_name(x: torch.Tensor) -> str:
    return "f32" if x.dtype == torch.float32 else "i8"


def stream_block(x: torch.Tensor, noise_sqrd: float, max_mag: float,
                 thresholds: torch.Tensor, mod: str, drop_first: bool, cap: int,
                 state_bits: int) -> torch.Tensor:
    """One block of a stream: (N, 2) float32 or int8 samples (int8 ingest
    scales by 1/128 on the device), sample 0 the previous block's last when
    ``drop_first`` -> the bundle, (2 + cap,) int32.  ``thresholds``:
    ascending float32 decision thresholds on x's device.  On the card: a
    memset and one kernel, no host sync."""
    if cap < 1:
        raise ValueError("cap must be at least 1")
    if not _check(x, thresholds, mod, drop_first):
        return stream_block_plain(x, noise_sqrd, max_mag, thresholds, mod, drop_first, cap,
                                  state_bits)[0]
    thresholds = thresholds.contiguous()
    ingest = _ingest_name(x)
    words = _build.library().urh_stream_block_work_words(len(x), cap, int(ingest == "i8"))
    work = torch.empty(words, dtype=torch.int32, device=x.device)
    _launch("stream_block_" + ingest, x, len(x), int(bool(drop_first)), noise_sqrd, max_mag,
            int(mod == "FSK"), thresholds.data_ptr(), len(thresholds), cap, state_bits,
            work.data_ptr())
    return work[:2 + cap]


def stream_states(x: torch.Tensor, noise_sqrd: float, max_mag: float,
                  thresholds: torch.Tensor, mod: str, drop_first: bool) -> torch.Tensor:
    """The block's per-sample int8 states after ``drop_first`` (N -
    drop_first,), for a block whose runs overflowed its bundle."""
    if not _check(x, thresholds, mod, drop_first):
        return stream_block_plain(x, noise_sqrd, max_mag, thresholds, mod, drop_first, 1,
                                  2)[1]
    thresholds = thresholds.contiguous()
    drop = int(bool(drop_first))
    states = torch.empty(len(x) - drop, dtype=torch.int8, device=x.device)
    _launch("stream_states_" + _ingest_name(x), x, len(x), drop, noise_sqrd, max_mag,
            int(mod == "FSK"), thresholds.data_ptr(), len(thresholds), states.data_ptr())
    return states
