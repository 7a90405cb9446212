"""The fused stream block (B6): demod, decision and run-length packing per chunk.

Port of urh_tpu/protocol/stream.py's XLA programs ``_runs_body`` /
``_block_runs`` / ``_block_runs_i8`` / ``_device_rle``.  For a CUDA tensor
:func:`stream_block` launches the three kernels of ``csrc/stream_block.cu``
on the current stream, without a host sync, and counts the call in
:data:`LAUNCHES`; for a CPU tensor it runs :func:`stream_block_plain`,
urh_tpu's program in torch ops.

Both return ``(bundle, states)``: the int32 bundle ``[n_runs, peak bits,
packed[cap]]`` with each run packed as ``(len << state_bits) | (state +
1)`` and 0 past the last, and the per-sample int8 states after
``drop_first``, which the stream reads only when ``n_runs > cap``.
"""

from __future__ import annotations

import torch

from urh_tpu_torch import _build
from urh_tpu_torch.dsp.demod import afp_demod_vec, noise_sentinel, scalar_f32
from urh_tpu_torch.dsp.symbols import _symbol_states_device

# kernel name -> launches since the last reset; only a kernel launch counts
LAUNCHES = {"stream_block_f32": 0, "stream_block_i8": 0}
TILE = 256  # states a block of the kernel's passes (i) and (iii): kTile in stream_block.cu
I8_SCALE = 1.0 / 128.0  # IQData's int8 -> float32 scale


def _ingest(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.int8:
        return x.to(torch.float32) * scalar_f32(I8_SCALE, x.device)
    return x


def stream_block_plain(x: torch.Tensor, noise_sqrd: float, max_mag: float,
                       thresholds: torch.Tensor, mod: str, drop_first: bool, cap: int,
                       state_bits: int):
    """urh_tpu's _runs_body (with _device_rle) in torch ops."""
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


def stream_block(x: torch.Tensor, noise_sqrd: float, max_mag: float,
                 thresholds: torch.Tensor, mod: str, drop_first: bool, cap: int,
                 state_bits: int):
    """One block of a stream: (N, 2) float32 or int8 samples (int8 ingest
    scales by 1/128 on the device), sample 0 the previous block's last when
    ``drop_first`` -> (bundle (2 + cap,) int32, states (N - drop_first,)
    int8).  ``thresholds``: ascending float32 decision thresholds on x's
    device."""
    if not isinstance(x, torch.Tensor) or x.dtype not in (torch.float32, torch.int8):
        raise TypeError("expected float32 or int8 samples as a torch.Tensor")
    if x.dim() != 2 or x.shape[1] != 2 or not x.is_contiguous():
        raise ValueError(f"expected contiguous (N, 2) I/Q, got {tuple(x.shape)}")
    if mod not in ("ASK", "FSK"):
        raise ValueError(f"the stream block demodulates ASK or FSK, not {mod}")
    n, drop = len(x), int(bool(drop_first))
    if n <= drop or cap < 1:
        raise ValueError(f"a block needs more than {drop} samples and cap >= 1")
    if (thresholds.dtype != torch.float32 or thresholds.device != x.device
            or thresholds.dim() != 1 or len(thresholds) >= 127):
        raise ValueError("thresholds: fewer than 127 float32 values on the samples' device")
    if x.device.type == "cpu":
        return stream_block_plain(x, noise_sqrd, max_mag, thresholds, mod, drop_first, cap,
                                  state_bits)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    name = "stream_block_f32" if x.dtype == torch.float32 else "stream_block_i8"
    thresholds = thresholds.contiguous()
    n_tiles = -(-max(n - drop, 1) // TILE)
    states = torch.empty(n - drop, dtype=torch.int8, device=x.device)
    tiles = torch.empty(3 * n_tiles, dtype=torch.int32, device=x.device)
    bundle = torch.empty(2 + cap, dtype=torch.int32, device=x.device)
    fn = getattr(_build.library(), "urh_" + name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), n, drop, noise_sqrd, max_mag, int(mod == "FSK"),
                thresholds.data_ptr(), len(thresholds), cap, state_bits, states.data_ptr(),
                tiles.data_ptr(), bundle.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"urh_{name} launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1
    return bundle, states
