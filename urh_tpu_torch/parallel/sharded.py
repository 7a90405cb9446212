"""Block-sharded streaming DSP over a mesh of shards (port of
urh_tpu.parallel.sharded).

A long capture is cut into contiguous time blocks, one a shard, and each
shard computes on its own device.  A :class:`Mesh` is an ordered tuple of
torch devices, one entry a shard.  A device may appear more than once:
its shards then share its memory, and a halo between them is a slice of
the neighbour's block; across devices a halo is moved with ``.to()``.
urh_tpu's ``shard_map`` programs exchange halos by ``ppermute``; here the
step a ``build_sharded_*`` function returns takes the list of shard
blocks and hands each block its neighbour's edge:

* the elementwise stages (magnitude, gate, envelope, symbol states) need
  no halo;
* the FSK discriminator needs a 1-sample left halo;
* the FIR filter an (n_taps - 1)-sample left halo (overlap-save);
* the STFT a (window - hop)-sample right halo;
* the Costas loop, a sequential feedback recursion, runs two ways:
  block-parallel, each shard relocking over a margin of samples from its
  left neighbour, all the shards of a device in one launch of the batched
  kernel B9 (:func:`urh_tpu_torch.dsp.costas.costa_demod_scan_batch`); or
  exact, the (phase, freq) carry chained from block to block through B5.

A step also takes the halo that the first shard of its list gets from
outside (``left`` / ``right``, zeros when None: the capture's edge);
:mod:`urh_tpu_torch.parallel.distributed` passes the one it receives from
the neighbouring rank.  Host entries take and return NumPy, as urh_tpu's
do, and default to a mesh over the CUDA cards (RuntimeError without one).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from urh_tpu_torch.core.iq import (max_magnitude_for_dtype, normalize_scale_shift,
                                   resolve_device)
from urh_tpu_torch.core.xfer import to_device, to_host
from urh_tpu_torch.dsp import costas
from urh_tpu_torch.dsp.demod import afp_demod_vec, noise_sentinel, scalar_f32
from urh_tpu_torch.dsp.spectrogram import _stft_device
from urh_tpu_torch.dsp.symbols import (PAUSE_STATE, _initial_state, _run_length_encode,
                                       _symbol_states_device, get_center_thresholds,
                                       pulse_lens_from_runs)


@dataclass(frozen=True)
class Mesh:
    """The shards of a 1-D time-block mesh: ``devices[i]`` computes block i."""

    devices: tuple
    axis: str = "b"

    @property
    def size(self) -> int:
        return len(self.devices)

    def by_device(self) -> list:
        """[(device, [shard indices]), ...], each device once, in first-shard
        order."""
        groups: dict = {}
        for i, dev in enumerate(self.devices):
            groups.setdefault(dev, []).append(i)
        return list(groups.items())


def make_mesh(n_devices: int = None, axis: str = "b", device=None) -> Mesh:
    """Without ``device``: one shard a visible CUDA card (the first
    ``n_devices``), as urh_tpu takes ``jax.devices()``; RuntimeError without
    a card.  With ``device``: ``n_devices`` shards (default 1) on it, e.g.
    ``make_mesh(8, device="cpu")``, the counterpart of the 8 virtual CPU
    devices urh_tpu's tests run on."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() takes the CUDA cards and none is available; "
                               "pass device='cpu'")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = devices[:n_devices] if n_devices is not None else devices
    else:
        devices = [resolve_device(device)] * (1 if n_devices is None else n_devices)
    if not devices:
        raise ValueError("a mesh needs at least one shard")
    return Mesh(tuple(devices), axis)


def pad_to_blocks(x: np.ndarray, n_blocks: int):
    """Pad sample axis to a multiple of n_blocks; returns (padded, orig_len)."""
    n = x.shape[0]
    padded = (n + n_blocks - 1) // n_blocks * n_blocks
    if padded != n:
        pad_width = [(0, padded - n)] + [(0, 0)] * (x.ndim - 1)
        x = np.pad(x, pad_width)
    return x, n


def shard_blocks(x: np.ndarray, mesh: Mesh) -> list:
    """Cut x (its length a multiple of mesh.size) into mesh.size blocks, one
    a shard, on the shard's device: one copy a device, each block a view."""
    blocks = x.reshape(mesh.size, -1, *x.shape[1:])
    shards = [None] * mesh.size
    for dev, idx in mesh.by_device():
        contiguous = idx == list(range(idx[0], idx[-1] + 1))
        on_device = to_device(blocks[idx[0]:idx[-1] + 1] if contiguous else blocks[idx], dev)
        for j, i in enumerate(idx):
            shards[i] = on_device[j]
    return shards


def check_halo(block: torch.Tensor, size: int):
    """A halo of ``size`` samples is cut from one neighbouring block."""
    if len(block) < size:
        raise ValueError(f"a {size}-sample halo needs blocks of at least {size} samples, "
                         f"not {len(block)}")


def _left_halos(shards: list, size: int, left=None) -> list:
    """The ``size`` samples before each shard, on its device: the left
    neighbour's last ones; ``left`` before the first (zeros when None)."""
    halos = []
    for i, x in enumerate(shards):
        if i == 0:
            halo = x.new_zeros((size, *x.shape[1:])) if left is None else left.to(x.device)
        else:
            prev = shards[i - 1]
            check_halo(prev, size)
            halo = prev[len(prev) - size:].to(x.device)
        halos.append(halo)
    return halos


def _right_halos(shards: list, size: int, right=None) -> list:
    """The ``size`` samples after each shard, on its device: the right
    neighbour's first ones; ``right`` after the last (zeros when None)."""
    halos = []
    for i, x in enumerate(shards):
        if i == len(shards) - 1:
            halo = x.new_zeros((size, *x.shape[1:])) if right is None else right.to(x.device)
        else:
            check_halo(shards[i + 1], size)
            halo = shards[i + 1][:size].to(x.device)
        halos.append(halo)
    return halos


def build_sharded_demod(mesh: Mesh, mod_type: str):
    """-> step(shards, noise_sqrd, max_mag, thresholds, left=None) ->
    (qad shards, states shards): demod and symbol states of each (n, 2)
    float32 block on its device.  ``left`` is the (1, 2) sample before the
    first shard; None: the first shard opens the capture."""
    if mod_type not in ("FSK", "ASK"):
        raise ValueError(f"sharded demod supports ASK/FSK, not {mod_type}")
    sentinel = noise_sentinel(mod_type)

    def step(shards, noise_sqrd, max_mag, thresholds, left=None):
        halos = (_left_halos(shards, 1, left) if mod_type == "FSK"
                 else [x[:1] for x in shards])  # ASK needs none: any sample will do
        thresholds = np.asarray(thresholds, dtype=np.float32)
        qads, states = [], []
        for i, (x, prev) in enumerate(zip(shards, halos)):
            if i == 0 and left is None:  # the capture's sample 0: the sentinel
                qad = afp_demod_vec(x, noise_sqrd, max_mag, mod_type)
            else:
                qad = afp_demod_vec(torch.cat((prev, x)), noise_sqrd, max_mag, mod_type)[1:]
            qads.append(qad)
            states.append(_symbol_states_device(qad, to_device(thresholds, x.device),
                                                sentinel))
        return qads, states

    return step


def _demod_shards(iq_f32, noise_mag, mod_type, center, center_spacing, bits_per_symbol,
                  mesh, dtype):
    """-> (qad shards, states shards, thresholds, n) of the capture padded
    to whole blocks."""
    x, n = pad_to_blocks(np.asarray(iq_f32, dtype=np.float32), mesh.size)
    thresholds = get_center_thresholds(center, center_spacing, 2 ** bits_per_symbol)
    step = build_sharded_demod(mesh, mod_type)
    qads, states = step(shard_blocks(x, mesh), float(np.float32(noise_mag * noise_mag)),
                        max_magnitude_for_dtype(dtype), thresholds)
    return qads, states, thresholds, n


def sharded_demodulate(iq_f32: np.ndarray, noise_mag: float, mod_type: str,
                       center: float, center_spacing: float, bits_per_symbol: int,
                       mesh: Mesh = None, dtype=np.float32):
    """Host entry: shard a capture by time block, demodulate and symbolize
    on the mesh, return (qad, states) as numpy (original length)."""
    mesh = mesh if mesh is not None else make_mesh()
    if len(iq_f32) == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.int32)
    qads, states, _, n = _demod_shards(iq_f32, noise_mag, mod_type, center, center_spacing,
                                       bits_per_symbol, mesh, dtype)
    return (np.concatenate([to_host(q) for q in qads])[:n],
            np.concatenate([to_host(s) for s in states])[:n])


# ---------------------------------------------------------------------------
# Overlap-save FIR filtering with an (n_taps - 1)-sample halo
# ---------------------------------------------------------------------------


def build_sharded_fir(mesh: Mesh, n_taps: int):
    """-> step(shards, taps, left=None) -> filtered shards: a causal FIR
    over complex64 blocks.  Each block is extended by its left halo
    (n_taps - 1 samples; ``left`` before the first shard, zeros when None)
    and filtered by one zero-padded FFT of the next power of two, as
    urh_tpu does, so out[i] = sum_j x[i-j] h[j] of the unsharded stream."""
    halo = n_taps - 1

    def step(shards, taps, left=None):
        out = []
        for x, h in zip(shards, _left_halos(shards, halo, left)):
            extended = torch.cat((h, x))
            n = extended.shape[0] + n_taps - 1
            n_fft = 1 << (n - 1).bit_length()
            spectrum = torch.fft.fft(taps.to(x.device), n_fft)
            full = torch.fft.ifft(torch.fft.fft(extended, n_fft) * spectrum)
            out.append(full[halo:halo + x.shape[0]].to(x.dtype))
        return out

    return step


def sharded_fir_filter(x: np.ndarray, taps: np.ndarray, mesh: Mesh = None) -> np.ndarray:
    """Host entry: causal FIR over a time-block sharded capture."""
    mesh = mesh if mesh is not None else make_mesh()
    x = np.asarray(x, dtype=np.complex64)
    if len(x) == 0:
        return x.copy()
    padded, n = pad_to_blocks(x, mesh.size)
    step = build_sharded_fir(mesh, len(taps))
    out = step(shard_blocks(padded, mesh), to_device(np.asarray(taps, np.complex64),
                                                     mesh.devices[0]))
    return np.concatenate([to_host(o) for o in out])[:n]


# ---------------------------------------------------------------------------
# Sharded STFT spectrogram: frames sharded across the mesh with a
# (window - hop)-sample halo from the right neighbour
# ---------------------------------------------------------------------------


def build_sharded_stft(mesh: Mesh, window_size: int, hop_size: int,
                       frames_per_shard: int):
    """-> step(shards, right=None) -> (frames_per_shard, window_size)
    complex64 rows a shard: each block of frames_per_shard * hop_size
    samples is extended by its right halo and framed as
    ``Spectrogram.stft`` frames (np.hanning's window, divided by
    window_size)."""
    overlap = window_size - hop_size

    def step(shards, right=None):
        return [_stft_device(torch.cat((x, h)), window_size, hop_size, frames_per_shard,
                             "hanning")
                for x, h in zip(shards, _right_halos(shards, overlap, right))]

    return step


def sharded_spectrogram(samples: np.ndarray, mesh: Mesh = None, window_size=1024,
                        overlap_factor=0.5) -> np.ndarray:
    """STFT over a time-block sharded capture, equal to the single-device
    Spectrogram.stft output."""
    mesh = mesh if mesh is not None else make_mesh()
    n_dev = mesh.size
    hop = window_size - int(overlap_factor * window_size)

    samples = np.asarray(samples, dtype=np.complex64)
    num_frames = max(1, (len(samples) - window_size) // hop + 1)
    frames_per_shard = -(-num_frames // n_dev)
    needed = (frames_per_shard * n_dev - 1) * hop + window_size
    if len(samples) < needed:
        samples = np.pad(samples, (0, needed - len(samples)))

    # each shard owns frames_per_shard frames = frames_per_shard*hop samples
    x = samples[: n_dev * frames_per_shard * hop]
    step = build_sharded_stft(mesh, window_size, hop, frames_per_shard)
    out = step(shard_blocks(x, mesh))
    return np.concatenate([to_host(o) for o in out])[:num_frames]


# ---------------------------------------------------------------------------
# PSK Costas loop: block-parallel with overlap-discard relocking (B9)
# ---------------------------------------------------------------------------


def build_sharded_costas(mesh: Mesh, loop_order: int, margin: int):
    """Block-parallel Costas demodulation: -> step(shards, noise_sqrd,
    scale, shift, bandwidth) -> qad shards.

    The loop is a sequential IIR, so exact sharding would serialize.
    Instead each block prepends ``margin`` halo samples from its left
    neighbour (zeros before the first, which the gate skips) and runs the
    loop from the default initial state (1.5, 0): the loop re-locks during
    the margin and the margin outputs are discarded.  The shards of one
    device run as the rows of one B9 launch.

    UNSAFE when the margin cannot hold enough lock-in signal: blocks
    shorter than a few hundred symbols (the host entry clamps margin to
    the block length, sharded_psk_demod), margins that fall entirely
    inside a pause (no signal to re-lock on), or captures where phase
    continuity across a block boundary is itself the signal of interest.
    Use :func:`sharded_psk_demod_exact` (chained carries, bit-identical)
    for those cases.
    """

    def step(shards, noise_sqrd, scale, shift, bandwidth):
        out = [None] * len(shards)
        for idx, streams in costas_streams(mesh, shards, margin):
            carry = costas.new_carry(streams.device).repeat(len(idx), 1)
            qad = costas.costa_demod_scan_batch(streams, noise_sqrd, scale, shift, loop_order,
                                                bandwidth, carry)
            for j, i in enumerate(idx):
                out[i] = qad[j, margin:]
        return out

    return step


def costas_streams(mesh: Mesh, shards: list, margin: int) -> list:
    """The rows of each device's B9 launch: [(shard indices, (k, margin +
    block, 2) float32 streams), ...], each shard after the ``margin``
    samples before it (zeros before the first)."""
    halos = _left_halos(shards, margin)
    out = []
    for _, idx in mesh.by_device():
        dev = shards[idx[0]].device
        out.append((idx, torch.cat((torch.stack([halos[i] for i in idx]),
                                    torch.stack([shards[i].to(dev) for i in idx])), dim=1)))
    return out


def sharded_psk_demod(iq_f32: np.ndarray, noise_mag: float, mod_order: int = 2,
                      costas_loop_bandwidth: float = 0.1, margin: int = 4096,
                      mesh: Mesh = None, dtype=np.float32) -> np.ndarray:
    """Host entry: block-parallel PSK (:func:`build_sharded_costas`), one
    B9 launch a device; sample 0 is the sentinel, as afp_demod writes it."""
    mesh = mesh if mesh is not None else make_mesh()
    x, n = pad_to_blocks(np.asarray(iq_f32, dtype=np.float32), mesh.size)
    if n == 0:
        return np.zeros(0, np.float32)
    margin = min(margin, len(x) // mesh.size)  # halo cannot exceed a block

    scale, shift = normalize_scale_shift(dtype)
    step = build_sharded_costas(mesh, int(mod_order), margin)
    out = step(shard_blocks(x, mesh), float(np.float32(noise_mag * noise_mag)), scale, shift,
               costas_loop_bandwidth)
    result = np.concatenate([to_host(o) for o in out])[:n]
    result[0] = noise_sentinel("PSK")  # afp_demod sample-0 convention
    return result


# ---------------------------------------------------------------------------
# Sharded modulation: batch of messages sharded across the mesh (DP-style)
# ---------------------------------------------------------------------------


def build_sharded_modulator(mesh: Mesh, sps: int):
    """-> synth(a_sym, f_sym, phi_sym, sample_rate): batched FSK/ASK/PSK
    synthesis of per-symbol parameter arrays (B, S), split by rows over the
    shards -> one (B / shards, S * sps, 2) float32 tensor a shard, on its
    device.  ValueError when the shards do not divide B, as shard_map
    refuses it."""

    def synth(a_sym, f_sym, phi_sym, sample_rate):
        rows = len(a_sym)
        if rows % mesh.size:
            raise ValueError(f"{rows} messages do not divide among {mesh.size} shards")
        per = rows // mesh.size
        out = []
        for i, dev in enumerate(mesh.devices):
            a, f, phi = (to_device(np.asarray(v[i * per:(i + 1) * per], np.float32), dev)
                         .repeat_interleave(sps, dim=1) for v in (a_sym, f_sym, phi_sym))
            t = (torch.arange(a.shape[1], dtype=torch.float32, device=a.device)
                 / scalar_f32(sample_rate, a.device))
            arg = scalar_f32(2 * np.pi, a.device) * f * t[None, :] + phi
            out.append(torch.stack((a * torch.cos(arg), a * torch.sin(arg)), dim=-1))
        return out

    return synth


def sharded_psk_demod_exact(iq_f32: np.ndarray, noise_mag: float,
                            mod_order: int = 2,
                            costas_loop_bandwidth: float = 0.1,
                            mesh: Mesh = None, dtype=np.float32) -> np.ndarray:
    """Bit-identical sharded PSK: chained per-block Costas scans.

    The Costas loop is a sequential IIR, so blocks execute one after
    another, each as one B5 launch on its shard's device, and only the
    8-byte (phase, freq) carry crosses a block boundary: it stays a device
    tensor, moved with ``.to()`` where the next shard is on another device.
    The approximate-but-parallel alternative is :func:`sharded_psk_demod`.

    Output is bitwise equal to ``afp_demod(iq, noise, "PSK", order)``.
    """
    mesh = mesh if mesh is not None else make_mesh()
    x = np.asarray(iq_f32, dtype=np.float32)
    n = len(x)
    if n <= 2:
        return np.zeros(n, dtype=np.float32)

    scale, shift = normalize_scale_shift(dtype)
    noise_sqrd = float(np.float32(noise_mag * noise_mag))
    # the loop processes samples 1..n-1 (afp_demod excludes sample 0)
    bounds = np.linspace(1, n, mesh.size + 1, dtype=np.int64)
    carry, pieces = None, []
    for dev, lo, hi in zip(mesh.devices, bounds[:-1], bounds[1:]):
        if hi == lo:
            continue
        block = to_device(x[lo:hi], dev)
        carry = costas.new_carry(block.device) if carry is None else carry.to(block.device)
        pieces.append(costas.costa_demod_scan(block, noise_sqrd, scale, shift, int(mod_order),
                                              costas_loop_bandwidth, carry))

    result = np.empty(n, dtype=np.float32)
    result[0] = noise_sentinel("PSK")  # afp_demod sample-0 convention
    result[1:] = np.concatenate([to_host(p) for p in pieces])
    return result


# ---------------------------------------------------------------------------
# Shard-local run extraction: symbolized states never gather to one host
# ---------------------------------------------------------------------------


def states_to_runs(states, total_len: int = None):
    """Run-length encode a state array, whole or as a list of shard blocks
    in index order.

    Each shard is run-length encoded on its own device, so only its runs
    reach the host, and runs that straddle shard boundaries merge: the
    full per-sample array is never gathered.  Returns (run_states,
    run_starts, run_lengths) as int64 numpy arrays covering samples
    [0, total_len)."""
    blocks = [states] if isinstance(states, (np.ndarray, torch.Tensor)) else list(states)
    offsets = np.cumsum([0] + [len(b) for b in blocks])
    if total_len is None:
        total_len = int(offsets[-1])

    all_states, all_starts, all_lens = [], [], []
    for offset, block in zip(offsets, blocks):
        block = block[: max(total_len - offset, 0)]
        if len(block) == 0:
            continue
        r_states, r_starts, r_lens = _run_length_encode(block)
        r_starts = r_starts + offset
        if all_states and all_states[-1][-1] == r_states[0]:
            # boundary run continues the previous shard's last run
            all_lens[-1][-1] += r_lens[0]
            r_states, r_starts, r_lens = r_states[1:], r_starts[1:], r_lens[1:]
        if len(r_states):
            all_states.append(np.asarray(r_states, dtype=np.int64))
            all_starts.append(np.asarray(r_starts, dtype=np.int64))
            all_lens.append(np.asarray(r_lens, dtype=np.int64))

    if not all_states:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty.copy(), empty.copy()
    return (np.concatenate(all_states), np.concatenate(all_starts),
            np.concatenate(all_lens))


def sharded_pulse_lens(iq_f32: np.ndarray, noise_mag: float, mod_type: str,
                       center: float, center_spacing: float,
                       bits_per_symbol: int, tolerance: int,
                       samples_per_symbol: int, mesh: Mesh = None,
                       dtype=np.float32) -> np.ndarray:
    """Sharded demod -> symbolize -> pulse extraction without gathering.

    The per-sample work (demod and threshold symbolization) runs sharded
    on the mesh; each shard's states reduce to a run list on its device and
    only the run lists reach the pulse machine.  Output equals
    ``grab_pulse_lens(afp_demod(...), ...)`` exactly."""
    mesh = mesh if mesh is not None else make_mesh()
    if len(iq_f32) == 0:
        return np.zeros((0, 2), dtype=np.int64)
    _, states, thresholds, n = _demod_shards(iq_f32, noise_mag, mod_type, center,
                                             center_spacing, bits_per_symbol, mesh, dtype)
    r_states, r_starts, r_lens = states_to_runs(states, total_len=n)
    return _pulses_from_runs(r_states, r_starts, r_lens, n, mod_type, thresholds,
                             bits_per_symbol, tolerance, samples_per_symbol)


def _pulses_from_runs(r_states, r_starts, r_lens, n, mod_type, thresholds, bits_per_symbol,
                      tolerance, samples_per_symbol) -> np.ndarray:
    """The pulse machine over a whole capture's runs; the initial state
    from the first run (sample 0, the sentinel, is a pause)."""
    sentinel = noise_sentinel(mod_type)
    first_state = r_states[0] if len(r_states) else PAUSE_STATE
    first_sample = sentinel if first_state == PAUSE_STATE else sentinel + 1.0
    initial = _initial_state(first_sample, thresholds, sentinel, 2 ** bits_per_symbol)
    return pulse_lens_from_runs(r_states, r_starts, r_lens, n, initial, tolerance,
                                mod_type == "ASK", samples_per_symbol)
