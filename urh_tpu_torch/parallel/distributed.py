"""Multi-process execution on ``torch.distributed`` (port of
urh_tpu.parallel.distributed).

urh_tpu runs one multi-controller JAX runtime over every process and a
mesh that spans all their devices.  torch has no global array, so here
every process (a rank) holds its own shards of the capture and the ranks
line up in rank order:

* every process runs the same program and calls :func:`initialize`,
  which joins the process group over a ``tcp://`` rendezvous: NCCL when
  the process computes on a CUDA card, gloo on the CPU (NCCL puts one
  rank on a card, so on one card it runs at world size 1);
* ingest is per process: each reads only its slice of the capture
  (:func:`read_capture_slice`, a byte-range read) and
  :func:`make_global_capture` places it as the rank's shards, each with
  its global offset;
* the steps of :mod:`urh_tpu_torch.parallel.sharded` run unchanged on a
  rank's shards; the halo that crosses a rank boundary goes to the
  neighbouring rank only, by ``batch_isend_irecv``;
* results come back as this rank's ``(global_offset, numpy)`` shards, and
  the run-level reductions exchange run lists, not samples.

A failed collective raises; nothing drops to another backend or to the
host.  Tested with two gloo ranks on the CPU (tests/test_torch_distributed.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from urh_tpu_torch.core.iq import (max_magnitude_for_dtype, normalize_scale_shift,
                                   resolve_device)
from urh_tpu_torch.core.xfer import to_device, to_host
from urh_tpu_torch.dsp import costas
from urh_tpu_torch.dsp.demod import noise_sentinel
from urh_tpu_torch.dsp.symbols import _run_length_encode, get_center_thresholds
from urh_tpu_torch.parallel.sharded import (Mesh, _pulses_from_runs, build_sharded_demod,
                                            build_sharded_fir, build_sharded_stft,
                                            check_halo, shard_blocks)

_ENV_COORD = "URH_TPU_COORDINATOR"
_ENV_NUM_PROCS = "URH_TPU_NUM_PROCESSES"
_ENV_PROC_ID = "URH_TPU_PROCESS_ID"


def initialize(coordinator_address: str = None, num_processes: int = None,
               process_id: int = None, device=None) -> None:
    """Join the process group.

    The address (``host:port``), world size and rank default to the
    URH_TPU_COORDINATOR / URH_TPU_NUM_PROCESSES / URH_TPU_PROCESS_ID
    environment variables (a world of one without them).  ``device`` is
    the one this process computes on (default: the CUDA card,
    RuntimeError without one) and names the backend: NCCL for a CUDA
    device, gloo for the CPU."""
    address = coordinator_address or os.environ.get(_ENV_COORD) or "localhost:29500"
    num_processes = num_processes or _env_int(_ENV_NUM_PROCS) or 1
    if process_id is None:
        process_id = _env_int(_ENV_PROC_ID) or 0
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend="nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{address}",
                            world_size=int(num_processes), rank=int(process_id))


def shutdown() -> None:
    """Leave the process group."""
    dist.destroy_process_group()


def _env_int(name: str):
    raw = os.environ.get(name)
    return int(raw) if raw else None


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world() -> tuple:
    """(world size, rank): (1, 0) outside a process group."""
    if _in_group():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def is_distributed() -> bool:
    return _world()[0] > 1


def global_mesh(n_local: int = 1, axis: str = "b", device=None) -> Mesh:
    """This process's part of the global time-block mesh: ``n_local``
    shards on ``device`` (default: the rank's CUDA card, one a rank, as
    NCCL wants it; RuntimeError without one).  The global mesh is every
    rank's part in rank order."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("global_mesh() takes the CUDA card and none is available; "
                               "pass device='cpu'")
        device = torch.device("cuda", _world()[1] % torch.cuda.device_count())
    return Mesh((resolve_device(device),) * n_local, axis)


def _comm_device(like: torch.device) -> torch.device:
    """Where a collective's tensors live: the card under NCCL, else the CPU."""
    if _in_group() and dist.get_backend() == "nccl":
        return like if like.type == "cuda" else resolve_device(None)
    return torch.device("cpu")


# ---------------------------------------------------------------------------
# per-process ingest
# ---------------------------------------------------------------------------


def process_slice(total: int, num_processes: int = None,
                  process_id: int = None) -> tuple:
    """[start, end) of this process's sample range.

    Samples divide as evenly as possible; every process must make the
    same call so the global partition lines up.
    """
    world, rank = _world()
    num_processes = num_processes or world
    process_id = rank if process_id is None else process_id
    bounds = np.linspace(0, total, num_processes + 1, dtype=np.int64)
    return int(bounds[process_id]), int(bounds[process_id + 1])


def read_capture_slice(path: str, dtype, total_samples: int = None,
                       samples_per_frame: int = 2) -> np.ndarray:
    """Read only this process's byte range of a raw capture file.

    Each process memory-maps the capture and touches only its own slice.
    Returns the (local_n, samples_per_frame) block for this process.
    """
    dtype = np.dtype(dtype)
    if total_samples is None:
        total_samples = os.path.getsize(path) // (dtype.itemsize * samples_per_frame)
    start, end = process_slice(total_samples)
    mm = np.memmap(path, dtype=dtype, mode="r",
                   shape=(total_samples, samples_per_frame))
    return np.array(mm[start:end])


def _all_gather_ints(values, device) -> np.ndarray:
    """(world, *shape of values) int64: every rank's values, in rank order."""
    mine = torch.as_tensor(np.asarray(values, dtype=np.int64), device=_comm_device(device))
    if not _in_group():
        return mine[None].cpu().numpy()
    out = [torch.empty_like(mine) for _ in range(_world()[0])]
    dist.all_gather(out, mine)
    return torch.stack(out).cpu().numpy()


def make_global_capture(local_block: np.ndarray, mesh: Mesh) -> list:
    """This rank's shards of the global capture: [(global_offset, tensor),
    ...] in index order, each on its shard's device.  Every process passes
    its own (local_n, ...) block; the offsets come from an all-gather of
    the local lengths.  local_n must be divisible by mesh.size."""
    local_n = len(local_block)
    if local_n % mesh.size:
        raise ValueError(f"{local_n} local samples do not divide among {mesh.size} shards")
    lengths = _all_gather_ints([local_n], mesh.devices[0])[:, 0]
    offset = int(lengths[:_world()[1]].sum())
    per = local_n // mesh.size
    return [(offset + i * per, shard)
            for i, shard in enumerate(shard_blocks(np.asarray(local_block), mesh))]


def _pass_halo(payload: torch.Tensor, step: int):
    """Send ``payload`` to rank + step and receive the same shape from rank -
    step, with no ring wrap -> what was received, on payload's device; None
    where there is no rank - step (the capture's edge)."""
    world, rank = _world()
    comm = _comm_device(payload.device)
    wire = torch.view_as_real(payload) if payload.is_complex() else payload
    ops, got = [], None
    if 0 <= rank + step < world:
        ops.append(dist.P2POp(dist.isend, wire.to(comm).contiguous(), rank + step))
    if 0 <= rank - step < world:
        got = torch.empty(wire.shape, dtype=wire.dtype, device=comm)
        ops.append(dist.P2POp(dist.irecv, got, rank - step))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if got is None:
        return None
    return (torch.view_as_complex(got) if payload.is_complex() else got).to(payload.device)


def _left_from_rank(shards: list, size: int):
    """The ``size`` samples before this rank's first shard, from the rank
    before (None on rank 0: the capture's start)."""
    last = shards[-1]
    check_halo(last, size)
    return _pass_halo(last[len(last) - size:], 1)


def _right_from_rank(shards: list, size: int):
    """The ``size`` samples after this rank's last shard, from the rank
    after (None on the last rank: the capture's end)."""
    check_halo(shards[0], size)
    return _pass_halo(shards[0][:size], -1)


def _local_shards(shards: list) -> list:
    """[(global_offset, numpy block), ...] for this process, in order."""
    return [(offset, to_host(block)) for offset, block in shards]


# ---------------------------------------------------------------------------
# distributed pipeline entries
# ---------------------------------------------------------------------------


def distributed_demodulate(local_block: np.ndarray, noise_mag: float,
                           mod_type: str, center: float, center_spacing: float,
                           bits_per_symbol: int, mesh: Mesh = None,
                           dtype=np.float32) -> tuple:
    """Sharded demod+symbolize over every rank's shards.

    Each process contributes its locally-ingested block and receives back
    only its shards of (qad, states), as lists of (global_offset,
    numpy_block) pairs in index order."""
    qad, states = _demodulate_shards(local_block, noise_mag, mod_type, center,
                                     center_spacing, bits_per_symbol, mesh, dtype)
    return _local_shards(qad), _local_shards(states)


def _demodulate_shards(local_block, noise_mag, mod_type, center, center_spacing,
                       bits_per_symbol, mesh, dtype):
    mesh = mesh if mesh is not None else global_mesh()
    placed = make_global_capture(np.ascontiguousarray(local_block, dtype=np.float32), mesh)
    offsets, shards = [o for o, _ in placed], [s for _, s in placed]
    # FSK's discriminator reads the sample before; for ASK the halo only
    # says that the rank's first shard does not open the capture
    left = _left_from_rank(shards, 1)
    step = build_sharded_demod(mesh, mod_type)
    thresholds = get_center_thresholds(center, center_spacing, 2 ** bits_per_symbol)
    qad, states = step(shards, float(np.float32(noise_mag * noise_mag)),
                       max_magnitude_for_dtype(dtype), thresholds, left=left)
    return list(zip(offsets, qad)), list(zip(offsets, states))


def distributed_pulse_lens(local_block: np.ndarray, noise_mag: float,
                           mod_type: str, center: float, center_spacing: float,
                           bits_per_symbol: int, tolerance: int,
                           samples_per_symbol: int, mesh: Mesh = None,
                           dtype=np.float32) -> np.ndarray:
    """Full distributed front half: demod -> symbolize -> local runs ->
    global pulse list.

    Per-sample arrays stay on each rank's devices; each shard reduces to
    a run list there, and the ranks all-gather only those (first the
    counts, then the rows padded to the largest count).  Every process
    returns the identical global pulse list."""
    _, states = _demodulate_shards(local_block, noise_mag, mod_type, center, center_spacing,
                                   bits_per_symbol, mesh, dtype)
    device = states[0][1].device

    # local reduction: samples -> (state, start, length) runs
    local_runs = []
    for offset, block in states:
        if len(block):
            r_states, r_starts, r_lens = _run_length_encode(block)
            local_runs.append(np.column_stack(
                (r_states.astype(np.int64), r_starts + offset, r_lens)))
    local_runs = (np.concatenate(local_runs) if local_runs
                  else np.zeros((0, 3), dtype=np.int64))

    # exchange run lists (ragged): pad to the max count across processes
    counts = _all_gather_ints([len(local_runs)], device)[:, 0]
    max_count = max(int(counts.max()), 1)
    padded = np.full((max_count, 3), -1, dtype=np.int64)
    padded[: len(local_runs)] = local_runs
    gathered = _all_gather_ints(padded, device)

    rows = [gathered[p, : counts[p]] for p in range(len(counts))]
    all_runs = np.concatenate(rows)
    all_runs = all_runs[np.argsort(all_runs[:, 1], kind="stable")]

    # merge runs straddling process/shard boundaries
    r_states, r_starts, r_lens = _merge_adjacent_runs(all_runs)
    n = int((r_starts[-1] + r_lens[-1]) if len(r_starts) else 0)
    thresholds = get_center_thresholds(center, center_spacing, 2 ** bits_per_symbol)
    return _pulses_from_runs(r_states, r_starts, r_lens, n, mod_type, thresholds,
                             bits_per_symbol, tolerance, samples_per_symbol)


def _merge_adjacent_runs(runs: np.ndarray) -> tuple:
    """Fuse consecutive runs with equal state (shard boundary stitches)."""
    if len(runs) == 0:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty.copy(), empty.copy()
    states, starts, lens = runs[:, 0], runs[:, 1], runs[:, 2]
    new_group = np.ones(len(runs), dtype=bool)
    new_group[1:] = states[1:] != states[:-1]
    group_ids = np.cumsum(new_group) - 1
    g_states = states[new_group]
    g_starts = starts[new_group]
    g_lens = np.bincount(group_ids, weights=lens).astype(np.int64)
    return g_states, g_starts, g_lens


# ---------------------------------------------------------------------------
# cross-process FIR / STFT / exact PSK
# ---------------------------------------------------------------------------


def distributed_fir_filter(local_block: np.ndarray, taps, mesh: Mesh = None) -> list:
    """Causal FIR over every rank's shards: the (n_taps - 1)-sample halo
    crosses a rank boundary from the rank before; each process
    contributes its local block and receives back only its filtered
    shards as (global_offset, block) pairs.  Output equals filtering the
    unsharded stream (overlap-save halo, sharded.build_sharded_fir)."""
    mesh = mesh if mesh is not None else global_mesh()
    placed = make_global_capture(np.ascontiguousarray(local_block, dtype=np.complex64), mesh)
    offsets, shards = [o for o, _ in placed], [s for _, s in placed]
    left = _left_from_rank(shards, len(taps) - 1)
    step = build_sharded_fir(mesh, len(taps))
    out = step(shards, to_device(np.asarray(taps, np.complex64), mesh.devices[0]), left=left)
    return _local_shards(list(zip(offsets, out)))


def distributed_spectrogram(local_block: np.ndarray, window_size=1024,
                            overlap_factor=0.5, mesh: Mesh = None) -> list:
    """Frame-sharded STFT across processes: each shard takes its
    (window - hop)-sample halo from its right neighbour, across a rank
    boundary from the rank after.  Every shard of every rank must hold
    the same whole number of hops.  Returns local (frame_offset, rows)
    shards."""
    mesh = mesh if mesh is not None else global_mesh()
    hop = window_size - int(overlap_factor * window_size)
    placed = make_global_capture(np.ascontiguousarray(local_block, dtype=np.complex64), mesh)
    offsets, shards = [o for o, _ in placed], [s for _, s in placed]
    lengths = _all_gather_ints([len(local_block)], shards[0].device)[:, 0]
    total, n_shards = int(lengths.sum()), mesh.size * len(lengths)
    if total % (n_shards * hop) != 0 or np.any(lengths != lengths[0]):
        raise ValueError(
            f"global capture ({total}) must divide into {n_shards} equal shards of "
            f"whole {hop}-sample hops")
    frames_per_shard = total // (n_shards * hop)
    right = _right_from_rank(shards, window_size - hop)
    step = build_sharded_stft(mesh, window_size, hop, frames_per_shard)
    out = step(shards, right=right)
    return _local_shards([(o // hop, rows) for o, rows in zip(offsets, out)])


def distributed_psk_demod_exact(local_block: np.ndarray, noise_mag: float,
                                mod_order: int = 2,
                                costas_loop_bandwidth: float = 0.1,
                                dtype=np.float32, device=None) -> tuple:
    """Bit-exact PSK across processes: chained Costas scans in rank order,
    each rank's block one B5 launch on ``device`` (default: the rank's
    card), with only the 8-byte (phase, freq) carry crossing a rank
    boundary: broadcast from the rank that just ran, as a device tensor.

    Returns (global_offset, local_qad) for this process; concatenating
    all processes' blocks equals afp_demod(full, noise, "PSK", order)
    bit for bit (rank 0's block carries the sample-0 sentinel)."""
    world, rank = _world()
    if device is None:
        device = global_mesh().devices[0]
    device = resolve_device(device)
    x = np.ascontiguousarray(local_block, dtype=np.float32)
    counts = _all_gather_ints([len(x)], device)[:, 0]
    offset = int(counts[:rank].sum())

    scale, shift = normalize_scale_shift(np.dtype(dtype))
    comm = _comm_device(device)
    carry = costas.new_carry(device)
    local_qad = None
    for p in range(world):
        if p == rank:
            body = x[1:] if rank == 0 else x  # afp_demod skips sample 0
            outs = costas.costa_demod_scan(to_device(body, device),
                                           float(np.float32(noise_mag * noise_mag)), scale,
                                           shift, int(mod_order), costas_loop_bandwidth,
                                           carry)
            local_qad = np.empty(len(x), dtype=np.float32)
            if rank == 0:
                local_qad[:1] = noise_sentinel("PSK")
            local_qad[len(x) - len(body):] = to_host(outs)
        if _in_group():
            # everyone adopts the carry left by the rank that just ran, so
            # the next rank in the chain starts from it
            shared = carry.to(comm)
            dist.broadcast(shared, src=p)
            carry = shared.to(device)
    return offset, local_qad
