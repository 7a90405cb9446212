"""Symbol decision: rectangular signal -> (state, length) pulse runs.

PyTorch port of urh_tpu.dsp.symbols: a run-level reformulation of the
reference's sequential run-length state machine
(urh/cythonext/signal_functions.pyx:380-511).  The per-sample work
(threshold comparison -> symbol state, and the run-length encoding of the
states) is PyTorch on the samples' device, so only the runs cross to the
host; the glitch-tolerance logic runs on the host over runs:

The reference machine commits a state change at the (tolerance+1)-th
consecutive sample of a new state.  Consecutive-sample counts are
exactly run lengths of the per-sample state sequence, so:

* a run of length <= tolerance can never commit (glitch, absorbed);
* a run of length > tolerance commits at ``run_start + tolerance`` iff
  its state differs from the machine's current state — i.e. commits are
  the consecutive-deduplicated sequence of "long" runs (dropping leading
  runs equal to the initial state);
* emitted pulse lengths are the distances between successive commit
  positions (first: commit_pos+1-tolerance; last: n-1-last_commit_pos).
"""

from __future__ import annotations

import numpy as np
import torch

from urh_tpu_torch.dsp.demod import noise_sentinel

PAUSE_STATE = -1


def get_center_thresholds(center: float, spacing: float, modulation_order: int) -> np.ndarray:
    """Decision thresholds for 2^bps-ary modulation
    (signal_functions.pyx:380-390)."""
    result = np.empty(modulation_order - 1, dtype=np.float32)
    n = modulation_order // 2
    for i in range(n):
        result[i] = center - (n - (i + 1)) * spacing
    for i in range(n, modulation_order - 1):
        result[i] = center + (i + 1 - n) * spacing
    return result


def _symbol_states_device(samples: torch.Tensor, thresholds: torch.Tensor,
                          sentinel: float) -> torch.Tensor:
    """Map each demodulated sample to a symbol state (or -1 for pause).

    state = first k with s <= thresholds[k], else order-1; thresholds are
    ascending so this equals the count of thresholds strictly below s.
    """
    state = torch.sum(samples[:, None] > thresholds[None, :], dim=1,
                      dtype=torch.int32)
    return state.masked_fill_(samples == sentinel, PAUSE_STATE)


def symbol_states(samples, thresholds: np.ndarray, sentinel: float) -> torch.Tensor:
    """Symbol states of ``samples`` (a tensor, on its device; numpy on the
    CPU) as int32."""
    x = torch.as_tensor(samples, dtype=torch.float32)
    thr = torch.as_tensor(np.asarray(thresholds, dtype=np.float32), device=x.device)
    return _symbol_states_device(x, thr, sentinel)


def _run_length_encode(states):
    """-> (run_states, run_starts, run_lengths) as host numpy arrays.

    A (non-empty) tensor is encoded on its own device, so only the runs
    cross to the host."""
    n = len(states)
    if isinstance(states, torch.Tensor):
        change = torch.nonzero(states[1:] != states[:-1]).flatten() + 1
        starts = torch.cat((change.new_zeros(1), change))
        ends = torch.cat((change, change.new_tensor([n])))
        return (states[starts].cpu().numpy(), starts.cpu().numpy(),
                (ends - starts).cpu().numpy())
    if n == 0:
        return states, np.zeros(0, np.int64), np.zeros(0, np.int64)
    change = np.flatnonzero(states[1:] != states[:-1]) + 1
    starts = np.concatenate(([0], change)).astype(np.int64)
    ends = np.concatenate((change, [n])).astype(np.int64)
    return states[starts], starts, ends - starts


def _initial_state(first_sample: float, thresholds: np.ndarray, sentinel: float, modulation_order: int) -> int:
    # Reference quirk (signal_functions.pyx:421-429): when the first sample is
    # not noise, the initial state is computed from the value 0.0 (an
    # uninitialized loop variable), not from the first sample.  Replicated
    # for bit-exact parity.
    if first_sample == sentinel:
        return PAUSE_STATE
    for k in range(modulation_order - 1):
        if 0.0 <= thresholds[k]:
            return k
    return modulation_order - 1


def grab_pulse_lens(
    samples,
    center: float,
    tolerance: int,
    modulation_type: str,
    samples_per_symbol: int,
    bits_per_symbol: int = 1,
    center_spacing: float = 0.1,
    precomputed_states=None,
) -> np.ndarray:
    """Pulse-run extraction: -> int64 array (M, 2) of (state, length).

    state -1 encodes pause.  Semantics of signal_functions.pyx:392-495.
    ``samples`` and ``precomputed_states`` are tensors (or numpy, taken
    as CPU tensors).  ``precomputed_states`` skips per-sample
    symbolization when a fused demod kernel already produced states; with
    ``samples=None`` they are the only input (int8 states-only route).
    """
    modulation_order = 2 ** bits_per_symbol
    is_ask = modulation_type == "ASK"
    sentinel = noise_sentinel(modulation_type)
    thresholds = get_center_thresholds(center, center_spacing, modulation_order)

    if samples is None:
        # states-only route (int8 fused kernels): sample 0's only role is
        # the sentinel check in the initial-state quirk, recoverable from
        # states[0]
        if precomputed_states is None:
            raise ValueError("samples=None needs precomputed_states")
        states = torch.as_tensor(precomputed_states)
        n = len(states)
        if n == 0:
            return np.zeros((0, 2), dtype=np.int64)
        first_sample = sentinel if int(states[0]) == PAUSE_STATE else sentinel + 1.0
    else:
        samples = torch.as_tensor(samples, dtype=torch.float32)
        n = len(samples)
        if n == 0:
            return np.zeros((0, 2), dtype=np.int64)
        if precomputed_states is not None and len(precomputed_states) == n:
            states = torch.as_tensor(precomputed_states)
        else:
            states = symbol_states(samples, thresholds, sentinel)
        first_sample = float(samples[0])
    cur_state0 = _initial_state(first_sample, thresholds, sentinel, modulation_order)

    r_states, r_starts, r_lens = _run_length_encode(states)
    return pulse_lens_from_runs(r_states, r_starts, r_lens, n, cur_state0,
                                tolerance, is_ask, samples_per_symbol)


def pulse_lens_from_runs(r_states: np.ndarray, r_starts: np.ndarray,
                         r_lens: np.ndarray, n: int, cur_state0: int,
                         tolerance: int, is_ask: bool,
                         samples_per_symbol: int) -> np.ndarray:
    """Run-level core of the pulse machine: consume a run-length-encoded
    state sequence instead of per-sample states (host NumPy, a verbatim
    copy of urh_tpu.dsp.symbols.pulse_lens_from_runs)."""
    # Long runs are the only ones that can commit a state change.
    long_mask = r_lens > tolerance
    l_states = r_states[long_mask]
    l_starts = r_starts[long_mask]

    # Deduplicate consecutive long-run states; drop leading group equal to the
    # initial machine state (those runs never differ from cur_state).
    if len(l_states):
        keep = np.ones(len(l_states), dtype=bool)
        keep[1:] = l_states[1:] != l_states[:-1]
        l_states = l_states[keep]
        l_starts = l_starts[keep]
        if l_states[0] == cur_state0:
            l_states = l_states[1:]
            l_starts = l_starts[1:]

    commit_pos = l_starts + tolerance  # sample index at which each commit fires

    k = len(commit_pos)
    rec_states = np.empty(k + 1, dtype=np.int64)
    rec_lens = np.empty(k + 1, dtype=np.int64)
    if k == 0:
        rec_states[0] = cur_state0
        rec_lens[0] = n - tolerance
    else:
        # record emitted at commit j carries the *previous* machine state
        rec_states[0] = cur_state0
        rec_states[1:k] = l_states[: k - 1]
        rec_states[k] = l_states[k - 1]
        rec_lens[0] = commit_pos[0] + 1 - tolerance
        rec_lens[1:k] = np.diff(commit_pos)
        rec_lens[k] = n - 1 - commit_pos[k - 1]

        if is_ask:
            # Aggregate short pauses for ASK (signal_functions.pyx:471-473):
            # applies to in-loop commits only (records 0..k-1).
            short_pause = (
                (rec_states[:k] == PAUSE_STATE)
                & (rec_lens[:k] < samples_per_symbol)
            )
            rec_states[:k][short_pause] = 0

    # Merge adjacent records with equal state (the in-loop merge rule).
    m_states, m_starts, m_lens_count = _run_length_encode(rec_states)
    merged_lens = np.add.reduceat(rec_lens, m_starts)

    return np.column_stack((m_states, merged_lens)).astype(np.int64)


def find_nearest_center(sample: float, centers: np.ndarray) -> int:
    """Index of the closest center (signal_functions.pyx:497-511)."""
    diffs = (np.asarray(centers) - sample) ** 2
    return int(np.argmin(diffs))
