"""Plain NumPy streaming semantics: a sample stream fed in chunks -> the
closed segments and their messages, as URH's sniffer gives them.

The states of the whole stream come from :func:`demod.rectangular` at once
(the FSK discriminator carries its previous sample across chunk bounds, and
only the stream's first sample is a pause).  Chunk by chunk, the runs join
the carried ones; every pause run of ``10 * samples_per_symbol`` samples or
more closes a segment (a still-growing trailing pause too), spans with no
run longer than the tolerance are dropped, and each segment runs through
the pulse machine on its own.  A segment's rows and its place in the stream
therefore depend on where the chunks were cut, and the reference takes the
cuts as they were made.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import demod

PAUSE_GATE_SYMBOLS = 10


def segments(states: np.ndarray, chunk_lengths, params: dict) -> list:
    """[(start sample, samples, (m, 2) pulse rows)] of a stream of states fed
    in chunks of the given lengths (summing to at most len(states)), then
    flushed."""
    sps, tol = int(params["samples_per_symbol"]), int(params["tolerance"])
    gate = PAUSE_GATE_SYMBOLS * sps
    is_ask = params["modulation"] == "ASK"
    c_states = np.zeros(0, np.int64)
    c_lens = np.zeros(0, np.int64)
    start_abs = 0
    out = []

    def close(done: bool):
        nonlocal c_states, c_lens, start_abs
        if len(c_states) == 0:
            return
        ends = np.flatnonzero((c_states == demod.PAUSE) & (c_lens >= gate)) + 1
        if done and (len(ends) == 0 or ends[-1] != len(c_states)):
            ends = np.append(ends, len(c_states))
        if len(ends) == 0:
            return
        begins = np.concatenate(([0], ends[:-1]))
        signal = (c_states != demod.PAUSE) & (c_lens > tol)
        for a, b in zip(begins.tolist(), ends.tolist()):
            n = int(c_lens[a:b].sum())
            if signal[a:b].any():
                r_s, r_l = c_states[a:b], c_lens[a:b]
                r_a = np.concatenate(([0], np.cumsum(r_l[:-1])))
                cur0 = demod.initial_state(r_s[0] == demod.PAUSE, params["center"])
                out.append((start_abs, n, demod.pulses(r_s, r_a, r_l, n, cur0, tol, is_ask, sps)))
            start_abs += n
        c_states, c_lens = c_states[ends[-1]:], c_lens[ends[-1]:]

    pos = 0
    for n in chunk_lengths:
        r_s, _, r_l = demod.runs(states[pos:pos + n])
        pos += n
        if len(r_s) == 0:
            continue
        if len(c_states) and c_states[-1] == r_s[0]:
            c_lens[-1] += r_l[0]
            r_s, r_l = r_s[1:], r_l[1:]
        c_states = np.concatenate((c_states, r_s))
        c_lens = np.concatenate((c_lens, r_l))
        close(False)
    close(True)
    return out


def messages(segs: list, params: dict) -> list:
    """[(bits, pause, first sample, end sample)] of the segments' messages in
    stream positions; pauses longer than 8 symbols end a message (the
    sniffer's default)."""
    out = []
    for start, _, rows in segs:
        for bits, pause, first, end, _ in demod.messages_of_pulses(
                rows, int(params["samples_per_symbol"]), 8):
            out.append((bits, pause, start + first, start + end))
    return out


def replay(x: np.ndarray, chunk_lengths, params: dict, rounding=None) -> tuple:
    """A recording fed in chunks at known parameters -> (segments, messages)."""
    noise = params["noise_threshold"]
    # the stream normalizes int8 by 1/128 and divides ASK magnitudes by
    # float32's full scale whatever the ingest
    xf = x.astype(np.float32) * np.float32(1.0 / 128.0) if x.dtype == np.int8 else x
    st = demod.states(xf, noise, params["center"], params["modulation"], np.float32, rounding)
    segs = segments(st, chunk_lengths, params)
    return segs, messages(segs, params)
