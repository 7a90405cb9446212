"""Plain NumPy demodulation: IQ -> symbol states -> pulse runs -> messages.

The semantics URH gives a capture (urh/cythonext/signal_functions.pyx and
ProtocolAnalyzer.py), written out again for the benchmark: the quadrature
demodulation in float32 (ASK: |x| over the dtype's full scale; FSK: the
argument of x[n] conj(x[n-1])), the noise gate at |x|^2 <= noise^2, sample 0
a pause, the decision against the center, the run machine that commits a
state change at the (tolerance + 1)-th sample, ASK's short pauses read as
zeros, and the split into messages at pauses longer than the pause threshold.
"""

from __future__ import annotations

import math

import numpy as np

PAUSE = -1
FSK_SENTINEL = np.float32(-4.0)
ASK_SENTINEL = np.float32(0.0)


def full_scale(dtype) -> float:
    """The magnitude ASK values are divided by, by sample dtype."""
    dtype = np.dtype(dtype)
    if dtype == np.int8:
        return math.sqrt(127 * 127 + 128 * 128)
    if dtype == np.float32:
        return math.sqrt(2.0)
    raise ValueError(f"unsupported sample dtype {dtype}")


def sentinel(modulation: str) -> np.float32:
    return ASK_SENTINEL if modulation == "ASK" else FSK_SENTINEL


def rectangular(x: np.ndarray, noise: float, modulation: str, scale_dtype=None,
                rounding=None) -> np.ndarray:
    """(n, 2) samples (raw units, any dtype) -> float32 demodulated values,
    the gated samples at the sentinel; x[0] is a stream's first sample, which
    reads as a pause.  ``rounding``: a function applied to every float32
    intermediate (the controls' lower precision); None keeps float32."""
    rnd = rounding or (lambda v: v)
    f = rnd(np.asarray(x, dtype=np.float32))
    re, im = f[:, 0], f[:, 1]
    mag2 = rnd(rnd(re * re) + rnd(im * im))
    noise_sqrd = np.float32(noise * noise)
    if modulation == "ASK":
        scale = np.float32(full_scale(scale_dtype or x.dtype))
        val = rnd(rnd(np.sqrt(mag2)) / scale)
    elif modulation == "FSK":
        pr = np.concatenate((re[:1], re[:-1]))
        pi = np.concatenate((im[:1], im[:-1]))
        t_re = rnd(rnd(pr * re) + rnd(pi * im))
        t_im = rnd(rnd(pr * im) - rnd(pi * re))
        val = np.arctan2(t_im, t_re).astype(np.float32)
    else:
        raise ValueError(f"the reference demodulates ASK or FSK, not {modulation}")
    out = np.where(mag2 <= noise_sqrd, sentinel(modulation), val).astype(np.float32)
    if len(out):
        out[0] = sentinel(modulation)
    return out


def states(x: np.ndarray, noise: float, center: float, modulation: str, scale_dtype=None,
           rounding=None) -> np.ndarray:
    """int8 symbol states of a stream's samples.  Binary FSK at center 0
    decides by the sign of the discriminator's imaginary part, with no
    arctangent: atan2(y, x) > 0 exactly where y > 0, or y is +0 and x is
    negative (or -0)."""
    if modulation != "FSK" or center != 0.0:
        return states_of(rectangular(x, noise, modulation, scale_dtype, rounding=rounding),
                         center, modulation)
    rnd = rounding or (lambda v: v)
    f = rnd(np.asarray(x, dtype=np.float32))
    re, im = f[:, 0], f[:, 1]
    pr = np.concatenate((re[:1], re[:-1]))
    pi = np.concatenate((im[:1], im[:-1]))
    t_im = rnd(rnd(pr * im) - rnd(pi * re))
    t_re = rnd(rnd(pr * re) + rnd(pi * im))
    st = ((t_im > 0) | ((t_im == 0) & ~np.signbit(t_im) & np.signbit(t_re))).astype(np.int8)
    st[rnd(rnd(re * re) + rnd(im * im)) <= np.float32(noise * noise)] = PAUSE
    if len(st):
        st[0] = PAUSE
    return st


def states_of(rect: np.ndarray, center: float, modulation: str) -> np.ndarray:
    """int8 symbol states of binary modulation: 1 above the center, 0 at or
    below, -1 for gated samples."""
    st = (rect > np.float32(center)).astype(np.int8)
    st[rect == sentinel(modulation)] = PAUSE
    return st


def runs(states: np.ndarray) -> tuple:
    """-> (run states, run starts, run lengths), int64."""
    n = len(states)
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    change = np.flatnonzero(states[1:] != states[:-1]) + 1
    starts = np.concatenate(([0], change)).astype(np.int64)
    ends = np.concatenate((change, [n])).astype(np.int64)
    return states[starts].astype(np.int64), starts, ends - starts


def initial_state(first_is_pause: bool, center: float) -> int:
    """URH's machine starts in pause after a gated first sample; otherwise in
    the state of the value 0.0 (its uninitialized loop variable)."""
    if first_is_pause:
        return PAUSE
    return 0 if 0.0 <= np.float32(center) else 1


def pulses(r_states, r_starts, r_lens, n: int, cur0: int, tolerance: int, is_ask: bool,
           samples_per_symbol: int) -> np.ndarray:
    """The run machine over runs -> (m, 2) int64 rows of (state, length)."""
    long_ = r_lens > tolerance
    l_states, l_starts = r_states[long_], r_starts[long_]
    if len(l_states):
        keep = np.ones(len(l_states), bool)
        keep[1:] = l_states[1:] != l_states[:-1]
        l_states, l_starts = l_states[keep], l_starts[keep]
        if l_states[0] == cur0:
            l_states, l_starts = l_states[1:], l_starts[1:]
    commit = l_starts + tolerance
    k = len(commit)
    rec_s = np.empty(k + 1, np.int64)
    rec_l = np.empty(k + 1, np.int64)
    rec_s[0] = cur0
    if k == 0:
        rec_l[0] = n - tolerance
    else:
        rec_s[1:k + 1] = l_states
        rec_l[0] = commit[0] + 1 - tolerance
        rec_l[1:k] = np.diff(commit)
        rec_l[k] = n - 1 - commit[k - 1]
        if is_ask:
            short = (rec_s[:k] == PAUSE) & (rec_l[:k] < samples_per_symbol)
            rec_s[:k][short] = 0
    change = np.flatnonzero(rec_s[1:] != rec_s[:-1]) + 1
    starts = np.concatenate(([0], change))
    return np.column_stack((rec_s[starts], np.add.reduceat(rec_l, starts))).astype(np.int64)


def pulses_of_states(states: np.ndarray, tolerance: int, is_ask: bool,
                     samples_per_symbol: int, center: float) -> np.ndarray:
    r_s, r_a, r_l = runs(states)
    cur0 = initial_state(len(states) == 0 or states[0] == PAUSE, center)
    return pulses(r_s, r_a, r_l, len(states), cur0, tolerance, is_ask, samples_per_symbol)


def messages_of_pulses(pp: np.ndarray, samples_per_symbol: int, pause_threshold: int = 8):
    """Pulse rows -> [(bits as a '0'/'1' string, pause, start sample, end
    sample, bit positions)]: a run lasts round-half-down(length /
    samples_per_symbol) symbols; pauses longer than pause_threshold symbols
    end a message, shorter ones read as zeros; a leading pause emits nothing;
    a message with no data symbol is dropped.  The end sample is where the
    message's last symbol ends (the closing pause's start, or the end of the
    pulses); the positions are each bit's first sample, then the closing
    pause's start and end (or the end of the pulses)."""
    out = []
    if len(pp) == 0:
        return out
    kind, length = pp[:, 0], pp[:, 1]
    ratio = length / samples_per_symbol
    n_sym = ratio.astype(np.int64)
    n_sym += (ratio - n_sym) > 0.5
    is_pause = kind == PAUSE
    split = is_pause & (n_sym > pause_threshold) & (pause_threshold != 0)
    start = np.cumsum(length) - length
    total = int(length.sum())
    lo = 1 if is_pause[0] else 0
    for hi in list(np.flatnonzero(split)) + [len(pp)]:
        if hi <= lo:
            lo = hi + 1
            continue
        sl = slice(lo, hi)
        lo = hi + 1
        if not np.any(~is_pause[sl] & (n_sym[sl] > 0)):
            continue
        sym = np.repeat(np.where(is_pause[sl], 0, kind[sl]), n_sym[sl])
        bits = "".join("1" if v else "0" for v in sym.tolist())
        counts = n_sym[sl]
        intra = np.arange(int(counts.sum())) - np.repeat(np.cumsum(counts) - counts, counts)
        pos = (np.repeat(start[sl], counts) + intra * samples_per_symbol).tolist()
        first = int(start[sl][0])
        if hi < len(pp):
            pause, end = int(length[hi]), int(start[hi])
            pos += [end, end + pause]
        else:
            pause, end = (int(length[-1]) if is_pause[-1] else 0), total
            pos.append(total)
        out.append((bits, pause, first, end, tuple(pos)))
    return out


def demodulate(x: np.ndarray, params: dict, rounding=None, rect=None) -> dict:
    """A whole capture at the given parameters (modulation, noise, center,
    samples_per_symbol, tolerance, pause_threshold) -> {"states", "rect",
    "messages"}; ``rect``, when given, is the capture already demodulated
    at that noise."""
    mod = params["modulation"]
    if rect is None:
        rect = rectangular(x, params["noise"], mod, rounding=rounding)
    st = states_of(rect, params["center"], mod)
    pp = pulses_of_states(st, int(params["tolerance"]), mod == "ASK",
                          int(params["samples_per_symbol"]), params["center"])
    msgs = messages_of_pulses(pp, int(params["samples_per_symbol"]),
                              int(params.get("pause_threshold", 8)))
    return {"states": st, "rect": rect, "messages": msgs}
