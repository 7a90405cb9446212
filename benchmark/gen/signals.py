"""The benchmark's one signal generator: a receiver configuration's frames,
placed on a seeded schedule and rendered as the SDR would deliver them.

NumPy and the standard library only, so the live cell's sender process
imports no torch.  Everything a configuration file states drives it: the
frame's chip strings and payload coding, the sample rate, the modulation
(continuous-phase 2-FSK, or on/off keying of a tone with linear edges), the
amplitude, the noise and the sample format.  Every seed gets the same set of
frame sizes and the same set of silences, in another order, so that the work
of a run does not depend on its seed.

A stream position ``s`` belongs to period ``s // period_samples``; each
period holds ``frames_per_period`` frames laid out by :func:`schedule` from
the seed and the period's index, and its noise is drawn in blocks of
``NOISE_BLOCK`` samples, each from its own seeded generator.  So any range
of the stream renders on its own (:func:`render`), the same in the sender
and in the reference.
"""

from __future__ import annotations

import numpy as np

NOISE_BLOCK = 1 << 16


def seed_words(seed) -> list:
    """A seed (a whole number, or a list of them) as non-negative words."""
    return [int(w) % (1 << 64) for w in np.atleast_1d(np.asarray(seed, dtype=object))]


def samples_per_chip(cfg: dict) -> int:
    if "samples_per_chip" in cfg:
        return int(cfg["samples_per_chip"])
    return int(round(cfg["sample_rate"] / cfg["chip_rate"]))


def payload_sizes(cfg: dict, k: int) -> list:
    """k payload sizes spread evenly over the configuration's range (bytes
    for 3-of-6 coding; the fixed bit count for pulse-width coding)."""
    payload = cfg["frame"]["payload"]
    if payload["coding"] == "pwm":
        return [int(payload["bits"])] * k
    lo, hi = int(payload["bytes_min"]), int(payload["bytes_max"])
    return [lo + int((hi - lo + 1) * (i + 0.5) / k) for i in range(k)]


def code_word_chips(cfg: dict, size: int, rng: np.random.Generator) -> str:
    """One code word: preamble, sync, a random payload of ``size``, postamble."""
    frame = cfg["frame"]
    payload = frame["payload"]
    if payload["coding"] == "3of6":
        nibbles = rng.integers(0, 16, 2 * size)
        body = "".join(cfg["code_3of6"][n] for n in nibbles)
    elif payload["coding"] == "pwm":
        bits = rng.integers(0, 2, size)
        body = "".join(payload["one"] if b else payload["zero"] for b in bits)
    else:
        raise ValueError(f"unknown payload coding {payload['coding']!r}")
    return frame["preamble"] + frame["sync"] + body + frame["postamble"]


def frame_chips(cfg: dict, size: int, rng: np.random.Generator) -> str:
    """A frame: the code word repeated as the configuration says."""
    frame = cfg["frame"]
    word = code_word_chips(cfg, size, rng)
    gap = "0" * int(frame["repeat_gap_chips"])
    return (word + gap) * (int(frame["repeats"]) - 1) + word


def frame_samples(cfg: dict, size: int) -> int:
    frame = cfg["frame"]
    payload = frame["payload"]
    per_unit = len(payload["one"]) if payload["coding"] == "pwm" else 12
    word = len(frame["preamble"]) + len(frame["sync"]) + size * per_unit + len(frame["postamble"])
    repeats = int(frame["repeats"])
    chips = word * repeats + int(frame["repeat_gap_chips"]) * (repeats - 1)
    return chips * samples_per_chip(cfg)


def frames_in(cfg: dict, n_samples: int) -> int:
    """Frames a stretch of n_samples holds at the configuration's arrival rate."""
    return max(1, int(n_samples / cfg["sample_rate"] * cfg["arrivals_per_s"]))


def schedule(cfg: dict, n_samples: int, seed, payload_seed=None) -> list:
    """[(start, size, chips)] of the frames in a stretch of n_samples: the
    fixed sizes and the silences (quantiles of an exponential, at least
    ``min_gap_s`` each, summing to the stretch's idle time) in the seed's
    order, with payloads from ``payload_seed`` (default: the same seed)."""
    rng = np.random.default_rng(seed)
    k = frames_in(cfg, n_samples)
    sizes = rng.permutation(payload_sizes(cfg, k))
    lengths = np.array([frame_samples(cfg, s) for s in sizes], dtype=np.int64)
    min_gap = int(cfg["min_gap_s"] * cfg["sample_rate"])
    idle = n_samples - int(lengths.sum()) - (k + 1) * min_gap
    if idle < 0:
        raise ValueError(f"{k} frames do not fit {n_samples} samples")
    q = -np.log(1.0 - (np.arange(k + 1) + 0.5) / (k + 1))
    gaps = min_gap + np.floor(rng.permutation(q) / q.sum() * idle).astype(np.int64)
    starts = gaps[:k] + np.concatenate(([0], np.cumsum(lengths + gaps[:k])[:-1]))
    bits = rng if payload_seed is None else np.random.default_rng(payload_seed)
    return [(int(a), int(s), frame_chips(cfg, int(s), bits)) for a, s in zip(starts, sizes)]


def waveform(cfg: dict, chips: str) -> np.ndarray:
    """(n, 2) float32 of a frame without noise."""
    spc = samples_per_chip(cfg)
    on = np.repeat(np.frombuffer(chips.encode(), np.uint8) - ord("0"), spc)
    rate, amp = float(cfg["sample_rate"]), float(cfg["amplitude"])
    n = np.arange(len(on))
    if cfg["modulation"] == "FSK":
        step = (2 * np.pi / rate) * (cfg["carrier_offset_hz"]
                                     + np.where(on == 1, 1.0, -1.0) * cfg["deviation_hz"])
        phase = np.cumsum(step) - step[0]
        env = np.full(len(on), amp)
    elif cfg["modulation"] == "OOK":
        phase = (2 * np.pi * cfg["carrier_offset_hz"] / rate) * n
        edge = int(cfg["edge_samples"])
        env = on.astype(np.float64)
        if edge > 1:
            env = np.convolve(np.concatenate((env, np.zeros(edge - 1))),
                              np.full(edge, 1.0 / edge))[:len(on) + edge - 1]
            phase = (2 * np.pi * cfg["carrier_offset_hz"] / rate) * np.arange(len(env))
        env = amp * env
    else:
        raise ValueError(f"unknown modulation {cfg['modulation']!r}")
    out = np.empty((len(env), 2), dtype=np.float32)
    out[:, 0] = env * np.cos(phase)
    out[:, 1] = env * np.sin(phase)
    return out


def noise(cfg: dict, seed, block: int) -> np.ndarray:
    """(NOISE_BLOCK, 2) float32 noise of one block of a stream."""
    rng = np.random.default_rng([*seed_words(seed), 0, block])
    return rng.standard_normal((NOISE_BLOCK, 2), dtype=np.float32) * np.float32(
        cfg["noise_sigma"])


class Stream:
    """A seeded stream of periods, each ``period_samples`` long with its own
    schedule; ``render(a, n)`` gives any stretch as float32 IQ in full-scale
    units, before quantization."""

    def __init__(self, cfg: dict, seed, period_samples: int, layout=None):
        self.cfg, self.seed, self.period = cfg, seed, int(period_samples)
        self.layout = layout
        self._frames = {}
        self._noise = (None, None)  # the last noise block drawn

    def frames(self, p: int) -> list:
        """[(absolute start, size, chips, waveform)] of period p (cached)."""
        if p not in self._frames:
            base = p * self.period
            self._frames[p] = [
                (base + a, s, chips, waveform(self.cfg, chips))
                for a, s, chips in schedule(self.cfg, self.period, *self._seeds(p))]
        return self._frames[p]

    def _seeds(self, p: int) -> tuple:
        """(the layout's seed, the payloads' seed) of period p."""
        own = [*seed_words(self.seed), 1, p]
        if self.layout is None:
            return own, None
        return [*seed_words(self.layout), 3, p], own

    def forget(self, before: int):
        """Drop the cached waveforms of periods wholly before position ``before``."""
        for p in [p for p in self._frames if (p + 1) * self.period <= before]:
            del self._frames[p]

    def render(self, a: int, n: int) -> np.ndarray:
        out = np.empty((n, 2), dtype=np.float32)
        b = a + n
        for blk in range(a // NOISE_BLOCK, (b - 1) // NOISE_BLOCK + 1):
            lo, hi = max(a, blk * NOISE_BLOCK), min(b, (blk + 1) * NOISE_BLOCK)
            if self._noise[0] != blk:
                self._noise = (blk, noise(self.cfg, self.seed, blk))
            out[lo - a:hi - a] = self._noise[1][lo - blk * NOISE_BLOCK:hi - blk * NOISE_BLOCK]
        for p in range(a // self.period, (b - 1) // self.period + 1):
            for start, _, _, wave in self.frames(p):
                lo, hi = max(a, start), min(b, start + len(wave))
                if lo < hi:
                    out[lo - a:hi - a] += wave[lo - start:hi - start]
        return out


def quantize(cfg: dict, x: np.ndarray) -> np.ndarray:
    """The SDR's sample format: float32 as is, or the RTL2832U's unsigned
    bytes (127.5 + 127.5 x, rounded and clipped) turned into int8 by -128."""
    if cfg["sample_format"] == "float32":
        return x
    if cfg["sample_format"] == "int8":
        u8 = np.clip(np.rint(x * np.float32(127.5) + np.float32(127.5)), 0, 255)
        return (u8.astype(np.int16) - 128).astype(np.int8)
    raise ValueError(f"unknown sample format {cfg['sample_format']!r}")


def capture(cfg: dict, seed, n_samples: int, layout=None) -> tuple:
    """One capture of n_samples as the SDR delivers it, a single period ->
    (samples, [(start, size, chips)]).  ``layout``: where given, the seed of
    the frames' order and silences, the payloads and the noise coming from
    ``seed``."""
    stream = Stream(cfg, seed, n_samples, layout)
    x = quantize(cfg, stream.render(0, n_samples))
    return x, [(a, s, chips) for a, s, chips, _ in stream.frames(0)]
