"""IEEE 802.15.4's 868 MHz BPSK PHY (2006, clause 6.6) as a HackRF records
it: a bulk transfer between two nodes, data frames each answered by an ACK.

A PPDU (preamble, SFD, length, PSDU; octets least significant bit first)
is differentially encoded (E_n = R_n xor E_(n-1), E_0 = 0), each encoded
bit spread to the configuration's 15-chip sequence (its inverse for a 1),
and the chips sent as BPSK with raised-cosine pulses (roll-off 1) at the
configuration's samples a chip, on the frame kind's tuner offset, amplitude
and a carrier phase drawn from the seed.  The capture opens with a quiet
lead of two whole 1% rows (URH's noise floor reads the quietest 1% rows),
then the exchanges follow: data frame, aTurnaroundTime, ACK, then CSMA-CA's
backoff of 0-7 unit periods, CCA and a turnaround before the next data
frame.  Every capture of one length holds the same frames and the same
backoffs; the order of the backoffs comes from ``layout``, the octets, the
phases and the noise from ``seed``.  The noise and the 8-bit quantizer are
:mod:`benchmark.gen.signals`'.
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from benchmark.gen import signals

ACK_OCTETS = 5  # frame control, sequence number, FCS


def quiet_lead(n: int) -> int:
    """Samples of silence ahead of an n-sample capture: two whole 1% rows
    of URH's noise floor (its rows start at n % (n // 100)), so that the
    first frame starts a row."""
    row = max(1, n // 100)
    return 2 * row + n % row


def octet_bits(octets) -> np.ndarray:
    """Octets -> their bits, least significant first, as uint8."""
    return np.unpackbits(np.asarray(octets, np.uint8), bitorder="little")


def ppdu_bits(cfg: dict, psdu) -> np.ndarray:
    """The PPDU's raw bits: preamble, SFD, the 7-bit frame length, the
    reserved bit (0), the PSDU."""
    p = cfg["ppdu"]
    psdu = np.asarray(psdu, np.uint8)
    if len(psdu) > int(p["psdu_octets_max"]):
        raise ValueError(f"a PSDU of {len(psdu)} octets is over {p['psdu_octets_max']}")
    length = (len(psdu) >> np.arange(int(p["length_bits"]))) & 1
    return np.concatenate((np.zeros(int(p["preamble_bits"]), np.uint8),
                           np.frombuffer(p["sfd"].encode(), np.uint8) - ord("0"),
                           length.astype(np.uint8), np.zeros(int(p["reserved_bits"]), np.uint8),
                           octet_bits(psdu)))


def differential(bits: np.ndarray) -> np.ndarray:
    """E_n = R_n xor E_(n-1), with E_0 = 0."""
    return np.bitwise_xor.accumulate(np.asarray(bits, np.uint8))


def chips_of(cfg: dict, bits: np.ndarray) -> np.ndarray:
    """Encoded bits -> their chips (uint8), 15 a bit."""
    table = np.array([np.frombuffer(cfg["spreading"][k].encode(), np.uint8) - ord("0")
                      for k in ("zero", "one")])
    return table[np.asarray(bits, np.intp)].ravel()


def raised_cosine(t: np.ndarray, rolloff: float) -> np.ndarray:
    """The raised-cosine impulse response at t chips."""
    t = np.asarray(t, np.float64)
    edge = np.isclose(np.abs(2 * rolloff * t), 1.0)
    safe = np.where(edge, 0.0, t)
    out = np.sinc(safe) * np.cos(np.pi * rolloff * safe) / (1 - (2 * rolloff * safe) ** 2)
    return np.where(edge, np.pi / 4 * np.sinc(1 / (2 * rolloff)), out)


def baseband(cfg: dict, chips: np.ndarray) -> np.ndarray:
    """Chips -> the real BPSK baseband (chip 1 at +1, 0 at -1), float64:
    chip k peaks in the middle of samples [(k + T) S, (k + T + 1) S), S the
    samples a chip and T the pulse's tail in chips, so the waveform is
    (K + 2T) S samples long.  Computed phase by phase of a chip: each output
    chip slot sums the 2T + 1 chips whose pulses reach it."""
    s, tail = int(cfg["samples_per_chip"]), int(cfg["pulse"]["tail_chips"])
    d = np.arange(-tail, tail + 1)[:, None]
    r = np.arange(s)[None, :]
    # taps[T + d, r]: the pulse of a chip d slots earlier at phase r of a slot
    taps = raised_cosine(d + (r - s / 2) / s, float(cfg["pulse"]["rolloff"]))
    a = np.where(np.asarray(chips) == 1, 1.0, -1.0)
    padded = np.concatenate((np.zeros(2 * tail), a, np.zeros(2 * tail)))
    windows = sliding_window_view(padded, 2 * tail + 1)[:len(a) + 2 * tail]
    return (windows[:, ::-1] @ taps).ravel()


def frame_waveform(cfg: dict, kind: str, psdu, phase: float) -> np.ndarray:
    """(n, 2) float32 of one frame, without noise."""
    f = cfg["frames"][kind]
    env = float(f["amplitude"]) * baseband(cfg, chips_of(cfg, differential(ppdu_bits(cfg, psdu))))
    n = np.arange(len(env))
    arg = 2 * np.pi * float(f["carrier_offset_hz"]) / float(cfg["sample_rate"]) * n + phase
    out = np.empty((len(env), 2), np.float32)
    out[:, 0] = env * np.cos(arg)
    out[:, 1] = env * np.sin(arg)
    return out


def frame_samples(cfg: dict, octets: int) -> int:
    bits = (int(cfg["ppdu"]["preamble_bits"]) + len(cfg["ppdu"]["sfd"])
            + int(cfg["ppdu"]["length_bits"]) + int(cfg["ppdu"]["reserved_bits"]) + 8 * octets)
    chips = bits * len(cfg["spreading"]["zero"]) + 2 * int(cfg["pulse"]["tail_chips"])
    return chips * int(cfg["samples_per_chip"])


def symbol_samples(cfg: dict) -> int:
    return int(round(cfg["sample_rate"] / cfg["bit_rate"]))


def schedule(cfg: dict, n: int, data_octets: int, layout) -> list:
    """[(start, kind)] of the frames of an n-sample capture: after the
    quiet lead as many exchanges (data, turnaround, ACK) as fit, the gap
    before each next data frame a backoff of 0-7 unit periods (their
    multiset fixed by the count, their order from ``layout``), CCA and a
    turnaround."""
    t = cfg["timing_symbols"]
    sym = symbol_samples(cfg)
    data, ack = frame_samples(cfg, data_octets), frame_samples(cfg, ACK_OCTETS)
    exchange = data + int(t["turnaround"]) * sym + ack
    levels = 1 << int(t["mac_min_be"])

    def gaps(k):
        b = np.arange(max(k - 1, 0)) % levels
        return (b * int(t["unit_backoff"]) + int(t["cca"]) + int(t["turnaround"])) * sym

    lead = quiet_lead(n)
    k = 0
    while lead + (k + 1) * exchange + int(gaps(k + 1).sum()) <= n:
        k += 1
    if k == 0:
        raise ValueError(f"no exchange fits {n} samples")
    order = np.random.default_rng(signals.seed_words(layout) + [3]).permutation(gaps(k))
    out, at = [], lead
    for i in range(k):
        out += [(at, "data"), (at + data + int(t["turnaround"]) * sym, "ack")]
        at += exchange + (int(order[i]) if i < k - 1 else 0)
    return out


def capture(cfg: dict, seed, n: int, data_octets: int, layout=None) -> tuple:
    """One n-sample capture as the HackRF delivers it -> (samples, [(start,
    kind, PSDU octets)]).  ``layout`` (default: the seed) orders the
    backoffs."""
    frames = schedule(cfg, n, data_octets, seed if layout is None else layout)
    rng = np.random.default_rng(signals.seed_words(seed) + [1])
    blocks = range((n + signals.NOISE_BLOCK - 1) // signals.NOISE_BLOCK)
    x = np.concatenate([signals.noise(cfg, seed, b) for b in blocks])[:n]
    out = []
    for start, kind in frames:
        psdu = rng.integers(0, 256, data_octets if kind == "data" else ACK_OCTETS, np.uint8)
        wave = frame_waveform(cfg, kind, psdu, float(rng.uniform(0, 2 * np.pi)))
        x[start:start + len(wave)] += wave
        out.append((start, kind, bytes(psdu)))
    return signals.quantize(cfg, x), out
