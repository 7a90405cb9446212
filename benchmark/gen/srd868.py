"""The 868 MHz SRD band as one HackRF records it: Wireless M-Bus T1
telegrams and an IEEE 802.15.4 868 MHz bulk transfer side by side, each
system rendered by its own generator (:mod:`benchmark.gen.signals`,
:mod:`benchmark.gen.ieee802154`) at its offset from the tuning.

The capture opens with the quiet lead of two whole 1% rows, in which
neither system sends (URH's noise floor reads the quietest 1% rows).  The
telegrams follow on :func:`signals.schedule`'s layout of the rest of the
capture, the 802.15.4 exchanges on :func:`ieee802154.schedule`'s,
independently, so that frames of the two overlap in time.  Each frame is
rendered at its system's ``offset_hz`` from the tuning (added to the
frame's own tuner offset; its carrier phase is the generator's), the frames
are summed over the noise, and the 8-bit quantizer applied
(:func:`signals.quantize`).  Every capture of one length holds the same
telegram sizes, silences and backoffs; their order comes from ``layout``,
the payloads, octets, carrier phases and noise from ``seed``.
"""

from __future__ import annotations

import numpy as np

from benchmark.gen import ieee802154, signals

# tags that keep the two systems' seeded draws apart
WMBUS_TAG, IEEE802154_TAG = 21, 22


def system(cfg: dict, name: str) -> dict:
    """One system's configuration as its own generator reads it, its
    carrier offsets moved by the system's ``offset_hz`` from the tuning."""
    own = dict(cfg["systems"][name], sample_rate=cfg["sample_rate"],
               sample_format=cfg["sample_format"], noise_sigma=cfg["noise_sigma"])
    shift = float(own["offset_hz"])
    if "frames" in own:
        own["frames"] = {k: dict(f, carrier_offset_hz=f["carrier_offset_hz"] + shift)
                         for k, f in own["frames"].items()}
    else:
        own["carrier_offset_hz"] = own["carrier_offset_hz"] + shift
    return own


def render(cfg: dict, seed, n: int, data_octets: int, layout=None) -> tuple:
    """One n-sample capture before the quantizer -> (float32 (n, 2),
    {"wmbus_t1": [(start, size, chips)], "ieee802154": [(start, kind, PSDU
    octets)]}).  ``layout`` (default: the seed) orders the telegrams'
    silences and the backoffs."""
    layout = signals.seed_words(seed if layout is None else layout)
    words = signals.seed_words(seed)
    wm, zb = system(cfg, "wmbus_t1"), system(cfg, "ieee802154")
    blocks = range((n + signals.NOISE_BLOCK - 1) // signals.NOISE_BLOCK)
    x = np.concatenate([signals.noise(cfg, seed, b) for b in blocks])[:n]
    lead = ieee802154.quiet_lead(n)
    telegrams = [(lead + a, size, chips) for a, size, chips in signals.schedule(
        wm, n - lead, [*layout, WMBUS_TAG], [*words, WMBUS_TAG])]
    for start, _, chips in telegrams:
        wave = signals.waveform(wm, chips)
        x[start:start + len(wave)] += wave
    rng = np.random.default_rng([*words, IEEE802154_TAG])
    frames = []
    for start, kind in ieee802154.schedule(zb, n, data_octets, [*layout, IEEE802154_TAG]):
        psdu = rng.integers(0, 256, data_octets if kind == "data" else ieee802154.ACK_OCTETS,
                            np.uint8)
        wave = ieee802154.frame_waveform(zb, kind, psdu, float(rng.uniform(0, 2 * np.pi)))
        x[start:start + len(wave)] += wave
        frames.append((start, kind, bytes(psdu)))
    return x, {"wmbus_t1": telegrams, "ieee802154": frames}


def capture(cfg: dict, seed, n: int, data_octets: int, layout=None) -> tuple:
    """One n-sample capture as the HackRF delivers it -> (int8 (n, 2), the
    frames of :func:`render`)."""
    x, frames = render(cfg, seed, n, data_octets, layout)
    return signals.quantize(cfg, x), frames
