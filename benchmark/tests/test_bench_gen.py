"""The traffic generator: determinism by seed and the shapes it declares."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.gen import signals
from benchmark.tests.conftest import small

WMBUS, OOK = small("wmbus_t1_hackrf"), small("ook_ev1527_rtlsdr")


@pytest.mark.parametrize("cfg", [WMBUS, OOK], ids=["wmbus", "ook"])
def test_same_seed_same_capture_other_seed_other_capture(cfg):
    a, fa = signals.capture(cfg, [2**31 + 5, 0], 1 << 20)
    b, fb = signals.capture(cfg, [2**31 + 5, 0], 1 << 20)
    c, fc = signals.capture(cfg, [2**31 + 6, 0], 1 << 20)
    assert np.array_equal(a, b) and fa == fb
    assert not np.array_equal(a, c)
    assert a.dtype == np.dtype(cfg["sample_format"])


def test_wmbus_frames_count_their_chips_and_keep_the_3_of_6_balance():
    rng = np.random.default_rng(1)
    for size in (20, 73, 120):
        chips = signals.frame_chips(WMBUS, size, rng)
        assert len(chips) == 38 + 10 + 12 * size + 2
        assert chips.startswith("01" * 19 + "0000111101") and chips.endswith("01")
        body = chips[48:-2]
        words = [body[i:i + 6] for i in range(0, len(body), 6)]
        assert all(w in WMBUS["code_3of6"] for w in words)
        assert all(w.count("1") == 3 for w in words)
    assert len(set(WMBUS["code_3of6"])) == 16
    assert signals.samples_per_chip(WMBUS) == 100
    assert signals.samples_per_chip(small("wmbus_t1_hackrf_5msps")) == 50


def test_ev1527_frames_are_eight_code_words_of_sync_and_24_cells():
    chips = signals.frame_chips(OOK, 24, np.random.default_rng(2))
    words = [chips[i:i + 128] for i in range(0, len(chips), 128)]
    assert len(chips) == 8 * 128 and len(set(words)) == 1
    word = words[0]
    assert word[:32] == "1" + "0" * 31
    assert all(word[32 + 4 * i:36 + 4 * i] in ("1000", "1110") for i in range(24))
    assert signals.samples_per_chip(OOK) == 700
    assert signals.frame_samples(OOK, 24) == 8 * 128 * 700


@pytest.mark.parametrize("cfg,n", [(WMBUS, 1 << 24), (OOK, 1 << 24)], ids=["wmbus", "ook"])
def test_every_seed_gets_the_same_sizes_and_silences_in_another_order(cfg, n):
    plans = [signals.schedule(cfg, n, [s, 1, 0]) for s in (1, 2, 2**31 + 3)]
    k = signals.frames_in(cfg, n)
    assert k == int(n / cfg["sample_rate"] * cfg["arrivals_per_s"])
    assert all(len(p) == k for p in plans)
    assert len({tuple(sorted(s for _, s, _ in p)) for p in plans}) == 1
    assert len({tuple(s for _, s, _ in p) for p in plans}) > 1 or k == 1 or cfg is OOK
    min_gap = cfg["min_gap_s"] * cfg["sample_rate"]
    for p in plans:
        ends = [a + signals.frame_samples(cfg, s) for a, s, _ in p]
        starts = [a for a, _, _ in p]
        assert starts[0] >= min_gap and ends[-1] <= n - min_gap
        assert all(b - a >= min_gap for a, b in zip(ends[:-1], starts[1:]))


def test_a_stream_renders_any_stretch_as_the_whole_does():
    s = signals.Stream(WMBUS, 9, 500_000)
    whole = s.render(0, 1_200_000)
    pieces = np.concatenate([signals.Stream(WMBUS, 9, 500_000).render(a, 7_777)
                             for a in range(0, 1_200_000, 7_777)])[:1_200_000]
    assert np.array_equal(whole, pieces)


def test_the_rtl_sdr_format_is_unsigned_bytes_less_128():
    x = np.array([[-1.0, 1.0], [0.0, 0.5], [-2.0, 2.0]], np.float32)
    q = signals.quantize(OOK, x)
    assert q.dtype == np.int8
    assert q.tolist() == [[-128, 127], [0, 63], [-128, 127]]


def test_ook_pulses_are_a_tone_with_ramped_edges():
    w = signals.waveform(OOK, "1")
    env = np.hypot(w[:, 0], w[:, 1])
    assert len(w) == 700 + OOK["edge_samples"] - 1
    assert env[0] < 0.1 and abs(env[100] - 0.75) < 1e-6
    phase = np.unwrap(np.arctan2(w[100:600, 1], w[100:600, 0]))
    assert abs(np.mean(np.diff(phase)) - 2 * np.pi * 1e5 / 2e6) < 1e-6
