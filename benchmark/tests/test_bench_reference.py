"""The plain reference against known bits on small captures, the ring's
semantics against a sample-by-sample ring, and the controls' precisions."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.gen import signals
from benchmark.reference import demod, estimate, precision, ring
from benchmark.reference import stream as ref_stream
from benchmark.tests.conftest import small

WMBUS, OOK = small("wmbus_t1_hackrf"), small("ook_ev1527_rtlsdr")
WMBUS_5MSPS = small("wmbus_t1_hackrf_5msps")


def test_the_wmbus_estimate_and_messages_are_the_telegrams_sent():
    x, frames = signals.capture(WMBUS_5MSPS, [11, 0], 1 << 21)
    params, res = estimate.analyze(x)
    assert params["modulation"] == "FSK" and params["samples_per_symbol"] == 50
    assert abs(params["center"]) < 0.01
    assert [m[0] for m in res["messages"]] == [chips for _, _, chips in frames]


def test_a_message_whose_bin_width_moves_an_ulp_gives_the_estimate_a_candidate():
    """In this capture the card's float32 arctangent (and the CPU routes' of
    the port and of urh_tpu) gives one message a variance one ulp under
    NumPy's: the message's histogram edges move, its center is lost and its
    tolerance reads 7, and the capture's tolerance is 3 where NumPy's values
    give 2.  The reference lists what such a rounding can give."""
    x, _ = signals.capture(WMBUS_5MSPS, [2148500901, 2], 1 << 24, layout=2)
    params = estimate.estimate(x)
    assert params["tolerance"] == 2 and params["candidates"][0]["tolerance"] == 2
    moved = [c for c in params["candidates"] if c["tolerance"] == 3]
    assert len(moved) == 1
    lo, hi = moved[0]["center_band"]
    assert lo - 1e-9 <= -0.0033173549418279435 <= hi + 1e-9


def test_at_the_hackrfs_100_samples_a_chip_urhs_estimate_calls_the_telegrams_ook():
    x, _ = signals.capture(WMBUS, [11, 0], 1 << 21)
    params, _ = estimate.analyze(x)
    assert params["modulation"] == "ASK"


def test_the_ook_estimate_finds_700_and_each_code_word_comes_out_between_syncs():
    x, frames = signals.capture(OOK, [12, 0], 1 << 22)
    params, res = estimate.analyze(x)
    assert params["modulation"] == "ASK" and params["samples_per_symbol"] == 700
    bits = [m[0] for m in res["messages"]]
    for _, _, chips in frames:
        data = chips[32:128]
        # URH splits at the sync's 31 low periods: each message is a code
        # word's 96 data chips and the next sync's high (C2's kind of split)
        assert bits.count(data + "1") == 7
        assert any(b.startswith(data[:-1]) for b in bits)


def test_fsk_states_at_center_0_are_the_arctangent_s_sign():
    x, _ = signals.capture(WMBUS, [14, 0], 1 << 18)
    x[100:110] = 0.0  # zeros: the discriminator's signed-zero cases
    x[200:210, 1] = -0.0
    for rounding in (None, precision.bf16):
        want = demod.states_of(demod.rectangular(x, 0.02, "FSK", rounding=rounding), 0.0, "FSK")
        assert np.array_equal(demod.states(x, 0.02, 0.0, "FSK", rounding=rounding), want)


def test_the_stream_reference_is_the_offline_one_at_gate_pauses():
    x, frames = signals.capture(OOK, [13, 0], 1 << 21)
    p = OOK["known_params"]
    segs, msgs = ref_stream.replay(x, [1 << 17] * 16, p)
    one, msgs_one = ref_stream.replay(x, [len(x)], p)
    assert [m[0] for m in msgs] == [m[0] for m in msgs_one]
    assert all(seg[1] > 0 for seg in segs)


def test_the_run_machine_commits_after_the_tolerance_and_reads_short_ask_pauses_as_zeros():
    st = np.array([-1] * 5 + [1] * 30 + [0] * 2 + [1] * 30 + [-1] * 40 + [1] * 20, np.int8)
    pp = demod.pulses_of_states(st, tolerance=3, is_ask=True, samples_per_symbol=10, center=0.5)
    # the leading 5-sample pause is short (under 10): ASK reads it as a zero;
    # the 2-sample dip is a glitch (at most the tolerance); the state changes
    # commit 3 samples into each long run, so the last run is 3 short
    assert pp.tolist() == [[0, 6], [1, 62], [-1, 40], [1, 16]]
    msgs = demod.messages_of_pulses(pp, 10, pause_threshold=3)
    assert [m[:2] for m in msgs] == [("0111111", 40), ("11", 0)]
    assert msgs[0][4] == (0, 6, 16, 26, 36, 46, 56, 68, 108)


def brute_ring(lengths, size):
    ring_, wi, sent, fed, pos = np.full(size, -1), 0, 0, [], 0
    for n in lengths:
        if wi + n >= size:
            fed += list(ring_[pos:wi]) + list(ring_[wi:size])
            pos = wi = 0
        ring_[wi:wi + n] = np.arange(sent, sent + n)
        wi += n
        sent += n
    return fed + list(ring_[pos:wi])


def test_the_ring_feeds_what_a_sample_by_sample_ring_feeds():
    rng = np.random.default_rng(1)
    for _ in range(200):
        size = int(rng.integers(50, 200))
        lengths = rng.integers(1, 40, int(rng.integers(5, 60))).tolist()
        got = []
        for o, n in ring.fed_pieces(lengths, size):
            got += [-1] * n if o is None else list(range(o, o + n))
        assert got == brute_ring(lengths, size)


def test_the_live_reference_s_fed_states_are_those_of_the_fed_samples():
    from benchmark import registry
    from benchmark.drivers import live

    cell = live.Cell(WMBUS, registry.traffic("live"), 3, "cpu", 1.0)
    x, _ = signals.capture(WMBUS, [15, 0], 1 << 18)
    rng = np.random.default_rng(2)
    for rounding in (None, precision.bf16):
        lengths = rng.integers(1000, 5000, 60).tolist()  # under the capture
        x = x[:sum(lengths)]
        assert len(x) == sum(lengths)
        pieces = ring.fed_pieces(lengths, 60000)
        fed = np.concatenate([np.zeros((n, 2), x.dtype) if o is None else x[o:o + n]
                              for o, n in pieces])
        got = cell._fed_states(x, cell._states(x, rounding), pieces, rounding)
        assert np.array_equal(got, cell._states(fed, rounding))


def test_ring_wraps_and_sent_positions():
    pieces = ring.fed_pieces([4, 4, 4], 10)  # the third batch wraps
    assert ring.wraps([4, 4, 4], 10) == 1 and ring.final_index([4, 4, 4], 10) == 4
    assert pieces == [(0, 8), (None, 2), (8, 4)]
    assert [ring.sent_position(pieces, f) for f in (0, 7, 8, 9, 10, 13)] == [0, 7, 8, 8, 8, 11]


def test_bf16_rounds_as_torch_and_int4_keeps_the_int8_scale():
    x = np.random.default_rng(0).standard_normal(10000).astype(np.float32)
    assert np.array_equal(precision.bf16(x),
                          torch.from_numpy(x).to(torch.bfloat16).float().numpy())
    q = precision.int4(np.arange(-128, 128, dtype=np.int8))
    assert set(np.unique(q).tolist()) <= {16 * k for k in range(-8, 8)}
