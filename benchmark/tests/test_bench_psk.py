"""The PSK cell's parts: its comparison on the reference's own answers and
on answers with a planted fault, the int4 control, ``analyze``'s planted
faults in a small run of the cell, the chain yardstick and the
readers of the Costas loop's metrics on a trace made by hand."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import chain_yardstick, registry
from benchmark.chrome_trace import Trace
from benchmark.drivers import analyze_psk
from benchmark.gen import ieee802154
from benchmark.reference import precision, psk
from benchmark.tests.conftest import small
from benchmark.tests.helpers import rehearse
from benchmark.tests.test_bench_rehearsal import plant

CELL = "ieee802154_bpsk868_hackrf.analyze"
CFG = small("ieee802154_bpsk868_hackrf")
LIMITS = registry.limits(CELL)


@pytest.fixture(scope="module")
def capture():
    """One short exchange (the cell's CPU traffic) and the reference's analysis."""
    cpu = registry.traffic("analyze_psk")["cpu"]
    x, _ = ieee802154.capture(CFG, [2**31 + 23, 0], cpu["capture_samples"],
                              cpu["data_psdu_octets"], layout=0)
    return x, psk.analyze(x)


def as_program(ref):
    """The reference's analysis in the form the cell keeps the program's."""
    params, res = ref
    got = (True, params["modulation"], params["samples_per_symbol"], params["center"],
           params["tolerance"], params["noise"])
    return got, [m[:2] + (m[4],) for m in res["messages"]], res["rect"].copy()


def numbers(check):
    return {k: v for k, (v, _) in check["numbers"].items()}


def test_the_reference_against_itself_reads_0(capture):
    x, ref = capture
    got, msgs, qad = as_program(ref)
    assert ref[0]["samples_per_symbol"] == 40 and len(msgs) == 2
    check = analyze_psk.compare([(0, got, msgs)], {0: qad}, {0: ref}, [x], LIMITS)
    assert check["correct"] and set(numbers(check).values()) == {0}


def test_a_flipped_state_a_dropped_message_and_int4_are_not_correct(capture):
    x, ref = capture
    got, msgs, qad = as_program(ref)
    far = int(np.flatnonzero(qad > 0.5)[100])
    flipped = qad.copy()
    flipped[far] = -qad[far]
    check = analyze_psk.compare([(0, got, msgs)], {0: flipped}, {0: ref}, [x], LIMITS)
    assert not check["correct"]
    assert numbers(check)["state_mismatch"] == 1 and numbers(check)["qad_err"] > 1
    check = analyze_psk.compare([(0, got, msgs[:-1])], {0: qad}, {0: ref}, [x], LIMITS)
    assert not check["correct"] and numbers(check)["msg_mismatch"] == 1
    low = psk.analyze(precision.int4(x))
    got, msgs, qad = as_program(low)
    check = analyze_psk.compare([(0, got, msgs)], {0: qad}, {0: ref}, [x], LIMITS)
    assert not check["correct"] and numbers(check)["qad_err"] > LIMITS["qad_err"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out"])
def test_an_analysis_fault_planted_in_the_psk_cell_turns_correct_false(monkeypatch, fault):
    """The faults planted in ``analyze`` cells (an auto-detection that sets
    nothing, half the messages left out) in the PSK cell, whose traffic
    names ``analyze_psk``."""
    plant(monkeypatch, fault, "analyze")
    _, _, check = rehearse(CELL)
    assert not check["correct"], (fault, check)


def test_a_state_near_the_center_may_take_either_side(capture):
    """Within qad_err's limit of the center the program's state decides,
    and the reference's messages follow it."""
    x, ref = capture
    got, msgs, qad = as_program(ref)
    center = np.float32(ref[0]["center"])
    near = int(np.flatnonzero((qad > center) & (qad < center + 0.01))[0])
    moved = qad.copy()
    moved[near] = center - np.float32(0.001)
    check = analyze_psk.compare([(0, got, msgs)], {0: moved}, {0: ref}, [x], LIMITS)
    assert numbers(check)["state_mismatch"] == 0 and numbers(check)["qad_err"] < 0.02


def test_the_chain_yardstick():
    n = (1 << 24) - 1
    steps = 2 * 15_000_000  # two launches' ungated samples
    chain = steps * 120 / 1.98e9
    assert chain_yardstick.costas_least_seconds(steps, 2 * n) == pytest.approx(chain)
    assert chain == pytest.approx(1.8182, abs=1e-4)
    # with nothing to step the bytes bound: 12 bytes a sample at 3.35 TB/s
    assert chain_yardstick.costas_least_seconds(0, 2 * n) == pytest.approx(2 * n * 12 / 3.35e12)


def events(costas_spans=True):
    """Two analyses, each with one demod.costas span launching a 1.2 s
    kernel over 2^24 - 1 samples inside bench.estimate, and one in
    bench.demodulate."""
    x = lambda cat, name, ts, dur, **args: {"ph": "X", "cat": cat, "name": name, "ts": ts,
                                            "dur": dur, "args": args}
    out = [x("user_annotation", "bench.window", 0, 6e6)]
    for k, t in enumerate((1e5, 3e6)):
        out += [x("user_annotation", "bench.estimate", t, 1.5e6),
                x("user_annotation", "bench.demodulate", t + 1.5e6, 1.4e6)]
        for j, s in enumerate((t + 2e5, t + 1.6e6)):
            corr = 10 * k + j
            if costas_spans:
                out.append(x("user_annotation", "demod.costas", s, 50))
            out += [x("cuda_runtime", "cudaLaunchKernel", s + 10, 5, correlation=corr),
                    x("kernel", "urh_costas_f32", s + 100, 1.2e6, correlation=corr)]
    return out


def test_the_costas_readers_on_a_trace_and_without_the_span():
    ctx = type("Ctx", (), {})()
    ctx.counters = {"capture_samples": 1 << 24, "sample_itemsize": 1,
                    "costas_steps": 4 * 15_000_000}
    ctx.trace = Trace(events())
    assert registry.reader("costas_s.analyze_psk")(ctx) == pytest.approx(2.4)
    least = chain_yardstick.costas_least_seconds(4 * 15_000_000, 4 * ((1 << 24) - 1))
    assert registry.reader("costas_roofline.analyze_psk")(ctx) == pytest.approx(
        100 * least / 4.8)
    assert registry.reader("estimate_s.analyze_psk")(ctx) == pytest.approx(1.5)
    assert registry.reader("demod_s.analyze_psk")(ctx) == pytest.approx(1.4)
    ctx.trace = Trace(events(costas_spans=False))  # a program without the span
    assert registry.reader("costas_s.analyze_psk")(ctx) is None
    assert registry.reader("costas_roofline.analyze_psk")(ctx) is None
