"""The band cell's parts: the generator's frames at their offsets and
within the quantizer's range, the comparison on the reference's own answers
and on answers with a planted fault, the bfloat16 control, the analyze
faults in a small run of the cell, the filter's yardstick and the readers
of its metrics on a trace made by hand."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import bandpass_yardstick, registry
from benchmark.chrome_trace import Trace
from benchmark.drivers import channel as driver
from benchmark.gen import ieee802154, srd868
from benchmark.reference import channel
from benchmark.tests.conftest import small
from benchmark.tests.helpers import rehearse
from benchmark.tests.test_bench_rehearsal import plant

CELL = "srd868_band_hackrf.channel"
CFG = small("srd868_band_hackrf")
TRAFFIC = registry.traffic("channel")
N = TRAFFIC["cpu"]["capture_samples"]
BAND = (TRAFFIC["f_low"], TRAFFIC["f_high"], TRAFFIC["filter_bw"])
LIMITS = registry.limits(CELL)


def alone(name: str) -> dict:
    """The configuration with only ``name``'s frames and no noise."""
    systems = {k: dict(v) for k, v in CFG["systems"].items()}
    for k, v in systems.items():
        if k != name:
            v["amplitude"] = 0.0
            v["frames"] = {f: dict(a, amplitude=0.0) for f, a in v.get("frames", {}).items()}
    return dict(CFG, systems=systems, noise_sigma=0.0)


def centroid_hz(x: np.ndarray, rate: float) -> float:
    """The power-weighted mean frequency of (m, 2) samples."""
    c = x[:, 0].astype(np.float64) + 1j * x[:, 1]
    p = np.abs(np.fft.fft(c)) ** 2
    return float(np.sum(np.fft.fftfreq(len(c), 1 / rate) * p) / np.sum(p))


@pytest.mark.parametrize("name", ["wmbus_t1", "ieee802154"])
def test_each_systems_frames_sit_at_their_offsets(name):
    x, frames = srd868.render(alone(name), [2**31 + 5, 0], N, TRAFFIC["data_psdu_octets"],
                              layout=0)
    rate, own = CFG["sample_rate"], CFG["systems"][name]
    spans = ([(a, a + srd868.signals.frame_samples(srd868.system(CFG, name), s))
              for a, s, _ in frames[name]] if name == "wmbus_t1" else
             [(a, a + ieee802154.frame_samples(srd868.system(CFG, name),
                                               TRAFFIC["data_psdu_octets"] if k == "data"
                                               else ieee802154.ACK_OCTETS))
              for a, k, _ in frames[name]])
    assert len(spans) >= 3
    silent = np.ones(N, bool)
    for (a, b), frame in zip(spans, frames[name]):
        tuner = 0.0 if name == "wmbus_t1" else own["frames"][frame[1]]["carrier_offset_hz"]
        assert centroid_hz(x[a:b], rate) == pytest.approx(own["offset_hz"] + tuner, abs=5e3)
        silent[a:b] = False
    assert not x[silent].any()  # nothing outside the frames
    assert min(a for a, _ in spans) >= ieee802154.quiet_lead(N)


@pytest.mark.parametrize("seed", [2**31 + 1, 2**40 + 3])
def test_the_band_never_clips_and_the_systems_overlap(seed):
    x, frames = srd868.render(CFG, [seed, 1], N, TRAFFIC["data_psdu_octets"], layout=1)
    assert np.abs(x).max() < 0.95  # 0.85 of the systems, noise under 0.1
    q = srd868.signals.quantize(CFG, x)
    assert q.min() > -128 and q.max() < 127
    tel = [(a, a + len(c) * 90) for a, _, c in frames["wmbus_t1"]]
    zb = [(a, a + ieee802154.frame_samples(srd868.system(CFG, "ieee802154"),
                                           TRAFFIC["data_psdu_octets"] if k == "data" else 5))
          for a, k, _ in frames["ieee802154"]]
    assert any(a < d and c < b for a, b in tel for c, d in zb)


def test_captures_of_one_index_share_their_layout_across_seeds():
    a = srd868.capture(CFG, [2**31 + 1, 2], N, 127, layout=2)[1]
    b = srd868.capture(CFG, [2**31 + 9, 2], N, 127, layout=2)[1]
    assert [f[:2] for f in a["wmbus_t1"]] == [f[:2] for f in b["wmbus_t1"]]
    assert [f[:2] for f in a["ieee802154"]] == [f[:2] for f in b["ieee802154"]]
    assert [f[2] for f in a["wmbus_t1"]] != [f[2] for f in b["wmbus_t1"]]


@pytest.fixture(scope="module")
def capture():
    """A small band capture, the reference's filtered samples (as the
    program's float32 planes) and its analysis of them."""
    x, _ = srd868.capture(CFG, [2**31 + 29, 0], N, TRAFFIC["data_psdu_octets"], layout=0)
    y = channel.bandpass(x, *BAND)
    planes = channel.planes(y)
    return x, y, planes, channel.analyze(planes)


def as_program(ref):
    params, res = ref
    got = (True, params["modulation"], params["samples_per_symbol"], params["center"],
           params["tolerance"], params["noise"])
    return got, [m[:2] + (m[4],) for m in res["messages"]], (res["states"].copy(),
                                                            res["rect"].copy())


def numbers(check):
    return {k: v for k, (v, _) in check["numbers"].items()}


def judge(capture, planes=None, msgs=None, kept=None):
    x, y, own, ref = capture
    got, ref_msgs, ref_kept = as_program(ref)
    planes = own if planes is None else planes
    return driver.compare(channel.error(planes, y), [(0, got, ref_msgs if msgs is None else msgs)],
                          {0: ref_kept if kept is None else kept}, {0: ref}, {0: own}, LIMITS)


def test_the_reference_against_itself_reads_0(capture):
    _, _, _, ref = capture
    assert ref[0]["samples_per_symbol"] == 90 and len(ref[1]["messages"]) >= 3
    check = judge(capture)
    n = numbers(check)
    assert check["correct"] and n.pop("filter_err") < 1e-7  # the planes' float32 rounding
    assert set(n.values()) == {0}


def test_a_flipped_state_a_dropped_message_and_a_scaled_filter_are_not_correct(capture):
    _, _, planes, ref = capture
    _, msgs, (states, rect) = as_program(ref)
    far = int(np.flatnonzero(np.abs(rect - np.float32(ref[0]["center"])) > 0.05)[100])
    flipped = states.copy()
    flipped[far] = 1 - flipped[far]
    check = judge(capture, kept=(flipped, rect))
    assert not check["correct"] and numbers(check)["state_mismatch"] == 1
    check = judge(capture, msgs=msgs[:-1])
    assert not check["correct"] and numbers(check)["msg_mismatch"] == 1
    check = judge(capture, planes=planes * np.float32(1 + 1e-3))
    assert not check["correct"]
    assert numbers(check)["filter_err"] == pytest.approx(1e-3, rel=0.01)


def test_the_bfloat16_control_is_not_correct_by_the_filter_and_the_analysis(capture):
    x = capture[0]
    cell = driver.Cell(CFG, TRAFFIC, 2**31 + 29, "cpu", 1.0)
    cell.captures = [x]
    n = numbers(cell.control(LIMITS))
    assert n["filter_err"] > LIMITS["filter_err"]
    assert any(n[k] > LIMITS[k] for k in LIMITS if k != "filter_err"), n


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out"])
def test_an_analysis_fault_planted_in_the_band_cell_turns_correct_false(monkeypatch, fault):
    """The faults planted in ``analyze`` cells (an auto-detection that sets
    nothing, half the messages left out) in the band cell, whose traffic
    names ``channel``."""
    plant(monkeypatch, fault, "analyze")
    _, _, check = rehearse(CELL)
    assert not check["correct"], (fault, check)


def test_the_filter_yardstick():
    n = 1 << 24
    assert bandpass_yardstick.least_bytes(n, 1) == 10 * n
    assert bandpass_yardstick.least_bytes(n, 4) == 16 * n
    assert bandpass_yardstick.least_seconds(n, 1) == pytest.approx(10 * n / 3.35e12)
    assert bandpass_yardstick.least_seconds(n, 1) == pytest.approx(50.08e-6, rel=1e-3)


def events(filter_spans=True):
    """Two analyses, each with a filter.bandpass span launching two 1-ms
    kernels inside bench.bandpass, then bench.estimate and bench.demodulate."""
    x = lambda cat, name, ts, dur, **args: {"ph": "X", "cat": cat, "name": name, "ts": ts,
                                            "dur": dur, "args": args}
    out = [x("user_annotation", "bench.window", 0, 1e6)]
    for k, t in enumerate((1e4, 5e5)):
        out += [x("user_annotation", "bench.bandpass", t, 1e5),
                x("user_annotation", "bench.estimate", t + 1e5, 2e5),
                x("user_annotation", "bench.demodulate", t + 3e5, 4e4)]
        if filter_spans:
            out.append(x("user_annotation", "filter.bandpass", t + 10, 9e4))
        for j in range(2):
            corr = 10 * k + j
            s = t + 1e3 + j * 2e3
            out += [x("cuda_runtime", "cudaLaunchKernel", s, 5, correlation=corr),
                    x("kernel", "fft", s + 100, 1e3, correlation=corr)]
    return out


def test_the_band_readers_on_a_trace_and_without_the_span():
    ctx = type("Ctx", (), {})()
    ctx.counters = {"capture_samples": 1 << 24, "sample_itemsize": 1}
    ctx.trace = Trace(events())
    assert registry.reader("bandpass_s.channel")(ctx) == pytest.approx(0.09)
    least = bandpass_yardstick.least_seconds(1 << 24, 1)
    assert registry.reader("bandpass_roofline.channel")(ctx) == pytest.approx(
        100 * 2 * least / 4e-3)
    assert registry.reader("estimate_s.channel")(ctx) == pytest.approx(0.2)
    assert registry.reader("demod_s.channel")(ctx) == pytest.approx(0.04)
    ctx.trace = Trace(events(filter_spans=False))  # a program without the span
    assert registry.reader("bandpass_s.channel")(ctx) is None
    assert registry.reader("bandpass_roofline.channel")(ctx) is None
