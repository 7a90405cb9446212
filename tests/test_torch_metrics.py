"""The port's tracer (urh_tpu_torch.util.metrics) and the spans and counters
the program records with it, on the CPU: the aggregates, the bounded
timeline, the counters, spans of a second thread, the clock shared with a
``torch.profiler`` trace, ``estimate()``'s six stages and its gate's
counters, and the live sniffer's
drains, ring waits, emit waits and ring counters."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from urh_tpu_torch.ai import estimate as est
from urh_tpu_torch.dev import network_sdr
from urh_tpu_torch.dev.backend_handler import BackendHandler
from urh_tpu_torch.dsp.modulate import modulate
from urh_tpu_torch.protocol.sniffer import ProtocolSniffer
from urh_tpu_torch.util import metrics, settings

torch.set_num_threads(1)

# how far a span's stamps may lie inside its record_function twin's edges
TWIN_EDGE_US = 200.0
STAGES = ["estimate.stage", "estimate.noise", "estimate.segment", "estimate.classify",
          "estimate.rect", "estimate.scan"]


def _own(spans):
    """The spans this thread recorded in the process-wide tracer."""
    return [s for s in spans if s.tid == threading.get_native_id()]


def test_span_adds_to_the_aggregates_and_the_timeline():
    m = metrics.StageMetrics()
    with m.span("feed", samples=100) as s:
        time.sleep(0.002)
    with m.span("feed", samples=50):
        pass
    m.record("feed", 10, 0.5)
    r = m.report()["feed"]
    assert (r["calls"], r["samples"]) == (3, 160)
    assert r["seconds"] >= 0.502
    first, second = m.timeline()
    assert first.name == "feed" and first.args == {"samples": 100}
    assert first.start_ns == s.start_ns and first.end_ns - first.start_ns >= 2_000_000
    assert second.start_ns >= first.end_ns
    assert first.tid == second.tid == threading.get_native_id()
    assert not first.profiled and m.overwritten == 0


def test_measure_is_a_span_with_samples():
    m = metrics.StageMetrics()
    with m.measure("sniffer.demodulate", 4000):
        pass
    (span,) = m.timeline()
    assert span.name == "sniffer.demodulate" and span.args == {"samples": 4000}
    assert m.report()["sniffer.demodulate"]["samples"] == 4000


def test_timeline_is_bounded_and_counts_what_it_overwrote(monkeypatch):
    monkeypatch.setattr(metrics, "TIMELINE_RECORDS", 4)
    m = metrics.StageMetrics()
    for k in range(6):
        m.add(f"s{k}", k, k + 1)
    assert [s.name for s in m.timeline()] == ["s2", "s3", "s4", "s5"]
    assert m.overwritten == 2
    assert m.report()["s0"]["calls"] == 1  # the aggregates keep every span
    m.clear()
    assert m.timeline() == [] and m.overwritten == 0 and m.report() == {}


def test_counters_are_read_by_their_own_accessor():
    m = metrics.StageMetrics()
    m.count("ring.commits")
    m.count("ring.commits")
    m.count("ring.samples", 3500)
    assert m.counters() == {"ring.commits": 2, "ring.samples": 3500}
    m.count({"ring.commits": 1, "ring.samples": 500, "ring.wraps": 0})
    assert m.counters() == {"ring.commits": 3, "ring.samples": 4000, "ring.wraps": 0}
    assert m.report() == {}
    m.clear()
    assert m.counters() == {}


def test_spans_of_a_second_thread_are_recorded_with_its_id():
    m = metrics.StageMetrics()
    ids = []

    def work():
        ids.append(threading.get_native_id())
        for _ in range(3):
            with m.span("worker", samples=1):
                pass

    t = threading.Thread(target=work, name="worker-thread")
    t.start()
    t.join(10)
    assert not t.is_alive()
    with m.span("main"):
        pass
    spans = m.timeline()
    assert [s.name for s in spans] == ["worker"] * 3 + ["main"]
    assert {s.tid for s in spans[:3]} == {ids[0]} != {spans[3].tid}
    assert m.thread_names()[ids[0]] == "worker-thread"


def test_spans_share_the_profiler_trace_clock(tmp_path):
    """A main-thread span lies inside its record_function twin, near both
    edges; a second thread's spans (which the profiler does not see) are
    written into the trace on their own row, inside the profiled stretch."""
    m = metrics.metrics
    with metrics.profile_trace(str(tmp_path / "warm")):
        with m.span("main.span"):  # the profiler's first record_function is slow
            pass
    m.clear()
    worker_tid = []

    def work():
        worker_tid.append(threading.get_native_id())
        for _ in range(3):
            with m.span("worker.span", samples=7):
                time.sleep(0.001)

    with metrics.profile_trace(str(tmp_path / "trace")):
        with m.span("main.outer"):
            t = threading.Thread(target=work)
            t.start()
            t.join(10)
            with m.span("main.span"):
                torch.ones(1000).cumsum(0)
    assert not t.is_alive()
    with open(tmp_path / "trace" / metrics.TRACE_FILE) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    offset = trace[metrics.TRACE_OFFSET_KEY]
    assert abs(offset - metrics.epoch_offset_ns()) < 1_000_000_000
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]

    def twin(name):
        (e,) = [e for e in events if e["name"] == name and e.get("cat") == "user_annotation"]
        return e["ts"], e["ts"] + e["dur"]

    (span,) = [s for s in _own(m.timeline()) if s.name == "main.span"]
    assert span.profiled
    a, b = twin("main.span")
    start_us = (span.start_ns + offset - base) / 1e3
    end_us = (span.end_ns + offset - base) / 1e3
    assert a <= start_us <= a + TWIN_EDGE_US
    assert b - TWIN_EDGE_US <= end_us <= b
    workers = [e for e in events if e["name"] == "worker.span"]
    assert len(workers) == 3
    assert {(e["cat"], e["tid"]) for e in workers} == {(metrics.TRACE_CATEGORY, worker_tid[0])}
    assert all(e["args"] == {"samples": 7} for e in workers)
    lo, hi = twin("main.outer")
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in workers)
    rows = [e for e in trace["traceEvents"]
            if e.get("ph") == "M" and e["name"] == "thread_name" and e["tid"] == worker_tid[0]]
    assert len(rows) == 1


def test_spans_skip_record_function_with_the_profiler_off(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function called with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    m = metrics.StageMetrics()
    with m.span("x"):
        pass
    assert not m.timeline()[0].profiled


def _capture(kind, seed, n_msgs=5, n_bits=64, pause=3000, noise=0.01):
    """[message, pause] * n_msgs from the port's modulator on the CPU."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(n_msgs):
        bits = rng.integers(0, 2, n_bits)
        bits[0] = bits[-1] = 1
        if kind == "FSK":
            iq = modulate(bits, 100, "fsk", [-20e3, 20e3], carrier_frequency=0.0,
                          pause=pause, device="cpu")
        else:
            iq = modulate(bits, 100, "ask", [0.0, 1.0], carrier_frequency=10e3,
                          pause=pause, device="cpu")
        parts.append(iq)
    iq = np.concatenate(parts)
    return (iq + rng.normal(0, noise, iq.shape)).astype(np.float32)


@pytest.mark.parametrize("kind,want", [("FSK", "FSK"), ("OOK", "ASK")])
def test_estimate_records_its_six_stages_once_in_order(kind, want):
    metrics.metrics.clear()
    result = est.estimate(_capture(kind, seed=3), device="cpu")
    assert result["modulation_type"] == want and result["bit_length"] == 100
    spans = _own(metrics.metrics.timeline())
    assert [s.name for s in spans] == STAGES
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))
    report = metrics.metrics.report()
    assert all(report[name]["calls"] == 1 for name in STAGES)


def test_estimate_staged_on_the_cpu_counts_no_gate():
    metrics.metrics.clear()
    result = est.estimate(_capture("FSK", seed=3), device="cpu")
    assert result["bit_length"] == 100
    assert not any(k.startswith("gate.") for k in metrics.metrics.counters())


@pytest.mark.parametrize("noise", [None, 0.05])
def test_estimate_on_a_staged_capture_counts_one_gate(noise, monkeypatch):
    # the gate's plain version stands in for the card's kernel
    monkeypatch.setattr(est, "gates", lambda staged: staged is not None)
    metrics.metrics.clear()
    result = est.estimate(_capture("FSK", seed=3), noise=noise, device="cpu")
    assert result["bit_length"] == 100
    counts = metrics.metrics.counters()
    assert counts["gate.card"] == 1
    assert counts["gate.crossings"] > 0
    assert counts.get("gate.settled_rows", 0) >= (1 if noise is None else 0)


# the ring test: 8 FSK messages of 2,480 samples (64 bits at 20 samples a
# bit, a 1,200-sample pause; the last pause cut to 100 samples, under the
# 200-sample gate, so only the flush closes the last message) written 3,000
# at a time into a 12,000-sample ring: the fourth write wraps, once
RING = 12000
WRITE = 3000


def test_sniffer_records_drains_waits_and_ring_counters(monkeypatch):
    monkeypatch.setattr(settings, "OVERWRITE_RECEIVE_BUFFER_SIZE", RING)
    bits = np.resize(np.array([1, 0, 1, 1, 0, 0, 1, 0], np.uint8), 64)
    one = modulate(bits, 20, "fsk", [-20e3, 20e3], sample_rate=1e6, pause=1200, device="cpu")
    x = np.tile(one, (8, 1))[:-1100]
    x = (x + np.random.default_rng(0).normal(0, 0.002, x.shape)).astype(np.float32)
    sniffer = ProtocolSniffer(20, 0.0, 0.1, 1e-2, 3, "FSK", 1, "Network SDR", BackendHandler(),
                              network_raw_mode=True, compute_device="cpu")
    sniffer._stream = sniffer._make_stream()
    dev = sniffer.rcv_device.underlying_device
    dev._sample_sink = network_sdr.SampleSink(dev.receive_buffer)
    metrics.metrics.clear()
    pos, drains = 0, 0
    for i in range(0, len(x), WRITE):
        dev._sample_sink(x[i:i + WRITE])
        pos = sniffer._drain_ring(pos)
        drains += 1
        assert sniffer._drain_ring(pos) == pos  # nothing new: no span
    in_drains = len(sniffer.messages)
    sniffer._emit_segments(sniffer._stream.flush())
    assert in_drains >= 4 and len(sniffer.messages) > in_drains

    spans = _own(metrics.metrics.timeline())
    named = lambda name: [s for s in spans if s.name == name]
    drain, ring_wait, emit_wait = (named("sniffer.drain"), named("sniffer.ring_wait"),
                                   named("sniffer.emit_wait"))
    assert len(drain) == len(ring_wait) == drains == 7
    assert [s.end_ns for s in ring_wait] == [s.start_ns for s in drain]
    assert sum(s.args["samples"] for s in drain) == sniffer._stream._fed == len(x) + RING - 9000
    assert len(emit_wait) == in_drains  # stop()'s flush is not counted
    starts = {s.start_ns for s in drain}
    assert all(s.start_ns in starts and s.end_ns > s.start_ns for s in emit_wait)
    # a message leaves inside the drain that fed its end
    assert all(s.end_ns <= min(d.end_ns for d in drain if d.start_ns == s.start_ns)
               for s in emit_wait)
    assert len(named("sniffer.demodulate")) == drains
    counters = metrics.metrics.counters()
    # each drain took the device route and settled its own chunk
    assert counters == {"ring.commits": 7, "ring.samples": len(x), "ring.wraps": 1,
                        "stream.settled": drains}
    # the drains fed the lap's stale tail besides every sample written
    stale = metrics.metrics.report()["sniffer.drain"]["samples"] - counters["ring.samples"]
    assert stale == RING - 9000
