"""The readers of the program's own spans: estimation's six stages from the
trace, the live path's drain period, ring wait and emit wait from the
program's timeline; each None where its spans are absent, where the
timeline overwrote a record, and where the program keeps no timeline."""

from __future__ import annotations

import pytest

from benchmark import registry
from benchmark.chrome_trace import Trace
from urh_tpu_torch.util import metrics

STAGES = ("noise", "segment", "stage", "classify", "rect", "scan")
LIVE = ("drain_period_p95_ms.live", "ring_wait_p95_ms.live", "emit_wait_p95_ms.live")


class Ctx:
    def __init__(self, trace, counters=None):
        self.trace, self.counters = trace, counters or {}


def read(name: str, trace=None):
    return registry.reader(name)(Ctx(trace if trace is not None else Trace([])))


def span(name: str, ts: float, dur: float) -> dict:
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "args": {}}


def analyses() -> Trace:
    """A window with two analyses; stage k of each lasts (k + 1) * 100 us,
    and one more noise span lies outside the window."""
    events = [span("bench.window", 0, 100000), span("estimate.noise", 200000, 50)]
    for a in (1000, 50000):
        events.append(span("bench.estimate", a, 30000))
        t = a + 10
        for k, stage in enumerate(STAGES):
            events.append(span(f"estimate.{stage}", t, (k + 1) * 100))
            t += (k + 1) * 100
    return Trace(events)


def test_each_stage_reads_its_mean_seconds_an_analysis():
    t = analyses()
    for k, stage in enumerate(STAGES):
        assert read(f"est_{stage}_s.analyze", t) == pytest.approx((k + 1) * 100e-6)


def test_stages_read_nothing_without_their_spans_or_the_analyses():
    only_analyses = Trace([span("bench.window", 0, 10000), span("bench.estimate", 10, 500)])
    only_stages = Trace([span("bench.window", 0, 10000), span("estimate.noise", 10, 500)])
    for stage in STAGES:
        for t in (Trace([]), only_analyses, only_stages):
            assert read(f"est_{stage}_s.analyze", t) is None


@pytest.fixture
def tracer(monkeypatch):
    """A fresh tracer in the program's place."""
    monkeypatch.setattr(metrics, "TIMELINE_RECORDS", 64)
    m = metrics.StageMetrics()
    monkeypatch.setattr(metrics, "metrics", m)
    return m


MS = 1_000_000


def drains(m, n: int):
    """n drains 12 ms apart, each 2 ms long, with a ring wait of 10 ms before
    it (11 ms for every fifth) and every second one emitting a message that
    waited 14 ms (20 ms for the last)."""
    for k in range(n):
        start = k * 12 * MS
        m.add("sniffer.ring_wait", start - (11 if k % 5 == 4 else 10) * MS, start)
        m.add("sniffer.drain", start, start + 2 * MS, {"samples": 100000})
        if k % 2:
            m.add("sniffer.emit_wait", start, start + (20 if k == n - 1 else 14) * MS)


def test_live_readers_read_the_p95_of_the_timeline(tracer):
    drains(tracer, 20)
    assert read("drain_period_p95_ms.live") == pytest.approx(12.0)
    # 16 waits of 10 ms and 4 of 11: the 95th percentile interpolates
    assert read("ring_wait_p95_ms.live") == pytest.approx(11.0)
    # 9 of 14 ms and one of 20: rank 8.55 of 0..9
    assert read("emit_wait_p95_ms.live") == pytest.approx(14 + 0.55 * 6)


def test_live_readers_read_nothing_without_their_spans(tracer):
    for name in LIVE:
        assert read(name) is None
    tracer.add("sniffer.drain", 0, MS)
    assert read("drain_period_p95_ms.live") is None  # one drain has no period


def test_live_readers_read_nothing_once_the_timeline_overwrote(tracer):
    drains(tracer, 40)  # 100 records through a ring of 64
    assert tracer.overwritten > 0
    for name in LIVE:
        assert read(name) is None
    tracer.clear()
    drains(tracer, 4)
    assert read("drain_period_p95_ms.live") == pytest.approx(12.0)


def test_live_readers_read_nothing_from_a_program_without_a_timeline(monkeypatch):
    class Aggregates:
        """A tracer as the program had one before its timeline."""

        def report(self):
            return {"sniffer.demodulate": {"samples": 1, "seconds": 0.002, "calls": 1,
                                           "samples_per_second": 500.0}}

    monkeypatch.setattr(metrics, "metrics", Aggregates())
    for name in LIVE:
        assert read(name) is None
