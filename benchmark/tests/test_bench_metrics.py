"""The metric arithmetic: the yardstick, the trace reader and each per-layer
metric's reader, on traces made by hand."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import registry, yardstick
from benchmark.chrome_trace import Trace


def test_union_and_gaps_of_intervals():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert yardstick.union_seconds(spans) == 4
    assert yardstick.gaps(spans, 0, 8) == [(3, 5), (6, 8)]


@pytest.mark.parametrize("q", [50, 95, 99])
def test_percentile_is_over_all_values_as_numpy_takes_it(q):
    v = np.random.default_rng(q).exponential(size=1001)
    assert yardstick.percentile(v.tolist(), q) == pytest.approx(np.percentile(v, q))


def test_least_bytes_count_each_sample_once_and_one_state_byte():
    assert yardstick.demod_least_bytes(1 << 24, 4) == (1 << 24) * 9
    assert yardstick.demod_least_bytes(1 << 17, 1) == (1 << 17) * 3
    assert yardstick.least_seconds(3.35e12) == pytest.approx(1.0)


def events():
    """A 10 ms window: two demodulate spans, each launching one kernel (the
    second runs after its span ended), a copy, and a kernel launched
    outside any span."""
    x = lambda cat, name, ts, dur, **args: {"ph": "X", "cat": cat, "name": name, "ts": ts,
                                            "dur": dur, "args": args}
    return [x("user_annotation", "bench.window", 1000, 10000),
            x("user_annotation", "bench.demodulate", 2000, 1000),
            x("user_annotation", "bench.demodulate", 5000, 1000),
            x("user_annotation", "bench.estimate", 6100, 2100),
            x("cuda_runtime", "cudaLaunchKernel", 2100, 5, correlation=1),
            x("cuda_runtime", "cudaLaunchKernel", 5900, 5, correlation=2),
            x("cuda_runtime", "cudaLaunchKernel", 8000, 5, correlation=3),
            x("kernel", "urh_fsk_f32", 2200, 100, correlation=1),
            x("kernel", "urh_fsk_f32", 6050, 100, correlation=2),
            x("kernel", "other", 8100, 400, correlation=3),
            x("gpu_memcpy", "Memcpy HtoD", 2150, 100)]


def test_the_trace_reads_spans_busy_time_launches_and_gaps():
    t = Trace(events())
    assert t.window_s == pytest.approx(0.010)
    assert t.named("bench.demodulate") == [(2000, 3000), (5000, 6000)]
    assert t.busy_s() == pytest.approx((150 + 100 + 400) * 1e-6)
    assert t.kernel_s_launched_in("bench.demodulate") == pytest.approx(200e-6)
    ops = dict(t.device_ops())
    assert ops["other"] == pytest.approx(400e-6) and ops["urh_fsk_f32"] == pytest.approx(200e-6)
    assert t.idle_gaps() == [["outside the benchmark's spans", pytest.approx(3.75e-3)],
                             ["outside the benchmark's spans", pytest.approx(2.5e-3)],
                             ["bench.estimate", pytest.approx(1.95e-3)],
                             ["outside the benchmark's spans", pytest.approx(1.15e-3)]]


class Ctx:
    def __init__(self, trace, counters):
        self.trace, self.counters = trace, counters


def test_each_reader_reads_its_number_and_nothing_from_an_empty_trace():
    t = Trace(events())
    c = {"capture_samples": 1 << 20, "sample_itemsize": 4, "feed_ms": 1.5,
         "gen_lag_p95_ms": 0.2}
    read = lambda name, trace=t, counters=c: registry.reader(name)(Ctx(trace, counters))
    assert read("demod_s.analyze") == pytest.approx(1e-3)
    assert read("estimate_s.analyze") == pytest.approx(2.1e-3)
    least = 2 * yardstick.least_seconds(yardstick.demod_least_bytes(1 << 20, 4))
    assert read("demod_roofline.analyze") == pytest.approx(100 * least / 200e-6)
    assert read("device_idle_pct.analyze") == pytest.approx(100 * (1 - 650e-6 / 0.01))
    assert read("feed_ms.live") == 1.5 and read("gen_lag_p95_ms.live") == 0.2
    empty = Trace([])
    for m in registry.benchmark()["per_layer"]:
        assert registry.reader(m["name"])(Ctx(empty, {})) is None or m["name"].startswith(
            "device_idle_pct")


def test_a_rate_is_all_the_work_over_the_whole_window(monkeypatch):
    """analyze_s is the window, from its start to the end of the last
    analysis, over every analysis completed in it."""
    from types import SimpleNamespace

    from benchmark.drivers import analyze

    clock = iter([0.0, 0.4, 0.8, 1.3])
    monkeypatch.setattr(analyze.time, "perf_counter", lambda: next(clock))
    monkeypatch.setattr(analyze.common, "reset_launches", lambda: {})
    monkeypatch.setattr(analyze.common, "read_launches", lambda start: {})
    cell = analyze.Cell({}, {}, 1, "cpu", 1.0)
    cell.captures = [np.zeros((1000, 2), np.float32), np.zeros((3000, 2), np.float32)]
    params = SimpleNamespace(modulation="FSK", samples_per_symbol=50, center=0.0, tolerance=5,
                             noise_threshold=0.1)
    sig = SimpleNamespace(params=params, qad_states=None, _qad=None)
    cell._analyze = lambda x: (sig, True, [])
    out = cell.window(1.0)
    assert out["e2e"]["analyze_s"] == pytest.approx(1.3 / 3)
