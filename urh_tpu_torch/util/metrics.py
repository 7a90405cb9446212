"""Pipeline observability: the port's one tracer.

The reference has no structured tracing (SURVEY.md section 5).  Here the
process-wide :data:`metrics` (a :class:`StageMetrics`) keeps

* spans: ``with metrics.span(name, **args):`` adds the body's wall time to
  the name's aggregates (``report()``: samples, seconds, calls) and appends
  a :class:`Span` to a bounded timeline (``timeline()``), a ring of
  ``TIMELINE_RECORDS`` that counts the records it overwrote
  (``overwritten``).  Where the calling thread's ``torch.profiler`` is
  collecting, the body also runs inside ``record_function(name)``, so the
  span lands in the profiler's trace; otherwise that call is skipped (it
  costs about 14 us even with the profiler off);
* counters: ``metrics.count(name, n)`` (or ``count({name: n, ...})``,
  several under one lock), read by ``counters()``.

Stamps are ``time.perf_counter_ns()`` (:func:`now_ns`); adding
:func:`epoch_offset_ns` puts them on the Unix epoch, the axis of a
``torch.profiler`` Chrome trace (an event's time is
``baseTimeNanoseconds + ts * 1000``).  :func:`profile_trace` writes such a
trace and adds to it the spans of the threads the profiler does not see (a
Python thread's ``record_function`` never reaches it), each on its own
thread row.

Spans and counters of the port: ``estimate.stage``, ``estimate.noise``,
``estimate.segment``, ``estimate.classify``, ``estimate.rect`` and
``estimate.scan`` (``ai/estimate.py``, one each an estimate, in that
order; inside ``estimate.scan`` the spans ``estimate.scan.center``,
``estimate.scan.plateaus`` and ``estimate.scan.vote``), with the counters
``scan.messages`` (the messages an estimate scans), ``scan.histogram_calls``
(``detect_centers``: one device call counting the centers' histograms of all
the messages it is given), ``gate.card`` (``estimate()``: a power gate run on
a capture staged on the card), ``gate.settled_rows`` and ``gate.crossings``
(``ai/power_gate.py``: chunk means the host recomputed, crossing positions
back from the device); ``demod.costas`` (``dsp/costas.py``, one a pass of the Costas loop,
B5's launch on the card); ``filter.bandpass`` (``Signal.bandpass``: the
int8 or float32 capture to complex64, the filter, the new signal; args:
samples, taps, route) and inside it ``filter.convolve``
(``Filter.apply_bandpass_filter``'s convolution, on the host or the device),
with the counters ``filter.samples`` (the samples each such filter takes),
``filter.card`` (filters that took ``fft_convolve_1d`` on the device) and
``filter.host`` (filters that took ``np.convolve``), one update a filter;
``sniffer.drain``, ``sniffer.ring_wait``,
``sniffer.emit_wait`` and ``sniffer.demodulate`` (``protocol/sniffer.py``);
the counters ``costas.samples`` (the samples of each such pass),
``ring.commits``, ``ring.samples`` and ``ring.wraps`` (the Network SDR's
``SampleSink``) and ``stream.settled`` (``StreamDemodulator.settle``).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple

import torch

now_ns = time.perf_counter_ns
# about 130 s of the live sniffer at 10 Msps (some 250 records a second)
TIMELINE_RECORDS = 1 << 15


def epoch_offset_ns() -> int:
    """Unix-epoch ns minus :func:`now_ns`, read now (a wall-clock step
    moves it)."""
    return time.time_ns() - time.perf_counter_ns()


# whether the calling thread's torch.profiler is collecting (about 0.1 us)
_profiler_enabled = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    tid: int            # the recording thread's native id
    start_ns: int       # now_ns() clock
    end_ns: int
    args: dict
    profiled: bool      # recorded inside its record_function twin


class _SpanContext:
    """One ``metrics.span``: stamps its edges inside the ``record_function``
    twin, if any, so the stamps lie within the twin."""

    __slots__ = ("_tracer", "_name", "_args", "_twin", "start_ns")

    def __init__(self, tracer, name: str, args: dict):
        self._tracer, self._name, self._args = tracer, name, args
        self._twin = None

    def __enter__(self):
        if _profiler_enabled():
            self._twin = torch.profiler.record_function(self._name)
            self._twin.__enter__()
        self.start_ns = now_ns()
        return self

    def __exit__(self, *exc):
        end = now_ns()
        twin = self._twin
        if twin is not None:
            twin.__exit__(*exc)
        self._tracer.add(self._name, self.start_ns, end, self._args, twin is not None)
        return False


class StageMetrics:
    """Thread-safe spans (aggregates and a timeline) and counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stages = {}           # name -> [samples, seconds, calls]
        self._counts = defaultdict(int)
        self._timeline = deque(maxlen=TIMELINE_RECORDS)
        self._threads = {}          # native id -> thread name
        self.overwritten = 0

    def record(self, stage: str, num_samples: int, seconds: float):
        with self._lock:
            self._aggregate_locked(stage, int(num_samples), float(seconds))

    def _aggregate_locked(self, stage: str, samples: int, seconds: float):
        agg = self._stages.get(stage)
        if agg is None:
            agg = self._stages[stage] = [0, 0.0, 0]
        agg[0] += samples
        agg[1] += seconds
        agg[2] += 1

    def span(self, name: str, **args) -> _SpanContext:
        """Context manager timing its body as a span of ``name``; ``args``
        go with the timeline's record (``samples`` also into the name's
        aggregates).  ``as s`` gives ``s.start_ns``."""
        return _SpanContext(self, name, args)

    def measure(self, stage: str, num_samples: int) -> _SpanContext:
        return self.span(stage, samples=num_samples)

    def add(self, name: str, start_ns: int, end_ns: int, args: dict = None,
            profiled: bool = False):
        """Record a span whose edges were stamped with :func:`now_ns`."""
        # the Thread's cached native id: threading.get_native_id() is a
        # system call, several us where system calls are intercepted
        thread = threading.current_thread()
        tid = thread.native_id
        samples = args.get("samples", 0) if args else 0
        timeline = self._timeline
        with self._lock:
            self._aggregate_locked(name, samples, (end_ns - start_ns) * 1e-9)
            if len(timeline) == timeline.maxlen:
                self.overwritten += 1
            timeline.append((name, tid, start_ns, end_ns, args or {}, profiled))
            if tid not in self._threads:
                self._threads[tid] = thread.name

    def count(self, name, n: int = 1):
        """Add ``n`` to the counter ``name``; ``name`` may instead be a
        dict ``{name: n}``, whose counts are added under one lock."""
        counts = name if isinstance(name, dict) else {name: n}
        with self._lock:
            for name, n in counts.items():
                self._counts[name] += n

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def timeline(self) -> list:
        """The kept spans, oldest first, as :class:`Span`."""
        with self._lock:
            return [Span(*rec) for rec in self._timeline]

    def thread_names(self) -> dict:
        with self._lock:
            return dict(self._threads)

    def throughput(self, stage: str) -> float:
        """Mean samples/s for a stage (0 when nothing recorded)."""
        with self._lock:
            samples, secs, _ = self._stages.get(stage, (0, 0.0, 0))
            return samples / secs if secs > 0 else 0.0

    def report(self) -> dict:
        with self._lock:
            return {
                stage: {
                    "samples": samples,
                    "seconds": round(secs, 6),
                    "calls": calls,
                    "samples_per_second": round(samples / secs, 1) if secs > 0 else 0.0,
                }
                for stage, (samples, secs, calls) in self._stages.items()
            }

    def clear(self):
        with self._lock:
            self._stages.clear()
            self._counts.clear()
            self._timeline.clear()
            self.overwritten = 0


# process-wide default registry
metrics = StageMetrics()


TRACE_FILE = "trace.json"
TRACE_CATEGORY = "urh_tpu_torch"
# the trace's key for the epoch_offset_ns() that placed the added spans
TRACE_OFFSET_KEY = "urh_tpu_torch_epoch_offset_ns"


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile a region with ``torch.profiler`` (the host and, where there
    is a card, CUDA activities) and write its Chrome trace to
    ``log_dir/trace.json`` (open it in chrome://tracing or Perfetto), with
    the spans of :data:`metrics` that the profiler did not see and that
    overlap the region added, placed with the :func:`epoch_offset_ns` read
    as the region starts (kept in the trace under ``TRACE_OFFSET_KEY``).
    Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        offset = epoch_offset_ns()
        start = now_ns()
        yield prof
        end = now_ns()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    _add_unseen_spans(path, start, end, offset)


def _add_unseen_spans(path: str, start_ns: int, end_ns: int, offset_ns: int):
    """Append to the Chrome trace at ``path`` the spans of :data:`metrics`
    recorded outside a ``record_function`` twin that overlap [start_ns,
    end_ns], on the trace's axis (``offset_ns`` from :func:`epoch_offset_ns`),
    one thread row a recording thread."""
    with open(path) as f:
        trace = json.load(f)
    trace[TRACE_OFFSET_KEY] = offset_ns
    base = int(trace["baseTimeNanoseconds"])
    pid = os.getpid()
    names = metrics.thread_names()
    events, rows = trace["traceEvents"], set()
    for s in metrics.timeline():
        if s.profiled or s.end_ns < start_ns or s.start_ns > end_ns:
            continue
        events.append({"ph": "X", "cat": TRACE_CATEGORY, "name": s.name, "pid": pid,
                       "tid": s.tid, "ts": (s.start_ns + offset_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": s.args})
        rows.add(s.tid)
    for tid in sorted(rows):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": f"{names.get(tid, 'thread')} ({tid})"}})
    with open(path, "w") as f:
        json.dump(trace, f)
