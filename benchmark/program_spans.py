"""Reading the program's own spans (``urh_tpu_torch.util.metrics``): those
of the main thread in the trace, where they are ``record_function`` twins,
and those of the sniffer's poll thread, which no trace sees, in the
program's timeline.  A reading is None where the program records no such
span, as a commit before its tracer had them does not."""

from __future__ import annotations

from benchmark import yardstick


def per_analysis_s(trace, name: str):
    """Seconds an analysis spends in spans of ``name``: their sum in the
    trace's window over the analyses (``bench.estimate`` spans) there."""
    analyses, spans = trace.named("bench.estimate"), trace.named(name)
    if not analyses or not spans:
        return None
    return sum(b - a for a, b in spans) * 1e-6 / len(analyses)


def timeline(name: str):
    """[(start ns, end ns)] of the program's spans of ``name`` since its
    tracer was last cleared (the live driver clears it as its window opens),
    by start; None where the program keeps no timeline or the timeline
    overwrote a record since."""
    from urh_tpu_torch.util.metrics import metrics

    read = getattr(metrics, "timeline", None)
    if read is None or getattr(metrics, "overwritten", 0):
        return None
    return sorted((s.start_ns, s.end_ns) for s in read() if s.name == name)


def p95_ms(lengths_ns: list):
    """The 95th percentile of lengths in ns, in ms; None for none."""
    return yardstick.percentile(lengths_ns, 95) * 1e-6 if lengths_ns else None


def length_p95_ms(name: str):
    """The 95th percentile of the lengths of the program's spans of ``name``."""
    spans = timeline(name)
    return None if spans is None else p95_ms([b - a for a, b in spans])
