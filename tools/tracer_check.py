#!/usr/bin/env python3
"""The port's tracer on a card: what a span costs, and whether its clock is
the device trace's.

    python3 tools/tracer_check.py [--seconds 8] [--seed 2148001234] [--out DIR]
    # from the repository root, one CUDA card

1. Cost: the mean time of one ``metrics.span`` with an empty body, over a
   loop of spans (the bare loop's time taken off), with no profiler running
   and with ``torch.profiler`` collecting the host and CUDA activities.
2. The shared clock: the benchmark's live cell (``wmbus_t1_hackrf.live``:
   a sender process writes 10 Msps in 1 ms blocks to a ``ProtocolSniffer``
   on the card) under ``profile_trace`` for 3 s of a ``--seconds`` window.
   For each drain whose feed ran inside the trace, every device copy and B6
   kernel it caused must start after its ``sniffer.drain`` span starts and
   before the next drain's span starts (the spans as ``profile_trace``
   wrote them into the trace).  What a drain caused comes from the stream's
   order, not from a clock: the drain's B6 launches (its increase of
   ``stream_kernels.LAUNCHES``) take the next B6 kernels in device order, an
   upload belongs to the drain of the kernel after it and a readback to the
   drain of the kernel before it.  The profiler starts and stops between
   feeds (the drains wait for it meanwhile), so the trace holds whole feeds.
   Also counted: the spans a drain records, and the tracer's counters a
   drain (``stream.settled`` reads 1 where every drain settled its chunk).

Prints one JSON line a part, each with the card's name and power limit; the
trace goes to ``DIR/trace.json`` (default ``build/tracer_check``).  The last line is
``{"ok": ...}``: true when at least 99% of the drains pass.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import subprocess
import sys
import threading
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

TRACED_S = 3.0
B6_KERNELS = ("block_kernel", "states_kernel")
PASS_SHARE = 0.99


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    return out or "nvidia-smi not readable"


def span_cost(n: int) -> dict:
    """ns a span, its empty loop's ns taken off: profiler off, then on."""
    import torch

    from urh_tpu_torch.util.metrics import StageMetrics

    m = StageMetrics()

    def per_span() -> float:
        t0 = time.perf_counter_ns()
        for _ in range(n):
            pass
        bare = time.perf_counter_ns() - t0
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with m.span("cost"):
                pass
        return (time.perf_counter_ns() - t0 - bare) / n

    per_span()  # warm
    off = per_span()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        per_span()  # the first record_function is slow
        on = per_span()
    return {"spans": n, "ns_a_span_profiler_off": off, "ns_a_span_profiler_on": on}


class Gate:
    """Starts and stops ``profile_trace`` between the sniffer's feeds, and
    notes each feed inside it: (its start on the trace's axis later, its
    B6 launches)."""

    def __init__(self, sniffer, out_dir: str):
        from urh_tpu_torch.dsp import stream_kernels
        from urh_tpu_torch.util import metrics

        self.seconds, self.out_dir = TRACED_S, out_dir
        self.lock, self.feeds, self.on = threading.Lock(), [], False
        self._metrics, self._ctx = metrics, None
        ingest = sniffer._ingest

        def gated(chunk):
            with self.lock:
                before = sum(stream_kernels.LAUNCHES.values())
                t = metrics.now_ns()
                ingest(chunk)
                if self.on:
                    self.feeds.append((t, sum(stream_kernels.LAUNCHES.values()) - before))

        sniffer._ingest = gated

    def start(self):
        with self.lock:
            self._ctx = self._metrics.profile_trace(self.out_dir)
            self._ctx.__enter__()
            self.on = True

    def stop(self):
        import torch

        with self.lock:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.on = False
            self._ctx.__exit__(None, None, None)


def shared_clock(seconds: float, seed: int, out_dir: str) -> dict:
    """The live cell under a ``Gate``; -> the drains judged and the spans
    a drain."""
    import torch

    from benchmark import registry
    from benchmark.drivers import live
    from urh_tpu_torch.util import metrics

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)  # the first start initializes CUPTI
    torch.cuda.synchronize()
    bench = registry.benchmark()
    wl = registry.workload(bench, "wmbus_t1_hackrf.live")
    cell = live.Cell(registry.config(bench, wl["config"]), registry.traffic(wl["traffic"]),
                     seed, "cuda", seconds)
    try:
        cell.setup()
        gate = Gate(cell.sniffer, out_dir)
        cell.window(seconds, gate)
        spans = metrics.metrics.timeline()
        counters = metrics.metrics.counters()
    finally:
        cell.close()
    counts = {}
    for s in spans:
        counts[s.name] = counts.get(s.name, 0) + 1
    out = judge(os.path.join(out_dir, metrics.TRACE_FILE), gate.feeds)
    drains = counts.get("sniffer.drain", 1)
    out["spans_a_drain"] = {k: v / drains for k, v in sorted(counts.items())}
    out["counters_a_drain"] = {k: v / drains for k, v in sorted(counters.items())}
    out["timeline_overwritten"] = metrics.metrics.overwritten
    return out


def judge(path: str, feeds: list) -> dict:
    """Each traced feed's drain against the device work it caused."""
    from urh_tpu_torch.util import metrics

    with open(path) as f:
        trace = json.load(f)
    base, offset = trace["baseTimeNanoseconds"], trace[metrics.TRACE_OFFSET_KEY]
    axis = lambda t_ns: (t_ns + offset - base) / 1e3
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    drains = sorted(e["ts"] for e in events
                    if e["name"] == "sniffer.drain" and e.get("cat") == metrics.TRACE_CATEGORY)
    kernels = sorted(e["ts"] for e in events if e.get("cat") == "kernel"
                     and any(k in e["name"] for k in B6_KERNELS))
    copies = sorted((e["ts"], "HtoD" in e["name"]) for e in events
                    if e.get("cat") == "gpu_memcpy" and ("HtoD" in e["name"] or "DtoH" in e["name"]))
    launched = sum(n for _, n in feeds)
    out = {"drains_traced": len(feeds), "b6_launched": launched, "b6_in_trace": len(kernels),
           "copies_in_trace": len(copies)}
    if launched != len(kernels) or not launched:
        return dict(out, drains_passed=0, share=0.0)
    # each feed's drain span: the latest drain span starting before the feed
    owner = []
    for t, n in feeds:
        k = bisect.bisect_right(drains, axis(t)) - 1
        owner += [k] * n
    caused = {k: [] for k in set(owner)}
    for ts, k in zip(kernels, owner):
        caused[k].append(ts)
    for ts, up in copies:
        i = bisect.bisect_right(kernels, ts)
        i = min(i, len(kernels) - 1) if up else max(i - 1, 0)
        caused[owner[i]].append(ts)
    passed, leads, slacks = 0, [], []
    for k, stamps in caused.items():
        start = drains[k] if k >= 0 else float("inf")
        after = drains[k + 1] if k + 1 < len(drains) else float("inf")
        passed += all(start <= ts < after for ts in stamps)
        leads.append(min(stamps) - start)
        slacks.append(after - max(stamps))
    return dict(out, drains_checked=len(caused), drains_passed=passed,
                share=passed / len(caused), least_lead_us=min(leads),
                least_slack_us=min(slacks))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=2148001234)
    p.add_argument("--out", default=os.path.join(_REPO, "build", "tracer_check"))
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tools/tracer_check.py needs a CUDA card")
    identity = card()
    cost = span_cost(100_000)
    print(json.dumps({"span_cost": cost, "card": identity}), flush=True)
    clock = shared_clock(args.seconds, args.seed, args.out)
    print(json.dumps({"shared_clock": clock, "card": identity}), flush=True)
    print(json.dumps({"ok": clock["share"] >= PASS_SHARE}), flush=True)


if __name__ == "__main__":
    main()
