"""One run of one cell of the port's benchmark.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration,
traffic mix, limits and driver are found by name (:mod:`benchmark.registry`).
The run makes its inputs from the seed, loads and warms the program, measures
for ``--seconds`` (with ``--trace 1`` under ``torch.profiler`` for a steady
part of the window, and then the per-layer metrics instead of the
end-to-end ones), frees the program's state, compares what the timed path
produced with the plain reference, and prints one JSON line last.  It exits
non-zero with no result without a CUDA card, when a module of JAX or of the
JAX package is loaded, or when the program is missing.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from benchmark import registry  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "urh_tpu")
TRACE_S = 3.0  # the traced stretch of a --trace 1 window


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class Tracer:
    """torch.profiler over a stretch of the window, marked ``bench.window``."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.trace = None
        self._prof = self._mark = None
        self.t0 = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self):
        import torch

        self._prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark = torch.profiler.record_function("bench.window")
        self._mark.__enter__()
        self.t0 = time.perf_counter()

    def warm(self):
        """Start and stop the profiler once, before the program runs: its
        first start initializes the device tracing, which can take seconds."""
        import torch

        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()

    def due(self) -> bool:
        return self.active and time.perf_counter() - self.t0 >= self.seconds

    def stop(self):
        import torch

        from benchmark.chrome_trace import Trace

        if not self.active:
            return
        torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        folder = tempfile.mkdtemp(prefix="bench_trace_")
        try:
            path = os.path.join(folder, "trace.json")
            self._prof.export_chrome_trace(path)
            self.trace = Trace.load(path)
        finally:
            shutil.rmtree(folder, ignore_errors=True)
        self._prof = None


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = "nvidia-smi not readable"
    return f"card: {out}"


class Context:
    """What a per-layer metric's reader reads: the trace and the cell's counters."""

    def __init__(self, trace, counters: dict):
        self.trace, self.counters = trace, counters


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench = registry.benchmark()
    wl = registry.workload(bench, args.workload)
    cfg = registry.config(bench, wl["config"])
    traffic = registry.traffic(wl["traffic"])
    limits = registry.limits(wl["name"])
    e2e, layer = registry.cell_metrics(bench, wl["name"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"no result: the cell needs {wl['chips']} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell = registry.driver(traffic["driver"]).Cell(cfg, traffic, args.seed, "cuda",
                                                   args.seconds)
    tracer = None
    if args.trace:
        tracer = Tracer(min(TRACE_S, args.seconds))
        tracer.warm()
    try:
        cell.setup()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - T_START
        gc.collect()  # the set-up's garbage is not collected inside the window
        result = cell.window(args.seconds, tracer)
        if tracer is not None:
            tracer.stop()
        torch.cuda.synchronize()
        peak = max(torch.cuda.max_memory_allocated(d) for d in range(int(wl["chips"])))
        kind = torch.cuda.get_device_name(0)
        cell.release()
        check = cell.check(limits)
    finally:
        cell.close()
    found = forbidden_modules()
    if found:
        print(f"no result: the run loaded {found}", file=sys.stderr)
        return 3

    print(f"launches: {json.dumps(result['launches'], sort_keys=True)}", flush=True)
    if check.get("notes"):
        print(f"notes: {json.dumps(check['notes'], sort_keys=True)}", flush=True)
    print(card_line(), flush=True)
    device = {"platform": "gpu", "kind": kind, "count": int(wl["chips"]),
              "memory_peak_bytes": int(peak)}
    metrics, extra = {}, {}
    if args.trace:
        trace = tracer.trace
        ctx = Context(trace, result["counters"])
        for m in layer:
            value = registry.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=trace.busy_s(), window_s=trace.window_s)
        extra["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
    else:
        values = dict(result["e2e"], **check.get("e2e", {}), setup_s=setup_s)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    line = {"correct": check["correct"], "attempted": check["attempted"],
            "failed": check["failed"], "metrics": metrics, "device": device, **extra,
            "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in check["numbers"].items()}}
    for k, (v, lim) in check["numbers"].items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
