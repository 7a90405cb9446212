"""Reading a ``torch.profiler`` Chrome trace: the benchmark's spans, the
device's kernels, copies and sets, and which kernels a span launched.

The harness marks the traced stretch with a span named ``bench.window`` and
each call into a layer with a span of its own (``torch.profiler.
record_function``).  A kernel belongs to the span in which the host launched
it (the runtime call and the kernel share a correlation id), whenever it ran.
"""

from __future__ import annotations

import json
from collections import defaultdict

from benchmark import yardstick

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Trace:
    def __init__(self, events: list):
        self.device, self.kernels, self.spans = [], [], []
        self.launch_ts = {}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, ts, dur = e.get("cat"), float(e["ts"]), float(e["dur"])
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e.get("name", "?"), cat))
                if cat == "kernel":
                    self.kernels.append((ts, ts + dur, e.get("args", {}).get("correlation")))
            elif cat == "user_annotation":
                self.spans.append((e.get("name", "?"), ts, ts + dur))
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.launch_ts[corr] = ts
        window = [s for s in self.spans if s[0] == WINDOW]
        if window:
            self.t0, self.t1 = window[0][1], window[0][2]
        else:
            stamps = [a for a, _, _, _ in self.device] + [a for _, a, _ in self.spans]
            self.t0 = min(stamps, default=0.0)
            self.t1 = max([b for _, b, _, _ in self.device] + [b for _, _, b in self.spans],
                          default=0.0)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def named(self, name: str) -> list:
        """[(start, end)] in microseconds of the spans of that name inside
        the window."""
        return [(a, b) for n, a, b in self.spans if n == name and a >= self.t0 and b <= self.t1]

    def busy_s(self) -> float:
        """Seconds of the window in which a kernel, copy or set ran."""
        return yardstick.union_seconds(
            (max(a, self.t0), min(b, self.t1)) for a, b, _, _ in self.device
            if b > self.t0 and a < self.t1) * 1e-6

    def kernel_s_launched_in(self, name: str) -> float:
        """Device seconds of the kernels launched inside spans of that name."""
        spans = sorted(self.named(name))
        if not spans:
            return 0.0
        total = 0.0
        for a, b, corr in self.kernels:
            t = self.launch_ts.get(corr)
            if t is not None and any(s <= t <= e for s, e in spans):
                total += b - a
        return total * 1e-6

    def device_ops(self, top: int = 10) -> list:
        by_name = defaultdict(float)
        for a, b, name, _ in self.device:
            if b > self.t0 and a < self.t1:
                by_name[name] += (min(b, self.t1) - max(a, self.t0)) * 1e-6
        return sorted(([n, s] for n, s in by_name.items()), key=lambda r: -r[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest stretches with nothing on the device, each named by the
        innermost benchmark span that covers its middle."""
        out = []
        for a, b in yardstick.gaps([(x, y) for x, y, _, _ in self.device], self.t0, self.t1):
            mid = (a + b) / 2
            covering = [(e - s, n) for n, s, e in self.spans
                        if s <= mid <= e and n != WINDOW]
            out.append([min(covering)[1] if covering else "outside the benchmark's spans",
                        (b - a) * 1e-6])
        return sorted(out, key=lambda r: -r[1])[:top]
