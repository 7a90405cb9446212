"""Closed-loop channel isolation in a band's recordings, as a user who
selects one system's band in URH's spectrogram, band-pass filters it into a
new signal and opens that with the modulation set: each analysis makes a
fresh ``Signal`` of a capture in host memory with the modulation set, runs
``Signal.bandpass`` over the traffic's band, then
``auto_detect(detect_modulation=False, detect_noise=True)`` and
``demodulate`` on the filtered signal.  The captures rotate
(:mod:`benchmark.drivers.analyze`).

The captures are :mod:`benchmark.gen.srd868`'s.  On a CPU device (the
rehearsals) the traffic's ``cpu`` entries replace its own.

Checked against the plain reference (:mod:`benchmark.reference.channel`):
``filter_err``, the largest gap between the program's filtered samples and
the reference filter's (float64) over the checked captures, relative to
the reference's largest magnitude; then the analysis of each checked
capture's filtered samples as the FSK analyze cell is judged
(:func:`benchmark.drivers.analyze.compare`), against the reference's
analysis of the samples the program filtered.
"""

from __future__ import annotations

from benchmark.drivers import analyze, common
from benchmark.gen import srd868
from benchmark.reference import channel, precision


class Cell(analyze.Cell):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, seconds: float):
        if str(device) == "cpu":
            traffic = dict(traffic, **traffic.get("cpu", {}))
        super().__init__(cfg, traffic, seed, device, seconds)
        self.filtered = {}  # capture index -> the filtered planes of its first analysis
        self._keeping = False
        self._filter_refs = {}

    def setup(self):
        n, octets = int(self.traffic["capture_samples"]), int(self.traffic["data_psdu_octets"])
        self.captures = [srd868.capture(self.cfg, [self.seed, i], n, octets, layout=i)[0]
                         for i in range(int(self.traffic["captures"]))]
        for x in self.captures[:int(self.traffic.get("warm_captures", 1))]:
            self._analyze(x)

    def band(self) -> tuple:
        t = self.traffic
        return float(t["f_low"]), float(t["f_high"]), float(t["filter_bw"])

    def _analyze(self, x):
        import torch

        import urh_tpu_torch as ut

        sig = ut.Signal.from_iq(x, sample_rate=self.cfg["sample_rate"],
                                modulation=self.traffic["modulation"], device=self.device)
        with torch.profiler.record_function("bench.bandpass"):
            filtered = sig.bandpass(*self.band())
        with torch.profiler.record_function("bench.estimate"):
            found = filtered.auto_detect(detect_modulation=False, detect_noise=True)
        with torch.profiler.record_function("bench.demodulate"):
            msgs = ut.demodulate(filtered)
        if self._keeping:
            i = next(k for k, c in enumerate(self.captures) if c is x)
            self.filtered.setdefault(i, filtered.iq_array.data)
        return filtered, found, msgs

    def window(self, seconds: float, tracer=None) -> dict:
        """The analyze window, keeping each capture's filtered samples from
        its first analysis in it (the analysis whose states are kept)."""
        self._keeping = True
        try:
            return super().window(seconds, tracer)
        finally:
            self._keeping = False

    def reference_filter(self, i: int):
        if i not in self._filter_refs:
            self._filter_refs[i] = channel.bandpass(self.captures[i], *self.band())
        return self._filter_refs[i]

    def reference(self, i: int):
        if i not in self._refs:
            self._refs[i] = channel.analyze(self.filtered[i], self.traffic["modulation"])
        return self._refs[i]

    def check(self, limits: dict) -> dict:
        which = self.checked({i for i, _, _ in self.results})
        results = [(i, got, [(common.bits_text(b), pause, tuple(pos)) for b, pause, pos in msgs])
                   for i, got, msgs in self.results if i in which]
        err = max(channel.error(self.filtered[i], self.reference_filter(i)) for i in which)
        refs = {i: self.reference(i) for i in which}
        return compare(err, results, {i: v for i, v in self.kept.items() if i in refs}, refs,
                       self.filtered, limits)

    def control(self, limits: dict) -> dict:
        """The reference one precision below the filter's complex64
        (bfloat16: the samples, the taps and the output, then the FSK
        demodulation's intermediates) in the program's place, judged as the
        program is."""
        _, rounding = precision.lower("float32")
        mod = self.traffic["modulation"]
        results, kept, refs, planes, err = [], {}, {}, {}, 0.0
        for i in self.checked(range(len(self.captures))):
            low = channel.bandpass(self.captures[i], *self.band(), rounding=rounding)
            err = max(err, channel.error(low, self.reference_filter(i)))
            planes[i] = channel.planes(low)
            params, res = channel.analyze(planes[i], mod, rounding=rounding)
            got = ((True, params["modulation"], params["samples_per_symbol"], params["center"],
                    params["tolerance"], params["noise"]) if params is not None
                   else (False, None, 0, 0.0, 0, 0.0))
            results.append((i, got, [m[:2] + (m[4],) for m in res["messages"]]))
            kept[i] = (res["states"], res["rect"])
            refs[i] = channel.analyze(planes[i], mod)
        return compare(err, results, kept, refs, planes, limits)


def compare(filter_err: float, results: list, kept: dict, refs: dict, planes: dict,
            limits: dict) -> dict:
    """The numbers that decide ``correct``, each beside its limit:
    ``filter_err`` and :func:`benchmark.drivers.analyze.compare`'s numbers
    of the analyses of the filtered samples (``planes``, by capture)."""
    rest = {k: v for k, v in limits.items() if k != "filter_err"}
    judged = analyze.compare(results, kept, refs, planes, rest)
    numbers = {"filter_err": filter_err, **{k: v for k, (v, _) in judged["numbers"].items()}}
    return common.verdict(numbers, limits, attempted=judged["attempted"],
                          failed=judged["failed"])
