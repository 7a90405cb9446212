"""Closed-loop capture analysis, as a user opening captures with automatic
parameter detection: each analysis makes a fresh ``Signal`` of a capture in
host memory, runs ``auto_detect(detect_noise=True)`` and ``demodulate``.
The captures rotate, so nothing one analysis leaves cached serves the next.

End to end: ``analyze_s``, the window over the analyses completed in it.
Checked against the plain reference (:mod:`benchmark.reference.estimate`),
once the window has closed, on a sample of the captures drawn from the
seed: every analysis's parameters and messages, and of each capture's first
analysis the symbol states and, for float32 captures, the demodulated values
that the timed path produced.  The estimate is checked by itself; the
demodulation is checked at the center the program estimated, wherever that
lies in the band of centers a rounding of the demodulated values can give.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.drivers import common
from benchmark.gen import signals
from benchmark.reference import demod, precision
from benchmark.reference import estimate as ref_estimate

# a demodulated value this near the center may round to either side of it:
# float32 arctangents differ by an ulp or two between implementations
NEAR_CENTER = 1e-6


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, seconds: float):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.seconds = seconds
        self.captures = []
        # per analysis: (capture index, (found, modulation, samples a symbol,
        # center, tolerance, noise), [(bits, pause, bit positions)])
        self.results = []
        self.kept = {}         # capture index -> (states, qad) of its first analysis
        self._refs = {}

    # -- set-up ------------------------------------------------------------
    def setup(self):
        n = int(self.traffic["capture_samples"])
        self.captures = [signals.capture(self.cfg, [self.seed, i], n, layout=i)[0]
                         for i in range(int(self.traffic["captures"]))]
        for x in self.captures[:int(self.traffic.get("warm_captures", 1))]:
            self._analyze(x)

    def _analyze(self, x):
        import torch

        import urh_tpu_torch as ut

        sig = ut.Signal.from_iq(x, sample_rate=self.cfg["sample_rate"], device=self.device)
        with torch.profiler.record_function("bench.estimate"):
            found = sig.auto_detect(detect_noise=True)
        with torch.profiler.record_function("bench.demodulate"):
            msgs = ut.demodulate(sig)
        return sig, found, msgs

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float, tracer=None) -> dict:
        counts = common.reset_launches()
        if tracer is not None:
            tracer.start()
        traced = 0
        t0 = time.perf_counter()
        while True:
            i = len(self.results) % len(self.captures)
            sig, found, msgs = self._analyze(self.captures[i])
            p = sig.params
            self.results.append((i, (bool(found), p.modulation, int(p.samples_per_symbol),
                                     float(p.center), int(p.tolerance),
                                     float(p.noise_threshold)),
                                 [(m.plain_bits.plane.tobytes(), int(m.pause), m.bit_sample_pos)
                                  for m in msgs]))
            if i not in self.kept:
                self.kept[i] = (sig.qad_states, sig._qad)
            if tracer is not None and tracer.active:
                traced += 1
                if tracer.due():
                    tracer.stop()
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        x = self.captures[0]
        return {"e2e": {"analyze_s": elapsed / len(self.results)},
                "launches": common.read_launches(counts),
                "counters": {"traced_analyses": traced, "capture_samples": len(x),
                             "sample_itemsize": x.dtype.itemsize}}

    def release(self):
        """Bring the kept device outputs to the host and free the program's state."""
        import torch

        self.kept = {i: (None if s is None else s.cpu().numpy().astype(np.int8),
                         None if q is None else q.cpu().numpy())
                     for i, (s, q) in self.kept.items()}
        torch.cuda.empty_cache()

    def close(self):
        pass

    # -- the check -------------------------------------------------------------
    def reference(self, i: int):
        if i not in self._refs:
            self._refs[i] = ref_estimate.analyze(self.captures[i])
        return self._refs[i]

    def checked(self, pool: list) -> list:
        """The captures whose analyses are checked: a sample of ``pool``
        drawn from the seed, so that the reference takes less time than the
        window."""
        k = min(int(self.traffic.get("check_captures", len(pool))), len(pool))
        rng = np.random.default_rng(signals.seed_words([self.seed, 2]))
        return sorted(rng.choice(sorted(pool), k, replace=False).tolist())

    def check(self, limits: dict) -> dict:
        which = self.checked({i for i, _, _ in self.results})
        results = [(i, got, [(common.bits_text(b), pause, tuple(pos)) for b, pause, pos in msgs])
                   for i, got, msgs in self.results if i in which]
        refs = {i: self.reference(i) for i in which}
        return compare(results, {i: v for i, v in self.kept.items() if i in refs}, refs,
                       self.captures, limits)

    def control(self, limits: dict) -> dict:
        """The reference one precision below the capture's, in the program's
        place, judged as the program is."""
        low, rounding = precision.lower(self.cfg["sample_format"])
        results, kept, refs = [], {}, {}
        for i in self.checked(range(len(self.captures))):
            params, res = ref_estimate.analyze(low(self.captures[i]), rounding=rounding)
            got = ((True, params["modulation"], params["samples_per_symbol"], params["center"],
                    params["tolerance"], params["noise"]) if params is not None
                   else (False, None, 0, 0.0, 0, 0.0))
            results.append((i, got, [m[:2] + (m[4],) for m in res["messages"]]))
            kept[i] = (res["states"], res["rect"])
            refs[i] = self.reference(i)
        return compare(results, kept, refs, self.captures, limits)


def compare(results: list, kept: dict, refs: dict, captures: list, limits: dict) -> dict:
    """The numbers that decide ``correct``, each beside its limit:

    * param_mismatch: analyses whose modulation, samples a symbol and
      tolerance are none that a rounding of the demodulated values can give
      the reference (its candidates), or that found parameters where it
      found none, or none where it found some;
    * center_err: how far the center lies outside the band of the candidate
      it is judged by (where both found the same modulation, as the noise
      below);
    * noise_rel_err: the largest relative gap of the noise level;
    * msg_mismatch: the most messages one analysis got wrong (bits, pause
      or a bit's sample position), against the reference demodulated at the
      program's samples a symbol and tolerance where a candidate has them,
      and at its center where that lies within center_err's limit of the
      candidate's band, else at the reference's own;
    * state_mismatch: the states of each capture's first analysis that
      differ, where the value is not within NEAR_CENTER of the center (there
      either state is right, and the reference's messages follow the
      program's);
    * qad_err: the largest gap of a demodulated value (float32 captures).
    """
    slack = limits.get("center_err", 0.0)
    firsts = {}
    for i, got, _ in results:
        firsts.setdefault(i, got)
    expected, state_mismatch, qad_err = {}, 0, 0.0
    for i, (params, res) in refs.items():
        at = dict(params or ref_estimate.DEFAULTS, pause_threshold=8)
        got = firsts.get(i)
        cand = judged_by(params, got)
        if cand is not None:
            at.update(samples_per_symbol=cand["samples_per_symbol"], tolerance=cand["tolerance"])
            if outside(cand["center_band"], got[3]) <= slack:
                at["center"] = got[3]
        same = params is None or all(at[k] == params[k] for k in
                                     ("center", "samples_per_symbol", "tolerance"))
        want = res if same else demod.demodulate(captures[i], at, rect=res["rect"])
        rect, want_states = want["rect"], want["states"]
        near = ((np.abs(rect - np.float32(at["center"])) <= NEAR_CENTER)
                & (rect != demod.sentinel(at["modulation"])))
        states, qad = kept.get(i, (None, None))
        if states is None or len(states) != len(want_states):
            state_mismatch += len(want_states)
            prog = want_states
        else:
            state_mismatch += int(np.count_nonzero((states != want_states) & ~near))
            prog = np.where(near, states, want_states)
        if (prog != want_states).any():
            sps = int(at["samples_per_symbol"])
            pp = demod.pulses_of_states(prog, int(at["tolerance"]), at["modulation"] == "ASK",
                                        sps, at["center"])
            expected[i] = [m[:2] + (m[4],) for m in demod.messages_of_pulses(pp, sps, 8)]
        else:
            expected[i] = [m[:2] + (m[4],) for m in want["messages"]]
        if params is not None and params["modulation"] == "FSK":
            qad_err = max(qad_err, float(np.max(np.abs(qad - rect)))
                          if qad is not None else float("inf"))
    param_mismatch = msg_mismatch = failed = 0
    center_err = noise_err = 0.0
    for i, got, msgs in results:
        params = refs[i][0]
        cand = judged_by(params, got)
        if params is None or not got[0]:
            bad = (params is not None) != bool(got[0])
        else:
            bad = cand is None
        if got[0] and params is not None and got[1] == params["modulation"]:
            center_err = max(center_err, outside((cand or params)["center_band"], got[3]))
            noise_err = max(noise_err, abs(got[5] - params["noise"]) / max(params["noise"], 1e-12))
        param_mismatch += bad
        m = common.sequence_mismatch(msgs, expected[i])
        msg_mismatch = max(msg_mismatch, m)
        failed += bool(bad or m)
    numbers = {"param_mismatch": param_mismatch, "center_err": center_err,
               "noise_rel_err": noise_err, "msg_mismatch": msg_mismatch,
               "state_mismatch": state_mismatch}
    if "qad_err" in limits:
        numbers["qad_err"] = qad_err
    return common.verdict(numbers, limits, attempted=len(results), failed=failed)


def outside(band: tuple, center: float) -> float:
    """How far a center lies outside a band (0 inside)."""
    lo, hi = band
    return max(0.0, lo - center, center - hi)


def judged_by(params, got):
    """The reference's candidate with the program's modulation, samples a
    symbol and tolerance whose center band lies nearest the program's
    center, or None (no such candidate, or nothing found on either side)."""
    if params is None or got is None or not got[0] or got[1] != params["modulation"]:
        return None
    same = [c for c in params["candidates"]
            if (c["samples_per_symbol"], c["tolerance"]) == (got[2], got[4])]
    return min(same, key=lambda c: outside(c["center_band"], got[3]), default=None)
