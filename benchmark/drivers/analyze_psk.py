"""Closed-loop analysis of PSK captures at the modulation a user sets, as in
URH when auto-detection misreads the signal: each analysis makes a fresh
``Signal`` of a capture in host memory with the modulation set, runs
``auto_detect(detect_modulation=False, detect_noise=True)`` and
``demodulate``.  The captures rotate (:mod:`benchmark.drivers.analyze`).

The captures are :mod:`benchmark.gen.ieee802154`'s, of the traffic's
length and data frames.  On a CPU device (the rehearsals) the traffic's
``cpu`` entries replace its own: the port's plain Costas loop steps a
sample in about 65 us there, so those captures hold one short exchange.

Checked against the plain reference (:mod:`benchmark.reference.psk`) as
the FSK and OOK cells are, with two numbers sized for the Costas loop
(:func:`compare`): the card's sine and cosine and the C library's differ
in the last bit for some phases, and the loop carries each such step on,
so the demodulated values differ by a little everywhere.
"""

from __future__ import annotations

import numpy as np

from benchmark.drivers import analyze, common
from benchmark.gen import ieee802154
from benchmark.reference import demod, precision, psk


class Cell(analyze.Cell):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, seconds: float):
        if str(device) == "cpu":
            traffic = dict(traffic, **traffic.get("cpu", {}))
        super().__init__(cfg, traffic, seed, device, seconds)

    def setup(self):
        n, octets = int(self.traffic["capture_samples"]), int(self.traffic["data_psdu_octets"])
        self.captures = [ieee802154.capture(self.cfg, [self.seed, i], n, octets, layout=i)[0]
                         for i in range(int(self.traffic["captures"]))]
        for x in self.captures[:int(self.traffic.get("warm_captures", 1))]:
            self._analyze(x)

    def _analyze(self, x):
        import torch

        import urh_tpu_torch as ut

        sig = ut.Signal.from_iq(x, sample_rate=self.cfg["sample_rate"],
                                modulation=self.traffic["modulation"], device=self.device)
        with torch.profiler.record_function("bench.estimate"):
            found = sig.auto_detect(detect_modulation=False, detect_noise=True)
        with torch.profiler.record_function("bench.demodulate"):
            msgs = ut.demodulate(sig)
        return sig, found, msgs

    def window(self, seconds: float, tracer=None) -> dict:
        """The analyze window, with ``costas_steps``: the Costas loop's
        steps of the traced analyses (the first ones of the window), each
        ungated sample but a capture's first once for each of the two
        passes an analysis makes, at the noise the analysis found."""
        out = super().window(seconds, tracer)
        steps = 0
        for i, got, _ in self.results[:out["counters"]["traced_analyses"]]:
            x = self.captures[i][1:].astype(np.float32)
            mag2 = x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]
            steps += 2 * int(np.count_nonzero(mag2 > np.float32(got[5] * got[5])))
        out["counters"]["costas_steps"] = steps
        return out

    def reference(self, i: int):
        if i not in self._refs:
            self._refs[i] = psk.analyze(self.captures[i])
        return self._refs[i]

    def check(self, limits: dict) -> dict:
        which = self.checked({i for i, _, _ in self.results})
        results = [(i, got, [(common.bits_text(b), pause, tuple(pos)) for b, pause, pos in msgs])
                   for i, got, msgs in self.results if i in which]
        refs = {i: self.reference(i) for i in which}
        return compare(results, {i: v[1] for i, v in self.kept.items() if i in refs}, refs,
                       self.captures, limits)

    def control(self, limits: dict) -> dict:
        """The reference one precision below the capture's (int8 -> int4)
        in the program's place, judged as the program is."""
        low, _ = precision.lower(self.cfg["sample_format"])
        results, kept, refs = [], {}, {}
        for i in self.checked(range(len(self.captures))):
            params, res = psk.analyze(low(self.captures[i]))
            got = ((True, params["modulation"], params["samples_per_symbol"], params["center"],
                    params["tolerance"], params["noise"]) if params is not None
                   else (False, None, 0, 0.0, 0, 0.0))
            results.append((i, got, [m[:2] + (m[4],) for m in res["messages"]]))
            kept[i] = res["rect"]
            refs[i] = self.reference(i)
        return compare(results, kept, refs, self.captures, limits)


def compare(results: list, qads: dict, refs: dict, captures: list, limits: dict) -> dict:
    """The numbers that decide ``correct``, each beside its limit, as
    :func:`benchmark.drivers.analyze.compare` takes them (param_mismatch,
    center_err, noise_rel_err, msg_mismatch), with the states and the
    demodulated values of each capture's first analysis judged so:

    * qad_err: the largest gap between the program's demodulated values
      and the reference's, over every sample (a gated sample is the
      sentinel on both sides: the gate reads the raw samples);
    * state_mismatch: the states (the program's values against its center)
      that differ from the reference's where the reference's value lies
      farther than qad_err's limit from the center: nearer, a gap within
      the limit may put it on either side, and the reference's messages
      then follow the program's states.
    """
    slack = limits.get("center_err", 0.0)
    band = limits["qad_err"]
    firsts = {}
    for i, got, _ in results:
        firsts.setdefault(i, got)
    expected, state_mismatch, qad_err = {}, 0, 0.0
    for i, (params, res) in refs.items():
        at = dict(params or psk.DEFAULTS, pause_threshold=8)
        got = firsts.get(i)
        cand = analyze.judged_by(params, got)
        if cand is not None:
            at.update(samples_per_symbol=cand["samples_per_symbol"], tolerance=cand["tolerance"])
            if analyze.outside(cand["center_band"], got[3]) <= slack:
                at["center"] = got[3]
        same = params is None or all(at[k] == params[k] for k in
                                     ("center", "samples_per_symbol", "tolerance"))
        want = res if same else demod.demodulate(captures[i], at, rect=res["rect"])
        rect, want_states = want["rect"], want["states"]
        qad = qads.get(i)
        if qad is None or len(qad) != len(rect):
            qad_err, state_mismatch = float("inf"), state_mismatch + len(rect)
            prog = want_states
        else:
            qad_err = max(qad_err, float(np.max(np.abs(qad - rect))))
            states = demod.states_of(qad, at["center"], "PSK")
            near = ((np.abs(rect - np.float32(at["center"])) <= band)
                    & (rect != demod.FSK_SENTINEL))
            state_mismatch += int(np.count_nonzero((states != want_states) & ~near))
            prog = np.where(near, states, want_states)
        if (prog != want_states).any():
            sps = int(at["samples_per_symbol"])
            pp = demod.pulses_of_states(prog, int(at["tolerance"]), False, sps, at["center"])
            expected[i] = [m[:2] + (m[4],) for m in demod.messages_of_pulses(pp, sps, 8)]
        else:
            expected[i] = [m[:2] + (m[4],) for m in want["messages"]]
    param_mismatch = msg_mismatch = failed = 0
    center_err = noise_err = 0.0
    for i, got, msgs in results:
        params = refs[i][0]
        cand = analyze.judged_by(params, got)
        bad = (params is not None) != bool(got[0]) or (params is not None and cand is None)
        if got[0] and params is not None and got[1] == params["modulation"]:
            center_err = max(center_err, analyze.outside((cand or params)["center_band"], got[3]))
            noise_err = max(noise_err, abs(got[5] - params["noise"]) / max(params["noise"], 1e-12))
        param_mismatch += bad
        m = common.sequence_mismatch(msgs, expected[i])
        msg_mismatch = max(msg_mismatch, m)
        failed += bool(bad or m)
    numbers = {"param_mismatch": param_mismatch, "center_err": center_err,
               "noise_rel_err": noise_err, "msg_mismatch": msg_mismatch,
               "state_mismatch": state_mismatch, "qad_err": qad_err}
    return common.verdict(numbers, limits, attempted=len(results), failed=failed)
