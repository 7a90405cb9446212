"""Live sniffing, open loop: the port's ``ProtocolSniffer`` on the card
behind a Network SDR in raw mode on a free port, fed by a sender process
(:mod:`benchmark.gen.sender`) that writes the configuration's stream in
blocks due on a fixed schedule, whatever the sniffer does.

End to end: ``msg_latency_p95_ms``, the 95th percentile over every message
whose last sample was due in the window, from that due time to the
sniffer's ``message_sniffed`` event.  The receive ring keeps its default
size and wraps as URH's does (C5): the reference follows it
(:mod:`benchmark.reference.ring`) from the sizes of the batches the receive
server wrote, and ``failed`` counts the frames due in the window whose bits
did not come out as sent.

Two sizes come from the program: the batches (one a ``recv``) and the
drains, where the sniffer cut the stream into chunks; a segment's place
depends on both, so the reference takes them.  They are checked on their
own (``ring_mismatch``): the batches tile exactly the samples the sender
sent, none holds more than one ``recv`` of the traffic's size, the ring has
the traffic's size, the wraps are as many as the samples sent and that size
allow and end where the program's write index stands, and the drains tile
exactly the samples the ring model says were fed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

from benchmark import registry, yardstick
from benchmark.drivers import common
from benchmark.gen import signals
from benchmark.reference import demod, precision, ring
from benchmark.reference import stream as ref_stream

DRAIN_WAIT_S = 60.0


def sleep_until(t: float):
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, seconds: float):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.seconds = seconds
        self.params = dict(cfg["known_params"])
        self.rate = float(cfg["sample_rate"])
        self.block = int(round(self.rate * traffic["block_s"]))
        self.period = int(round(self.rate * traffic["period_s"]))
        self.sniffer = self.proc = None
        self.batches, self.drains, self.segments, self.emits = [], [], [], []
        self.messages, self.sender = [], {}
        self.ring_size = self.final_index = 0
        self.t0 = self.ws = self.we = 0.0
        self.cfg_ref = cfg["name"]  # how the sender finds the configuration
        self._ref = None

    # -- set-up ------------------------------------------------------------
    def setup(self):
        import urh_tpu_torch as ut
        from urh_tpu_torch.dev.backend_handler import BackendHandler
        from urh_tpu_torch.protocol.sniffer import ProtocolSniffer

        # load the kernels and the card before any traffic: a stream fed a
        # second of this configuration's samples in the sniffer's drain sizes
        warm = signals.Stream(self.cfg, [self.seed, 1], self.period).render(0, self.period)
        sd = ut.StreamDemodulator(common.demod_params(self.params, self.rate), device=self.device)
        drain = max(1, int(self.rate * 0.01))
        for a in range(0, len(warm), drain):
            sd.feed(signals.quantize(self.cfg, warm[a:a + drain]))
        sd.flush()

        p = self.params
        sn = ProtocolSniffer(p["samples_per_symbol"], p["center"], 0.1, p["noise_threshold"],
                             p["tolerance"], p["modulation"], 1, "Network SDR",
                             BackendHandler(), network_raw_mode=True,
                             compute_device=self.device)
        self.sniffer = sn
        ingest, emit = sn._ingest, sn._emit_segments

        def counted_ingest(chunk):
            self.drains.append(len(chunk))
            ingest(chunk)

        def recorded_emit(segments):
            self.segments += [(s.start_sample, s.num_samples, s.ppseq.copy()) for s in segments]
            emit(segments)

        sn._ingest, sn._emit_segments = counted_ingest, recorded_emit
        sn.message_sniffed.connect(lambda _: self.emits.append(time.monotonic()))
        sn.rcv_device.set_server_port(0)
        sn.sniff()
        self.ring_size = len(sn.rcv_device.data)
        server = sn.rcv_device.underlying_device.server
        sink = server.sink

        def counted_sink(frames):
            self.batches.append(len(frames))
            sink(frames)

        server.sink = counted_sink  # each connection's handler reads it when it starts
        port = sn.rcv_device.underlying_device.server_port
        t = self.traffic
        self.t0 = time.monotonic() + t["lead_s"]
        self.ws = self.t0 + t["warm_s"]
        self.stop_s = t["warm_s"] + self.seconds + t["tail_s"]
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "benchmark.gen.sender", "--config", self.cfg_ref,
             "--seed", str(self.seed), "--port", str(port), "--t0", repr(self.t0),
             "--stop", repr(self.stop_s), "--block-s", repr(t["block_s"]),
             "--period-s", repr(t["period_s"])],
            cwd=registry.ROOT, stdout=subprocess.PIPE, text=True)
        sleep_until(self.ws)

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float, tracer=None) -> dict:
        from urh_tpu_torch.util.metrics import metrics

        self.we = self.ws + seconds
        counts = common.reset_launches()
        metrics.clear()
        if tracer is not None:
            tracer.start()
            sleep_until(time.monotonic() + tracer.seconds)
            tracer.stop()
        sleep_until(self.we)
        report = metrics.report().get("sniffer.demodulate", {})
        launches = common.read_launches(counts)
        out, _ = self.proc.communicate(timeout=self.stop_s + 120)
        self.proc = None
        self.sender = json.loads(out.strip().splitlines()[-1])
        sent = self.sender["blocks"] * self.sender["block_samples"]
        dev = self.sniffer.rcv_device
        deadline = time.monotonic() + DRAIN_WAIT_S
        while not (sum(self.batches) == sent and self.sniffer.drain_position == dev.current_index):
            if time.monotonic() > deadline:
                raise RuntimeError(f"live: {sum(self.batches)} of {sent} samples received, "
                                   f"drained to {self.sniffer.drain_position}")
            time.sleep(0.01)
        self.final_index = dev.current_index
        self.sniffer.stop()
        self.messages = [(common.bits_text(m.plain_bits.plane.tobytes()), int(m.pause))
                         for m in self.sniffer.messages]
        lags = [lag for k, lag in enumerate(self.sender["lag_s"])
                if self.ws <= self.t0 + (k + 1) * self.traffic["block_s"] < self.we]
        counters = {"gen_lag_p95_ms": yardstick.percentile(lags, 95) * 1e3 if lags else None,
                    "feed_ms": (report["seconds"] / report["calls"] * 1e3
                                if report.get("calls") else None)}
        return {"e2e": {}, "launches": launches, "counters": counters}

    def release(self):
        import torch

        self.sniffer = None
        torch.cuda.empty_cache()

    def close(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if self.sniffer is not None and self.sniffer.is_running:
            self.sniffer.stop()

    # -- the check -------------------------------------------------------------
    def due(self, sent_sample: int) -> float:
        return self.t0 + (sent_sample // self.block + 1) * self.traffic["block_s"]

    def _states(self, x: np.ndarray, rounding=None) -> np.ndarray:
        p = self.params
        return demod.states(x, p["noise_threshold"], p["center"], p["modulation"],
                            rounding=rounding)

    def reference(self, rounding=None) -> dict:
        """The sniffer's segments and messages as URH's semantics give them on
        the samples the ring fed; at full precision also the messages of the
        stream as sent."""
        if rounding is None and self._ref is not None:
            return self._ref
        sent = sum(self.batches)
        clean = signals.quantize(self.cfg, signals.Stream(self.cfg, self.seed, self.period)
                                 .render(0, sent))
        clean_states = self._states(clean, rounding)
        pieces = ring.fed_pieces(self.batches, int(self.traffic["ring_samples"]))
        segs = ref_stream.segments(self._fed_states(clean, clean_states, pieces, rounding),
                                   self.drains, self.params)
        out = {"pieces": pieces, "segments": [(a, n, r.tolist()) for a, n, r in segs],
               "messages": ref_stream.messages(segs, self.params)}
        if rounding is None:
            out["ideal"] = ref_stream.messages(
                ref_stream.segments(clean_states, [sent], self.params), self.params)
            self._ref = out
        return out

    def _fed_states(self, clean, clean_states, pieces: list, rounding) -> np.ndarray:
        """The states of the samples the ring fed, from those of the stream
        as sent: a state depends on its sample and the one fed before it, so
        only the first sample after a splice, and the stale zeros, are
        worked out again."""
        parts, prev, after = [], None, 0
        for o, n in pieces:
            x = np.zeros((n, 2), clean.dtype) if o is None else clean[o:o + n]
            if o is not None and (o == after and (o > 0 or prev is None)):
                parts.append(clean_states[o:o + n])
            elif prev is None:
                parts.append(self._states(x, rounding))
            else:
                parts.append(self._states(np.concatenate((prev, x)), rounding)[1:])
            prev = x[-1:]
            after = None if o is None else o + n
        return np.concatenate(parts) if parts else np.zeros(0, np.int8)

    def control(self, limits: dict) -> dict:
        """The reference one precision below the stream's, on the samples the
        ring fed, in the program's place, judged as the program is."""
        low, rounding = precision.lower(self.cfg["sample_format"])
        if low(np.zeros((1, 2), np.float32)).dtype != np.float32:
            raise ValueError("the live control handles float32 streams")
        got = self.reference(rounding=rounding)
        ref = self.reference()
        return compare(got["segments"], [(b, p) for b, p, _, _ in got["messages"]], ref, limits,
                       self.ring_mismatch(ref["pieces"]))

    def ring_mismatch(self, pieces: list) -> int:
        """The program's sizes against what the sender and the traffic state:
        the count of samples, and of conditions, that disagree."""
        size = int(self.traffic["ring_samples"])
        frame = 2 * (4 if self.cfg["sample_format"] == "float32" else 1)
        most = (int(self.traffic["recv_bytes"]) + frame - 1) // frame
        sent = self.sender["blocks"] * self.sender["block_samples"]
        wraps = ring.wraps(self.batches, size)
        lo, hi = -(-sent // size) - 1, sent // (size - most)
        return (abs(sum(self.batches) - sent) + abs(self.ring_size - size)
                + abs(sum(self.drains) - sum(n for _, n in pieces))
                + abs(self.final_index - ring.final_index(self.batches, size))
                + sum(n > most for n in self.batches) + int(not lo <= wraps <= hi))

    def check(self, limits: dict) -> dict:
        ref = self.reference()
        out = compare([(int(a), int(n), rows.tolist()) for a, n, rows in self.segments],
                      self.messages, ref, limits, self.ring_mismatch(ref["pieces"]))
        pieces = ref["pieces"]
        lat = []
        ends = [ring.sent_position(pieces, end - 1) for _, _, _, end in ref["messages"]]
        for i, s in enumerate(ends):
            due = self.due(s)
            if self.ws <= due < self.we and i < len(self.emits):
                lat.append(self.emits[i] - due)
        got = {(bits, s) for (bits, _), s in zip(self.messages, ends)}
        attempted = failed = 0
        for bits, _, _, end in ref["ideal"]:
            if self.ws <= self.due(end - 1) < self.we:
                attempted += 1
                failed += (bits, end - 1) not in got
        out["attempted"], out["failed"] = attempted, failed
        out["correct"] = out["correct"] and attempted > 0 and len(lat) > 0
        out["e2e"] = {"msg_latency_p95_ms": yardstick.percentile(lat, 95) * 1e3 if lat else None}
        out["notes"] = {"ring_wraps": ring.wraps(self.batches, self.ring_size),
                        "ring_samples": self.ring_size, "largest_batch": max(self.batches),
                        "frames_spoiled": failed, "drains": len(self.drains),
                        "samples_fed": sum(self.drains), "samples_sent": sum(self.batches)}
        return out


def compare(segments: list, messages: list, ref: dict, limits: dict,
            ring_mismatch: int) -> dict:
    """output_mismatch: the segments (their place in the stream and pulse
    rows) and the messages (bits and pause) that differ from the
    reference's, or are missing or extra.  A lower precision moves pulse
    edges, which the segments show and the bits mostly do not; the bits are
    the user's answer.  ring_mismatch: see :meth:`Cell.ring_mismatch`."""
    s = common.sequence_mismatch(segments, ref["segments"])
    m = common.sequence_mismatch(messages, [(b, p) for b, p, _, _ in ref["messages"]])
    return common.verdict({"output_mismatch": s + m, "ring_mismatch": ring_mismatch}, limits,
                          attempted=len(ref["messages"]), failed=0)
