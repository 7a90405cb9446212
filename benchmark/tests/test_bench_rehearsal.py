"""Every cell rehearsed small on the CPU through its driver, its check and
its control; planted faults of the timed path turn ``correct`` false; a
rehearsal loads no JAX; one run on the card when there is one."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest

from benchmark import registry
from benchmark.tests.helpers import CELLS, LIVE_CELLS, rehearse, small_live


@pytest.mark.parametrize("workload", CELLS)
def test_each_offline_cell_runs_small_and_matches_the_reference(workload):
    _, result, check = rehearse(workload)
    assert check["correct"], check
    assert check["attempted"] >= 1 and check["failed"] == 0
    assert all(v > 0 for v in result["e2e"].values())


@pytest.mark.parametrize("workload", LIVE_CELLS)
def test_the_live_cell_runs_small_through_a_wrapping_ring(workload, tmp_path, monkeypatch):
    cfg, path, traffic = small_live(workload, tmp_path, monkeypatch)
    traffic = dict(traffic, warm_s=1.0, tail_s=0.5)
    cell, result, check = rehearse(workload, seconds=2.0, cfg=cfg, cfg_ref=path,
                                   traffic=traffic)
    assert check["correct"], check
    assert check["numbers"]["ring_mismatch"] == (0, 0)
    assert check["notes"]["ring_wraps"] >= 1
    assert check["notes"]["samples_fed"] > check["notes"]["samples_sent"]
    assert check["attempted"] >= 4 and check["e2e"]["msg_latency_p95_ms"] > 0
    assert result["counters"]["feed_ms"] > 0 and result["counters"]["gen_lag_p95_ms"] is not None


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_one_precision_lower_is_not_correct(workload):
    _, _, check = rehearse(workload, control=True)
    assert not check["correct"], check


def flip_first_bit(real):
    def altered(ppseq, *args, **kwargs):
        bits, pauses, pos = real(ppseq, *args, **kwargs)
        if bits:
            bits[0][0] ^= 1
        return bits, pauses, pos
    return staticmethod(altered)


def plant(monkeypatch, fault: str, kind: str):
    from urh_tpu_torch.core.signal import Signal
    from urh_tpu_torch.protocol.analyzer import ProtocolAnalyzer
    from urh_tpu_torch.protocol.sniffer import ProtocolSniffer
    from urh_tpu_torch.protocol.stream import StreamDemodulator

    if fault == "answer_altered":
        monkeypatch.setattr(ProtocolAnalyzer, "_ppseq_to_bits",
                            flip_first_bit(ProtocolAnalyzer._ppseq_to_bits))
    elif fault == "state_unchanged" and kind == "analyze":
        monkeypatch.setattr(Signal, "auto_detect", lambda self, **kw: True)
    elif fault == "state_unchanged":
        monkeypatch.setattr(StreamDemodulator, "feed", lambda self, chunk: [])
        monkeypatch.setattr(StreamDemodulator, "flush", lambda self: [])
    elif fault == "half_left_out" and kind == "analyze":
        real = ProtocolAnalyzer.get_protocol_from_signal

        def half(self):
            real(self)
            self.messages[:] = self.messages[::2]
            return self.messages
        monkeypatch.setattr(ProtocolAnalyzer, "get_protocol_from_signal", half)
    elif fault == "half_left_out":
        real, seen = ProtocolSniffer._emit_segments, []

        def every_other(self, segments):
            kept = []
            for seg in segments:
                seen.append(seg)
                if len(seen) % 2:
                    kept.append(seg)
            return real(self, kept)
        monkeypatch.setattr(ProtocolSniffer, "_emit_segments", every_other)


FAULTS = ("state_unchanged", "half_left_out", "answer_altered")


def kind(workload: str) -> str:
    w = registry.workload(registry.benchmark(), workload)
    return registry.traffic(w["traffic"])["driver"]


# one cell of each driver: the faults are planted in what the drivers share
FAULT_CELLS = sorted({kind(w): w for w in CELLS}.values())


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", FAULT_CELLS)
def test_a_planted_fault_turns_correct_false(monkeypatch, workload, fault):
    plant(monkeypatch, fault, kind(workload))
    _, _, check = rehearse(workload)
    assert not check["correct"], (fault, check)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", LIVE_CELLS)
def test_a_planted_fault_in_the_live_path_turns_correct_false(monkeypatch, tmp_path, workload,
                                                              fault):
    cfg, path, traffic = small_live(workload, tmp_path, monkeypatch)
    plant(monkeypatch, fault, "live")
    traffic = dict(traffic, warm_s=0.5, tail_s=0.5)
    _, _, check = rehearse(workload, seconds=1.5, cfg=cfg, cfg_ref=path, traffic=traffic)
    assert not check["correct"], (fault, check)


def test_a_rehearsal_loads_neither_jax_nor_the_jax_package():
    code = ("from benchmark.tests.helpers import rehearse\n"
            "from benchmark.run import forbidden_modules\n"
            f"rehearse({CELLS[0]!r}, seconds=0.5)\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.card
def test_one_run_on_the_card_prints_the_result_line(card):
    workload = CELLS[0]
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload,
                          "--seed", str(2**31 + 11), "--seconds", "2", "--trace", "0"],
                         cwd=registry.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"] is True
    e2e, _ = registry.cell_metrics(registry.benchmark(), workload)
    assert set(line["metrics"]) == {m["name"] for m in e2e}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert all(np.isfinite(m["value"]) for m in line["metrics"].values())


@pytest.mark.parametrize("workload", LIVE_CELLS)
def test_a_ring_that_wraps_early_fails_the_ring_check(monkeypatch, tmp_path, workload):
    from urh_tpu_torch.dev.network_sdr import SampleSink

    def early(self, frames):
        n = len(frames)
        if n == 0:
            return
        if self.write_index + n >= 0.9 * len(self.buffer):
            self.write_index = 0
        self.buffer[self.write_index:self.write_index + n] = frames
        self.write_index += n

    cfg, path, traffic = small_live(workload, tmp_path, monkeypatch)
    monkeypatch.setattr(SampleSink, "__call__", early)
    traffic = dict(traffic, warm_s=0.5, tail_s=0.5)
    _, _, check = rehearse(workload, seconds=1.5, cfg=cfg, cfg_ref=path, traffic=traffic)
    assert check["numbers"]["ring_mismatch"][0] > 0 and not check["correct"], check
