"""Running a cell small on the CPU, as a benchmark run would on the card.
The cells are BENCHMARK.json's: a cell a later change adds is rehearsed
without an edit here."""

from __future__ import annotations

import json

from benchmark import registry
from benchmark.tests.conftest import small, small_traffic

BENCH = registry.benchmark()


def driver_of(w: dict) -> str:
    return registry.traffic(w["traffic"])["driver"]


CELLS = sorted(w["name"] for w in BENCH["workloads"] if driver_of(w) != "live")
LIVE_CELLS = sorted(w["name"] for w in BENCH["workloads"] if driver_of(w) == "live")

# the live cells' rate on the CPU, and the receive ring there: a short run
# wraps it twice
LIVE_RATE = 500000
LIVE_RING = 700000


def small_live(workload: str, tmp_path, monkeypatch) -> tuple:
    """A live cell's configuration at a rate the CPU keeps up with (each
    rate scaled alike, the samples a symbol kept), 4 frames a second, the
    receive ring cut to LIVE_RING -> (configuration, its file, traffic)."""
    from urh_tpu_torch.util import settings

    w = registry.workload(BENCH, workload)
    cfg = small(w["config"])
    f = LIVE_RATE / float(cfg["sample_rate"])
    cfg = dict(cfg, sample_rate=LIVE_RATE, arrivals_per_s=4,
               **{k: cfg[k] * f for k in ("chip_rate", "deviation_hz", "carrier_offset_hz")
                  if k in cfg})
    path = tmp_path / f"{w['config']}_small.json"
    path.write_text(json.dumps(cfg))
    monkeypatch.setattr(settings, "OVERWRITE_RECEIVE_BUFFER_SIZE", LIVE_RING)
    traffic = dict(registry.traffic(w["traffic"]), ring_samples=LIVE_RING)
    return cfg, str(path), traffic


def rehearse(workload: str, seed: int = 2**31 + 7, seconds: float = 1.0, cfg=None,
             cfg_ref=None, traffic=None, control=False):
    """-> (the cell, the window's result, the check) of one small CPU run."""
    w = registry.workload(BENCH, workload)
    cfg = cfg or small(w["config"])
    traffic = traffic or small_traffic(w["traffic"], w["config"])
    cell = registry.driver(traffic["driver"]).Cell(cfg, traffic, seed, "cpu", seconds)
    if cfg_ref is not None:
        cell.cfg_ref = cfg_ref
    try:
        cell.setup()
        result = cell.window(seconds, None)
        cell.release()
        limits = registry.limits(workload)
        check = cell.control(limits) if control else cell.check(limits)
    finally:
        cell.close()
    return cell, result, check
