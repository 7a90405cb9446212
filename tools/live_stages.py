#!/usr/bin/env python3
"""Where the live loop's time goes, on a card.

    python3 tools/live_stages.py     # from the repository root, one CUDA card

A one-off measurement; nothing in the package depends on it.
1. The loopback alone: chip_smoke.py's 2^24-sample float32 FSK capture
   sent by a Network SDR sender to a Network SDR receiver with no sniffer;
   the wall from the first sample received to the last (host clock).
2. The live FSK receive of chip_smoke.py's live phase (a ProtocolSniffer on
   the card), with the interpreter's thread switch interval at its default
   (5 ms) and at 0.5 ms, in turns (default, short, short, default): the
   receiver thread, the poll thread that feeds the card and the sending
   thread share one interpreter lock, so the interval bounds how long a
   thread that wants the lock waits for it.
3. The start-up of a ContinuousModulator-like child on the card, spawned
   as urh_tpu_torch spawns it: the wall to its entry, then ``import
   torch``, ``import urh_tpu_torch``, its CUDA context (a first tensor on
   the card), the first and the second ``Modulator.modulate`` of a
   message (256 bits, 100 samples a bit) on the card.
Each line ends with the card's name and power limit.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def child_stages(device: str, started: float, queue):
    """Child entry: the wall of each start-up stage (s) onto ``queue``."""
    out = {"spawn to entry": time.time() - started}
    t0 = time.perf_counter()

    def mark(name):
        nonlocal t0
        now = time.perf_counter()
        out[name] = now - t0
        t0 = now

    import torch

    mark("import torch")
    import urh_tpu_torch as ut

    mark("import urh_tpu_torch")
    torch.zeros(1, device=device)
    torch.cuda.synchronize()
    mark("CUDA context")
    bits = "10" * 128
    for name in ("first modulate", "second modulate"):
        ut.Modulator().modulate(bits, pause=20000, device=device)
        torch.cuda.synchronize()
        mark(name)
    queue.put(out)


def loopback_alone(iq) -> float:
    """Samples/s of the Network SDR loopback with no sniffer."""
    import numpy as np

    from urh_tpu_torch import IQData
    from urh_tpu_torch.dev.network_sdr import NetworkSDRInterfacePlugin
    from urh_tpu_torch.util import settings

    settings.OVERWRITE_RECEIVE_BUFFER_SIZE = len(iq) + 1
    receiver = NetworkSDRInterfacePlugin(raw_mode=True, resume_on_full_receive_buffer=True)
    receiver.server_port = 0
    receiver.start_tcp_server_for_receiving()
    sink, first = receiver.server.sink, []

    def timed_sink(frames):
        if not first:
            first.append(time.perf_counter())
        sink(frames)

    receiver.server.sink = timed_sink
    sender = NetworkSDRInterfacePlugin(raw_mode=True, sending=True)
    sender.client_port = receiver.server_port
    sender.send_raw_data(IQData(np.ascontiguousarray(iq), skip_conversion=True), 1)
    while receiver.current_receive_index < len(iq):
        time.sleep(0.0005)
    wall = time.perf_counter() - first[0]
    receiver.stop_tcp_server()
    settings.OVERWRITE_RECEIVE_BUFFER_SIZE = None
    return len(iq) / wall


def main():
    import numpy as np
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("tools/live_stages.py needs a CUDA card")
    from urh_tpu_torch import _build

    _build.library()
    identity = chip_smoke.card_identity()
    iq, bits = chip_smoke.make_capture("FSK", chip_smoke.N_FULL, seed=11)
    for run in (1, 2):
        rate = loopback_alone(iq)
        print(f"loopback alone, run {run}: {rate} samples/s ({rate * 8 / 1e6} MB/s) on "
              f"{identity}", flush=True)

    p = chip_smoke.demod_params("FSK", np.float32)
    default = sys.getswitchinterval()
    for interval in (default, 0.0005, 0.0005, default):
        sys.setswitchinterval(interval)
        try:
            rx = chip_smoke.live_rx(None, iq, p, f"live FSK at {interval} s")
        finally:
            sys.setswitchinterval(default)
        chip_smoke.check_bits(rx["bits"], bits, "live FSK")
        drains = rx["record"]["drains"]
        print(f"live FSK, switch interval {interval} s: wall {rx['wall']} s "
              f"({rx['total'] / rx['wall']} samples/s), {len(drains)} drains (median "
              f"{float(np.median(drains))}), sniffer.demodulate "
              f"{rx['report']['samples_per_second']} samples/s over {rx['report']['seconds']} s "
              f"on {identity}", flush=True)

    ctx = multiprocessing.get_context("spawn")
    for run in (1, 2):
        queue = ctx.Queue()
        child = ctx.Process(target=child_stages, args=("cuda:0", time.time(), queue))
        child.start()
        stages = queue.get(timeout=300)
        child.join(60)
        print(f"child start-up, run {run} (s): {stages}; exit code {child.exitcode}; on "
              f"{identity}", flush=True)


if __name__ == "__main__":
    main()
