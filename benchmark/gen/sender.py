"""The live cell's SDR: a process of its own that writes a configuration's
stream, as the SDR delivers it, to a Network SDR receive port in blocks due
on a fixed schedule (open loop: a block is sent when due, however far the
receiver is behind).  Block k holds samples [k B, (k + 1) B) and is due at
t0 + (k + 1) block_s on the machine's monotonic clock, which the harness
shares.  At the end it prints one JSON line: the blocks sent and how late
each send began.  A thread renders the stream ahead in pieces of RENDER_S
seconds, so the sending loop only sleeps and sends.  NumPy and the standard
library only.

    python3 -m benchmark.gen.sender --config FILE --seed N --port P --t0 T --stop S
"""

from __future__ import annotations

import argparse
import json
import queue
import socket
import threading
import time

from benchmark import registry
from benchmark.gen import signals

RENDER_S = 0.05
AHEAD = 40  # rendered pieces held ready


def render_ahead(cfg: dict, stream, piece: int, out: queue.Queue, stop: threading.Event):
    k = 0
    while not stop.is_set():
        data = signals.quantize(cfg, stream.render(k * piece, piece))
        stream.forget(k * piece)
        while not stop.is_set():
            try:
                out.put(data, timeout=0.1)
                break
            except queue.Full:
                continue
        k += 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True,
                   help="a configuration's name in BENCHMARK.json, or a JSON file")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--t0", type=float, required=True, help="monotonic time of sample 0")
    p.add_argument("--stop", type=float, required=True, help="seconds after t0 to stop")
    p.add_argument("--block-s", type=float, default=0.001)
    p.add_argument("--period-s", type=float, default=1.0)
    args = p.parse_args(argv)
    if args.config.endswith(".json"):
        with open(args.config) as f:
            cfg = json.load(f)
    else:
        cfg = registry.config(registry.benchmark(), args.config)
    rate = float(cfg["sample_rate"])
    block = int(round(rate * args.block_s))
    stream = signals.Stream(cfg, args.seed, int(round(rate * args.period_s)))
    nbytes = block * 2 * (4 if cfg["sample_format"] == "float32" else 1)
    per_piece = max(1, int(round(RENDER_S / args.block_s)))
    pieces, stop = queue.Queue(maxsize=AHEAD), threading.Event()
    producer = threading.Thread(target=render_ahead, daemon=True,
                                args=(cfg, stream, block * per_piece, pieces, stop))
    producer.start()
    lags = []
    try:
        with socket.create_connection(("127.0.0.1", args.port)) as sock:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            k, piece = 0, None
            while True:
                due = args.t0 + (k + 1) * args.block_s
                if due > args.t0 + args.stop:
                    break
                if k % per_piece == 0:
                    piece = memoryview(pieces.get(timeout=60).tobytes())
                j = k % per_piece
                data = piece[j * nbytes:(j + 1) * nbytes]
                wait = due - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
                lags.append(time.monotonic() - due)
                sock.sendall(data)
                k += 1
            sock.shutdown(socket.SHUT_WR)
    finally:
        stop.set()
        producer.join(timeout=10)
    print(json.dumps({"blocks": k, "block_samples": block, "lag_s": lags}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
