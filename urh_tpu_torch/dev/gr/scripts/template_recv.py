#!/usr/bin/env python
"""Generic osmosdr receive flowgraph (runs under a GNU Radio python).

Counterpart of the per-device scripts in urh/dev/gr/scripts/: builds
``osmosdr.source -> blocks.tcp_server_sink`` and applies retune
commands read from stdin ("F:<freq>", "SR:<rate>", "G:<gain>", ...).
Device selection via --device-args (e.g. "hackrf", "rtl=0").
"""

import argparse
import sys
import threading


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--samplerate", type=float, default=2e6)
    parser.add_argument("--freq", type=float, default=433.92e6)
    parser.add_argument("--gain", type=float, default=20)
    parser.add_argument("--if-gain", type=float, default=20)
    parser.add_argument("--bb-gain", type=float, default=16)
    parser.add_argument("--bandwidth", type=float, default=None)
    parser.add_argument("--port", type=int, default=1337)
    parser.add_argument("--device-args", default="")
    args = parser.parse_args()

    from gnuradio import blocks, gr
    import osmosdr

    tb = gr.top_block()
    src = osmosdr.source(args.device_args)
    src.set_sample_rate(args.samplerate)
    src.set_center_freq(args.freq)
    src.set_gain(args.gain)
    src.set_if_gain(getattr(args, "if_gain", 20))
    src.set_bb_gain(getattr(args, "bb_gain", 16))
    if args.bandwidth:
        src.set_bandwidth(args.bandwidth)

    sink = blocks.tcp_server_sink(gr.sizeof_gr_complex, "127.0.0.1", args.port, True)
    tb.connect(src, sink)

    def command_loop():
        for line in sys.stdin:
            try:
                tag, value = line.strip().split(":")
                value = float(value)
            except ValueError:
                continue
            if tag == "F":
                src.set_center_freq(value)
            elif tag == "SR":
                src.set_sample_rate(value)
            elif tag == "G":
                src.set_gain(value)
            elif tag == "IFG":
                src.set_if_gain(value)
            elif tag == "BBG":
                src.set_bb_gain(value)
            elif tag == "BW":
                src.set_bandwidth(value)

    threading.Thread(target=command_loop, daemon=True).start()
    tb.run()


if __name__ == "__main__":
    main()
