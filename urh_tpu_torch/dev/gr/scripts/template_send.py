#!/usr/bin/env python
"""Generic osmosdr transmit flowgraph (runs under a GNU Radio python).

``blocks.tcp_client_source -> osmosdr.sink`` with stdin retuning,
mirroring the reference's send scripts.
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
    src = blocks.tcp_client_source(gr.sizeof_gr_complex, "127.0.0.1", args.port)
    sink = osmosdr.sink(args.device_args)
    sink.set_sample_rate(args.samplerate)
    sink.set_center_freq(args.freq)
    sink.set_gain(args.gain)
    if args.bandwidth:
        sink.set_bandwidth(args.bandwidth)
    tb.connect(src, sink)

    def command_loop():
        for line in sys.stdin:
            try:
                tag, value = line.strip().split(":")
                value = float(value)
            except ValueError:
                continue
            if tag == "F":
                sink.set_center_freq(value)
            elif tag == "SR":
                sink.set_sample_rate(value)
            elif tag == "G":
                sink.set_gain(value)
            elif tag == "BW":
                sink.set_bandwidth(value)

    threading.Thread(target=command_loop, daemon=True).start()
    tb.run()


if __name__ == "__main__":
    main()
