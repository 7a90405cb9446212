#!/usr/bin/env python
"""AirSpy receive flowgraph (GENERATED by urh_tpu_torch.dev.gr.generate_scripts
from device_table.py -- edit the table, not this file).

Runs under an external GNU Radio python: osmosdr.source ->
TCP server sink on --port; retune commands arrive on stdin as
"TAG:value" lines (F, SR, G, IFG, BBG, BW, FC, DSM, ANT).
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
    parser.add_argument("--freq-correction", type=float, default=None)
    parser.add_argument("--direct-sampling", type=int, default=None)
    parser.add_argument("--antenna-index", type=int, default=None)
    parser.add_argument("--port", type=int, default=1337)
    parser.add_argument("--device-args", default='airspy')
    args = parser.parse_args()

    from gnuradio import blocks, gr
    import osmosdr

    tb = gr.top_block()
    dev = osmosdr.source("numchan=1 " + args.device_args)
    dev.set_sample_rate(args.samplerate)
    dev.set_center_freq(args.freq, 0)
    dev.set_gain(args.gain, 0)
    if args.freq_correction is not None:
        dev.set_freq_corr(args.freq_correction, 0)
    dev.set_if_gain(args.if_gain, 0)
    dev.set_bb_gain(args.bb_gain, 0)
    if args.bandwidth:
        dev.set_bandwidth(args.bandwidth, 0)

    sink = blocks.tcp_server_sink(gr.sizeof_gr_complex, "127.0.0.1",
                                  args.port, False)
    tb.connect((dev, 0), (sink, 0))

    def command_loop():
        for line in sys.stdin:
            try:
                tag, value = line.strip().split(":")
                value = float(value)
            except ValueError:
                continue
            if tag == "F":
                dev.set_center_freq(value, 0)
            elif tag == "SR":
                dev.set_sample_rate(value)
            elif tag == "G":
                dev.set_gain(value, 0)
            elif tag == "FC":
                dev.set_freq_corr(value, 0)
            elif tag == "IFG":
                dev.set_if_gain(value, 0)
            elif tag == "BBG":
                dev.set_bb_gain(value, 0)
            elif tag == "BW":
                dev.set_bandwidth(value, 0)

    threading.Thread(target=command_loop, daemon=True).start()
    tb.run()


if __name__ == "__main__":
    main()
