"""Render the per-device GNU Radio flowgraph scripts from the device table.

Run ``python -m urh_tpu_torch.dev.gr.generate_scripts`` after editing
:mod:`device_table`; the rendered scripts are checked in so the backend
works from a plain source tree.  Each script is self-contained (it runs
under an *external* GNU Radio python picked in settings, where
urh_tpu_torch is not importable).

Counterpart of urh/dev/gr/scripts/__create_gr_script.py, which pastes
osmosdr args into .grc-generated boilerplate; here the whole script is
one template parameterized by the table row.
"""

from __future__ import annotations

import os

from urh_tpu_torch.dev.gr.device_table import GR_DEVICES

SCRIPTS_DIR = os.path.join(os.path.dirname(__file__), "scripts")

TEMPLATE = '''#!/usr/bin/env python
"""{name} {verb} flowgraph (GENERATED by urh_tpu_torch.dev.gr.generate_scripts
from device_table.py -- edit the table, not this file).

Runs under an external GNU Radio python: osmosdr.{block} {arrow}
TCP {sock_role} on --port; retune commands arrive on stdin as
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
    parser.add_argument("--device-args", default={osmosdr_args!r})
    args = parser.parse_args()

    from gnuradio import blocks, gr
    import osmosdr

    tb = gr.top_block()
    dev = osmosdr.{block}("numchan=1 " + args.device_args)
    dev.set_sample_rate(args.samplerate)
    dev.set_center_freq(args.freq, 0)
    dev.set_gain(args.gain, 0)
    if args.freq_correction is not None:
        dev.set_freq_corr(args.freq_correction, 0)
{gain_lines}{bandwidth_lines}{direct_sampling_lines}{antenna_lines}
{wiring}

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
{loop_extras}
    threading.Thread(target=command_loop, daemon=True).start()
    tb.run()


if __name__ == "__main__":
    main()
'''

RECV_WIRING = """    sink = blocks.tcp_server_sink(gr.sizeof_gr_complex, "127.0.0.1",
                                  args.port, False)
    tb.connect((dev, 0), (sink, 0))"""

# urh_tpu_torch's SenderThread runs the TCP server; the flowgraph connects as
# a client.  blocks.tcp_source is GR 3.7; 3.9+ moved it to gr-network.
SEND_WIRING = """    if hasattr(blocks, "tcp_source"):
        src = blocks.tcp_source(gr.sizeof_gr_complex, "127.0.0.1",
                                args.port, False)
    else:
        from gnuradio import network
        src = network.tcp_source(gr.sizeof_gr_complex, 1, "127.0.0.1",
                                 args.port)
    tb.connect((src, 0), (dev, 0))"""


def _render(device, direction: str) -> str:
    gain_lines = ""
    if device.has_if_gain:
        gain_lines += "    dev.set_if_gain(args.if_gain, 0)\n"
    if device.has_bb_gain:
        gain_lines += "    dev.set_bb_gain(args.bb_gain, 0)\n"

    bandwidth_lines = ""
    if device.has_bandwidth:
        bandwidth_lines = ("    if args.bandwidth:\n"
                           "        dev.set_bandwidth(args.bandwidth, 0)\n")

    direct_sampling_lines = ""
    if device.has_direct_sampling:
        direct_sampling_lines = (
            "    if args.direct_sampling is not None and hasattr(dev, 'set_direct_sampling'):\n"
            "        dev.set_direct_sampling(args.direct_sampling)\n")

    antenna_lines = ""
    if device.antennas:
        antenna_lines = (
            "    antennas = %r\n"
            "    if args.antenna_index is not None:\n"
            "        dev.set_antenna(antennas[args.antenna_index %% len(antennas)], 0)\n"
            % (tuple(device.antennas),))

    loop_extras = ""
    if device.has_if_gain:
        loop_extras += ('            elif tag == "IFG":\n'
                        "                dev.set_if_gain(value, 0)\n")
    if device.has_bb_gain:
        loop_extras += ('            elif tag == "BBG":\n'
                        "                dev.set_bb_gain(value, 0)\n")
    if device.has_bandwidth:
        loop_extras += ('            elif tag == "BW":\n'
                        "                dev.set_bandwidth(value, 0)\n")
    if device.has_direct_sampling:
        loop_extras += ('            elif tag == "DSM" and hasattr(dev, "set_direct_sampling"):\n'
                        "                dev.set_direct_sampling(int(value))\n")
    if device.antennas:
        loop_extras += ('            elif tag == "ANT":\n'
                        "                dev.set_antenna(antennas[int(value) % len(antennas)], 0)\n")

    if direction == "recv":
        block, wiring = "source", RECV_WIRING
        verb, arrow, sock_role = "receive", "->", "server sink"
    else:
        block, wiring = "sink", SEND_WIRING
        verb, arrow, sock_role = "transmit", "<-", "client source"

    return TEMPLATE.format(
        name=device.name, verb=verb, block=block, arrow=arrow,
        sock_role=sock_role, osmosdr_args=device.osmosdr_args,
        gain_lines=gain_lines, bandwidth_lines=bandwidth_lines,
        direct_sampling_lines=direct_sampling_lines,
        antenna_lines=antenna_lines, wiring=wiring,
        loop_extras=loop_extras)


def generate(out_dir: str = SCRIPTS_DIR) -> list:
    written = []
    for device in GR_DEVICES:
        for direction in device.directions:
            path = os.path.join(out_dir,
                                f"{device.script_stem}_{direction}.py")
            with open(path, "w") as f:
                f.write(_render(device, direction))
            written.append(path)
    return written


if __name__ == "__main__":
    for p in generate():
        print(p)
