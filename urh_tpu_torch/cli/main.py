"""Headless command-line interface (PyTorch port of urh_tpu.cli.main).

Counterpart of urh/cli/urh_cli.py (722 LoC): TX (modulate messages or
raw file to a device) and RX (raw record or live protocol sniffing to
stdout/file), with project-file defaults.  Mirrors the reference's flag
surface; adds an --estimate mode that runs the auto-interpretation
pipeline on a capture file.

The compute device comes from the environment, as urh_tpu's platform
does from URH_TPU_PLATFORM: ``URH_TPU_TORCH_DEVICE`` is ``cpu``, ``cuda``,
``cuda:N`` or ``auto`` (placed between the card and the CPU, see
:mod:`urh_tpu_torch.util.placement`); unset, the CUDA card, and a
RuntimeError without one.  It is read only here and handed to every
estimation, demodulation, synthesis and sniffer the CLI makes.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from collections import defaultdict

import numpy as np

DEFAULT_CARRIER_FREQUENCY = 1e3
DEFAULT_CARRIER_AMPLITUDE = 1
DEFAULT_CARRIER_PHASE = 0
DEFAULT_SAMPLES_PER_SYMBOL = 100
DEFAULT_NOISE = 0.1
DEFAULT_CENTER = 0
DEFAULT_CENTER_SPACING = 0.1
DEFAULT_TOLERANCE = 5

PAUSE_SEP = "/"

DEVICE_ENV = "URH_TPU_TORCH_DEVICE"


def device_name(value: str, source: str) -> str:
    """``value`` when it names cpu, cuda, cuda:N or auto; else a ValueError
    that names ``source``, where the value came from."""
    kind, _, index = value.partition(":")
    if value in ("cpu", "cuda", "auto") or (kind == "cuda" and index.isdigit()):
        return value
    raise ValueError("{}={!r}: expected cpu, cuda, cuda:N or auto".format(source, value))


def compute_device():
    """The torch device named by URH_TPU_TORCH_DEVICE: None (the card) when
    unset or empty; ValueError for anything but cpu, cuda, cuda:N, auto."""
    value = os.environ.get(DEVICE_ENV, "").strip()
    return device_name(value, DEVICE_ENV) if value else None


def cli_progress_bar(value, end_value, bar_length=20, title="Percent"):
    percent = value / end_value
    hashes = "#" * int(round(percent * bar_length))
    spaces = " " * (bar_length - len(hashes))
    sys.stdout.write("\r{0}:\t[{1}] {2}%".format(title, hashes + spaces, int(round(percent * 100))))
    sys.stdout.flush()


def on_fatal_device_error_occurred(error: str):
    from urh_tpu_torch.util.logging import logger

    logger.critical(error.strip())
    sys.exit(1)


def build_modulator_from_args(arguments):
    from urh_tpu_torch.dsp.modulator import Modulator

    if arguments.raw:
        return None
    if arguments.bits_per_symbol is None:
        arguments.bits_per_symbol = 1

    n = 2 ** int(arguments.bits_per_symbol)
    if arguments.parameters is None or len(arguments.parameters) != n:
        raise ValueError("you need to give {} parameters for {} bits per symbol".format(
            n, int(arguments.bits_per_symbol)))

    result = Modulator("CLI Modulator")
    result.carrier_freq_hz = float(arguments.carrier_frequency)
    result.carrier_amplitude = float(arguments.carrier_amplitude)
    result.carrier_phase_deg = float(arguments.carrier_phase)
    result.samples_per_symbol = int(arguments.samples_per_symbol)
    result.bits_per_symbol = int(arguments.bits_per_symbol)
    result.modulation_type = arguments.modulation_type
    result.sample_rate = arguments.sample_rate

    for i, param in enumerate(arguments.parameters):
        param = str(param)
        if result.is_amplitude_based and param.endswith("%"):
            result.parameters[i] = float(param[:-1])
        elif result.is_amplitude_based:
            result.parameters[i] = float(param) * 100
        else:
            result.parameters[i] = parse_suffixed_value(param)
    return result


def parse_suffixed_value(value: str) -> float:
    suffixes = {"k": 1e3, "K": 1e3, "M": 1e6, "G": 1e9, "m": 1e-3}
    if value and value[-1] in suffixes:
        return float(value[:-1]) * suffixes[value[-1]]
    return float(value)


def build_backend_handler_from_args(arguments):
    from urh_tpu_torch.dev.backend_handler import BackendHandler, Backends

    bh = BackendHandler()
    if arguments.device.lower() in bh.device_backends:
        selected = {"native": Backends.native,
                    "gnuradio": Backends.grc,
                    "network": Backends.network}.get(arguments.device_backend)
        if selected is not None:
            bh.device_backends[arguments.device.lower()].selected_backend = selected
    return bh


def _apply_device_flags(device, arguments, include_tuning=False):
    """Shared device configuration: identifier, optional gains, error
    hook — and (for the sniffer path) frequency/rate/bandwidth tuning
    (urh_cli.py:129-137, 173-192)."""
    if include_tuning:
        device.frequency = arguments.frequency
        device.sample_rate = arguments.sample_rate
        device.bandwidth = (arguments.sample_rate if arguments.bandwidth is None
                            else arguments.bandwidth)
        for flag in ("gain", "if_gain", "baseband_gain"):
            value = getattr(arguments, flag)
            if value is not None:
                setattr(device, flag, value)
    if arguments.device_identifier is not None:
        # numeric identifier = device index, otherwise serial
        try:
            device.device_number = int(arguments.device_identifier)
        except ValueError:
            device.device_serial = arguments.device_identifier
    device.fatal_error_occurred.connect(on_fatal_device_error_occurred)
    return device


def build_device_from_args(arguments):
    from urh_tpu_torch.dev.virtual_device import Mode, VirtualDevice

    bh = build_backend_handler_from_args(arguments)
    result = VirtualDevice(
        bh, name=arguments.device,
        mode=Mode.receive if arguments.receive else Mode.send,
        freq=arguments.frequency, sample_rate=arguments.sample_rate,
        bandwidth=(arguments.sample_rate if arguments.bandwidth is None
                   else arguments.bandwidth),
        gain=arguments.gain, if_gain=arguments.if_gain,
        baseband_gain=arguments.baseband_gain)
    return _apply_device_flags(result, arguments)


def build_protocol_sniffer_from_args(arguments):
    from urh_tpu_torch.protocol.sniffer import ProtocolSniffer

    if arguments.bits_per_symbol is None:
        arguments.bits_per_symbol = 1  # binary default (urh_cli.py:83-84)
    result = ProtocolSniffer(arguments.samples_per_symbol, arguments.center,
                             arguments.center_spacing, arguments.noise,
                             arguments.tolerance, arguments.modulation_type,
                             arguments.bits_per_symbol, arguments.device,
                             build_backend_handler_from_args(arguments),
                             compute_device=compute_device())
    _apply_device_flags(result.rcv_device, arguments, include_tuning=True)
    result.adaptive_noise = arguments.adaptive_noise
    if arguments.encoding:
        result.decoder = build_encoding_from_args(arguments)
    return result


def build_encoding_from_args(arguments):
    from urh_tpu_torch.coding.encodings import Encoding

    if arguments.encoding is None:
        return None
    primitives = arguments.encoding.split(",")
    return Encoding(list(filter(None, map(str.strip, primitives))))


def read_messages_to_send(arguments):
    from urh_tpu_torch.protocol.analyzer import ProtocolAnalyzer

    if not arguments.transmit:
        return None

    if arguments.messages is not None and arguments.filename is not None:
        print("Either give messages (-m) or a file to read from (-file) not both.")
        sys.exit(1)
    elif arguments.messages is not None:
        if len(arguments.messages) == 1:
            message_strings = arguments.messages[0].split(" ")
        else:
            message_strings = arguments.messages
    elif arguments.filename is not None:
        with open(arguments.filename) as f:
            message_strings = list(map(str.strip, f.readlines()))
    else:
        print("You need to give messages to send either with (-m) or a file (-file).")
        sys.exit(1)

    encoding = build_encoding_from_args(arguments)
    result = ProtocolAnalyzer.get_protocol_from_string(
        message_strings, is_hex=arguments.hex, default_pause=arguments.pause,
        sample_rate=arguments.sample_rate).messages
    if encoding:
        for msg in result:
            msg.decoder = encoding
    return result


def modulate_messages(messages, modulator):
    from urh_tpu_torch.core.iq import IQData

    if len(messages) == 0:
        return None
    device = compute_device()
    cli_progress_bar(0, len(messages), title="Modulating")
    nsamples = sum(int(len(msg.encoded_bits) * modulator.samples_per_symbol + msg.pause)
                   for msg in messages)
    buffer = IQData(None, dtype=np.float32, n=nsamples)
    pos = 0
    for i, msg in enumerate(messages):
        # pause needs no modulation: the buffer is zero-initialized
        modulated = modulator.modulate(start=0, data=msg.encoded_bits, pause=0,
                                       device=device)
        buffer[pos : pos + len(modulated)] = modulated.data
        pos += len(modulated) + msg.pause
        cli_progress_bar(i + 1, len(messages), title="Modulating")
    print("\nSuccessfully modulated {} messages".format(len(messages)))
    return buffer


def parse_project_file(file_path: str):
    import xml.etree.ElementTree as ET

    from urh_tpu_torch.dsp.modulator import Modulator
    from urh_tpu_torch.util.logging import logger
    from urh_tpu_torch.util.project import ProjectManager

    result = defaultdict(lambda: None)
    if not file_path or not os.path.isfile(file_path):
        return result
    try:
        root = ET.parse(file_path).getroot()
    except Exception as e:
        logger.error("could not read project file {}: {}".format(file_path, e))
        return result

    ProjectManager.read_device_conf_dict(root.find("device_conf"), target_dict=result)
    result["device"] = result["name"]

    modulators = Modulator.modulators_from_xml_tag(root)
    if len(modulators) > 0:
        modulator = modulators[0]
        result["carrier_frequency"] = modulator.carrier_freq_hz
        result["carrier_amplitude"] = modulator.carrier_amplitude
        result["carrier_phase"] = modulator.carrier_phase_deg
        result["parameters"] = " ".join(map(str, modulator.parameters))
        result["modulation_type"] = modulator.modulation_type
    return result


# Declarative flag registry: the flag surface is the compatibility spec
# (urh_cli's options); each entry is (flags, kwargs).
def _flag_spec():
    from urh_tpu_torch.dev.backend_handler import BackendHandler
    from urh_tpu_torch.dsp.modulator import Modulator

    devices = BackendHandler.DEVICE_NAMES + ("Network SDR",)
    return {
        "Software Defined Radio Settings": [
            (("-d", "--device"),
             dict(choices=devices, metavar="DEVICE",
                  help="SDR to use. Allowed values: " + ", ".join(devices))),
            (("-di", "--device-identifier"), {}),
            (("-db", "--device-backend"),
             dict(choices=["native", "gnuradio", "network"], default="native")),
            (("-f", "--frequency"),
             dict(type=float, help="center frequency to tune to")),
            (("-s", "--sample-rate"), dict(type=float, help="sample rate")),
            (("-b", "--bandwidth"),
             dict(type=float, help="bandwidth (defaults to sample rate)")),
            (("-g", "--gain"), dict(type=int, help="RF gain")),
            (("-if", "--if-gain"), dict(type=int, help="IF gain")),
            (("-bb", "--baseband-gain"), dict(type=int, help="baseband gain")),
            (("-a", "--adaptive-noise"),
             dict(action="store_true", help="use adaptive noise when receiving")),
            (("-fcorr", "--frequency-correction"), dict(default=1, type=int)),
        ],
        "Modulation/Demodulation settings": [
            (("-cf", "--carrier-frequency"), dict(type=float)),
            (("-ca", "--carrier-amplitude"), dict(type=float)),
            (("-cp", "--carrier-phase"), dict(type=float)),
            (("-mo", "--modulation-type"),
             dict(choices=Modulator.MODULATION_TYPES, metavar="MOD_TYPE",
                  default="FSK")),
            (("-bps", "--bits-per-symbol"), dict(type=int)),
            (("-pm", "--parameters"),
             dict(nargs="+", help="modulation parameters, separated by spaces")),
            (("-sps", "--samples-per-symbol"), dict(type=int)),
            (("-bl", "--bit-length"), dict(type=int, help=argparse.SUPPRESS)),
            (("-n", "--noise"), dict(type=float, help="noise threshold (RX)")),
            (("-c", "--center"), dict(type=float, help="demod center (RX)")),
            (("-cs", "--center-spacing"), dict(type=float)),
            (("-t", "--tolerance"), dict(type=float)),
        ],
        "Data configuration": [
            (("--hex",), dict(action="store_true", help="messages as hex")),
            (("-e", "--encoding"), dict(help="specify encoding chain")),
            (("-m", "--messages"),
             dict(nargs="+", help="messages to send; pauses after a {0}, "
                                  "e.g. 1001{0}42ms".format(PAUSE_SEP))),
            (("-file", "--filename"), {}),
            (("-p", "--pause"), dict(default="250ms")),
            (("-rx", "--receive"),
             dict(action="store_true", help="enter RX mode")),
            (("-tx", "--transmit"),
             dict(action="store_true", help="enter TX mode")),
            (("-rt", "--receive-time"), dict(default="3.0", type=float)),
            (("-r", "--raw"),
             dict(action="store_true",
                  help="raw mode: send/receive IQ data instead of bits")),
            (("--estimate",),
             dict(action="store_true",
                  help="run auto-interpretation on FILE and print the "
                       "estimated parameters and demodulated messages")),
        ],
        "Miscellaneous options": [
            (("-h", "--help"), dict(action="help",
                                    help="show this help and exit")),
            (("-v", "--verbose"), dict(action="count")),
        ],
    }


def create_parser():
    parser = argparse.ArgumentParser(
        description="Command Line Interface for urh_tpu_torch, the PyTorch/CUDA "
                    "port of the Universal Radio Hacker framework urh_tpu.",
        add_help=False)
    parser.add_argument("project_file", nargs="?", default=None)
    for title, entries in _flag_spec().items():
        group = parser.add_argument_group(title)
        for flags, kwargs in entries:
            group.add_argument(*flags, **kwargs)
    return parser


def parse_pause(pause_str, sample_rate):
    pause = str(pause_str)
    if pause.endswith("ms"):
        return float(pause[:-2]) * sample_rate / 1e3
    if pause.endswith("µs") or pause.endswith("us"):
        return float(pause[:-2]) * sample_rate / 1e6
    if pause.endswith("ns"):
        return float(pause[:-2]) * sample_rate / 1e9
    if pause.endswith("s"):
        return float(pause[:-1]) * sample_rate
    return float(pause)


def run_estimate(args):
    import urh_tpu_torch as ut

    if args.filename is None:
        print("You need to give a capture file (-file) to estimate.")
        sys.exit(1)
    device = compute_device()
    sig = ut.Signal.from_file(args.filename, device=device)
    result = ut.estimate(sig.iq_array.data, device=device)
    if result is None:
        print("Could not estimate parameters for this capture.")
        sys.exit(1)
    print("modulation: {}".format(result["modulation_type"]))
    print("samples_per_symbol: {}".format(result["bit_length"]))
    print("center: {:.6f}".format(result["center"]))
    print("tolerance: {}".format(result["tolerance"]))
    print("noise: {:.6f}".format(result["noise"]))

    sig.modulation_type = result["modulation_type"]
    sig.samples_per_symbol = result["bit_length"]
    sig.center = result["center"]
    sig.noise_threshold = result["noise"]
    sig.tolerance = result["tolerance"]
    msgs = ut.demodulate(sig)
    enc = build_encoding_from_args(args)
    for msg in msgs:
        if enc is not None:
            msg.decoder = enc
        print(msg.decoded_hex_str if args.hex else msg.decoded_bits_str)


def main(argv=None):
    from urh_tpu_torch.util import logging as urh_logging
    from urh_tpu_torch.util.logging import logger

    import multiprocessing as mp

    if mp.get_start_method(allow_none=True) is None:
        mp.set_start_method("spawn")

    parser = create_parser()
    args = parser.parse_args(argv)

    if args.estimate:
        run_estimate(args)
        return

    project_params = parse_project_file(args.project_file)
    for argument in ("device", "frequency", "sample_rate"):
        if getattr(args, argument):
            continue
        if project_params[argument] is not None:
            setattr(args, argument, project_params[argument])
        else:
            print("You must specify a {}.".format(argument))
            sys.exit(1)

    if args.receive and args.transmit:
        print("You cannot use receive and transmit mode at the same time.")
        sys.exit(1)
    if not args.receive and not args.transmit:
        print("You must choose a mode: RX (-rx) or TX (-tx)")
        sys.exit(1)

    # CLI flag > project file > built-in default, one merge table
    # (gain keys are prefixed by the active direction in project files)
    direction = "rx_" if args.receive else "tx_"
    merge_table = {
        "bandwidth": ("bandwidth", None),
        "gain": (direction + "gain", None),
        "if_gain": (direction + "if_gain", None),
        "baseband_gain": (direction + "baseband_gain", None),
        "samples_per_symbol": ("samples_per_symbol", DEFAULT_SAMPLES_PER_SYMBOL),
        "center": ("center", DEFAULT_CENTER),
        "center_spacing": ("center_spacing", DEFAULT_CENTER_SPACING),
        "noise": ("noise", DEFAULT_NOISE),
        "tolerance": ("tolerance", DEFAULT_TOLERANCE),
        "bits_per_symbol": ("bits_per_symbol", 1),
        "carrier_frequency": ("carrier_frequency", DEFAULT_CARRIER_FREQUENCY),
        "carrier_amplitude": ("carrier_amplitude", DEFAULT_CARRIER_AMPLITUDE),
        "carrier_phase": ("carrier_phase", DEFAULT_CARRIER_PHASE),
        "parameters": ("parameters", None),
    }
    if args.bit_length is not None and args.samples_per_symbol is None:
        args.samples_per_symbol = args.bit_length  # legacy flag name
        del merge_table["samples_per_symbol"]
    for attr, (project_key, default) in merge_table.items():
        if getattr(args, attr) is None:
            project_value = project_params[project_key]
            setattr(args, attr,
                    default if project_value is None else project_value)
    if args.parameters is None and not args.raw:
        print("You must give modulation parameters (--parameters)")
        sys.exit(0)
    if isinstance(args.parameters, str):
        args.parameters = args.parameters.split(" ")

    if args.verbose is None:
        logger.setLevel(logging.ERROR)
    elif args.verbose == 1:
        logger.setLevel(logging.INFO)
    else:
        logger.setLevel(logging.DEBUG)
    urh_logging.save_log_level(logger.level)

    args.pause = parse_pause(args.pause, args.sample_rate)

    if args.transmit:
        run_transmit(args)
    elif args.receive:
        run_receive(args)


def run_transmit(args):
    device = build_device_from_args(args)
    if args.raw:
        if args.filename is None:
            print("You need to give a file (-file) to read samples from.")
            sys.exit(1)
        samples_to_send = np.fromfile(args.filename, dtype=np.complex64)
    else:
        modulator = build_modulator_from_args(args)
        messages_to_send = read_messages_to_send(args)
        samples_to_send = modulate_messages(messages_to_send, modulator)
    device.samples_to_send = samples_to_send
    device.start()

    while not device.sending_finished:
        try:
            time.sleep(0.1)
            device.read_messages()
            if device.current_index > 0:
                cli_progress_bar(device.current_index, len(device.samples_to_send),
                                 title="Sending")
        except KeyboardInterrupt:
            break
    print()
    device.stop("Sending finished")


def run_receive(args):
    if args.raw:
        if args.filename is None:
            print("You need to give a file (-file) to receive into in raw RX mode.")
            sys.exit(1)
        receiver = build_device_from_args(args)
        receiver.start()
    else:
        receiver = build_protocol_sniffer_from_args(args)
        receiver.sniff()

    total_time = 0
    if args.receive_time >= 0:
        print("Receiving for {} seconds...".format(args.receive_time))
    else:
        print("Receiving forever...")

    f = None if args.filename is None or args.raw else open(args.filename, "w")
    kwargs = dict() if f is None else {"file": f}

    dev = receiver.rcv_device if hasattr(receiver, "rcv_device") else receiver

    while total_time < abs(args.receive_time):
        try:
            dev.read_messages()
            time.sleep(0.1)
            if args.receive_time >= 0:
                total_time += 0.1
            if not args.raw:
                num_messages = len(receiver.messages)
                for msg in receiver.messages[:num_messages]:
                    print(msg.decoded_hex_str if args.hex else msg.decoded_bits_str, **kwargs)
                del receiver.messages[:num_messages]
        except KeyboardInterrupt:
            break

    print("\nStopping receiving...")
    if args.raw:
        receiver.stop("Receiving finished")
        np.asarray(receiver.data[: receiver.current_index]).tofile(args.filename)
    else:
        receiver.stop()

    if f is not None:
        f.close()
        print("Received data written to {}".format(args.filename))


if __name__ == "__main__":
    main()
