"""The port's command-line interface against urh_tpu's.

Both CLIs parse the same arguments and build the same modulators,
devices, sniffers, encodings and messages.  ``--estimate`` on the same
2^17-sample FSK and ASK files prints the same lines, apart from the
center and the noise, which are compared as numbers within estimate()'s
tolerances (tests/test_torch_estimate.py: center 1e-6, noise exact, each
printed with 6 decimals).  ``-tx`` to a loopback Network SDR receiver
sends samples within the TX tolerance of tests/test_torch_modulate.py (4
float32 ulps of the amplitude) of urh_tpu's, and equal word for word to
the port's ``Modulator.modulate`` of each message; ``-rx`` from a Network
SDR sending bit lines writes the same file.  The port runs on the CPU
(``URH_TPU_TORCH_DEVICE=cpu``), urh_tpu on JAX's CPU.  Both packages'
settings store is one temporary config dir, and ``main()``'s process-wide
start method and log-level file are kept out of the process.
"""

import logging
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from urh_tpu.cli import main as jax_cli
from urh_tpu.dev.backend_handler import Backends as JaxBackends
from urh_tpu.dsp.modulate import modulate as jax_modulate
from urh_tpu.util import logging as jax_logging
from urh_tpu.util import settings as jax_settings
from urh_tpu_torch.cli import main as cli
from urh_tpu_torch.dev.backend_handler import Backends
from urh_tpu_torch.dev.virtual_device import Mode
from urh_tpu_torch.dsp.modulator import Modulator
from urh_tpu_torch.util import logging as urh_logging
from urh_tpu_torch.util import settings

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CENTER_ATOL = 1e-6 + 5e-7  # estimate()'s tolerance plus the printed rounding
TX_ULPS = 4
DEADLINE_S = 60.0


@pytest.fixture
def config(tmp_path, monkeypatch):
    """One temporary settings store for both packages; main()'s start
    method and log-level file kept to this test."""
    folder = tmp_path / "urh_tpu"
    for module in (settings, jax_settings):
        monkeypatch.setattr(module, "_config_dir", str(folder))
        monkeypatch.setattr(module, "_settings_file", str(folder / "settings.json"))
        monkeypatch.setattr(module, "_store", None)
    for module in (urh_logging, jax_logging):
        monkeypatch.setattr(module, "LOG_LEVEL_PATH", str(tmp_path / "log_level"))
    import multiprocessing

    monkeypatch.setattr(multiprocessing, "set_start_method", lambda *a, **k: None)
    monkeypatch.setenv(cli.DEVICE_ENV, "cpu")
    levels = [(lg, lg.level) for lg in (urh_logging.logger, jax_logging.logger)]
    yield folder
    for lg, level in levels:
        lg.setLevel(level)


@pytest.fixture
def parsers():
    return cli.create_parser(), jax_cli.create_parser()


def _both(parsers, line: str):
    port, jax = parsers
    return port.parse_args(line.split()), jax.parse_args(line.split())


# -- parsing and builders (tests/test_cli_parsing.py) -------------------------------


def test_flag_surface_equals_urh_tpu(parsers):
    port, jax = parsers
    flags = lambda p: sorted((a.dest, tuple(a.option_strings), a.default, a.nargs,
                              tuple(a.choices or ())) for a in p._actions)
    assert flags(port) == flags(jax)


MODULATOR_LINES = (
    "-pm 0 1 -mo ASK -cf 1337e3 -ca 0.9 -sps 24 -cp 30",
    "-pm 10% 20% -mo ASK -cf 1337e3 -ca 0.9 -sps 24 -cp 30",
    "-pm 20e3 -20000 -mo FSK -cf 1337e3 -ca 0.9 -sps 24 -cp 30",
    "-pm 1k 2M -mo FSK -sps 10 -cf 0 -ca 1 -cp 0",
    "-pm 0 90 180 270 -mo PSK -bps 2 -sps 50 -cf 40e3 -ca 0.5 -cp 90",
)


@pytest.mark.parametrize("line", MODULATOR_LINES)
def test_build_modulator_from_args_equals_urh_tpu(parsers, line):
    args, jax_args = _both(parsers, "--device HackRF --frequency 433.92e6 --sample-rate 2e6 "
                           + line)
    got, want = cli.build_modulator_from_args(args), jax_cli.build_modulator_from_args(jax_args)
    for attr in ("modulation_type", "sample_rate", "samples_per_symbol", "bits_per_symbol",
                 "carrier_freq_hz", "carrier_amplitude", "carrier_phase_deg"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert list(got.parameters) == list(want.parameters)


def test_build_modulator_from_args_refusals(parsers):
    for line in ("--raw", "", "-p0 0"):
        args, jax_args = _both(parsers, "--device HackRF --frequency 433.92e6 "
                               "--sample-rate 2e6 " + line)
        if line == "--raw":
            assert cli.build_modulator_from_args(args) is None
            continue
        with pytest.raises(ValueError):
            cli.build_modulator_from_args(args)
        with pytest.raises(ValueError):
            jax_cli.build_modulator_from_args(jax_args)


@pytest.mark.parametrize("device,backend,selected", [
    ("USRP", "", "native"), ("HackRF", " --device-backend native", "native"),
    ("RTL-SDR", " --device-backend gnuradio", "grc")])
def test_build_backend_handler_from_args(parsers, device, backend, selected):
    args, jax_args = _both(parsers, f"--device {device} --frequency 433.92e6 "
                           f"--sample-rate 2e6" + backend)
    got = cli.build_backend_handler_from_args(args).device_backends[device.lower()]
    want = jax_cli.build_backend_handler_from_args(jax_args).device_backends[device.lower()]
    assert got.selected_backend == getattr(Backends, selected)
    assert want.selected_backend == getattr(JaxBackends, selected)


DEVICE_LINES = (
    "--device HackRF --frequency 133.7e6 --sample-rate 2.5e6 -rx -if 24 -bb 30 -g 0 "
    "--device-identifier abcde",
    "--device RTL-SDR --frequency 133.7e6 --sample-rate 1e6 -rx -db native "
    "--device-identifier 42",
    "--device HackRF --frequency 133.7e6 --sample-rate 2.5e6 --bandwidth 5e6 -tx -db native",
)


@pytest.mark.parametrize("line", DEVICE_LINES)
def test_build_device_from_args_equals_urh_tpu(parsers, line):
    args, jax_args = _both(parsers, line)
    got, want = cli.build_device_from_args(args), jax_cli.build_device_from_args(jax_args)
    for attr in ("name", "sample_rate", "bandwidth", "frequency", "gain", "if_gain",
                 "baseband_gain", "device_serial", "device_number"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.backend.name == want.backend.name == "native"
    assert got.mode.name == want.mode.name
    assert got.mode == (Mode.receive if "-rx" in line else Mode.send)


def test_build_protocol_sniffer_from_args_equals_urh_tpu(parsers, config):
    args, jax_args = _both(parsers, "--device HackRF --frequency 50e3 --sample-rate 2.5e6 "
                           "-rx -if 24 -bb 30 -g 0 --device-identifier abcde -sps 1337 "
                           "--center 0.5 --noise 0.1234 --tolerance 42 -cs 0.42 -bps 4")
    got = cli.build_protocol_sniffer_from_args(args)
    want = jax_cli.build_protocol_sniffer_from_args(jax_args)
    assert got.compute_device == torch.device("cpu")
    for attr in ("frequency", "sample_rate", "bandwidth", "name", "gain", "if_gain",
                 "baseband_gain", "device_serial"):
        assert getattr(got.rcv_device, attr) == getattr(want.rcv_device, attr), attr
    assert got.rcv_device.mode == Mode.receive and got.rcv_device.backend == Backends.native
    for attr in ("samples_per_symbol", "bits_per_symbol", "center_spacing", "noise_threshold",
                 "center", "tolerance", "modulation_type"):
        assert getattr(got.signal, attr) == getattr(want.signal, attr), attr
    assert got.signal.samples_per_symbol == 1337 and got.signal.bits_per_symbol == 4


def test_build_encoding_from_args(parsers):
    args, jax_args = _both(parsers, "--device HackRF --frequency 50e3 --sample-rate 2.5e6 "
                           "-e Test,Invert")
    got, want = cli.build_encoding_from_args(args), jax_cli.build_encoding_from_args(jax_args)
    assert len(got.chain) == len(want.chain) == 2
    names = lambda chain: [getattr(c, "__name__", c) for c in chain]
    assert names(got.chain) == names(want.chain) == ["Test", "code_invert"]


def test_read_messages_to_send_equals_urh_tpu(parsers, tmp_path):
    base = "--device HackRF --frequency 50e3 --sample-rate 2e6 "
    args, _ = _both(parsers, base + "-rx")
    assert cli.read_messages_to_send(args) is None
    for line in ("-tx", f"-tx -file {tmp_path / 'x'} -m 1111"):
        args, _ = _both(parsers, base + line)
        with pytest.raises(SystemExit):
            cli.read_messages_to_send(args)

    strings = ["101010/1s", "10000/50ms", "00001111/100.5µs", "111010101/500ns", "1111001",
               "111110000/2000"]
    path = tmp_path / "messages.txt"
    path.write_text("aabb/2s\n0f/3ms\n")
    for line in (base + "-tx --pause 1337 -m " + " ".join(strings),
                 base + f"-tx --pause 1337 --hex -file {path}",
                 base + "-tx --pause 10ms -e Invert -m 1100 0011/20us"):
        args, jax_args = _both(parsers, line)
        args.pause = cli.parse_pause(args.pause, args.sample_rate)
        jax_args.pause = jax_cli.parse_pause(jax_args.pause, jax_args.sample_rate)
        got = cli.read_messages_to_send(args)
        want = jax_cli.read_messages_to_send(jax_args)
        assert [(m.decoded_bits_str, m.encoded_bits_str, m.pause) for m in got] == \
            [(m.decoded_bits_str, m.encoded_bits_str, m.pause) for m in want]
    assert [m.pause for m in cli.read_messages_to_send(_both(
        parsers, base + "-tx --pause 1337 -m " + " ".join(strings))[0])] == \
        [2e6, 100e3, 201, 1, 1337, 2000]


@pytest.mark.parametrize("pause", ["250ms", "3s", "100.5µs", "40us", "500ns", "1337", "2.5"])
def test_parse_pause_equals_urh_tpu(pause):
    assert cli.parse_pause(pause, 2e6) == jax_cli.parse_pause(pause, 2e6)


def test_parse_project_file_of_the_ports_project(tmp_path):
    from urh_tpu_torch.util.project import ProjectManager

    pm = ProjectManager(str(tmp_path))
    pm.device_conf.update(name="HackRF", frequency=868.3e6, sample_rate=2e6, rx_gain=17)
    mod = Modulator("mod")
    mod.modulation_type = "FSK"
    mod.parameters = [-20e3, 20e3]
    mod.carrier_freq_hz = 5e3
    pm.modulators = [mod]
    pm.save_project()
    got = cli.parse_project_file(pm.project_file)
    want = jax_cli.parse_project_file(pm.project_file)
    assert dict(got) == dict(want)
    assert got["device"] == "HackRF" and got["frequency"] == 868.3e6
    assert got["modulation_type"] == "FSK" and got["carrier_frequency"] == 5e3
    assert got["parameters"] == "-20000.0 20000.0"
    assert cli.parse_project_file(str(tmp_path / "missing.xml"))["device"] is None


@pytest.mark.parametrize("value,want", [("", None), ("cpu", "cpu"), ("cuda", "cuda"),
                                        ("cuda:1", "cuda:1"), ("auto", "auto")])
def test_compute_device_from_the_environment(monkeypatch, value, want):
    monkeypatch.setenv(cli.DEVICE_ENV, value)
    assert cli.compute_device() == want


@pytest.mark.parametrize("value", ["gpu", "cuda:x", "xla", "CPU"])
def test_unknown_compute_device_raises(monkeypatch, value):
    monkeypatch.setenv(cli.DEVICE_ENV, value)
    with pytest.raises(ValueError, match=cli.DEVICE_ENV):
        cli.compute_device()


def test_missing_mode_and_flags_exit_as_urh_tpu(config, capsys):
    for argv in (["--device", "HackRF", "--frequency", "1e6"],
                 ["--device", "HackRF", "--frequency", "1e6", "-s", "1e6"],
                 ["--device", "HackRF", "--frequency", "1e6", "-s", "1e6", "-rx", "-tx"],
                 ["--estimate"]):
        outputs = []
        for main in (cli.main, jax_cli.main):
            with pytest.raises(SystemExit):
                main(argv)
            outputs.append(capsys.readouterr().out)
        assert outputs[0] == outputs[1] and outputs[0]


# -- --estimate ----------------------------------------------------------------------


def _capture(kind: str, seed: int, n: int = 1 << 17, n_bits: int = 64, pause: int = 3000):
    """[message, pause] * k from urh_tpu's modulator, every message opening
    and closing with a 1, then silence to n samples, plus noise."""
    rng = np.random.default_rng(seed)
    parts, sent = [], []
    while sum(map(len, parts)) + n_bits * 100 + pause <= n:
        bits = rng.integers(0, 2, n_bits)
        bits[0] = bits[-1] = 1
        if kind == "FSK":
            parts.append(jax_modulate(bits, 100, "fsk", [-20e3, 20e3], carrier_frequency=0.0,
                                      pause=pause))
        else:
            parts.append(jax_modulate(bits, 100, "ask", [0.0, 1.0], carrier_frequency=10e3,
                                      pause=pause))
        sent.append(bits)
    iq = np.concatenate(parts + [np.zeros((n - sum(map(len, parts)), 2), np.float32)])
    return (iq + rng.normal(0, 0.01, iq.shape)).astype(np.float32), sent


def _estimate_lines(main, path, capsys, *flags):
    main(["--estimate", "-file", str(path), *flags])
    return capsys.readouterr().out.splitlines()


def _assert_estimate_lines_equal(got, want):
    assert len(got) == len(want) and len(got) > 5
    for line, other in zip(got, want):
        key = line.split(":")[0]
        if key in ("center", "noise") and line != other:
            atol = CENTER_ATOL if key == "center" else 5e-7
            assert other.startswith(key + ": ")
            assert abs(float(line.split()[1]) - float(other.split()[1])) <= atol, (line, other)
        else:
            assert line == other


@pytest.mark.parametrize("kind,seed", [("FSK", 3), ("ASK", 4)])
def test_estimate_prints_what_urh_tpu_prints(config, capsys, tmp_path, kind, seed):
    iq, sent = _capture(kind, seed)
    path = tmp_path / "capture.complex"
    iq.tofile(path)
    for flags in ((), ("--hex",)):
        got = _estimate_lines(cli.main, path, capsys, *flags)
        want = _estimate_lines(jax_cli.main, path, capsys, *flags)
        _assert_estimate_lines_equal(got, want)
        assert got[0] == f"modulation: {kind}" and got[1] == "samples_per_symbol: 100"
    if kind == "FSK":  # exact at the estimated parameters
        bits = _estimate_lines(cli.main, path, capsys)[5:]
        assert bits == ["".join(map(str, b)) for b in sent]


def test_estimate_of_an_empty_capture_exits_as_urh_tpu(config, capsys, tmp_path):
    path = tmp_path / "silence.complex"
    (np.random.default_rng(0).normal(0, 0.001, (20000, 2))).astype(np.float32).tofile(path)
    outputs = []
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit):
            main(["--estimate", "-file", str(path)])
        outputs.append(capsys.readouterr().out)
    assert outputs[0] == outputs[1] == "Could not estimate parameters for this capture.\n"


def test_estimate_as_a_module_in_its_own_process(config, capsys, tmp_path):
    """``python -m urh_tpu_torch.cli`` (the console script's path) prints
    what main() prints in this process."""
    iq, _ = _capture("FSK", 3)
    path = tmp_path / "capture.complex"
    iq.tofile(path)
    want = _estimate_lines(cli.main, path, capsys, "--hex")
    env = dict(os.environ, URH_TPU_TORCH_DEVICE="cpu", XDG_CONFIG_HOME=str(tmp_path))
    out = subprocess.run([sys.executable, "-m", "urh_tpu_torch.cli", "--estimate", "-file",
                          str(path), "--hex"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == want


# -- -tx and -rx over the Network SDR ------------------------------------------------


class _Receiver:
    """A loopback server that reads one connection to its end."""

    def __init__(self):
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self.data = bytearray()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        conn, _ = self._srv.accept()
        with conn:
            while chunk := conn.recv(1 << 16):
                self.data += chunk
        self._srv.close()

    def samples(self) -> np.ndarray:
        self._thread.join(DEADLINE_S)
        assert not self._thread.is_alive()
        return np.frombuffer(bytes(self.data), np.float32).reshape(-1, 2)


TX_MESSAGES = ["1010101100110110", "11110000101011111100", "100111000111", "1" * 32]


def _write_setting(key: str, value):
    """Write a key to the shared store; both packages read it anew."""
    settings.write(key, value)
    for module in (settings, jax_settings):
        module._store = None


def _transmit(main, config, tmp_path, *flags) -> np.ndarray:
    receiver = _Receiver()
    _write_setting("network_sdr_client_port", receiver.port)
    main(["-tx", "-d", "Network SDR", "-f", "433.92e6", "-s", "1e6", "-sps", "100",
          "-p", "1000", "-m", *TX_MESSAGES, *flags])
    return receiver.samples()


@pytest.mark.parametrize("flags", [("-mo", "FSK", "-pm", "-25000", "25000"),
                                   ("-mo", "ASK", "-pm", "0", "1", "-cf", "10e3"),
                                   ("-mo", "PSK", "-pm", "0", "180", "-cf", "40e3"),
                                   ("-mo", "FSK", "-bps", "2", "-pm", "-30000", "-10000", "10k",
                                    "30k")])
def test_transmit_over_network_sdr_equals_urh_tpu(config, tmp_path, capsys, flags):
    got = _transmit(cli.main, config, tmp_path, *flags)
    want = _transmit(jax_cli.main, config, tmp_path, *flags)
    assert "Successfully modulated 4 messages" in capsys.readouterr().out
    assert got.shape == want.shape
    atol = TX_ULPS * float(np.finfo(np.float32).eps)
    assert np.abs(got.astype(np.float64) - want).max() <= atol

    # word for word the port's Modulator.modulate of each message, pauses zero
    args = cli.create_parser().parse_args(["-d", "Network SDR", "-s", "1e6", "-sps", "100",
                                           *flags])
    for attr, default in (("carrier_frequency", cli.DEFAULT_CARRIER_FREQUENCY),
                          ("carrier_amplitude", cli.DEFAULT_CARRIER_AMPLITUDE),
                          ("carrier_phase", cli.DEFAULT_CARRIER_PHASE)):
        if getattr(args, attr) is None:
            setattr(args, attr, default)
    modulator = cli.build_modulator_from_args(args)
    # the buffer holds len(bits) * samples_per_symbol + pause samples a
    # message, as urh_tpu's does: zeros past the symbols when a symbol holds
    # more than one bit
    want = np.zeros((sum(len(b) * 100 + 1000 for b in TX_MESSAGES), 2), np.float32)
    pos = 0
    for bits in TX_MESSAGES:
        part = modulator.modulate(bits, pause=0, device="cpu").data
        want[pos:pos + len(part)] = part
        pos += len(part) + 1000
    assert np.array_equal(got, want)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


RX_LINES = ["1010101100110110", "1111000010101111", "10011100", "11" * 16]


def _receive(main, tmp_path, name: str) -> list:
    port = _free_port()
    _write_setting("network_sdr_server_port", port)
    out = tmp_path / name
    thread = threading.Thread(target=main, args=(
        ["-rx", "-d", "Network SDR", "-f", "433.92e6", "-s", "1e6", "-pm", "0", "1",
         "-rt", "1.5", "-file", str(out)],), daemon=True)
    thread.start()
    deadline = time.monotonic() + DEADLINE_S
    while True:
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=1)
            break
        except OSError:
            assert time.monotonic() < deadline, "the receive server did not start"
            time.sleep(0.01)
    from urh_tpu_torch.dev.network_sdr import bytes_from_bits

    with sock:
        sock.sendall(b"".join(bytes_from_bits(bits) + b"\n" for bits in RX_LINES))
    thread.join(DEADLINE_S)
    assert not thread.is_alive()
    return out.read_text().splitlines()


def test_receive_from_network_sdr_writes_what_urh_tpu_writes(config, tmp_path, capsys):
    got = _receive(cli.main, tmp_path, "port.txt")
    want = _receive(jax_cli.main, tmp_path, "jax.txt")
    assert got == want == RX_LINES
    out = capsys.readouterr().out
    assert "Receiving for 1.5 seconds..." in out and "Received data written to" in out


def test_main_sets_the_log_level_as_urh_tpu(config, tmp_path):
    for verbose, level in (([], logging.ERROR), (["-v"], logging.INFO),
                           (["-v", "-v"], logging.DEBUG)):
        for main, module in ((cli.main, urh_logging), (jax_cli.main, jax_logging)):
            receiver = _Receiver()
            _write_setting("network_sdr_client_port", receiver.port)
            main(["-tx", "-d", "Network SDR", "-f", "1e6", "-s", "1e6", "-mo", "ASK", "-pm",
                  "0", "1", "-m", "1010", *verbose])
            receiver.samples()
            assert module.logger.level == level
            with open(module.LOG_LEVEL_PATH) as f:
                assert int(f.read()) == level
