"""urh_tpu_torch stands alone: no JAX, no urh_tpu, and the card by default."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import urh_tpu_torch
from urh_tpu_torch.core.signal import Signal

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# matches "import jax", "from jax.x import", "import urh_tpu", "from urh_tpu.x"
# but not urh_tpu_torch
FORBIDDEN_IMPORT = re.compile(r"^\s*(?:import|from)\s+(?:jax|urh_tpu)\b", re.M)

DEMOD_WITHOUT_JAX = r"""
import sys
import time
sys.modules["jax"] = None  # any import of jax now fails
sys.path.insert(0, sys.argv[1])  # packages jax and urh_tpu there raise, in spawned children too
import numpy as np
import urh_tpu_torch as ut


def message_bits(pulses):
    bits, _, _ = ut.ProtocolAnalyzer._ppseq_to_bits(pulses, 100, 1)
    return ["".join(map(str, b)) for b in bits]

bits = np.array([1, 0, 1, 1, 0, 0, 1, 0] * 4)
phase = np.cumsum(np.repeat(np.where(bits == 1, 0.12, -0.12), 100))
iq = np.zeros((len(phase) + 2000, 2), np.float32)
iq[1000:1000 + len(phase), 0] = np.cos(phase)
iq[1000:1000 + len(phase), 1] = np.sin(phase)
params = ut.DemodParams(modulation="FSK", noise_threshold=0.1)
messages = ut.demodulate(iq, params, device="cpu")
assert [m.plain_bits_str for m in messages] == ["".join(map(str, bits))], messages
sd = ut.StreamDemodulator(params, device="cpu")
segments = [s for i in range(0, len(iq), 1000) for s in sd.feed(iq[i:i + 1000])]
segments += sd.flush()
assert len(segments) == 1 and segments[0].ppseq[0, 0] != -1, segments
modulator = ut.Modulator()
modulator.modulation_type = "FSK"
modulator.parameters = [-20e3, 20e3]
tx = modulator.modulate("10110010" * 8, pause=3000, device="cpu").data
tx = np.concatenate([tx] * 4)
tx = tx + np.random.default_rng(0).normal(0, 0.01, tx.shape).astype(np.float32)
found = ut.estimate(tx, device="cpu")
assert (found["modulation_type"], found["bit_length"]) == ("FSK", 100), found
from urh_tpu_torch.awre.format_finder import FormatFinder
from urh_tpu_torch.dsp.decimation import create_path
from urh_tpu_torch.dsp.filters import Filter, iir_filter
from urh_tpu_torch.dsp.spectrogram import Spectrogram
sig = ut.Signal.from_iq(iq, device="cpu")
sig.params = params
sig.qad
sig.filter_range(0, len(iq), Filter(Filter.design_windowed_sinc_bandpass(-0.05, 0.05, 0.08)))
assert [m.plain_bits_str for m in ut.demodulate(sig)] == ["".join(map(str, bits))]
assert iir_filter([1.0, -1.0], [0.9], iq[:, 0], device="cpu").shape == (len(iq),)
assert Spectrogram(iq, window_size=256, device="cpu").create_spectrogram_image().ndim == 3
assert len(create_path(iq[:, 0], 0, len(iq), device="cpu")) == 1
proto = ut.ProtocolAnalyzer(sig)
proto.messages = [m for _ in range(4) for m in ut.demodulate(sig)]
proto.auto_assign_labels()
assert FormatFinder(proto.messages, device="cpu").message_types
from urh_tpu_torch.dev.backend_handler import BackendHandler
from urh_tpu_torch.dsp.continuous_modulator import ContinuousModulator
from urh_tpu_torch.protocol.container import ProtocolAnalyzerContainer
from urh_tpu_torch.protocol.generator import GeneratorBackend
from urh_tpu_torch.protocol.sniffer import ProtocolSniffer
from urh_tpu_torch.util import settings
settings.OVERWRITE_RECEIVE_BUFFER_SIZE = 100000
sniffer = ProtocolSniffer(100, 0.0, 0.1, 0.1, 5, "FSK", 1, "Network SDR", BackendHandler(),
                          network_raw_mode=True, compute_device="cpu")
sniffer._stream = sniffer._make_stream()
for i in range(0, len(iq), 1000):
    sniffer._ingest(iq[i:i + 1000])
sniffer._emit_segments(sniffer._stream.flush())
assert sniffer.plain_bits_str == ["".join(map(str, bits))], sniffer.plain_bits_str
container = ProtocolAnalyzerContainer.from_string(["10110010" * 8] * 3, default_pause=3000)
buffer = GeneratorBackend(container, [modulator], device="cpu").generate()
assert len(buffer) == 3 * (64 * 100 + 3000), len(buffer)
continuous = ContinuousModulator(container.messages, [modulator], num_repeats=1, device="cpu")
continuous.start()
deadline = time.monotonic() + 60
while continuous.ring_buffer.is_empty and time.monotonic() < deadline:
    time.sleep(0.01)
assert not continuous.ring_buffer.is_empty
continuous.process.join(60)
assert continuous.process.exitcode == 0, continuous.process.exitcode
continuous.stop()
import urh_tpu_torch.dev.device
import urh_tpu_torch.dev.gr.base_thread
import urh_tpu_torch.dev.gr.device_table
import urh_tpu_torch.dev.gr.generate_scripts
import urh_tpu_torch.dev.native_devices
import urh_tpu_torch.dev.rtl_tcp
import urh_tpu_torch.dev.vendor_libs
import urh_tpu_torch.sim.configuration
import urh_tpu_torch.sim.expression_parser
import urh_tpu_torch.sim.items
import urh_tpu_torch.sim.simulator
import urh_tpu_torch.util.project
import urh_tpu_torch.dev.pcap
import urh_tpu_torch.util.csv_import
import urh_tpu_torch.util.file_operator
import urh_tpu_torch.util.formatter
import urh_tpu_torch.util.placement
from urh_tpu_torch.dev.virtual_device import Mode, VirtualDevice
rtl = VirtualDevice(BackendHandler(), "RTL-TCP", Mode.receive)
assert type(rtl._dev).__name__ == "RTLSDRTCP" and rtl.data_type == np.int8
from urh_tpu_torch.parallel import distributed, sharded
mesh = sharded.make_mesh(8, device="cpu")
pulses = sharded.sharded_pulse_lens(iq, 0.1, "FSK", 0.0, 1.0, 1, 5, 100, mesh=mesh)
assert message_bits(pulses) == ["".join(map(str, bits))]
assert sharded.sharded_psk_demod(iq[:2000], 0.1, mesh=mesh).shape == (2000,)
assert len(distributed.distributed_fir_filter(iq[:, 0], [1.0, 0.5],
                                              mesh=distributed.global_mesh(2, device="cpu"))) == 2
import urh_tpu_torch.cli.main
import urh_tpu_torch.plugins
import urh_tpu_torch.ui.actions
import urh_tpu_torch.ui.models
import urh_tpu_torch.ui.plots
import urh_tpu_torch.ui.png
import urh_tpu_torch.ui.widgets
from urh_tpu_torch.plugins import PluginManager
assert len(PluginManager().installed_plugins) == 6
from urh_tpu_torch.ui.actions import EditAction, EditSignalAction
from urh_tpu_torch.ui.undo import UndoStack
stack = UndoStack()
stack.push(EditSignalAction(sig, EditAction.mute, start=0, end=1000))
stack.undo()
assert [m.plain_bits_str for m in ut.demodulate(sig)] == ["".join(map(str, bits))]
import os
from urh_tpu_torch.ui import dialogs
from urh_tpu_torch.ui.controllers import MainController
from urh_tpu_torch.ui.web import WebUI
capture = os.path.join(sys.argv[1], "capture.complex")
np.concatenate([tx, tx]).tofile(capture)
web = WebUI(device="cpu")
assert isinstance(web.main, MainController) and str(web.device) == "cpu"
assert web.open_signal(None, {"path": capture})["id"] == 0
web.signal_set_params(0, None, {"modulation_type": "FSK", "samples_per_symbol": 100,
                                "center": 0.0, "noise_threshold": 0.1})
assert web.signal_messages(0, {}, None)["messages"] == ["10110010" * 8] * 8
assert web.signal_autodetect(0, None, None)["success"]
png, kind = web.signal_spectrogram(0, {"window": ["256"]}, None)
assert kind == "image/png" and png.startswith(b"\x89PNG")
web.analysis_add(None, {"signal_id": 0})
assert web.analysis_awre(None, None)["message_types"]
web.generator_add(None, {"signal_id": 0})
assert web.generator_generate(None, {})["samples"] > 0
dialogs.SignalDetailsDialogController(web.main.signal_frames[0].signal)
loaded = [m for m in sys.modules if m == "urh_tpu" or m.startswith("urh_tpu.")]
assert not loaded, loaded
print("ok")
"""


def test_demodulates_with_jax_unimportable_and_loads_no_urh_tpu(tmp_path):
    """Offline demodulate(), a stream, Modulator.modulate, estimate(),
    filter_range, the IIR filter, a spectrogram, a plot path, awre, the
    sniffer's ingest, GeneratorBackend and a ContinuousModulator's spawned
    child, in a process where JAX cannot be imported (and, for the child,
    neither JAX nor urh_tpu); then the simulator, the project manager and
    every hardware backend module import, an RTL-TCP VirtualDevice builds
    its device, the sharded pipeline (demod to bits, block-parallel PSK)
    and a distributed FIR outside a process group run, and the web app's
    routes (open, params, messages, autodetect, spectrogram, awre, generate)
    run their function-local imports."""
    for name in ("jax", "urh_tpu"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('{name} imported by urh_tpu_torch')\n")
    out = subprocess.run([sys.executable, "-c", DEMOD_WITHOUT_JAX, str(tmp_path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _port_sources():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "urh_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_sources_import_neither_jax_nor_urh_tpu():
    offenders = []
    scanned = {os.path.relpath(path, ROOT) for path in _port_sources()}
    for name in ("cli/main.py", "cli/__main__.py", "plugins/rfcat.py", "plugins/insert_sine.py",
                 "ui/actions.py", "ui/models.py", "ui/plots.py", "ui/widgets.py", "ui/dialogs.py",
                 "ui/web.py", "ui/controllers/__init__.py", "ui/controllers/compare_frame.py",
                 "ui/controllers/generator_tab.py", "ui/controllers/main.py",
                 "ui/controllers/signal_frame.py", "ui/controllers/simulator_tab.py"):
        assert os.path.join("urh_tpu_torch", name) in scanned
    for path in _port_sources():
        with open(path) as f:
            offenders += [f"{path}: {m.group(0).strip()}"
                          for m in FORBIDDEN_IMPORT.finditer(f.read())]
    assert not offenders
    assert FORBIDDEN_IMPORT.search("from urh_tpu.core import x")
    assert FORBIDDEN_IMPORT.search("  import jax.numpy as jnp")
    assert not FORBIDDEN_IMPORT.search("from urh_tpu_torch.core import x")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    iq = np.zeros((1000, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        urh_tpu_torch.demodulate(iq)
    with pytest.raises(RuntimeError, match="CUDA"):
        Signal()
    with pytest.raises(RuntimeError, match="CUDA"):
        Signal.from_iq(iq)
    with pytest.raises(RuntimeError, match="CUDA"):
        urh_tpu_torch.afp_demod(iq, 0.1, "FSK")
    with pytest.raises(RuntimeError, match="CUDA"):
        urh_tpu_torch.StreamDemodulator(urh_tpu_torch.DemodParams())
    with pytest.raises(RuntimeError, match="CUDA"):
        urh_tpu_torch.estimate(iq)
    with pytest.raises(RuntimeError, match="CUDA"):
        urh_tpu_torch.Modulator().modulate("1010")
    from urh_tpu_torch.awre.format_finder import FormatFinder
    from urh_tpu_torch.dsp.decimation import create_path
    from urh_tpu_torch.dsp.filters import Filter, fir_filter, iir_filter
    from urh_tpu_torch.dsp.spectrogram import Spectrogram
    from urh_tpu_torch.dev.backend_handler import BackendHandler
    from urh_tpu_torch.dsp.continuous_modulator import ContinuousModulator
    from urh_tpu_torch.protocol.container import ProtocolAnalyzerContainer
    from urh_tpu_torch.protocol.generator import GeneratorBackend
    from urh_tpu_torch.protocol.sniffer import ProtocolSniffer

    sniffer = lambda: ProtocolSniffer(100, 0.0, 0.1, 0.1, 5, "FSK", 1, "Network SDR",
                                      BackendHandler(), network_raw_mode=False)
    from urh_tpu_torch.sim.simulator import Simulator

    from urh_tpu_torch.parallel import distributed, sharded

    for call in (sniffer, lambda: GeneratorBackend(ProtocolAnalyzerContainer()),
                 lambda: ContinuousModulator([], [urh_tpu_torch.Modulator()]),
                 lambda: Simulator(None, [], None, None, None, None), sharded.make_mesh,
                 lambda: sharded.sharded_demodulate(iq, 0.1, "FSK", 0.0, 1.0, 1),
                 lambda: sharded.sharded_psk_demod(iq, 0.1), distributed.global_mesh,
                 lambda: distributed.distributed_pulse_lens(iq, 0.1, "FSK", 0.0, 1.0, 1, 5,
                                                            100),
                 lambda: distributed.distributed_psk_demod_exact(iq, 0.1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    x = np.ones(20000, np.complex64)  # four samples a pixel of a plot path
    for call in (lambda: fir_filter(x, np.ones(3)), lambda: iir_filter([1.0], [0.5], x),
                 lambda: Filter.fft_convolve_1d(x, np.ones(3)), lambda: Spectrogram(x),
                 lambda: create_path(x.real, 0, len(x)), lambda: FormatFinder([])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # "auto" places work between the card and the CPU only where a card is
    # present: without one it raises as the default does, at every entry point
    from urh_tpu_torch.ai import device as ai_device
    from urh_tpu_torch.awre import device as awre_device
    from urh_tpu_torch.dsp.modulate import modulate
    from urh_tpu_torch.util.csv_import import csv_to_signal

    auto = "auto"
    rows = torch.zeros(2, 100)
    data, lengths = awre_device.pack_messages([np.zeros(8, np.uint8)] * 2)
    for call in (lambda: urh_tpu_torch.demodulate(iq, device=auto), lambda: Signal(device=auto),
                 lambda: Signal.from_iq(iq, device=auto),
                 lambda: urh_tpu_torch.afp_demod(iq, 0.1, "FSK", device=auto),
                 lambda: urh_tpu_torch.afp_demod(iq, 0.1, "PSK", device=auto),
                 lambda: urh_tpu_torch.StreamDemodulator(urh_tpu_torch.DemodParams(),
                                                         device=auto),
                 lambda: urh_tpu_torch.estimate(iq, device=auto),
                 lambda: urh_tpu_torch.Modulator().modulate("1010", device=auto),
                 lambda: modulate([1, 0], 100, "fsk", [-1e3, 1e3], device=auto),
                 lambda: ai_device.median_filter_rows(rows, 11, device=auto),
                 lambda: ai_device.classification_stats(np.ones((2, 100), np.complex64),
                                                        device=auto),
                 lambda: ai_device.histogram(np.zeros(10, np.float32), np.arange(3.0),
                                             device=auto),
                 lambda: awre_device.first_difference_matrix(data, lengths, device=auto),
                 lambda: awre_device.column_agreement(data, lengths, device=auto),
                 lambda: awre_device.ngram_values(data, lengths, 4, device=auto),
                 lambda: awre_device.occurrence_matrix(data, lengths, [[0, 0]], device=auto),
                 lambda: awre_device.batched_crc(np.zeros((2, 8), np.uint8), [1, 1, 1], [0, 0],
                                                 [0, 0], device=auto),
                 lambda: ProtocolSniffer(100, 0.0, 0.1, 0.1, 5, "FSK", 1, "Network SDR",
                                         BackendHandler(), compute_device=auto),
                 lambda: GeneratorBackend(ProtocolAnalyzerContainer(), device=auto),
                 lambda: ContinuousModulator([], [urh_tpu_torch.Modulator()], device=auto),
                 lambda: Simulator(None, [], None, None, None, None, device=auto),
                 lambda: sharded.make_mesh(device=auto), lambda: distributed.global_mesh(
                     device=auto), lambda: fir_filter(x, np.ones(3), device=auto),
                 lambda: iir_filter([1.0], [0.5], x, device=auto),
                 lambda: Filter.fft_convolve_1d(x, np.ones(3), device=auto),
                 lambda: Spectrogram(x, device=auto),
                 lambda: create_path(x.real, 0, len(x), device=auto),
                 lambda: FormatFinder([], device=auto)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(RuntimeError, match="CUDA"):
        csv_to_signal(os.path.join(ROOT, "pyproject.toml"), device=auto)
    # the CLI with URH_TPU_TORCH_DEVICE unset runs on the card: without one it
    # raises, never falls back to the CPU; the UI's actions edit on the card
    import multiprocessing

    from urh_tpu_torch.cli import main as cli
    from urh_tpu_torch.ui.actions import EditAction, EditSignalAction
    from urh_tpu_torch.util import logging as urh_logging
    from urh_tpu_torch.util import settings

    monkeypatch.delenv(cli.DEVICE_ENV, raising=False)
    monkeypatch.setattr(multiprocessing, "set_start_method", lambda *a, **k: None)
    monkeypatch.setattr(urh_logging, "LOG_LEVEL_PATH", os.devnull)
    monkeypatch.setattr(settings, "_store", {})
    level = urh_logging.logger.level
    capture = os.path.join(ROOT, "pyproject.toml")
    radio = ["-f", "433.92e6", "-s", "1e6", "-pm", "0", "1", "-mo", "ASK"]
    for argv in (["--estimate", "-file", capture],
                 ["-tx", "-d", "Network SDR", "-m", "1010", *radio],
                 ["-rx", "-d", "Network SDR", "-rt", "0", *radio]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    urh_logging.logger.setLevel(level)
    with pytest.raises(RuntimeError, match="CUDA"):
        EditSignalAction(Signal(), EditAction.mute, start=0, end=10)
    # the controllers and the web app, its console script with no arguments
    from urh_tpu_torch.ui import web
    from urh_tpu_torch.ui.controllers import MainController

    monkeypatch.setattr(sys, "argv", ["urh_tpu_torch-web"])
    for call in (MainController, web.WebUI, web.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # an explicit device is honoured
    assert Signal.from_iq(iq, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("value", ["gpu", "cuda:first", "npu"])
def test_the_cli_refuses_an_unknown_compute_device(monkeypatch, value):
    from urh_tpu_torch.cli import main as cli

    monkeypatch.setenv(cli.DEVICE_ENV, value)
    with pytest.raises(ValueError, match=cli.DEVICE_ENV):
        cli.main(["--estimate", "-file", os.path.join(ROOT, "pyproject.toml")])


@pytest.mark.parametrize("value", ["gpu", "cuda:first", ""])
def test_the_web_app_refuses_an_unknown_compute_device(monkeypatch, value):
    from urh_tpu_torch.cli import main as cli
    from urh_tpu_torch.ui import web

    served = []
    monkeypatch.setattr(web, "serve", lambda **kwargs: served.append(kwargs))
    monkeypatch.delenv(cli.DEVICE_ENV, raising=False)
    with pytest.raises(ValueError, match="--device"):
        web.main(["--device", value])
    if value:
        monkeypatch.setenv(cli.DEVICE_ENV, value)
        with pytest.raises(ValueError, match=cli.DEVICE_ENV):
            web.main([])
    assert not served
    # a known value is what the server computes on, --device before the environment
    monkeypatch.setenv(cli.DEVICE_ENV, "cuda:1")
    web.main(["--device", "cpu", "--port", "0"])
    web.main([])
    assert [s["device"] for s in served] == ["cpu", "cuda:1"]


def test_demodulate_rejects_a_device_other_than_the_signals():
    sig = Signal.from_iq(np.zeros((1000, 2), np.float32), device="cpu")
    with pytest.raises(ValueError):
        urh_tpu_torch.demodulate(sig, device="cuda:0")
