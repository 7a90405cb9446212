"""The host utilities and the settings writes against urh_tpu's.

Formatter strings, CSV samples and sample rates, saved and extracted
files, PCAP bytes and find_nearest_center are compared with urh_tpu's on
the same input, exactly.  The settings store is urh_tpu's JSON file, kept
here in a temporary config dir: a key written by one package is read
back by the other.
"""

import os
import random
import tarfile
import time
from zipfile import ZipFile

import numpy as np
import pytest
import torch

from urh_tpu.dev import backend_handler as jax_backend_handler
from urh_tpu.dev import pcap as jax_pcap
from urh_tpu.dsp import symbols as jax_symbols
from urh_tpu.plugins import manager as jax_manager
from urh_tpu.protocol.analyzer import ProtocolAnalyzer as JaxProtocolAnalyzer
from urh_tpu.protocol.message import Message as JaxMessage
from urh_tpu.util import colormaps as jax_colormaps
from urh_tpu.util import csv_import as jax_csv_import
from urh_tpu.util import file_operator as jax_file_operator
from urh_tpu.util import settings as jax_settings
from urh_tpu.util.formatter import Formatter as JaxFormatter
from urh_tpu_torch.core.iq import IQData
from urh_tpu_torch.core.signal import Signal
from urh_tpu_torch.dev import backend_handler, pcap
from urh_tpu_torch.dsp import symbols
from urh_tpu_torch.plugins import manager
from urh_tpu_torch.protocol.analyzer import ProtocolAnalyzer
from urh_tpu_torch.protocol.message import Message
from urh_tpu_torch.util import colormaps, csv_import, file_operator, settings
from urh_tpu_torch.util.formatter import Formatter

torch.set_num_threads(1)


@pytest.fixture
def config(tmp_path, monkeypatch):
    """Both packages' settings store in one temporary config dir, unread."""
    folder = tmp_path / "urh_tpu"
    for module in (settings, jax_settings):
        monkeypatch.setattr(module, "_config_dir", str(folder))
        monkeypatch.setattr(module, "_settings_file", str(folder / "settings.json"))
        monkeypatch.setattr(module, "_store", None)
    return folder


def _reread(module, monkeypatch):
    """The module's next read goes to the file, as a new process's would."""
    monkeypatch.setattr(module, "_store", None)


# -- formatter ------------------------------------------------------------------


@pytest.mark.parametrize("value", [0.0, 1e-10, 1e-7, 2.5e-4, 0.3, 1.0, 42.0, 2e3, 433.92e6,
                                   -1.5e9, 7e12])
def test_formatter_strings_equal_urh_tpu(value):
    for decimals in (0, 2, 3):
        for strip in (True, False):
            assert (Formatter.big_value_with_suffix(value, decimals, strip)
                    == JaxFormatter.big_value_with_suffix(value, decimals, strip))
        for append, remove in ((True, False), (False, True)):
            assert (Formatter.science_time(value, decimals, append, remove)
                    == JaxFormatter.science_time(value, decimals, append, remove))
    assert Formatter.local_decimal_seperator() == JaxFormatter.local_decimal_seperator()


def test_formatter_str2val_equals_urh_tpu():
    for text, dtype, default in (("42", int, 0), ("nope", int, 7), ("2.5", float, 0.0),
                                 (None, float, 1.5), ("1e3", float, 0.0), ("x", str, "y")):
        assert Formatter.str2val(text, dtype, default) == JaxFormatter.str2val(
            text, dtype, default)


# -- CSV import ---------------------------------------------------------------------


def _write_csv(path, sep=",", rows=150, seed=0):
    random.seed(seed)
    with open(path, "w") as f:
        f.write("this is a comment\n")
        f.write("format is\n")
        f.write("Timestamp I Q Trash\n")
        for i in range(rows):
            f.write("{}{sep}{}{sep}{}{sep}{}\n".format(
                i / 1e6, i, random.uniform(0, 1), 42 * i, sep=sep))


@pytest.mark.parametrize("sep,read_sep,cols", [
    (",", ",", (1, 2, 0)), (";", ";", (1, 2, 0)), (";", ",", (1, 2, 0)),
    (",", ",", (1, -1, -1)), (",", ",", (2, -1, 0)), (",", ",", (-1, -1, -1))])
def test_csv_samples_and_rate_equal_urh_tpu(tmp_path, sep, read_sep, cols):
    path = str(tmp_path / "capture.csv")
    _write_csv(path, sep)
    data, rate = csv_import.parse_csv_file(path, read_sep, *cols)
    want_data, want_rate = jax_csv_import.parse_csv_file(path, read_sep, *cols)
    assert data.dtype == want_data.dtype and np.array_equal(data, want_data)
    assert rate == want_rate


def test_csv_to_signal_on_its_device(tmp_path):
    path = str(tmp_path / "ionly.csv")
    with open(path, "w") as f:
        for i in range(64):
            f.write("{}\n".format(np.sin(2 * np.pi * i / 8)))
    sig = csv_import.csv_to_signal(path, i_data_col=0, device="cpu")
    want, _ = jax_csv_import.parse_csv_file(path, ",", 0)
    assert sig.device == torch.device("cpu") and sig.sample_rate == 1e6
    assert np.array_equal(sig.iq_array.as_complex64(), want)
    assert csv_import.estimate_sample_rate([0.0]) is None
    assert csv_import.estimate_sample_rate(np.arange(5) * 2e-6) == pytest.approx(5e5)


# -- file operator ----------------------------------------------------------------------


@pytest.mark.parametrize("ext", [".wav", ".coco", ".sub", ".complex", ".cs8"])
@pytest.mark.parametrize("dtype", [np.int16, np.int8, np.float32])
def test_saved_files_equal_urh_tpu(tmp_path, ext, dtype):
    data = (np.random.default_rng(1).uniform(-0.9, 0.9, (500, 2))
            * (1 if dtype == np.float32 else np.iinfo(dtype).max)).astype(dtype)
    ours, theirs = str(tmp_path / f"a{ext}"), str(tmp_path / f"b{ext}")
    file_operator.save_data(data, ours)
    jax_file_operator.save_data(data, theirs)
    if ext == ".coco":  # a bz2 tar of one temporary file: compare what it holds
        with tarfile.open(ours) as a, tarfile.open(theirs) as b:
            assert len(a.getmembers()) == len(b.getmembers()) == 1
            assert (a.extractfile(a.getmembers()[0]).read()
                    == b.extractfile(b.getmembers()[0]).read())
    else:
        assert open(ours, "rb").read() == open(theirs, "rb").read()
    file_operator.save_data(b"\x01\x02", ours)
    assert open(ours, "rb").read() == b"\x01\x02"


def test_save_signal_and_names_equal_urh_tpu(tmp_path):
    sig = Signal.from_iq(np.arange(32, dtype=np.float32).reshape(16, 2), device="cpu")
    path = file_operator.save_signal(sig, str(tmp_path / "x.complex"))
    assert os.path.getsize(path) == 16 * 8
    assert np.array_equal(IQData.from_file(path).data, sig.iq_array.data)
    for name in ("/a/b/test.complex", "x.tar.gz", None, 3):
        assert (file_operator.get_name_from_filename(name)
                == jax_file_operator.get_name_from_filename(name))
    assert file_operator.get_open_filename_filters() == (
        jax_file_operator.get_open_filename_filters())


def test_uncompress_archives_equals_urh_tpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with tarfile.open("test.tar.gz", "w:gz") as tar:
        for name in ["1.complex", "2.complex", "3.complex"]:
            np.ones(10, dtype=np.complex64).tofile(name)
            tar.add(name)
    with ZipFile("test.zip", "w") as zipf:
        for name in ["4.complex", "5.complex"]:
            np.ones(20, dtype=np.complex64).tofile(name)
            zipf.write(name)
    outputs = []
    for module, folder in ((file_operator, "ours"), (jax_file_operator, "theirs")):
        os.makedirs(folder)
        outputs.append(module.uncompress_archives(["test.tar.gz", "test.zip", "x.txt"], folder))
    ours, theirs = outputs
    assert [os.path.relpath(p, "ours") for p in ours[:5]] == [
        os.path.relpath(p, "theirs") for p in theirs[:5]]
    assert ours[5] == theirs[5] == "x.txt"
    for a, b in zip(ours[:5], theirs[:5]):
        assert open(a, "rb").read() == open(b, "rb").read()


# -- PCAP ---------------------------------------------------------------------------------


def test_pcap_bytes_equal_urh_tpu(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    rows = ([1, 1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 0, 1, 1], [1, 1, 1, 0, 1], [0] * 40)
    files = []
    for pa, message, module in ((ProtocolAnalyzer(None), Message, pcap),
                                (JaxProtocolAnalyzer(None), JaxMessage, jax_pcap)):
        for i, bits in enumerate(rows):
            pa.messages.append(message(bits, 1000 * (i + 1), pa.default_message_type,
                                       samples_per_symbol=100,
                                       bit_sample_pos=list(range(0, 100 * len(bits) + 1, 100))))
        files.append(str(tmp_path / f"{module.__name__}.pcap"))
        module.PCAP().write_packets(pa.messages, files[-1], 1e6)
    assert open(files[0], "rb").read() == open(files[1], "rb").read()
    assert pcap.global_header() == jax_pcap.global_header()
    assert pcap.record(123_456_789_012, b"ab") == jax_pcap.record(123_456_789_012, b"ab")
    assert pcap.PCAP.get_seconds_nseconds(2.5) == jax_pcap.PCAP.get_seconds_nseconds(2.5)


# -- find_nearest_center ------------------------------------------------------------------


def test_find_nearest_center_equals_urh_tpu():
    rng = np.random.default_rng(3)
    centers = np.array([-0.5, -0.1, 0.2, 0.7])
    for sample in list(rng.uniform(-1, 1, 200)) + [-0.3, 0.45, -0.1]:
        assert (symbols.find_nearest_center(sample, centers)
                == jax_symbols.find_nearest_center(sample, centers))


# -- the settings writes ------------------------------------------------------------------


def test_settings_written_by_one_package_are_read_by_the_other(config, monkeypatch):
    settings.write("port_key", 3)
    _reread(jax_settings, monkeypatch)
    assert jax_settings.read("port_key", 0, int) == 3
    jax_settings.write("urh_tpu_key", "x")
    _reread(settings, monkeypatch)
    assert settings.read("urh_tpu_key") == "x" and settings.read("port_key", 0, int) == 3
    assert sorted(settings.all_keys()) == ["port_key", "urh_tpu_key"]
    settings.sync()
    assert sorted(os.listdir(config)) == ["settings.json"]  # no temporary file left


def test_settings_writers_are_read_back_by_urh_tpu(config, monkeypatch):
    name = [n for n in jax_colormaps.maps if n != jax_colormaps.default_colormap][0]
    colormaps.write_selected_colormap_to_settings(name)
    container = backend_handler.BackendContainer(
        "HackRF", {backend_handler.Backends.native}, True, True)
    container.set_enabled(False)
    container.write_settings()
    plugin = manager.Plugin("ZeroHide")
    plugin.write_setting("following_zeros", 42)

    _reread(jax_settings, monkeypatch)
    assert jax_colormaps.read_selected_colormap_name_from_settings() == name
    jax_container = jax_backend_handler.BackendContainer(
        "HackRF", {jax_backend_handler.Backends.native, jax_backend_handler.Backends.grc},
        True, True)
    assert not jax_container.is_enabled
    assert jax_container.selected_backend == jax_backend_handler.Backends.native
    assert jax_manager.Plugin("ZeroHide").read_setting("following_zeros", 0, int) == 42

    # and urh_tpu's writes read back by the port
    jax_container.set_enabled(True)
    jax_manager.Plugin("ZeroHide").write_setting("following_zeros", 7)
    jax_colormaps.write_selected_colormap_to_settings(jax_colormaps.default_colormap)
    _reread(settings, monkeypatch)
    assert container.is_enabled
    assert plugin.read_setting("following_zeros", 0, int) == 7
    assert colormaps.read_selected_colormap_name_from_settings() == jax_colormaps.default_colormap
