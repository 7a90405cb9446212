"""The port's plugins against urh_tpu's (the cases of
tests/test_plugins_and_decimation.py, create_path aside).

Every output is compared exactly: the sine's samples (float32, int8 and
int16 signals), the broken and the zero-hidden messages, the Flipper
``.sub`` bytes, the statements and the command line the RfCat plugin
gives a fake ``rfcat`` on disk, the discovered plugins and their enabled
state kept in the settings store, which both packages share here in a
temporary config dir.  An insert into a signal whose samples and qad sit
on the port's device is read by the next demodulation.
"""

import os
import stat
import sys

import numpy as np
import pytest
import torch

import urh_tpu as jax_ut
import urh_tpu_torch as ut
from urh_tpu import plugins as jax_plugins
from urh_tpu.dsp.modulate import modulate as jax_modulate
from urh_tpu.dsp.modulator import Modulator as JaxModulator
from urh_tpu.protocol.analyzer import ProtocolAnalyzer as JaxProtocolAnalyzer
from urh_tpu.protocol.message import Message as JaxMessage
from urh_tpu.util import settings as jax_settings
from urh_tpu.util.project import ProjectManager as JaxProjectManager
from urh_tpu_torch import plugins
from urh_tpu_torch.dsp.modulator import Modulator
from urh_tpu_torch.protocol.analyzer import ProtocolAnalyzer
from urh_tpu_torch.protocol.message import Message
from urh_tpu_torch.util import settings
from urh_tpu_torch.util.project import ProjectManager

torch.set_num_threads(1)

DEADLINE_S = 30.0


@pytest.fixture
def config(tmp_path, monkeypatch):
    """Both packages' settings store in one temporary config dir, unread."""
    folder = tmp_path / "urh_tpu"
    for module in (settings, jax_settings):
        monkeypatch.setattr(module, "_config_dir", str(folder))
        monkeypatch.setattr(module, "_settings_file", str(folder / "settings.json"))
        monkeypatch.setattr(module, "_store", None)
    return folder


def test_installed_plugins_equal_urh_tpu(config):
    got = [(p.name, type(p).__name__) for p in plugins.get_installed_plugins()]
    want = [(p.name, type(p).__name__) for p in jax_plugins.get_installed_plugins()]
    assert got == want
    assert {name for name, _ in got} == {"InsertSine", "MessageBreak", "ZeroHide",
                                         "FlipperZeroSub", "RfCat"}


def test_plugin_framework_bases():
    from urh_tpu_torch.dev.network_sdr import NetworkSDRInterfacePlugin
    from urh_tpu_torch.plugins.rfcat import RfCatPlugin

    assert isinstance(plugins.MessageBreakPlugin(), plugins.ProtocolPlugin)
    assert isinstance(plugins.ZeroHidePlugin(), plugins.ProtocolPlugin)
    assert isinstance(plugins.InsertSinePlugin(), plugins.SignalEditorPlugin)
    assert isinstance(plugins.FlipperZeroSubPlugin(), plugins.SDRPlugin)
    assert isinstance(RfCatPlugin(), plugins.SDRPlugin)
    assert isinstance(NetworkSDRInterfacePlugin(), plugins.SDRPlugin)
    for plugin in plugins.get_installed_plugins():
        assert isinstance(plugin, plugins.Plugin)
    with pytest.raises(NotImplementedError):
        plugins.ProtocolPlugin("x").get_action(None)


# -- InsertSine -------------------------------------------------------------------------


def _sine(package_plugins, **params):
    plugin = package_plugins.InsertSinePlugin()
    for key, value in params.items():
        setattr(plugin, key, value)
    return plugin


SINES = (dict(frequency=100e3, sample_rate=1e6, num_samples=1000, amplitude=0.8),
         dict(frequency=-37e3, sample_rate=2e6, num_samples=777, amplitude=0.3, phase=1.1),
         dict(frequency=10e3, sample_rate=1e6, num_samples=1, amplitude=1.0))


@pytest.mark.parametrize("params", SINES)
@pytest.mark.parametrize("dtype", [np.float32, np.int8, np.int16])
def test_sine_samples_equal_urh_tpu(params, dtype):
    got = _sine(plugins, **params).generate_sine_wave(dtype=dtype)
    want = _sine(jax_plugins, **params).generate_sine_wave(dtype=dtype)
    assert got.dtype == want.dtype == dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_insert_into_signal_equals_urh_tpu(dtype):
    zeros = np.zeros((100, 2), dtype=dtype)
    sig = ut.Signal.from_iq(zeros, device="cpu")
    jax_sig = jax_ut.Signal.from_iq(zeros)
    _sine(plugins, **SINES[0]).insert_into_signal(sig, position=50)
    _sine(jax_plugins, **SINES[0]).insert_into_signal(jax_sig, position=50)
    assert sig.num_samples == 1100
    assert np.array_equal(sig.iq_array.data, jax_sig.iq_array.data)
    assert np.abs(sig.iq_array[:50]).max() == 0


def test_insert_is_read_by_the_next_demodulation():
    """An insert drops the staged device copy and the cached qad: the
    signal demodulated again gives what a fresh signal of the same
    samples gives, and urh_tpu's messages."""
    bits = np.array([1, 0, 1, 1, 0, 0, 1, 0] * 6, np.uint8)
    burst = jax_modulate(bits, 100, "fsk", [-20e3, 20e3], carrier_frequency=0.0, pause=0)
    iq = np.concatenate([np.zeros((3000, 2), np.float32), burst,
                         np.zeros((40000, 2), np.float32)])
    params = ut.DemodParams(modulation="FSK", noise_threshold=0.1, samples_per_symbol=100)
    sig = ut.Signal.from_iq(iq, device="cpu")
    sig.params = params
    assert len(ut.demodulate(sig)) == 1
    sig.iq_array.staged_planes(sig.device)
    plugin = _sine(plugins, frequency=20e3, sample_rate=1e6, num_samples=4800, amplitude=1.0)
    plugin.insert_into_signal(sig, position=20000)
    got = [m.plain_bits_str for m in ut.demodulate(sig)]
    fresh = ut.Signal.from_iq(sig.iq_array.data.copy(), device="cpu")
    fresh.params = params
    jax_sig = jax_ut.Signal.from_iq(sig.iq_array.data.copy())
    jax_sig.params = jax_ut.DemodParams(**vars(params))
    assert got == [m.plain_bits_str for m in ut.demodulate(fresh)]
    assert got == [m.plain_bits_str for m in jax_ut.demodulate(jax_sig)]
    assert len(got) == 2 and got[1] == "1" * 48


# -- MessageBreak and ZeroHide ------------------------------------------------------------


def _analyzers(strings, pause=500):
    pa = ProtocolAnalyzer(None, filename="x")
    jax_pa = JaxProtocolAnalyzer(None, filename="x")
    for s in strings:
        pa.messages.append(Message.from_plain_bits_str(s, pause=pause))
        jax_pa.messages.append(JaxMessage.from_plain_bits_str(s, pause=pause))
    return pa, jax_pa


def _state(pa):
    return [(m.plain_bits_str, m.decoded_bits_str, m.pause) for m in pa.messages]


@pytest.mark.parametrize("msg_nr,pos,view", [(0, 8, 0), (1, 3, 1), (0, 1, 2), (1, 0, 0)])
def test_message_break_equals_urh_tpu(msg_nr, pos, view):
    pa, jax_pa = _analyzers(["1010101011110000", "110011001100110011110000"])
    action = plugins.MessageBreakPlugin().get_action(pa, msg_nr, pos, view=view)
    jax_action = jax_plugins.MessageBreakPlugin().get_action(jax_pa, msg_nr, pos, view=view)
    before = _state(pa)
    action.redo()
    jax_action.redo()
    assert _state(pa) == _state(jax_pa) and len(pa.messages) == 3
    assert pa.messages[msg_nr + 1].pause == 500 and pa.messages[msg_nr].pause == 0
    action.undo()
    jax_action.undo()
    assert _state(pa) == _state(jax_pa) == before


@pytest.mark.parametrize("view", [0, 1, 2])
@pytest.mark.parametrize("following", [1, 4, 5, 9])
def test_zero_hide_equals_urh_tpu(config, view, following):
    strings = ["11110000000011", "0" * 40 + "1" * 8 + "0" * 16, "10" * 12]
    pa, jax_pa = _analyzers(strings)
    plugin, jax_plugin = plugins.ZeroHidePlugin(), jax_plugins.ZeroHidePlugin()
    assert plugin.following_zeros == jax_plugin.following_zeros == 5
    plugin.following_zeros = jax_plugin.following_zeros = following
    action, jax_action = plugin.get_action(pa, view=view), jax_plugin.get_action(jax_pa,
                                                                                 view=view)
    assert action.text == jax_action.text
    action.redo()
    jax_action.redo()
    assert _state(pa) == _state(jax_pa)
    assert plugin.zero_hide_offsets == jax_plugin.zero_hide_offsets
    action.undo()
    jax_action.undo()
    assert [m.decoded_bits_str for m in pa.messages] == strings


def test_zero_hide_reads_its_setting(config):
    settings.write("following_zeros", 7)
    jax_settings._store = None
    assert plugins.ZeroHidePlugin().following_zeros == 7
    assert jax_plugins.ZeroHidePlugin().following_zeros == 7


# -- FlipperZeroSub ---------------------------------------------------------------------


@pytest.mark.parametrize("mod,value", [("ASK", 1000), ("ASK", 100), ("FSK", 10), ("FSK", 30),
                                       ("GFSK", 0), ("PSK", 0), ("OQPSK", 0)])
def test_furi_hal_presets_equal_urh_tpu(mod, value):
    got = plugins.FlipperZeroSubPlugin().get_furi_hal_string(mod, value)
    assert got == jax_plugins.FlipperZeroSubPlugin().getFuriHalString(mod, value)


@pytest.mark.parametrize("modulation", ["ASK", "FSK"])
def test_sub_file_bytes_equal_urh_tpu(tmp_path, modulation):
    rng = np.random.default_rng(3)
    strings = ["".join(map(str, rng.integers(0, 2, n))) for n in (5, 300, 1500, 1)]
    written = []
    for package, pm_cls, mod_cls, msg_cls in (
            (plugins, ProjectManager, Modulator, Message),
            (jax_plugins, JaxProjectManager, JaxModulator, JaxMessage)):
        pm = pm_cls()
        pm.device_conf["frequency"] = 433920000
        messages = [msg_cls.from_plain_bits_str(s) for s in strings]
        for m in messages:
            m.samples_per_symbol = 100
        mod = mod_cls("m")
        mod.modulation_type = modulation
        path = tmp_path / f"{package.__name__}.sub"
        assert package.FlipperZeroSubPlugin().write_sub_file(str(path), messages, [1e6], [mod],
                                                             pm)
        written.append(path.read_bytes())
    assert written[0] == written[1]
    text = written[0].decode()
    assert text.startswith("Filetype: Flipper SubGhz RAW File\nVersion: 1\n")
    assert "RAW_Data: " in text
    assert not plugins.FlipperZeroSubPlugin().write_sub_file(str(tmp_path / "e.sub"), [], [],
                                                             [], None)


def test_signed_runs_equal_urh_tpu():
    from urh_tpu.plugins.flipper_zero_sub import signed_runs as jax_signed_runs
    from urh_tpu_torch.plugins.flipper_zero_sub import signed_runs

    rng = np.random.default_rng(4)
    for n in (0, 1, 2, 17, 1000):
        bits = rng.integers(0, 2, n)
        assert np.array_equal(signed_runs(bits), jax_signed_runs(bits))


# -- RfCat ------------------------------------------------------------------------------


def _fake_rfcat(folder):
    """An executable that logs its arguments, then every line of its stdin."""
    log = folder / "rfcat.log"
    fake = folder / "rfcat"
    fake.write_text(f"#!{sys.executable}\n"
                    "import sys\n"
                    f"log = open({str(log)!r}, 'a', buffering=1)\n"
                    "log.write(' '.join(sys.argv[1:]) + '\\n')\n"
                    "for line in sys.stdin:\n"
                    "    log.write(line)\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    return fake, log


def _rfcat_script(package, tmp_path, modulation: str, repeats: int) -> str:
    folder = tmp_path / package.__name__
    folder.mkdir()
    fake, log = _fake_rfcat(folder)
    plugin = package.RfCatPlugin()
    plugin.rfcat_executable = str(fake)
    assert plugin.rfcat_is_found
    mod_cls, msg_cls, pm_cls = ((Modulator, Message, ProjectManager) if package is plugins
                                else (JaxModulator, JaxMessage, JaxProjectManager))
    mod = mod_cls("m")
    mod.modulation_type = modulation
    plugin.modulators = [mod]
    plugin.project_manager = pm_cls()
    plugin.project_manager.device_conf["frequency"] = 868.3e6
    messages = [msg_cls.from_plain_bits_str(s, pause=0) for s in ("10101111", "110011001")]
    for m in messages:
        m.samples_per_symbol = 250
    sent = []
    plugin.current_send_message_changed.connect(sent.append)
    assert plugin._send_messages(messages, [2e6, 2e6])
    plugin.process.stdin.close()  # the fake logs every statement, then exits
    assert plugin.process.wait(DEADLINE_S) == 0
    plugin.close_rfcat()
    assert not plugin.rfcat_is_open
    assert sent == [0, 1] * repeats
    return log.read_text()


@pytest.mark.parametrize("modulation,repeats", [("ASK", 1), ("FSK", 2), ("PSK", 1)])
def test_rfcat_statements_equal_urh_tpu(config, tmp_path, modulation, repeats):
    settings.write("num_sending_repeats", repeats)
    jax_settings._store = None
    got = _rfcat_script(plugins, tmp_path, modulation, repeats)
    want = _rfcat_script(jax_plugins, tmp_path, modulation, repeats)
    assert got == want
    lines = got.splitlines()
    assert lines[0] == "-r"
    assert lines[1] == "d.setMdmModulation({})".format(plugins.RfCatPlugin.MODULATION_MAP[
        modulation])
    assert "d.setFreq(868300000)" in lines and "d.setMdmDRate(8000)" in lines
    assert lines[-1] == "d.RFxmit(b'\\xcc\\x80')" and len(lines) == 6 + 2 * repeats


def test_rfcat_without_its_executable():
    plugin = plugins.RfCatPlugin()
    plugin.rfcat_executable = os.path.join("no", "such", "rfcat")
    assert not plugin.rfcat_is_found and not plugin.open_rfcat()
    assert plugins.RfCatPlugin.bit_str_to_bytearray("1010111100000001") == bytearray(b"\xaf\x01")


# -- discovery, enable state, settings ---------------------------------------------------


def test_plugin_manager_discovery_and_enable_persistence(config):
    manager, jax_manager = plugins.PluginManager(), jax_plugins.PluginManager()
    names = lambda m: [(p.name, type(p).__name__, p.enabled, p.description)
                       for p in m.installed_plugins]
    assert names(manager) == names(jax_manager)
    assert {p.name for p in manager.protocol_plugins} == {"MessageBreak", "ZeroHide"}
    assert {p.name for p in manager.signal_editor_plugins} == {"InsertSine"}
    assert manager.get_plugin_by_name("Unknown") is None

    plugin = manager.get_plugin_by_name("ZeroHide")
    changes = []
    plugin.enabled_changed.connect(lambda: changes.append(True))
    plugin.enabled = True
    assert changes == [True] and manager.is_plugin_enabled("ZeroHide")
    assert not manager.is_plugin_enabled("MessageBreak")
    manager.save_enabled_states()
    # urh_tpu reads the port's choice back from the same store, and the other way
    jax_settings._store = None
    assert jax_plugins.PluginManager().get_plugin_by_name("ZeroHide").enabled
    jax_fresh = jax_plugins.PluginManager()
    jax_fresh.get_plugin_by_name("RfCat").enabled = True
    jax_fresh.save_enabled_states()
    settings._store = None
    fresh = plugins.PluginManager()
    assert [p.name for p in fresh.installed_plugins if p.enabled] == ["RfCat", "ZeroHide"]


def test_plugin_settings_roundtrip_and_description(config):
    plugin, jax_plugin = plugins.InsertSinePlugin(), jax_plugins.InsertSinePlugin()
    plugin.load_description()
    jax_plugin.load_description()
    assert plugin.description == jax_plugin.description
    assert "sine" in plugin.description.lower()
    plugin.write_setting("frequency", 12345.0)
    jax_settings._store = None
    assert jax_plugin.read_setting("frequency", 0.0, type=float) == 12345.0
    assert plugin.read_setting("frequency", 0.0, type=float) == 12345.0


def test_legacy_plugin_wrapped():
    from urh_tpu.plugins.manager import _wrap_legacy as jax_wrap
    from urh_tpu_torch.plugins.manager import _wrap_legacy

    class Legacy:
        """A plugin of an older interface."""
        name = "Old"

    got, want = _wrap_legacy(Legacy()), jax_wrap(Legacy())
    assert (got.name, got.description) == (want.name, want.description)
    assert isinstance(got, plugins.Plugin) and isinstance(got.wrapped, Legacy)


def test_plugin_list_model(config):
    from urh_tpu.ui.models import PluginListModel as JaxPluginListModel
    from urh_tpu_torch.ui.models import PluginListModel

    listed = plugins.get_installed_plugins()
    jax_listed = jax_plugins.get_installed_plugins()
    model = PluginListModel(listed, highlighted_plugins=[listed[1]])
    jax_model = JaxPluginListModel(jax_listed, highlighted_plugins=[jax_listed[1]])
    for row in range(model.row_count):
        for role in ("display", "check", "highlight", "description", "other"):
            assert model.data(row, role) == jax_model.data(row, role)
    model.set_checked(2, True)
    assert listed[2].enabled and model.data(2, "check")
    assert model.row_count == jax_model.row_count == 5
