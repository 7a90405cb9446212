"""TX synthesis (modulate, Modulator) against urh_tpu's.

The same bits and parameters go through urh_tpu.dsp.modulate and
urh_tpu_torch.dsp.modulate on the CPU, for every modulation type, with a
start offset, a pause, 1 and 2 bits a symbol and every output type.

Tolerance.  The carrier argument is the same float32 on both sides (the
same op order, a 0-dim divisor), so a float32 sample differs only by the
cosine and sine implementations: at most FLOAT_ULPS float32 ulps of the
amplitude.  int8 and int16 truncate toward zero, so a value on an integer
boundary may then differ by 1: at most 1, in at most MAX_LSB_SHARE of the
values.  GFSK's smoothed frequencies are np.convolve's float32 sums in
urh_tpu and a float64 sum rounded once in the port, an ulp or two apart;
an ulp of frequency moves the phase by 2*pi*t*ulp, so GFSK is held to
gfsk_atol (8 frequency ulps at the last sample's t) on top.

Past urh_tpu's DEVICE_MIN_BODY_SAMPLES (2^21 body samples) urh_tpu
synthesizes through XLA, which on the CPU contracts (t*f)*2pi + phi into
an FMA: the argument differs from its own host route's, and the port's,
by an ulp.  There the port is held to urh_tpu's host route within
FLOAT_ULPS, and to its XLA route within an ulp of the largest argument.
"""

import array
import math
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import urh_tpu
from urh_tpu.coding.encodings import Encoding as JaxEncoding
from urh_tpu.dsp import modulate as jax_modulate
from urh_tpu.dsp.modulator import Modulator as JaxModulator
from urh_tpu.protocol.labels import Participant as JaxParticipant
from urh_tpu.protocol.message import Message as JaxMessage
from urh_tpu_torch import ProtocolAnalyzer
from urh_tpu_torch.coding.encodings import Encoding
from urh_tpu_torch.dsp import modulate as mod
from urh_tpu_torch.dsp.modulator import Modulator
from urh_tpu_torch.protocol.labels import Participant
from urh_tpu_torch.protocol.message import Message
from urh_tpu_torch.util import settings

torch.set_num_threads(1)

FLOAT_ULPS = 4
MAX_LSB_SHARE = 1e-3
AMPLITUDE = {np.float32: 1.0, np.int8: 127.0, np.int16: 32767.0}
SAMPLE_RATE = 1e6
START, PAUSE, SPS = 123, 517, 100

# (type, bits a symbol, parameters)
CASES = [
    ("ask", 1, [0.2, 1.0]),
    ("ask", 2, [0.0, 0.3, 0.6, 1.0]),
    ("fsk", 1, [-20e3, 20e3]),
    ("fsk", 2, [-30e3, -10e3, 10e3, 30e3]),
    ("gfsk", 1, [-20e3, 20e3]),
    ("gfsk", 2, [-30e3, -10e3, 10e3, 30e3]),
    ("psk", 1, [0.0, math.pi]),
    ("psk", 2, [-2.3, -0.7, 0.7, 2.3]),
    ("oqpsk", 2, [-2.3, -0.7, 0.7, 2.3]),
]
DTYPES = pytest.mark.parametrize("dtype", [np.float32, np.int8, np.int16],
                                 ids=["float32", "int8", "int16"])


def _gfsk_atol(n_samples, params, amplitude):
    t_end = (START + n_samples) / SAMPLE_RATE
    f_ulp = float(np.spacing(np.float32(np.max(np.abs(params)))))
    return amplitude * 2 * math.pi * t_end * 8 * f_ulp


def _assert_close(got, want, dtype, amplitude, extra_atol=0.0):
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.float64) - want)
    if dtype == np.float32:
        atol = FLOAT_ULPS * float(np.finfo(np.float32).eps) * amplitude + extra_atol
        assert diff.max() <= atol, (diff.max(), atol)
    else:
        assert diff.max() <= 1 + math.ceil(extra_atol), diff.max()
        if not extra_atol:
            assert (diff > 0).mean() <= MAX_LSB_SHARE, (diff > 0).sum()


def _kwargs(mt, dtype, params):
    amplitude = AMPLITUDE[dtype]
    return dict(carrier_amplitude=amplitude, carrier_frequency=0.0 if mt == "fsk" else 30e3,
                carrier_phase=0.3, sample_rate=SAMPLE_RATE, pause=PAUSE, start=START,
                dtype=dtype), np.array(params, np.float32) * (amplitude if mt == "ask" else 1)


@DTYPES
@pytest.mark.parametrize("mt,bps,params", CASES, ids=[f"{c[0]}{c[1]}" for c in CASES])
@pytest.mark.parametrize("n_bits", [4, 64])
def test_modulate_equals_urh_tpu(mt, bps, params, dtype, n_bits):
    bits = np.random.default_rng(n_bits + bps).integers(0, 2, n_bits)
    kwargs, p = _kwargs(mt, dtype, params)
    want = jax_modulate.modulate(bits, SPS, mt, p, bits_per_symbol=bps, **kwargs)
    got = mod.modulate(bits, SPS, mt, p, bits_per_symbol=bps, device="cpu", **kwargs)
    extra = _gfsk_atol(len(got), params, AMPLITUDE[dtype]) if mt == "gfsk" else 0.0
    _assert_close(got, want, dtype, AMPLITUDE[dtype], extra)
    assert not got[len(got) - PAUSE:].any()


@pytest.mark.parametrize("dtype", [np.float32, np.int16], ids=["float32", "int16"])
def test_modulate_past_urh_tpus_device_threshold(monkeypatch, dtype):
    bits = np.random.default_rng(5).integers(0, 2, jax_modulate.DEVICE_MIN_BODY_SAMPLES // SPS + 3)
    kwargs, p = _kwargs("fsk", dtype, [-20e3, 20e3])
    got = mod.modulate(bits, SPS, "fsk", p, device="cpu", **kwargs)
    xla = jax_modulate.modulate(bits, SPS, "fsk", p, **kwargs)
    max_arg = 2 * math.pi * 20e3 * (START + len(got)) / SAMPLE_RATE + 2 * math.pi
    amplitude = AMPLITUDE[dtype]
    arg_ulp = float(np.spacing(np.float32(max_arg))) * amplitude
    last = 1 if dtype != np.float32 else FLOAT_ULPS * float(np.finfo(np.float32).eps) * amplitude
    assert np.abs(got.astype(np.float64) - xla).max() <= arg_ulp + last
    monkeypatch.setattr(jax_modulate, "DEVICE_MIN_BODY_SAMPLES", 1 << 62)  # its host route
    _assert_close(got, jax_modulate.modulate(bits, SPS, "fsk", p, **kwargs), dtype,
                  AMPLITUDE[dtype])


def test_empty_and_oqpsk_rules():
    assert mod.modulate([], SPS, "fsk", [0, 1], pause=5, device="cpu").shape == (5, 2)
    with pytest.raises(ValueError):
        mod.modulate([1, 0], SPS, "oqpsk", [0, 1, 2, 3], device="cpu")
    with pytest.raises(ValueError):
        mod.modulate([1, 0], SPS, "qam", [0, 1], device="cpu")
    bits = np.array([1, 0, 1, 1, 0, 0, 1, 0])
    np.testing.assert_array_equal(mod.get_oqpsk_bits(bits), jax_modulate.get_oqpsk_bits(bits))
    np.testing.assert_array_equal(mod.gauss_fir(1e6, 100), jax_modulate.gauss_fir(1e6, 100))
    np.testing.assert_array_equal(mod.bits_to_symbol_indices(bits, 2),
                                  jax_modulate.bits_to_symbol_indices(bits, 2))


def _modulators(package_modulator):
    out = []
    for i, (mt, bps, params) in enumerate(CASES):
        m = package_modulator(f"mod {i}")
        m.modulation_type = mt.upper()
        m.bits_per_symbol = bps
        m.samples_per_symbol = 50 + i
        m.carrier_freq_hz = 25e3
        m.carrier_phase_deg = 10 * i
        m.sample_rate = 2e6 if i % 2 else None
        scale = {"ask": 100.0, "psk": 180 / math.pi}.get(mt, 1.0)
        m.parameters = array.array("f", [p * scale for p in params])
        out.append(m)
    return out


@DTYPES
def test_modulator_modulate_equals_urh_tpu(dtype):
    bits = "1011001110001011"
    for got_mod, want_mod in zip(_modulators(Modulator), _modulators(JaxModulator)):
        got = got_mod.modulate(bits, pause=300, start=7, dtype=dtype, device="cpu")
        want = want_mod.modulate(bits, pause=300, start=7, dtype=dtype)
        amplitude = AMPLITUDE[dtype]
        extra = (_gfsk_atol(len(got), want_mod.parameters, amplitude)
                 if got_mod.modulation_type == "GFSK" else 0.0)
        _assert_close(got.data, want.data, dtype, amplitude, extra)
    assert len(Modulator().modulate([], device="cpu")) == 0
    with pytest.raises(ValueError):
        Modulator().modulate("10", pause=-1, device="cpu")


def test_get_dtype_reads_the_settings_store(tmp_path, monkeypatch):
    path = tmp_path / "settings.json"
    path.write_text('{"modulation_dtype": "int8"}')
    monkeypatch.setattr(settings, "_settings_file", str(path))
    monkeypatch.setattr(settings, "_store", None)
    assert Modulator.get_dtype() is np.int8
    monkeypatch.setattr(settings, "_store", {"modulation_dtype": "int16"})
    assert Modulator.get_dtype() is np.int16
    monkeypatch.setattr(settings, "_store", {})
    assert Modulator.get_dtype() is np.float32


def test_modulator_xml_round_trip_equals_urh_tpu():
    got, want = _modulators(Modulator), _modulators(JaxModulator)
    for i, (g, w) in enumerate(zip(got, want)):
        assert ET.tostring(g.to_xml(i)) == ET.tostring(w.to_xml(i))
        assert Modulator.from_xml(g.to_xml(i)) == g
    tag = Modulator.modulators_to_xml_tag(got)
    assert ET.tostring(tag) == ET.tostring(JaxModulator.modulators_to_xml_tag(want))
    assert Modulator.modulators_from_xml_tag(tag) == got
    root = ET.Element("project")
    root.append(tag)
    assert Modulator.modulators_from_xml_tag(root) == got
    assert Modulator.modulators_from_xml_tag(None) == []
    legacy = ET.fromstring('<modulator modulation_type="1" samples_per_bit="42" '
                           'param_for_zero="-10" param_for_one="10" sample_rate="None"/>')
    old = Modulator.from_xml(legacy)
    assert (old.modulation_type, old.samples_per_symbol, list(old.parameters),
            old._sample_rate) == ("FSK", 42, [-10.0, 10.0], None)


def test_to_xml_tag_writes_the_modulators_as_urh_tpu():
    trees = []
    for pa, message, participant, encoding, modulator in (
            (ProtocolAnalyzer(None, filename="x"), Message, Participant, Encoding, Modulator),
            (urh_tpu.ProtocolAnalyzer(None, filename="x"), JaxMessage, JaxParticipant,
             JaxEncoding, JaxModulator)):
        pa.messages.append(message.from_plain_bits_str("1010101011110000", pause=1000))
        tag = pa.to_xml_tag(decodings=[encoding(["NRZ"])],
                            participants=[participant("Alice", "A")],
                            modulators=_modulators(modulator))
        trees.append(tag)
    # the participants' ids are random, so the modulators are compared whole
    assert [child.tag for child in trees[0]] == [child.tag for child in trees[1]]
    assert trees[0][0].tag == "modulators"
    assert ET.tostring(trees[0][0]) == ET.tostring(trees[1][0])
