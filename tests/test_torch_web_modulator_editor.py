"""The modulator editor over the port's web API against urh_tpu's:
counterparts of tests/test_web_modulator_editor.py.

Both apps (tests/torch_web_pair.py) get the same requests and must give
the same JSON replies, exactly.  Generated samples are held to urh_tpu's
within tests/test_torch_modulate.py's FLOAT_ULPS ulps of the amplitude and
demodulated back to the table's bits; the preview PNG is the rendering of
the port's own modulated waveform, urh_tpu's size.  urh_tpu's case that
reads the golden fsk.complex reads a synthetic FSK capture of one message
(torch_web_pair.FSK_BITS).
"""

import array

import numpy as np
import torch

import urh_tpu as jax_ut
import urh_tpu_torch as ut
from tests.torch_web_pair import (FSK_BITS, FSK_PARAMS, assert_same_samples, config, fsk_iq,
                                  pair, png_size, write_capture)
from urh_tpu_torch.dsp.modulator import Modulator
from urh_tpu_torch.ui.plots import render_waveform_rgba
from urh_tpu_torch.ui.png import encode_rgba

torch.set_num_threads(1)

__all__ = ["config", "pair"]  # fixtures


def test_modulator_list_and_edit(pair):
    status, r = pair.call("GET", "/api/generator/modulators")
    assert status == 200 and len(r["modulators"]) == 1
    default = r["modulators"][0]
    assert default["modulation_type"] == "ASK" and default["parameters"] == [0.0, 100.0]
    status, m = pair.call("POST", "/api/generator/modulator",
                          {"action": "edit", "index": 0, "modulation_type": "FSK",
                           "carrier_freq_hz": 55e3, "samples_per_symbol": 80,
                           "parameters": [10e3, 20e3]})
    assert status == 200 and m["modulation_type"] == "FSK" and m["carrier_freq_hz"] == 55e3
    assert m["samples_per_symbol"] == 80 and m["parameters"] == [10e3, 20e3]
    assert "Frequenc" in m["parameter_type"]
    status, r = pair.call("POST", "/api/generator/modulator",
                          {"action": "edit", "index": 0, "bits_per_symbol": 2,
                           "parameters": [10e3, 20e3]})
    assert status == 400 and "4 parameters" in r["error"]
    status, m = pair.call("POST", "/api/generator/modulator",
                          {"action": "edit", "index": 0, "bits_per_symbol": 2,
                           "parameters": [-20e3, -10e3, 10e3, 20e3]})
    assert status == 200 and m["parameters"] == [-20e3, -10e3, 10e3, 20e3]
    status, _ = pair.call("POST", "/api/generator/modulator",
                          {"action": "edit", "index": 0, "modulation_type": "QAM"})
    assert status == 400


def test_modulator_create_assign_delete(pair):
    status, m = pair.call("POST", "/api/generator/modulator",
                          {"action": "create", "name": "alt", "modulation_type": "PSK",
                           "parameters": [0.0, 180.0]})
    assert status == 200 and m["index"] == 1 and m["name"] == "alt"
    status, r = pair.call("GET", "/api/generator/modulators")
    assert [x["name"] for x in r["modulators"]] == ["Modulator", "alt"]
    status, _ = pair.call("POST", "/api/generator/message_modulator", {"modulator_index": 5})
    assert status == 400
    status, r = pair.call("POST", "/api/generator/modulator", {"action": "delete", "index": 1})
    assert status == 200 and r["modulators"] == ["Modulator"]
    status, r = pair.call("POST", "/api/generator/modulator", {"action": "delete", "index": 0})
    assert status == 400 and "last modulator" in r["error"]
    status, _ = pair.call("POST", "/api/generator/modulator", {"action": "bogus"})
    assert status == 400


def test_edited_modulator_generates_demodulatable_iq(pair, tmp_path):
    pair.call("POST", "/api/signal/open",
              {"path": write_capture(tmp_path, "fsk.complex", fsk_iq(FSK_BITS))})
    pair.call("POST", "/api/signal/0/params", FSK_PARAMS)
    status, r = pair.call("POST", "/api/generator/add", {"signal_id": 0})
    assert status == 200 and r["rows"] == 1
    status, table = pair.call("GET", "/api/generator/table")
    bits = table["rows"][0]["data"]
    assert bits == FSK_BITS
    status, _ = pair.call("POST", "/api/generator/modulator",
                          {"action": "edit", "index": 0, "modulation_type": "FSK",
                           "samples_per_symbol": 60, "carrier_freq_hz": 40e3,
                           "sample_rate": 1e6, "parameters": [-20e3, 20e3]})
    assert status == 200
    status, r = pair.call("POST", "/api/generator/message_modulator", {"modulator_index": 0})
    assert status == 200 and r["rows"] == [0]
    status, r = pair.call("POST", "/api/generator/generate",
                          {"filename": str(tmp_path / "{pkg}.complex")})
    assert status == 200
    got = np.fromfile(tmp_path / "torch.complex", np.float32).reshape(-1, 2)
    assert_same_samples(got, np.fromfile(tmp_path / "jax.complex", np.float32).reshape(-1, 2))
    for package, kwargs, pkg in ((ut, {"device": "cpu"}, "torch"), (jax_ut, {}, "jax")):
        sig = package.Signal.from_file(str(tmp_path / f"{pkg}.complex"), **kwargs)
        sig.modulation_type = "FSK"
        sig.samples_per_symbol = 60
        sig.center = 0.0
        sig.noise_threshold = 0.01
        pa = package.ProtocolAnalyzer(sig)
        pa.get_protocol_from_signal()
        assert pa.plain_bits_str == [bits], pkg


def test_modulator_preview_png(pair):
    pair.call("POST", "/api/generator/modulator",
              {"action": "edit", "index": 0, "modulation_type": "FSK", "samples_per_symbol": 50,
               "parameters": [-10e3, 10e3], "display_bits": "1010"})
    replies = pair.each("GET", "/api/generator/modulator_preview?index=0&width=400&height=100")
    (status, png, ctype), (_, jax_png, _) = replies["torch"], replies["jax"]
    assert status == 200 and ctype == "image/png"
    assert png_size(png) == png_size(jax_png) == (400, 100)
    m = Modulator("golden")
    m.modulation_type = "FSK"
    m.samples_per_symbol = 50
    m.parameters = array.array("f", [-10e3, 10e3])
    iq = m.modulate([True, False, True, False], pause=0, dtype=np.float32, device="cpu")
    assert png == encode_rgba(render_waveform_rgba(iq.data[:, 0], 400, 100))
    replies = pair.each("GET", "/api/generator/modulator_preview?index=0&bits=1100&width=400"
                               "&height=100")
    assert replies["torch"][0] == 200 and replies["torch"][1] != png
    assert png_size(replies["torch"][1]) == png_size(replies["jax"][1])
    status, _ = pair.call("GET", "/api/generator/modulator_preview?index=0&bits=xy")
    assert status == 400
    status, _ = pair.call("GET", "/api/generator/modulator_preview?index=3")
    assert status == 400
