"""The port's web app against urh_tpu's over HTTP: counterparts of
tests/test_web_ui.py's workflow cases.

Each case starts urh_tpu's ``WebUI()`` and the port's ``WebUI(device="cpu")``
on port 0 and sends both the same requests (tests/torch_web_pair.py).  The
JSON replies must be equal: bits, messages, labels, parameters and table
rows exactly; ``signal_plot``'s rounded y within 1e-5; an estimated center
within 1e-6 (tests/test_torch_estimate.py).  A spectrogram PNG must have
urh_tpu's size and be the image of a dB image within 0.05 dB of urh_tpu's
at or above -100 dB (ROADMAP C10); band-passed samples are held to
tests/test_torch_filters.py's 1e-3.  urh_tpu's cases read the golden
fsk.complex, not in this tree: these read a synthetic FSK capture of one
message in its shape (torch_web_pair.FSK_BITS).
"""

import csv
import os
import re
import shutil
import socket

import numpy as np
import pytest
import torch

from tests.torch_web_pair import (CENTER_ATOL, FSK_BITS, FSK_PARAMS, PLOT_ATOL, Pair,
                                  assert_same_db, config, fsk_iq, pair, png_size,
                                  write_capture)
from urh_tpu.dsp.spectrogram import Spectrogram as JaxSpectrogram
from urh_tpu.protocol.analyzer import ProtocolAnalyzer as JaxProtocolAnalyzer
from urh_tpu.ui import web as jax_web
from urh_tpu_torch.dsp.spectrogram import Spectrogram
from urh_tpu_torch.protocol.analyzer import ProtocolAnalyzer
from urh_tpu_torch.ui import web
from urh_tpu_torch.ui.png import encode_bgra
from urh_tpu_torch.util import colormaps

torch.set_num_threads(1)

__all__ = ["config", "pair"]  # fixtures


@pytest.fixture
def fsk_path(tmp_path):
    return write_capture(tmp_path, "fsk.complex", fsk_iq(FSK_BITS))


def open_fsk(pair, path, params=True):
    status, sig = pair.call("POST", "/api/signal/open", {"path": path})
    assert status == 200 and sig["id"] == 0
    if params:
        status, _ = pair.call("POST", "/api/signal/0/params", FSK_PARAMS)
        assert status == 200
    return sig


def test_page_and_state(pair):
    replies = pair.each("GET", "/")
    for status, html, ctype in replies.values():
        assert status == 200 and ctype.startswith("text/html")
    page = replies["torch"][1].decode()
    assert "Interpretation" in page and "Generator" in page
    assert "<title>urh_tpu_torch</title>" in page
    assert page == jax_web.PAGE.replace("<title>urh_tpu</title>",
                                        "<title>urh_tpu_torch</title>").replace(
        "<b>urh_tpu</b>", "<b>urh_tpu_torch</b>")
    status, state = pair.call("GET", "/api/state")
    assert status == 200 and state["signals"] == []


def test_routes_are_urh_tpus():
    assert web.ROUTES == jax_web.ROUTES and len(web.ROUTES) == 86
    for _, _, name in web.ROUTES:
        assert callable(getattr(web.WebUI, name))


def test_interpretation_to_generator_workflow(pair, fsk_path):
    open_fsk(pair, fsk_path)
    status, msgs = pair.call("GET", "/api/signal/0/messages?view=0")
    assert status == 200 and msgs["messages"] == [FSK_BITS]
    for view in (1, 2):
        pair.call("GET", f"/api/signal/0/messages?view={view}&decoded=1")
    status, plot = pair.call("GET", "/api/signal/0/plot", atol={"y": PLOT_ATOL})
    assert status == 200 and len(plot["x"]) == len(plot["y"]) > 100
    pair.call("GET", "/api/signal/0/plot?start=1000&end=3000", atol={"y": PLOT_ATOL})

    status, r = pair.call("POST", "/api/analysis/add", {"signal_id": 0})
    assert status == 200 and r["rows"] == 1
    status, rows = pair.call("GET", "/api/analysis/rows?view=1&decoded=1")
    assert rows["rows"][0]["data"].startswith("aaaaaaaa")

    status, r = pair.call("POST", "/api/generator/add", {"signal_id": 0})
    assert status == 200 and r["rows"] == 1
    status, table = pair.call("GET", "/api/generator/table")
    assert table["total_samples"] > 0 and len(table["rows"]) == 1
    pair.call("POST", "/api/generator/pause", {"pause": 500})
    status, table = pair.call("GET", "/api/generator/table")
    assert table["rows"][0]["pause"] == 500
    status, gen = pair.call("POST", "/api/generator/generate", {})
    assert status == 200 and gen["samples"] == table["total_samples"] > 0
    status, state = pair.call("GET", "/api/state")
    assert (state["analysis_rows"], state["generator_rows"]) == (1, 1)


def test_autodetect_and_undo(pair, fsk_path):
    open_fsk(pair, fsk_path, params=False)
    status, det = pair.call("POST", "/api/signal/0/autodetect", atol={"center": CENTER_ATOL})
    assert status == 200 and det["success"]
    assert det["params"]["samples_per_symbol"] == 100
    before = det["params"]["center"]
    pair.call("POST", "/api/signal/0/params", {"center": 0.42})
    status, r = pair.call("POST", "/api/signal/0/undo", atol={"center": CENTER_ATOL})
    assert status == 200 and r["params"]["center"] == pytest.approx(before)
    status, msgs = pair.call("GET", "/api/signal/0/messages?view=0")
    assert msgs["messages"] == [FSK_BITS]


def test_analysis_decodings_and_awre(pair, tmp_path):
    # awre needs a few messages: the capture's message four times over
    iq = np.concatenate([fsk_iq(FSK_BITS, seed=s) for s in range(4)])
    pair.call("POST", "/api/signal/open", {"path": write_capture(tmp_path, "four.complex", iq)})
    pair.call("POST", "/api/signal/0/params", FSK_PARAMS)
    pair.call("POST", "/api/analysis/add", {"signal_id": 0})
    status, decs = pair.call("GET", "/api/analysis/decodings")
    assert status == 200 and len(decs["decodings"]) >= 1
    status, r = pair.call("POST", "/api/analysis/decoding", {"decoding_index": 0})
    assert status == 200
    status, awre = pair.call("POST", "/api/analysis/awre")
    assert status == 200 and isinstance(awre["message_types"], list)
    assert any(mt["labels"] for mt in awre["message_types"])
    pair.call("GET", "/api/analysis/rows?view=0&decoded=1")
    pair.call("GET", "/api/analysis/message_types")


def test_error_handling(pair):
    status, r = pair.call("POST", "/api/signal/open", {"path": "/nonexistent.complex"})
    assert status in (400, 500) and "error" in r
    status, r = pair.call("GET", "/api/signal/7/messages")
    assert status == 400 and "error" in r
    status, r = pair.call("GET", "/api/nope")
    assert status == 404
    status, r = pair.call("POST", "/api/signal/0/params", {"bogus": 1})
    assert status == 400


def test_page_references_only_existing_routes():
    called = set(re.findall(r"/api/[a-z_/]+(?=['\"?]|\'\+)", web.PAGE))
    patterns = [p for _, p, _ in web.ROUTES]
    assert called
    for url in called:
        url_probe = re.sub(r"\d+", "0", url)
        assert any(re.fullmatch(p.replace(r"(\d+)", r"\d+"), url_probe)
                   or p.startswith(url_probe.rstrip("/"))
                   for p in patterns), f"page calls unknown endpoint {url}"


def test_simulator_run_controls(pair):
    status, r = pair.call("GET", "/api/simulator/items")
    assert status == 200 and r["items"] == []
    sink = socket.create_server(("127.0.0.1", 0))  # where the senders connect
    try:
        status, r = pair.call("POST", "/api/simulator/start",
                              {"noise": 0.01, "samples_per_symbol": 100, "rx_server_port": 0,
                               "tx_client_port": sink.getsockname()[1]},
                              ignore=("rx_port", "running"))
        assert status == 200 and r["rx_port"] > 0
        assert pair.ui.main.simulator_tab_controller.simulator.device == torch.device("cpu")
        replies = pair.each("GET", "/api/simulator/log")
        assert all(s == 200 and isinstance(log["log"], list) for s, log, _ in replies.values())
        status, r = pair.call("POST", "/api/simulator/stop", {})
        assert status == 200 and r["running"] is False
        status, t = pair.call("GET", "/api/simulator/transcript")
        assert status == 200
    finally:
        sink.close()


def test_spectrogram_endpoint_per_colormap(pair, fsk_path):
    open_fsk(pair, fsk_path, params=False)
    status, maps = pair.call("GET", "/api/colormaps")
    assert status == 200 and "magma" in maps["colormaps"]
    raw = np.fromfile(fsk_path, np.complex64)
    for query, (start, end), window in (("", (0, None), 1024),
                                        ("&window=256&start=1000&end=9000", (1000, 9000), 256)):
        spec = Spectrogram(raw, window_size=window, device="cpu")
        data = spec._calculate_spectrogram(spec.samples[start:end])
        ref = JaxSpectrogram(raw, window_size=window)
        assert_same_db(data, ref._calculate_spectrogram(ref.samples[start:end]))
        images = {}
        for cmap in ("magma", "viridis", "grayscale"):
            replies = pair.each("GET", f"/api/signal/0/spectrogram?colormap={cmap}{query}")
            (status, png, ctype), (_, jax_png, _) = replies["torch"], replies["jax"]
            assert status == 200 and ctype == "image/png"
            assert png_size(png) == png_size(jax_png) == (data.shape[0], data.shape[1])
            image = Spectrogram.create_image(data, colormaps.calculate_numpy_brga_for(cmap),
                                             spec.data_min, spec.data_max)
            assert png == encode_bgra(image), f"{cmap} render diverged"
            images[cmap] = png
        assert images["magma"] != images["viridis"] != images["grayscale"]
    status, _ = pair.call("GET", "/api/signal/0/spectrogram?colormap=nope")
    assert status == 400


def test_analysis_label_create_edit_delete(pair, fsk_path):
    open_fsk(pair, fsk_path)
    pair.call("POST", "/api/analysis/add", {"signal_id": 0})
    status, r = pair.call("POST", "/api/analysis/label",
                          {"action": "create", "message": 0, "start": 0, "end": 15,
                           "view": 0, "name": "preamble16"})
    assert status == 200
    assert any(l["name"] == "preamble16" and l["start"] == 0 and l["end"] == 16
               for l in r["labels"]), r
    status, rows = pair.call("GET", "/api/analysis/rows?view=0&decoded=1")
    assert any(l["name"] == "preamble16" for l in rows["rows"][0]["labels"])
    idx = next(i for i, l in enumerate(r["labels"]) if l["name"] == "preamble16")
    status, r = pair.call("POST", "/api/analysis/label",
                          {"action": "edit", "message": 0, "label": idx, "name": "sync",
                           "start": 16, "end": 31})
    assert any(l["name"] == "sync" and l["start"] == 16 and l["end"] == 32
               for l in r["labels"]), r
    status, r = pair.call("POST", "/api/analysis/label",
                          {"action": "create", "message": 0, "start": 1, "end": 2,
                           "view": 1, "name": "hex", "field_type": "sequence number"})
    assert status == 200
    idx = next(i for i, l in enumerate(r["labels"]) if l["name"] == "sync")
    status, r = pair.call("POST", "/api/analysis/label",
                          {"action": "delete", "message": 0, "label": idx})
    assert status == 200 and not any(l["name"] == "sync" for l in r["labels"])
    status, _ = pair.call("POST", "/api/analysis/label",
                          {"action": "delete", "message": 0, "label": 99})
    assert status == 400
    status, _ = pair.call("POST", "/api/analysis/label",
                          {"action": "create", "message": 42, "start": 0, "end": 3})
    assert status == 400


def test_in_table_cell_editing(pair, fsk_path):
    open_fsk(pair, fsk_path)
    pair.call("POST", "/api/analysis/add", {"signal_id": 0})
    pair.call("POST", "/api/generator/add", {"signal_id": 0})
    status, r = pair.call("POST", "/api/analysis/cell",
                          {"row": 0, "col": 0, "value": "0", "view": 0})
    assert status == 200 and r["data"].startswith("00101010"), r
    status, r = pair.call("POST", "/api/generator/cell",
                          {"row": 0, "col": 0, "value": "f", "view": 1})
    assert status == 200 and r["data"].startswith("f"), r
    status, _ = pair.call("POST", "/api/analysis/cell",
                          {"row": 0, "col": 0, "value": "x", "view": 0})
    assert status == 400


def test_fuzzing_label_and_values_over_http(pair, fsk_path):
    open_fsk(pair, fsk_path)
    pair.call("POST", "/api/generator/add", {"signal_id": 0})
    status, lbl = pair.call("POST", "/api/generator/fuzz_label",
                            {"message": 0, "start": 8, "end": 16})
    assert status == 200 and len(lbl["values"]) >= 1
    status, vals = pair.call("POST", "/api/generator/fuzz_values",
                             {"message": 0, "label": lbl["label"], "mode": "range",
                              "start": 1, "end": 5})
    assert status == 200 and len(vals["values"]) >= 5
    for body in ({"mode": "boundaries", "lower": 2, "upper": 200, "num_values": 2},
                 {"mode": "random", "number": 4, "minimum": 0, "maximum": 255, "seed": 42}):
        status, _ = pair.call("POST", "/api/generator/fuzz_values",
                              {"message": 0, "label": lbl["label"], **body})
        assert status == 200
    status, table = pair.call("GET", "/api/generator/table")
    rows_before = len(table["rows"])
    status, r = pair.call("POST", "/api/generator/fuzz", {"mode": "successive"})
    assert status == 200 and r["rows"] > rows_before
    pair.call("GET", "/api/generator/table")
    status, _ = pair.call("POST", "/api/generator/fuzz_values",
                          {"message": 0, "label": 99, "mode": "range", "start": 0, "end": 1})
    assert status == 400


def test_project_save_and_open_roundtrip(pair, fsk_path, tmp_path):
    for pkg in ("jax", "torch"):
        os.makedirs(tmp_path / pkg)
        shutil.copy(fsk_path, tmp_path / pkg / "cap.complex")
    project = str(tmp_path / "{pkg}")
    pair.call("POST", "/api/signal/open", {"path": os.path.join(project, "cap.complex")})
    pair.call("POST", "/api/signal/0/params",
              {"modulation_type": "FSK", "samples_per_symbol": 123, "center": 0.25})
    status, r = pair.call("POST", "/api/project/save", {"path": project})
    assert status == 200 and r["saved"].endswith("URHProject.xml")
    again = Pair()
    try:
        status, state = again.call("POST", "/api/project/open", {"path": project})
        assert status == 200 and len(state["signals"]) == 1
        params = state["signals"][0]["params"]
        assert params["samples_per_symbol"] == 123
        assert params["center"] == pytest.approx(0.25)
        assert again.ui.main.signal_frames[0].signal.device == torch.device("cpu")
    finally:
        again.close()


def test_signal_edit_operations_over_http(pair, fsk_path):
    open_fsk(pair, fsk_path)
    status, before = pair.call("GET", "/api/state")
    n0 = before["signals"][0]["num_samples"]
    pair.call("GET", "/api/signal/0/messages")  # the protocol view is on: edits demodulate
    status, sel = pair.call("GET", "/api/signal/0/selection?start=0&end=2000")
    assert status == 200 and sel
    status, sel = pair.call("GET", "/api/signal/0/selection?start=3000&end=9000")
    assert sel["selected_bits"][0] == 0
    status, r = pair.call("POST", "/api/signal/0/edit",
                          {"action": "delete", "start": 0, "end": 1000})
    assert status == 200 and r["num_samples"] == n0 - 1000
    status, r = pair.call("POST", "/api/signal/0/edit",
                          {"action": "mute", "start": 0, "end": 500})
    assert status == 200
    status, r = pair.call("POST", "/api/signal/0/undo")
    assert status == 200
    status, r = pair.call("POST", "/api/signal/0/edit",
                          {"action": "filter", "start": 0, "end": 2000, "cutoff": 0.1,
                           "bw": 0.05})
    assert status == 200
    status, msgs = pair.call("GET", "/api/signal/0/messages?view=0")
    assert msgs["messages"] == [FSK_BITS]
    status, r = pair.call("POST", "/api/signal/0/edit",
                          {"action": "crop", "start": 0, "end": 5000})
    assert status == 200 and r["num_samples"] == 5000
    status, r = pair.call("POST", "/api/signal/0/edit", {"action": "nope"})
    assert status == 400
    for _ in range(2):
        pair.call("POST", "/api/signal/0/undo")
    status, msgs = pair.call("GET", "/api/signal/0/messages?view=0")
    assert msgs["messages"] == [FSK_BITS]


def test_mute_of_the_message_over_http(pair, fsk_path):
    """ROADMAP C11 through the web route: a mute with qad cached drops the
    fused states on the port as on urh_tpu's host route (the muted range
    decodes as zeros), and the undo brings the message back."""
    open_fsk(pair, fsk_path)
    pair.call("GET", "/api/signal/0/messages")
    status, r = pair.call("POST", "/api/signal/0/edit",
                          {"action": "mute", "start": 2000, "end": 4000})
    assert status == 200
    status, msgs = pair.call("GET", "/api/signal/0/messages?view=0")
    assert msgs["messages"][0] != FSK_BITS
    pair.call("POST", "/api/signal/0/undo")
    status, msgs = pair.call("GET", "/api/signal/0/messages?view=0")
    assert msgs["messages"] == [FSK_BITS]
    np.testing.assert_array_equal(pair.ui.main.signal_frames[0].signal.iq_array.data,
                                  pair.jax_ui.main.signal_frames[0].signal.iq_array.data)


def test_signal_copy_paste_over_http(pair, fsk_path):
    open_fsk(pair, fsk_path, params=False)
    status, before = pair.call("GET", "/api/state")
    n0 = before["signals"][0]["num_samples"]
    pair.call("POST", "/api/signal/0/edit", {"action": "copy", "start": 0, "end": 1000})
    status, r = pair.call("POST", "/api/signal/0/edit", {"action": "paste", "position": 0})
    assert status == 200 and r["num_samples"] == n0 + 1000


def test_table_undo_depth(pair, fsk_path):
    open_fsk(pair, fsk_path)
    pair.call("POST", "/api/analysis/add", {"signal_id": 0})
    status, before = pair.call("GET", "/api/analysis/rows?view=0&decoded=0")
    bits_before = before["rows"][0]["data"]
    status, r = pair.call("POST", "/api/analysis/delete_range",
                          {"msg_start": 0, "msg_end": 0, "index_start": 0, "index_end": 7,
                           "view": 0})
    assert status == 200 and r["can_undo"]
    status, after = pair.call("GET", "/api/analysis/rows?view=0&decoded=0")
    assert after["rows"][0]["data"] == bits_before[8:]
    status, r = pair.call("POST", "/api/analysis/undo", {"action": "undo"})
    assert status == 200 and r["can_redo"]
    status, restored = pair.call("GET", "/api/analysis/rows?view=0&decoded=0")
    assert restored["rows"][0]["data"] == bits_before
    pair.call("POST", "/api/analysis/undo", {"action": "redo"})

    pair.call("POST", "/api/generator/add", {"signal_id": 0})
    status, table = pair.call("GET", "/api/generator/table")
    gen_bits = table["rows"][0]["data"]
    status, r = pair.call("POST", "/api/generator/insert_column", {"index": 4, "view": 0})
    assert status == 200 and r["can_undo"]
    status, table = pair.call("GET", "/api/generator/table")
    assert table["rows"][0]["data"] == gen_bits[:4] + "0" + gen_bits[4:]
    pair.call("POST", "/api/generator/undo", {"action": "undo"})
    status, r = pair.call("POST", "/api/generator/clear", {})
    assert status == 200
    status, table = pair.call("GET", "/api/generator/table")
    assert table["rows"] == []
    pair.call("POST", "/api/generator/undo", {"action": "undo"})
    status, table = pair.call("GET", "/api/generator/table")
    assert table["rows"][0]["data"] == gen_bits
    status, r = pair.call("POST", "/api/generator/undo", {"action": "status"})
    assert status == 200 and r["can_undo"] is True
    status, r = pair.call("POST", "/api/generator/undo", {"action": "bogus"})
    assert status == 400


def test_undo_status_reports_real_stack_state(pair):
    status, r = pair.call("POST", "/api/analysis/undo", {"action": "status"})
    assert status == 200
    assert r["can_undo"] is False and r["can_redo"] is False and r["depth"] == 0


def test_csv_import_route(pair, tmp_path):
    t = np.arange(2000) / 1e6
    i = np.cos(2 * np.pi * 10e3 * t).astype(np.float32)
    q = np.sin(2 * np.pi * 10e3 * t).astype(np.float32)
    path = tmp_path / "cap.csv"
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, delimiter=";")
        for k in range(len(t)):
            writer.writerow([f"{t[k]:.9f}", f"{i[k]:.6f}", f"{q[k]:.6f}"])
    status, sig = pair.call("POST", "/api/signal/import_csv",
                            {"path": str(path), "separator": ";", "i_column": 1,
                             "q_column": 2, "t_column": 0})
    assert status == 200 and sig["num_samples"] == 2000
    assert sig["params"]["sample_rate"] == pytest.approx(1e6, rel=0.01)
    assert pair.ui.main.signal_frames[0].signal.device == torch.device("cpu")
    np.testing.assert_array_equal(pair.ui.main.signal_frames[0].signal.iq_array.data,
                                  pair.jax_ui.main.signal_frames[0].signal.iq_array.data)


def test_bandpass_filter_creates_new_signal(pair, tmp_path):
    n = 1 << 14
    t = np.arange(n)
    mix = (np.exp(2j * np.pi * 0.1 * t) + np.exp(-2j * np.pi * 0.3 * t)).astype(np.complex64)
    path = str(tmp_path / "two_tone.complex")
    mix.tofile(path)
    status, sig = pair.call("POST", "/api/signal/open", {"path": path})
    assert status == 200
    status, filt = pair.call("POST", f"/api/signal/{sig['id']}/bandpass",
                             {"f_low": 0.05, "f_high": 0.15, "bw": 0.05})
    assert status == 200 and filt["id"] == sig["id"] + 1
    assert "filtered" in filt["name"] and filt["num_samples"] == n
    got = pair.ui.main.signal_frames[filt["id"]].signal
    want = pair.jax_ui.main.signal_frames[filt["id"]].signal
    assert got.device == torch.device("cpu")
    np.testing.assert_allclose(got.iq_array.data, want.iq_array.data, atol=1e-3)
    data = got.iq_array.as_complex64()
    spec = np.abs(np.fft.fft(data[1000:1000 + 4096]))
    freqs = np.fft.fftfreq(4096)
    power_in = spec[np.argmin(np.abs(freqs - 0.1))]
    power_out = spec[np.argmin(np.abs(freqs + 0.3))]
    assert power_in > 50 * power_out, (power_in, power_out)


def test_bandpassed_fsk_demodulates_as_urh_tpus(pair, fsk_path):
    open_fsk(pair, fsk_path)
    status, filt = pair.call("POST", "/api/signal/0/bandpass",
                             {"f_low": -0.05, "f_high": 0.05, "bw": 0.08})
    assert status == 200 and filt["params"]["samples_per_symbol"] == 100
    status, msgs = pair.call("GET", f"/api/signal/{filt['id']}/messages?view=0")
    assert msgs["messages"] == [FSK_BITS]


def test_signal_save_and_analysis_export(pair, fsk_path, tmp_path):
    open_fsk(pair, fsk_path)
    out = str(tmp_path / "{pkg}.complex")
    status, r = pair.call("POST", "/api/signal/0/save", {"path": out})
    assert status == 200
    orig = np.fromfile(fsk_path, np.float32)
    for pkg in ("jax", "torch"):
        np.testing.assert_array_equal(np.fromfile(tmp_path / f"{pkg}.complex", np.float32),
                                      orig)
    pair.call("POST", "/api/analysis/add", {"signal_id": 0})
    status, r = pair.call("POST", "/api/analysis/export",
                          {"path": str(tmp_path / "{pkg}.xml"), "format": "xml"})
    assert status == 200 and r["messages"] == 1
    status, rows = pair.call("GET", "/api/analysis/rows?view=0&decoded=0")
    exported_bits = rows["rows"][0]["data"]
    # each package reads the other's export back with the bits intact
    for reader, pkg in ((ProtocolAnalyzer, "jax"), (JaxProtocolAnalyzer, "torch")):
        pa = reader(None)
        pa.from_xml_file(str(tmp_path / f"{pkg}.xml"), read_bits=True)
        assert pa.plain_bits_str == [exported_bits]
    status, r = pair.call("POST", "/api/analysis/export",
                          {"path": str(tmp_path / "{pkg}.pcapng"), "format": "pcapng"})
    assert status == 200 and (tmp_path / "torch.pcapng").stat().st_size > 24
    status, _ = pair.call("POST", "/api/analysis/export",
                          {"path": str(tmp_path / "x"), "format": "bogus"})
    assert status == 400


def test_generator_fuzz_profile_roundtrip(pair, fsk_path, tmp_path):
    open_fsk(pair, fsk_path)
    pair.call("POST", "/api/generator/add", {"signal_id": 0})
    status, _ = pair.call("POST", "/api/generator/fuzz_label",
                          {"message": 0, "start": 8, "end": 16})
    assert status == 200
    path = str(tmp_path / "{pkg}.fuzz.xml")
    status, _ = pair.call("POST", "/api/generator/profile", {"action": "save", "path": path})
    assert status == 200
    pair.call("POST", "/api/generator/clear", {})
    status, table = pair.call("GET", "/api/generator/table")
    assert table["rows"] == []
    status, r = pair.call("POST", "/api/generator/profile", {"action": "load", "path": path})
    assert status == 200 and r["rows"] == 1
    status, table = pair.call("GET", "/api/generator/table")
    assert len(table["rows"]) == 1
    status, _ = pair.call("POST", "/api/generator/profile",
                          {"action": "load", "path": str(tmp_path / "no.xml")})
    assert status == 400


def test_generator_fuzz_profile_preserves_modulators(pair, fsk_path, tmp_path):
    open_fsk(pair, fsk_path)
    pair.call("POST", "/api/generator/add", {"signal_id": 0})
    pair.call("POST", "/api/generator/modulator",
              {"action": "edit", "index": 0, "name": "custom77", "modulation_type": "FSK",
               "samples_per_symbol": 77, "parameters": [-15e3, 15e3]})
    path = str(tmp_path / "{pkg}.fuzz.xml")
    status, r = pair.call("POST", "/api/generator/profile", {"action": "save", "path": path})
    assert status == 200 and r["modulators"] == 1
    again = Pair()
    try:
        status, r = again.call("POST", "/api/generator/profile",
                               {"action": "load", "path": path})
        assert status == 200 and r["rows"] == 1
        status, mods = again.call("GET", "/api/generator/modulators")
        assert mods["modulators"][0]["name"] == "custom77"
        assert mods["modulators"][0]["samples_per_symbol"] == 77
    finally:
        again.close()


def test_message_type_crud_and_ruleset_assignment(pair, fsk_path):
    open_fsk(pair, fsk_path)
    pair.call("POST", "/api/analysis/add", {"signal_id": 0})
    status, types = pair.call("GET", "/api/analysis/message_types")
    assert status == 200 and types["message_types"][0]["name"] == "Default"
    status, mt = pair.call("POST", "/api/analysis/message_type",
                           {"action": "create", "name": "preamble frames"})
    assert status == 200 and mt["name"] == "preamble frames"
    index = mt["index"]
    status, mt = pair.call("POST", "/api/analysis/message_type",
                           {"action": "edit", "index": index, "assigned_by_ruleset": True,
                            "ruleset": {"mode": "all_apply", "rules": [
                                {"start": 0, "end": 7, "operator": "=",
                                 "target_value": "10101010", "value_type": 0}]}})
    assert status == 200 and mt["rules"][0]["operator_description"]
    assert mt["messages"] == [0], mt
    status, rows = pair.call("GET", "/api/analysis/rows?view=0&decoded=1")
    assert rows["rows"][0]["type"] == "preamble frames"
    status, mt = pair.call("POST", "/api/analysis/message_type",
                           {"action": "edit", "index": index, "name": "renamed"})
    assert status == 200 and mt["name"] == "renamed"
    status, _ = pair.call("POST", "/api/analysis/message_type",
                          {"action": "edit", "index": index, "ruleset": {
                              "rules": [{"start": 0, "end": 1, "operator": "~",
                                         "target_value": "1"}]}})
    assert status == 400
    status, r = pair.call("POST", "/api/analysis/message_type",
                          {"action": "delete", "index": index})
    assert status == 200 and r["message_types"] == ["Default"]
    status, rows = pair.call("GET", "/api/analysis/rows?view=0&decoded=1")
    assert rows["rows"][0]["type"] == "Default"
    status, _ = pair.call("POST", "/api/analysis/message_type", {"action": "delete", "index": 0})
    assert status == 400


def test_plugin_actions_insert_sine_and_message_break(pair, fsk_path):
    open_fsk(pair, fsk_path, params=False)
    status, st = pair.call("GET", "/api/state")
    n0 = st["signals"][0]["num_samples"]
    status, sig = pair.call("POST", "/api/signal/0/insert_sine",
                            {"position": 1000, "amplitude": 0.4, "frequency": 20e3,
                             "num_samples": 5000})
    assert status == 200 and sig["num_samples"] == n0 + 5000
    np.testing.assert_array_equal(pair.ui.main.signal_frames[0].signal.iq_array.data,
                                  pair.jax_ui.main.signal_frames[0].signal.iq_array.data)
    pair.call("POST", "/api/signal/0/undo")
    status, st = pair.call("GET", "/api/state")
    assert st["signals"][0]["num_samples"] == n0
    status, _ = pair.call("POST", "/api/signal/0/insert_sine",
                          {"position": -5, "num_samples": 100})
    assert status == 400
    pair.call("POST", "/api/signal/0/params", FSK_PARAMS)
    pair.call("POST", "/api/analysis/add", {"signal_id": 0})
    status, rows = pair.call("GET", "/api/analysis/rows?view=0&decoded=0")
    bits = rows["rows"][0]["data"]
    status, r = pair.call("POST", "/api/analysis/message_break",
                          {"message": 0, "position": 32, "view": 0})
    assert status == 200 and r["rows"] == 2 and r["can_undo"]
    status, rows = pair.call("GET", "/api/analysis/rows?view=0&decoded=0")
    assert [row["data"] for row in rows["rows"]] == [bits[:32], bits[32:]]
    status, _ = pair.call("POST", "/api/analysis/undo", {"action": "undo"})
    status, rows = pair.call("GET", "/api/analysis/rows?view=0&decoded=0")
    assert [row["data"] for row in rows["rows"]] == [bits]


def test_zero_hide_plugin_action(pair, fsk_path):
    open_fsk(pair, fsk_path)
    pair.call("POST", "/api/analysis/add", {"signal_id": 0})
    status, rows = pair.call("GET", "/api/analysis/rows?view=0&decoded=1")
    bits = rows["rows"][0]["data"]
    assert "00000" in bits
    status, r = pair.call("POST", "/api/analysis/zero_hide", {"following_zeros": 5, "view": 0})
    assert status == 200 and r["can_undo"]
    status, rows = pair.call("GET", "/api/analysis/rows?view=0&decoded=1")
    hidden = rows["rows"][0]["data"]
    assert len(hidden) < len(bits) and "00000" not in hidden
    status, _ = pair.call("POST", "/api/analysis/zero_hide", {"action": "restore"})
    status, rows = pair.call("GET", "/api/analysis/rows?view=0&decoded=1")
    assert rows["rows"][0]["data"] == bits
    status, _ = pair.call("POST", "/api/analysis/zero_hide", {"following_zeros": 0})
    assert status == 400


def test_project_settings_and_participants(pair, config):
    status, s = pair.call("GET", "/api/project/settings")
    assert status == 200 and s["modulation_dtype"] == "float32"
    status, s = pair.call("POST", "/api/project/settings",
                          {"simulator_timeout_ms": 8000, "broadcast_address_hex": "ff",
                           "device_conf": {"frequency": 868e6, "name": "HackRF"},
                           "modulation_dtype": "int16"})
    assert status == 200 and s["modulation_dtype"] == "int16"
    assert s["device_conf"]["frequency"] == 868e6
    status, _ = pair.call("POST", "/api/project/settings", {"modulation_dtype": "int4"})
    assert status == 400
    status, _ = pair.call("POST", "/api/project/settings", {"device_conf": {"nope": 1}})
    assert status == 400
    status, p = pair.call("POST", "/api/project/participants",
                          {"action": "create", "name": "Alice", "shortname": "A"})
    assert status == 200 and p["participants"][0]["name"] == "Alice"
    status, p = pair.call("POST", "/api/project/participants",
                          {"action": "edit", "index": 0, "address_hex": "ab",
                           "simulate": True, "relative_rssi": 2})
    assert p["participants"][0]["simulate"] is True
    pair.call("GET", "/api/project/participants")
    status, p = pair.call("POST", "/api/project/participants", {"action": "delete", "index": 0})
    assert status == 200 and p["participants"] == []
    status, _ = pair.call("POST", "/api/project/participants", {"action": "edit", "index": 3})
    assert status == 400


def awre_protocol(builder, generator, labels_module, n_msgs: int = 30):
    """chip_smoke.awre_protocol's messages (bench.py's awre protocol) from
    either package's ProtocolGenerator."""
    f = labels_module.FieldType.Function
    alice = labels_module.Participant("Alice", address_hex="1337")
    bob = labels_module.Participant("Bob", address_hex="4711")
    mb = builder("data")
    for function, width in ((f.PREAMBLE, 16), (f.SYNC, 16), (f.LENGTH, 8),
                            (f.SRC_ADDRESS, 16), (f.DST_ADDRESS, 16), (f.SEQUENCE_NUMBER, 8)):
        mb.add_label(function, width)
    pg = generator([mb.message_type], syncs_by_mt={mb.message_type: "0x9a7d"},
                   participants=[alice, bob])
    rng = np.random.default_rng(42)
    for i in range(n_msgs):
        data = "".join(rng.choice(["0", "1"], size=16 if i % 2 else 32))
        src, dst = (alice, bob) if i % 2 else (bob, alice)
        pg.generate_message(data=data, source=src, destination=dst)
    empty = labels_module.MessageType("empty")
    for msg in pg.messages:
        msg.message_type = empty
    return pg.messages


def test_awre_labels_reply_as_json_where_urh_tpu_cannot(config):
    """ROADMAP C12: awre's engines give labels NumPy uint32 bounds (their
    ranges shifted by the uint32 sync ends), in both packages.  urh_tpu's
    /api/analysis/awre and /rows put them into the reply, whose json.dumps
    then raises (the server closes the connection without an answer); the
    port's replies carry them as ints, otherwise equal to urh_tpu's."""
    import json

    from urh_tpu.awre.message_type_builder import MessageTypeBuilder as JaxBuilder
    from urh_tpu.awre.protocol_generator import ProtocolGenerator as JaxGenerator
    from urh_tpu.protocol import labels as jax_labels
    from urh_tpu_torch.awre.message_type_builder import MessageTypeBuilder
    from urh_tpu_torch.awre.protocol_generator import ProtocolGenerator
    from urh_tpu_torch.protocol import labels

    replies = {}
    for name, ui, analyzer, parts in (
            ("jax", jax_web.WebUI(), JaxProtocolAnalyzer, (JaxBuilder, JaxGenerator, jax_labels)),
            ("torch", web.WebUI(device="cpu"), ProtocolAnalyzer,
             (MessageTypeBuilder, ProtocolGenerator, labels))):
        pa = analyzer(None)
        pa.messages = awre_protocol(*parts)
        ui.analysis.add_protocol(pa)
        replies[name] = (ui.analysis_awre(None, None), ui.analysis_rows({"view": ["0"]}, None))
    jax_awre, jax_rows = replies["jax"]
    got = json.loads(json.dumps(replies["torch"]))
    with pytest.raises(TypeError, match="uint32"):
        json.dumps(jax_awre)
    assert got == json.loads(json.dumps(replies["jax"], default=int))
    found = {lbl["name"] for mt in got[0]["message_types"] for lbl in mt["labels"]}
    assert {"preamble", "synchronization", "length"} <= found
