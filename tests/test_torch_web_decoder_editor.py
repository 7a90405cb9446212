"""The decoding-chain editor and the checksum label over the port's web
API against urh_tpu's: counterparts of tests/test_web_decoder_editor.py.

Both apps (tests/torch_web_pair.py) get the same requests and must give
the same replies, exactly.  urh_tpu's cases read the golden
cc1101.complex, not in this tree: these read a synthetic FSK capture of
the same frame (its plain bits are the golden capture's 113,
CC1101_PLAIN_HEX), made by urh_tpu's modulate and written to ``tmp_path``.
"""

import pytest
import torch

from tests.torch_web_pair import Pair, config, fsk_iq, pair, write_capture

torch.set_num_threads(1)

__all__ = ["config", "pair"]  # fixtures

CC1101_PLAIN_HEX = "aaaaaaaa9a7d9a7dfc99ff1398fb8"
CC1101_DECODED_HEX = "aaaaaaaa9a7d9a7d0378e289757e"
WHITENING_PARAM = "0x9a7d9a7d;0x21;0"
CC1101_PARAMS = {"modulation_type": "FSK", "noise_threshold": 0.06, "center": 0.0,
                 "samples_per_symbol": 100, "tolerance": 5}


@pytest.fixture
def cc1101_path(tmp_path):
    # the golden frame's 113 bits (the hex view pads its last nibble)
    bits = "".join(f"{int(c, 16):04b}" for c in CC1101_PLAIN_HEX)[:113]
    return write_capture(tmp_path, "cc1101.complex", fsk_iq(bits, seed=3))


def whitening_name(pair):
    status, prims = pair.call("GET", "/api/decoding/primitives")
    assert status == 200
    entry = next(p for p in prims["primitives"] if p["key"] == "data_whitening")
    assert entry["takes_param"] and entry["param_default"]
    return entry["name"]


def open_cc1101(pair, path):
    status, _ = pair.call("POST", "/api/signal/open", {"path": path})
    assert status == 200
    pair.call("POST", "/api/signal/0/params", CC1101_PARAMS)
    status, r = pair.call("POST", "/api/analysis/add", {"signal_id": 0})
    assert status == 200 and r["rows"] == 1


def test_primitive_list_matches_reference_surface(pair):
    status, prims = pair.call("GET", "/api/decoding/primitives")
    assert status == 200
    keys = {p["key"] for p in prims["primitives"]}
    assert keys >= {"invert", "differential", "redundancy", "data_whitening", "carrier",
                    "bitorder", "edge", "substitution", "external", "enocean", "cut", "morse"}


def test_build_cc1101_chain_preview_apply_roundtrip(pair, cc1101_path, tmp_path):
    open_cc1101(pair, cc1101_path)
    status, rows = pair.call("GET", "/api/analysis/rows?view=1&decoded=0")
    assert rows["rows"][0]["data"] == CC1101_PLAIN_HEX
    op = whitening_name(pair)
    status, plain = pair.call("GET", "/api/analysis/rows?view=0&decoded=0")
    plain_bits = plain["rows"][0]["data"]
    status, prev = pair.call("POST", "/api/decoding/preview",
                             {"chain": [op, WHITENING_PARAM], "input": plain_bits})
    assert status == 200 and prev["state"] == "success" and prev["errors"] == 0
    assert prev["decoded_hex"] == CC1101_DECODED_HEX and prev["reencoded"] == plain_bits

    status, saved = pair.call("POST", "/api/decoding/save",
                              {"name": "CC1101 custom", "chain": [op, WHITENING_PARAM]})
    assert status == 200 and "CC1101 custom" in saved["decodings"]
    index = saved["decodings"].index("CC1101 custom")
    status, r = pair.call("POST", "/api/analysis/decoding", {"decoding_index": index})
    assert status == 200 and r["decoding"] == "CC1101 custom"
    status, rows = pair.call("GET", "/api/analysis/rows?view=1&decoded=1")
    assert rows["rows"][0]["data"] == CC1101_DECODED_HEX
    status, got = pair.call("GET", f"/api/decoding/get?decoding_index={index}")
    assert got == {"name": "CC1101 custom", "chain": [op, WHITENING_PARAM]}

    for pkg in ("jax", "torch"):
        (tmp_path / pkg).mkdir()
    project = str(tmp_path / "{pkg}")
    status, _ = pair.call("POST", "/api/project/save", {"path": project})
    assert status == 200
    again = Pair()
    try:
        status, _ = again.call("POST", "/api/project/open", {"path": project})
        assert status == 200
        status, decs = again.call("GET", "/api/analysis/decodings")
        idx2 = decs["decodings"].index("CC1101 custom")
        status, got2 = again.call("GET", f"/api/decoding/get?decoding_index={idx2}")
        assert got2["chain"] == [op, WHITENING_PARAM]
    finally:
        again.close()


def test_preview_reports_decode_errors(pair):
    op = whitening_name(pair)
    status, prev = pair.call("POST", "/api/decoding/preview",
                             {"chain": [op, "0xdeadbeef;0x21;0"], "input": "1010101011110000"})
    assert status == 200 and (prev["state"] != "success" or prev["errors"] > 0)


def test_decoding_delete_and_errors(pair, config):
    status, r = pair.call("POST", "/api/decoding/save",
                          {"name": "tmp inverted", "chain": ["Invert"]})
    assert status == 200
    # no project: each app wrote the decodings file (the same one, the same lines)
    assert "tmp inverted" in (config / "decodings.txt").read_text()
    index = r["decodings"].index("tmp inverted")
    status, r = pair.call("POST", "/api/decoding/delete", {"decoding_index": index})
    assert status == 200 and r["removed"] == "tmp inverted"
    assert "tmp inverted" not in r["decodings"]
    status, _ = pair.call("POST", "/api/decoding/save", {"name": "", "chain": ["Invert"]})
    assert status == 400
    status, _ = pair.call("POST", "/api/decoding/preview", {"chain": ["Invert"],
                                                            "input": "10a1"})
    assert status == 400
    status, _ = pair.call("POST", "/api/decoding/delete", {"decoding_index": 99})
    assert status == 400


def test_checksum_label_configuration_cc1101(pair, cc1101_path):
    open_cc1101(pair, cc1101_path)
    op = whitening_name(pair)
    status, saved = pair.call("POST", "/api/decoding/save",
                              {"name": "CC1101 wh", "chain": [op, WHITENING_PARAM]})
    index = saved["decodings"].index("CC1101 wh")
    pair.call("POST", "/api/analysis/decoding", {"decoding_index": index})
    status, r = pair.call("POST", "/api/analysis/label",
                          {"action": "create", "message": 0, "start": 96, "end": 111,
                           "view": 0, "name": "crc", "field_type": "checksum"})
    assert status == 200
    lbl = next(l for l in r["labels"] if l["name"] == "crc")
    assert lbl["is_checksum"] and lbl["field_type"] == "checksum"
    label_index = r["labels"].index(lbl)
    status, cfg = pair.call("POST", "/api/analysis/checksum_label",
                            {"message": 0, "label": label_index, "crc_function": "CC1101",
                             "data_ranges": [[64, 96]]})
    assert status == 200
    assert cfg["polynomial_hex"].lstrip("0x") in ("18005", "8005")
    assert cfg["data_ranges"] == [[64, 96]] and cfg["checksum_ok"] is True, cfg
    status, cfg = pair.call("POST", "/api/analysis/checksum_label",
                            {"message": 0, "label": label_index, "data_ranges": [[60, 96]]})
    assert status == 200 and cfg["checksum_ok"] is False
    for body, code in (({"crc_function": 99}, 400), ({"crc_function": "nope"}, 400),
                       ({"category": "generic", "polynomial_hex": "0x8005"}, 200),
                       ({"category": "CRC"}, 400)):
        status, _ = pair.call("POST", "/api/analysis/checksum_label",
                              {"message": 0, "label": label_index, **body})
        assert status == code, body
    for mode in ("crc8", "crc9"):  # the same reply from both, whatever it is
        pair.call("POST", "/api/analysis/checksum_label",
                  {"message": 0, "label": label_index, "wsp_mode": mode})
    status, _ = pair.call("POST", "/api/analysis/checksum_label",
                          {"message": 0, "label": 99})
    assert status == 400
