"""Both packages' web apps side by side, for tests/test_torch_web_*.py.

``Pair`` serves urh_tpu's ``WebUI()`` and the port's ``WebUI(device="cpu")``
on port 0, each on a thread of its own, and sends both the same requests.
A request body's strings may hold ``{pkg}``, which becomes ``jax`` for
urh_tpu and ``torch`` for the port, so that routes writing files write two;
the replies' copies of every such string sent so far are turned back
before they are compared.  ``close`` stops whatever either app started (devices, sniffer,
simulator, continuous modulator, rfcat) and then both servers.
"""

import json
import math
import os
import re
import struct
import threading
import time
from http.client import HTTPConnection

import numpy as np
import pytest

from urh_tpu.dsp.modulate import modulate as jax_modulate
from urh_tpu.ui import web as jax_web
from urh_tpu.util import settings as jax_settings
from urh_tpu_torch.ui import web
from urh_tpu_torch.util import settings

PACKAGES = ("jax", "torch")
CENTER_ATOL = 1e-6  # tests/test_torch_estimate.py: FSK centers
PLOT_ATOL = 1e-5  # signal_plot rounds y to 5 decimals; a value on a rounding edge moves 1e-5
DB_ATOL = 0.05  # tests/test_torch_spectrogram.py, at or above DB_FLOOR (ROADMAP C10)
DB_FLOOR = -100.0
FLOAT_ULPS = 4  # tests/test_torch_modulate.py: TX float32 samples, ulps of the amplitude
DEADLINE_S = 30.0

# A capture in the shape of the golden fsk.complex urh_tpu's web tests read
# (one FSK message, 100 samples a bit, starting 10101010, with a run of
# zeros): preamble, sync, a payload with five zeros, a 16-bit tail.
FSK_BITS = "10101010" * 4 + "1001101001111101" + "1100000111010011" * 3 + "0110100101101001"


def wait_until(predicate, timeout=DEADLINE_S, interval=0.05):
    """Poll until ``predicate`` returns a truthy value (returned) or the
    deadline passes (None)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(interval)
    return None


def fsk_iq(bits: str, seed: int = 0, lead: int = 2000, pause: int = 10000, sps: int = 100,
           noise: float = 0.01, freqs=(-20e3, 20e3)) -> np.ndarray:
    """float32 (n, 2) FSK capture of ``bits`` from urh_tpu's modulate: a
    silent lead, the message, a pause, Gaussian noise from ``seed``."""
    iq = jax_modulate(np.array([int(b) for b in bits]), sps, "fsk", list(freqs),
                      carrier_frequency=0.0, pause=pause)
    iq = np.concatenate([np.zeros((lead, 2), np.float32), iq])
    rng = np.random.default_rng(seed)
    return (iq + rng.normal(0, noise, iq.shape)).astype(np.float32)


def write_capture(folder, name: str, iq: np.ndarray) -> str:
    path = os.path.join(str(folder), name)
    np.ascontiguousarray(iq, np.float32).tofile(path)
    return path


FSK_PARAMS = {"modulation_type": "FSK", "samples_per_symbol": 100, "center": 0.0,
              "noise_threshold": 0.1}


@pytest.fixture
def config(tmp_path, monkeypatch):
    """Both packages' settings store, decodings file included, in one
    temporary config dir; receive buffers of 100,000 samples."""
    folder = tmp_path / "config"
    for module in (settings, jax_settings):
        monkeypatch.setattr(module, "_config_dir", str(folder))
        monkeypatch.setattr(module, "_settings_file", str(folder / "settings.json"))
        monkeypatch.setattr(module, "_store", None)
        monkeypatch.setattr(module, "OVERWRITE_RECEIVE_BUFFER_SIZE", 100_000)
    return folder


def serve(ui, module):
    srv = module.make_server(ui, host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread


def request(srv, method: str, path: str, body=None, timeout: float = 120.0):
    """-> (status, JSON reply or raw bytes, content type)."""
    conn = HTTPConnection("127.0.0.1", srv.server_address[1], timeout=timeout)
    try:
        payload = json.dumps(body) if body is not None else None
        conn.request(method, path, body=payload, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        ctype = resp.getheader("Content-Type")
    finally:
        conn.close()
    return resp.status, (json.loads(data) if ctype == "application/json" else data), ctype


def fill(value, pkg: str):
    """``value`` with ``{pkg}`` in its strings replaced by ``pkg``."""
    if isinstance(value, str):
        return value.replace("{pkg}", pkg)
    if isinstance(value, dict):
        return {k: fill(v, pkg) for k, v in value.items()}
    if isinstance(value, list):
        return [fill(v, pkg) for v in value]
    return value


# a default object repr in a reply (urh_tpu's simulator items have no
# __str__): the same class of either package at any address
OBJECT_REPR = re.compile(r"<urh_tpu(?:_torch)?\.([\w.]+) object at 0x[0-9a-f]+>")


def unfill(value, strings: dict):
    """Replace each filled string of ``strings`` (filled -> template)
    inside ``value``'s strings by its template, and an object repr by its
    class's path inside the package."""
    if isinstance(value, str):
        for filled, template in strings.items():
            value = value.replace(filled, template)
        return OBJECT_REPR.sub(r"<\1 object>", value)
    if isinstance(value, dict):
        return {k: unfill(v, strings) for k, v in value.items()}
    if isinstance(value, list):
        return [unfill(v, strings) for v in value]
    return value


def templates(value, pkg: str) -> dict:
    out = {}
    if isinstance(value, str) and "{pkg}" in value:
        out[fill(value, pkg)] = value
    elif isinstance(value, dict):
        for v in value.values():
            out.update(templates(v, pkg))
    elif isinstance(value, list):
        for v in value:
            out.update(templates(v, pkg))
    return out


def assert_same(got, want, atol=None, ignore=(), where="reply"):
    """JSON values equal: exactly, but a number under a key of ``atol``
    within its tolerance, and a key of ``ignore`` only present in both."""
    atol = atol or {}
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (where, got, want)
        for key in want:
            if key in ignore:
                continue
            if key in atol:
                close(got[key], want[key], atol[key], f"{where}[{key!r}]")
            else:
                assert_same(got[key], want[key], atol, ignore, f"{where}[{key!r}]")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, atol, ignore, f"{where}[{i}]")
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def close(got, want, tol, where):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            close(g, w, tol, f"{where}[{i}]")
    else:
        assert math.isclose(got, want, rel_tol=0, abs_tol=tol), (where, got, want)


def png_size(png: bytes) -> tuple:
    assert png.startswith(b"\x89PNG\r\n\x1a\n")
    return struct.unpack(">II", png[16:24])


def assert_same_db(got: np.ndarray, want: np.ndarray):
    """Two dB images: the same shape and non-finite cells, finite cells at
    or above DB_FLOOR within DB_ATOL (ROADMAP C10: below it float32 FFT
    rounding decides, in urh_tpu too)."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    above = np.isfinite(want) & (want >= DB_FLOOR)
    assert np.abs(got - want)[above].max() <= DB_ATOL


def assert_same_samples(got: np.ndarray, want: np.ndarray, amplitude: float = 1.0):
    """TX float32 samples within FLOAT_ULPS ulps of the amplitude."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    atol = FLOAT_ULPS * float(np.finfo(np.float32).eps) * amplitude
    assert np.abs(got.astype(np.float64) - want).max() <= atol


def stop_everything(ui):
    """Stop what a WebUI of either package started (each route does nothing
    where nothing runs)."""
    for route in ("sniffer_stop", "simulator_stop", "device_send_stop", "device_spectrum_stop",
                  "device_rfcat_stop", "device_record_stop"):
        getattr(ui, route)(None, None)


def messages_of(samples: np.ndarray, center: float, noise: float, tolerance: int = 5) -> list:
    """Both packages' messages of received float32 FSK samples at 100
    samples a bit, asserted equal."""
    import urh_tpu as jax_ut
    import urh_tpu_torch as ut

    out = []
    for package, kwargs in ((ut, {"device": "cpu"}), (jax_ut, {})):
        sig = package.Signal.from_samples(np.array(samples, np.float32), "rx", 1e6, **kwargs)
        sig.modulation_type = "FSK"
        sig.samples_per_symbol = 100
        sig.center = center
        sig.noise_threshold = noise
        sig.tolerance = tolerance
        pa = package.ProtocolAnalyzer(sig)
        pa.get_protocol_from_signal()
        out.append(pa.plain_bits_str)
    assert out[0] == out[1]
    return out[0]


class Pair:
    """urh_tpu's web app and the port's, served side by side."""

    def __init__(self, project_path: str = ""):
        self.uis = {"jax": jax_web.WebUI(project_path),
                    "torch": web.WebUI(project_path, device="cpu")}
        self.filled = {pkg: {} for pkg in PACKAGES}  # every {pkg} string sent so far
        self.servers = {}
        try:
            for pkg, module in zip(PACKAGES, (jax_web, web)):
                self.servers[pkg] = serve(self.uis[pkg], module)[0]
        except BaseException:
            self.close()
            raise

    @property
    def ui(self):
        return self.uis["torch"]

    @property
    def jax_ui(self):
        return self.uis["jax"]

    def each(self, method: str, path: str, body=None) -> dict:
        """pkg -> (status, reply, content type), the body filled per package."""
        return {pkg: request(srv, method, fill(path, pkg), fill(body, pkg))
                for pkg, srv in self.servers.items()}

    def call(self, method: str, path: str, body=None, atol=None, ignore=(), raw=False):
        """Send both apps the request; assert the same status and reply
        (JSON as assert_same; raw replies the same content type).  -> the
        port's (status, reply)."""
        replies = self.each(method, path, body)
        (want_status, want, want_type), (status, got, ctype) = (replies["jax"],
                                                                replies["torch"])
        assert status == want_status, (path, status, got, want)
        assert ctype == want_type, (path, ctype, want_type)
        for pkg in PACKAGES:
            self.filled[pkg].update(templates(body, pkg))
        if not raw and ctype == "application/json":
            assert_same(unfill(got, self.filled["torch"]), unfill(want, self.filled["jax"]),
                        atol, ignore, path)
        return status, got

    def close(self):
        for ui in self.uis.values():
            stop_everything(ui)
        for srv in self.servers.values():
            srv.shutdown()
            srv.server_close()


@pytest.fixture
def pair(config):
    p = Pair()
    try:
        yield p
    finally:
        p.close()
