"""Placement under device="auto" (urh_tpu_torch.util.placement) against
urh_tpu's placement and host twins.

The card is faked as a second CPU route: ``placement.place("auto")`` gives
the CPU twice, the link signature is fixed, and the dispatch and transfer
costs are set, for urh_tpu's placement too, so both packages make the same
choice.  Each route is taken both ways, the side read off
``placement.ROUTES``, and its result compared with urh_tpu's on the same
seeded input, within the tolerances of the port's other test files: CWT
atol 1e-4, classification statistics rtol 1e-4, qad atol 1e-6, dB 0.05,
TX 4 float32 ulps; medians, histograms, estimates' discrete fields and
everything awre computes exactly.  Every verdict store lives in a
temporary config dir.
"""

import json
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

import urh_tpu
import urh_tpu_torch
from urh_tpu.ai import device as jax_device
from urh_tpu.awre import device as jax_awre
from urh_tpu.awre.format_finder import FormatFinder as JaxFormatFinder
from urh_tpu.dsp import demod as jax_demod
from urh_tpu.dsp import modulate as jax_modulate
from urh_tpu.dsp import spectrogram as jax_spectrogram
from urh_tpu.util import placement as jax_placement
from urh_tpu.util import settings as jax_settings
from urh_tpu_torch.ai import device as ai_device
from urh_tpu_torch.ai import median_kernels as mk
from urh_tpu_torch.awre import device as awre_device
from urh_tpu_torch.awre.format_finder import FormatFinder
from urh_tpu_torch.dsp import demod, modulate
from urh_tpu_torch.dsp.spectrogram import Spectrogram
from urh_tpu_torch.util import placement, settings

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SIGNATURE = "cuda:fake card:-4"
LOCAL = (20e-6, 1e-10)  # dispatch (s) and transfer (s a byte) of a local card
RELAY = (20e-6, 1e-6)  # a link whose bandwidth makes bulk transfers lose
CWT_ATOL = 1e-4
STATS_RTOL = 1e-4
QAD_ATOL = 1e-6
DB_ATOL = 0.05
TX_ATOL = 4 * float(np.finfo(np.float32).eps)


@pytest.fixture
def store(tmp_path, monkeypatch):
    """Both packages' verdicts empty, their store in a temporary config dir
    (the one an XDG_CONFIG_HOME of tmp_path gives)."""
    for module in (settings, jax_settings):
        monkeypatch.setattr(module, "_config_dir", str(tmp_path / "urh_tpu"))
    for module in (placement, jax_placement):
        monkeypatch.setattr(module, "_RACE_VERDICTS", {})
        monkeypatch.setattr(module, "_STORE_LOADED", False)
    monkeypatch.setattr(jax_placement, "_EPHEMERAL_KEYS", set())
    monkeypatch.setattr(placement, "ROUTES", Counter())
    return tmp_path


def set_link(monkeypatch, dispatch_s, s_per_byte):
    for module in (placement, jax_placement):
        monkeypatch.setattr(module, "dispatch_overhead_s", lambda: dispatch_s)
        monkeypatch.setattr(module, "transfer_s_per_byte", lambda: (s_per_byte, s_per_byte))


@pytest.fixture
def card(store, monkeypatch):
    """The card faked as a second CPU route on a local link."""
    real_place = placement.place
    monkeypatch.setattr(placement, "place",
                        lambda d: (CPU, CPU) if placement.is_auto(d) else real_place(d))
    monkeypatch.setattr(placement, "_link_signature", lambda: SIGNATURE)
    set_link(monkeypatch, *LOCAL)
    return monkeypatch


@pytest.fixture
def probe_on_cpu(monkeypatch):
    """The probes measured for real, with the CPU standing in for the card."""
    real_place = placement.place
    monkeypatch.setattr(placement, "place",
                        lambda d: (CPU, CPU) if placement.is_auto(d) else real_place(d))
    placement.dispatch_overhead_s.cache_clear()
    placement.transfer_s_per_byte.cache_clear()
    yield
    placement.dispatch_overhead_s.cache_clear()
    placement.transfer_s_per_byte.cache_clear()


def routes(prefix=""):
    return {k: v for k, v in placement.ROUTES.items() if k[0].startswith(prefix)}


class FakeClock:
    """time.perf_counter for race(): each route advances it by its cost."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def route(self, name, cost, calls):
        def fn():
            calls[name] += 1
            self.now += cost
            return name
        return fn


# -- the probes, the cost model and race (tests/test_placement.py) ------------


def test_dispatch_overhead_measured_once(probe_on_cpu):
    a = placement.dispatch_overhead_s()
    b = placement.dispatch_overhead_s()
    assert a == b  # cached
    assert 0 < a < 10


def test_transfer_cost_model(probe_on_cpu):
    up, down = placement.transfer_s_per_byte()
    assert 0 < up < 1 and 0 < down < 1  # seconds per byte, sane range
    base = placement.device_io_cost_s(0, 0)
    assert base == pytest.approx(placement.dispatch_overhead_s())
    # cost is monotone in bytes, both directions
    assert placement.device_io_cost_s(1 << 20) > base
    assert placement.device_io_cost_s(0, 1 << 20) > base
    assert placement.device_io_cost_s(1 << 21) > placement.device_io_cost_s(1 << 20)


def test_probes_catch_nothing_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    placement.dispatch_overhead_s.cache_clear()
    placement.transfer_s_per_byte.cache_clear()
    for probe in (placement.dispatch_overhead_s, placement.transfer_s_per_byte):
        with pytest.raises(RuntimeError, match="CUDA"):
            probe()
    for device in (None, "auto"):
        with pytest.raises(RuntimeError, match="CUDA"):
            placement.place(device)
    assert placement.place("cpu") == (CPU, None)


def test_scaled_threshold_never_lowers(monkeypatch):
    for dispatch_s, factor in ((1e-6, 1), (100e-6, 1), (1e-3, 10)):
        set_link(monkeypatch, dispatch_s, 1e-10)
        assert placement.scaled_threshold(0) == 0
        assert placement.scaled_threshold(1 << 16) == factor << 16
        # sentinel-size thresholds stay effective (capped inflation)
        assert placement.scaled_threshold(1 << 62) >= 1 << 62
    set_link(monkeypatch, 1e6, 1e-10)
    assert placement.scaled_threshold(1 << 16) == int((1 << 16) * 1e6)


@pytest.mark.parametrize("dispatch_s,mag", [(5e-6, -4), (28e-6, -4), (40e-6, -4), (100e-6, -4),
                                           (1e-3, -3), (20e-3, -2)])
def test_link_signature_names_the_card_and_the_dispatch_magnitude(monkeypatch, dispatch_s, mag):
    """Every dispatch cost below BASE_OVERHEAD_S shares its magnitude: one
    card measured 28 us and over 31.6 us in two processes."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    set_link(monkeypatch, dispatch_s, 1e-10)
    assert placement._link_signature() == f"cuda:NVIDIA H100 80GB HBM3:{mag:+d}"


@pytest.mark.parametrize("host_cost,winner", [(1.2, "host"), (1.4, "card")])
def test_race_caches_verdict_and_requires_margin(card, host_cost, winner):
    """The card costs 1.0 a call: it must beat the host by RACE_MARGIN (1.3)."""
    clock, calls = FakeClock(), Counter()
    card.setattr(placement, "time", clock)
    device_fn = clock.route("card", 1.0, calls)
    host_fn = clock.route("host", host_cost, calls)
    assert placement.race("test.race", device_fn, host_fn) == winner
    assert calls == {"card": 3, "host": 2}  # a warm call, then best of 2 each
    assert placement._RACE_VERDICTS["test.race"] == ("device" if winner == "card" else "host")

    # later calls run only the winner
    calls.clear()
    assert placement.race("test.race", device_fn, host_fn) == winner
    assert calls == {winner: 1}
    assert placement.ROUTES[("test.race", winner)] == 2


def test_race_lets_a_card_exception_out_and_keeps_no_verdict(card):
    """urh_tpu runs its host twin after any device exception and keeps an
    in-process "host" verdict; the port's race raises and remembers nothing,
    in the process or in the store."""
    calls = Counter()

    def device_fn():
        calls["card"] += 1
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    def host_fn():
        calls["host"] += 1
        return "h"

    for _ in range(2):  # the card route is tried again: nothing was cached
        with pytest.raises(RuntimeError, match="illegal memory access"):
            placement.race("test.error", device_fn, host_fn)
    assert calls == {"card": 2}
    assert "test.error" not in placement._RACE_VERDICTS
    placement.race("test.other", lambda: "d", lambda: "h")  # a save through a normal race
    stored = json.load(open(placement._store_path()))[SIGNATURE]
    assert "test.error" not in stored and "test.other" in stored
    # urh_tpu's rule, for the record
    assert jax_placement.race("test.error", device_fn, host_fn) == "h"
    assert jax_placement._RACE_VERDICTS["test.error"] == "host"


REPLAY = r"""
import sys
from collections import Counter
sys.modules["jax"] = None
from urh_tpu_torch.util import placement
placement._link_signature = lambda: sys.argv[1]
calls = Counter()
def route(name):
    def fn():
        calls[name] += 1
        return name
    return fn
print(placement.race(sys.argv[2], route("card"), route("host")), dict(calls))
"""


def test_race_verdicts_persist_across_processes(card):
    """A settled verdict is written to the per-link store and replayed by a
    fresh process, which runs only the winner: a link's races are paid
    once."""
    clock, calls = FakeClock(), Counter()
    card.setattr(placement, "time", clock)
    placement.race("test.persist", clock.route("card", 1.0, calls),
                   clock.route("host", 5.0, calls))
    assert json.load(open(placement._store_path()))[SIGNATURE] == {"test.persist": "device"}

    # this process with its caches cleared
    card.setattr(placement, "_RACE_VERDICTS", {})
    card.setattr(placement, "_STORE_LOADED", False)
    calls.clear()
    assert placement.race("test.persist", clock.route("card", 1.0, calls),
                          clock.route("host", 5.0, calls)) == "card"
    assert calls == {"card": 1}

    # a new process reading the same config dir
    env = dict(os.environ, XDG_CONFIG_HOME=os.path.dirname(settings.config_dir()))
    out = subprocess.run([sys.executable, "-c", REPLAY, SIGNATURE, "test.persist"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split(None, 1) == ["card", "{'card': 1}\n"]


def test_each_package_keeps_the_others_verdicts(card):
    """One store, one key a link: a save by either package rewrites its own
    link's verdicts and keeps the other's."""
    jax_placement.race("urh_tpu.key", lambda: "d", lambda: "h")
    jax_signature = jax_placement._link_signature()
    assert jax_signature != SIGNATURE
    placement.race("port.key", lambda: "d", lambda: "h")
    stored = json.load(open(placement._store_path()))
    assert set(stored) == {jax_signature, SIGNATURE}
    assert set(stored[jax_signature]) == {"urh_tpu.key"}
    assert set(stored[SIGNATURE]) == {"port.key"}
    # and the other way round, with urh_tpu's verdicts read afresh
    card.setattr(jax_placement, "_RACE_VERDICTS", {})
    card.setattr(jax_placement, "_STORE_LOADED", False)
    jax_placement.race("urh_tpu.second", lambda: "d", lambda: "h")
    stored = json.load(open(placement._store_path()))
    assert set(stored[jax_signature]) == {"urh_tpu.key", "urh_tpu.second"}
    assert set(stored[SIGNATURE]) == {"port.key"}


# -- the routes of ai/device.py ------------------------------------------------


def _complex_rows(b, width, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, width)) + 1j * rng.normal(size=(b, width))).astype(np.complex64)


def _stats_batch(b, width, seed):
    """Rows of FSK, ASK, PSK and noise: each decision occurs."""
    rng = np.random.default_rng(seed)
    t = np.arange(width)
    sym = (t // 100) % 2
    kinds = [np.exp(1j * 2 * np.pi * np.where(sym, 0.025, -0.025) * t),
             (0.3 + 0.7 * sym) * np.exp(1j * 2 * np.pi * 0.01 * t),
             np.exp(1j * (2 * np.pi * 0.04 * t + np.pi * sym)),
             rng.normal(size=width) + 1j * rng.normal(size=width)]
    rows = [kinds[i % 4] + 0.01 * (rng.normal(size=width) + 1j * rng.normal(size=width))
            for i in range(b)]
    return np.stack(rows).astype(np.complex64)


# (8, 4096) holds DEVICE_MIN_CELLS cells, (8, 2048) half as many
@pytest.mark.parametrize("width,side", [(4096, "card"), (2048, "host")])
def test_cwt_haar_placed(card, width, side):
    """The CWT runs where classification_stats placed its bucket, by
    urh_tpu's rule for cwt_haar (the card from DEVICE_MIN_CELLS cells), and
    equals urh_tpu's host twin either way."""
    x = _complex_rows(8, width, seed=width)
    outputs = []
    real_cwt = ai_device.cwt_haar

    def spy(*args, **kwargs):
        outputs.append(real_cwt(*args, **kwargs))
        return outputs[-1]

    card.setattr(ai_device, "cwt_haar", spy)
    ai_device.classification_stats(x, device="auto")
    assert routes("ai.classification_stats") == {("ai.classification_stats", side): 1}
    normalized = x / np.abs(np.max(x, axis=-1))[:, None]
    np.testing.assert_allclose(outputs[0].numpy(), jax_device.cwt_haar_np(normalized, scale=4),
                               atol=CWT_ATOL)


@pytest.mark.parametrize("k", [11, 65])
def test_rows_on_the_card_stay_there_under_auto(card, k):
    """Only host inputs are placed: rows already on the card run B7 on
    their device with no probe and no route, as afp_demod keeps a staged
    tensor's device; rows on the CPU are placed.  The meta device stands in
    for the card, and B7 is spied on."""
    def probe():
        raise AssertionError("a probe ran for rows on the card")

    card.setattr(placement, "dispatch_overhead_s", probe)
    card.setattr(placement, "transfer_s_per_byte", probe)
    card.setattr(ai_device, "_median_host", lambda *a: pytest.fail("the host route ran"))
    seen = []

    def b7(rows, kk):
        seen.append((rows.device.type, kk))
        return rows

    card.setattr(ai_device, "median_filter", b7)
    rows = torch.empty((4, 1 << 14), device="meta")
    assert ai_device.median_filter_rows(rows, k, device="auto") is rows
    assert seen == [("meta", k)] and routes() == {}

    set_link(card, *LOCAL)
    ai_device.median_filter_rows(torch.zeros(4, 1 << 14), k, device="auto")
    assert seen[1:] == [("cpu", k)] and routes() == {("ai.median_filter_rows", "card"): 1}


@pytest.mark.parametrize("link,side", [(LOCAL, "card"), (RELAY, "host")])
def test_median_filter_rows_placed(card, link, side):
    """4 x 2^14 cells: the card (B7) on a local link; on a relay the host
    route, urh_tpu's native sliding median; equal to urh_tpu's host twin to
    the bit either way."""
    set_link(card, *link)
    card.setattr(jax_device, "use_device", lambda n: False)  # urh_tpu's host twin
    rows = np.random.default_rng(7).normal(size=(4, 1 << 14)).astype(np.float32)
    got = ai_device.median_filter_rows(torch.from_numpy(rows), 11, device="auto")
    assert routes() == {("ai.median_filter_rows", side): 1}
    np.testing.assert_array_equal(got.numpy(), jax_device.median_filter_rows(rows, 11))


@pytest.mark.parametrize("k", [11, 65])
def test_native_median_route_orders_zeros_and_nan_by_less_than(card, k):
    """The host route's native median compares with ``<``: -0.0 and +0.0
    tie and a window holding a NaN has no defined order.  Its full windows
    equal urh_tpu's native twin to the bit (signs of zero and NaNs
    included); every window equals B7's plain version (the card's order,
    -0.0 below +0.0 and NaN last) by value where it holds no NaN."""
    set_link(card, *RELAY)
    rng = np.random.default_rng(k)
    rows = rng.choice(np.array([-0.0, 0.0, 1.0, -1.0, np.nan], np.float32), size=(2, 1 << 15))
    rows[:, :200] = rng.choice(np.array([-0.0, 0.0], np.float32), size=(2, 200))
    got = ai_device.median_filter_rows(torch.from_numpy(rows), k, device="auto").numpy()
    assert routes() == {("ai.median_filter_rows", "host"): 1}
    full = rows.shape[1] - k + 1
    twin = jax_device._median_full_windows_np(rows.astype(np.float64), k)
    assert np.array_equal(got[:, :full].view(np.int32) & ~np.int32(0x003FFFFF),
                          twin.view(np.int32) & ~np.int32(0x003FFFFF))  # NaN payloads aside
    plain = mk.median_filter_plain(torch.from_numpy(rows), k).numpy()
    windows = np.lib.stride_tricks.sliding_window_view(
        np.concatenate([rows, np.zeros((2, k - 1), np.float32)], axis=1), k, axis=1)
    clean = ~np.isnan(windows).any(axis=-1)
    clean[:, full:] = ~np.array([[np.isnan(r[i:]).any() for i in range(full, rows.shape[1])]
                                 for r in rows])
    np.testing.assert_array_equal(got[clean], plain[clean])
    assert clean[:, :200 - k + 1].all()  # the stretch of zeros is compared


@pytest.mark.parametrize("link,side", [(LOCAL, "card"), (RELAY, "host")])
def test_classification_stats_placed(card, link, side):
    """8 x 8192 cells: uploaded on a local link; on a relay the CPU, whose
    median is placed again, on the host as urh_tpu's twin places it."""
    set_link(card, *link)
    batch = _stats_batch(8, 8192, seed=3)
    got = ai_device.classification_stats(batch, device="auto")
    want = ({("ai.classification_stats", "card"): 1} if side == "card" else
            {("ai.classification_stats", "host"): 1, ("ai.median_filter_rows", "host"): 1})
    assert routes() == want
    expected = jax_device.classification_stats(batch)
    for key in ("var_mag", "var_norm_mag", "var_filtered_mag", "var_filtered_norm_mag"):
        np.testing.assert_allclose(got[key], np.asarray(expected[key]), rtol=STATS_RTOL)
    np.testing.assert_array_equal(got["is_fsk"], np.asarray(expected["is_fsk"]))


@pytest.mark.parametrize("n,side", [(1 << 22, "card"), ((1 << 22) - 1, "host")])
def test_histogram_placed(card, n, side):
    values = np.random.default_rng(5).normal(size=n).astype(np.float32)
    edges = np.arange(-3.0, 3.0, 0.25)
    got = ai_device.histogram(values, edges, device="auto")
    assert routes() == {("ai.histogram", side): 1}
    np.testing.assert_array_equal(got, jax_device.histogram(values, edges))


def _fsk_capture(seed, n_msgs=5, n_bits=64, pause=3000):
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(n_msgs):
        bits = rng.integers(0, 2, n_bits)
        bits[0] = bits[-1] = 1
        parts.append(jax_modulate.modulate(bits, 100, "fsk", [-20e3, 20e3],
                                           carrier_frequency=0.0, pause=pause))
    iq = np.concatenate(parts)
    return (iq + rng.normal(0, 0.01, iq.shape)).astype(np.float32)


@pytest.mark.parametrize("link,side", [(LOCAL, "card"), (RELAY, "host")])
def test_estimate_staging_placed(card, link, side):
    """Staged on a local link; unstaged on a relay, each stage then placed
    on its own (the demodulation and the scan's one batch of histograms on
    the host)."""
    set_link(card, *link)
    iq = _fsk_capture(1)
    got = urh_tpu_torch.estimate(iq, device="auto")
    assert placement.ROUTES[("ai.estimate.staging", side)] == 1
    if side == "host":
        assert placement.ROUTES[("dsp.afp_demod", "host")] == 1
        assert placement.ROUTES[("ai.histogram", "host")] == 1  # one batch, five messages
        # unstaged, every width bucket is uploaded, each placed
        assert set(routes("ai.classification_stats")) == {("ai.classification_stats", "host")}
    else:
        assert set(routes()) == {("ai.estimate.staging", "card"), ("ai.histogram", "host")}
    want = urh_tpu.estimate(iq)
    for key in ("modulation_type", "bit_length", "tolerance", "noise"):
        assert got[key] == want[key], (key, got, want)
    assert abs(got["center"] - want["center"]) <= 1e-6


# -- afp_demod, the spectrogram, TX ------------------------------------------------


@pytest.mark.parametrize("n,link,side", [(1 << 16, LOCAL, "card"), ((1 << 16) - 1, LOCAL, "host"),
                                         (1 << 16, RELAY, "host")])
@pytest.mark.parametrize("mod", ["ASK", "FSK"])
def test_afp_demod_placed(card, mod, n, link, side):
    set_link(card, *link)
    x = _fsk_capture(2, n_msgs=8)[:n]
    got = demod.afp_demod(x, 0.1, mod, device="auto")
    assert routes() == {("dsp.afp_demod", side): 1}
    np.testing.assert_allclose(got.numpy(), jax_demod.afp_demod(x, 0.1, mod), atol=QAD_ATOL)
    # a staged tensor keeps its device, and PSK is never placed
    demod.afp_demod(torch.from_numpy(x), 0.1, mod, device="auto")
    demod.afp_demod(x[:300], 0.1, "PSK", device="auto")
    assert routes() == {("dsp.afp_demod", side): 1}


def _tone(n, seed):
    rng = np.random.default_rng(seed)
    x = (np.exp(2j * np.pi * 0.1 * np.arange(n))
         + 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)
    x[1000:3000] = 0  # exactly silent frames: -inf dB
    return x


@pytest.mark.parametrize("link,side", [(LOCAL, "card"), (RELAY, "host")])
def test_spectrogram_placed(card, link, side):
    set_link(card, *link)
    x = _tone(9000, seed=9)
    got = Spectrogram(x, window_size=1024, device="auto")._calculate_spectrogram(x)
    assert routes() == {("dsp.spectrogram", side): 1}
    want = jax_spectrogram.Spectrogram(x, window_size=1024)._calculate_spectrogram(x)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    assert (~finite).any()
    np.testing.assert_allclose(got[finite], want[finite], atol=DB_ATOL)


@pytest.mark.parametrize("n_bits,side", [((1 << 21) // 100 + 1, "card"), (1000, "host")])
@pytest.mark.parametrize("mt,params", [("fsk", [-20e3, 20e3]), ("gfsk", [-20e3, 20e3]),
                                       ("psk", [0.0, np.pi])])
def test_modulate_placed(card, mt, params, n_bits, side):
    """Against urh_tpu's host twin at every size (its XLA route, from 2^21
    samples, is an ulp of the argument away from it)."""
    card.setattr(jax_modulate, "DEVICE_MIN_BODY_SAMPLES", 1 << 62)
    bits = np.random.default_rng(n_bits).integers(0, 2, n_bits)
    got = modulate.modulate(bits, 100, mt, params, pause=500, device="auto")
    assert routes() == {("dsp.modulate", side): 1}
    want = jax_modulate.modulate(bits, 100, mt, params, pause=500)
    extra = (8 * float(np.spacing(np.float32(20e3))) * 2 * np.pi * len(got) / 1e6
             if mt == "gfsk" else 0.0)
    assert np.abs(got.astype(np.float64) - want).max() <= TX_ATOL + extra


# -- awre: urh_tpu's five race keys -------------------------------------------


def _pack(seed, n, alphabet=2, widths=(33, 48, 64)):
    rng = np.random.default_rng(seed)
    return awre_device.pack_messages(
        [rng.integers(0, alphabet, size=int(rng.choice(widths))).astype(np.uint8)
         for _ in range(n)])


OCCURRENCE_PATTERNS = [np.array([1, 0, 1, 1] * 5, np.uint8)[: 3 + i] for i in range(16)]


def _occurrence_call(dev_module, **kw):
    data, lengths = _pack(4, 100)
    return dev_module.occurrence_matrix(data, lengths, OCCURRENCE_PATTERNS,
                                        ignore_columns=(5, 6), **kw)


def _awre_calls():
    """key -> a call of each package's function on inputs above urh_tpu's
    DEVICE_MIN_CELLS (one chunk for the occurrences)."""
    diff = _pack(1, 40)
    counts = _pack(2, 80, alphabet=16)
    grams = _pack(3, 1100)
    crc = (np.random.default_rng(5).integers(0, 2, (1024, 64)).astype(np.uint8),
           [1, 0, 0, 0, 0, 0, 1, 1, 1], [0] * 8, [0] * 8)
    occurrence_pmax = awre_device._pack_patterns(OCCURRENCE_PATTERNS, 64)[2]
    return {
        "awre.first_difference_matrix": lambda m, **kw: m.first_difference_matrix(*diff, **kw),
        "awre.column_value_counts": lambda m, **kw: m.column_agreement(*counts, 16, **kw),
        "awre.ngram_matrix:4": lambda m, **kw: m.ngram_values(*grams, 4, **kw),
        f"awre.occurrence:128x16x64x{occurrence_pmax}": lambda m, **kw: _occurrence_call(m, **kw),
        "awre.batched_crc_matmul": lambda m, **kw: m.batched_crc(*crc, **kw),
    }


def _assert_awre_equal(got, want):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    else:
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("verdict,side", [("device", "card"), ("host", "host"), (None, None)])
@pytest.mark.parametrize("key", sorted(_awre_calls()))
def test_awre_calls_raced_under_urh_tpu_keys(card, key, verdict, side):
    """A stored verdict runs its side alone; without one the call races
    (both sides run) and stores a verdict under urh_tpu's key."""
    if verdict is not None:
        placement._RACE_VERDICTS[key] = verdict
    call = _awre_calls()[key]
    got = call(awre_device, device="auto")
    if side is None:
        assert routes() == {(key, "card"): 1, (key, "host"): 1}
        assert placement._RACE_VERDICTS[key] in ("device", "host")
        assert key in json.load(open(placement._store_path()))[SIGNATURE]
    else:
        assert routes() == {(key, side): 1}
    _assert_awre_equal(got, call(jax_awre))


def test_awre_calls_below_the_threshold_stay_on_the_host(card):
    """Small inputs go to the CPU unraced, as urh_tpu's twins take them; an
    n-gram above 30 bits stays there at any size."""
    data, lengths = _pack(6, 10)
    for got, want in (
            (awre_device.first_difference_matrix(data, lengths, device="auto"),
             jax_awre.first_difference_matrix(data, lengths)),
            (awre_device.column_agreement(data, lengths, device="auto"),
             jax_awre.column_agreement(data, lengths)),
            (awre_device.ngram_values(data, lengths, 8, device="auto")[0],
             jax_awre.ngram_values(data, lengths, 8)[0])):
        np.testing.assert_array_equal(got, want)
    grams = _pack(3, 1100, widths=(64,))
    np.testing.assert_array_equal(awre_device.ngram_values(*grams, 32, device="auto")[0],
                                  jax_awre.ngram_values(*grams, 32)[0])
    assert routes() == {("awre.first_difference_matrix", "host"): 1,
                        ("awre.column_value_counts", "host"): 1,
                        ("awre.ngram_matrix:8", "host"): 1, ("awre.ngram_matrix:32", "host"): 1}
    assert placement._RACE_VERDICTS == {}


def _bench_protocol(package, n_msgs):
    """bench.py's awre protocol (bench.py:556-592), built by the package's
    own ProtocolGenerator, every message on one shared empty type."""
    import importlib

    labels = importlib.import_module(f"{package}.protocol.labels")
    builder = importlib.import_module(f"{package}.awre.message_type_builder")
    generator = importlib.import_module(f"{package}.awre.protocol_generator")
    f = labels.FieldType.Function
    alice = labels.Participant("Alice", address_hex="1337")
    bob = labels.Participant("Bob", address_hex="4711")
    mb = builder.MessageTypeBuilder("data")
    for function, width in ((f.PREAMBLE, 16), (f.SYNC, 16), (f.LENGTH, 8), (f.SRC_ADDRESS, 16),
                            (f.DST_ADDRESS, 16), (f.SEQUENCE_NUMBER, 8)):
        mb.add_label(function, width)
    pg = generator.ProtocolGenerator([mb.message_type], syncs_by_mt={mb.message_type: "0x9a7d"},
                                     participants=[alice, bob])
    rng = np.random.default_rng(42)
    for i in range(n_msgs):
        data = "".join(rng.choice(["0", "1"], size=16 if i % 2 else 32))
        src, dst = (alice, bob) if i % 2 else (bob, alice)
        pg.generate_message(data=data, source=src, destination=dst)
    empty = labels.MessageType("empty")
    for msg in pg.messages:
        msg.message_type = empty
    return pg.messages


def _found(ff):
    types = [(mt.name, [(lbl.name, int(lbl.start), int(lbl.end),
                         lbl.field_type.function.name if lbl.field_type else None)
                        for lbl in mt])
             for mt in ff.message_types]
    members = sorted((mt.name, sorted(int(i) for i in indices))
                     for mt, indices in ff.existing_message_types.items())
    return types, members, list(map(int, ff.sync_ends))


def test_format_finder_auto_equals_urh_tpu(card):
    """FormatFinder keeps "auto" and hands it to every engine: its calls
    are placed (the large ones raced), and its types and labels are
    urh_tpu's; a second run replays the verdicts without racing."""
    ff = FormatFinder(_bench_protocol("urh_tpu_torch", 300), device="auto")
    assert ff.device == "auto"
    ff.run(max_iterations=10)
    jax_ff = JaxFormatFinder(_bench_protocol("urh_tpu", 300))
    jax_ff.run(max_iterations=10)
    found = _found(ff)
    assert found == _found(jax_ff) and found[0][0][1]
    raced = {key for (key, side) in placement.ROUTES if side == "card"}
    assert raced and raced <= set(placement._RACE_VERDICTS)

    placement.ROUTES.clear()
    again = FormatFinder(_bench_protocol("urh_tpu_torch", 300), device="auto")
    again.run(max_iterations=10)
    assert _found(again) == found
    sides = Counter()
    for (key, side), runs in placement.ROUTES.items():
        sides[key] += 1
    assert max(sides.values()) == 1  # one side a key: every race replayed


# -- pass-through: Signal, demodulate, Modulator ---------------------------------


def test_signal_and_modulator_pass_auto_on(card):
    """A Signal made with "auto" lives on the card (here the faked one) and
    hands "auto" to estimate() and to awre; Modulator.modulate places its
    synthesis; the results are those of the CPU."""
    modulator = urh_tpu_torch.Modulator()
    modulator.modulation_type = "FSK"
    modulator.parameters = [-20e3, 20e3]
    modulator.carrier_freq_hz = 0.0
    bits = "1" + "".join(np.random.default_rng(3).choice(["0", "1"], 62)) + "1"
    tx = np.concatenate([modulator.modulate(bits, pause=3000, device="auto").data] * 5)
    assert routes() == {("dsp.modulate", "host"): 1}
    tx = tx + np.random.default_rng(4).normal(0, 0.01, tx.shape).astype(np.float32)

    sig = urh_tpu_torch.Signal.from_iq(tx, device="auto")
    assert (sig.device, sig.requested_device) == (CPU, "auto")
    assert sig.auto_detect(detect_noise=True)
    assert placement.ROUTES[("ai.estimate.staging", "card")] == 1
    cpu = urh_tpu_torch.Signal.from_iq(tx, device="cpu")
    assert cpu.auto_detect(detect_noise=True) and vars(cpu.params) == vars(sig.params)
    messages = urh_tpu_torch.demodulate(sig, device="auto")
    assert [m.plain_bits_str for m in messages] == [bits] * 5
    assert sig.create_new(0, 100).requested_device == "auto"

    placement.ROUTES.clear()
    proto = urh_tpu_torch.ProtocolAnalyzer(sig)
    proto.messages = messages * 4
    proto.auto_assign_labels()
    assert routes("awre.")  # the signal's "auto" reached awre


def test_explicit_devices_are_never_placed(card):
    """"cpu" (and so "cuda") is honoured as given: no probe, no route, no race."""
    def probe():
        raise AssertionError("a probe ran for an explicit device")

    card.setattr(placement, "dispatch_overhead_s", probe)
    card.setattr(placement, "transfer_s_per_byte", probe)
    x = _fsk_capture(2, n_msgs=8)
    rows = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 1 << 14)).astype(np.float32))
    ai_device.median_filter_rows(rows, 11, device="cpu")
    ai_device.classification_stats(_stats_batch(8, 8192, 1), device="cpu")
    ai_device.histogram(x[:, 0], np.arange(-1.0, 1.0, 0.1), device="cpu")
    demod.afp_demod(x, 0.1, "FSK", device="cpu")
    Spectrogram(x[:9000, 0], window_size=1024, device="cpu").create_spectrogram_image()
    modulate.modulate([1, 0] * 11000, 100, "fsk", [-20e3, 20e3], device="cpu")
    urh_tpu_torch.estimate(_fsk_capture(1), device="cpu")
    for key, call in _awre_calls().items():
        call(awre_device, device="cpu")
    FormatFinder(_bench_protocol("urh_tpu_torch", 100), device="cpu").run(max_iterations=2)
    assert routes() == {} and placement._RACE_VERDICTS == {}
