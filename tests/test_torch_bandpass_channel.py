"""Channel isolation in a band's capture: ``Signal.bandpass`` against the
benchmark's plain filter (``benchmark/reference/channel.py``, float64) and
urh_tpu's ``Filter.apply_bandpass_filter``, the 868 MHz SRD band's captures
(``benchmark/gen/srd868.py``) through the port's filter and FSK analysis,
the web app's ``/bandpass`` route, and the filter's spans and counters.

Tolerances: the port's filtered samples are complex64; on the direct route
(np.convolve in complex128, then the cast) they lie within a float32
rounding of the float64 filter, and on the FFT route (torch.fft in float32
over 2^17-2^20 points) within a few float32 roundings of the largest value
for each of the FFT's passes: REF_TOL, relative to the filter's largest
magnitude (6e-7 read at 2^21 samples on the CPU).  Against urh_tpu the
direct route is the same NumPy code (exact); on the FFT route torch.fft and
XLA's FFT round differently, within the same bound.
"""

import numpy as np
import pytest
import torch

from benchmark import registry
from benchmark.gen import srd868
from benchmark.reference import channel as ref_channel
from tests.torch_web_pair import Pair, config, fsk_iq, write_capture  # noqa: F401
from urh_tpu.core.iq import IQData as JaxIQData
from urh_tpu.dsp import filters as jax_filters
from urh_tpu_torch.core.signal import Signal
from urh_tpu_torch.dsp.filters import Filter
from urh_tpu_torch.util.metrics import metrics, now_ns

torch.set_num_threads(1)

CFG = registry.config(registry.benchmark(), "srd868_band_hackrf")
BAND = registry.traffic("channel")
F_LOW, F_HIGH, BW = BAND["f_low"], BAND["f_high"], BAND["filter_bw"]
REF_TOL = 1e-5
N_BAND = 1 << 21  # 0.23 s at 9 Msps: 4 telegrams, 3 802.15.4 exchanges


def int8_capture(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(-128, 128, (n, 2)).astype(np.int8)


# (samples, filter width, route): 8 ln(sqrt(n)) taps is the heuristic's
# edge, 44.4 at 2^16 and 52.7 at 2^19
ROUTES = [(1 << 16, 0.1, "host"),    # 41 taps
          (1 << 19, 0.08, "host"),   # 51 taps
          (1 << 16, 0.08, "card"),   # 51 taps
          (1 << 16, BW, "card")]     # 401 taps, the band's filter


@pytest.mark.parametrize("n,bw,route", ROUTES, ids=[f"{r}-{n}-{bw}" for n, bw, r in ROUTES])
def test_bandpass_equals_the_reference_filter(n, bw, route):
    x = int8_capture(n, seed=n % 97)
    assert Filter.convolution_route(n, Filter.get_filter_length_from_bandwidth(bw)) == route
    got = Signal.from_iq(x, sample_rate=9e6, device="cpu").bandpass(F_LOW, F_HIGH, bw)
    want = ref_channel.bandpass(x, F_LOW, F_HIGH, bw)
    assert got.iq_array.data.dtype == np.float32 and got.num_samples == n
    assert ref_channel.error(got.iq_array.data, want) <= REF_TOL
    # reversed edges are swapped, as URH swaps them
    again = Signal.from_iq(x, sample_rate=9e6, device="cpu").bandpass(F_HIGH, F_LOW, bw)
    np.testing.assert_array_equal(again.iq_array.data, got.iq_array.data)


@pytest.mark.parametrize("n,bw,route", ROUTES[::2], ids=["host", "card"])
def test_bandpass_of_an_int8_capture_equals_urh_tpus_filter(n, bw, route):
    x = int8_capture(n, seed=3)
    sig = Signal.from_iq(x, sample_rate=9e6, modulation="FSK", device="cpu")
    sig.name, sig.samples_per_symbol, sig.noise_threshold = "band", 90, 0.02
    got = sig.bandpass(F_LOW, F_HIGH, bw)
    data = JaxIQData(x).as_complex64()
    np.testing.assert_array_equal(data, sig.iq_array.as_complex64())
    want = jax_filters.Filter.apply_bandpass_filter(data, F_LOW, F_HIGH, filter_bw=bw)
    want = want.astype(np.complex64).view(np.float32).reshape(-1, 2)
    if route == "host":
        np.testing.assert_array_equal(got.iq_array.data, want)
    else:
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.iq_array.data, want, atol=REF_TOL * scale, rtol=0)
    assert got.name == "band filtered" and got.device == torch.device("cpu")
    assert vars(got.params) == vars(sig.params)
    np.testing.assert_array_equal(sig.iq_array.data, x)  # the source is left as it was


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16, np.uint16, np.float32])
def test_as_complex64_is_the_callers_own_and_equals_urh_tpus(dtype):
    rng = np.random.default_rng(7)
    if dtype == np.float32:
        x = rng.uniform(-1, 1, (1 << 12, 2)).astype(np.float32)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max + 1, (1 << 12, 2)).astype(dtype)
    kept = x.copy()
    iq = Signal.from_iq(x, device="cpu").iq_array
    got = iq.as_complex64()
    assert got.dtype == np.complex64 and got.shape == (1 << 12,) and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, JaxIQData(kept).as_complex64())
    got[:] = 0  # the caller's own: the capture is left as it was
    np.testing.assert_array_equal(iq.data, kept)
    staged = iq.staged_complex64("cpu")  # converted where the capture is staged
    assert staged.dtype == torch.complex64 and staged.shape == (1 << 12,)
    np.testing.assert_array_equal(staged.numpy(), JaxIQData(kept).as_complex64())
    np.testing.assert_array_equal(iq.data, kept)


def test_fft_convolve_takes_a_tensor_as_it_takes_an_array():
    x = Signal.from_iq(int8_capture(1 << 15, seed=11), device="cpu").iq_array
    h = Filter.design_windowed_sinc_bandpass(F_LOW, F_HIGH, BW)
    want = Filter.fft_convolve_1d(x.as_complex64(), h, "cpu")
    got = Filter.fft_convolve_1d(x.staged_complex64("cpu"), h, "cpu")
    assert got.dtype == np.complex64 and len(got) == 1 << 15
    np.testing.assert_array_equal(got, want)
    # real samples and real taps give real values, as from an array
    lpf, re = Filter.design_windowed_sinc_lpf(0.1, BW), x.as_complex64().real.copy()
    real = Filter.fft_convolve_1d(torch.from_numpy(re), lpf, "cpu")
    assert real.dtype == np.float32 and len(real) == 1 << 15
    np.testing.assert_array_equal(real, Filter.fft_convolve_1d(re, lpf, "cpu"))


def test_bandpass_width_defaults_to_the_configured_one(monkeypatch):
    from urh_tpu_torch.util import settings

    monkeypatch.setattr(settings, "_store", {"bandpass_filter_bw_type": "Narrow"})
    x = int8_capture(1 << 14, seed=5)
    got = Signal.from_iq(x, device="cpu").bandpass(F_LOW, F_HIGH)
    want = Signal.from_iq(x, device="cpu").bandpass(F_LOW, F_HIGH, 0.01)
    np.testing.assert_array_equal(got.iq_array.data, want.iq_array.data)


def frame_bytes(chips: str, code: list) -> bytes:
    """A telegram's 3-out-of-6 words -> its bytes (high nibble first);
    ValueError on a word outside the code."""
    nibbles = [code.index(chips[k:k + 6]) for k in range(0, len(chips), 6)]
    return bytes(16 * a + b for a, b in zip(nibbles[::2], nibbles[1::2]))


@pytest.fixture(scope="module")
def band():
    x, frames = srd868.capture(CFG, [2**31 + 101, 0], N_BAND, BAND["data_psdu_octets"], layout=0)
    return x, frames


def test_without_the_filter_fsk_detection_finds_no_90_sample_chips(band):
    x, _ = band
    sig = Signal.from_iq(x, sample_rate=CFG["sample_rate"], modulation="FSK", device="cpu")
    found = sig.auto_detect(detect_modulation=False, detect_noise=True)
    assert not found or sig.samples_per_symbol != 90, sig.params


def test_the_filtered_channel_gives_every_telegram(band):
    """The meters' band filtered out: FSK at 90 samples a chip, the center
    at the channel's offset (within a tenth of the deviation's phase step),
    and each telegram's bytes decoded from the message it gives."""
    x, frames = band
    wm = CFG["systems"]["wmbus_t1"]
    rate = CFG["sample_rate"]
    sig = Signal.from_iq(x, sample_rate=rate, modulation="FSK", device="cpu")
    filtered = sig.bandpass(F_LOW, F_HIGH, BW)
    assert filtered.auto_detect(detect_modulation=False, detect_noise=True)
    assert filtered.modulation_type == "FSK" and filtered.samples_per_symbol == 90
    offset = 2 * np.pi * wm["offset_hz"] / rate
    assert abs(filtered.center - offset) < 0.1 * 2 * np.pi * wm["deviation_hz"] / rate
    from urh_tpu_torch.protocol.analyzer import demodulate

    messages = demodulate(filtered)
    telegrams = frames["wmbus_t1"]
    assert len(telegrams) >= 3 and len(messages) == len(telegrams)
    frame = wm["frame"]
    head, tail = len(frame["preamble"]) + len(frame["sync"]), len(frame["postamble"])
    for m, (_, size, chips) in zip(messages, telegrams):
        bits = "".join(map(str, m.plain_bits.plane.tolist()))
        at = bits.find(frame["preamble"][-8:] + frame["sync"])
        assert at >= 0, bits[:80]
        body = bits[at + 8 + len(frame["sync"]):][:12 * size]
        assert frame_bytes(body, wm["code_3of6"]) == frame_bytes(chips[head:-tail],
                                                                 wm["code_3of6"])
        assert len(frame_bytes(body, wm["code_3of6"])) == size


def test_the_port_analyses_its_filtered_channel_as_the_reference_does(band):
    x, _ = band
    sig = Signal.from_iq(x, sample_rate=CFG["sample_rate"], modulation="FSK", device="cpu")
    filtered = sig.bandpass(F_LOW, F_HIGH, BW)
    assert ref_channel.error(filtered.iq_array.data,
                             ref_channel.bandpass(x, F_LOW, F_HIGH, BW)) <= REF_TOL
    filtered.auto_detect(detect_modulation=False, detect_noise=True)
    params, _ = ref_channel.analyze(filtered.iq_array.data)
    assert (params["samples_per_symbol"], params["tolerance"], params["noise"]) == (
        filtered.samples_per_symbol, filtered.tolerance, filtered.noise_threshold)
    lo, hi = params["center_band"]
    assert lo - 1e-6 <= filtered.center <= hi + 1e-6


def test_the_filter_records_its_spans_and_counters_once_a_call():
    for n, bw, route in ROUTES[::2]:
        x = int8_capture(n, seed=11)
        before, t0 = metrics.counters(), now_ns()
        Signal.from_iq(x, device="cpu").bandpass(F_LOW, F_HIGH, bw)
        spans = [s for s in metrics.timeline() if s.start_ns >= t0
                 and s.name in ("filter.bandpass", "filter.convolve")]
        taps = Filter.get_filter_length_from_bandwidth(bw)
        assert [s.name for s in spans] == ["filter.convolve", "filter.bandpass"]  # by end
        outer, inner = spans[1], spans[0]
        assert outer.args == {"samples": n, "taps": taps, "route": route}
        assert inner.args == outer.args
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
        after = metrics.counters()
        delta = {k: after.get(k, 0) - before.get(k, 0)
                 for k in ("filter.samples", "filter.card", "filter.host")}
        assert delta == {"filter.samples": n, "filter.card": int(route == "card"),
                         "filter.host": int(route == "host")}


def test_the_web_route_filters_through_signal_bandpass(config, tmp_path, monkeypatch):
    calls = []
    real = Signal.bandpass

    def counted(self, *args):
        calls.append(args)
        return real(self, *args)

    monkeypatch.setattr(Signal, "bandpass", counted)
    path = write_capture(tmp_path, "fsk.complex", fsk_iq("1010" * 20))
    pair = Pair()
    try:
        status, sig = pair.call("POST", "/api/signal/open", {"path": path})
        assert status == 200
        status, first = pair.call("POST", f"/api/signal/{sig['id']}/bandpass",
                                  {"f_low": -0.05, "f_high": 0.05, "bw": 0.08})
        assert status == 200 and first["name"].endswith(" filtered")
        # no width: the configured one, on both sides
        status, second = pair.call("POST", f"/api/signal/{sig['id']}/bandpass",
                                   {"f_low": 0.05, "f_high": -0.05})
        assert status == 200 and second["id"] == first["id"] + 1
    finally:
        pair.close()
    assert calls == [(-0.05, 0.05, 0.08), (0.05, -0.05, None)]
