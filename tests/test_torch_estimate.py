"""Auto-interpretation (estimate, Signal.auto_detect) against urh_tpu's.

The same seeded inputs go through urh_tpu.ai and urh_tpu_torch.ai on the
CPU (the port's plain versions, B7's among them).  Tolerances:

* host copies (segmentation, plateaus, divisor histogram, k-means) and
  the histogram's counts: exact;
* CWT values: atol 1e-4 of rows of unit scale (torch.fft and NumPy's or
  XLA's FFT round differently);
* classification statistics: rtol 1e-4 (measured: 1e-6), is_fsk and the
  decisions exact, on both sides of urh_tpu's DEVICE_MIN_CELLS (its host
  twin below, its XLA program above) and through the staged gather;
* estimate(): modulation_type, bit_length and tolerance exact, noise exact
  (host arithmetic on both sides), center within 1e-6 (FSK's discriminator
  is atan2 in XLA against torch's), on captures away from the decision
  thresholds; a BPSK center within 1e-4 (the Costas loop's output, whose
  sin/cos differ by rounding) where the lead shifts.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import urh_tpu
import urh_tpu_torch
from urh_tpu.ai import device as jax_device
from urh_tpu.ai import estimate as jax_estimate
from urh_tpu.ai import kernels as jax_kernels
from urh_tpu.ai import segmentation as jax_seg
from urh_tpu.ai import wavelet as jax_wavelet
from urh_tpu.core.iq import IQData as JaxIQData
from urh_tpu.dsp.modulate import modulate
from urh_tpu_torch.ai import device as ai_device
from urh_tpu_torch.ai import estimate as est
from urh_tpu_torch.ai import kernels, segmentation, wavelet
from urh_tpu_torch.ai import median_kernels as mk
from urh_tpu_torch.core.iq import IQData
from urh_tpu_torch.core.signal import Signal

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CENTER_ATOL = 1e-6
STATS_RTOL = 1e-4
CWT_ATOL = 1e-4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT,
                                                                            "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _capture(kind, seed, n_msgs=5, n_bits=64, pause=3000, noise=0.01):
    """[message, pause] * n_msgs from urh_tpu's modulator, every message
    opening and closing with a 1, plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(n_msgs):
        bits = rng.integers(0, 2, n_bits)
        bits[0] = bits[-1] = 1
        if kind == "FSK":
            iq = modulate(bits, 100, "fsk", [-20e3, 20e3], carrier_frequency=0.0, pause=pause)
        elif kind == "ASK":
            iq = modulate(bits, 100, "ask", [0.3, 1.0], carrier_frequency=10e3, pause=pause)
        elif kind == "OOK":
            iq = modulate(bits, 100, "ask", [0.0, 1.0], carrier_frequency=10e3, pause=pause)
        else:
            iq = modulate(bits, 100, "psk", [0.0, np.pi], carrier_frequency=40e3, pause=pause)
        parts.append(iq)
    iq = np.concatenate(parts)
    return (iq + rng.normal(0, noise, iq.shape)).astype(np.float32)


def _int8(iq):
    return np.clip(np.round(iq * 127), -128, 127).astype(np.int8)


# PSK stays small: the plain Costas loop steps sample by sample
CAPTURES = {
    "FSK": dict(seed=1),
    "ASK": dict(seed=2),
    "OOK": dict(seed=3),
    "PSK": dict(seed=4, n_msgs=2, n_bits=32, pause=2000),
}


def _assert_same_estimate(got, want):
    assert got is not None and want is not None
    for key in ("modulation_type", "bit_length", "tolerance", "noise"):
        assert got[key] == want[key], (key, got, want)
    assert abs(got["center"] - want["center"]) <= CENTER_ATOL, (got, want)


# -- host copies ---------------------------------------------------------------


def test_segmentation_equals_urh_tpu():
    rng = np.random.default_rng(0)
    for trial in range(20):
        data = rng.normal(size=rng.integers(1, 200)) * rng.uniform(0.1, 5)
        for z in (1, 2, 3):
            assert np.array_equal(segmentation._drop_outliers(data, z),
                                  jax_seg._drop_outliers(data, z))
        assert segmentation.max_without_outliers(data) == jax_seg.max_without_outliers(data)
        assert segmentation.min_without_outliers(data) == jax_seg.min_without_outliers(data)
        mags = np.abs(_capture("ASK", trial, n_msgs=3, n_bits=16)[:, 0]).astype(np.float64)
        noise = segmentation.detect_noise_level(mags)
        assert noise == jax_seg.detect_noise_level(mags)
        segments = segmentation.segment_messages_from_magnitudes(mags, noise)
        assert segments == jax_seg.segment_messages_from_magnitudes(mags, noise)
        assert (segmentation.merge_message_segments_for_ook(segments)
                == jax_seg.merge_message_segments_for_ook(segments))
    assert segmentation.max_without_outliers(np.zeros(0)) is None


def test_plateau_and_divisor_kernels_equal_urh_tpu():
    rng = np.random.default_rng(1)
    for trial in range(20):
        rect = np.repeat(rng.choice([-0.5, 0.5], 40), rng.integers(1, 300, 40))
        rect = (rect + rng.normal(0, 0.05, len(rect))).astype(np.float32)
        plateaus = kernels.get_plateau_lengths(rect, 0.0, percentage=25 + trial)
        assert np.array_equal(plateaus, jax_kernels.get_plateau_lengths(rect, 0.0, 25 + trial))
        for tol in (0, 1, 5, 50):
            assert np.array_equal(kernels.merge_plateaus(plateaus, tol, 10000),
                                  jax_kernels.merge_plateaus(plateaus, tol, 10000))
        assert np.array_equal(kernels.get_threshold_divisor_histogram(plateaus),
                              jax_kernels.get_threshold_divisor_histogram(plateaus))
        centers, clusters = kernels.k_means(rect[:200])
        want_centers, want_clusters = jax_kernels.k_means(rect[:200])
        assert np.array_equal(centers, want_centers) and clusters == want_clusters


def test_per_message_parameters_equal_urh_tpu():
    rng = np.random.default_rng(2)
    lengths = [[100, 200, 100, 300, 100], [99, 201, 298, 102], [50, 50, 150, 3, 47, 100]]
    for plateaus in lengths:
        assert (est.get_bit_length_from_plateau_lengths(list(plateaus))
                == jax_estimate.get_bit_length_from_plateau_lengths(list(plateaus)))
        assert (est.estimate_tolerance_from_plateau_lengths(np.array(plateaus))
                == jax_estimate.estimate_tolerance_from_plateau_lengths(np.array(plateaus)))
    values = list(rng.integers(0, 5, 30))
    assert est.get_most_frequent_value(values) == jax_estimate.get_most_frequent_value(values)
    assert est.most_common(values) == jax_estimate.most_common(values)
    assert (est.get_tolerant_greatest_common_divisor([100, 200, 300, 50])
            == jax_estimate.get_tolerant_greatest_common_divisor([100, 200, 300, 50]))
    rect = _capture("FSK", 9, n_msgs=1)[:, 0]
    assert (est.detect_center(rect, device="cpu") == jax_estimate.detect_center(rect))


# -- wavelet and device statistics ------------------------------------------------


@pytest.mark.parametrize("n", [64, 1000, 4096])
def test_cwt_haar_equals_urh_tpu(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    got = wavelet.cwt_haar(torch.from_numpy(x), scale=4).numpy()
    np.testing.assert_allclose(got, jax_wavelet.cwt_haar(x, scale=4), atol=CWT_ATOL)
    batch = np.stack([x[:64], x[64:128]]) if n >= 128 else x[None]
    got = ai_device.cwt_haar(torch.from_numpy(batch), scale=4).numpy()
    np.testing.assert_allclose(got, jax_device.cwt_haar_np(batch, scale=4), atol=CWT_ATOL)
    omega = wavelet.angular_frequencies(n)
    np.testing.assert_array_equal(omega, jax_wavelet.angular_frequencies(n))
    np.testing.assert_array_equal(wavelet.normalized_haar_wavelet(omega * 4, 4),
                                  jax_wavelet.normalized_haar_wavelet(omega * 4, 4))


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


def _assert_same_stats(got, want):
    for key in ("var_mag", "var_norm_mag", "var_filtered_mag", "var_filtered_norm_mag"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=STATS_RTOL, err_msg=key)
    np.testing.assert_array_equal(got["is_fsk"], np.asarray(want["is_fsk"]))
    decide = est._decide_modulation
    assert ([decide(*(got[k][i] for k in got)) for i in range(len(got["is_fsk"]))]
            == [decide(*(np.asarray(want[k])[i] for k in got)) for i in range(len(got["is_fsk"]))])


# 8 x 1024 cells lie below urh_tpu's DEVICE_MIN_CELLS (its host twin), 8 x
# 8192 above it (its XLA program)
@pytest.mark.parametrize("b,width", [(8, 1024), (8, 8192)])
def test_classification_stats_equal_urh_tpu(b, width):
    assert (b * width >= jax_device.DEVICE_MIN_CELLS) == (width == 8192)
    batch = _stats_batch(b, width, seed=width)
    _assert_same_stats(ai_device.classification_stats(batch, device="cpu"),
                       jax_device.classification_stats(batch))


@pytest.mark.parametrize("dtype", [np.float32, np.int8], ids=["float32", "int8"])
def test_staged_classification_stats_equal_urh_tpu(dtype):
    """Rows gathered from the resident capture by their starts, raw units."""
    rows = _stats_batch(6, 2048, seed=7)
    capture = np.concatenate([np.stack((r.real, r.imag), 1) for r in rows]).astype(np.float32)
    capture = np.concatenate((np.zeros((300, 2), np.float32), capture))
    if dtype == np.int8:
        capture = _int8(capture / 2)
    starts = [300 + 2048 * i for i in range(6)]
    planes = IQData(capture).staged_planes("cpu")
    got = ai_device.classification_stats_staged(planes, starts, 2048)
    want = jax_device.classification_stats_staged(JaxIQData(capture).staged_planes(), starts,
                                                  2048)
    _assert_same_stats(got, want)


def test_histogram_counts_as_np_histogram_below_the_threshold():
    rng = np.random.default_rng(3)
    for trial in range(30):
        v = (rng.normal(size=3000) * rng.uniform(0.1, 3)).astype(np.float32)
        if trial % 3 == 0:
            v = np.round(v * 4) / 4  # values on the edges
        edges = np.arange(float(v.min()), float(v.max()) + float(np.var(v)), float(np.var(v)))
        np.testing.assert_array_equal(ai_device.histogram(v, edges, device="cpu"),
                                      np.histogram(v, bins=edges)[0])
        np.testing.assert_array_equal(ai_device.histogram(v, edges, device="cpu"),
                                      jax_device.histogram(v, edges))
    assert len(ai_device.histogram(v, edges[:1], device="cpu")) == 0


def _device_binning(v, edges):
    """urh_tpu's device route of histogram(): _histogram_jax over the
    values inside the edges (called directly: urh_tpu picks the route by a
    threshold it scales with the measured dispatch cost)."""
    lo = float(edges[0])
    inside = v[(v >= lo) & (v <= float(edges[-1]))]
    return np.asarray(jax_device._histogram_jax(inside.astype(np.float32), lo,
                                                float(edges[1] - edges[0]), len(edges) - 1))


def test_histogram_bins_as_urh_tpu_device_route(monkeypatch):
    """From HISTOGRAM_MIN_VALUES on: the binning against _histogram_jax at a
    small n (the threshold lowered), then at the threshold itself."""
    rng = np.random.default_rng(4)
    for trial in range(20):
        v = (rng.normal(size=2000) * rng.uniform(0.1, 3)).astype(np.float32)
        if trial % 2:
            v = np.round(v * 8) / 8
        step = float(np.var(v))
        edges = np.arange(float(v.min()), float(v.max()) + step, step)
        monkeypatch.setattr(ai_device, "HISTOGRAM_MIN_VALUES", 1)
        np.testing.assert_array_equal(ai_device.histogram(v, edges, device="cpu"),
                                      _device_binning(v, edges))
        monkeypatch.undo()
    v = np.round(rng.normal(size=ai_device.HISTOGRAM_MIN_VALUES) * 40).astype(np.float32) / 40
    edges = np.arange(float(v.min()), float(v.max()) + 0.05, 0.05)
    np.testing.assert_array_equal(ai_device.histogram(v, edges, device="cpu"),
                                  _device_binning(v, edges))


# -- estimate and auto_detect --------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.int8], ids=["float32", "int8"])
@pytest.mark.parametrize("kind", sorted(CAPTURES))
def test_estimate_equals_urh_tpu(kind, dtype):
    iq = _capture(kind, **CAPTURES[kind])
    if dtype == np.int8:
        iq = _int8(iq)
    before = dict(mk.LAUNCHES)
    got = est.estimate(iq, device="cpu")
    want = urh_tpu.estimate(iq)
    _assert_same_estimate(got, want)
    assert got["modulation_type"] == ("ASK" if kind == "OOK" else kind)
    assert got["bit_length"] == 100
    assert mk.LAUNCHES == before  # the CPU runs the plain versions


def test_classify_messages_equals_urh_tpu():
    """Per-segment decisions, staged and uploaded buckets, widths of several
    powers of two (messages of 16 to 64 bits), a zero inside a message."""
    iq = np.concatenate([_capture(kind, 10 + i, n_msgs=2, n_bits=16 * (1 + i % 3))
                         for i, kind in enumerate(["FSK", "ASK", "PSK", "FSK"])])
    iq[5000] = 0.0  # a dead sample: that segment is uploaded, not gathered
    mags = IQData(iq).magnitudes
    noise = segmentation.detect_noise_level(mags)
    segments = segmentation.segment_messages_from_magnitudes(mags, noise)
    data = IQData(iq)
    got = est.classify_messages(data, segments, staged=data.staged_planes("cpu"))
    assert got == jax_estimate.classify_messages(JaxIQData(iq), segments)
    decisions, staged, uploaded = est.bucket_segments(data, segments, staged=True)
    assert len(staged) >= 2 and len(uploaded) == 1
    assert est.detect_modulation(iq[:6400, 0] + 1j * iq[:6400, 1], device="cpu") == (
        jax_estimate.detect_modulation(iq[:6400, 0] + 1j * iq[:6400, 1]))


@pytest.mark.parametrize("detect_noise", [False, True])
def test_auto_detect_sets_the_same_parameters(detect_noise):
    iq = _capture("FSK", 21)
    want = urh_tpu.Signal.from_iq(iq)
    got = Signal.from_iq(iq, device="cpu")
    for sig in (want, got):
        sig.noise_threshold = 0.05
        sig.modulation_type = "ASK"
    assert got.auto_detect(detect_noise=detect_noise) == want.auto_detect(
        detect_noise=detect_noise) is True
    for field in ("modulation", "samples_per_symbol", "tolerance", "noise_threshold"):
        assert getattr(got.params, field) == getattr(want.params, field), field
    assert abs(got.center - want.center) <= CENTER_ATOL
    # with the modulation given, FSK is kept
    assert got.auto_detect(detect_modulation=False) and got.modulation_type == "FSK"


def test_chip_smoke_captures_are_estimated_as_made():
    """urh_tpu's estimate and the port's give the modulation and bit length
    chip_smoke.py made its captures with, on CPU-sized versions of them."""
    cs = _chip_smoke()
    psk = dict(n=20_000, seed=43, n_bits=16, pause=2000, lock_in=1000)
    for name, iq, _, kind, _ in cs.estimate_captures(150_000, psk, 2, 200, device="cpu"):
        want = urh_tpu.estimate(iq)
        assert (want["modulation_type"], want["bit_length"]) == (kind, 100), (name, want)
        _assert_same_estimate(est.estimate(iq, device="cpu"), want)


# lead shift -> urh_tpu's own tolerance for chip_smoke.py's BPSK capture cut
# to 120,000 samples (its center moves too)
PSK_SHIFT_TOLERANCE = {0: 1, 2: 0, 10: 1, 14: 0}
# The BPSK center comes from the Costas loop's output, where torch's float32
# sin/cos and XLA's differ by rounding; test_torch_costas.py holds the two
# loops to 1e-4, and a center read off the lock-in burst moves with them.
PSK_CENTER_ATOL = 1e-4


@pytest.mark.parametrize("shift", sorted(PSK_SHIFT_TOLERANCE))
def test_psk_estimate_follows_urh_tpu_across_lead_shifts(shift):
    """The BPSK estimate's tolerance and center move with a few more silent
    samples ahead of the capture, in urh_tpu as in the port: the port gives
    urh_tpu's modulation, bit length, tolerance and noise at each shift, and
    its center within the Costas loop's tolerance."""
    cs = _chip_smoke()
    n = 120_000
    iq, _ = cs.make_psk_capture(n=n, seed=13, silence=cs.quiet_lead(n) + shift)
    want = urh_tpu.estimate(iq)
    assert (want["modulation_type"], want["bit_length"]) == ("PSK", 100)
    assert want["tolerance"] == PSK_SHIFT_TOLERANCE[shift]
    got = est.estimate(iq, device="cpu")
    for key in ("modulation_type", "bit_length", "tolerance", "noise"):
        assert got[key] == want[key], (key, got, want)
    assert abs(got["center"] - want["center"]) <= PSK_CENTER_ATOL, (got, want)


@pytest.mark.parametrize("shift,tolerance", [(0, 1), (10, 0)])
def test_urh_tpu_psk_estimate_moves_with_the_lead_at_full_size(shift, tolerance):
    """chip_smoke.py's 2^22-sample BPSK capture: urh_tpu's own estimate gives
    tolerance 1, and 0 with 10 more silent samples ahead, as the port does
    on the card (chip_smoke.py's estimate_phase prints it)."""
    cs = _chip_smoke()
    n = 1 << 22
    iq, _ = cs.make_psk_capture(n=n, seed=13, silence=cs.quiet_lead(n) + shift)
    want = urh_tpu.estimate(iq)
    assert (want["modulation_type"], want["bit_length"], want["tolerance"]) == (
        "PSK", 100, tolerance)


@pytest.mark.parametrize("dtype", [np.float32, np.int8], ids=["float32", "int8"])
def test_ask_messages_at_the_estimated_parameters_equal_urh_tpu(dtype):
    """chip_smoke.py's ASK capture cut to 2^20 samples, demodulated at the
    parameters auto_detect finds: the port's messages are urh_tpu's, bit for
    bit.  Both split messages apart: an ASK zero is silence, and a run of
    zero bits as long as the pause threshold (8 symbols) ends a message."""
    cs = _chip_smoke()
    n = 1 << 20
    iq, sent = cs.make_capture("ASK", n, 12, lead=cs.quiet_lead(n))
    if dtype == np.int8:
        iq = cs.to_int8(iq)
    want_sig, got_sig = urh_tpu.Signal.from_iq(iq), Signal.from_iq(iq, device="cpu")
    assert want_sig.auto_detect(detect_noise=True) and got_sig.auto_detect(detect_noise=True)
    for field in ("modulation", "samples_per_symbol", "tolerance", "noise_threshold",
                  "pause_threshold"):
        assert getattr(got_sig.params, field) == getattr(want_sig.params, field), field
    assert abs(got_sig.center - want_sig.center) <= CENTER_ATOL
    want = [bytes(m.plain_bits) for m in urh_tpu.demodulate(want_sig)]
    got = [bytes(m.plain_bits) for m in urh_tpu_torch.demodulate(got_sig)]
    assert got == want
    assert len(want) > len(sent)  # urh_tpu's own split
