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


def _edge_batch(seed):
    """Messages of several sizes and scales, some on their edges, some
    holding -0.0 and +0.0 with an edge at zero, one with one bin and one with
    no bin, with np.arange edges as detect_center makes them."""
    rng = np.random.default_rng(seed)
    values, edges = [], []
    for k in range(12):
        v = (rng.normal(size=int(rng.integers(1, 3000))) * rng.uniform(1e-3, 5)).astype(np.float32)
        if k % 3 == 0:
            v = (np.round(v * 8) / 8).astype(np.float32)  # on the edges
        if k % 4 == 1:
            v[: len(v) // 2] = np.where(rng.random(len(v) // 2) < 0.5, -0.0, 0.0)
        lo, hi, step = float(v.min()), float(v.max()), float(np.var(v))
        e = np.arange(lo, hi + step, step) if step > 0 else np.array([lo])
        if k % 4 == 1:
            e = np.arange(-0.5, 0.625, 0.125)  # an edge at 0.0
        values.append(v)
        edges.append(e)
    values += [np.array([1.0, 2.0], np.float32), np.array([3.0], np.float32)]
    edges += [np.array([1.0, 2.0]), np.array([3.0])]  # one bin (both closed), none
    return values, edges


def _histograms(values, edges, resident=False):
    """ai_device.histograms of separate messages on the CPU: their values laid
    out by the call, or read from a resident tensor that holds them apart,
    each after a gap of sentinels and with one more inside its span, past
    its rank window."""
    if not resident:
        return ai_device.histograms(values, edges, device="cpu")
    gap = np.full(7, -5.0, np.float32)
    source = np.concatenate([part for v in values for part in (gap, v, gap[:1])])
    spans, at = [], 0
    for v in values:
        at += len(gap)
        spans.append((at, at + len(v) + 1, 0, len(v)))
        at += len(v) + 1
    return ai_device.histograms(values, edges, device="cpu",
                                resident=(torch.from_numpy(source), spans, -np.inf))


@pytest.mark.parametrize("resident", [False, True], ids=["laid_out", "resident"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histograms_count_each_message_as_np_histogram(seed, resident):
    """Below HISTOGRAM_MIN_VALUES every message of one batch gets
    np.histogram's counts (float64 comparisons, the last bin closed)."""
    values, edges = _edge_batch(seed)
    got = _histograms(values, edges, resident)
    for v, e, counts in zip(values, edges, got):
        want = np.histogram(v, bins=e)[0] if len(e) > 1 else np.zeros(0, np.int64)
        np.testing.assert_array_equal(counts, want)
        np.testing.assert_array_equal(counts, jax_device.histogram(v, e))
        assert counts.dtype == np.int64


@pytest.mark.parametrize("resident", [False, True], ids=["laid_out", "resident"])
def test_histograms_select_ranked_values_above_the_bound(resident):
    """A span counts its values above ``above``, of those the ones ranked
    first to last - 1, wherever sentinels lie inside it: the counts of
    np.histogram over that selection, for spans that overlap and that cut a
    run of sentinels."""
    rng = np.random.default_rng(11)
    source = (rng.normal(size=5000) * 0.3).astype(np.float32)
    source[rng.random(5000) < 0.2] = -5.0  # sentinels everywhere
    source[100:160] = -4.0  # at the bound: not above it
    spans = [(0, 5000, 250, 3750), (90, 170, 0, 20), (1000, 3000, 0, 1), (1000, 3000, 37, 1200),
             (4990, 5000, 0, 10)]
    edges, want = [], []
    for start, stop, first, last in spans:
        chosen = source[start:stop][source[start:stop] > -4][first:last]
        e = np.linspace(-1.0, 1.0, 17)
        edges.append(e)
        want.append(np.histogram(chosen, bins=e)[0])
    values = [source[a:z][source[a:z] > -4][f:l] for a, z, f, l in spans]
    got = ai_device.histograms(values, edges, device="cpu",
                               resident=(torch.from_numpy(source), spans, -4) if resident else None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_histograms_bin_the_large_message_alone_in_float32():
    """One message of HISTOGRAM_MIN_VALUES values beside short ones in one
    batch: urh_tpu's float32 binning for that message, np.histogram's counts
    for the others."""
    rng = np.random.default_rng(6)
    big = np.round(rng.normal(size=ai_device.HISTOGRAM_MIN_VALUES) * 40).astype(np.float32) / 40
    values, edges = _edge_batch(7)
    values.insert(3, big)
    edges.insert(3, np.arange(float(big.min()), float(big.max()) + 0.05, 0.05))
    got = _histograms(values, edges)
    np.testing.assert_array_equal(got[3], _device_binning(big, edges[3]))
    assert not np.array_equal(got[3], np.histogram(big, bins=edges[3])[0])  # the rules differ
    for i, (v, e) in enumerate(zip(values, edges)):
        if i != 3 and len(e) > 1:
            np.testing.assert_array_equal(got[i], np.histogram(v, bins=e)[0])


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


# each ingest dtype: (quantize a float32 capture in [-1, 1], the raw sample that
# converts to 0 + 0j); float32's is -0.0, which the zero test takes as 0 too
DTYPE_CASES = {
    "int8": (lambda x: np.clip(np.round(x * 127), -128, 127).astype(np.int8), 0),
    "uint8": (lambda x: np.clip(np.round(x * 127) + 128, 0, 255).astype(np.uint8), 128),
    "int16": (lambda x: np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16), 0),
    "uint16": (lambda x: np.clip(np.round(x * 32767) + 32768, 0, 65535).astype(np.uint16),
               32768),
    "float32": (lambda x: x.astype(np.float32), -0.0),
}

# segment -> offsets of its zero samples, None: from its end; the messages are
# 1600 (width 1024), 3200 (2048) and 4800 (4096) samples long
ZERO_PLANTS = [
    (),  # zero-free: gathered where staged
    (10,),  # one zero inside the power-of-two width: uploaded
    (100, 101, 2000),  # three inside
    (-1, -2, -3),  # three after the width: gathered where staged
    (5, 6, 7, 8),  # more than _OOK_MAX_ZEROS: OOK without statistics
    (-10,),  # one after the width
]


@pytest.mark.parametrize("staged", [False, True], ids=["unstaged", "staged"])
@pytest.mark.parametrize("dtype", sorted(DTYPE_CASES))
def test_classification_screens_every_dtype_as_urh_tpu(dtype, staged):
    """classify_messages of a capture in each ingest dtype equals urh_tpu's
    (staged on both sides, or on neither), with segments holding no zero,
    1-3 zeros inside and after their power-of-two width, and more than
    _OOK_MAX_ZEROS; bucket_segments puts each segment in the bucket it takes
    when the whole capture is converted to complex64 first."""
    quantize, zero = DTYPE_CASES[dtype]
    iq = np.concatenate([_capture(kind, 30 + i, n_msgs=2, n_bits=16 * (1 + i % 3))
                         for i, kind in enumerate(["FSK", "ASK", "PSK"])])
    mags = IQData(iq).magnitudes
    segments = segmentation.segment_messages_from_magnitudes(
        mags, segmentation.detect_noise_level(mags))
    assert len(segments) == 6
    x = quantize(iq)
    for (start, end), plants in zip(segments, ZERO_PLANTS):
        for offset in plants:
            x[start + offset if offset >= 0 else end + offset] = zero

    data = IQData(x)
    got = est.classify_messages(data, segments, device="cpu",
                                staged=data.staged_planes("cpu") if staged else None)
    jax_data = JaxIQData(x)
    want = jax_estimate.classify_messages(
        jax_data, segments, staged=jax_data.staged_planes() if staged else None)
    assert got == want
    assert got[4] == "OOK" and None not in got

    whole = IQData(data.as_complex64().view(np.float32).reshape(-1, 2), skip_conversion=True)
    decisions, gathered, uploaded = est.bucket_segments(data, segments, staged=staged)
    want_decisions, want_gathered, want_uploaded = est.bucket_segments(whole, segments,
                                                                       staged=staged)
    assert decisions == want_decisions and gathered == want_gathered
    assert sorted(uploaded) == sorted(want_uploaded)
    for width, members in uploaded.items():
        assert [i for i, _ in members] == [i for i, _ in want_uploaded[width]]
        for (_, row), (_, want_row) in zip(members, want_uploaded[width]):
            np.testing.assert_array_equal(row.view(np.uint64), want_row.view(np.uint64))
    routed = {i for members in gathered.values() for i, _ in members}
    assert routed == ({0, 3, 5} if staged else set())


def test_estimate_of_an_int8_capture_converts_no_whole_capture(monkeypatch):
    """estimate() of an int8 capture never converts the whole capture to
    complex64 on the host, and gives urh_tpu's estimate."""
    iq = _int8(_capture("OOK", 3))

    def whole(self):
        raise AssertionError("the whole capture converted to complex64")

    monkeypatch.setattr(IQData, "as_complex64", whole)
    monkeypatch.setattr(IQData, "as_complex64_view", whole)
    _assert_same_estimate(est.estimate(iq, device="cpu"), urh_tpu.estimate(iq))


@pytest.mark.parametrize("cap", [2, est._MAX_CLASSIFIED_MESSAGES])
def test_screened_samples_count_the_classified_segments(cap, monkeypatch):
    """classify.screened_samples: the samples of the segments classified
    (the first _MAX_CLASSIFIED_MESSAGES), one update an estimate."""
    iq = _int8(_capture("ASK", 2))
    mags = IQData(iq).magnitudes
    segments = segmentation.segment_messages_from_magnitudes(
        mags, segmentation.detect_noise_level(mags))
    assert len(segments) == 5
    monkeypatch.setattr(est, "_MAX_CLASSIFIED_MESSAGES", cap)
    metrics = urh_tpu_torch.util.metrics.metrics
    metrics.clear()
    assert est.estimate(iq, device="cpu")["modulation_type"] == "ASK"
    assert metrics.counters()["classify.screened_samples"] == sum(
        end - start for start, end in segments[:cap]) < len(iq)
    assert metrics.report()["estimate.classify"]["calls"] == 1


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


# -- the batched scan ------------------------------------------------------------

# the benchmark generator's configurations at a test size (PSK: 2^17 samples,
# five-octet frames; its rect comes from the plain Costas loop)
SCAN_CAPTURES = {
    "FSK float32": ("wmbus_t1_hackrf_5msps", 1 << 20, None),
    "OOK int8": ("ook_ev1527_rtlsdr", 1 << 20, None),
    "PSK int8": ("ieee802154_bpsk868_hackrf", 1 << 17, "PSK"),
}


def _bench_capture(config: str, n: int) -> np.ndarray:
    from benchmark import registry
    from benchmark.gen import ieee802154, signals

    cfg = registry.config(registry.benchmark(), config)
    seed = [2**31 + 23, 0]
    if config == "ieee802154_bpsk868_hackrf":
        return ieee802154.capture(cfg, seed, n, 5, layout=0)[0]
    return signals.capture(cfg, seed, n, layout=0)[0]


def _per_message(rect, segments, scan) -> list:
    return [scan(rect[start:end]) for start, end in segments]


@pytest.mark.parametrize("name", sorted(SCAN_CAPTURES))
def test_batched_scan_equals_the_per_message_loop_and_urh_tpu(name, monkeypatch):
    """estimate()'s scan of the benchmark's captures: every message's
    (center, bit length, tolerance) as the per-message loop and urh_tpu's
    loop give it on the same rect, one histogram call for all centers, and
    urh_tpu's estimate."""
    config, n, modulation = SCAN_CAPTURES[name]
    x = _bench_capture(config, n)
    assert x.dtype == (np.float32 if name.startswith("FSK") else np.int8)
    seen = {}
    centers = est.detect_centers

    def spy(rect, segments, **kwargs):
        seen.update(rect=rect, segments=list(segments))
        return centers(rect, segments, **kwargs)

    monkeypatch.setattr(est, "detect_centers", spy)
    urh_tpu_torch.util.metrics.metrics.clear()
    got = est.estimate(x, modulation=modulation, device="cpu")
    counts = urh_tpu_torch.util.metrics.metrics.counters()
    rect, segments = seen["rect"], seen["segments"]
    assert counts["scan.messages"] == len(segments) >= 2
    assert counts["scan.histogram_calls"] == 1

    batched = est.scan_messages(rect, segments, device="cpu")
    assert batched == _per_message(rect, segments,
                                   lambda r: est._message_parameters(r, device="cpu"))
    assert batched == _per_message(rect, segments, jax_estimate._message_parameters)
    assert sum(c is not None for c, _, _ in batched) >= 2

    want = urh_tpu.estimate(x, modulation=modulation)
    for key in ("modulation_type", "bit_length", "tolerance", "noise"):
        assert got[key] == want[key], (key, got, want)
    atol = PSK_CENTER_ATOL if modulation == "PSK" else CENTER_ATOL
    assert abs(got["center"] - want["center"]) <= atol, (got, want)


def _levels(levels, lengths, seed=0, noise=0.01) -> np.ndarray:
    """A rectangular signal: levels[i % len(levels)] for lengths[i] samples,
    plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    rect = np.repeat([levels[i % len(levels)] for i in range(len(lengths))], lengths)
    return (rect + rng.normal(0, noise, len(rect))).astype(np.float32)


# messages that take each branch of the scan, each scanned beside two
# ordinary ones; the plateau lengths (runs of the rect) sit where the
# rounding's digit count or its halves of the unit change
SCAN_EDGE_CASES = {
    "constant": np.full(800, 0.3, np.float32),
    "all noise sentinel": np.full(800, -5.0, np.float32),
    "one plateau": _levels([-0.5, 0.5], [400, 600]),
    "tolerance 0": _levels([-0.5, 0.5], [100, 200, 100, 300, 100, 100, 200, 100] * 3),
    "glitches merged": _levels([-0.5, 0.5], [100, 2, 98, 200, 1, 99, 100, 300, 2, 198] * 3),
    "digits 9/10": _levels([-0.5, 0.5], [9, 10, 9, 10, 10, 9, 18, 20, 9] * 12),
    "digits 99/100": _levels([-0.5, 0.5], [99, 100, 99, 100, 100, 99, 198, 200, 99] * 4),
    "digits 999/1000": _levels([-0.5, 0.5], [999, 1000, 999, 1000, 1000, 999, 1998] * 2),
    "halves of 10": _levels([-0.5, 0.5], [15, 25, 35, 45, 15, 25, 35, 45, 55] * 8),
    "halves of 100": _levels([-0.5, 0.5], [150, 250, 350, 150, 250, 450, 150] * 3),
    "halves at 4 digits": _levels([-0.5, 0.5], [1050, 1150, 1250, 1050, 2150, 1250] * 2),
    "tied peaks": _levels([-0.5, 0.0, 0.5], [100] * 30, noise=0.0),
}


@pytest.mark.parametrize("case", sorted(SCAN_EDGE_CASES))
def test_batched_scan_edge_cases(case):
    """The odd message and two ordinary ones in one batch: the same
    (center, bit length, tolerance) as the port's per-message loop and
    urh_tpu's, message by message."""
    ordinary = [_levels([-0.5, 0.5], [100, 200, 100, 100, 300] * 5, seed=s) for s in (1, 2)]
    messages = [ordinary[0], SCAN_EDGE_CASES[case], ordinary[1]]
    gap = np.full(50, -5.0, np.float32)  # the noise sentinel between messages
    rect = np.concatenate([part for m in messages for part in (gap, m)])
    segments, at = [], 0
    for m in messages:
        segments.append((at + len(gap), at + len(gap) + len(m)))
        at += len(gap) + len(m)
    batched = est.scan_messages(rect, segments, device="cpu")
    assert batched == _per_message(rect, segments,
                                   lambda r: est._message_parameters(r, device="cpu"))
    assert batched == _per_message(rect, segments, jax_estimate._message_parameters)
    center, bit_length, tolerance = batched[1]
    if case in ("constant", "all noise sentinel"):
        assert batched[1] == (None, None, None)
        assert est.detect_center(SCAN_EDGE_CASES[case], device="cpu") is None
    elif case == "one plateau":
        assert batched[1] == (None, None, None)
        assert est.detect_center(SCAN_EDGE_CASES[case], device="cpu") is not None
    elif case == "tolerance 0":
        assert tolerance == 0 and bit_length == 100
    elif case == "glitches merged":
        assert tolerance >= 1 and bit_length == 100
    elif case == "tied peaks":
        counts = ai_device.histogram(*_center_histogram_inputs(SCAN_EDGE_CASES[case]),
                                     device="cpu")
        assert (counts == counts.max()).sum() >= 2
    else:
        assert center is not None


def _center_histogram_inputs(rect):
    """The values and edges detect_center counts."""
    rect = rect[rect > -4]
    rect = rect[int(0.05 * len(rect)) : int(0.95 * len(rect))]
    step = float(np.var(rect))
    return rect, np.arange(float(np.min(rect)), float(np.max(rect)) + step, step)


def test_batched_scan_bins_one_large_message_in_float32(monkeypatch):
    """With HISTOGRAM_MIN_VALUES lowered below one message's size and above
    the others', the batch bins that message by urh_tpu's float32 rule and
    the others by np.histogram's, as each message scanned alone does."""
    messages = [_levels([-0.5, 0.5], [100, 200, 100, 100, 300] * k, seed=k) for k in (2, 6, 3)]
    rect = np.concatenate(messages)
    bounds = np.cumsum([0] + [len(m) for m in messages])
    segments = list(zip(bounds[:-1], bounds[1:]))
    monkeypatch.setattr(ai_device, "HISTOGRAM_MIN_VALUES", 4000)
    values = [_center_histogram_inputs(m) for m in messages]
    assert [len(v) >= 4000 for v, _ in values] == [False, True, False]
    np.testing.assert_array_equal(_histograms(*map(list, zip(*values)))[1],
                                  _device_binning(*values[1]))
    batched = est.scan_messages(rect, segments, device="cpu")
    assert batched == _per_message(rect, segments,
                                   lambda r: est._message_parameters(r, device="cpu"))
    assert all(c is not None for c, _, _ in batched)


ROUNDING_CASES = {
    "digit boundaries": [9, 10, 99, 100, 999, 1000, 9999, 10000],
    "one digit": [1, 5, 9, 3],
    "two and one digits, even count": [9, 10, 9, 10],
    "halves of 10": [15, 25, 35, 45, 105, 115],
    "halves of 100": [150, 250, 350, 1050, 1150],
    "halves at 4 digits": [1050, 1150, 1250, 2150],
    "zero": [0, 0, 10, 20],
    "long": [10**18, 10**19 - 1, 10**19, 5 * 10**18],
    "seeded": list(np.random.default_rng(8).integers(1, 5000, 301)),
}


@pytest.mark.parametrize("case", sorted(ROUNDING_CASES))
def test_round_plateau_lengths_equals_urh_tpu(case):
    """The digit count by comparison, the median over it and np.rint give
    urh_tpu's len(str(p)), np.percentile and round, on a uint64 array (in
    place) and on a list of ints."""
    lengths = np.array(ROUNDING_CASES[case], dtype=np.uint64)
    got, want = lengths.copy(), lengths.copy()
    est.round_plateau_lengths(got)
    jax_estimate.round_plateau_lengths(want)
    np.testing.assert_array_equal(got, want)
    as_list = [int(p) for p in lengths]
    want_list = list(as_list)
    est.round_plateau_lengths(as_list)
    jax_estimate.round_plateau_lengths(want_list)
    assert as_list == want_list and all(type(p) is int for p in as_list)


BIT_LENGTH_CASES = {
    "one divisor": [100, 200, 100, 300, 100, 400, 200],
    "near multiples": [99, 201, 298, 102, 150, 49],
    "no vote": [3, 5, 7],  # every vote 0: np.argsort's order throughout
    "tied top votes": [3, 3, 5, 5, 7, 7],
    "tied below the top": [50, 50, 50, 100, 150, 250, 350],
    "glitch-sized": [1, 2, 3, 1, 2, 40, 80],
    "EV1527 periods": [700, 2100, 700, 2100, 21700, 1400, 700],
    "seeded": [int(x) for x in np.random.default_rng(9).integers(1, 2000, 60)],
}


@pytest.mark.parametrize("case", sorted(BIT_LENGTH_CASES))
def test_bit_length_vote_equals_urh_tpu(case):
    """The vote over the divisor histogram, walked in np.argsort's order only
    where votes tie, gives urh_tpu's bit length."""
    lengths = BIT_LENGTH_CASES[case]
    assert (est.get_bit_length_from_plateau_lengths(list(lengths))
            == jax_estimate.get_bit_length_from_plateau_lengths(list(lengths)))


@pytest.mark.parametrize("max_size", [None, 700])
def test_detect_centers_read_a_resident_rect(max_size):
    """detect_centers with the rect resident on a device (the CPU here, the
    card in estimate()): each message's values selected there, sentinels
    inside a message and max_size included, give the centers of the host's
    own selection and of urh_tpu's detect_center, message by message."""
    messages = [_levels([-0.5, 0.5], [100, 200, 100, 100, 300] * 3, seed=s) for s in range(4)]
    messages[1][200:260] = -5.0  # a pause inside a message
    messages[2][:3] = -4.0  # sentinels at its start only: a view on the host
    gap = np.full(40, -5.0, np.float32)
    rect = np.concatenate([part for m in messages for part in (gap, m)])
    segments, at = [], 0
    for m in messages:
        segments.append((at + len(gap), at + len(gap) + len(m)))
        at += len(gap) + len(m)
    resident = est.detect_centers(rect, segments, max_size=max_size, device="cpu",
                                  resident=torch.from_numpy(rect))
    assert resident == est.detect_centers(rect, segments, max_size=max_size, device="cpu")
    assert resident == [jax_estimate.detect_center(rect[s:e], max_size=max_size)
                        for s, e in segments]
    assert all(c is not None for c in resident)


def test_bit_lengths_of_a_batch_equal_urh_tpu():
    """bit_lengths over every case at once: the batched rounding, divisor
    votes and walks give urh_tpu's bit length message by message."""
    merged = [BIT_LENGTH_CASES[case] for case in sorted(BIT_LENGTH_CASES)]
    assert est.bit_lengths(merged) == [jax_estimate.get_bit_length_from_plateau_lengths(list(m))
                                       for m in merged]


TOLERANCE_CASES = {
    "no glitch": [100, 200, 100, 300, 100],
    "near multiples": [99, 201, 298, 102],
    "glitches": [100, 2, 98, 200, 1, 99, 100, 300, 2, 198],
    "an outlier dropped": [1, 2, 50, 51, 49, 50, 52, 48, 50, 5000],
    "all equal": [7, 7, 7],
    "one length": [42],
    "floats": [50.0, 50.0, 150.0, 3.0, 47.0, 100.0],
    "seeded": [int(x) for x in np.random.default_rng(12).integers(1, 400, 80)],
}


@pytest.mark.parametrize("margin", [None, 1.0], ids=["batched", "numpy_test"])
def test_tolerances_equal_urh_tpu(margin, monkeypatch):
    """tolerances over every case at once, with the outlier test batched, and
    with a margin so wide that every message takes NumPy's own test: urh_tpu's
    tolerance message by message (None for a single length)."""
    if margin is not None:
        monkeypatch.setattr(est, "_Z_MARGIN", margin)
    plateaus = [np.array(TOLERANCE_CASES[case]) for case in sorted(TOLERANCE_CASES)]
    want = [jax_estimate.estimate_tolerance_from_plateau_lengths(p) for p in plateaus]
    assert est.tolerances(plateaus) == want
    assert [est.estimate_tolerance_from_plateau_lengths(p) for p in plateaus] == want
