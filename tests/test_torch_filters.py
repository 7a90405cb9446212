"""Filters (FIR, IIR, design) and Signal.filter_range against urh_tpu's.

The same seeded inputs go through urh_tpu.dsp.filters (JAX on the CPU)
and urh_tpu_torch.dsp.filters (torch's CPU ops and B8's plain loop).
Tolerances:

* FIR: atol 1e-3 on inputs of unit scale, 1e-2 on the 50,000-sample
  overlap-save route (tests/test_filters_spectrogram.py:27, :36): torch.fft
  and XLA's FFT round differently;
* IIR and B8's plain loop against urh_tpu's _iir_feedback: atol 1e-4
  (tests/test_filters_spectrogram.py:87; XLA promises no order for the
  feedback sum, the port fixes one);
* filter design, moving average and DC correction on the host: exact;
* filter_range: float32 samples within 1e-4, int8 samples within 1 LSB
  (the float-to-int8 cast truncates, and a value on an integer boundary may
  fall either way), qad within 1e-5 where the samples agree (atan2 rounds
  differently), the same messages.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import urh_tpu
from urh_tpu.dsp import filters as jax_filters
from urh_tpu_torch.core.signal import Signal
from urh_tpu_torch.dsp import filters
from urh_tpu_torch.dsp import iir_kernels
from urh_tpu_torch.dsp.filters import Filter, FilterType
from urh_tpu_torch.protocol.analyzer import demodulate

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIR_ATOL = 1e-3
FIR_LONG_ATOL = 1e-2
IIR_ATOL = 1e-4
SAMPLE_ATOL = 1e-4
QAD_ATOL = 1e-5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT,
                                                                            "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _complex(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


@pytest.mark.parametrize("n,m", [(200, 9), (4095, 31), (5000, 31), (50_000, 31), (64, 64),
                                 (40, 100), (6000, 3000), (1, 1)],
                         ids=["short", "below-4096", "block", "overlap-save", "m=n", "m>n",
                              "block>=n", "one"])
def test_fir_filter_equals_urh_tpu_on_both_routes(n, m):
    x = _complex(n, seed=n)
    h = _complex(m, seed=m + 1)
    got = filters.fir_filter(x, h, device="cpu")
    want = jax_filters.fir_filter(x, h)
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FIR_LONG_ATOL if n >= 50_000 else FIR_ATOL)


def test_fir_filter_of_nothing():
    assert filters.fir_filter(np.zeros(0, np.complex64), np.ones(3), device="cpu").shape == (0,)


def test_moving_average_and_dc_correction_equal_urh_tpu():
    x = _complex(300, seed=4)
    avg, jax_avg = Filter([0.1] * 10, FilterType.moving_average), \
        jax_filters.Filter([0.1] * 10, jax_filters.FilterType.moving_average)
    np.testing.assert_allclose(avg.work(x, device="cpu"), jax_avg.work(x), atol=FIR_ATOL)
    iq = np.random.default_rng(5).normal(size=(50, 2)).astype(np.float32) + 3.0
    np.testing.assert_array_equal(Filter([], FilterType.dc_correction).work(iq),
                                  jax_filters.Filter([], jax_filters.FilterType.dc_correction)
                                  .work(iq))


@pytest.mark.parametrize("real", [True, False])
def test_fft_convolve_1d_equals_urh_tpu(real):
    rng = np.random.default_rng(6)
    x = rng.normal(size=1000).astype(np.float32)
    h = rng.normal(size=51).astype(np.float32)
    if not real:
        x = x + 1j * rng.normal(size=1000).astype(np.float32)
    got = Filter.fft_convolve_1d(x, h, device="cpu")
    want = jax_filters.Filter.fft_convolve_1d(x, h)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FIR_ATOL)


# np.convolve below 4 ln(n) taps (11 taps at bw 0.42), the FFT above (51 at 0.08)
@pytest.mark.parametrize("n,bw", [(50, 0.42), (20_000, 0.08)], ids=["np.convolve", "fft"])
def test_apply_bandpass_filter_equals_urh_tpu_on_both_branches(n, bw):
    x = _complex(n, seed=7)
    got = Filter.apply_bandpass_filter(x, 0.3, 0.1, filter_bw=bw, device="cpu")
    want = jax_filters.Filter.apply_bandpass_filter(x, 0.3, 0.1, filter_bw=bw)
    assert got.shape == want.shape
    if bw == 0.42:  # the host branch: the same NumPy code
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, atol=FIR_ATOL)


@pytest.mark.parametrize("bw", [0.001, 0.01, 0.08, 0.1, 0.42])
def test_filter_design_equals_urh_tpu(bw):
    np.testing.assert_array_equal(Filter.design_windowed_sinc_lpf(0.1, bw),
                                  jax_filters.Filter.design_windowed_sinc_lpf(0.1, bw))
    np.testing.assert_array_equal(Filter.design_windowed_sinc_bandpass(-0.05, 0.2, bw),
                                  jax_filters.Filter.design_windowed_sinc_bandpass(-0.05, 0.2,
                                                                                   bw))
    assert (Filter.get_filter_length_from_bandwidth(bw)
            == jax_filters.Filter.get_filter_length_from_bandwidth(bw))
    assert Filter.get_bandwidth_from_filter_length(51) == 4 / 51


def test_configured_bandwidth_reads_the_settings_store(monkeypatch):
    from urh_tpu_torch.util import settings

    monkeypatch.setattr(settings, "_store", {"bandpass_filter_bw_type": "Wide"})
    assert Filter.read_configured_filter_bw() == 0.1
    monkeypatch.setattr(settings, "_store", {"bandpass_filter_bw_type": "custom",
                                             "bandpass_filter_custom_bw": "0.2"})
    assert Filter.read_configured_filter_bw() == 0.2
    monkeypatch.setattr(settings, "_store", {})
    assert Filter.read_configured_filter_bw() == 0.08


# (feed-forward a, feedback b): N = 1, 2, 5 feedback taps, stable
IIR_CASES = {
    "N=1 (DC blocker)": ([1.0, -1.0], [0.995]),
    "N=2": ([0.2, 0.3, 0.1], [0.5, -0.25]),
    "N=5": ([0.5, 0.25], [0.3, -0.2, 0.1, 0.05, -0.02]),
    "N=9": ([1.0], [0.1, -0.05, 0.04, 0.03, -0.02, 0.02, 0.01, -0.01, 0.005]),
}


@pytest.mark.parametrize("case", sorted(IIR_CASES))
def test_iir_filter_equals_urh_tpu(case):
    a, b = IIR_CASES[case]
    x = _complex(600, seed=len(b) + 10)
    got = filters.iir_filter(a, b, x, device="cpu")
    want = jax_filters.iir_filter(a, b, x)
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=IIR_ATOL)
    start = max(len(a), len(b) + 1)
    assert not got[:start].any() and got[start:].any()


def test_iir_filter_without_feedback_taps_is_the_feed_forward_sum():
    """urh_tpu's scan cannot take an empty carry (TypeError, ROADMAP.md §C);
    the port's feedback adds +0 to every feed-forward sum."""
    x = _complex(100, seed=9)
    got = filters.iir_filter([1.0, 0.5], [], x, device="cpu")
    want = np.zeros_like(x)
    want[2:] = x[2:] + 0.5 * x[1:-1]
    np.testing.assert_allclose(got, want, atol=1e-6)
    with pytest.raises(TypeError):
        jax_filters.iir_filter([1.0, 0.5], [], x)


def test_iir_filter_shorter_than_its_start_is_zero():
    assert not filters.iir_filter([1.0, 1.0], [0.5, 0.5], _complex(3, 1), device="cpu").any()


@pytest.mark.parametrize("n_taps", [1, 2, 5, 9])
def test_iir_plain_loop_equals_urh_tpu_feedback(n_taps):
    import jax.numpy as jnp

    rng = np.random.default_rng(n_taps)
    ff = _complex(500, seed=n_taps + 20)
    b_rev = (rng.uniform(-0.4, 0.4, n_taps) / n_taps).astype(np.float32)
    _, want = jax_filters._iir_feedback(jnp.asarray(ff), jnp.asarray(b_rev))
    got = iir_kernels.iir_feedback(torch.from_numpy(ff.view(np.float32).reshape(-1, 2)),
                                   torch.from_numpy(b_rev))
    np.testing.assert_allclose(got.numpy().reshape(-1).view(np.complex64), np.asarray(want),
                               atol=IIR_ATOL)


def test_iir_plain_loop_outputs_depend_on_earlier_samples_only():
    """The first n outputs over a stream are those over its first n samples,
    to the bit (chip_smoke.py checks B8's launches at each n against one
    plain run)."""
    b_rev = torch.tensor([0.1, -0.2, 0.3], dtype=torch.float32)
    x = torch.from_numpy(_complex(37, seed=2).view(np.float32).reshape(-1, 2))
    whole = iir_kernels.iir_feedback_plain(x, b_rev)
    for n in (1, 4, 5, 36):
        assert torch.equal(whole[:n].view(torch.int32),
                           iir_kernels.iir_feedback_plain(x[:n].clone(), b_rev).view(torch.int32))


def test_iir_feedback_rejects_what_the_kernel_does_not_take():
    ff = torch.zeros((10, 2), dtype=torch.float32)
    with pytest.raises(ValueError):
        iir_kernels.iir_feedback(ff[:, :1], torch.zeros(2))
    with pytest.raises(ValueError):
        iir_kernels.iir_feedback(ff, torch.zeros(2, dtype=torch.float64))
    with pytest.raises(TypeError):
        iir_kernels.iir_feedback(ff.double(), torch.zeros(2))


BANDPASS = dict(f_low=-0.05, f_high=0.05, bw=0.08)


def _filter_range_case(dtype):
    """(port Signal, urh_tpu Signal) of a 5-message FSK capture with the
    demodulation parameters set and qad cached."""
    cs = _chip_smoke()
    iq, _ = cs.make_capture("FSK", 1 << 16, seed=3, n_bits=64, pause=5000)
    if dtype == np.int8:
        iq = cs.to_int8(iq)
    params = cs.demod_params("FSK", iq.dtype)
    sig = Signal.from_iq(iq.copy(), device="cpu")
    sig.params = params
    ref = urh_tpu.Signal.from_iq(iq.copy())
    ref.params = urh_tpu.DemodParams(**vars(params))
    sig.qad, ref.qad  # cache qad on both
    return sig, ref


@pytest.mark.parametrize("dtype", [np.float32, np.int8], ids=["float32", "int8"])
def test_filter_range_equals_urh_tpu(dtype):
    sig, ref = _filter_range_case(dtype)
    taps = Filter.design_windowed_sinc_bandpass(BANDPASS["f_low"], BANDPASS["f_high"],
                                                BANDPASS["bw"])
    start, end = 1000, sig.num_samples - 777
    before = sig.iq_array.data.copy()
    sig.filter_range(start, end, Filter(taps))
    ref.filter_range(start, end, jax_filters.Filter(taps))

    got, want = sig.iq_array.data, ref.iq_array.data
    np.testing.assert_array_equal(got[:start], before[:start])
    np.testing.assert_array_equal(got[end:], before[end:])
    assert not np.array_equal(got[start:end], before[start:end])
    if dtype == np.int8:
        assert np.abs(got.astype(np.int16) - want).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=SAMPLE_ATOL)

    qad, ref_qad = sig._qad.numpy(), np.asarray(ref._qad)
    same = (got == want).all(axis=1)
    same[1:] &= same[:-1]  # the discriminator reads the sample before too
    np.testing.assert_allclose(qad[same], ref_qad[same], atol=QAD_ATOL)
    assert sig.qad_states is None  # the kernels' states no longer match

    got_bits = [m.plain_bits_str for m in demodulate(sig)]
    want_bits = [m.plain_bits_str for m in urh_tpu.demodulate(ref)]
    assert len(got_bits) == 5 and got_bits == want_bits


def test_filter_range_without_cached_qad_demodulates_the_filtered_capture():
    """With no qad cached the next demodulation runs the fused kernel's
    plain version on the filtered samples and gives urh_tpu's messages."""
    sig, ref = _filter_range_case(np.float32)
    sig._qad, ref._qad = None, None
    taps = Filter.design_windowed_sinc_bandpass(BANDPASS["f_low"], BANDPASS["f_high"],
                                                BANDPASS["bw"])
    sig.filter_range(0, sig.num_samples, Filter(taps))
    ref.filter_range(0, ref.num_samples, jax_filters.Filter(taps))
    assert sig._qad is None
    got_bits = [m.plain_bits_str for m in demodulate(sig)]
    assert sig.qad_states is not None
    assert got_bits == [m.plain_bits_str for m in urh_tpu.demodulate(ref)]
