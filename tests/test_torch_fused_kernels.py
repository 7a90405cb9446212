"""The four fused demod kernels of urh_tpu_torch against urh_tpu's Pallas ones.

On the CPU each wrapper of urh_tpu_torch.dsp.fused_kernels runs its plain
PyTorch version; urh_tpu's Pallas kernels run in interpret mode.  Both are
also held against urh_tpu's afp_demod + symbol_states.  Tolerances are
those of tests/test_pallas_kernels.py: qad atol 1e-6 (atan2 implementations
differ by an ulp or two), states exact.  The CUDA kernels themselves are
checked against the same plain versions on the card by chip_smoke.py.
"""

import math

import numpy as np
import pytest
import torch

from urh_tpu.dsp import pallas_kernels as pk
from urh_tpu.dsp.demod import afp_demod, noise_sentinel
from urh_tpu.dsp.symbols import symbol_states
from urh_tpu_torch.dsp import fused_kernels as fk

torch.set_num_threads(1)

SIZES = [1000, 65536 + 129]
MAX_I8 = math.sqrt(127 * 127 + 128 * 128)


def _f32_capture(n, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    samples = rng.normal(0, scale, (n, 2)).astype(np.float32)
    samples[100:300] *= 0.001  # silent stretch -> gated
    return samples


def _i8_capture(n, seed):
    rng = np.random.default_rng(seed)
    samples = rng.normal(0, 40, (n, 2)).clip(-128, 127).astype(np.int8)
    samples[100:300] = 0  # silent stretch -> gated
    return samples


def _reference(samples, noise, mod, threshold):
    qad = afp_demod(samples, noise, mod, 2)
    return qad, symbol_states(qad, np.float32([threshold]), noise_sentinel(mod))


@pytest.mark.parametrize("threshold", [0.0, 0.3])
@pytest.mark.parametrize("n", SIZES)
def test_fsk_f32_matches_pallas_and_reference(n, threshold):
    samples = _f32_capture(n, 3)
    qad, states = fk.fsk_demod_symbolize(samples, 0.1, threshold, device="cpu")
    assert qad.dtype == torch.float32 and states.dtype == torch.int32
    p_qad, p_states = pk.fsk_demod_symbolize(samples, 0.1, threshold, interpret=True)
    r_qad, r_states = _reference(samples, 0.1, "FSK", threshold)
    for want_qad, want_states in ((p_qad, p_states), (r_qad, r_states)):
        np.testing.assert_allclose(qad.numpy(), want_qad, atol=1e-6)
        np.testing.assert_array_equal(states.numpy(), want_states)


@pytest.mark.parametrize("threshold", [0.0, -0.4])
@pytest.mark.parametrize("n", SIZES)
def test_fsk_i8_matches_pallas_and_reference(n, threshold):
    samples = _i8_capture(n, 7)
    states = fk.fsk_symbolize_i8(samples, 10.0, threshold, device="cpu")
    assert states.dtype == torch.int8
    np.testing.assert_array_equal(
        states.numpy(), pk.fsk_symbolize_i8(samples, 10.0, threshold, interpret=True))
    np.testing.assert_array_equal(states.numpy(),
                                  _reference(samples, 10.0, "FSK", threshold)[1])
    # the comparison kernel decides as the float32 kernel does
    _, f32_states = fk.fsk_demod_symbolize(samples, 10.0, threshold, device="cpu")
    np.testing.assert_array_equal(states.numpy(), f32_states.numpy())


@pytest.mark.parametrize("n", SIZES)
def test_ask_f32_matches_pallas_and_reference(n):
    samples = _f32_capture(n, 5, scale=0.4)
    qad, states = fk.ask_demod_symbolize(samples, 0.1, 0.3, math.sqrt(2), device="cpu")
    p_qad, p_states = pk.ask_demod_symbolize(samples, 0.1, 0.3, math.sqrt(2),
                                             interpret=True)
    r_qad, r_states = _reference(samples, 0.1, "ASK", 0.3)
    for want_qad, want_states in ((p_qad, p_states), (r_qad, r_states)):
        np.testing.assert_allclose(qad.numpy(), want_qad, atol=1e-6)
        np.testing.assert_array_equal(states.numpy(), want_states)


@pytest.mark.parametrize("n", SIZES)
def test_ask_i8_matches_pallas_and_reference(n):
    samples = _i8_capture(n, 9)
    states = fk.ask_symbolize_i8(samples, 10.0, 0.3, MAX_I8, device="cpu")
    assert states.dtype == torch.int8
    np.testing.assert_array_equal(
        states.numpy(), pk.ask_symbolize_i8(samples, 10.0, 0.3, MAX_I8, interpret=True))
    np.testing.assert_array_equal(states.numpy(),
                                  _reference(samples, 10.0, "ASK", 0.3)[1])


def _all_pairs_i8():
    """Every int8 (I, Q) pair once, after a copy of the first (sample 0 is
    forced to -1)."""
    v = np.arange(-128, 128, dtype=np.int8)
    pairs = np.stack(np.meshgrid(v, v, indexing="ij"), -1).reshape(-1, 2)
    return np.concatenate((pairs[:1], pairs))


def _ask_i8_by_decision(samples, noise_mag, threshold, max_mag):
    """K4's integer evaluation in torch: the wrapper's decision integers
    applied to I^2 + Q^2, as the CUDA kernel applies them."""
    gate_below, cutoff, above = fk.ask_i8_decision(fk._noise_sqrd(noise_mag), threshold,
                                                   max_mag)
    x = torch.from_numpy(samples).to(torch.int32)
    mag2 = x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]
    states = torch.where(mag2 >= cutoff, above, 1 - above)
    states = states.masked_fill(mag2 < gate_below, -1).to(torch.int8)
    states[:1] = -1
    return states


@pytest.mark.parametrize("threshold", [-0.3, 0.0, 0.3, 0.9999, 1.0, 1.5])
@pytest.mark.parametrize("max_mag", [MAX_I8, 1.0, 0.0, -1.0])
@pytest.mark.parametrize("noise_mag", [0.0, 10.0])
def test_ask_i8_decision_matches_pallas_over_all_pairs(noise_mag, max_mag, threshold):
    samples = _all_pairs_i8()
    states = _ask_i8_by_decision(samples, noise_mag, threshold, max_mag)
    np.testing.assert_array_equal(
        states.numpy(),
        pk.ask_symbolize_i8(samples, noise_mag, threshold, max_mag, interpret=True))


def test_int8_wrappers_copy_an_unaligned_view():
    buf = torch.from_numpy(_i8_capture(1001, 6)).clone()  # torch aligns to 64 B
    view = buf[1:]  # 2 bytes past a 16-byte aligned allocation
    assert buf.data_ptr() % 16 == 0 and view.data_ptr() % 16 == 2
    before = dict(fk.ALIGNMENT_COPIES)
    assert fk._aligned("ask_i8", buf) is buf
    copy = fk._aligned("ask_i8", view)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)
    assert fk.ALIGNMENT_COPIES == {**before, "ask_i8": before["ask_i8"] + 1}


@pytest.mark.parametrize("threshold", [math.pi / 2, -2.0])
def test_fsk_i8_rejects_wide_threshold_in_both_packages(threshold):
    samples = _i8_capture(1000, 1)
    with pytest.raises(ValueError):
        pk.fsk_symbolize_i8(samples, 10.0, threshold, interpret=True)
    with pytest.raises(ValueError):
        fk.fsk_symbolize_i8(samples, 10.0, threshold, device="cpu")


def test_wrappers_validate_input_and_count_only_launches():
    before = dict(fk.LAUNCHES)
    x = torch.from_numpy(_f32_capture(1000, 2))
    fk.fused_fsk_demod_symbolize(x, 0.01, 0.0)
    fk.fused_ask_symbolize_i8(x.to(torch.int8), 1.0, 0.3, MAX_I8)
    assert fk.LAUNCHES == before  # the plain versions are no launches
    with pytest.raises(TypeError):
        fk.fused_fsk_demod_symbolize(x.to(torch.float64), 0.01, 0.0)
    with pytest.raises(TypeError):
        fk.fused_fsk_symbolize_i8(x, 0.01, 0.0)
    with pytest.raises(ValueError):
        fk.fused_ask_demod_symbolize(x.reshape(-1, 4), 0.01, 0.3, 1.0)
    with pytest.raises(ValueError):
        fk.fused_ask_demod_symbolize(x.t().contiguous().t(), 0.01, 0.3, 1.0)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_tiny_inputs_keep_the_sample_zero_sentinel(n):
    samples = _f32_capture(1000, 4)[:n]
    qad, states = fk.fsk_demod_symbolize(samples, 0.01, 0.0, device="cpu")
    p_qad, p_states = pk.fsk_demod_symbolize(samples, 0.01, 0.0, interpret=True)
    np.testing.assert_allclose(qad.numpy(), p_qad, atol=1e-6)
    np.testing.assert_array_equal(states.numpy(), p_states)
    assert states[0] == -1 and qad[0] == -4.0
    empty = fk.fsk_symbolize_i8(samples[:0].astype(np.int8), 1.0, 0.0, device="cpu")
    assert empty.shape == (0,) and empty.dtype == torch.int8
