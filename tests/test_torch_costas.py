"""The Costas loop (B5) and offline PSK against urh_tpu's.

The plain loop (costa_demod_scan_plain, which the CPU path runs and the
CUDA kernel equals on the card) against urh_tpu's _costa_demod_scan on
the same PSK captures, orders 2 and 4, with gated stretches.  Tolerance:
qad atol 1e-4 and the final carry atol 1e-5.  XLA's float32 cos/sin on
the CPU are not torch's, and the loop feeds each rounding back into the
phase; on these captures the two stay within about 2e-6 of each other.
The pulse runs after grab_pulse_lens must be equal; a raw state may
differ only within one sample of a run boundary, and at most
MAX_EDGE_MISMATCHES times.  Within the port, chained chunks equal one
shot exactly.  Captures stay at or below 20k samples: the plain loop runs
sample by sample.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import urh_tpu
import urh_tpu_torch
from urh_tpu.dsp import symbols as jax_symbols
from urh_tpu.dsp.demod import DemodParams, _costa_demod_scan
from urh_tpu.dsp.modulate import modulate
from urh_tpu_torch.core.signal import signal_from_reference
from urh_tpu_torch.dsp import costas

torch.set_num_threads(1)

QAD_ATOL = 1e-4
CARRY_ATOL = 1e-5
MAX_EDGE_MISMATCHES = 4
NOISE = 0.1
ANGLES_4PSK = [math.pi * a / 180 for a in (-135, -45, 45, 135)]


def _capture(order, seed, n_bits=96, gate=(3000, 3600)):
    """A PSK capture from urh_tpu's modulator, Gaussian noise of sigma
    0.05 and a gated stretch (scaled below the noise threshold)."""
    rng = np.random.default_rng(seed)
    if order == 2:
        iq = modulate(rng.integers(0, 2, n_bits), 100, "psk", [0.0, np.pi], pause=1500)
    else:
        iq = modulate(rng.integers(0, 2, n_bits), 100, "psk", ANGLES_4PSK,
                      bits_per_symbol=2, pause=1500)
    iq = iq + rng.normal(0, 0.05, iq.shape)
    iq[gate[0]:gate[1]] *= 0.01
    return iq.astype(np.float32)


def _jax_scan(x, order, phase=1.5, freq=0.0):
    qad, phase, freq = _costa_demod_scan(
        jnp.asarray(x), jnp.float32(NOISE ** 2), jnp.float32(1.0), jnp.float32(0.0), order,
        jnp.float32(0.1), jnp.float32(math.sqrt(2.0) / 2.0), jnp.float32(phase),
        jnp.float32(freq))
    return np.asarray(qad), float(phase), float(freq)


def _plain(x, order, phase=1.5, freq=0.0):
    alpha, beta = costas.costas_alpha_beta(0.1)
    qad, phase, freq = costas.costa_demod_scan_plain(
        torch.from_numpy(x), float(np.float32(NOISE ** 2)), 1.0, 0.0, order, alpha, beta,
        torch.tensor(phase), torch.tensor(freq))
    return qad.numpy(), float(phase), float(freq)


def _edge_mismatches(got, want):
    """Positions where two state sequences differ; each must lie within
    one sample of a run boundary of ``want``."""
    bad = np.flatnonzero(got != want)
    boundary = np.flatnonzero(want[1:] != want[:-1])  # want[b] != want[b + 1]
    for i in bad:
        assert np.any((boundary >= i - 2) & (boundary <= i + 1)), f"state {i} off an edge"
    return len(bad)


def test_loop_gains_match_jax():
    d, bw = jnp.float32(math.sqrt(2.0) / 2.0), jnp.float32(0.1)
    denom = 1.0 + 2.0 * d * bw + bw * bw
    assert costas.costas_alpha_beta(0.1) == (float((4.0 * d * bw) / denom),
                                            float((4.0 * bw * bw) / denom))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("order", [2, 4])
def test_plain_loop_matches_jax(order, seed):
    x = _capture(order, seed)
    got, phase, freq = _plain(x, order)
    want, w_phase, w_freq = _jax_scan(x, order)
    np.testing.assert_allclose(got, want, atol=QAD_ATOL)
    assert abs(phase - w_phase) <= CARRY_ATOL and abs(freq - w_freq) <= CARRY_ATOL
    assert (got[3001:3599] == -4.0).all()  # the gated stretch

    bps = 1 if order == 2 else 2
    thresholds = jax_symbols.get_center_thresholds(0.0, 1.0, order)
    states = [np.asarray(jax_symbols.symbol_states(q, thresholds, -4.0)) for q in (got, want)]
    assert _edge_mismatches(*states) <= MAX_EDGE_MISMATCHES
    runs = [jax_symbols.grab_pulse_lens(q, 0.0, 5, "PSK", 100, bps, 1.0) for q in (got, want)]
    np.testing.assert_array_equal(*runs)


@pytest.mark.parametrize("order", [2, 4])
def test_carry_in_and_out_matches_jax(order):
    """A carry handed in (as a stream's later block gets it) and the one
    handed out."""
    x = _capture(order, seed=5)[:4000]
    got, phase, freq = _plain(x, order, phase=-6.2, freq=0.3)
    want, w_phase, w_freq = _jax_scan(x, order, phase=-6.2, freq=0.3)
    np.testing.assert_allclose(got, want, atol=QAD_ATOL)
    assert abs(phase - w_phase) <= CARRY_ATOL and abs(freq - w_freq) <= CARRY_ATOL


@pytest.mark.parametrize("order", [2, 4])
def test_chained_chunks_equal_one_shot(order):
    x = torch.from_numpy(_capture(order, seed=2)[:6000])
    one = costas.new_carry("cpu")
    whole = costas.costa_demod_scan(x, 0.01, 1.0, 0.0, order, 0.1, one)
    chained = costas.new_carry("cpu")
    cuts = [0, 1, 2, 700, 3001, 3599, 5999, 6000]
    parts = [costas.costa_demod_scan(x[a:b], 0.01, 1.0, 0.0, order, 0.1, chained)
             for a, b in zip(cuts, cuts[1:])]
    assert torch.equal(torch.cat(parts), whole)
    assert torch.equal(chained, one)
    assert not torch.equal(one, costas.new_carry("cpu"))  # the carry moved


@pytest.mark.parametrize("order", [2, 4])
def test_plain_loop_over_pieces_equals_one_stream(order):
    """The plain loop on (C, N, 2): C pieces of one stream stepped together,
    each from the carry the piece before ends on, give the one stream's qad
    (the check chip_smoke.py makes of the kernel at the main path's sizes)."""
    x = torch.from_numpy(_capture(order, seed=3)[:4800])  # the gated stretch in piece 3
    alpha, beta = costas.costas_alpha_beta(0.1)
    args = (float(np.float32(NOISE ** 2)), 1.0, 0.0, order, alpha, beta)
    whole, phase, freq = costas.costa_demod_scan_plain(x, *args, torch.tensor(1.5),
                                                       torch.tensor(0.0))
    pieces = x.reshape(4, 1200, 2)
    starts = [(torch.tensor(1.5), torch.tensor(0.0))]
    for piece in pieces[:-1]:
        starts.append(costas.costa_demod_scan_plain(piece, *args, *starts[-1])[1:])
    got, phases, freqs = costas.costa_demod_scan_plain(
        pieces, *args, torch.stack([p for p, _ in starts]), torch.stack([f for _, f in starts]))
    assert got.shape == (4, 1200)
    assert torch.equal(got.reshape(-1), whole)
    assert torch.equal(phases[-1], phase) and torch.equal(freqs[-1], freq)
    assert all(torch.equal(phases[k], starts[k + 1][0]) for k in range(3))


def test_wrapper_checks_its_inputs():
    x = torch.zeros((10, 2))
    with pytest.raises(ValueError, match="carry"):
        costas.costa_demod_scan(x, 0.0, 1.0, 0.0, 2, 0.1, torch.zeros(3))
    with pytest.raises(TypeError):
        costas.costa_demod_scan(x.double(), 0.0, 1.0, 0.0, 2, 0.1, costas.new_carry("cpu"))


def _messages(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.plain_bits_str == w.plain_bits_str
        assert g.pause == w.pause
        assert list(g.bit_sample_pos) == list(w.bit_sample_pos)


@pytest.mark.parametrize("order", [2, 4])
def test_offline_psk_demodulate_matches_jax(order):
    """demodulate() on PSK and 4-PSK (tests/test_demodulations.py:76-115
    are the model): the same messages as urh_tpu's, and the sent bits."""
    rng = np.random.default_rng(order)
    bits = rng.integers(0, 2, 64 if order == 2 else 96).astype(np.uint8)
    params = [0.0, np.pi] if order == 2 else ANGLES_4PSK
    bps = 1 if order == 2 else 2
    iq = modulate(bits, 100, "psk", params, bits_per_symbol=bps, pause=1000)
    iq = (iq + rng.normal(0, 0.02, iq.shape)).astype(np.float32)
    p = DemodParams(modulation="PSK", samples_per_symbol=100, center=0.0,
                    center_spacing=1.0, bits_per_symbol=bps, noise_threshold=NOISE,
                    tolerance=5)
    want = urh_tpu.demodulate(urh_tpu.Signal.from_iq(iq), p)
    got = urh_tpu_torch.demodulate(signal_from_reference(iq, vars(p), "cpu"))
    _messages(got, want)
    assert len(got[0].plain_bits) == len(bits)
