"""The offline slice end to end: urh_tpu_torch.demodulate against urh_tpu's.

Synthetic captures from urh_tpu's modulator (several messages with
pauses, light noise from a seeded numpy generator) go through both
packages on the CPU.  On the port's side that is the same routing as on
the card (fused kernels for binary ASK/FSK, afp_demod + symbol_states for
4-FSK), with each kernel's plain PyTorch version; urh_tpu takes its host
path.  Bits, pauses and bit sample positions must be equal; rssi and
timestamps agree to 1e-6 (float32 reductions in either package).
"""

import numpy as np
import pytest
import torch

import urh_tpu
import urh_tpu_torch
from urh_tpu.coding.crc import GenericCRC as JaxCRC
from urh_tpu.dsp.demod import DemodParams
from urh_tpu.dsp.modulate import modulate
from urh_tpu_torch.coding.crc import GenericCRC
from urh_tpu_torch.coding.encodings import DECODING_EDGE, Encoding
from urh_tpu_torch.core.signal import signal_from_reference
from urh_tpu_torch.dsp import fused_kernels as fk

torch.set_num_threads(1)

FSK = dict(mod="fsk", params=[-20e3, 20e3], bits_per_symbol=1)
FSK4 = dict(mod="fsk", params=[-30e3, -10e3, 10e3, 30e3], bits_per_symbol=2)
ASK = dict(mod="ask", params=[0.0, 1.0], bits_per_symbol=1)


def _capture(messages, kind, dtype, seed=0, sps=100, pause=3000):
    """[lead-in silence, message, pause]... with Gaussian noise (sigma 0.005
    of full scale); int8 captures are scaled by 100 and rounded."""
    parts = [np.zeros((500, 2), np.float32)]
    for bits in messages:
        parts.append(modulate(bits, sps, kind["mod"], kind["params"],
                              bits_per_symbol=kind["bits_per_symbol"], pause=pause))
    iq = np.concatenate(parts)
    iq += np.random.default_rng(seed).normal(0, 0.005, iq.shape).astype(np.float32)
    if dtype == np.int8:
        return np.clip(np.round(iq * 100), -128, 127).astype(np.int8)
    return iq


def _random_messages(seed, lengths, ends_with_one=False):
    rng = np.random.default_rng(seed)
    messages = [rng.integers(0, 2, n).astype(np.uint8) for n in lengths]
    for m in messages:
        m[0] = 1  # a leading zero of an ASK message would be silence
        if ends_with_one:
            m[-1] = 1
    return messages


def _both(iq, params: DemodParams):
    want = urh_tpu.demodulate(urh_tpu.Signal.from_iq(iq), params)
    got = urh_tpu_torch.demodulate(signal_from_reference(iq, vars(params), "cpu"))
    return got, want


def _assert_same_messages(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.plain_bits_str == w.plain_bits_str
        assert g.pause == w.pause
        assert list(g.bit_sample_pos) == list(w.bit_sample_pos)
        np.testing.assert_allclose(g.rssi, w.rssi, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g.timestamp, w.timestamp, rtol=1e-6, atol=1e-6)


def _noise(dtype):
    return 0.05 * (100 if dtype == np.int8 else 1)


DTYPES = pytest.mark.parametrize("dtype", [np.float32, np.int8],
                                 ids=["float32", "int8"])


@DTYPES
def test_fsk_matches_jax(dtype):
    messages = _random_messages(1, [64, 80, 48])
    iq = _capture(messages, FSK, dtype, seed=1)
    params = DemodParams(modulation="FSK", samples_per_symbol=100, center=0.0,
                         noise_threshold=_noise(dtype), tolerance=5)
    got, want = _both(iq, params)
    _assert_same_messages(got, want)
    assert [m.plain_bits_str for m in got] == ["".join(map(str, m)) for m in messages]


@DTYPES
def test_ask_with_message_length_divisor_matches_jax(dtype):
    # lengths that are no multiple of 8, each message ending in zero bits
    # that the ASK pause swallows and the divisor gives back
    messages = _random_messages(2, [61, 45, 70], ends_with_one=True)
    messages = [np.concatenate((m, [0, 0])).astype(np.uint8) for m in messages]
    iq = _capture(messages, ASK, dtype, seed=2)
    params = DemodParams(modulation="ASK", samples_per_symbol=100, center=0.3,
                         noise_threshold=_noise(dtype), tolerance=5,
                         message_length_divisor=8)
    got, want = _both(iq, params)
    _assert_same_messages(got, want)
    assert all(len(m.plain_bits) % 8 == 0 for m in got)


@DTYPES
def test_4fsk_matches_jax(dtype):
    messages = _random_messages(3, [64, 96])
    iq = _capture(messages, FSK4, dtype, seed=3)
    params = DemodParams(modulation="FSK", samples_per_symbol=100, center=0.0,
                         center_spacing=0.125, bits_per_symbol=2,
                         noise_threshold=_noise(dtype), tolerance=5)
    got, want = _both(iq, params)
    _assert_same_messages(got, want)
    assert [m.plain_bits_str for m in got] == ["".join(map(str, m)) for m in messages]


@pytest.mark.parametrize("dtype,center,kernel", [
    (np.float32, 0.0, "fused_fsk_demod_symbolize"),
    (np.int8, 0.0, "fused_fsk_symbolize_i8"),
    # |center| >= pi/2: the int8 comparison kernel does not apply
    (np.int8, 2.0, "fused_fsk_demod_symbolize"),
])
def test_demodulate_routes_binary_captures_through_the_fused_kernels(
        dtype, center, kernel, monkeypatch):
    """On the CPU the kernels' plain versions stand in for them; the route
    is the card's: int8 -> states-only kernel, float32 -> qad + states."""
    called = []
    for name in ("fused_fsk_demod_symbolize", "fused_fsk_symbolize_i8"):
        orig = getattr(fk, name)
        monkeypatch.setattr(fk, name, lambda *a, _o=orig, _n=name: called.append(_n) or _o(*a))
    iq = _capture(_random_messages(4, [40]), FSK, dtype, seed=4)
    params = DemodParams(modulation="FSK", center=center, noise_threshold=_noise(dtype))
    got = urh_tpu_torch.demodulate(iq, params, device="cpu")
    assert called == [kernel]
    _assert_same_messages(got, urh_tpu.demodulate(urh_tpu.Signal.from_iq(iq), params))


def test_manchester_decoding_matches_jax():
    manchester = Encoding(["Manchester I", DECODING_EDGE])
    data = _random_messages(5, [32, 40])
    encoded = [np.frombuffer(bytes(manchester.encode(d)), np.uint8) for d in data]
    iq = _capture(encoded, FSK, np.float32, seed=5)
    params = DemodParams(modulation="FSK", samples_per_symbol=100, center=0.0,
                         noise_threshold=0.05, tolerance=5)
    got, want = _both(iq, params)
    _assert_same_messages(got, want)
    for msg, sent in zip(got, data):
        msg.decoder = manchester
        assert msg.decoded_bits_str == "".join(map(str, sent))


def test_crc_over_demodulated_bits_matches_jax():
    crc, jax_crc = GenericCRC("16_ccitt"), JaxCRC("16_ccitt")
    data = _random_messages(6, [64, 72])
    framed = [np.concatenate((d, np.frombuffer(bytes(crc.crc(d)), np.uint8))) for d in data]
    for d in data:
        assert list(crc.crc(d)) == list(jax_crc.crc(d))
    iq = _capture(framed, FSK, np.int8, seed=6)
    params = DemodParams(modulation="FSK", samples_per_symbol=100, center=0.0,
                         noise_threshold=5.0, tolerance=5)
    got, want = _both(iq, params)
    _assert_same_messages(got, want)
    for msg in got:
        bits = np.frombuffer(bytes(msg.plain_bits), np.uint8)
        assert list(crc.crc(bits[:-16])) == bits[-16:].tolist()
