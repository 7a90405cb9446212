"""urh_tpu_torch's demodulation and symbol decision against urh_tpu's.

afp_demod (ASK, FSK) in all five ingest dtypes: qad atol 1e-6 (atan2
implementations differ by an ulp or two); PSK and OQPSK on float32.  symbol_states and the pulse
machine (grab_pulse_lens): exact.
"""

import numpy as np
import pytest
import torch

from urh_tpu.dsp import demod as jax_demod
from urh_tpu.dsp import symbols as jax_symbols
from urh_tpu.dsp.modulate import modulate
from urh_tpu_torch.dsp import demod, symbols

torch.set_num_threads(1)

# dtype -> (center, spread) of the synthetic raw samples, and a noise
# threshold in raw units that gates part of them
DTYPES = {
    np.int8: (0.0, 40.0, 12.0),
    np.uint8: (128.0, 40.0, 170.0),
    np.int16: (0.0, 8000.0, 2500.0),
    np.uint16: (32768.0, 8000.0, 45000.0),
    np.float32: (0.0, 0.5, 0.15),
}


def _capture(dtype, n, seed):
    center, spread, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    x = rng.normal(center, spread, (n, 2))
    x[100:300] = center + (x[100:300] - center) * 0.01  # quiet stretch
    if dtype != np.float32:
        info = np.iinfo(dtype)
        x = np.round(x).clip(info.min, info.max)
    return x.astype(dtype)


@pytest.mark.parametrize("n", [5000, 70001])
@pytest.mark.parametrize("mod", ["ASK", "FSK"])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=lambda d: np.dtype(d).name)
def test_afp_demod_matches_jax(dtype, mod, n):
    x = _capture(dtype, n, seed=n)
    noise = DTYPES[dtype][2]
    got = demod.afp_demod(x, noise, mod, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n,)
    want = jax_demod.afp_demod(x, noise, mod)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # a tensor input is demodulated where it lies, with the same result
    np.testing.assert_array_equal(
        demod.afp_demod(torch.from_numpy(x), noise, mod).numpy(), got.numpy())


def test_afp_demod_short_inputs_are_zero():
    x = _capture(np.float32, 2, seed=1)
    np.testing.assert_array_equal(demod.afp_demod(x, 0.1, "FSK", device="cpu").numpy(),
                                  jax_demod.afp_demod(x, 0.1, "FSK"))


@pytest.mark.parametrize("mod", ["PSK", "OQPSK"])
def test_psk_and_oqpsk_match_jax(mod):
    """PSK runs the Costas loop on a PSK capture (qad atol 1e-4: XLA's
    cos/sin are not torch's and the loop feeds rounding back; on noise the
    loop never locks and the two diverge, tests/test_torch_costas.py);
    OQPSK takes the quadrature discriminator as urh_tpu's host route does
    (atol 1e-6, as ASK/FSK)."""
    bits = np.random.default_rng(2).integers(0, 2, 40)
    x = modulate(bits, 50, "psk", [0.0, np.pi], pause=500)
    x = (x + np.random.default_rng(3).normal(0, 0.05, x.shape)).astype(np.float32)
    got = demod.afp_demod(x, 0.1, mod, 2, device="cpu")
    want = jax_demod.afp_demod(x, 0.1, mod, 2)
    assert got.dtype == torch.float32 and got.shape == (len(x),) and got[0] == -4.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 if mod == "PSK" else 1e-6)


@pytest.mark.parametrize("bits_per_symbol", [1, 2, 3])
def test_symbol_states_match_jax(bits_per_symbol):
    order = 2 ** bits_per_symbol
    rng = np.random.default_rng(order)
    thresholds = symbols.get_center_thresholds(0.05, 0.2, order)
    np.testing.assert_array_equal(
        thresholds, jax_symbols.get_center_thresholds(0.05, 0.2, order))
    qad = rng.uniform(-1.0, 1.0, 20000).astype(np.float32)
    qad[::7] = -4.0  # FSK noise sentinel -> pause
    qad[::11] = thresholds[rng.integers(0, order - 1, len(qad[::11]))]  # on a threshold
    got = symbols.symbol_states(torch.from_numpy(qad), thresholds, -4.0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  jax_symbols.symbol_states(qad, thresholds, -4.0))


def _random_runs(rng, n_runs, order, max_len=260):
    run_states = rng.integers(-1, order, n_runs)
    run_lens = rng.integers(1, max_len, n_runs)
    return np.repeat(run_states, run_lens).astype(np.int32)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mod,bits_per_symbol", [("FSK", 1), ("ASK", 1), ("FSK", 2)])
def test_grab_pulse_lens_matches_jax(mod, bits_per_symbol, seed):
    order = 2 ** bits_per_symbol
    rng = np.random.default_rng(seed)
    states = _random_runs(rng, 400, order)
    center, spacing = (0.5 if mod == "ASK" else 0.0), 0.5
    args = (center, 5, mod, 100, bits_per_symbol, spacing)

    # states only (samples=None), as the int8 fused kernels hand them over
    want = jax_symbols.grab_pulse_lens(None, *args, precomputed_states=states)
    got = symbols.grab_pulse_lens(None, *args, precomputed_states=torch.from_numpy(states))
    np.testing.assert_array_equal(got, want)

    # samples whose states are those runs: one value inside each state's bin
    # (an ASK envelope stays positive, clear of its 0.0 sentinel)
    sentinel = demod.noise_sentinel(mod)
    thresholds = symbols.get_center_thresholds(center, spacing, order)
    edges = np.concatenate(([thresholds[0] - 0.3], thresholds, [thresholds[-1] + 0.3]))
    levels = ((edges[:-1] + edges[1:]) / 2).astype(np.float32)
    qad = np.where(states < 0, sentinel, levels[np.maximum(states, 0)]).astype(np.float32)
    want = jax_symbols.grab_pulse_lens(qad, *args)
    np.testing.assert_array_equal(symbols.grab_pulse_lens(torch.from_numpy(qad), *args),
                                  want)
    np.testing.assert_array_equal(
        symbols.grab_pulse_lens(qad, *args, precomputed_states=torch.from_numpy(
            np.array(jax_symbols.symbol_states(qad, thresholds, sentinel)))), want)


def test_grab_pulse_lens_empty():
    assert symbols.grab_pulse_lens(None, 0.0, 5, "FSK", 100,
                                   precomputed_states=torch.zeros(0)).shape == (0, 2)
    assert symbols.grab_pulse_lens(torch.zeros(0), 0.0, 5, "FSK", 100).shape == (0, 2)
