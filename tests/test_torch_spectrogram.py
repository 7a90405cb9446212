"""Spectrogram, colormaps and plot decimation against urh_tpu's.

The same seeded inputs go through urh_tpu (JAX on the CPU) and
urh_tpu_torch (torch's CPU ops).  Tolerances:

* STFT dB: atol 0.05 on finite cells and the same non-finite cells
  (tests/test_filters_spectrogram.py:198-199): torch.fft and XLA's FFT
  round differently, and a silent frame is -inf in both;
* the complex STFT: atol 1e-5 of unit-scale input;
* colour indices of the image: within 1 (0.05 dB is 0.09 of an index);
* colormap tables (the same interpreter: matplotlib's maps where it is
  installed, the anchors otherwise), create_path's min/max and the .fta
  export's f and t: exact; its amplitudes within 0.05 dB.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from urh_tpu.dsp import decimation as jax_decimation
from urh_tpu.dsp import spectrogram as jax_spectrogram
from urh_tpu.util import colormaps as jax_colormaps
from urh_tpu_torch.dsp import decimation, spectrogram
from urh_tpu_torch.dsp.spectrogram import Spectrogram
from urh_tpu_torch.util import colormaps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

DB_ATOL = 0.05
STFT_ATOL = 1e-5


def _tone(n, seed, silent=True):
    """A 0.1 fs tone plus noise, with an exactly silent stretch (its frames
    are -inf dB) when ``silent``."""
    rng = np.random.default_rng(seed)
    x = (np.exp(2j * np.pi * 0.1 * np.arange(n))
         + 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)
    if silent and n > 3000:
        x[1000:3000] = 0
    return x


def _assert_same_db(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[~np.isfinite(got)], want[~np.isfinite(want)])
    finite = np.isfinite(got)
    np.testing.assert_allclose(got[finite], want[finite], atol=DB_ATOL)


@pytest.mark.parametrize("kind", ["hanning", "hamming", "blackman", "rectangular"])
@pytest.mark.parametrize("n", [100, 512, 513, 9000], ids=["below", "at", "above", "frames"])
def test_stft_db_equals_urh_tpu(kind, n):
    spec = Spectrogram(_tone(n, seed=n), window_size=512, window_function=kind, device="cpu")
    samples, hop, frames, wf = spec._frame_params(spec.samples)
    got = spectrogram._stft_db_device(torch.from_numpy(samples), 512, hop, frames, wf).numpy()
    want = np.asarray(jax_spectrogram._stft_db_device(
        jnp.asarray(samples.real), jnp.asarray(samples.imag), 512, hop, frames, wf))
    _assert_same_db(got, want)
    if n == 9000:
        assert np.isneginf(got).any()  # the silent frames


def test_windows_are_symmetric_like_jax():
    for kind in ("hanning", "hamming", "blackman"):
        window = spectrogram._window(kind, 64, "cpu").numpy()
        np.testing.assert_array_equal(window, window[::-1])
        np.testing.assert_allclose(window, np.asarray(jax_spectrogram._window(kind, 64)),
                                   atol=1e-6)


def test_stft_and_decibels_equal_urh_tpu():
    x = _tone(5000, seed=1)
    spec = Spectrogram(x, window_size=256, device="cpu")
    ref = jax_spectrogram.Spectrogram(x, window_size=256)
    got, want = spec.stft(x), ref.stft(x)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=STFT_ATOL)
    _assert_same_db(spectrogram.arr2decibel(torch.from_numpy(got)).numpy(),
                    np.asarray(jax_spectrogram.arr2decibel(jnp.asarray(got))))
    assert (spec.time_bins, spec.freq_bins, spec.hop_size) == (ref.time_bins, ref.freq_bins,
                                                                ref.hop_size)


@pytest.mark.parametrize("transpose", [False, True])
def test_spectrogram_image_equals_urh_tpu(transpose):
    x = _tone(20000, seed=2)
    spec = Spectrogram(x, window_size=256, device="cpu")
    ref = jax_spectrogram.Spectrogram(x, window_size=256)
    got_db, want_db = spec._calculate_spectrogram(x), ref._calculate_spectrogram(x)
    _assert_same_db(got_db, want_db)
    got = Spectrogram.color_indices(got_db, 256, spec.data_min, spec.data_max)
    want = Spectrogram.color_indices(want_db, 256, ref.data_min, ref.data_max)
    assert np.abs(got - want).max() <= 1
    image = spec.create_spectrogram_image(transpose=transpose)
    ref_image = ref.create_spectrogram_image(transpose=transpose)
    assert image.shape == ref_image.shape and image.dtype == np.uint8
    table = {tuple(row) for row in colormaps.chosen_colormap_numpy_bgra}
    assert {tuple(px) for px in image.reshape(-1, 4)} <= table


def test_image_segments_equal_urh_tpu():
    x = _tone(300_000, seed=3, silent=False)
    spec = Spectrogram(x, window_size=128, device="cpu")
    ref = jax_spectrogram.Spectrogram(x, window_size=128)
    got, want = list(spec.create_image_segments()), list(ref.create_image_segments())
    assert [s.shape for s in got] == [s.shape for s in want] and len(got) > 1


def test_samples_of_an_iq_array_convert_as_urh_tpu():
    iq = (np.random.default_rng(4).normal(size=(300, 2)) * 40).astype(np.int8)
    np.testing.assert_array_equal(Spectrogram(iq, device="cpu").samples,
                                  jax_spectrogram.Spectrogram(iq).samples)


@pytest.mark.parametrize("include_amplitude", [False, True])
def test_export_to_fta_equals_urh_tpu(tmp_path, include_amplitude):
    x = _tone(3000, seed=5)
    Spectrogram(x, window_size=64, device="cpu").export_to_fta(
        1e6, str(tmp_path / "port.fta"), include_amplitude)
    jax_spectrogram.Spectrogram(x, window_size=64).export_to_fta(
        1e6, str(tmp_path / "ref.fta"), include_amplitude)
    fields = [("f", np.float64), ("t", np.uint32)] + (
        [("a", np.float32)] if include_amplitude else [])
    got = np.fromfile(tmp_path / "port.fta", dtype=fields)
    want = np.fromfile(tmp_path / "ref.fta", dtype=fields)
    np.testing.assert_array_equal(got["f"], want["f"])
    np.testing.assert_array_equal(got["t"], want["t"])
    if include_amplitude:
        _assert_same_db(got["a"], want["a"])


@pytest.mark.parametrize("name", ["magma", "viridis", "inferno", "plasma", "grayscale"])
def test_colormap_tables_equal_urh_tpu(name):
    np.testing.assert_array_equal(colormaps.calculate_colormap(name),
                                  jax_colormaps.calculate_colormap(name))
    np.testing.assert_array_equal(colormaps.calculate_numpy_brga_for(name),
                                  jax_colormaps.calculate_numpy_brga_for(name))
    np.testing.assert_array_equal(colormaps.maps[name], jax_colormaps.maps[name])


def test_colormap_choice_equals_urh_tpu(monkeypatch, tmp_path):
    import json

    from urh_tpu_torch.util import settings

    assert colormaps.available_colormaps == jax_colormaps.available_colormaps
    assert colormaps.default_colormap == jax_colormaps.default_colormap
    np.testing.assert_array_equal(colormaps.chosen_colormap_numpy_bgra,
                                  jax_colormaps.chosen_colormap_numpy_bgra)
    for stored, chosen in (("viridis", "viridis"), ("no such map", "plasma")):
        monkeypatch.setattr(settings, "_store", {"spectrogram_colormap": stored})
        assert colormaps.read_selected_colormap_name_from_settings() == chosen
    monkeypatch.setattr(settings, "_store", {"spectrogram_colormap": "magma"})
    try:
        colormaps.load_colormap_from_settings()
        assert colormaps.chosen_colormap_name == "magma"
        np.testing.assert_array_equal(colormaps.chosen_colormap_numpy_bgra,
                                      jax_colormaps.calculate_numpy_brga_for("magma"))
    finally:
        colormaps.choose_colormap(colormaps.default_colormap)
    # the choice is written to the store under urh_tpu's key
    monkeypatch.setattr(settings, "_config_dir", str(tmp_path))
    monkeypatch.setattr(settings, "_settings_file", str(tmp_path / "settings.json"))
    colormaps.write_selected_colormap_to_settings("viridis")
    assert colormaps.read_selected_colormap_name_from_settings() == "viridis"
    assert json.load(open(tmp_path / "settings.json"))["spectrogram_colormap"] == "viridis"


PATH_CASES = {
    "decimated": (200_000, 0, 200_000, None),
    "decimated, an offset range": (200_000, 12_345, 190_001, None),
    "subpaths": (150_000, 1000, 150_000, [(1000, 5000), (70_000, 71_234), (149_000, 150_000)]),
    "two samples a pixel": (10_001, 0, 10_001, None),
    "one sample a pixel": (9_999, 0, 9_999, [(0, 10), (500, 600)]),
}


@pytest.mark.parametrize("case", sorted(PATH_CASES))
def test_create_path_equals_urh_tpu(case):
    n, start, end, ranges = PATH_CASES[case]
    samples = np.random.default_rng(n).normal(size=n).astype(np.float32)
    got = decimation.create_path(samples, start, end, ranges, device="cpu")
    want = jax_decimation.create_path(samples, start, end, ranges)
    assert len(got) == len(want)
    for (x, y), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)
        assert y.dtype == wy.dtype


def test_create_live_path_equals_urh_tpu():
    samples = np.arange(100, dtype=np.float32)
    for got, want in zip(decimation.create_live_path(samples, 10, 90),
                         jax_decimation.create_live_path(samples, 10, 90)):
        np.testing.assert_array_equal(got, want)


def test_db_images_agree_above_minus_100_db_and_not_below():
    """ROADMAP C10: on chip_smoke's 2^22-sample FSK capture at window 1,024,
    urh_tpu's host (NumPy) and device (XLA) dB images agree within 0.05 dB
    at or above -100 dB and differ by more below it, where float32 FFT
    rounding decides; the port's CPU image agrees with both above."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    iq, _ = chip_smoke.make_capture("FSK", 1 << 22, 1)
    x = (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
    samples, hop, frames, wf = Spectrogram(x, window_size=1024, device="cpu")._frame_params(x)
    host = jax_spectrogram.Spectrogram._stft_db_np(samples, 1024, hop, frames, wf)
    device = np.asarray(jax_spectrogram._stft_db_device(
        jnp.asarray(samples.real), jnp.asarray(samples.imag), 1024, hop, frames, wf))
    port = spectrogram._stft_db_device(torch.from_numpy(samples), 1024, hop, frames, wf).numpy()
    np.testing.assert_array_equal(np.isfinite(host), np.isfinite(device))
    above = np.isfinite(host) & (host >= chip_smoke.DB_FLOOR)
    below = np.isfinite(host) & (host < chip_smoke.DB_FLOOR)
    assert above.any() and below.any()
    assert np.abs(host - device)[above].max() <= DB_ATOL
    assert np.abs(host - device)[below].max() > DB_ATOL
    for image in (host, device):
        assert np.abs(port - image)[above].max() <= DB_ATOL
