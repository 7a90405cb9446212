"""urh_tpu_torch.parallel.sharded on 8 CPU shards against urh_tpu on its
8 virtual CPU devices (tests/conftest.py).

Captures are synthetic, made with urh_tpu's modulate from seeds (the
golden captures are missing here).  Tolerances:

* demod: qad atol 1e-6 (atan2 and the ASK envelope may round an ulp
  apart), states equal; runs, pulses and bits equal;
* FIR: atol 1e-3 on inputs of unit scale, 1e-2 at 40,000 samples and more
  (tests/test_torch_filters.py): torch.fft and XLA's FFT round differently;
* STFT: atol 1e-4 (tests/test_sharded.py:105);
* block-parallel PSK: qad atol 1e-4 (the loop tolerance of
  tests/test_torch_costas.py: XLA's float32 cos/sin are not torch's, and
  the loop feeds each rounding back), pulses equal;
* exact PSK: equal to the port's afp_demod to the bit, within 1e-4 of
  urh_tpu's;
* the modulator: 4 float32 ulps of the amplitude plus an ulp of the
  largest carrier argument (tests/test_torch_modulate.py's device route:
  XLA contracts (2*pi*f)*t + phi into an FMA).

PSK streams stay at or below 20k samples: the plain loop steps sample by
sample.
"""

import math

import numpy as np
import pytest
import torch

import urh_tpu_torch
from urh_tpu.dsp.modulate import modulate
from urh_tpu.dsp.symbols import grab_pulse_lens as jax_grab_pulse_lens
from urh_tpu.parallel import sharded as jax_sharded
from urh_tpu_torch.dsp import costas, symbols
from urh_tpu_torch.dsp.spectrogram import Spectrogram
from urh_tpu_torch.parallel import sharded
from urh_tpu_torch.parallel.sharded import Mesh, make_mesh
from urh_tpu_torch.protocol.analyzer import ProtocolAnalyzer

torch.set_num_threads(1)

QAD_ATOL = 1e-6
FIR_ATOL, FIR_LONG_ATOL = 1e-3, 1e-2
STFT_ATOL = 1e-4
PSK_ATOL = 1e-4
FLOAT_ULPS = 4
SPS = 100
NOISE = 0.05
# ASK zeros are silence: a run of 20 zero bits ends a message
DECISIONS = {"FSK": dict(center=0.0, center_spacing=1.0, pause_threshold=8),
             "ASK": dict(center=0.25, center_spacing=0.1, pause_threshold=20)}


def _capture(kind: str, seed: int, n_msgs: int = 4, n_bits: int = 64, pause: int = 2400):
    """n_msgs messages of n_bits random bits, each after a pause, with
    Gaussian noise of sigma 0.01; ASK messages open and close with a 1."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n_msgs, n_bits))
    if kind == "ASK":
        bits[:, 0] = bits[:, -1] = 1
    params = [-20e3, 20e3] if kind == "FSK" else [0.0, 1.0]
    iq = np.concatenate([np.zeros((pause, 2), np.float32)]
                        + [modulate(b, SPS, kind.lower(), np.float32(params), pause=pause)
                           for b in bits])
    return (iq + rng.normal(0, 0.01, iq.shape)).astype(np.float32), bits


def _psk(seed: int, n_bits: int, noise: float = 0.0):
    rng = np.random.default_rng(seed)
    iq = modulate(rng.integers(0, 2, n_bits), SPS, "PSK", np.float32([0, np.pi]), 1, 1, 40e3,
                  0, 1e6, 0, 0)
    return (iq + rng.normal(0, noise, iq.shape)).astype(np.float32) if noise else iq


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_sharded.make_mesh()


def test_make_mesh():
    m = make_mesh(8, device="cpu")
    assert m.size == 8 and m.axis == "b" and set(m.devices) == {torch.device("cpu")}
    assert m.by_device() == [(torch.device("cpu"), list(range(8)))]
    assert make_mesh(device="cpu").size == 1
    split = Mesh((torch.device("cpu"), torch.device("cpu", 0)) * 2)
    assert split.by_device() == [(torch.device("cpu"), [0, 2]), (torch.device("cpu", 0), [1, 3])]
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")


@pytest.mark.parametrize("n_blocks", [1, 3, 8])
@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 100])
def test_pad_to_blocks_equals_urh_tpus(n, n_blocks):
    x = np.arange(2 * n, dtype=np.float32).reshape(n, 2)
    got, got_n = sharded.pad_to_blocks(x, n_blocks)
    want, want_n = jax_sharded.pad_to_blocks(x, n_blocks)
    assert got_n == want_n and np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["FSK", "ASK"])
@pytest.mark.parametrize("cut", [0, 5], ids=["divisible", "ragged"])
@pytest.mark.parametrize("shards", [1, 3, 8])
def test_sharded_demodulate_equals_urh_tpu(kind, cut, shards, jax_mesh):
    iq, _ = _capture(kind, seed=1)
    iq = iq[:len(iq) - len(iq) % 8 - cut]
    d = DECISIONS[kind]
    args = (iq, NOISE, kind, d["center"], d["center_spacing"], 1)
    qad, states = sharded.sharded_demodulate(*args, mesh=make_mesh(shards, device="cpu"))
    jmesh = jax_sharded.make_mesh(shards)
    want_qad, want_states = jax_sharded.sharded_demodulate(*args, mesh=jmesh)
    assert qad.shape == want_qad.shape == (len(iq),)
    np.testing.assert_allclose(qad, want_qad, atol=QAD_ATOL)
    np.testing.assert_array_equal(states, want_states)


@pytest.mark.parametrize("kind", ["FSK", "ASK"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_sharded_demodulate_of_a_few_samples(kind, n, mesh, jax_mesh):
    iq, _ = _capture(kind, seed=2)
    x = iq[2400 + 37:2400 + 37 + n]  # inside the first message
    got = sharded.sharded_demodulate(x, NOISE, kind, 0.0, 1.0, 1, mesh=mesh)
    want = jax_sharded.sharded_demodulate(x, NOISE, kind, 0.0, 1.0, 1, mesh=jax_mesh)
    np.testing.assert_allclose(got[0], want[0], atol=QAD_ATOL)
    np.testing.assert_array_equal(got[1], want[1])


def test_sharded_demodulate_of_nothing(mesh, jax_mesh):
    """The port returns empty arrays; urh_tpu's step indexes an empty block
    and raises."""
    qad, states = sharded.sharded_demodulate(np.zeros((0, 2), np.float32), NOISE, "FSK",
                                             0.0, 1.0, 1, mesh=mesh)
    assert qad.shape == states.shape == (0,)
    with pytest.raises(IndexError):
        jax_sharded.sharded_demodulate(np.zeros((0, 2), np.float32), NOISE, "FSK", 0.0, 1.0,
                                       1, mesh=jax_mesh)
    assert sharded.sharded_pulse_lens(np.zeros((0, 2), np.float32), NOISE, "FSK", 0.0, 1.0,
                                      1, 5, SPS, mesh=mesh).shape == (0, 2)


def test_sharded_demod_rejects_psk(mesh):
    with pytest.raises(ValueError):
        sharded.build_sharded_demod(mesh, "PSK")


@pytest.mark.parametrize("kind", ["FSK", "ASK"])
@pytest.mark.parametrize("cut", [0, 3], ids=["divisible", "ragged"])
def test_states_to_runs_equals_urh_tpu(kind, cut, mesh):
    iq, _ = _capture(kind, seed=3)
    iq = iq[:len(iq) - cut]
    d = DECISIONS[kind]
    _, states, _, n = sharded._demod_shards(iq, NOISE, kind, d["center"],
                                            d["center_spacing"], 1, mesh, np.float32)
    whole = np.concatenate([s.numpy() for s in states])
    want = jax_sharded.states_to_runs(whole, total_len=n)
    for got in (sharded.states_to_runs(states, total_len=n),
                sharded.states_to_runs([s.numpy() for s in states], total_len=n),
                sharded.states_to_runs(torch.from_numpy(whole[:n]))):
        for g, w in zip(got, want):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w)


def test_states_to_runs_of_nothing():
    for got in (sharded.states_to_runs(np.zeros(0, np.int32)),
                sharded.states_to_runs([torch.zeros(4, dtype=torch.int32)], total_len=0)):
        assert all(len(a) == 0 and a.dtype == np.int64 for a in got)


@pytest.mark.parametrize("kind", ["FSK", "ASK"])
@pytest.mark.parametrize("seed", [4, 5])
def test_sharded_pulse_lens_and_bits(kind, seed, mesh, jax_mesh):
    iq, bits = _capture(kind, seed)
    d = DECISIONS[kind]
    args = (iq, NOISE, kind, d["center"], d["center_spacing"], 1, 5, SPS)
    got = sharded.sharded_pulse_lens(*args, mesh=mesh)
    np.testing.assert_array_equal(got, jax_sharded.sharded_pulse_lens(*args, mesh=jax_mesh))
    qad = urh_tpu_torch.afp_demod(iq, NOISE, kind, device="cpu")
    np.testing.assert_array_equal(got, symbols.grab_pulse_lens(
        qad, d["center"], 5, kind, SPS, 1, d["center_spacing"]))
    bit_data, _, _ = ProtocolAnalyzer._ppseq_to_bits(got, SPS, 1,
                                                     pause_threshold=d["pause_threshold"])
    assert [list(b) for b in bit_data] == bits.tolist()


@pytest.mark.parametrize("n_taps", [31, 51])
@pytest.mark.parametrize("n", [5000, 40_001])
def test_sharded_fir_filter_equals_urh_tpu(n_taps, n, mesh, jax_mesh):
    rng = np.random.default_rng(n_taps + n)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    taps = rng.normal(size=n_taps).astype(np.complex64)
    got = sharded.sharded_fir_filter(x, taps, mesh=mesh)
    atol = FIR_LONG_ATOL if n >= 40_000 else FIR_ATOL
    assert got.dtype == np.complex64 and got.shape == x.shape
    np.testing.assert_allclose(got, jax_sharded.sharded_fir_filter(x, taps, mesh=jax_mesh),
                               atol=atol)
    np.testing.assert_allclose(got, np.convolve(x, taps)[:n], atol=atol)


def test_sharded_fir_refuses_a_halo_longer_than_a_block(mesh, jax_mesh):
    """ROADMAP C9: 80 samples on 8 shards and 31 taps.  urh_tpu's halo is
    a block's 10 samples where 30 are needed, and its output is off by up
    to 20; the port raises."""
    x, taps = np.ones(80, np.complex64), np.ones(31)
    with pytest.raises(ValueError):
        sharded.sharded_fir_filter(x, taps, mesh=mesh)
    wrong = jax_sharded.sharded_fir_filter(x, taps, mesh=jax_mesh)
    assert np.abs(wrong - np.convolve(x, taps)[:80]).max() > 10
    np.testing.assert_allclose(sharded.sharded_fir_filter(x, taps, mesh=make_mesh(
        2, device="cpu")), np.convolve(x, taps)[:80], atol=FIR_ATOL)


@pytest.mark.parametrize("window,overlap", [(1024, 0.5), (256, 0.75), (64, 0.0)])
@pytest.mark.parametrize("n", [1 << 16, 50_003])
def test_sharded_spectrogram_equals_urh_tpu(window, overlap, n, mesh, jax_mesh):
    rng = np.random.default_rng(n)
    x = (np.exp(2j * np.pi * 0.05 * np.arange(n))
         + 0.1 * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)
    got = sharded.sharded_spectrogram(x, mesh=mesh, window_size=window,
                                      overlap_factor=overlap)
    want = jax_sharded.sharded_spectrogram(x, mesh=jax_mesh, window_size=window,
                                           overlap_factor=overlap)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=STFT_ATOL)
    # the single-device STFT, up to the frames that reach past the samples
    # the shards hold (ROADMAP C8: both packages read zeros there)
    hop = window - int(overlap * window)
    per_shard = -(-got.shape[0] // 8)
    held = 8 * per_shard * hop
    inside = max(0, min(got.shape[0], (held - window) // hop + 1))
    single = Spectrogram(x, window_size=window, overlap_factor=overlap, device="cpu").stft(x)
    np.testing.assert_allclose(got[:inside], single[:inside], atol=STFT_ATOL)
    if held >= len(x):
        np.testing.assert_allclose(got, single, atol=STFT_ATOL)
    else:
        assert np.abs(got[inside:] - single[inside:]).max() > 0.1


def test_sharded_spectrogram_reads_zeros_past_the_shards_as_urh_tpu_does(mesh, jax_mesh):
    """ROADMAP C8: 50,003 samples, 96 frames of 1,024 at a hop of 512, 12 a
    shard: the shards hold 49,152 samples, and the last frame, which
    reaches to 49,664, takes zeros for samples that the capture has."""
    x = np.exp(2j * np.pi * 0.05 * np.arange(50_003)).astype(np.complex64)
    got = sharded.sharded_spectrogram(x, mesh=mesh)
    want = jax_sharded.sharded_spectrogram(x, mesh=jax_mesh)
    single = Spectrogram(x, device="cpu").stft(x)
    assert got.shape == want.shape == single.shape == (96, 1024)
    np.testing.assert_allclose(got, want, atol=STFT_ATOL)
    np.testing.assert_allclose(got[:95], single[:95], atol=STFT_ATOL)
    zeroed = np.concatenate((x[95 * 512:49_152], np.zeros(512, np.complex64)))
    np.testing.assert_allclose(got[95], np.fft.fft(zeroed * np.hanning(1024)) / 1024,
                               atol=STFT_ATOL)
    assert np.abs(got[95] - single[95]).max() > 0.1


@pytest.mark.parametrize("margin", [64, 8192])
def test_sharded_psk_demod_equals_urh_tpu(margin, mesh, jax_mesh):
    iq = _psk(9, 512)  # 51,200 samples: streams of 6,400 plus the margin
    got = sharded.sharded_psk_demod(iq, 0, 2, margin=margin, mesh=mesh)
    want = jax_sharded.sharded_psk_demod(iq, 0, 2, margin=margin, mesh=jax_mesh)
    np.testing.assert_allclose(got, want, atol=PSK_ATOL)
    np.testing.assert_array_equal(symbols.grab_pulse_lens(got, 0, 5, "PSK", SPS),
                                  jax_grab_pulse_lens(want, 0, 5, "PSK", SPS))


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_sharded_psk_demod_exact(shards, jax_mesh):
    iq = _psk(17, 150, noise=0.05)
    m = make_mesh(shards, device="cpu")
    got = sharded.sharded_psk_demod_exact(iq, 0.01, 2, mesh=m)
    np.testing.assert_array_equal(got, urh_tpu_torch.afp_demod(iq, 0.01, "PSK", 2,
                                                               device="cpu").numpy())
    want = jax_sharded.sharded_psk_demod_exact(iq, 0.01, 2, mesh=jax_sharded.make_mesh(shards))
    np.testing.assert_allclose(got, want, atol=PSK_ATOL)


@pytest.mark.parametrize("n", [0, 1, 2])
def test_sharded_psk_demod_exact_of_a_few_samples(n, mesh):
    assert np.array_equal(sharded.sharded_psk_demod_exact(np.ones((n, 2), np.float32), 0.1,
                                                          mesh=mesh), np.zeros(n, np.float32))


def _count_calls(monkeypatch, name):
    calls = []
    original = getattr(costas, name)

    def counted(x, *args):
        calls.append(x.shape)
        return original(x, *args)

    monkeypatch.setattr(costas, name, counted)
    return calls


def test_one_batch_call_a_device_and_one_scan_a_block(monkeypatch, mesh):
    iq = _psk(3, 40)
    batch = _count_calls(monkeypatch, "costa_demod_scan_batch")
    sharded.sharded_psk_demod(iq, 0, 2, margin=100, mesh=mesh)
    assert batch == [(8, 100 + 500, 2)]
    split = Mesh((torch.device("cpu"), torch.device("cpu", 0)) * 4)
    sharded.sharded_psk_demod(iq, 0, 2, margin=100, mesh=split)
    assert batch[1:] == [(4, 600, 2), (4, 600, 2)]
    scans = _count_calls(monkeypatch, "costa_demod_scan")
    sharded.sharded_psk_demod_exact(iq, 0.01, 2, mesh=mesh)
    assert len(scans) == 8 and sum(s[0] for s in scans) == len(iq) - 1


def test_a_mesh_of_repeated_devices_gives_what_distinct_ones_give(mesh):
    """"cpu" and "cpu:0" are one memory but two mesh devices, so the split
    mesh takes the path of distinct cards: a batch a device, halos by
    .to() between groups."""
    split = Mesh((torch.device("cpu"), torch.device("cpu", 0)) * 4)
    iq, _ = _capture("FSK", seed=6)
    psk = _psk(7, 64)
    for fn, args in ((sharded.sharded_demodulate, (iq, NOISE, "FSK", 0.0, 1.0, 1)),
                     (sharded.sharded_pulse_lens, (iq, NOISE, "ASK", 0.25, 0.1, 1, 5, SPS)),
                     (sharded.sharded_fir_filter, (iq[:, 0] + 1j * iq[:, 1], np.ones(9))),
                     (sharded.sharded_spectrogram, (iq[:, 0] + 1j * iq[:, 1],)),
                     (sharded.sharded_psk_demod, (psk, 0.0, 2, 0.1, 300)),
                     (sharded.sharded_psk_demod_exact, (psk, 0.01))):
        one, two = fn(*args, mesh=mesh), fn(*args, mesh=split)
        for a, b in zip(one if isinstance(one, tuple) else (one,),
                        two if isinstance(two, tuple) else (two,)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mt", ["fsk", "ask", "psk"])
def test_build_sharded_modulator_equals_urh_tpu(mt, mesh, jax_mesh):
    rng = np.random.default_rng(11)
    rows, symbols_a_row, sps, rate = 16, 12, 50, 1e6
    a = np.where(rng.integers(0, 2, (rows, symbols_a_row)) == 1, 1.0, 0.3 if mt == "ask" else 1.0)
    f = rng.choice([-20e3, 20e3] if mt == "fsk" else [40e3], (rows, symbols_a_row))
    phi = rng.choice([0.0, math.pi] if mt == "psk" else [0.0], (rows, symbols_a_row))
    a, f, phi = (v.astype(np.float32) for v in (a, f, phi))
    got = sharded.build_sharded_modulator(mesh, sps)(a, f, phi, rate)
    assert len(got) == 8 and all(g.shape == (2, symbols_a_row * sps, 2) for g in got)
    got = torch.cat(got).numpy()
    want = np.asarray(jax_sharded.build_sharded_modulator(jax_mesh, sps)(a, f, phi,
                                                                         np.float32(rate)))
    max_arg = 2 * math.pi * np.abs(f).max() * symbols_a_row * sps / rate + np.abs(phi).max()
    atol = FLOAT_ULPS * float(np.finfo(np.float32).eps) + float(np.spacing(np.float32(max_arg)))
    assert np.abs(got.astype(np.float64) - want).max() <= atol


def test_build_sharded_modulator_refuses_a_batch_the_shards_do_not_divide(mesh, jax_mesh):
    a = np.ones((12, 3), np.float32)
    with pytest.raises(ValueError):
        sharded.build_sharded_modulator(mesh, 10)(a, a, a, 1e6)
    with pytest.raises(Exception):
        jax_sharded.build_sharded_modulator(jax_mesh, 10)(a, a, a, np.float32(1e6))


def _batch_inputs(c: int, n: int, seed: int):
    """(c, n, 2) raw samples with gated stretches, the last row all gated,
    and carries from the default to far outside the loop's range."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, (c, n, 2)).astype(np.float32)
    x[:, n // 3:n // 3 + 40] *= 0.001
    x[-1] *= 0.001
    phases = np.resize([1.5, 13.0, -13.0, 100.0, -100.0, 0.3], c)
    carry = np.stack((phases, np.resize([0.0, 0.5, -0.5], c)), 1).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(carry)


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("c,n", [(1, 1), (3, 2), (5, 33), (7, 301)])
def test_plain_batch_equals_the_single_stream_loop_row_by_row(order, c, n):
    x, start = _batch_inputs(c, n, seed=c * n)
    carry = start.clone()
    got = costas.costa_demod_scan_batch(x, 0.01, 1.0, 0.0, order, 0.1, carry)
    assert got.shape == (c, n)
    for row in range(c):
        one = start[row].clone()
        want = costas.costa_demod_scan(x[row].contiguous(), 0.01, 1.0, 0.0, order, 0.1, one)
        assert torch.equal(got[row], want)
        assert torch.equal(carry[row], one)
    assert torch.equal(carry[-1], start[-1])  # the gated row keeps its carry
    assert (got[-1] == -4.0).all()


def test_batch_of_no_streams_or_no_samples():
    for c, n in ((0, 5), (3, 0)):
        x, carry = torch.zeros((c, n, 2)), costas.new_carry("cpu").repeat(c, 1)
        assert costas.costa_demod_scan_batch(x, 0.1, 1.0, 0.0, 2, 0.1, carry).shape == (c, n)


def test_batch_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 4, 2))
    carry = costas.new_carry("cpu").repeat(2, 1)
    for bad_x, bad_carry in ((x.double(), carry), (x[:, :, :1], carry), (x[0], carry),
                             (x.transpose(0, 1), carry), (x, carry[:1]), (x, carry.T),
                             (x, carry.double())):
        with pytest.raises((TypeError, ValueError)):
            costas.costa_demod_scan_batch(bad_x, 0.1, 1.0, 0.0, 2, 0.1, bad_carry)


def test_entries_default_to_the_card_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((64, 2), np.float32)
    for call in (make_mesh, lambda: sharded.sharded_demodulate(x, 0.1, "FSK", 0.0, 1.0, 1),
                 lambda: sharded.sharded_pulse_lens(x, 0.1, "FSK", 0.0, 1.0, 1, 5, SPS),
                 lambda: sharded.sharded_fir_filter(x[:, 0], np.ones(3)),
                 lambda: sharded.sharded_spectrogram(x[:, 0], window_size=8),
                 lambda: sharded.sharded_psk_demod(x, 0.1),
                 lambda: sharded.sharded_psk_demod_exact(x, 0.1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
