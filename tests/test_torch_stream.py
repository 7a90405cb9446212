"""Streaming (StreamDemodulator, RunCarry) and the fused stream block (B6)
against urh_tpu's.

tests/test_stream.py is the model, on synthetic captures from urh_tpu's
modulator with seeded numpy noise.  The port runs on the CPU
(``device="cpu"``), where the stream block is its plain version; urh_tpu
runs its XLA programs on the CPU.  Segments (start_sample, num_samples,
ppseq) must be equal, exactly, PSK's too (the two Costas loops stay
within about 2e-6 of each other on these captures, and the pulse
machine's tolerance absorbs that, tests/test_torch_costas.py); the
detected center within 1e-5 (a mean of histogram levels of qad, whose
atan2 differs by ulps).  The plain bundle must equal urh_tpu's _runs_body
bundle to the bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from urh_tpu.dsp.demod import DemodParams as JaxParams
from urh_tpu.dsp.modulate import modulate
from urh_tpu.protocol import stream as jax_stream
from urh_tpu_torch.dsp import stream_kernels as sk
from urh_tpu_torch.dsp.demod import DemodParams
from urh_tpu_torch.dsp.symbols import get_center_thresholds
from urh_tpu_torch.protocol import stream

torch.set_num_threads(1)

CENTER_ATOL = 1e-5


def _fsk(n_copies=4, sps=20, pause=1200, seed=0, amp=1.0):
    bits = np.resize(np.array([1, 0, 1, 1, 0, 0, 1, 0], np.uint8), 64)
    one = modulate(bits, sps, "fsk", [-20e3, 20e3], sample_rate=1e6, pause=pause)
    x = np.tile(one, (n_copies, 1)) * amp
    return (x + np.random.default_rng(seed).normal(0, 0.002, x.shape)).astype(np.float32)


def _ask(n_copies=4, seed=0):
    bits = np.resize(np.array([1, 0, 1, 1, 0, 0, 1, 1], np.uint8), 64)
    one = modulate(bits, 20, "ask", [0.0, 1.0], sample_rate=1e6, pause=1200)
    x = np.tile(one, (n_copies, 1)) * 0.9
    return (x + np.random.default_rng(seed).normal(0, 0.002, x.shape)).astype(np.float32)


def _fsk8():
    rng = np.random.default_rng(11)
    symbols = rng.integers(0, 8, 48)
    bits = np.array([(s >> k) & 1 for s in symbols for k in (2, 1, 0)], np.uint8)
    return modulate(bits, 60, "fsk", list(np.linspace(-35e3, 35e3, 8)), sample_rate=1e6,
                    bits_per_symbol=3, pause=1500).astype(np.float32)


def _psk():
    bits = np.resize([1, 0, 1, 1, 0, 0, 1, 0], 48)
    x = modulate(bits, 100, "psk", [0.0, np.pi], sample_rate=1e6, pause=2500)
    return (x + np.random.default_rng(4).normal(0, 0.02, x.shape)).astype(np.float32)


def _i8(x):
    return np.clip(np.round(x * 128), -128, 127).astype(np.int8)


FSK = dict(modulation="FSK", samples_per_symbol=20, center=0.0, noise_threshold=1e-2,
           tolerance=3)
ASK = dict(modulation="ASK", samples_per_symbol=20, center=0.3, noise_threshold=1e-2,
           tolerance=3)
FSK8 = dict(modulation="FSK", samples_per_symbol=60, bits_per_symbol=3, center=0.0,
            center_spacing=2 * np.pi * 10e3 / 1e6, noise_threshold=0.01, tolerance=5)
PSK = dict(modulation="PSK", samples_per_symbol=100, center=0.0, noise_threshold=0.1,
           tolerance=5)


def _chunks(x, sizes):
    i, sizes = 0, iter(sizes)
    while i < len(x):
        n = next(sizes)
        yield x[i:i + n]
        i += n


def _run(sd, chunks):
    segments = []
    for c in chunks:
        segments += sd.feed(c)
    return segments + sd.flush()


def _assert_same_segments(got, want):
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert (g.start_sample, g.num_samples) == (w.start_sample, w.num_samples)
        np.testing.assert_array_equal(np.asarray(g.ppseq), np.asarray(w.ppseq))
        if w.center is None:
            assert g.center is None
        else:  # the mean of two histogram levels of qad (atan2 ulps apart)
            assert g.center == pytest.approx(w.center, abs=CENTER_ATOL)


def _both(params: dict, chunks, **kw):
    """Segments of urh_tpu's StreamDemodulator and the port's on the CPU."""
    backend = kw.pop("backend", "device")
    want = _run(jax_stream.StreamDemodulator(JaxParams(**params), backend=backend, **kw),
                chunks)
    sd = stream.StreamDemodulator(DemodParams(**params), backend=backend, device="cpu", **kw)
    return _run(sd, chunks), want, sd


def _random_cuts(x, seed, k=20):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, len(x)), size=k, replace=False))
    return np.split(x, cuts)


CASES = {
    "fsk_f32": (FSK, lambda: list(_chunks(_fsk(), iter(lambda: 2048, 0)))),
    "fsk_i8": (FSK, lambda: list(_chunks(_i8(_fsk(amp=0.9)), iter(lambda: 2048, 0)))),
    "ask_f32": (ASK, lambda: list(_chunks(_ask(), iter(lambda: 1500, 0)))),
    "ask_i8": (ASK, lambda: list(_chunks(_i8(_ask()), iter(lambda: 1500, 0)))),
    "fsk_random_cuts": (FSK, lambda: _random_cuts(_fsk(n_copies=5), seed=1)),
    "fsk_i8_random_cuts": (FSK, lambda: _random_cuts(_i8(_fsk(amp=0.9)), seed=2)),
    "single_samples_and_giant": (FSK, lambda: [_fsk()[:1], _fsk()[1:3], _fsk()[3:]]),
    "mixed_dtypes": (FSK, lambda: [_fsk(amp=0.9)[:9000], _i8(_fsk(amp=0.9))[9000:13000],
                                   _fsk(amp=0.9)[13000:]]),
    "fsk8": (FSK8, lambda: list(_chunks(_fsk8(), iter(lambda: 1024, 0)))),
    "psk": (PSK, lambda: _random_cuts(_psk(), seed=7, k=12)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_segments_match_jax(case):
    params, chunks = CASES[case]
    got, want, _ = _both(params, chunks())
    _assert_same_segments(got, want)


@pytest.mark.parametrize("case", ["fsk_f32", "fsk_i8", "ask_f32", "mixed_dtypes", "fsk8"])
def test_host_backend_matches_jax(case):
    params, chunks = CASES[case]
    got, want, sd = _both(params, chunks(), backend="host")
    _assert_same_segments(got, want)
    assert sd.backend == "host"


def test_auto_backend_settles_and_matches():
    params, chunks = CASES["fsk_f32"]
    got, want, sd = _both(params, [np.concatenate(chunks())])
    auto = stream.StreamDemodulator(DemodParams(**params), backend="auto", device="cpu")
    _assert_same_segments(_run(auto, [np.concatenate(chunks())]), got)
    assert auto.backend in ("host", "device")


def test_auto_backend_runs_small_chunks_on_the_device(monkeypatch):
    """Chunks below the probe's 4096 samples decide nothing and take the
    device path (urh_tpu takes its host twin there)."""
    params, chunks = CASES["fsk_f32"]  # 2048-sample chunks
    got, _, _ = _both(params, chunks())
    sd = stream.StreamDemodulator(DemodParams(**params), backend="auto", device="cpu")
    monkeypatch.setattr(sd, "_host_block", None)  # raises if the host twin runs
    _assert_same_segments(_run(sd, chunks()), got)
    assert sd.backend == "auto"


def test_adaptive_noise_matches_jax():
    rng = np.random.default_rng(3)
    idle = [rng.normal(0, 3e-4, (2000, 2)).astype(np.float32) for _ in range(12)]
    params = dict(FSK, noise_threshold=0.001)
    chunks = idle + list(_chunks(_fsk(), iter(lambda: 2048, 0)))
    got, want, sd = _both(params, chunks, adaptive_noise=True)
    _assert_same_segments(got, want)
    assert sd.noise_threshold > 0.001


def test_automatic_center_matches_jax():
    bits = np.resize([1, 0, 1, 1, 0, 0, 1, 0], 40)
    x = modulate(bits, 100, "fsk", [-20e3, 20e3], sample_rate=1e6, pause=1500)
    x = np.tile(x, (2, 1)).astype(np.float32)
    params = dict(FSK, samples_per_symbol=100, center=0.3, tolerance=5)
    got, want, _ = _both(params, list(_chunks(x, iter(lambda: 3000, 0))),
                         automatic_center=True)
    _assert_same_segments(got, want)
    assert abs(got[0].center) < 0.15


@pytest.mark.parametrize("backend", ["host", "device"])
def test_prompt_close_matches_jax(backend):
    """A gate-length trailing pause closes its segment at once on the host
    and one chunk later on the device (the one-chunk pipeline), in both
    packages; flush has nothing left."""
    x = modulate([1, 0, 1, 1, 0, 0, 1, 0], 100, "fsk", [-20e3, 20e3], sample_rate=1e6)
    params = dict(FSK, samples_per_symbol=100, tolerance=5)
    sd = stream.StreamDemodulator(DemodParams(**params), backend=backend, device="cpu")
    jsd = jax_stream.StreamDemodulator(JaxParams(**params), backend=backend)
    silence = np.zeros((10 * 100, 2), np.float32)
    outputs = []
    for chunk in (x, silence, silence):
        got, want = sd.feed(chunk), jsd.feed(chunk)
        _assert_same_or_empty(got, want)
        outputs.append(len(got))
    assert outputs == ([0, 1, 0] if backend == "host" else [0, 0, 1])
    assert not sd.flush() and not jsd.flush()


def test_overflow_falls_back_to_the_states():
    """Alternating states overflow the bundle: the kernel's per-sample
    states give the runs, and the segments stay urh_tpu's."""
    x = np.zeros((3000, 2), np.float32)
    x[:, 0] = np.where(np.arange(3000) % 2, 0.9, 0.2)
    x[2000:] = 0.0
    params = dict(ASK, tolerance=0)
    before = stream.FALLBACKS["states"]
    got, want, _ = _both(params, [x[:1000], x[1000:]])
    _assert_same_segments(got, want)
    assert stream.FALLBACKS["states"] > before


# -- the block (B6) ------------------------------------------------------


def _block_input(n, ingest, seed):
    rng = np.random.default_rng(seed)
    x = _fsk(n_copies=1)[:n] + _ask(n_copies=1)[:n] * 0.5
    x = np.tile(x, (-(-n // len(x)), 1))[:n]
    x[n // 3:n // 3 + 200] *= 0.001  # a gated stretch
    x += rng.normal(0, 0.01, x.shape).astype(np.float32)
    return _i8(x) if ingest == "i8" else x.astype(np.float32)


@pytest.mark.parametrize("order", [2, 8])
@pytest.mark.parametrize("mod", ["ASK", "FSK"])
@pytest.mark.parametrize("ingest", ["f32", "i8"])
def test_plain_bundle_matches_jax_runs_body(ingest, mod, order):
    center, spacing = (0.3, 0.1) if mod == "ASK" else (0.0, 0.5)
    thr = get_center_thresholds(center, spacing, order)
    bits = stream.rle_state_bits(order)
    assert bits == jax_stream.rle_state_bits(order)
    nsq, max_mag = float(np.float32(0.01 ** 2)), float(np.float32(np.sqrt(2.0)))
    for n in (1, 2, 17, 1000, 5003):
        x = _block_input(n, ingest, seed=n)
        xf = x.astype(np.float32) * np.float32(1 / 128) if ingest == "i8" else x
        for halo in (False, True):
            if n <= halo:
                continue
            cap = n // 4 + 8
            got = sk.stream_block(torch.from_numpy(x), nsq, max_mag,
                                  torch.from_numpy(thr), mod, halo, cap, bits)
            states = sk.stream_states(torch.from_numpy(x), nsq, max_mag,
                                      torch.from_numpy(thr), mod, halo)
            want = jax_stream._runs_body(jnp.asarray(xf), jnp.float32(nsq),
                                         jnp.float32(max_mag), jnp.asarray(thr),
                                         jnp.float32(-4.0 if mod == "FSK" else 0.0), mod,
                                         halo, cap, bits)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert states.dtype == torch.int8 and len(states) == n - halo


@pytest.mark.parametrize("mod", ["ASK", "FSK"])
@pytest.mark.parametrize("ingest", ["f32", "i8"])
def test_stream_states_match_jax_block_states(ingest, mod):
    """The states-only launch's CPU path: urh_tpu's _block_states after
    drop_first, exact."""
    thr = get_center_thresholds(*((0.3, 0.1) if mod == "ASK" else (0.0, 0.5)), 4)
    nsq, max_mag = float(np.float32(0.01 ** 2)), float(np.float32(np.sqrt(2.0)))
    x = _block_input(3001, ingest, seed=5)
    xf = x.astype(np.float32) * np.float32(1 / 128) if ingest == "i8" else x
    want, _ = jax_stream._block_states(jnp.asarray(xf), jnp.float32(nsq), jnp.float32(max_mag),
                                       jnp.asarray(thr),
                                       jnp.float32(-4.0 if mod == "FSK" else 0.0), mod)
    for halo in (False, True):
        got = sk.stream_states(torch.from_numpy(x), nsq, max_mag, torch.from_numpy(thr), mod,
                               halo)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[int(halo):])


@pytest.mark.parametrize("ingest", ["f32", "i8"])
def test_plain_bundle_overflow_matches_jax(ingest):
    x = np.zeros((500, 2), np.float32)
    x[:, 0] = np.where(np.arange(500) % 2, 0.9, 0.2)
    xi = x if ingest == "f32" else _i8(x)
    xf = x if ingest == "f32" else xi.astype(np.float32) * np.float32(1 / 128)
    thr = np.float32([0.3])
    got = sk.stream_block(torch.from_numpy(xi), 0.0, 1.4142135, torch.from_numpy(thr),
                          "ASK", True, 16, 2)
    want = jax_stream._runs_body(jnp.asarray(xf), jnp.float32(0.0), jnp.float32(1.4142135),
                                 jnp.asarray(thr), jnp.float32(0.0), "ASK", True, 16, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0]) == 499 > 16


def test_stream_block_rejects_bad_inputs():
    x, thr = torch.zeros((10, 2)), torch.zeros(1)
    with pytest.raises(ValueError):
        sk.stream_block(x, 0.0, 1.0, thr, "PSK", False, 8, 2)
    with pytest.raises(ValueError):
        sk.stream_block(x[:1], 0.0, 1.0, thr, "FSK", True, 8, 2)
    with pytest.raises(TypeError):
        sk.stream_block(x.double(), 0.0, 1.0, thr, "FSK", False, 8, 2)


# -- host helpers -------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_run_carry_matches_jax(seed):
    """Random pushes (merging across pushes, pure-idle spans, gate-length
    pauses) and closes, stream_done last."""
    rng = np.random.default_rng(seed)
    ours, theirs = stream.RunCarry(50, tolerance=3), jax_stream.RunCarry(50, tolerance=3)
    for step in range(30):
        k = int(rng.integers(0, 6))
        states = rng.integers(-1, 2, k)
        lens = np.where(states == -1, rng.integers(1, 120, k), rng.integers(1, 30, k))
        ours.push(states, lens)
        theirs.push(states, lens)
        done = step == 29
        _assert_same_or_empty(ours.close_segments(done), theirs.close_segments(done))
        assert (ours.states, ours.lens, ours.start_abs) == (
            theirs.states, theirs.lens, theirs.start_abs)


def _assert_same_or_empty(got, want):
    assert len(got) == len(want)
    if got:
        _assert_same_segments(got, want)


def test_rle_helpers_match_jax():
    states = np.array([7, 7, 7, -1, -1, 5, 5, 5, 5, 7, 7, 0, 0], np.int32)
    packed, _ = jax_stream._device_rle(jnp.asarray(states), cap=16, state_bits=4)
    for fn in ("unpack_rle",):
        got = getattr(stream, fn)(np.asarray(packed), 4)
        want = getattr(jax_stream, fn)(np.asarray(packed), 4)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    r_states, r_lens = np.array([0, 1, -1]), np.array([5, 7, 100])
    for n in (112, 50, 12, 3):
        for g, w in zip(stream._clip_runs(r_states, r_lens, n),
                        jax_stream._clip_runs(r_states, r_lens, n)):
            np.testing.assert_array_equal(g, w)
    assert stream.rle_max_block(4) == jax_stream.rle_max_block(4)
