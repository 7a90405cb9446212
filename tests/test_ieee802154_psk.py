"""IEEE 802.15.4's 868 MHz BPSK captures (``benchmark/gen/ieee802154.py``)
through the port's PSK analysis at a given modulation.

The generator's frames against the standard's PPDU; URH's classifier on
raised-cosine chips (urh_tpu and the port alike: no PSK without the
modulation given, PSK at 40 samples a chip with it); the benchmark's plain
Costas loop against the port's CPU loop; the port's analysis against the
benchmark's plain PSK analysis; the ``demod.costas`` span and the
``costas.samples`` counter.  The captures hold one exchange with a 5-octet
data frame (2^17 samples): the port's plain loop steps about 65 us a
sample on the CPU.
"""

import numpy as np
import pytest
import torch

import urh_tpu
import urh_tpu_torch as ut
from benchmark import registry
from benchmark.gen import ieee802154 as gen
from benchmark.reference import costas as ref_costas
from benchmark.reference import demod as ref_demod
from benchmark.reference import psk as ref_psk
from urh_tpu_torch.dsp import costas
from urh_tpu_torch.util.metrics import metrics, now_ns

CFG = registry.config(registry.benchmark(), "ieee802154_bpsk868_hackrf")
LIMITS = registry.limits("ieee802154_bpsk868_hackrf.analyze")
N_SMALL, OCTETS_SMALL = 1 << 17, 5
SEED = 2**31 + 19


def small_capture(cfg=CFG, seed=SEED):
    return gen.capture(cfg, [seed, 0], N_SMALL, OCTETS_SMALL, layout=0)


def despread(chips: np.ndarray) -> np.ndarray:
    """Chips -> the raw bits: each 15 chips to the nearer sequence, then
    R_n = E_n xor E_(n-1) with E_0 = 0."""
    seqs = np.array([np.frombuffer(CFG["spreading"][k].encode(), np.uint8) - ord("0")
                     for k in ("zero", "one")])
    words = chips.reshape(-1, 15)
    encoded = np.array([np.argmin([(w != s).sum() for s in seqs]) for w in words], np.uint8)
    return encoded ^ np.concatenate(([0], encoded[:-1])).astype(np.uint8)


@pytest.mark.parametrize("kind,octets", [("data", 127), ("ack", 5), ("data", 20)])
def test_a_frame_despreads_to_the_ppdu_sent(kind, octets):
    rng = np.random.default_rng(octets)
    psdu = rng.integers(0, 256, octets, np.uint8)
    phase = float(rng.uniform(0, 2 * np.pi))
    w = gen.frame_waveform(CFG, kind, psdu, phase)
    assert len(w) == gen.frame_samples(CFG, octets) == (8 * (6 + octets) * 15 + 8) * 40
    # back to baseband: undo the tuner offset and the phase, read each chip's peak
    f = CFG["frames"][kind]
    n = np.arange(len(w))
    rot = np.exp(-1j * (2 * np.pi * f["carrier_offset_hz"] / CFG["sample_rate"] * n + phase))
    base = ((w[:, 0] + 1j * w[:, 1]) * rot).real / f["amplitude"]
    peaks = base[4 * 40 + 20::40][:8 * (6 + octets) * 15]
    assert np.abs(np.abs(peaks) - 1).max() < 0.02  # raised cosine: no interference at a peak
    bits = despread((peaks > 0).astype(np.uint8))
    assert (bits[:32] == 0).all()
    assert "".join(map(str, bits[32:40])) == "11100101"  # SFD 0xA7, LSB first
    length = bits[40:47]
    assert int((length << np.arange(7)).sum()) == octets and bits[47] == 0
    assert np.packbits(bits[48:], bitorder="little").tobytes() == psdu.tobytes()


def test_a_capture_holds_exchanges_after_two_quiet_rows():
    n = 1 << 24
    row = n // 100
    sym = gen.symbol_samples(CFG)
    data, ack = gen.frame_samples(CFG, 127), gen.frame_samples(CFG, 5)
    gaps = {}
    for layout in (0, 1):
        frames = gen.schedule(CFG, n, 127, layout)
        assert len(frames) == 44 and [k for _, k in frames] == ["data", "ack"] * 22
        assert frames[0][0] == gen.quiet_lead(n) == 2 * row + n % row
        starts = [a for a, _ in frames]
        assert all(starts[i + 1] - starts[i] == data + 12 * sym for i in range(0, 44, 2))
        between = [(starts[i + 1] - starts[i] - ack) // sym for i in range(1, 43, 2)]
        assert all((b - 20) % 20 == 0 and 20 <= b <= 160 for b in between)
        gaps[layout] = between
        assert frames[-1][0] + ack <= n
    assert gaps[0] != gaps[1] and sorted(gaps[0]) == sorted(gaps[1])
    x, frames = small_capture()
    y, _ = small_capture()
    assert x.dtype == np.int8 and x.shape == (N_SMALL, 2) and np.array_equal(x, y)
    assert [k for _, k, _ in frames] == ["data", "ack"]
    lead = gen.quiet_lead(N_SMALL)
    assert np.abs(x[:lead].astype(np.int16)).max() < 8 < np.abs(x[lead + 200:lead + 800]).max()


@pytest.fixture(scope="module")
def port_analysis():
    """The port's analysis of the small capture on the CPU, as a user runs
    it: PSK set, auto_detect(detect_modulation=False, detect_noise=True),
    demodulate; with the spans and the counter it recorded."""
    x, frames = small_capture()
    t0 = now_ns()
    before = metrics.counters().get("costas.samples", 0)
    sig = ut.Signal.from_iq(x, sample_rate=CFG["sample_rate"], modulation="PSK", device="cpu")
    found = sig.auto_detect(detect_modulation=False, detect_noise=True)
    msgs = ut.demodulate(sig)
    spans = [s for s in metrics.timeline() if s.name == "demod.costas" and s.start_ns >= t0]
    counted = metrics.counters().get("costas.samples", 0) - before
    return {"x": x, "sig": sig, "found": found, "msgs": msgs, "spans": spans,
            "counted": counted}


@pytest.mark.parametrize("fmt", ["int8", "float32"])
def test_full_auto_detection_misses_psk_and_psk_given_finds_40(fmt, port_analysis):
    x, _ = small_capture(dict(CFG, sample_format=fmt))
    full = urh_tpu.estimate(x)
    assert full is None or full["modulation_type"] != "PSK"
    port_full = ut.estimate(x, device="cpu")
    assert (port_full is None) == (full is None)
    if full is not None:
        assert (port_full["modulation_type"], port_full["bit_length"]) == (
            full["modulation_type"], full["bit_length"])
    given = urh_tpu.estimate(x, modulation="PSK")
    assert (given["modulation_type"], given["bit_length"]) == ("PSK", 40)
    sig = port_analysis["sig"]
    assert port_analysis["found"] and (sig.modulation_type, sig.samples_per_symbol) == ("PSK", 40)


def test_the_reference_loop_equals_the_port_s_cpu_loop_within_the_qad_limit():
    """A data frame's start: gated noise, then the loop's acquisition of a
    carrier 15 kHz off, whose phase wraps past 2 pi every 800 samples."""
    x, _ = small_capture()
    lead = gen.quiet_lead(N_SMALL)
    piece = x[lead - 600:lead + 3400]
    nsq = float(np.float32(6.0 * 6.0))
    want, carry = ref_costas.loop(piece, nsq)
    alpha, beta = costas.costas_alpha_beta(0.1)
    got, phase, freq = costas.costa_demod_scan_plain(
        torch.from_numpy(piece.astype(np.float32)), nsq, 127.5, 0.5, 2, alpha, beta,
        torch.tensor(1.5), torch.tensor(0.0))
    gated = want == ref_costas.SENTINEL
    assert 100 < gated.sum() < len(piece) - 3000
    assert np.array_equal(gated, got.numpy() == ref_costas.SENTINEL)
    assert np.abs(got.numpy() - want).max() <= LIMITS["qad_err"]
    assert abs(float(phase) - carry[0]) <= LIMITS["qad_err"]
    # the wrap: the carried phase drops by about 2 pi between 200-sample steps
    state, phases = (ref_costas.INIT_PHASE, 0.0), []
    for a in range(0, len(piece), 200):
        state = ref_costas.loop(piece[a:a + 200], nsq, carry=state)[1]
        phases.append(state[0])
    assert np.min(np.diff(phases)) < -np.pi and np.abs(phases).max() <= 2 * np.pi


def test_the_port_s_psk_analysis_matches_the_reference(port_analysis):
    x, sig = port_analysis["x"], port_analysis["sig"]
    params, res = ref_psk.analyze(x)
    assert params["noise"] == sig.noise_threshold
    assert any((c["samples_per_symbol"], c["tolerance"]) == (sig.samples_per_symbol,
                                                             sig.tolerance)
               for c in params["candidates"])
    lo, hi = params["center_band"]
    assert lo - LIMITS["center_err"] <= sig.center <= hi + LIMITS["center_err"]
    qad = sig.qad.numpy()
    assert np.abs(qad - res["rect"]).max() <= LIMITS["qad_err"]
    at = dict(params, center=sig.center, pause_threshold=8)
    want = ref_demod.demodulate(x, at, rect=res["rect"])["messages"]
    got = port_analysis["msgs"]
    assert len(got) == len(want) == 2
    for m, (bits, pause, _, _, pos) in zip(got, want):
        assert "".join(map(str, m.plain_bits.plane.tolist())) == bits
        assert (int(m.pause), tuple(m.bit_sample_pos)) == (pause, pos)


def test_each_costas_pass_is_one_span_and_one_counter_update(port_analysis):
    n = len(port_analysis["x"])
    spans = port_analysis["spans"]
    assert [s.args for s in spans] == [{"samples": n - 1, "loop_order": 2}] * 2
    assert port_analysis["counted"] == 2 * (n - 1)
    t0 = now_ns()
    before = metrics.counters().get("costas.samples", 0)
    x = torch.full((7, 2), 0.5)
    costas.costa_demod_scan(x, 0.0, 1.0, 0.0, 4, 0.1, costas.new_carry("cpu"))
    costas.costa_demod_scan(x[:0], 0.0, 1.0, 0.0, 2, 0.1, costas.new_carry("cpu"))
    mine = [s for s in metrics.timeline() if s.name == "demod.costas" and s.start_ns >= t0]
    assert [s.args for s in mine] == [{"samples": 7, "loop_order": 4}]
    assert metrics.counters()["costas.samples"] - before == 7
