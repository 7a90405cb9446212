"""The power gate on the staged capture (urh_tpu_torch.ai.power_gate).

On the CPU the gate's torch ops run, and the host finishes them: its
noise level and segments must equal the host path's
(``detect_noise_level`` and ``segment_messages_from_magnitudes`` over
``IQData.magnitudes``) to the bit, on every ingest dtype, at lengths that
are no multiple of 100 and at n <= 3, on an all-zero and a flat capture,
on gates with no crossing and with crossings at the first and the last
sample, on captures shaped like the benchmark's cells (the wmbus FSK
float32, the EV1527 OOK int8 and the 802.15.4 BPSK int8 generators at CPU
sizes), and on captures built so that a chunk's float32 mean lies at the
vote's threshold (1.1 times the quietest mean) within the bound: those
rows must be settled on the host and still agree; NaN, inf and rows whose
float32 sum may overflow give the host's level too, and a settled row off
its bound raises.  ``estimate()`` gates only a capture staged on the card
and gives the host path's estimate either way; ``Signal``'s noise threshold
follows estimate()'s staging rule.

The gate's magnitudes equal the host's einsum to the bit, its chunk sums
lie within ``mean_bound`` of NumPy's float32 means, its maxes are NumPy's.

On a CUDA card (marked ``card``; here they skip): the gate against the
host path, at 2^24 samples in float32 and int8, on rows past float32 sums
and through ``estimate()``; and estimate()'s batched scan of the cells'
2^24-sample captures against its CPU route.  Run them on the card with
``python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_power_gate.py``
(the repository's conftest loads JAX, which the card's machine lacks).
"""

import numpy as np
import pytest
import torch

from benchmark import registry
from benchmark.gen import ieee802154, signals
from urh_tpu_torch.ai import estimate as est
from urh_tpu_torch.ai import power_gate as pg
from urh_tpu_torch.ai import segmentation as seg
from urh_tpu_torch.core.iq import IQData
from urh_tpu_torch.util import metrics, placement

torch.set_num_threads(1)

DTYPES = [np.int8, np.uint8, np.int16, np.uint16, np.float32]
BENCH = registry.benchmark()


def host_path(iq: IQData, noise=None) -> tuple:
    """(noise, segments) as estimate() computes them on the host."""
    mags = iq.magnitudes
    if noise is None:
        noise = seg.detect_noise_level(mags)
    return noise, seg.segment_messages_from_magnitudes(mags, noise)


def gate_path(iq: IQData, noise=None, device="cpu") -> tuple:
    """(noise, segments) as estimate() computes them on a staged capture."""
    staged = iq.staged_planes(device)
    if noise is None:
        noise = pg.noise_level(staged, iq)
    return noise, pg.segments(staged, noise)


def assert_same(iq: IQData, noise=None, device="cpu"):
    want = host_path(iq, noise)
    got = gate_path(iq, noise, device)
    assert got[0] == want[0] and type(got[0]) is type(want[0])
    assert got[1] == want[1]
    return got


def bursts(dtype, n: int, seed: int) -> np.ndarray:
    """(n, 2) samples of dtype: quiet noise with loud tone bursts of
    several lengths, a short glitch and a burst up to the last sample (an
    unsigned dtype keeps the non-negative half)."""
    rng = np.random.default_rng(seed)
    scale = 1.0 if dtype == np.float32 else (int(np.iinfo(dtype).max) + 1) / 2
    x = rng.normal(0, 0.01 * scale, (n, 2))
    for start, length in ((n // 7, n // 9), (n // 3, 7), (n // 2, n // 5), (n - n // 11, n)):
        k = np.arange(len(x[start:start + length]))
        x[start:start + length, 0] += 0.6 * scale * np.cos(0.01 * k)
        x[start:start + length, 1] += 0.6 * scale * np.sin(0.01 * k)
    if dtype != np.float32:
        info = np.iinfo(dtype)
        x = np.clip(np.rint(x), info.min, info.max)
    return x.astype(dtype)


# ---------------------------------------------------------------------------
# the gate and the host's finish against the host path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("n", [4, 99, 250, 1234, 20011])
def test_gate_gives_the_host_noise_and_segments(dtype, n):
    assert n % 100 != 0
    assert_same(IQData(bursts(dtype, n, seed=n), skip_conversion=True))


@pytest.mark.parametrize("n", [0, 1, 2, 3])
def test_gate_on_three_samples_or_fewer(n):
    iq = IQData(bursts(np.float32, 8, seed=1)[:n].copy(), skip_conversion=True)
    noise, segments = assert_same(iq)
    assert noise == 0
    assert_same(iq, noise=0.001)


@pytest.mark.parametrize("dtype", [np.int8, np.float32], ids=["int8", "float32"])
def test_all_zero_capture_has_no_noise_floor(dtype):
    iq = IQData(np.zeros((5000, 2), dtype), skip_conversion=True)
    noise, segments = assert_same(iq)
    assert noise == 0 and segments == []


def test_flat_capture_has_no_noise_floor():
    rng = np.random.default_rng(3)
    x = (0.5 + rng.normal(0, 0.001, (12345, 2))).astype(np.float32)
    means = seg.chunk_means(np.asarray(IQData(x).magnitudes[45:], np.float32).reshape(-1, 123))
    assert float(means.min()) / float(means.max()) > 0.9
    noise, segments = assert_same(IQData(x, skip_conversion=True))
    assert noise == 0


def test_gate_with_no_crossing():
    x = bursts(np.float32, 3000, seed=4)
    iq = IQData(x, skip_conversion=True)
    staged = iq.staged_planes("cpu")
    for noise in (0.0, 10.0):
        positions, _ = pg.gate_crossings(staged, noise)
        assert len(positions) == 0
        assert_same(iq, noise=noise)


def test_gate_with_crossings_at_the_first_and_last_samples():
    x = np.full((3000, 2), 0.01, np.float32)
    x[0] = x[1000:1500] = x[-1] = 0.5
    iq = IQData(x, skip_conversion=True)
    positions, above0 = pg.gate_crossings(iq.staged_planes("cpu"), 0.1)
    assert positions.tolist() == [1, 1000, 1500, 2999] and above0
    assert_same(iq, noise=0.1)
    x[0] = x[-1] = 0.01
    positions, above0 = pg.gate_crossings(IQData(x).staged_planes("cpu"), 0.1)
    assert positions.tolist() == [1000, 1500] and not above0


def test_nan_samples_give_no_noise_floor_as_on_the_host():
    """A NaN level makes its row's sum NaN on the card and its mean NaN on
    the host, whose minimum is then NaN: no row votes, the level is 0."""
    x = bursts(np.float32, 5000, seed=5)
    x[2000, 1] = np.nan
    metrics.metrics.clear()
    noise, _ = assert_same(IQData(x, skip_conversion=True))
    assert noise == 0
    assert "gate.settled_rows" not in metrics.metrics.counters()


@pytest.mark.parametrize("loud", [np.inf, 1e37, 2e36], ids=["inf", "overflow", "huge"])
def test_rows_past_float32_sums_are_settled_one_by_one(loud):
    """A row with an inf level, one whose float32 sum overflows (1e37 x 50)
    and one whose float64 sum passes 2^120 but whose float32 sum does not
    (2e36 x 50): each is settled whatever its card mean, and the level is
    the host's; the other rows stay on the card's means."""
    x = bursts(np.float32, 5037, seed=7)
    x[37 + 50 * 60:37 + 50 * 61, 0] = loud
    iq = IQData(x, skip_conversion=True)
    metrics.metrics.clear()
    noise, _ = assert_same(iq)
    assert noise > 0
    assert 1 <= metrics.metrics.counters()["gate.settled_rows"] < 100


def test_every_row_inf_raises_as_on_the_host():
    """Every mean inf: every row votes and the ceiling of an inf level
    raises, on the host and here alike."""
    x = np.full((5000, 2), np.inf, np.float32)
    iq = IQData(x, skip_conversion=True)
    with pytest.raises(OverflowError):
        host_path(iq)
    with pytest.raises(OverflowError):
        gate_path(iq)


def test_a_settled_row_off_its_bound_raises(monkeypatch):
    """Where a recomputed mean lies outside its row's bound (the bound does
    not hold for this NumPy) the gate raises, and does not fall back."""
    monkeypatch.setattr(pg, "mean_bound", lambda chunk: 0.0)
    x = bursts(np.float32, 20011, seed=6)
    with pytest.raises(RuntimeError, match="mean_bound does not hold"):
        gate_path(IQData(x, skip_conversion=True))


def cell_capture(cell: str) -> np.ndarray:
    seed = [2**31 + 23, 0]
    if cell == "ieee802154_bpsk868_hackrf":
        return ieee802154.capture(registry.config(BENCH, cell), seed, 1 << 17, 5, layout=0)[0]
    return signals.capture(registry.config(BENCH, cell), seed, 1 << 20, layout=0)[0]


@pytest.mark.parametrize("cell,dtype", [("wmbus_t1_hackrf_5msps", np.float32),
                                        ("ook_ev1527_rtlsdr", np.int8),
                                        ("ieee802154_bpsk868_hackrf", np.int8)])
def test_gate_on_captures_shaped_like_the_cells(cell, dtype):
    x = cell_capture(cell)
    assert x.dtype == dtype
    metrics.metrics.clear()
    noise, segments = assert_same(IQData(x, skip_conversion=True))
    counts = metrics.metrics.counters()
    assert noise > 0 and segments
    assert 1 <= counts["gate.settled_rows"] < 100
    assert counts["gate.crossings"] >= 2 * len(segments)


@pytest.mark.parametrize("ulps", [-3, -1, 0, 1, 3])
def test_a_mean_at_the_threshold_is_settled_and_agrees(ulps):
    """Row 0 averages 1.0 (the quietest), row 1 lies the given float32 ulps
    from 1.1 (the vote's threshold), the other rows at 5.0: row 1's host
    mean is within the bound of the threshold, so it must be settled."""
    chunk = 1000
    x = np.zeros((100 * chunk + 37, 2), np.float32)
    rows = x[37:].reshape(100, chunk, 2)
    rows[:, :, 0] = 5.0
    rows[0, :, 0] = 1.0
    level = np.float32(1.1)
    step = np.float32(np.inf if ulps > 0 else -np.inf)
    for _ in range(abs(ulps)):
        level = np.nextafter(level, step)
    rows[1, :, 0] = level
    rows[1, ::7, 0] = np.nextafter(level, np.float32(np.inf))  # a sum that rounds
    iq = IQData(x, skip_conversion=True)
    mean = seg.chunk_means(np.asarray(iq.magnitudes[37:], np.float32).reshape(100, chunk))[1]
    assert abs(float(mean) - 1.1) <= pg.mean_bound(chunk) * float(mean)
    metrics.metrics.clear()
    assert_same(iq)
    assert metrics.metrics.counters()["gate.settled_rows"] >= 2  # rows 0 and 1


def test_estimate_on_a_staged_capture_equals_the_host_path(monkeypatch):
    """Unstaged (placement's host side), staged on the CPU (the host path
    too) and gated (the gate's torch ops, as the card's path runs them):
    one estimate."""
    x = cell_capture("wmbus_t1_hackrf_5msps")
    host = placement.choose
    with monkeypatch.context() as m:
        m.setattr(placement, "choose", lambda route, device, card_wins: (
            torch.device("cpu"), "host") if route == "ai.estimate.staging"
            else host(route, device, card_wins))
        want_est = est.estimate(x, device="cpu")
    metrics.metrics.clear()
    cpu_est = est.estimate(x, device="cpu")
    assert not any(k.startswith("gate.") for k in metrics.metrics.counters())
    monkeypatch.setattr(est, "gates", lambda staged: staged is not None)
    got_est = est.estimate(x, device="cpu")
    assert metrics.metrics.counters()["gate.card"] == 1
    assert want_est == cpu_est == got_est and want_est is not None


@pytest.mark.parametrize("side", ["card", "host"])
def test_signal_noise_threshold_follows_the_staging_rule(monkeypatch, side):
    """Signal.detect_noise_threshold (run as a file loads) gates only where
    estimate()'s staging rule puts the capture on the card, as it does
    under "auto"; on placement's host side it keeps the host's vote."""
    import urh_tpu_torch as ut

    x = cell_capture("ook_ev1527_rtlsdr")
    sig = ut.Signal.from_iq(x, device="cpu")
    want = seg.detect_noise_level(sig.iq_array.magnitudes)
    asked = []

    def choose(route, device, card_wins):
        asked.append((route, device))
        return torch.device("cpu"), side

    calls = []
    noise_level = pg.noise_level
    monkeypatch.setattr(placement, "choose", choose)
    monkeypatch.setattr(est, "gates", lambda staged: staged is not None)
    monkeypatch.setattr(pg, "noise_level", lambda *a: calls.append(1) or noise_level(*a))
    assert sig.detect_noise_threshold() == want
    assert asked == [("ai.estimate.staging", sig.requested_device)]
    assert len(calls) == (side == "card")


def test_gate_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        pg.gate_stats(torch.zeros((10, 2), dtype=torch.float64), 0, 1)
    with pytest.raises(ValueError):
        pg.gate_crossings(torch.zeros((10, 3), dtype=torch.float32), 0.1)
    with pytest.raises(ValueError):
        pg.gate_crossings(torch.zeros((10, 2), dtype=torch.int8).t(), 0.1)


BURSTS = [(np.float32, 1000003), (np.int8, 250017), (np.uint8, 417), (np.int16, 56789),
          (np.uint16, 4)]


@pytest.mark.parametrize("case", ["lognormal", *BURSTS],
                         ids=lambda c: c if isinstance(c, str)
                         else f"{np.dtype(c[0]).name}-{c[1]}")
def test_mean_bound_covers_numpy_float32_means(case):
    """The bound against NumPy's own float32 mean, on levels of many
    magnitudes (the widest relative spread a real chunk has) and on bursts
    captures: the exact mean lies within half of it and the gate's float64
    sum over chunk within it; the gate's maxes are NumPy's row maxes."""
    for x, skip, chunk in level_rows(case):
        rows = (len(x) - skip) // chunk
        levels = np.asarray(IQData(x, skip_conversion=True).magnitudes[skip:skip + rows * chunk],
                            np.float32).reshape(rows, chunk)
        exact = levels.astype(np.float64).sum(axis=1) / chunk
        host = seg.chunk_means(levels).astype(np.float64)
        assert (np.abs(host - exact) <= 0.5 * pg.mean_bound(chunk) * exact).all()
        sums, maxes = (t.numpy() for t in pg.gate_stats(torch.from_numpy(x), skip, chunk))
        assert (np.abs(host - sums / chunk) <= pg.mean_bound(chunk) * sums / chunk
                + 2.0 ** -148).all()
        assert np.array_equal(maxes.view(np.int32), levels.max(axis=1).view(np.int32))


# ---------------------------------------------------------------------------
# the gate's arithmetic against NumPy's
# ---------------------------------------------------------------------------


def edge_samples(dtype) -> np.ndarray:
    """Every pair of a byte dtype; extremes and random pairs of the others
    (float32 with subnormals, huge values, zeros of both signs)."""
    if np.dtype(dtype).itemsize == 1:
        v = np.arange(256, dtype=np.uint8).view(dtype)
        return np.stack(np.meshgrid(v, v), axis=-1).reshape(-1, 2).copy()
    rng = np.random.default_rng(11)
    if dtype == np.float32:
        special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-38, 3.4e38, -3.4e38, 1.0, 0.1],
                           np.float32)
        grid = np.stack(np.meshgrid(special, special), axis=-1).reshape(-1, 2)
        rand = (rng.normal(0, 1, (50000, 2)) * 10.0 ** rng.integers(-30, 30, (50000, 1)))
        return np.concatenate([grid, rand.astype(np.float32)])
    info = np.iinfo(dtype)
    special = np.array([info.min, info.min + 1, -1 if info.min else 1, 0, 1, info.max - 1,
                        info.max], dtype)
    grid = np.stack(np.meshgrid(special, special), axis=-1).reshape(-1, 2)
    rand = rng.integers(info.min, int(info.max) + 1, (50000, 2)).astype(dtype)
    return np.concatenate([grid, rand])


def level_rows(case) -> list:
    """-> [(x, skip, chunk)]: 4 rows of lognormal levels (many magnitudes:
    the widest relative spread a real chunk has) as (level, 0) float32
    samples at chunks of 1 to 167,772, or a bursts capture in
    detect_noise_level's layout."""
    if case == "lognormal":
        rng = np.random.default_rng(9)
        out = []
        for chunk in (1, 7, 128, 129, 1000, 40961, 167772):
            levels = (rng.lognormal(0, 3, 4 * chunk) * 1e-3).astype(np.float32)
            out.append((np.stack([levels, np.zeros_like(levels)], axis=1), 0, chunk))
        return out
    dtype, n = case
    return [(bursts(dtype, n, seed=n), *seg.noise_rows(n))]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_magnitudes_equal_the_host_einsum(dtype):
    x = edge_samples(dtype)
    want = IQData(x, skip_conversion=True).magnitudes
    got = pg._magnitudes(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


def test_a_nan_level_gives_its_row_a_nan_max():
    """A NaN level inside a burst, louder levels after it: its row's max
    (and sum) is NaN, as np.max gives, and the other rows' maxes are
    NumPy's."""
    x = bursts(np.float32, 5037, seed=7)
    x[37 + 50 * 60 + 3, 1] = np.nan
    skip, chunk = seg.noise_rows(len(x))
    levels = np.asarray(IQData(x, skip_conversion=True).magnitudes[skip:],
                        np.float32).reshape(-1, chunk)
    sums, maxes = (t.numpy() for t in pg.gate_stats(torch.from_numpy(x), skip, chunk))
    assert np.isnan(maxes[60]) and np.isnan(sums[60])
    assert np.array_equal(maxes, levels.max(axis=1), equal_nan=True)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("dtype", [np.float32, np.int8], ids=["float32", "int8"])
def test_card_gate_at_2_24_samples(card, dtype):
    x = bursts(dtype, 1 << 24, seed=24)
    iq = IQData(x, skip_conversion=True)
    metrics.metrics.clear()
    assert_same(iq, device=card)
    scale = 1.0 if dtype == np.float32 else 64.0  # bursts' scale: tones at 0.6, noise 0.01
    _, segments = assert_same(iq, noise=0.3 * scale, device=card)
    counts = metrics.metrics.counters()
    assert counts["gate.crossings"] >= len(segments) > 0
    assert 1 <= counts["gate.settled_rows"] < 100


@pytest.mark.card
@pytest.mark.parametrize("loud", [np.nan, np.inf, 1e37, 2e36], ids=["nan", "inf", "overflow", "huge"])
def test_card_gate_on_rows_past_float32_sums(card, loud):
    """The card's sums carry NaN and inf as the host's means do, and a
    row past 2^120 is settled: the host path's level on the card too."""
    x = bursts(np.float32, 5037, seed=7)
    x[37 + 50 * 60:37 + 50 * 61, 0] = loud
    metrics.metrics.clear()
    noise, _ = assert_same(IQData(x, skip_conversion=True), device=card)
    counts = metrics.metrics.counters()
    assert (noise == 0) == np.isnan(loud)
    assert ("gate.settled_rows" in counts) != np.isnan(loud)
    assert counts["gate.crossings"] > 0


@pytest.mark.card
def test_card_estimate_counts_one_gate(card, monkeypatch):
    """estimate() on the card gates once (one crossings pass, counted) and
    gives the estimate of the host path on the same card."""
    x = cell_capture("wmbus_t1_hackrf_5msps")
    with monkeypatch.context() as m:
        m.setattr(est, "gates", lambda staged: False)
        want = est.estimate(x, device=card)
    assert want is not None
    positions, _ = pg.gate_crossings(IQData(x).staged_planes(card), want["noise"])
    metrics.metrics.clear()
    assert est.estimate(x, device=card) == want
    counts = metrics.metrics.counters()
    assert counts["gate.card"] == 1
    assert counts["gate.crossings"] == len(positions) > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", ["wmbus_t1_hackrf_5msps", "ook_ev1527_rtlsdr",
                                  "ieee802154_bpsk868_hackrf"])
def test_card_scan_at_2_24_samples_equals_the_cpu_route(card, cell, monkeypatch):
    """estimate() on the card of a cell's 2^24-sample capture counts every
    message's center histogram in one device call (``scan.histogram_calls``
    1, ``scan.messages`` the segments scanned) and gives the estimate it
    gives with the scan's histograms counted on the CPU; the batched scan
    on the card (the rect uploaded, as the values left on the card are read
    inside estimate()) and on the CPU equal the per-message loop on the CPU."""
    seed = [2**31 + 23, 0]
    cfg = registry.config(BENCH, cell)
    psk = cell == "ieee802154_bpsk868_hackrf"
    x = (ieee802154.capture(cfg, seed, 1 << 24, 127, layout=0) if psk
         else signals.capture(cfg, seed, 1 << 24, layout=0))[0]
    modulation = "PSK" if psk else None
    seen = {}
    centers = est.detect_centers

    def spy(rect, segments, device=None, resident=None):
        seen.update(rect=rect, segments=list(segments), device=device, resident=resident)
        return centers(rect, segments, device=device, resident=resident)

    monkeypatch.setattr(est, "detect_centers", spy)
    metrics.metrics.clear()
    got = est.estimate(x, modulation=modulation, device=card)
    counts = metrics.metrics.counters()
    rect, segments = seen["rect"], seen["segments"]
    assert got is not None and torch.device(seen["device"]).type == card.type
    assert seen["resident"].device.type == card.type  # the rect is read on the card
    assert counts["scan.histogram_calls"] == 1
    assert counts["scan.messages"] == len(segments) > 1

    on_cpu = est.scan_messages(rect, segments, device="cpu")
    assert est.scan_messages(rect, segments, device=card) == on_cpu
    assert on_cpu == [est._message_parameters(rect[start:end], device="cpu")
                      for start, end in segments]
    monkeypatch.setattr(est, "detect_centers",
                        lambda rect, segments, device=None, resident=None:
                        centers(rect, segments, device="cpu", resident=resident))
    assert est.estimate(x, modulation=modulation, device=card) == got
