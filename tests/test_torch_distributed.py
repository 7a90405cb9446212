"""urh_tpu_torch.parallel.distributed on two gloo ranks against urh_tpu.

Two worker processes (and, as a control, one) join a gloo process group
on localhost; each reads only its slice of raw captures written under
tmp_path (read_capture_slice), holds its shards on the CPU (four in
all), runs the distributed pipelines and writes its results to a pickle.  The workers
import neither JAX nor urh_tpu.  This process compares them with
urh_tpu's single-host results on the whole captures:

* demod: states equal, qad within 1e-6 (urh_tpu's sharded tolerance:
  atan2 and the ASK envelope may round an ulp apart);
* pulse lens: equal;
* FIR: atol 1e-3 on inputs of unit scale (tests/test_torch_filters.py);
* STFT: atol 1e-4 (tests/test_sharded.py:105);
* exact PSK: equal to the port's afp_demod to the bit, and within 1e-4 of
  urh_tpu's (the loop tolerance of tests/test_torch_costas.py).

The two-rank results must also equal the one-rank control's.  urh_tpu's
scaling test is not ported: it writes SCALING.json into the repository.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import urh_tpu_torch
from urh_tpu.dsp.demod import afp_demod as jax_afp_demod
from urh_tpu.dsp.demod import noise_sentinel
from urh_tpu.dsp.modulate import modulate
from urh_tpu.dsp.symbols import get_center_thresholds, grab_pulse_lens, symbol_states
from urh_tpu.parallel import distributed as jax_dist
from urh_tpu.parallel.sharded import make_mesh, sharded_fir_filter
from urh_tpu_torch.parallel import distributed as dist

from tests.proc_util import communicate_with_watchdog

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QAD_ATOL = 1e-6
FIR_ATOL = 1e-3
STFT_ATOL = 1e-4
PSK_ATOL = 1e-4
NOISE = 0.05
WINDOW, HOP = 64, 32
SHARDS = 4  # in all: 4 on the one rank, 2 on each of the two
WORKER_TIMEOUT_S = 240

WORKER = r"""
import pickle
import sys

sys.modules["jax"] = None  # any import of jax now fails
sys.modules["urh_tpu"] = None
import numpy as np
import torch

torch.set_num_threads(1)
from urh_tpu_torch.parallel import distributed as dist

port, rank, world, folder, shards, window = sys.argv[1:7]
rank, world, shards, window = int(rank), int(world), int(shards), int(window)
dist.initialize(f"localhost:{port}", world, rank, device="cpu")
assert dist.is_distributed() == (world > 1)
mesh = dist.global_mesh(shards, device="cpu")
noise = float(open(f"{folder}/noise").read())
out = {}
for kind in ("FSK", "ASK"):
    local = dist.read_capture_slice(f"{folder}/{kind}.raw", np.float32)
    center, spacing = (0.0, 1.0) if kind == "FSK" else (0.25, 0.1)
    out[kind, "pulses"] = dist.distributed_pulse_lens(local, noise, kind, center, spacing,
                                                      1, 5, 100, mesh=mesh)
    out[kind, "qad"], out[kind, "states"] = dist.distributed_demodulate(
        local, noise, kind, center, spacing, 1, mesh=mesh)
    if kind == "FSK":
        cx = (local[:, 0] + 1j * local[:, 1]).astype(np.complex64)
        taps = np.load(f"{folder}/taps.npy")
        out["fir"] = dist.distributed_fir_filter(cx, taps, mesh=mesh)
        out["stft"] = dist.distributed_spectrogram(cx, window_size=window, mesh=mesh)
psk = dist.read_capture_slice(f"{folder}/PSK.raw", np.float32)
out["psk"] = dist.distributed_psk_demod_exact(psk, 0.01, 2, device="cpu")
with open(f"{folder}/rank{rank}of{world}.pkl", "wb") as f:
    pickle.dump(out, f)
dist.shutdown()
assert not [m for m in sys.modules if m.split(".")[0] == "urh_tpu" and sys.modules[m]]
print(f"WORKER{rank} OK", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _captures(folder) -> dict:
    """FSK and ASK captures of three 48-bit messages (a whole number of
    STFT hops on every shard) and a 10,000-sample PSK one,
    written as raw float32 (I, Q) frames."""
    rng = np.random.default_rng(21)
    caps = {}
    for kind, params in (("FSK", [-20e3, 20e3]), ("ASK", [0.0, 1.0])):
        bits = rng.integers(0, 2, 144)
        iq = modulate(bits, 100, kind.lower(), np.float32(params), pause=1200)
        iq = iq + rng.normal(0, 0.01, iq.shape)
        total = len(iq) - len(iq) % (SHARDS * HOP)
        caps[kind] = iq[:total].astype(np.float32)
    iq = modulate(rng.integers(0, 2, 100), 100, "psk", np.float32([0, np.pi]),
                  carrier_frequency=40e3)
    caps["PSK"] = (iq + rng.normal(0, 0.05, iq.shape)).astype(np.float32)
    for kind, iq in caps.items():
        iq.tofile(folder / f"{kind}.raw")
    np.save(folder / "taps.npy",
            (rng.normal(size=9) + 1j * rng.normal(size=9)).astype(np.complex64))
    (folder / "noise").write_text(repr(NOISE))
    return caps


def _run(folder, world: int) -> list:
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    workers = [subprocess.Popen([sys.executable, "-c", WORKER, port, str(rank), str(world),
                                 str(folder), str(SHARDS // world), str(WINDOW)],
                                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
               for rank in range(world)]
    outputs = communicate_with_watchdog(workers, WORKER_TIMEOUT_S)
    results = []
    for rank, (worker, out) in enumerate(zip(workers, outputs)):
        assert worker.returncode == 0 and f"WORKER{rank} OK" in out, out
        with open(folder / f"rank{rank}of{world}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    folder = tmp_path_factory.mktemp("distributed")
    caps = _captures(folder)
    return caps, folder, {world: _run(folder, world) for world in (1, 2)}


WORLDS = pytest.mark.parametrize("world", [1, 2])
KINDS = pytest.mark.parametrize("kind", ["FSK", "ASK"])


def _joined(results, key) -> np.ndarray:
    """Every rank's (offset, block) shards in order, checked to tile the
    capture, joined."""
    shards = [s for r in results for s in r[key]]
    offsets = np.cumsum([0] + [len(b) for _, b in shards[:-1]])
    assert [o for o, _ in shards] == offsets.tolist()
    return np.concatenate([b for _, b in shards])


def _decision(kind):
    return (0.0, 1.0) if kind == "FSK" else (0.25, 0.1)


@WORLDS
@KINDS
def test_pulse_lens_equal_urh_tpu_on_every_rank(runs, world, kind):
    caps, _, results = runs
    center, _ = _decision(kind)
    want = grab_pulse_lens(jax_afp_demod(caps[kind], NOISE, kind, 2), center, 5, kind, 100)
    assert len(want) > 6
    for r in results[world]:
        np.testing.assert_array_equal(r[kind, "pulses"], want)


@WORLDS
@KINDS
def test_demodulate_equals_urh_tpu(runs, world, kind):
    caps, _, results = runs
    center, spacing = _decision(kind)
    want = jax_afp_demod(caps[kind], NOISE, kind, 2)
    got = _joined(results[world], (kind, "qad"))
    states = _joined(results[world], (kind, "states"))
    np.testing.assert_allclose(got, want, atol=QAD_ATOL)
    want_states = symbol_states(want, get_center_thresholds(center, spacing, 2),
                                noise_sentinel(kind))
    np.testing.assert_array_equal(states, np.asarray(want_states))


@WORLDS
def test_fir_filter_equals_urh_tpu(runs, world):
    caps, folder, results = runs
    x = (caps["FSK"][:, 0] + 1j * caps["FSK"][:, 1]).astype(np.complex64)
    taps = np.load(folder / "taps.npy")
    want = np.convolve(x, taps)[:len(x)]
    np.testing.assert_allclose(_joined(results[world], "fir"), want, atol=FIR_ATOL)
    np.testing.assert_allclose(_joined(results[world], "fir"),
                               sharded_fir_filter(x, taps, mesh=make_mesh(4)), atol=FIR_ATOL)


@WORLDS
def test_spectrogram_equals_urh_tpu(runs, world):
    caps, _, results = runs
    x = (caps["FSK"][:, 0] + 1j * caps["FSK"][:, 1]).astype(np.complex64)
    rows = [s for r in results[world] for s in r["stft"]]
    assert [o for o, _ in rows] == np.cumsum([0] + [len(b) for _, b in rows[:-1]]).tolist()
    got = np.concatenate([b for _, b in rows])
    # urh_tpu's distributed STFT on a mesh of as many shards
    want = np.concatenate([b for _, b in _jax_spectrogram(x, make_mesh(SHARDS))])
    assert got.shape == want.shape == (len(x) // HOP, WINDOW)
    np.testing.assert_allclose(got, want, atol=STFT_ATOL)


def _jax_spectrogram(x, mesh):
    """urh_tpu's single-process distributed_spectrogram (a whole capture
    on one process's mesh)."""
    return jax_dist.distributed_spectrogram(x, window_size=WINDOW, mesh=mesh)


@WORLDS
def test_exact_psk_equals_afp_demod(runs, world):
    caps, _, results = runs
    iq = caps["PSK"]
    parts = [r["psk"] for r in results[world]]
    assert [o for o, _ in parts] == np.cumsum([0] + [len(b) for _, b in parts[:-1]]).tolist()
    got = np.concatenate([b for _, b in parts])
    port = urh_tpu_torch.afp_demod(iq, 0.01, "PSK", 2, device="cpu").numpy()
    np.testing.assert_array_equal(got, port)
    np.testing.assert_allclose(got, jax_afp_demod(iq, 0.01, "PSK", 2), atol=PSK_ATOL)


@pytest.mark.parametrize("key", [("FSK", "pulses"), ("ASK", "pulses"), ("FSK", "qad"),
                                 ("ASK", "states"), "fir", "stft", "psk"],
                         ids=lambda k: "-".join(k) if isinstance(k, tuple) else k)
def test_two_ranks_give_what_one_gives(runs, key):
    _, _, results = runs
    one, two = results[1][0][key], [r[key] for r in results[2]]
    if key[-1] == "pulses":
        for got in two:
            np.testing.assert_array_equal(got, one)
        return
    if key == "psk":
        np.testing.assert_array_equal(np.concatenate([b for _, b in two]), one[1])
        return
    np.testing.assert_array_equal(np.concatenate([b for r in two for _, b in r]),
                                  np.concatenate([b for _, b in one]))


@pytest.mark.parametrize("total,world", [(0, 1), (7, 1), (7, 2), (10, 3), (1000, 4)])
def test_process_slice_equals_urh_tpus(total, world):
    for rank in range(world):
        assert dist.process_slice(total, world, rank) == jax_dist.process_slice(total, world,
                                                                                rank)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_adjacent_runs_equals_urh_tpus(seed):
    rng = np.random.default_rng(seed)
    states = rng.integers(-1, 2, 40)
    lens = rng.integers(1, 9, 40)
    runs = np.column_stack((states, np.cumsum(lens) - lens, lens)).astype(np.int64)
    for got, want in zip(dist._merge_adjacent_runs(runs), jax_dist._merge_adjacent_runs(runs)):
        np.testing.assert_array_equal(got, want)


def test_outside_a_process_group_the_world_is_one_rank():
    assert not dist.is_distributed()
    assert dist.process_slice(10) == (0, 10)
    x = np.zeros((8, 2), np.float32)
    shards = dist.make_global_capture(x, dist.global_mesh(4, device="cpu"))
    assert [o for o, _ in shards] == [0, 2, 4, 6]


def test_entries_default_to_the_card_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((64, 2), np.float32)
    for call in (dist.global_mesh, lambda: dist.initialize("localhost:1", 1, 0),
                 lambda: dist.distributed_demodulate(x, 0.1, "FSK", 0.0, 1.0, 1),
                 lambda: dist.distributed_pulse_lens(x, 0.1, "FSK", 0.0, 1.0, 1, 5, 100),
                 lambda: dist.distributed_fir_filter(x[:, 0], np.ones(3)),
                 lambda: dist.distributed_spectrogram(x[:, 0], 8),
                 lambda: dist.distributed_psk_demod_exact(x, 0.1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
