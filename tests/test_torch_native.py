"""The port's native host runtime against urh_tpu's.

The C++ sources under urh_tpu_torch/native/src are urh_tpu's, byte for
byte, built by g++ with urh_tpu's flags into build/urh_tpu_torch/native/.
The same seeded inputs go through both packages' ring buffers (the
shared-memory Python ring and the native lock-free one), TCP streamer,
fused host block and run-length encoder, which must agree to the bit.
The port's host stream route (backend="host") must give the segments of
its device route on the CPU and of urh_tpu's host route.
"""

import filecmp
import os
import threading
import time

import numpy as np
import pytest
import torch

from urh_tpu import native as jax_native
from urh_tpu.dsp.demod import DemodParams as JaxParams
from urh_tpu.dsp.modulate import modulate
from urh_tpu.protocol import stream as jax_stream
from urh_tpu.util.ringbuffer import RingBuffer as JaxRingBuffer
from urh_tpu_torch import native
from urh_tpu_torch.dsp.demod import DemodParams
from urh_tpu_torch.native import build
from urh_tpu_torch.protocol import stream
from urh_tpu_torch.util.ringbuffer import RingBuffer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 10.0


def test_sources_are_urh_tpus_byte_for_byte():
    for name in ("ringbuffer.cpp", "net_io.cpp", "dsp_kernels.cpp"):
        assert filecmp.cmp(os.path.join(ROOT, "urh_tpu", "native", "src", name),
                           os.path.join(ROOT, "urh_tpu_torch", "native", "src", name),
                           shallow=False), name
    assert build._FLAGS == jax_native.build._FLAGS  # -ffp-contract=off included


def test_library_is_built_into_the_checkouts_build_directory():
    path = build.build()
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "urh_tpu_torch", "native")
    assert build._source_hash() in os.path.basename(path)
    assert native.is_available()
    assert not [f for f in os.listdir(build.BUILD_DIR) if f.endswith(".tmp")]


def test_failed_build_returns_none_and_the_host_route_takes_numpy(monkeypatch, tmp_path):
    """urh_tpu's semantics: without g++ get_library() is None and the host
    routes run NumPy."""
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_build_failed", False)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ here
    assert build.get_library() is None and not native.is_available()
    assert not os.listdir(tmp_path)
    x = _fsk(4)
    counts = dict(stream.HOST_ROUTE)
    sd = stream.StreamDemodulator(DemodParams(**FSK), backend="host", device="cpu")
    _run(sd, [x])
    assert stream.HOST_ROUTE["native_block"] == counts["native_block"]
    assert stream.HOST_ROUTE["numpy_block"] == counts["numpy_block"] + 1


# -- ring buffers -------------------------------------------------------------

def _rings(size):
    """The same ring in both packages, Python and native."""
    return {"urh_tpu": JaxRingBuffer(size), "urh_tpu native": jax_native.NativeRingBuffer(size),
            "port": RingBuffer(size), "port native": native.NativeRingBuffer(size)}


# (size, operations): the cases of tests/test_ringbuffer_reference.py,
# tests/test_native.py and tests/test_device_layer.py:37-75
RING_CASES = {
    "push_pop": (1024, [("push", 32), ("pop", 16), ("len",), ("pop", -1), ("empty",)]),
    "wraparound": (8, [("push", 8), ("pop", 6), ("push", 6), ("pop", -1)]),
    "wraparound_4": (4, [("push", 4), ("pop", 3), ("push", 3), ("pop", -1)]),
    "overflow": (4, [("push", 5)]),
    "overflow_2": (2, [("push", 3)]),
    "big_buffer": (5, [("push", 7)]),
    "push_to_full": (10, [("push", 5), ("fit", 6), ("push", 5), ("fit", 1), ("len",)]),
    "pop": (5, [("push", 3), ("pop", 40), ("empty",), ("push", 4), ("pop", 4), ("empty",),
                ("push", 2), ("pop", 1), ("empty",), ("push", 4), ("fit", 1), ("pop", 5)]),
    "continuous_pop": (10, [("push", 10)] + [("pop", 1)] * 10 + [("empty",)]),
    "will_fit": (8, [("space",), ("fit", 4), ("fit", 8), ("fit", 9), ("push", 4), ("space",),
                     ("fit", 3), ("fit", 4), ("fit", 5)]),
    "will_fit_5": (5, [("fit", 5), ("push", 3), ("fit", 2), ("fit", 3)]),
    "laps": (7, [("push", 5), ("pop", 4), ("push", 6), ("pop", 3), ("push", 2), ("pop", -1),
                 ("push", 7), ("pop", 0), ("pop", 7)]),
}


def _replay(ring, ops, seed):
    rng = np.random.default_rng(seed)
    out = []
    for op, *arg in ops:
        if op == "push":
            data = rng.normal(size=(arg[0], 2)).astype(np.float32)
            try:
                ring.push(data)
                out.append(("pushed", arg[0]))
            except ValueError:
                out.append("ValueError")
        elif op == "pop":
            out.append(np.asarray(ring.pop(arg[0])).reshape(-1, 2).tolist())
        elif op == "fit":
            out.append(ring.will_fit(arg[0]))
        elif op == "space":
            out.append(ring.space_left)
        elif op == "len":
            out.append(len(ring))
        else:
            out.append(ring.is_empty)
    return out


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_buffers_agree_across_packages(case):
    size, ops = RING_CASES[case]
    results = {}
    for name, ring in _rings(size).items():
        results[name] = _replay(ring, ops, seed=len(case))
        if hasattr(ring, "close"):
            ring.close()
    want = results.pop("urh_tpu")
    for name, got in results.items():
        assert got == want, name


def test_port_native_ring_concurrent_producer_consumer():
    rb = native.NativeRingBuffer(1 << 12)
    total = 1 << 16
    sent = np.random.default_rng(0).normal(size=(total, 2)).astype(np.float32)
    received = []

    def producer():
        i = 0
        while i < total:
            chunk = sent[i:i + 512]
            if rb.will_fit(len(chunk)):
                rb.push(chunk)
                i += len(chunk)
            else:
                time.sleep(0.0005)

    def consumer():
        got = 0
        while got < total:
            out = rb.pop(1024)
            if len(out):
                received.append(out)
                got += len(out)
            else:
                time.sleep(0.0005)

    threads = [threading.Thread(target=producer), threading.Thread(target=consumer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    np.testing.assert_array_equal(np.concatenate(received), sent)
    rb.close()


def test_ring_attaches_across_processes_by_name():
    """A second handle on the same shared memory sees the samples (the
    producer/consumer-in-two-processes layout)."""
    owner = native.NativeRingBuffer(64)
    data = np.arange(20, dtype=np.float32).reshape(10, 2)
    owner.push(data)
    other = native.NativeRingBuffer(64, shm_name=owner.shm_name)
    np.testing.assert_array_equal(other.pop(-1), data)
    assert owner.is_empty
    other.close()
    owner.close()


@pytest.mark.parametrize("direction", ["urh_tpu_to_port", "port_to_urh_tpu"])
def test_native_tcp_streaming_across_packages(direction):
    rx_pkg, tx_pkg = (native, jax_native) if direction == "urh_tpu_to_port" else (jax_native,
                                                                                  native)
    rb = rx_pkg.NativeRingBuffer(1 << 16)
    rx = rx_pkg.NativeSampleReceiver(rb, port=0)
    data = np.random.default_rng(1).normal(size=(5000, 2)).astype(np.float32)
    assert tx_pkg.native_send_samples("127.0.0.1", rx.port, data) == len(data)
    deadline = time.monotonic() + DEADLINE_S
    while len(rb) < len(data) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert rx.total_samples == len(data) and rx.dropped_samples == 0
    np.testing.assert_array_equal(rb.pop(-1), data)
    rx.stop()
    rb.close()


# -- the fused host block and the run-length encoder -----------------------------

BLOCK_CASES = [("FSK", 1, 0.0, 1.0), ("FSK", 2, 0.1, 0.05), ("ASK", 1, 0.1, 0.25),
               ("ASK", 2, 0.3, 0.2)]


@pytest.mark.parametrize("mod,bps,center,spacing", BLOCK_CASES)
@pytest.mark.parametrize("with_prev", [False, True])
def test_block_states_equal_urh_tpus_build(mod, bps, center, spacing, with_prev):
    rng = np.random.default_rng(17)
    x = rng.normal(0, 0.3, (1 << 15, 2)).astype(np.float32)
    x[500:600] = 0  # a gated stretch
    x[700:710, 1] = -0.0  # signed zeros on the FSK cross product
    prev = np.float32([[0.1, -0.2]]) if with_prev else None
    thr = stream.get_center_thresholds(center, spacing, 2 ** bps).astype(np.float32)
    outs = []
    for lib in (native.get_library(), jax_native.get_library()):
        states = np.empty(len(x), np.int8)
        peak = np.zeros(1, np.float32)
        lib.urh_block_states_f32(x.ctypes.data, len(x), None if prev is None else
                                 prev.ctypes.data, float(np.float32(0.05) ** 2),
                                 float(np.float32(np.sqrt(2))), 0 if mod == "ASK" else 1,
                                 thr.ctypes.data, len(thr), states.ctypes.data, peak.ctypes.data)
        outs.append((states, peak))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1].tobytes() == outs[1][1].tobytes()
    assert (outs[0][0] == -1).any() and (outs[0][0] >= 1).any()


@pytest.mark.parametrize("n_runs,cap", [(4000, 10), (4000, 100000), (1, 1), (3000, 3000)])
def test_rle_equals_urh_tpus_build(n_runs, cap):
    rng = np.random.default_rng(n_runs + cap)
    states = np.repeat(rng.integers(-1, 4, n_runs).astype(np.int8), rng.integers(1, 12, n_runs))
    outs = []
    for lib in (native.get_library(), jax_native.get_library()):
        run_states = np.zeros(cap, np.int8)
        run_lens = np.zeros(cap, np.int64)
        m = lib.urh_rle_i8(states.ctypes.data, len(states), cap, run_states.ctypes.data,
                           run_lens.ctypes.data)
        outs.append((m, run_states, run_lens))
    assert outs[0][0] == outs[1][0]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    np.testing.assert_array_equal(outs[0][2], outs[1][2])


def test_stream_rle_takes_the_native_encoder_at_urh_tpus_threshold():
    rng = np.random.default_rng(23)
    states = np.repeat(rng.integers(-1, 4, 4000).astype(np.int8), rng.integers(1, 12, 4000))
    assert len(states) >= stream.NATIVE_MIN_SAMPLES
    before = stream.HOST_ROUTE["native_rle"]
    got = stream._rle(states)
    assert stream.HOST_ROUTE["native_rle"] == before + 1
    want = jax_stream._rle(states)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    stream._rle(states[:stream.NATIVE_MIN_SAMPLES - 1])  # below: NumPy
    assert stream.HOST_ROUTE["native_rle"] == before + 1


# -- the stream's host route --------------------------------------------------------

FSK = dict(modulation="FSK", samples_per_symbol=20, center=0.0, noise_threshold=1e-2,
           tolerance=3)
FSK4 = dict(modulation="FSK", samples_per_symbol=20, bits_per_symbol=2, center=0.0,
            center_spacing=2 * np.pi * 20e3 / 1e6, noise_threshold=1e-2, tolerance=3)
ASK = dict(modulation="ASK", samples_per_symbol=20, center=0.3, noise_threshold=1e-2,
           tolerance=3)


def _fsk(n_copies, seed=0):
    bits = np.resize(np.array([1, 0, 1, 1, 0, 0, 1, 0], np.uint8), 64)
    one = modulate(bits, 20, "fsk", [-20e3, 20e3], sample_rate=1e6, pause=1200)
    x = np.tile(one, (n_copies, 1))
    return (x + np.random.default_rng(seed).normal(0, 0.002, x.shape)).astype(np.float32)


def _fsk4(n_copies):
    bits = np.resize(np.array([1, 0, 1, 1, 0, 0, 1, 0], np.uint8), 64)
    one = modulate(bits, 20, "fsk", [-30e3, -10e3, 10e3, 30e3], sample_rate=1e6,
                   bits_per_symbol=2, pause=1200)
    x = np.tile(one, (n_copies, 1))
    return (x + np.random.default_rng(3).normal(0, 0.002, x.shape)).astype(np.float32)


def _ask(n_copies):
    bits = np.resize(np.array([1, 0, 1, 1, 0, 0, 1, 1], np.uint8), 64)
    one = modulate(bits, 20, "ask", [0.0, 1.0], sample_rate=1e6, pause=1200)
    x = np.tile(one, (n_copies, 1)) * 0.9
    return (x + np.random.default_rng(1).normal(0, 0.002, x.shape)).astype(np.float32)


def _run(sd, chunks):
    segments = []
    for c in chunks:
        segments += sd.feed(c)
    return segments + sd.flush()


def _key(segments):
    return [(s.start_sample, s.num_samples, np.asarray(s.ppseq).tolist()) for s in segments]


HOST_CASES = {"fsk": (FSK, lambda: _fsk(40)), "fsk4": (FSK4, lambda: _fsk4(40)),
              "ask": (ASK, lambda: _ask(40))}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
@pytest.mark.parametrize("chunk", [1 << 14, 20011])
def test_host_route_equals_the_device_route_and_urh_tpus(case, chunk):
    params, capture = HOST_CASES[case]
    x = capture()
    chunks = [x[i:i + chunk] for i in range(0, len(x), chunk)]
    big = sum(len(c) >= stream.NATIVE_MIN_SAMPLES for c in chunks)
    before = dict(stream.HOST_ROUTE)
    host = _run(stream.StreamDemodulator(DemodParams(**params), backend="host", device="cpu"),
                chunks)
    assert stream.HOST_ROUTE["native_block"] - before["native_block"] == big >= 2
    assert stream.HOST_ROUTE["numpy_block"] - before["numpy_block"] == len(chunks) - big
    assert stream.HOST_ROUTE["native_rle"] - before["native_rle"] == big
    device = _run(stream.StreamDemodulator(DemodParams(**params), backend="device",
                                           device="cpu"), chunks)
    want = _run(jax_stream.StreamDemodulator(JaxParams(**params), backend="host"), chunks)
    assert len(host) >= 10
    assert _key(host) == _key(device) == _key(want)


def test_auto_backend_host_verdict_takes_the_native_block(monkeypatch):
    """The host verdict of "auto" runs the same host route."""
    monkeypatch.setattr(stream, "_BACKEND_VERDICTS", {("FSK", "cpu"): "host"})
    x = _fsk(40)
    chunks = [x[i:i + (1 << 14)] for i in range(0, len(x), 1 << 14)]
    before = stream.HOST_ROUTE["native_block"]
    sd = stream.StreamDemodulator(DemodParams(**FSK), backend="auto", device="cpu")
    got = _run(sd, chunks)
    assert sd.backend == "host"
    assert stream.HOST_ROUTE["native_block"] - before == len(chunks) - 1  # a short tail
    want = _run(jax_stream.StreamDemodulator(JaxParams(**FSK), backend="host"), chunks)
    assert _key(got) == _key(want)
