#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (urh_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py        # from the repository root, one card

1. Build the CUDA kernels from ``urh_tpu_torch/csrc`` and identify the card.
2. Kernels: each of the four fused demod kernels against its plain PyTorch
   version on the same CUDA tensors at N = 1, 2, 15, 16, 17 (around the
   int8 kernels' 16 samples per thread), 1000, 1029 (a ragged tail on
   lane 0 of a warp), 2^24 and 2^24 + 17 (qad max-abs error <= 1e-6, 0
   state mismatches); the int8 kernels against the float32 ones on the
   same capture, on a view 2 bytes past an aligned allocation (which
   their wrappers copy first), and K4 over all 65,536 int8 (I, Q) pairs
   for a grid of thresholds and max_mag; each kernel and plain version
   timed at 2^24 with CUDA events beside the kernel's memory bound, and
   the int8 kernels also at 2^26 beside a copy of the same traffic.
3. Main path: ``urh_tpu_torch.demodulate`` on the default device for
   2^24-sample FSK and ASK captures (about 8.4 s of a 2 Msps receiver,
   367 messages of 256 random bits each), as float32 and as int8; every
   message must come back bit-exact and every kernel of the path must have
   been launched by it.

Every failed check raises.  The last two lines are a JSON ``kernels``
summary and ``{"ok": true, "device": {...}}``.  Without a CUDA card the
script exits non-zero before it prints any result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch

N_FULL = 1 << 24
N_STREAM = 1 << 26  # the int8 kernels timed here too: launch and ramp-up
                    # weigh less, the streaming rate more
KERNEL_SIZES = (1, 2, 15, 16, 17, 1000, 1029, N_FULL, N_FULL + 17)
QAD_ATOL = 1e-6
TIMED_RUNS = 25

# H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SOURCE = "urh_tpu_torch/csrc/fused_demod.cu"
PALLAS = "urh_tpu/dsp/pallas_kernels.py"

# bytes/sample: each input read once, each output written once.
# ops/sample: every arithmetic op, comparison, select and int->float
# conversion counted as one, atan2f as 20 (its polynomial and division).
KERNELS = {
    "fsk_f32": dict(name="fused_fsk_demod_symbolize", replaces=f"{PALLAS}:128",
                    bytes_per_sample=8 + 4 + 4, ops_per_sample=9 + 20 + 4),
    "fsk_i8": dict(name="fused_fsk_symbolize_i8", replaces=f"{PALLAS}:201",
                   bytes_per_sample=2 + 1, ops_per_sample=4 + 9 + 1 + 8),
    "ask_f32": dict(name="fused_ask_demod_symbolize", replaces=f"{PALLAS}:269",
                    bytes_per_sample=8 + 4 + 4, ops_per_sample=3 + 2 + 4),
    "ask_i8": dict(name="fused_ask_symbolize_i8", replaces=f"{PALLAS}:319",
                   bytes_per_sample=2 + 1, ops_per_sample=2 + 3 + 2 + 3),
}

# kernel-phase parameters (raw units): noise magnitude, threshold, max_mag
F32_FSK = dict(noise=0.1, thr=0.0)
I8_FSK = dict(noise=10.0, thr=0.0)
F32_ASK = dict(noise=0.1, thr=0.3, max_mag=math.sqrt(2.0))
I8_ASK = dict(noise=10.0, thr=0.3, max_mag=math.sqrt(127 * 127 + 128 * 128))


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over TIMED_RUNS runs after warm-up, with
    the 50 MB L2 flushed before each run by zeroing ``flush`` (the main
    path finds its capture cold)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        flush.zero_()  # keeps the card busy while the host enqueues fn
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_inputs(n: int, seed: int):
    """Seeded float32 and int8 (n, 2) captures with silent stretches (the
    noise gate) as in tests/test_pallas_kernels.py, on the host."""
    rng = np.random.default_rng(seed)
    f32 = rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    i8 = rng.normal(0, 40, (n, 2)).clip(-128, 127).astype(np.int8)
    for lo in range(100, n, max(n // 16, 1000)):  # silent stretches
        f32[lo:lo + 200] *= 0.001
        i8[lo:lo + 200] = 0
    return f32, i8


def compare(got, want):
    """-> (max abs error, state mismatches) of a kernel's output against its
    plain version's: the error is qad's for the (qad, states) kernels and
    the states' own for the states-only ones."""
    err = None
    if isinstance(got, tuple):
        err = (got[0] - want[0]).abs().max().item()
        got, want = got[1], want[1]
    diff = got.to(torch.int32) - want.to(torch.int32)
    return (diff.abs().max().item() if err is None else err), int(diff.count_nonzero())


def kernel_phase(device, sizes=KERNEL_SIZES, timed_n=N_FULL) -> dict:
    """Check every kernel against its plain version; time both at timed_n."""
    from urh_tpu_torch.dsp import fused_kernels as fk

    f32_all, i8_all = kernel_inputs(max(sizes), seed=3)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=device)
    nsq = {dtype: float(np.float32(p["noise"] ** 2))
           for dtype, p in (("f32", F32_FSK), ("i8", I8_FSK))}
    err = {k: 0.0 for k in KERNELS}
    mismatch = {k: 0 for k in KERNELS}
    timings = {}
    for n in sizes:
        xf = torch.from_numpy(f32_all[:n]).to(device)
        xi = torch.from_numpy(i8_all[:n]).to(device)
        i8 = i8_calls(xi, nsq["i8"])
        calls = {
            "fsk_f32": (fk.fused_fsk_demod_symbolize, fk.fused_fsk_demod_symbolize_plain,
                        (xf, nsq["f32"], F32_FSK["thr"])),
            "fsk_i8": i8["fsk_i8"],
            "ask_f32": (fk.fused_ask_demod_symbolize, fk.fused_ask_demod_symbolize_plain,
                        (xf, nsq["f32"], F32_ASK["thr"], F32_ASK["max_mag"])),
            "ask_i8": i8["ask_i8"],
        }
        for key, (kernel, plain, args) in calls.items():
            got = kernel(*args)
            torch.cuda.synchronize()  # a fault in the kernel shows here
            e, bad = compare(got, plain(*args))
            err[key] = max(err[key], e)
            mismatch[key] += bad
            if n == timed_n:
                timings[key] = (time_ms(lambda: kernel(*args), flush),
                                time_ms(lambda: plain(*args), flush))
        # the int8 comparison kernels decide as the float32 kernels do on
        # the same capture converted to float32
        xi_f = xi.to(torch.float32)
        k2_vs_k1 = compare(fk.fused_fsk_symbolize_i8(xi, nsq["i8"], I8_FSK["thr"]),
                           fk.fused_fsk_demod_symbolize(xi_f, nsq["i8"], I8_FSK["thr"])[1])[1]
        k4_vs_k3 = compare(
            fk.fused_ask_symbolize_i8(xi, nsq["i8"], I8_ASK["thr"], I8_ASK["max_mag"]),
            fk.fused_ask_demod_symbolize(xi_f, nsq["i8"], I8_ASK["thr"], I8_ASK["max_mag"])[1])[1]
        print(f"kernels n={n}: max_abs_err {err}, state mismatches {mismatch}, "
              f"K2 vs K1 mismatches {k2_vs_k1}, K4 vs K3 mismatches {k4_vs_k3}",
              flush=True)
        if k2_vs_k1 or k4_vs_k3:
            raise AssertionError(f"int8 kernels disagree with float32 ones at n={n}")
        if n == max(sizes):
            for key, bad in unaligned_check(xi, nsq["i8"]).items():
                mismatch[key] += bad
    for key, bad in ask_i8_all_pairs_check(device).items():
        mismatch[key] += bad
    for key in KERNELS:
        limit = QAD_ATOL if key.endswith("f32") else 0.0
        if mismatch[key] or err[key] > limit:
            raise AssertionError(f"{key}: max_abs_err {err[key]}, "
                                 f"{mismatch[key]} state mismatches")
    return {"err": err, "mismatch": mismatch, "timings": timings}


def i8_calls(x, noise_sqrd):
    """int8 kernel key -> (kernel, plain version, arguments) on capture x."""
    from urh_tpu_torch.dsp import fused_kernels as fk

    return {
        "fsk_i8": (fk.fused_fsk_symbolize_i8, fk.fused_fsk_symbolize_i8_plain,
                   (x, noise_sqrd, I8_FSK["thr"])),
        "ask_i8": (fk.fused_ask_symbolize_i8, fk.fused_ask_symbolize_i8_plain,
                   (x, noise_sqrd, I8_ASK["thr"], I8_ASK["max_mag"])),
    }


def unaligned_check(xi, noise_sqrd) -> dict:
    """The int8 kernels on a view 2 bytes past an aligned allocation: each
    wrapper copies it (counted) and still launches; -> state mismatches
    against the plain versions on the view."""
    from urh_tpu_torch.dsp import fused_kernels as fk

    buf = torch.empty((len(xi) + 1, 2), dtype=torch.int8, device=xi.device)
    view = buf[1:]
    view.copy_(xi)
    copies, launches = dict(fk.ALIGNMENT_COPIES), dict(fk.LAUNCHES)
    mismatch = {}
    for key, (kernel, plain, args) in i8_calls(view, noise_sqrd).items():
        got = kernel(*args)
        torch.cuda.synchronize()
        mismatch[key] = compare(got, plain(*args))[1]
        if view.is_cuda and (fk.ALIGNMENT_COPIES[key] != copies[key] + 1
                             or fk.LAUNCHES[key] != launches[key] + 1):
            raise AssertionError(f"{key}: an unaligned view was not copied and launched")
    print(f"kernels on a view at byte offset {view.data_ptr() % 16}, n={len(view)}: "
          f"state mismatches {mismatch}, alignment copies {fk.ALIGNMENT_COPIES}",
          flush=True)
    return mismatch


def ask_i8_all_pairs_check(device) -> dict:
    """K4 against its plain version over every int8 (I, Q) pair (after a
    copy of the first, since sample 0 is -1), for a grid of noise levels,
    thresholds and max_mag (0: the envelope is inf; < 0: a step down)."""
    from urh_tpu_torch.dsp import fused_kernels as fk

    v = torch.arange(-128, 128, dtype=torch.int8)
    pairs = torch.stack(torch.meshgrid(v, v, indexing="ij"), -1).reshape(-1, 2)
    x = torch.cat((pairs[:1], pairs)).to(device)
    bad = cases = 0
    for noise_sqrd in (0.0, 1.0, 100.0):
        for max_mag in (I8_ASK["max_mag"], 1.0, 0.0, -1.0):
            for thr in (-0.3, 0.0, 0.3, 0.9999, 1.0, 1.5):
                got = fk.fused_ask_symbolize_i8(x, noise_sqrd, thr, max_mag)
                torch.cuda.synchronize()
                bad += compare(got, fk.fused_ask_symbolize_i8_plain(
                    x, noise_sqrd, thr, max_mag))[1]
                cases += 1
    print(f"ask_i8 over all 65536 int8 pairs, {cases} parameter sets: "
          f"{bad} state mismatches", flush=True)
    return {"ask_i8": bad}


def stream_phase(device):
    """The int8 kernels and a copy of their traffic (x[:, 0].clone() reads
    2 B and writes 1 B per sample) timed at N_FULL and N_STREAM."""
    _, i8 = kernel_inputs(N_FULL, seed=3)
    noise_sqrd = float(np.float32(I8_FSK["noise"] ** 2))
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=device)
    x_full = torch.from_numpy(i8).to(device)
    for n, x in ((N_FULL, x_full), (N_STREAM, x_full.repeat(N_STREAM // N_FULL, 1))):
        bound = KERNELS["fsk_i8"]["bytes_per_sample"] * n / HBM_BYTES_PER_S * 1e3
        calls = {key: (lambda f=kernel, a=args: f(*a))
                 for key, (kernel, _, args) in i8_calls(x, noise_sqrd).items()}
        calls["copy"] = lambda x=x: x[:, 0].clone()
        ms = {key: time_ms(fn, flush) for key, fn in calls.items()}
        print(f"stream n={n}: " + ", ".join(
            f"{key} {t} ms ({bound / t:.1%} of the {bound} ms bound)"
            for key, t in ms.items()), flush=True)


def make_capture(kind: str, n: int, seed: int, sps: int = 100, n_bits: int = 256,
                 pause: int = 20000):
    """Synthetic float32 (n, 2) capture: [pause, message] * k + trailing
    pause, messages of n_bits random bits at sps samples per bit, amplitude
    0.75 plus Gaussian noise of sigma 0.01.  FSK is continuous-phase at
    +-25 kHz of 1 Msps; ASK is on/off keying of a 10 kHz tone, every
    message starting and ending with a 1 (an ASK zero is silence)."""
    rng = np.random.default_rng(seed)
    period = pause + n_bits * sps
    n_msgs = n // period
    bits = rng.integers(0, 2, (n_msgs, n_bits), dtype=np.uint8)
    if kind == "ASK":
        bits[:, 0] = bits[:, -1] = 1
    sym = np.zeros((n_msgs, pause + n_bits * sps), dtype=np.int8)  # -1 silent
    sym[:, :pause] = -1
    sym[:, pause:] = np.repeat(bits, sps, axis=1)
    sym = np.concatenate((sym.ravel(), np.full(n - n_msgs * period, -1, np.int8)))
    on = sym >= 0
    if kind == "FSK":
        step = np.where(sym == 1, 1.0, -1.0) * (2 * np.pi * 25e3 / 1e6)
        phase = np.cumsum(step)
        amp = 0.75 * on
    else:
        phase = np.arange(n) * (2 * np.pi * 10e3 / 1e6)
        amp = 0.75 * (sym == 1)
    iq = np.empty((n, 2), dtype=np.float32)
    iq[:, 0] = amp * np.cos(phase)
    iq[:, 1] = amp * np.sin(phase)
    iq += rng.normal(0, 0.01, (n, 2)).astype(np.float32)
    return iq, bits


def demod_params(kind: str, dtype):
    from urh_tpu_torch import DemodParams

    scale = 127.0 if dtype == np.int8 else 1.0  # raw units of the capture
    # ASK zeros are silence, so runs of zero bits inside a message are
    # pauses: the 200-symbol message gap is told apart by a pause
    # threshold of 100 symbols
    return DemodParams(modulation=kind, samples_per_symbol=100,
                       center=0.0 if kind == "FSK" else 0.25,
                       noise_threshold=0.15 * scale, tolerance=5,
                       pause_threshold=8 if kind == "FSK" else 100)


def to_int8(iq: np.ndarray) -> np.ndarray:
    return np.clip(np.round(iq * 127), -128, 127).astype(np.int8)


def check_messages(messages, bits, label: str):
    if len(messages) != len(bits):
        raise AssertionError(f"{label}: {len(messages)} messages, sent {len(bits)}")
    for i, (msg, sent) in enumerate(zip(messages, bits)):
        if not np.array_equal(np.frombuffer(bytes(msg.plain_bits), np.uint8), sent):
            raise AssertionError(f"{label}: message {i} differs from the sent bits")


def main_path_phase(device, n: int):
    """demodulate() on each capture; -> (launch counts, wall times)."""
    import urh_tpu_torch as ut
    from urh_tpu_torch.dsp import fused_kernels as fk

    runs = []
    for kind, seed in (("FSK", 11), ("ASK", 12)):
        iq, bits = make_capture(kind, n, seed)
        runs.append((kind, "float32", iq, bits, "fsk_f32" if kind == "FSK" else "ask_f32"))
        runs.append((kind, "int8", to_int8(iq), bits, "fsk_i8" if kind == "FSK" else "ask_i8"))

    for counts in (fk.LAUNCHES, fk.ALIGNMENT_COPIES):
        for key in counts:
            counts[key] = 0
    walls = {}
    for kind, dtype, iq, bits, key in runs:
        before = fk.LAUNCHES[key]
        t0 = time.perf_counter()
        messages = ut.demodulate(ut.Signal.from_iq(iq, device=device),
                                 demod_params(kind, iq.dtype))
        wall = time.perf_counter() - t0
        label = f"{kind} {dtype}"
        check_messages(messages, bits, label)
        if fk.LAUNCHES[key] == before:
            raise AssertionError(f"{label}: kernel {key} was not launched")
        walls[label] = wall
        print(f"main path {label}: {len(messages)} messages bit-exact, "
              f"wall {wall:.6f} s", flush=True)
    launches = dict(fk.LAUNCHES)
    missing = [k for k in KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    # the staged captures are fresh allocations: no int8 kernel input copied
    if any(fk.ALIGNMENT_COPIES.values()):
        raise AssertionError(f"main path copied unaligned captures: {fk.ALIGNMENT_COPIES}")
    print(f"main path launches {launches}, alignment copies {fk.ALIGNMENT_COPIES}",
          flush=True)
    return launches, walls


def card_vs_cpu_phase(n: int = 200000):
    """The port on the card gives the same messages as on the CPU (plain
    versions) for a short capture of each kind and dtype."""
    import urh_tpu_torch as ut

    for kind, seed in (("FSK", 21), ("ASK", 22)):
        iq, _ = make_capture(kind, n, seed)
        for x in (iq, to_int8(iq)):
            got = ut.demodulate(x, demod_params(kind, x.dtype), device="cuda")
            want = ut.demodulate(x, demod_params(kind, x.dtype), device="cpu")
            same = ([(m.plain_bits, m.pause, list(m.bit_sample_pos)) for m in got]
                    == [(m.plain_bits, m.pause, list(m.bit_sample_pos)) for m in want])
            if not same or not got:
                raise AssertionError(f"{kind} {x.dtype}: card and CPU messages differ")
    print("card vs CPU: messages equal for FSK/ASK float32/int8", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is available")
    from urh_tpu_torch import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)
    identity = card_identity()

    kernels = kernel_phase("cuda")
    stream_phase("cuda")
    launches, _ = main_path_phase(None, N_FULL)  # None: the default device
    card_vs_cpu_phase()

    rows = []
    for key, k in KERNELS.items():
        ms, plain_ms = kernels["timings"][key]
        byte_ms = k["bytes_per_sample"] * N_FULL / HBM_BYTES_PER_S * 1e3
        op_ms = k["ops_per_sample"] * N_FULL / FP32_OPS_PER_S * 1e3
        rows.append({
            "name": k["name"], "route": "cuda", "source": SOURCE,
            "replaces": k["replaces"], "launches": launches[key],
            "max_abs_err": kernels["err"][key],
            "state_mismatches": kernels["mismatch"][key],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": None,
        })
        print(f"{k['name']}: {ms:.4f} ms (bound {max(byte_ms, op_ms):.4f} ms, "
              f"{rows[-1]['bound_by']}), plain {plain_ms:.4f} ms, "
              f"launches {launches[key]}", flush=True)
    print(json.dumps({"kernels": rows}))
    print(identity)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
