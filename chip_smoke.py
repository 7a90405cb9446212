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
   The Costas loop (B5): its sincosf against torch.sin and torch.cos over
   every float32 in [-4*pi, 4*pi] (the same bits); against its plain
   version at N = 1, 2, 3, 1000 and 2^14, loop orders 2 and 4, on a
   capture with gated stretches (qad max-abs error 0, the final carry
   equal), from carries of phase +-13 and +-100 (the wrap's fmodf
   branch), and 7 uneven chained chunks against one shot; then called as
   the main path calls it on the 2^22-sample BPSK capture (offline over
   x[1:], streamed chunk by chunk) against the plain loop run in
   2048-sample pieces side by side, each from its chained carry; timed at
   2^22 (3 runs) beside its chain-latency bound, the plain loop at 2^14
   (1 run).  The stream block (B6) against its plain version at N = 1, 2,
   17, 1000, one below, at, one past and twice plus one each kernel tile
   (1,024 float32 and 4,096 int8 samples), 2^17, 2^17 + 1 and 2^17 + 5,
   with and without the halo, float32 and int8 ingest, ASK and FSK,
   binary and 8-ary, on a capture whose one pause spans every tile, and
   on alternating states that overflow cap, with cap around a tile
   boundary (bundles, and states by the states-only launch, equal to the
   bit, max-abs error 0); bundles also at 2^22 and 2^24 (float32) and
   2^24 and 2^25 (int8), where tiles take 2 and 4 groups a thread; timed
   per 2^17-sample chunk and at 2^24.
3. Main path, offline: ``urh_tpu_torch.demodulate`` on the default device
   for 2^24-sample FSK and ASK captures (about 8.4 s of a 2 Msps receiver,
   367 messages of 256 random bits each), as float32 and as int8, and for
   a 2^22-sample BPSK capture (91 messages after a lock-in burst); every
   message must come back bit-exact and every kernel of the path must have
   been launched by it (the Costas loop once).
4. Main path, streaming: ``StreamDemodulator(backend="device")`` over the
   2^24-sample FSK captures, float32 and int8, in 2^17-sample chunks: all
   367 messages bit-exact, one stream block launch a chunk, no fallback to
   per-sample states, each dtype streamed twice in turns; the BPSK
   capture streamed, its segments the offline pulse runs, one Costas
   launch a chunk; stream segments on the card equal those on the CPU,
   also for a capture whose runs overflow every bundle (the states-only
   launch).
5. B7, the median filter: the kernel each k takes (the window kernel up
   to 16, its outputs a thread and a block, registers; the rank count
   above), then against its plain version on the same CUDA tensors at k =
   1, 2, 3, 11, 12, 16, 17, 64, 65 and W = 1, k - 1, k, k + 1, 1000, 2^14 +
   3, one below, at and past the kernel's run of outputs a thread and its
   block's tile, on rows with ties, +-0.0, +-inf and NaN, at the main
   path's shapes (2 x 100 rows of 16,368 and 2 x 24 of 65,520) and on
   70,000 rows (more than a grid is high): every word equal; timed at 2 x
   100 x 16,368 and at 2^25 cells beside its bound, its plain version and
   unfold().median().
6. Main path, estimation: ``urh_tpu_torch.estimate`` and
   ``Signal.auto_detect`` on the default device for the 2^24-sample FSK and
   ASK captures (float32, int8), the 2^22-sample BPSK capture and
   bench.py's estimate capture (24 messages of 800 bits, about 2.9 M
   samples): each estimated as made (modulation, 100 samples a bit), B7
   launched once a width bucket, the Costas loop once for PSK; then
   ``demodulate()`` at the estimated parameters decodes every FSK message
   bit-exactly (the exact messages of the others are counted); the BPSK
   capture with 10 more silent samples ahead estimated as PSK at 100 with
   tolerance 0 (ROADMAP C1).  The same
   captures cut short give the same estimate and decisions on the card and
   on the CPU.  Each estimate runs each pass of the power gate once.  The
   power gate's kernel against its plain version on the same CUDA tensors,
   every ingest dtype at n = 0-4, 99, around its 4,096-sample tile, 20,011
   and 409,617, at three gate levels; at 2^24 samples (float32, int8) its
   noise level and segments equal the host path's; each pass timed there
   beside its bound and its plain version.
7. TX: ``Modulator.modulate`` for ASK, FSK, GFSK, PSK and OQPSK, 1 and 2
   bits a symbol, float32/int8/int16, at a 2^21-sample body, on the card
   against the CPU (float32 within 4 ulps of the amplitude, integers
   within 1), and a 2^24-sample FSK capture synthesized on the card,
   estimated and decoded back to its bits; the synthesis rate printed.
8. B8, the IIR feedback: against its plain loop on the same CUDA tensors
   for 1, 2, 4, 5, 9 and 40 taps (the register ring holds 8) at n = 1,
   N + 1, N + 2, 1000, 1023-1025 (its tile) and, up to 9 taps, 2^14, on
   sums with both planes non-zero, +-0 and a row of +-1e30: every word
   equal; the chain step's latency measured by clock64; timed at 2^22
   samples for 1, 4 and 9 taps beside its chain bound, the plain loop at
   2^14.
9. Filters, spectrum and plot paths, on the default device:
   ``Signal.filter_range`` with a 51-tap band-pass over the 2^24-sample
   FSK captures (float32, int8) with qad cached, then ``demodulate()``
   from the re-demodulated qad and, with the cache dropped, through K1 /
   K2 (launched once each): all 367 messages bit-exact both times; the
   first 2^20 filtered samples equal to the port's on the CPU (float32
   within 1e-3, int8 within 1); ``iir_filter`` as a DC blocker and a
   4th-order Butterworth over the capture against scipy's lfilter in
   float64 (within 1e-3 of max|y|), one B8 launch each;
   ``Spectrogram(window_size=1024).create_spectrogram_image()`` (32,767
   frames): dB within 0.05 of the CPU's at or above -100 dB with the same
   non-finite cells, colour indices within 1 on every cell, the tones'
   peak bins at +-25 kHz;
   ``create_path``: 5,000 pixels, min/max equal to the CPU's.
10. awre: ``FormatFinder.run(10)`` over bench.py's 1,000-message protocol
   on the card and on the CPU: the same message types, labels and members,
   the messages unchanged; ``ProtocolAnalyzer.auto_assign_labels()`` on the
   default device; ``to_pcapng`` written under ``build/``.  Walls printed.
11. The live loop, on the default device.  The native host library (g++)
   must build, and the stream's host route (its fused block and run-length
   encoder, counted) must give the device route's segments of the FSK
   capture.  A ``ProtocolSniffer`` over the Network SDR in raw mode (port 0)
   receives the 2^24-sample float32 FSK capture and then silence of two
   pause gates from a Network SDR sender, and once those are fed one gate
   more (a continuing stream's next drain): all 367 messages bit-exact in
   order, one stream block launch a drain (``sniffer.demodulate``'s calls),
   no fallback, no host block; the drains' sizes, the wall from the first
   sample received to the last message and the rates printed.  The same
   for the 2^22-sample BPSK capture: the bit lists of ``demodulate()`` on
   the card, one Costas launch a drain.  The FSK run again under
   ``torch.profiler``: the card's busy share of the live wall (kernels,
   copies and fills).  TX: 64 messages of 256 random bits, one 8-bit label
   fuzzed over 16 values, through ``GeneratorBackend`` on the card (equal to
   the CPU's within 4 ulps) and a sending ``VirtualDevice`` back to a
   sniffer, then through ``ContinuousModulator``'s spawned child on the card
   and a continuous-send ``VirtualDevice``: every message back bit-exact,
   the child exits 0 on its own.  The default receive buffer (5e7 samples)
   holds every capture with its silence, and the phase fails if its index
   ever wrapped (a wrap splices stale samples into the stream: ROADMAP §C,
   C5); it fails on any exception raised on a thread.
12. The simulator, on the default device.  A ``ProjectManager`` with Alice
   (played here) and Bob (simulated), one FSK ``Modulator`` at 100 samples
   a bit; Alice -> Bob 256 bits (preamble 16, sync 16, sequence number 8
   and data 200 live, a CRC-16 over both), Bob -> Alice 256 bits (sequence
   number ``item1.sequence_number + 1``, constant data, the CRC
   recomputed), 32 rounds, then a counter and a rule that sleeps 0.5 s
   after the last answer (ROADMAP §C, C7).  The simulator's sniffer (a
   Network SDR in raw mode, the stream on the card) and its EndlessSender
   (a Network SDR) run as a user's would; each round Alice sends a fresh
   random sequence number and data, a pause gate of silence, and once that
   is fed one gate more, then reads Bob's answer and decodes it with
   ``demodulate()`` on the card: every answer's sequence number Alice's +
   1 with a valid CRC, 64 transcript entries in order, no receive timeout,
   mismatch, lost message or "Devices not ready" in the log, "Finished",
   one stream block launch a drain with no fallback,
   ``Modulator.modulate`` on the card 32 times, no exception on a thread;
   each round's wall printed.
13. RTL-TCP's live int8 path, on the default device.  A loopback fake
   rtl_tcp server streams the 2^24-sample FSK capture as unsigned 8-bit
   IQ (the int8 capture + 128), then two pause gates of silence, and once
   those are fed one gate more, to a ``ProtocolSniffer(device="RTL-TCP")``
   through its spawned ``RTLSDRTCP`` child and the int8 receive buffer:
   all 367 messages bit-exact in order and equal to ``demodulate()``'s of
   the int8 capture on the card (K2), one ``urh_stream_block_i8`` launch a
   drain (no float32 ingest, no fallback, no host block), no wrap, the
   startup commands in the registry's order, the child's exit code 0, no
   exception on a thread, and a live rate above 3.2 Msps (the RTL2832U's
   highest); the child's time to connect, the drains and the rate printed.
14. Sharding and distribution.  B9, the batch of Costas streams, against
   its plain version on every word and final carry for C = 1, 2, 3, 33,
   132 and one past the streams the card runs at once (the occupancy API's
   blocks an SM times the SMs), L = 1, 2, 3, 31, 32, 33, 2049 and 5000,
   loop orders 2 and 4, rows 16-byte aligned and half a chunk late, every
   7th row wholly gated, carries of phase 1.5, +-13 and +-100, and at C =
   132, L = 4096 where its plain time is taken; on the 2^22-sample BPSK
   capture's streams at C = 8 and 132 (margin 4096) against the plain
   batch (each row in pieces of 2,048 samples from the kernel's carries
   there, every piece's end carry checked) and against B5 row by row, and
   timed there beside its chain bound.  Then, on 8
   shards of the default device: ``sharded_demodulate`` of the 2^24-sample
   FSK and ASK captures (float32) equal to the unsharded
   ``afp_demod_vec`` and ``symbol_states`` to the bit, and
   ``sharded_pulse_lens`` decoding all 367 messages of each;
   ``sharded_fir_filter`` (the 51-tap band-pass) within 1e-2 of
   ``fir_filter`` and ``sharded_spectrogram`` within 1e-4 of
   ``Spectrogram.stft``; ``sharded_psk_demod_exact`` equal to
   ``afp_demod`` to the bit (8 B5 launches); ``sharded_psk_demod`` at C =
   8 and 132 (one B9 launch each), its exact messages of the 91 printed,
   not asserted; then ``distributed_pulse_lens`` and
   ``distributed_psk_demod_exact`` at world size 1 on NCCL in a spawned
   child, reading raw captures with ``read_capture_slice``, equal to the
   sharded results.  Walls printed.
15. Placement, ``device="auto"``, in a temporary config dir: the link
   signature, the dispatch probe and the transfer cost a byte each way
   (pageable and pinned) printed; ``estimate()`` of the 2^24-sample FSK
   capture, ``afp_demod`` at 2^24 and 2^12 samples, the spectrogram image
   at 2^24, ``median_filter_rows`` at the bucket (2 x 100 rows of 16,368,
   k = 11; B7 on the card) and ``modulate`` with 2^21- and 2^16-sample
   bodies, each forced to the card, forced to the CPU and placed: its
   verdict and three walls printed, the placed result equal to the forced
   one of its side (to the word), B7's launches in the placed calls
   counted (at least one); a second placed median runs one route (B7's
   counter and ``placement.ROUTES``); rows already on the card stay there
   under ``"auto"`` (one B7 launch, no route, the forced card's result);
   ``FormatFinder.run(10)`` over
   bench.py's 1,000 messages on the card, on the CPU and placed twice,
   the first racing and the second replaying every key with one route, the
   same types and labels each time; the store holds the link's verdicts,
   and a fresh child replays them without racing; a race whose card route
   raises lets the exception out and keeps no verdict.
16. The CLI and the UI's model layer, on the default device
   (URH_TPU_TORCH_DEVICE unset), in a temporary config dir, calling
   ``urh_tpu_torch.cli.main`` in this process: ``--estimate -file
   capture.complex --hex`` of phase 6's 2^24-sample FSK capture (its quiet
   lead leaves room for 360 messages): FSK at 100 samples a bit, every
   message printed equal to the sent bits, B7 once a width bucket and K1
   once; the same command as ``python -m urh_tpu_torch.cli`` in its own
   process prints the same lines.  ``-tx -d "Network SDR"`` of the 367
   messages of the FSK capture (a messages file, 20 ms pauses, FSK at
   -25/+25 kHz) to a loopback receiver: every sample equal to
   ``Modulator.modulate``'s of its message, the pauses zero, and
   ``demodulate()`` of them (K1) gives the 367 messages.  ``-rx -d
   RTL-TCP -rt 20 -file out.txt`` fed by the fake rtl_tcp server streaming
   the int8 capture (the CLI's sniffer pointed at it: ROADMAP C6): the file
   holds the 367 messages, ``urh_stream_block_i8`` once a drain, the child
   exits 0.  Then the undo stack on a ``Signal`` of the float32 capture with
   its protocol: the 51-tap band-pass over the whole capture (367 messages),
   muting the first message and its pause (366: a muted FSK range decodes
   as zeros joined to the next message, as in urh_tpu), an InsertSine of
   10,000 samples into the first pause (368, one of ones); after each undo
   the samples equal the original to the word and ``demodulate`` through K1
   gives the 367 messages.  Walls printed.
17. The web app (``urh_tpu_torch.ui.web``), on the default device
   (URH_TPU_TORCH_DEVICE unset), served in this process on 127.0.0.1:0 and
   driven over HTTP with http.client as the page drives it, beside a second
   ``WebUI(device="cpu")``, in a temporary config dir, on phase 3's 2^24-sample
   float32 FSK capture written as .complex: ``/api/signal/open``, ``/params``
   (FSK, 100 samples a symbol, center 0) and ``/messages``: all 367 messages
   equal to the sent bits, K1 once; ``/spectrogram`` of samples 0-2^20 at
   window 1,024 on both apps: PNGs of 2,047 x 1,024, colour indices within 1,
   the dB image within 0.05 dB at or above -100 dB; ``/api/analysis/add`` and
   ``/awre`` on both apps: the same message types and labels (before the
   other signals open, so both analyze the same 367 messages); phase 6's
   capture opened and ``/autodetect``: FSK at 100, B7 once a width bucket,
   its 360 messages exact; ``/bandpass`` (the 51-tap band-pass) into a new
   signal and its ``/messages``: all 367, K1 once; ``/edit`` muting the
   first message and its pause, then ``/undo``: 366 messages (the first
   zeros joined to the second), then 367 and the samples equal to the word;
   ``/api/generator/add`` and ``/generate`` to a file: every sample equal to
   ``Modulator.modulate``'s with the generator's modulator; ``/api/sniffer/
   start`` over the Network SDR, the capture sent to its port over loopback,
   ``/messages``, ``/stop``, ``/to_analysis``: all 367, one B6 float32
   launch a drain; 4 rounds of phase 12's simulator profile through
   ``/api/simulator/load``, ``/start``, ``/log`` and ``/stop``: every answer
   sequence number + 1 with a valid CRC, "Finished".  Any reply but 200 fails
   the phase with its error text; the servers and everything they started
   are stopped in a finally.  Each route's wall and the phase's printed.

Every failed check raises.  The last three lines are a JSON ``kernels``
summary, the card's name and power limit, and ``{"ok": true, "device":
{...}}``; the two lines before them have the offline PSK wall time, the
stream's samples per second, the estimate() walls, the TX rate, the
filter, spectrum, plot path and awre walls, the live loop's rates, the
simulator's round walls, the RTL-TCP rate, the sharding walls, the
placement verdicts and walls, the CLI's and the undo stack's walls and the web
app's.  Without
a CUDA card the script exits non-zero before it prints any result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
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


def time_ms(fn, flush: torch.Tensor | None = None, runs: int = TIMED_RUNS, warmup: int = 3,
            before=None) -> float:
    """Median device time of ``fn`` over ``runs`` runs after ``warmup``
    ones, CUDA events around fn alone.  Ahead of each timed run the 50 MB
    L2 is flushed by zeroing ``flush`` (the main path finds its capture
    cold; it also keeps the card busy while the host enqueues fn), and
    ``before()`` runs (a reset of state that fn changes)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        if flush is not None:
            flush.zero_()
        if before is not None:
            before()
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
                 pause: int = 20000, lead: int = 0):
    """Synthetic float32 (n, 2) capture: ``lead`` silent samples, [pause,
    message] * k + trailing pause, messages of n_bits random bits at sps
    samples per bit, amplitude 0.75 plus Gaussian noise of sigma 0.01.  FSK is continuous-phase at
    +-25 kHz of 1 Msps; ASK is on/off keying of a 10 kHz tone, every
    message starting and ending with a 1 (an ASK zero is silence)."""
    rng = np.random.default_rng(seed)
    period = pause + n_bits * sps
    n_msgs = (n - lead) // period
    bits = rng.integers(0, 2, (n_msgs, n_bits), dtype=np.uint8)
    if kind == "ASK":
        bits[:, 0] = bits[:, -1] = 1
    sym = np.zeros((n_msgs, pause + n_bits * sps), dtype=np.int8)  # -1 silent
    sym[:, :pause] = -1
    sym[:, pause:] = np.repeat(bits, sps, axis=1)
    sym = np.concatenate((np.full(lead, -1, np.int8), sym.ravel(),
                          np.full(n - lead - n_msgs * period, -1, np.int8)))
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


def make_estimate_capture(n_msgs: int = 24, n_bits: int = 800, device=None):
    """bench.py's estimate capture (bench_estimate), synthesized by the
    port's modulate on ``device``: n_msgs messages of the bits 10110010
    repeated to n_bits, 100 samples a bit, FSK at +-20 kHz of 1 Msps around
    a carrier of 0 Hz, each followed by a 40,000-sample pause, plus
    Gaussian noise of sigma 0.01 (seed 7): about 2.9 M samples at full
    size.  -> (float32 (n, 2) capture, the (n_msgs, n_bits) bits)."""
    from urh_tpu_torch.dsp.modulate import modulate

    bits = np.resize(np.array([1, 0, 1, 1, 0, 0, 1, 0], np.uint8), n_bits)
    message = modulate(bits, 100, "fsk", [-20e3, 20e3], carrier_frequency=0.0,
                       sample_rate=1e6, pause=40_000, device=device)
    capture = np.tile(message, (n_msgs, 1))
    capture += np.random.default_rng(7).normal(0, 0.01, capture.shape).astype(np.float32)
    return capture, np.tile(bits, (n_msgs, 1))


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
              f"wall {wall} s", flush=True)
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


# -- B5 (Costas loop) and B6 (fused stream block) -----------------------------

B5_SIZES = (1, 2, 3, 1000, 1 << 14)
B5_ORDERS = (2, 4)
B5_TIMED_N = 1 << 22
B5_TIMED_RUNS = 3  # one launch at 2^22 takes a sizeable fraction of a second
B5_PLAIN_N = 1 << 14  # the plain loop steps sample by sample: timed here
B5_NOISE = 0.1
B5_FAR_PHASES = (13.0, -13.0, 100.0, -100.0)  # carries in the wrap's fmodf branch
B5_PIECE = 2048  # samples a piece of the plain loop at the main path's sizes
# dependent FP32 operations on the loop-carried chain a sample (phase ->
# cosf/sinf -> mix -> error -> clip -> freq -> phase -> wrap -> gate, counted
# from csrc/costas.cuh in csrc/costas.cu's note) at about 4 cycles each
B5_CHAIN_CYCLES = 30 * 4
B5_BYTES_PER_SAMPLE = 8 + 4
B5_SOURCE = "urh_tpu_torch/csrc/costas.cu"
B5_REPLACES = "urh_tpu/dsp/demod.py:118"

# the stream block kernel's tile in samples, by ingest, at one group a
# thread (kUrhStreamThreads x kUrhStreamF32Group / kUrhStreamI8Group in
# csrc/stream_block.cuh), as a chunk of a stream takes it
B6_TILES = {"f32": 1024, "i8": 4096}
B6_SIZES = (1, 2, 17, 1000, *sorted({n for t in B6_TILES.values()
                                     for n in (t - 1, t, t + 1, 2 * t + 1)}),
            1 << 17, (1 << 17) + 1, (1 << 17) + 5)
# blocks whose tiles take 2 and 4 groups a thread (urh_stream_groups on
# 132 SMs), by ingest
B6_LARGE = (("f32", 1 << 22), ("f32", 1 << 24), ("i8", 1 << 24), ("i8", 1 << 25))
STREAM_CHUNK = 1 << 17  # bench.py's chunk
B6_SOURCE = "urh_tpu_torch/csrc/stream_block.cu"
B6_REPLACES = "urh_tpu/protocol/stream.py:156"
# (modulation, center, spacing) of the kernel-phase decisions, for orders 2 and 8
B6_DECISIONS = {"ASK": (0.3, 0.1), "FSK": (0.0, 0.5)}
B6_NOISE = 0.05  # normalized units, both ingests


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def b5_bound_ms(n: int, clock_hz: float) -> tuple[float, str]:
    chain_ms = n * B5_CHAIN_CYCLES / clock_hz * 1e3
    byte_ms = n * B5_BYTES_PER_SAMPLE / HBM_BYTES_PER_S * 1e3
    return max(chain_ms, byte_ms), "operations" if chain_ms >= byte_ms else "bytes"


def b6_bytes(n: int, ingest_bytes: int) -> int:
    """Input read once, the (2 + cap) int32 bundle written once."""
    return n * ingest_bytes + 4 * (2 + n // 4 + 8)


def b5_main_calls_check(device, iq: np.ndarray, chunk: int = STREAM_CHUNK,
                        piece: int = B5_PIECE) -> tuple[float, int]:
    """The Costas kernel called as the main path calls it on the BPSK
    capture iq, against the plain loop, for each loop order: offline, once
    over x[1:] (N - 1 samples, 8 bytes into the allocation); streamed,
    over x[1:chunk], then over each chunk as the stream uploads it (the
    halo sample and the chunk, a fresh allocation) cut to [1:].

    The plain loop steps sample by sample, so it runs over x[1:] in
    pieces of ``piece`` samples stepped together, each piece from the
    carry the kernel holds at its start (the kernel run piece by piece).
    Each piece must end on the next piece's starting carry and the last
    on both calls' final carries, so the plain loop checks the whole
    chain.  -> (qad max abs error, qad and carry mismatches)."""
    from urh_tpu_torch.core.iq import normalize_scale_shift
    from urh_tpu_torch.dsp import costas

    p = psk_params()
    nsq = float(np.float32(p.noise_threshold * p.noise_threshold))
    scale, shift = normalize_scale_shift(np.float32)
    alpha, beta = costas.costas_alpha_beta(p.costas_loop_bandwidth)
    x = torch.from_numpy(iq).to(device)
    n, body = len(x), x[1:]
    n_pieces = -(-(n - 1) // piece)
    pieces = torch.zeros((n_pieces * piece, 2), dtype=torch.float32, device=device)
    pieces[:n - 1] = body  # zero samples pad the last piece: gated, they keep the carry
    err, mismatch = 0.0, 0
    for order in B5_ORDERS:
        def run(v, carry):
            return costas.costa_demod_scan(v, nsq, scale, shift, order,
                                           p.costas_loop_bandwidth, carry)

        offline_carry = costas.new_carry(device)
        offline = run(body, offline_carry)
        stream_carry = costas.new_carry(device)
        streamed = [run(x[1:chunk], stream_carry)]
        streamed += [run(x[a - 1:a + chunk].clone()[1:], stream_carry)
                     for a in range(chunk, n, chunk)]
        streamed = torch.cat(streamed)
        carry, starts = costas.new_carry(device), []
        for a in range(0, n - 1, piece):
            starts.append(carry.clone())
            run(body[a:a + piece], carry)
        starts = torch.stack(starts)
        want, phases, freqs = costas.costa_demod_scan_plain(
            pieces.view(n_pieces, piece, 2), nsq, scale, shift, order, alpha, beta,
            starts[:, 0], starts[:, 1])
        want, ends = want.reshape(-1)[:n - 1], torch.stack((phases, freqs), 1)
        e = max((offline - want).abs().max().item(), (streamed - want).abs().max().item())
        bad = (int((offline != want).sum()) + int((streamed != want).sum())
               + int((ends[:-1] != starts[1:]).sum()) + int((ends[-1] != offline_carry).sum())
               + int((ends[-1] != stream_carry).sum()))
        err, mismatch = max(err, e), mismatch + bad
        print(f"costas at the main path's calls, order {order}: offline over {n - 1} "
              f"samples, streamed in {len(range(0, n, chunk))} chunks, against the plain "
              f"loop in {n_pieces} pieces of {piece}: max_abs_err {e}, qad and carry "
              f"mismatches {bad}", flush=True)
    return err, mismatch


def b5_sincos_sweep(device, stride: int = 1, batch: int = 1 << 26) -> int:
    """The loop's sincosf and its near version (costas.loop_sincos) against
    torch.sin and torch.cos on every stride-th float32 in [-4*pi, 4*pi],
    bit for bit: the plain loop takes torch's, so the kernel must give the
    same bits.  -> mismatching results."""
    from urh_tpu_torch.dsp import costas

    top = int(np.float32(4 * np.pi).view(np.int32))  # float32(4*pi) <= 4*pi < the next one
    bad = values = 0
    for sign in (0, -(1 << 31)):  # the positive floats, then the negative ones
        for a in range(0, top + 1, batch * stride):
            bits = torch.arange(a, min(a + batch * stride, top + 1), stride, dtype=torch.int32,
                                device=device)
            x = (bits + sign).view(torch.float32)
            want = torch.sin(x).view(torch.int32), torch.cos(x).view(torch.int32)
            for s, c in costas.loop_sincos(x):
                bad += int((s.view(torch.int32) != want[0]).sum())
                bad += int((c.view(torch.int32) != want[1]).sum())
            values += len(x)
    print(f"costas sincosf and its near version against torch.sin/torch.cos on {values} "
          f"float32 values in [-4*pi, 4*pi]: {bad} mismatching results", flush=True)
    return bad


def b5_phase(device, sizes=B5_SIZES, timed_n=B5_TIMED_N, plain_n=B5_PLAIN_N,
             main_n=B5_TIMED_N, chunk=STREAM_CHUNK, sweep_stride=1) -> dict:
    """The Costas kernel's sincosf against torch's (b5_sincos_sweep); the
    kernel against its plain version (qad to the bit, the final carry
    equal) at each size and loop order, on a capture with gated stretches,
    and from carries with |phase| >= 4*pi; carry chaining over 7 uneven
    chunks against one shot; the main path's calls on the main_n-sample
    BPSK capture (b5_main_calls_check); kernel time at timed_n, plain time
    at plain_n."""
    from urh_tpu_torch.dsp import costas

    f32, _ = kernel_inputs(max(max(sizes), timed_n), seed=5)
    nsq = float(np.float32(B5_NOISE ** 2))
    alpha, beta = costas.costas_alpha_beta(0.1)
    err, mismatch = 0.0, b5_sincos_sweep(device, sweep_stride)
    cases = [(n, costas.new_carry(device)) for n in sizes]
    cases += [(1000, costas.new_carry(device, phase=p, freq=0.5)) for p in B5_FAR_PHASES]
    for n, start in cases:
        x = torch.from_numpy(f32[:n]).to(device)
        for order in B5_ORDERS:
            carry = start.clone()
            got = costas.costa_demod_scan(x, nsq, 1.0, 0.0, order, 0.1, carry)
            torch.cuda.synchronize()
            want, phase, freq = costas.costa_demod_scan_plain(
                x, nsq, 1.0, 0.0, order, alpha, beta, start[0], start[1])
            e = (got - want).abs().max().item() if n else 0.0
            bad = int((got != want).sum()) + int(
                not torch.equal(carry, torch.stack((phase, freq))))
            err, mismatch = max(err, e), mismatch + bad
            print(f"costas n={n} order={order} from phase {start[0].item()}: max_abs_err {e}, "
                  f"qad/carry mismatches {bad}", flush=True)
    # 7 uneven chunks, the carry handed on in the same tensor
    n = max(sizes)
    x = torch.from_numpy(f32[:n]).to(device)
    cuts = [0, 1, 3, n // 7, n // 3, n // 2 + 1, n - 5, n]  # 7 chunks for n >= 1000
    for order in B5_ORDERS:
        one = costas.new_carry(device)
        whole = costas.costa_demod_scan(x, nsq, 1.0, 0.0, order, 0.1, one)
        chained = costas.new_carry(device)
        parts = [costas.costa_demod_scan(x[a:b].contiguous(), nsq, 1.0, 0.0, order, 0.1,
                                         chained) for a, b in zip(cuts, cuts[1:])]
        torch.cuda.synchronize()
        bad = int((torch.cat(parts) != whole).sum()) + int(not torch.equal(one, chained))
        mismatch += bad
        print(f"costas chained over {len(cuts) - 1} chunks, order {order}: {bad} "
              f"mismatches against one shot", flush=True)
    e, bad = b5_main_calls_check(device, make_psk_capture(main_n, seed=13)[0], chunk)
    err, mismatch = max(err, e), mismatch + bad
    if err > 0.0 or mismatch:
        raise AssertionError(f"costas: max_abs_err {err}, {mismatch} mismatches")

    x = torch.from_numpy(f32[:timed_n]).to(device)
    carry, init = costas.new_carry(device), costas.new_carry(device)
    ms = time_ms(lambda: costas.costa_demod_scan(x, nsq, 1.0, 0.0, 2, 0.1, carry),
                 runs=B5_TIMED_RUNS, warmup=1, before=lambda: carry.copy_(init))
    xp = x[:plain_n]
    plain_ms = time_ms(lambda: costas.costa_demod_scan_plain(
        xp, nsq, 1.0, 0.0, 2, alpha, beta, init[0], init[1]), runs=1, warmup=0)
    print(f"costas timed: {ms} ms at n={timed_n} (median of {B5_TIMED_RUNS} after 1 "
          f"warm-up), plain {plain_ms} ms at n={plain_n} (1 run)", flush=True)
    return {"err": err, "mismatch": mismatch, "ms": ms, "plain_ms": plain_ms}


def b6_calls(xf, xi, halo: bool):
    """(label, x, args) of the stream block for each ingest, modulation
    and order on the captures xf (float32) and xi (int8)."""
    from urh_tpu_torch.dsp.symbols import get_center_thresholds
    from urh_tpu_torch.protocol.stream import rle_state_bits

    nsq = float(np.float32(B6_NOISE ** 2))
    max_mag = float(np.float32(math.sqrt(2.0)))
    cap = len(xf) // 4 + 8
    for ingest, x in (("f32", xf), ("i8", xi)):
        for mod, (center, spacing) in B6_DECISIONS.items():
            for order in (2, 8):
                thr = torch.from_numpy(get_center_thresholds(center, spacing, order)).to(
                    x.device)
                yield (f"{ingest} {mod} order {order} halo {int(halo)}", x,
                       (nsq, max_mag, thr, mod, halo, cap, rle_state_bits(order)))


def b6_inputs(n: int):
    """Float32 and int8 stretches of the FSK and ASK captures (runs of
    realistic length, gated pauses), interleaved so that both occur."""
    fsk, _ = make_capture("FSK", 1 << 18, seed=31, pause=2000)
    ask, _ = make_capture("ASK", 1 << 18, seed=32, pause=2000)
    mixed = np.where((np.arange(len(fsk)) // 5000 % 2 == 0)[:, None], fsk, ask)
    reps = -(-(n + 1500) // len(mixed))
    xf = np.ascontiguousarray(np.tile(mixed, (reps, 1))[1500:1500 + n])
    return xf, to_int8(xf)


def b6_run(x, args):
    """The stream block's bundle and, by the states-only launch, its
    states, as the plain version returns them."""
    from urh_tpu_torch.dsp import stream_kernels as sk

    got = sk.stream_block(x, *args), sk.stream_states(x, *args[:-2])
    torch.cuda.synchronize()  # a fault in the kernels shows here
    return got


def b6_compare(got, want) -> tuple[float, int]:
    """-> (max abs error, mismatches) of a stream block's (bundle, states)
    against its plain version's, over every bundle word and state: the
    peak word read as float32, the others as integers."""
    (gb, gs), (wb, ws) = got, want
    bad = int((gb != wb).sum()) + int((gs != ws).sum())
    peak = (gb[1:2].view(torch.float32).double() - wb[1:2].view(torch.float32).double()).abs()
    ints = torch.cat((gb[:1].long() - wb[:1].long(), gb[2:].long() - wb[2:].long(),
                      gs.long() - ws.long())).abs()
    return max(peak.max().item(), float(ints.max().item())), bad


def b6_phase(device, sizes=B6_SIZES, chunk=STREAM_CHUNK, full=N_FULL, large=B6_LARGE) -> dict:
    """The stream block kernels against their plain versions (bundle and
    states to the bit) at each size, with and without the halo, for both
    ingests, ASK and FSK, binary and 8-ary, and a cap overflow; bundles
    also for the large blocks; kernel and plain times per chunk and at
    full, for binary FSK (and the kernel's for 8-ary FSK)."""
    from urh_tpu_torch.dsp import stream_kernels as sk
    from urh_tpu_torch.dsp.symbols import get_center_thresholds

    mismatch, err = {"f32": 0, "i8": 0}, {"f32": 0.0, "i8": 0.0}
    for n in sizes:
        xf_np, xi_np = b6_inputs(n)
        xf, xi = torch.from_numpy(xf_np).to(device), torch.from_numpy(xi_np).to(device)
        for halo in (False, True):
            if n <= halo:
                continue
            for label, x, args in b6_calls(xf, xi, halo):
                e, bad = b6_compare(b6_run(x, args), sk.stream_block_plain(x, *args))
                ingest = label[:3].strip()
                mismatch[ingest], err[ingest] = mismatch[ingest] + bad, max(err[ingest], e)
                if bad:
                    print(f"stream block n={n} {label}: {bad} mismatches", flush=True)
        print(f"stream block n={n}: mismatches {mismatch}, max_abs_err {err}", flush=True)
    # one pause over every tile of a 2^17 + 5 block, a short signal at either end
    pause = np.zeros(((1 << 17) + 5, 2), np.float32)
    pause[:300], pause[-300:] = b6_inputs(300)[0], b6_inputs(600)[0][300:]
    for halo in (False, True):
        for label, x, args in b6_calls(torch.from_numpy(pause).to(device),
                                       torch.from_numpy(to_int8(pause)).to(device), halo):
            e, bad = b6_compare(b6_run(x, args), sk.stream_block_plain(x, *args))
            ingest = label[:3].strip()
            mismatch[ingest], err[ingest] = mismatch[ingest] + bad, max(err[ingest], e)
    print(f"stream block, one pause over every tile: mismatches {mismatch}", flush=True)
    # alternating states: every sample starts a run, far more runs than cap;
    # the start of rank cap - 1 around the first state of a tile
    alt = np.zeros((3 * B6_TILES["i8"], 2), np.float32)
    alt[:, 0] = np.where(np.arange(len(alt)) % 2, 0.9, 0.2)
    thr = torch.tensor([0.3], dtype=torch.float32, device=device)
    for x in (torch.from_numpy(alt).to(device), torch.from_numpy(to_int8(alt)).to(device)):
        ingest = "f32" if x.dtype == torch.float32 else "i8"
        tile = B6_TILES[ingest]
        for halo in (False, True):
            for cap in (16, tile - 1, tile, tile + 1, 2 * tile + 1):
                args = (0.0, float(np.float32(math.sqrt(2.0))), thr, "ASK", halo, cap, 2)
                got = b6_run(x, args)
                e, bad = b6_compare(got, sk.stream_block_plain(x, *args))
                if int(got[0][0]) <= cap:
                    raise AssertionError("the alternating capture did not overflow cap")
                mismatch[ingest], err[ingest] = mismatch[ingest] + bad, max(err[ingest], e)
        print(f"stream block overflow {x.dtype}, caps around the tile of {tile}: "
              f"mismatches {mismatch[ingest]}", flush=True)
    # large blocks, whose tiles take more groups a thread
    for ingest, n in large:
        xf_np, xi_np = b6_inputs(n)
        x = torch.from_numpy(xf_np if ingest == "f32" else xi_np).to(device)
        del xf_np, xi_np
        for halo in (False, True):
            for label, xx, args in b6_calls(x, x, halo):
                if label.startswith(ingest):
                    got = sk.stream_block(xx, *args)
                    torch.cuda.synchronize()
                    want = sk.stream_block_plain(xx, *args)[0]
                    mismatch[ingest] += int((got != want).sum())
        print(f"stream block {ingest} n={n}: bundle mismatches {mismatch[ingest]}", flush=True)
        del x
    if any(mismatch.values()) or any(err.values()):
        raise AssertionError(f"stream block mismatches {mismatch}, max_abs_err {err}")

    flush = torch.empty(512 << 20, dtype=torch.uint8, device=device)
    timings = {}
    xf_np, xi_np = b6_inputs(full)
    thr = torch.zeros(1, dtype=torch.float32, device=device)
    for n in (chunk, full):
        for ingest, x_np in (("f32", xf_np), ("i8", xi_np)):
            x = torch.from_numpy(x_np[:n]).to(device)
            args = (float(np.float32(B6_NOISE ** 2)), float(np.float32(math.sqrt(2.0))),
                    thr, "FSK", True, n // 4 + 8, 2)
            timings[(ingest, n)] = (
                time_ms(lambda: sk.stream_block(x, *args), flush),
                time_ms(lambda: sk.stream_block_plain(x, *args), flush))
            # 8-ary FSK, whose decision takes the arctangent
            thr8 = torch.from_numpy(get_center_thresholds(0.0, 0.5, 8)).to(device)
            args8 = (*args[:2], thr8, "FSK", True, n // 4 + 8, 4)
            ms8 = time_ms(lambda: sk.stream_block(x, *args8), flush)
            print(f"stream block {ingest} n={n}: {timings[(ingest, n)][0]} ms, plain "
                  f"{timings[(ingest, n)][1]} ms; 8-ary FSK {ms8} ms", flush=True)
    return {"mismatch": mismatch, "err": err, "timings": timings}


def make_psk_capture(n: int, seed: int, sps: int = 100, n_bits: int = 256,
                     pause: int = 20000, lock_in: int = 2000, silence: int = 0):
    """Synthetic float32 BPSK capture: ``silence`` silent samples, a lock-in
    burst of lock_in samples of the carrier (the loop starts off frequency
    and needs a few symbols to lock; the burst decodes as a first message
    of ones), a pause, then [message, pause] * k.  A 40 kHz carrier at 1
    Msps, bit 1 at phase pi (which the loop locks to as state 1), every
    message opening with a 1; every length after the silence is a whole
    number of carrier periods (25 samples), so the loop, frozen through a
    pause, re-enters in phase.  Amplitude 0.75, Gaussian noise of sigma
    0.01."""
    rng = np.random.default_rng(seed)
    period = pause + n_bits * sps
    lead = np.concatenate((np.full(silence, -1, np.int8), np.ones(lock_in, np.int8),
                           np.full(pause, -1, np.int8)))
    n_msgs = (n - len(lead)) // period
    bits = rng.integers(0, 2, (n_msgs, n_bits), dtype=np.uint8)
    bits[:, 0] = 1
    sym = np.zeros((n_msgs, period), dtype=np.int8)
    sym[:, :n_bits * sps] = np.repeat(bits, sps, axis=1)
    sym[:, n_bits * sps:] = -1
    sym = np.concatenate((lead, sym.ravel(), np.full(n - len(lead) - sym.size, -1, np.int8)))
    phase = np.arange(n) * (2 * np.pi * 40e3 / 1e6) + np.pi * (sym == 1)
    amp = 0.75 * (sym >= 0)
    iq = np.empty((n, 2), dtype=np.float32)
    iq[:, 0] = amp * np.cos(phase)
    iq[:, 1] = amp * np.sin(phase)
    iq += rng.normal(0, 0.01, (n, 2)).astype(np.float32)
    return iq, bits


def psk_params():
    from urh_tpu_torch import DemodParams

    return DemodParams(modulation="PSK", samples_per_symbol=100, center=0.0,
                       noise_threshold=0.15, tolerance=5, pause_threshold=8)


def check_psk_messages(bit_lists, bits, label: str):
    """The lock-in burst's message of ones, then every sent message."""
    lock_in = np.asarray(bit_lists[0], np.uint8) if bit_lists else np.zeros(0, np.uint8)
    if not len(lock_in) or not lock_in.all():
        raise AssertionError(f"{label}: the first message is not the lock-in burst")
    check_bits(bit_lists[1:], bits, label)


def check_bits(bit_lists, bits, label: str):
    if len(bit_lists) != len(bits):
        raise AssertionError(f"{label}: {len(bit_lists)} messages, sent {len(bits)}")
    for i, (got, sent) in enumerate(zip(bit_lists, bits)):
        if not np.array_equal(np.frombuffer(bytes(got), np.uint8), sent):
            raise AssertionError(f"{label}: message {i} differs from the sent bits")


def psk_main_path_phase(device, n: int):
    """demodulate() on the PSK capture; -> (Costas launches, wall, offline
    pulse runs, capture, bits)."""
    import urh_tpu_torch as ut
    from urh_tpu_torch.dsp import costas, symbols

    iq, bits = make_psk_capture(n, seed=13)
    costas.LAUNCHES["costas_f32"] = 0
    t0 = time.perf_counter()
    sig = ut.Signal.from_iq(iq, device=device)
    messages = ut.demodulate(sig, psk_params())
    wall = time.perf_counter() - t0
    launches = costas.LAUNCHES["costas_f32"]
    check_psk_messages([m.plain_bits for m in messages], bits, "PSK float32")
    if launches != 1:
        raise AssertionError(f"PSK: {launches} Costas launches, not 1")
    p = sig.params
    offline = symbols.grab_pulse_lens(sig.qad, p.center, p.tolerance, p.modulation,
                                      p.samples_per_symbol, p.bits_per_symbol,
                                      p.center_spacing)
    print(f"main path PSK float32: {len(messages) - 1} messages bit-exact after the "
          f"lock-in burst, Costas launches {launches}, wall {wall} s", flush=True)
    return launches, wall, offline, iq, bits


def stream_segments(sd, data: np.ndarray, chunk: int):
    segments = []
    for i in range(0, len(data), chunk):
        segments += sd.feed(data[i:i + chunk])
    return segments + sd.flush()


def segment_bits(segments, p) -> list:
    """Each segment's messages, through ProtocolAnalyzer._ppseq_to_bits."""
    from urh_tpu_torch import ProtocolAnalyzer

    out = []
    for seg in segments:
        out += ProtocolAnalyzer._ppseq_to_bits(seg.ppseq, p.samples_per_symbol,
                                               p.bits_per_symbol,
                                               pause_threshold=p.pause_threshold)[0]
    return out


def stream_main_path_phase(device, n: int, chunk: int = STREAM_CHUNK):
    """StreamDemodulator(backend="device") over the FSK captures in chunks,
    each dtype twice in turns (the first pass also pays the process's
    first pinned allocations and launches); -> (launch counts of the last
    pass, samples/s by (dtype, pass))."""
    import urh_tpu_torch as ut
    from urh_tpu_torch.dsp import stream_kernels as sk
    from urh_tpu_torch.protocol import stream

    iq, bits = make_capture("FSK", n, seed=11)
    launches, rates = {}, {}
    for run in (1, 2):
        for dtype, data, key in (("float32", iq, "stream_block_f32"),
                                 ("int8", to_int8(iq), "stream_block_i8")):
            params = demod_params("FSK", np.float32)  # normalized units for both
            sk.LAUNCHES[key] = 0
            stream.FALLBACKS["states"] = 0
            sd = ut.StreamDemodulator(params, backend="device", device=device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            segments = stream_segments(sd, data, chunk)
            wall = time.perf_counter() - t0
            launches[key] = sk.LAUNCHES[key]
            rates[(dtype, run)] = n / wall
            check_bits(segment_bits(segments, params), bits, f"stream FSK {dtype}")
            chunks = -(-n // chunk)
            if launches[key] != chunks or stream.FALLBACKS["states"]:
                raise AssertionError(f"stream FSK {dtype}: {launches[key]} launches for "
                                     f"{chunks} chunks, {stream.FALLBACKS['states']} "
                                     f"fallbacks")
            print(f"stream FSK {dtype} pass {run}: {len(bits)} messages bit-exact from "
                  f"{len(segments)} segments, {key} launches {launches[key]} for {chunks} "
                  f"chunks, fallbacks 0, {rates[(dtype, run)]} samples/s (wall {wall} s)",
                  flush=True)
    return launches, rates


def stream_layers_phase(device, n: int, chunk: int = STREAM_CHUNK) -> dict:
    """The stream's device layers alone over the FSK captures: each chunk
    staged into a pinned buffer, uploaded, run through the stream block and
    its bundle read back and waited for, with none of the host's run
    handling; -> ms a chunk by dtype (host clock)."""
    from urh_tpu_torch.dsp import stream_kernels as sk
    from urh_tpu_torch.protocol import stream

    iq, _ = make_capture("FSK", n, seed=11)
    thr = torch.zeros(1, dtype=torch.float32, device=device)
    nsq = float(np.float32(0.15 ** 2))
    out = {}
    for dtype, data in (("float32", iq), ("int8", to_int8(iq))):
        slots = [stream._Slot(), stream._Slot()]
        for run in (1, 2):  # the first pass allocates the pinned buffers
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for k, i in enumerate(range(0, n, chunk)):
                slot = slots[k % 2]
                x = slot.upload([data[i:i + chunk]], device)
                bundle = sk.stream_block(x, nsq, float(np.float32(math.sqrt(2.0))), thr,
                                         "FSK", False, len(x) // 4 + 8, 2)
                slot.download(bundle)
                slot.bundle()
            out[dtype] = (time.perf_counter() - t0) * 1e3 / -(-n // chunk)
        print(f"stream layers {dtype}: staging + upload + stream block + bundle readback "
              f"{out[dtype]} ms a {chunk}-sample chunk (second pass)", flush=True)
    return out


def psk_stream_phase(device, iq, bits, offline, chunk: int = STREAM_CHUNK) -> int:
    """The PSK capture streamed: each segment's runs are the offline pulse
    runs, but for the prompt-closed trailing pause (and the rest of a
    closed pause opening the next one); its messages the sent bits.
    -> Costas launches."""
    import urh_tpu_torch as ut
    from urh_tpu_torch.dsp import costas

    costas.LAUNCHES["costas_f32"] = 0
    sd = ut.StreamDemodulator(psk_params(), backend="device", device=device)
    segments = stream_segments(sd, iq, chunk)
    launches = costas.LAUNCHES["costas_f32"]
    offline = [tuple(r) for r in offline.tolist()]
    at = 0
    for k, seg in enumerate(segments):
        rows = [tuple(r) for r in seg.ppseq.tolist()]
        # a pause left from the previous segment's prompt close, or the
        # glitch record a segment opening on a signal run starts with
        while rows and (rows[0][0] == -1 or rows[0][1] <= psk_params().tolerance):
            rows = rows[1:]
        if not rows or rows[-1][0] != -1:
            raise AssertionError(f"PSK stream: segment {k} does not end in a pause")
        core, closing = rows[:-1], rows[-1]
        while at < len(offline) and offline[at:at + len(core)] != core:
            at += 1
        after = offline[at + len(core)] if at + len(core) < len(offline) else None
        if after is None or after[0] != -1 or after[1] < closing[1]:
            raise AssertionError(f"PSK stream: segment {k} is not in the offline runs")
        at += len(core)
    check_psk_messages(segment_bits(segments, psk_params()), bits, "PSK stream")
    if launches != -(-len(iq) // chunk):
        raise AssertionError(f"PSK stream: {launches} Costas launches for "
                             f"{-(-len(iq) // chunk)} chunks")
    print(f"stream PSK: {len(segments)} segments equal the offline runs but for their "
          f"closing pauses, messages bit-exact, Costas launches {launches}", flush=True)
    return launches


def stream_card_vs_cpu_phase(n: int = 200000, chunk: int = 1 << 14):
    """Stream segments on the card equal those on the CPU (plain versions),
    also for alternating states that overflow every chunk's bundle (the
    per-sample states then come from the states-only launch)."""
    import urh_tpu_torch as ut
    from urh_tpu_torch.dsp import stream_kernels as sk
    from urh_tpu_torch.protocol import stream

    cases = []
    for kind, seed in (("FSK", 41), ("ASK", 42)):
        iq, _ = make_capture(kind, n, seed, pause=3000)
        cases += [(kind, iq), (kind, to_int8(iq))]
    psk, _ = make_psk_capture(20000, seed=43, n_bits=16, pause=2000, lock_in=1000)
    cases.append(("PSK", psk))
    alt = np.zeros((3 * chunk, 2), np.float32)
    alt[:, 0] = np.where(np.arange(len(alt)) % 2, 0.9, 0.2)
    alt[:1000, 0], alt[1000:3000] = 0.9, 0.0  # a message, then a pause that closes it
    alt[2 * chunk:] = 0.0  # a closing pause
    cases += [("ASK overflow", alt), ("ASK overflow", to_int8(alt))]
    for kind, x in cases:
        if kind == "PSK":
            params = psk_params
        else:
            params = lambda k=kind: demod_params(k.split()[0], np.float32)  # noqa: E731
        before = dict(sk.LAUNCHES), stream.FALLBACKS["states"]
        got = stream_segments(ut.StreamDemodulator(params(), device="cuda"), x, chunk)
        states_launches = sum(sk.LAUNCHES[k] - before[0][k] for k in sk.LAUNCHES
                              if k.startswith("stream_states"))
        fallbacks = stream.FALLBACKS["states"] - before[1]
        want = stream_segments(ut.StreamDemodulator(params(), device="cpu"), x, chunk)
        same = ([(s.start_sample, s.num_samples, s.ppseq.tolist()) for s in got]
                == [(s.start_sample, s.num_samples, s.ppseq.tolist()) for s in want])
        if not same or not got:
            raise AssertionError(f"stream {kind} {x.dtype}: card and CPU segments differ")
        if kind.endswith("overflow") and (fallbacks < 2 or states_launches != fallbacks):
            raise AssertionError(f"stream {kind} {x.dtype}: {fallbacks} fallbacks, "
                                 f"{states_launches} states-only launches")
    print("stream card vs CPU: segments equal for FSK/ASK float32/int8, PSK, and overflowing "
          "ASK float32/int8 through the states-only launch", flush=True)


# -- B7 (median filter), estimate() and TX ------------------------------------

B7_K = 11  # estimate's _MEDIAN_ORDER
B7_KS = (1, 2, 3, 11, 12, 16, 17, 64, 65)  # 16 the last in registers, 17 the rank count
B7_ROWS = 3
# the main path's buckets, both magnitudes stacked: 2 x 100 rows of 16,384 -
# 16 (the 2^24-sample FSK capture's 25,600-sample messages) and 2 x 24 of
# 65,536 - 16 (the estimate capture's 80,000-sample messages)
B7_MAIN_SHAPES = ((200, 16368), (48, 65520))
B7_LARGE = (2048, 16384)  # 2^25 cells
B7_TALL = (70000, 7)  # more rows than a grid is high (65,535)
B7_PLAIN_RUNS = 5  # the plain version sorts k copies of every cell
B7_SOURCE = "urh_tpu_torch/csrc/median_filter.cu"
B7_REPLACES = "urh_tpu/ai/device.py:141"
B7_LEVELS = np.array([-0.0, 0.0, 1.0, -1.0, 0.5, 2.0, np.inf, -np.inf], np.float32)

EST_MSGS, EST_BITS = 24, 800  # bench.py's estimate capture
CENTER_ATOL = 1e-6  # estimate() card against CPU: atan2 rounds differently
TX_BODY = 1 << 21  # urh_tpu's DEVICE_MIN_BODY_SAMPLES
TX_FLOAT_ULPS = 4  # card against CPU: their cosf/sinf, a few ulps apart
# (type, bits a symbol, Modulator parameters: % / Hz / degrees)
TX_CASES = (("ASK", 1, [20.0, 100.0]), ("ASK", 2, [0.0, 30.0, 60.0, 100.0]),
            ("FSK", 1, [-20e3, 20e3]), ("FSK", 2, [-30e3, -10e3, 10e3, 30e3]),
            ("GFSK", 1, [-20e3, 20e3]), ("GFSK", 2, [-30e3, -10e3, 10e3, 30e3]),
            ("PSK", 1, [-90.0, 90.0]), ("PSK", 2, [-135.0, -45.0, 45.0, 135.0]),
            ("OQPSK", 2, [-135.0, -45.0, 45.0, 135.0]))
TX_DTYPES = {"float32": (np.float32, 1.0), "int8": (np.int8, 127.0),
             "int16": (np.int16, 32767.0)}


def b7_rows(rows: int, w: int, seed: int, nan: bool = False) -> np.ndarray:
    """rows x w float32: quantized rows (ties, +-0, +-inf), Gaussian rows,
    and with ``nan`` a row of NaN stretches."""
    rng = np.random.default_rng(seed)
    out = np.concatenate((rng.choice(B7_LEVELS, (rows, w)),
                          rng.normal(size=(rows, w)).astype(np.float32)))
    if nan:
        out[0, ::7] = np.nan
        out[1, w // 3:w // 3 + 40] = np.nan
    return out


def b7_compare(got: torch.Tensor, want: torch.Tensor) -> tuple[float, int]:
    """-> (max abs error over the finite pairs, mismatching words)."""
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    finite = torch.isfinite(got) & torch.isfinite(want)
    err = (got - want).abs()[finite].max().item() if bool(finite.any()) else 0.0
    return err, bad


def b7_bound(shape, k: int) -> tuple[float, str]:
    """Bytes: each float32 read once and each output written once; ops: a
    selection's kk - 1 comparisons an output (kk the window, shrunk at the
    row's end), at the float32 rate.  -> (ms, bound_by)."""
    rows, w = shape
    kk = np.minimum(k, w - np.arange(w))
    byte_ms = 8 * rows * w / HBM_BYTES_PER_S * 1e3
    op_ms = rows * float((kk - 1).sum()) / FP32_OPS_PER_S * 1e3
    return max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else "operations"


def b7_widths(k: int, variant: dict) -> list:
    """W = 1, k - 1, k, k + 1, 1000 and 2^14 + 3, and around the kernel's
    run of outputs a thread (T - 1, T, T + 1) and its block's tile (one
    below, at, one past)."""
    t, tile = variant["outputs"], variant["block_outputs"]
    return sorted({1, k - 1, k, k + 1, 1000, (1 << 14) + 3, t - 1, t, t + 1, tile - 1, tile,
                   tile + 1} - {0})


def b7_phase(device, ks=B7_KS, main_shapes=B7_MAIN_SHAPES, large=B7_LARGE, tall=B7_TALL,
             runs: int = TIMED_RUNS, plain_runs: int = B7_PLAIN_RUNS, variant=None) -> dict:
    """B7 against its plain version on the same tensors, to the bit: every
    k of ks at b7_widths on quantized, Gaussian and NaN rows, at the main
    path's shapes and on ``tall`` rows (k = 3 and 11); kernel, plain version
    and the library's unfold().median() (odd k, full windows only: the
    nearest single PyTorch call) timed at the first main shape and at
    ``large``.  ``variant(k)`` is the kernel a window k takes
    (median_kernels.kernel_variant on the card), printed for each k.
    -> max-abs error, mismatching words, timings and the k = B7_K variant."""
    from urh_tpu_torch.ai import median_kernels as mk

    variant = variant or mk.kernel_variant
    err, mismatch, cases = 0.0, 0, 0
    for k in ks:
        v = variant(k)
        print(f"median filter k={k}: {v['variant']} kernel, {v['outputs']} outputs a thread "
              f"at a time, {v['block_outputs']} a block, {v['registers']} registers and "
              f"{v['local_bytes']} local bytes a thread", flush=True)
        for w in b7_widths(k, v):
            rows = torch.from_numpy(b7_rows(B7_ROWS, w, seed=k * 7919 + w, nan=w > 2)).to(device)
            got = mk.median_filter(rows, k)
            torch.cuda.synchronize()  # a fault in the kernel shows here
            e, bad = b7_compare(got, mk.median_filter_plain(rows, k))
            err, mismatch, cases = max(err, e), mismatch + bad, cases + 1
    for i, shape in enumerate(main_shapes):
        rows = torch.from_numpy(np.abs(b7_rows(shape[0] // 2, shape[1], seed=i))).to(device)
        got = mk.median_filter(rows, B7_K)
        torch.cuda.synchronize()
        e, bad = b7_compare(got, mk.median_filter_plain(rows, B7_K))
        err, mismatch, cases = max(err, e), mismatch + bad, cases + 1
    rows = torch.from_numpy(b7_rows(tall[0] // 2, tall[1], seed=5)).to(device)
    for k in (3, B7_K):
        got = mk.median_filter(rows, k)
        torch.cuda.synchronize()
        e, bad = b7_compare(got, mk.median_filter_plain(rows, k))
        err, mismatch, cases = max(err, e), mismatch + bad, cases + 1
    print(f"median filter: {cases} cases (k {ks}, the main path's shapes {main_shapes}, "
          f"{tall[0]} rows of {tall[1]}): max_abs_err {err}, mismatching words {mismatch}",
          flush=True)
    if err or mismatch:
        raise AssertionError(f"median filter: max_abs_err {err}, {mismatch} mismatching words")

    flush = torch.empty(512 << 20, dtype=torch.uint8, device=device)
    timings = {}
    for shape in (main_shapes[0], large):
        rows = torch.from_numpy(np.abs(np.random.default_rng(1).normal(
            size=shape)).astype(np.float32)).to(device)
        timings[shape] = {
            "ms": time_ms(lambda: mk.median_filter(rows, B7_K), flush, runs),
            "plain_ms": time_ms(lambda: mk.median_filter_plain(rows, B7_K), flush,
                                plain_runs, warmup=1),
            "library_ms": time_ms(lambda: rows.unfold(-1, B7_K, 1).median(-1).values, flush,
                                  runs),
        }
        bound, by = b7_bound(shape, B7_K)
        print(f"median filter {shape[0]} x {shape[1]}, k={B7_K}: {timings[shape]} "
              f"(bound {bound} ms, {by})", flush=True)
        del rows
    return {"err": err, "mismatch": mismatch, "timings": timings, "variant": variant(B7_K)}


def quiet_lead(n: int) -> int:
    """Silent samples ahead of an estimated n-sample capture: the noise
    floor is read off the quietest 1% rows of a capture (the first row
    starting at n % (n // 100)), so two whole rows of silence ending on a
    row boundary, where the first signal then starts a row.  (The captures'
    own pauses are shorter than a row.)"""
    row = max(1, n // 100)
    return 2 * row + n % row


def estimate_captures(n: int, psk: dict, est_msgs: int = EST_MSGS, est_bits: int = EST_BITS,
                      device=None):
    """(label, capture, sent bits, modulation, kernel of the demodulation
    after it) for the n-sample FSK and ASK captures (float32, int8), the
    BPSK capture (make_psk_capture's arguments in ``psk``) and bench.py's
    estimate capture (synthesized by the port on ``device``).  The FSK,
    ASK and BPSK captures open with quiet_lead samples of silence."""
    out = []
    for kind, seed in (("FSK", 11), ("ASK", 12)):
        iq, bits = make_capture(kind, n, seed, lead=quiet_lead(n))
        key = kind.lower() + "_{}"
        out += [(f"{kind} float32", iq, bits, kind, key.format("f32")),
                (f"{kind} int8", to_int8(iq), bits, kind, key.format("i8"))]
    iq, bits = make_psk_capture(**psk, silence=quiet_lead(psk["n"]))
    out.append(("PSK float32", iq, bits, "PSK", "costas_f32"))
    iq, bits = make_estimate_capture(est_msgs, est_bits, device=device)
    out.append(("estimate capture", iq, bits, "FSK", "fsk_f32"))
    return out


def reset_launches():
    from urh_tpu_torch.ai import median_kernels as mk
    from urh_tpu_torch.ai import power_gate as pg
    from urh_tpu_torch.dsp import costas
    from urh_tpu_torch.dsp import fused_kernels as fk
    from urh_tpu_torch.dsp import iir_kernels as ik

    for counts in (mk.LAUNCHES, fk.LAUNCHES, costas.LAUNCHES, ik.LAUNCHES, pg.LAUNCHES):
        for key in counts:
            counts[key] = 0


def read_launches() -> dict:
    from urh_tpu_torch.ai import median_kernels as mk
    from urh_tpu_torch.ai import power_gate as pg
    from urh_tpu_torch.dsp import costas
    from urh_tpu_torch.dsp import fused_kernels as fk
    from urh_tpu_torch.dsp import iir_kernels as ik

    return {**mk.LAUNCHES, **fk.LAUNCHES, **costas.LAUNCHES, **ik.LAUNCHES, **pg.LAUNCHES}


def width_buckets(iq: np.ndarray) -> int:
    """The width buckets estimate() classifies iq in: one B7 launch each."""
    from urh_tpu_torch import IQData
    from urh_tpu_torch.ai import estimate as est
    from urh_tpu_torch.ai import segmentation

    data = IQData(iq)
    mags = data.magnitudes
    segments = segmentation.segment_messages_from_magnitudes(
        mags, segmentation.detect_noise_level(mags))
    _, staged, uploaded = est.bucket_segments(data, segments[:est._MAX_CLASSIFIED_MESSAGES],
                                              staged=True)
    return len(staged) + len(uploaded)


def count_exact(bit_lists, bits) -> int:
    sent = {np.asarray(b, np.uint8).tobytes() for b in bits}
    return sum(np.frombuffer(bytes(got), np.uint8).tobytes() in sent for got in bit_lists)


def estimate_phase(device, n: int = N_FULL, psk_n: int = B5_TIMED_N,
                   est_msgs: int = EST_MSGS, est_bits: int = EST_BITS) -> dict:
    """estimate() and Signal.auto_detect() on every capture, each run with
    the launch counts set to 0 just before and read just after: the
    capture's modulation and bit length, B7 launched once a width bucket,
    the Costas loop once for PSK; then demodulate() with the detected
    parameters, through the capture's kernel: every FSK message bit-exact,
    the exact messages counted for the others.  -> B7 launches and walls."""
    import urh_tpu_torch as ut

    launches, gate_launches, walls = 0, 0, {}
    for label, iq, bits, kind, key in estimate_captures(n, dict(n=psk_n, seed=13), est_msgs,
                                                        est_bits, device):
        buckets = width_buckets(iq)
        reset_launches()
        t0 = time.perf_counter()
        found = ut.estimate(iq, device=device)
        wall = time.perf_counter() - t0
        counts = read_launches()
        sig = ut.Signal.from_iq(iq, device=device)
        reset_launches()
        t0 = time.perf_counter()
        detected = sig.auto_detect(detect_noise=True)
        auto_wall = time.perf_counter() - t0
        auto_counts = read_launches()
        if found is None or (found["modulation_type"], found["bit_length"]) != (kind, 100):
            raise AssertionError(f"estimate {label}: {found}, made as {kind} at 100")
        if not detected or (sig.modulation_type, sig.samples_per_symbol, sig.tolerance,
                            sig.noise_threshold) != (kind, 100, found["tolerance"],
                                                     found["noise"]):
            raise AssertionError(f"auto_detect {label}: {sig.params} against {found}")
        for what, c in (("estimate", counts), ("auto_detect", auto_counts)):
            if c["median_filter_f32"] != buckets or (kind == "PSK") != (c["costas_f32"] == 1):
                raise AssertionError(f"{what} {label}: launches {c}, {buckets} width buckets")
            if (c["power_gate_stats"], c["power_gate_crossings"]) != (1, 1):
                raise AssertionError(f"{what} {label}: launches {c}, not one power gate pass "
                                     "of each")
        launches += counts["median_filter_f32"] + auto_counts["median_filter_f32"]
        gate_launches += (counts["power_gate_stats"] + counts["power_gate_crossings"]
                          + auto_counts["power_gate_stats"] + auto_counts["power_gate_crossings"])
        reset_launches()
        messages = ut.demodulate(sig)
        if read_launches()[key] == 0:
            raise AssertionError(f"{label}: demodulate() did not launch {key}")
        bit_lists = [m.plain_bits for m in messages]
        if kind == "FSK" and label != "estimate capture":
            check_bits(bit_lists, bits, f"{label} at the estimated parameters")
        walls[label] = (wall, auto_wall)
        print(f"estimate {label} ({len(iq)} samples): {found}; estimate() wall {wall} s, "
              f"auto_detect() wall {auto_wall} s; median filter launches {buckets} a call "
              f"({buckets} width buckets); demodulate() at the estimated parameters: "
              f"{count_exact(bit_lists, bits)} of {len(bits)} messages exact, "
              f"{len(messages)} messages", flush=True)
    # ROADMAP.md C1: 10 more silent samples ahead of the BPSK capture move
    # urh_tpu's own estimate (tolerance 0, not 1)
    iq, _ = make_psk_capture(psk_n, seed=13, silence=quiet_lead(psk_n) + 10)
    shifted = ut.estimate(iq, device=device)
    print(f"estimate PSK float32 with 10 more silent samples ahead ({psk_n} samples): "
          f"{shifted}", flush=True)
    if shifted is None or (shifted["modulation_type"], shifted["bit_length"],
                           shifted["tolerance"]) != ("PSK", 100, 0):
        raise AssertionError(f"estimate PSK with 10 more silent samples ahead: {shifted}, "
                             "not PSK at 100 with tolerance 0 (ROADMAP C1)")
    return {"launches": launches, "gate_launches": gate_launches, "walls": walls}


def estimate_card_vs_cpu_phase(n: int = 200_000, psk_n: int = 20_000):
    """estimate() on the card and on the CPU (plain versions) on the
    captures cut short: the same modulation, bit length, tolerance and
    noise, the center within CENTER_ATOL, and the same decision for every
    classified message of every width bucket."""
    import urh_tpu_torch as ut
    from urh_tpu_torch.ai import estimate as est
    from urh_tpu_torch.ai import segmentation

    psk = dict(n=psk_n, seed=43, n_bits=16, pause=2000, lock_in=1000)
    for label, iq, *_ in estimate_captures(n, psk, 2, EST_BITS, "cuda"):
        card, cpu = ut.estimate(iq, device="cuda"), ut.estimate(iq, device="cpu")
        same = (card is not None and cpu is not None
                and all(card[k] == cpu[k] for k in ("modulation_type", "bit_length",
                                                    "tolerance", "noise"))
                and abs(card["center"] - cpu["center"]) <= CENTER_ATOL)
        data = ut.IQData(iq)
        mags = data.magnitudes
        segments = segmentation.segment_messages_from_magnitudes(
            mags, segmentation.detect_noise_level(mags))[:est._MAX_CLASSIFIED_MESSAGES]
        decisions = [est.classify_messages(data, segments, staged=data.staged_planes(dev))
                     for dev in ("cuda", "cpu")]
        if not same or decisions[0] != decisions[1]:
            raise AssertionError(f"estimate {label}: card {card} {decisions[0]}, "
                                 f"CPU {cpu} {decisions[1]}")
        print(f"estimate card vs CPU, {label} ({len(iq)} samples): {card}; "
              f"{len(segments)} decisions equal", flush=True)


GATE_SOURCE = "urh_tpu_torch/csrc/power_gate.cu"
GATE_REPLACES = ("none: urh_tpu/ai/segmentation.py detect_noise_level and "
                 "segment_messages_from_magnitudes run on the host")
GATE_SIZES = (0, 1, 2, 3, 4, 99, 4095, 4096, 4097, 8193, 20011, 409_617)


def gate_capture(dtype, n: int, seed: int) -> np.ndarray:
    """(n, 2) samples of dtype: kernel_inputs' noise (silent stretches
    included) with a quiet lead of two 1% rows and tone bursts, one up to
    the last sample."""
    rng = np.random.default_rng(seed)
    scale = 1.0 if dtype == np.float32 else (int(np.iinfo(dtype).max) + 1) / 2
    x = rng.normal(0, 0.01 * scale, (n, 2))
    x[:quiet_lead(n)] *= 0.1
    for start, length in ((n // 7, n // 9), (n // 3, 7), (n // 2, n // 5), (n - n // 11, n)):
        k = np.arange(len(x[start:start + length]))
        x[start:start + length, 0] += 0.6 * scale * np.cos(0.01 * k)
        x[start:start + length, 1] += 0.6 * scale * np.sin(0.01 * k)
    if dtype != np.float32:
        info = np.iinfo(dtype)
        x = np.clip(np.rint(x), info.min, info.max)
    return x.astype(dtype)


def gate_same(got: tuple, want: tuple) -> bool:
    """Two (values, values) results equal word for word (floats by their
    bits, NaN payloads included)."""
    ok = True
    for a, b in zip(got, want):
        if isinstance(a, torch.Tensor):
            a, b = a.cpu(), b.cpu()
            if a.dtype.is_floating_point:
                view = torch.int64 if a.dtype == torch.float64 else torch.int32
                a, b = a.view(view), b.view(view)
            ok &= a.dtype == b.dtype and torch.equal(a, b)
        else:
            ok &= a == b
    return bool(ok)


def gate_phase(device, sizes=GATE_SIZES, full=N_FULL) -> dict:
    """The power gate's two passes against their plain versions on the same
    CUDA tensors: every ingest dtype at the sizes around its tiles, at three
    gate levels; float32 and int8 at 2^24 samples, the statistics and the
    crossings equal word for word, and the host's finish (noise_level,
    segments) equal to the host path's (detect_noise_level and
    segment_messages_from_magnitudes over IQData.magnitudes).  Each pass
    timed at 2^24 (L2 flushed; the crossings' launch without the copy of
    their count back) beside its bound and the plain version;
    the gate's whole wall (both passes, their copies back and the host's
    finish) beside the host path's."""
    from urh_tpu_torch import IQData
    from urh_tpu_torch.ai import power_gate as pg
    from urh_tpu_torch.ai import segmentation as seg
    from urh_tpu_torch.util.metrics import metrics

    cases = 0
    for dtype in (np.int8, np.uint8, np.int16, np.uint16, np.float32):
        for n in sizes:
            x = gate_capture(dtype, max(n, 1), seed=n)[:n].copy()
            xt = torch.from_numpy(x).to(device)
            mags = IQData(x).magnitudes
            if n > 3:
                skip, chunk = seg.noise_rows(n)
                if not gate_same(pg.gate_stats(xt, skip, chunk),
                                 pg.gate_stats_plain(xt, skip, chunk)):
                    raise AssertionError(f"power gate stats {np.dtype(dtype).name} n={n}: "
                                         "kernel and plain differ")
            for noise in ((0.0, float(np.median(mags)), 1e30) if n else (0.1,)):
                got = pg.gate_crossings(xt, noise)
                want = pg.gate_crossings_plain(xt, noise)
                torch.cuda.synchronize()  # a fault in the kernel shows here
                if not gate_same(got, want):
                    raise AssertionError(f"power gate crossings {np.dtype(dtype).name} n={n} "
                                         f"noise {noise}: kernel and plain differ")
                cases += 1
    print(f"power gate: {cases} cases at n {sizes}, every dtype: kernel equal to plain",
          flush=True)

    flush = torch.empty(512 << 20, dtype=torch.uint8, device=device)
    timings, walls, settled, crossed = {}, {}, {}, {}
    for dtype in (np.float32, np.int8):
        name = np.dtype(dtype).name
        x = gate_capture(dtype, full, seed=24)
        iq = IQData(x, skip_conversion=True)
        t0 = time.perf_counter()
        mags = iq.magnitudes
        want_noise = seg.detect_noise_level(mags)
        want_segments = seg.segment_messages_from_magnitudes(mags, want_noise)
        host_wall = time.perf_counter() - t0
        staged = iq.staged_planes(device)
        skip, chunk = seg.noise_rows(full)
        stats = pg.gate_stats(staged, skip, chunk)
        crossings = pg.gate_crossings(staged, want_noise)
        if not (gate_same(stats, pg.gate_stats_plain(staged, skip, chunk))
                and gate_same(crossings, pg.gate_crossings_plain(staged, want_noise))):
            raise AssertionError(f"power gate {name} at {full}: kernel and plain differ")
        metrics.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        noise = pg.noise_level(staged, iq)
        segments = pg.segments(staged, noise)
        gate_wall = time.perf_counter() - t0
        settled[name] = metrics.counters().get("gate.settled_rows", 0)
        if noise != want_noise or segments != want_segments:
            raise AssertionError(f"power gate {name} at {full}: noise {noise}, "
                                 f"{len(segments)} segments; the host path {want_noise}, "
                                 f"{len(want_segments)}")
        timings[name] = {
            "stats_ms": time_ms(lambda: pg.gate_stats(staged, skip, chunk), flush),
            "crossings_ms": time_ms(lambda: pg.launch_crossings(staged, noise), flush),
            "stats_plain_ms": time_ms(lambda: pg.gate_stats_plain(staged, skip, chunk), flush,
                                      runs=5, warmup=1),
            "crossings_plain_ms": time_ms(lambda: pg.gate_crossings_plain(staged, noise), flush,
                                          runs=5, warmup=1),
        }
        walls[name] = (gate_wall, host_wall)
        crossed[name] = len(crossings[0])
        print(f"power gate {name} at {full}: noise {noise}, {len(segments)} segments, "
              f"{len(crossings[0])} crossings, {settled[name]} rows settled, equal to the host "
              f"path; {timings[name]}; the gate's wall {gate_wall} s, the host path's "
              f"{host_wall} s", flush=True)
    return {"timings": timings, "walls": walls, "settled": settled, "crossings": crossed}


def tx_modulator(mt: str, bps: int, params):
    from urh_tpu_torch import Modulator

    m = Modulator(f"{mt} {bps}")
    m.modulation_type = mt
    m.bits_per_symbol = bps
    m.samples_per_symbol = 100
    m.carrier_freq_hz = 30e3
    m.carrier_phase_deg = 20
    m.parameters = params
    return m


def tx_phase(device, n_body: int = TX_BODY, n_capture: int = N_FULL) -> dict:
    """Modulator.modulate for every type, bits a symbol and output type at a
    body of n_body samples, on the card against the port on the CPU: float32
    within TX_FLOAT_ULPS ulps of the amplitude, int8/int16 within 1 (the
    truncation of a value on an integer boundary), those samples counted.
    Then an n_capture-sample FSK capture synthesized on the card goes
    through estimate() and demodulate() back to its bits.  -> the
    synthesis rate (samples/s, host clock) by case."""
    import urh_tpu_torch as ut

    rng = np.random.default_rng(17)
    rates = {}
    for mt, bps, params in TX_CASES:
        bits = "".join(map(str, rng.integers(0, 2, bps * (n_body // 100))))
        m = tx_modulator(mt, bps, params)
        for name, (dtype, amplitude) in TX_DTYPES.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = m.modulate(bits, pause=1000, start=5, dtype=dtype, device=device).data
            wall = time.perf_counter() - t0
            cpu = m.modulate(bits, pause=1000, start=5, dtype=dtype, device="cpu").data
            diff = np.abs(card.astype(np.float64) - cpu)
            limit = (TX_FLOAT_ULPS * float(np.finfo(np.float32).eps) * amplitude
                     if dtype == np.float32 else 1)
            if card.shape != cpu.shape or diff.max() > limit:
                raise AssertionError(f"TX {mt} {bps} {name}: card and CPU differ by "
                                     f"{diff.max()} (limit {limit})")
            rates[(mt, bps, name)] = len(card) / wall
            print(f"TX {mt} {bps} bit(s) a symbol {name}: {len(card)} samples, max diff "
                  f"{diff.max()} (limit {limit}), {int((diff > 0).sum())} values differ; "
                  f"{rates[(mt, bps, name)]} samples/s on {device or 'the card'}", flush=True)

    # an FSK capture made by the port on the card (silence, then [message,
    # pause] * k), estimated and decoded back
    period, lead = 20000 + 256 * 100, quiet_lead(n_capture)
    sent = rng.integers(0, 2, ((n_capture - lead) // period, 256), dtype=np.uint8)
    sent[:, 0] = 1
    fsk = tx_modulator("FSK", 1, [-25e3, 25e3])
    fsk.carrier_freq_hz = 0.0
    t0 = time.perf_counter()
    parts = [fsk.modulate(b, pause=20000, device=device).data for b in sent]
    wall = time.perf_counter() - t0
    iq = np.concatenate([np.zeros((lead, 2), np.float32)] + parts + [
        np.zeros((n_capture - lead - len(sent) * period, 2), np.float32)])
    iq += rng.normal(0, 0.01, iq.shape).astype(np.float32)
    sig = ut.Signal.from_iq(iq, device=device)
    if not sig.auto_detect(detect_noise=True) or sig.modulation_type != "FSK":
        raise AssertionError(f"TX capture: estimated {sig.params}")
    check_bits([m.plain_bits for m in ut.demodulate(sig)], sent, "TX FSK capture")
    print(f"TX FSK capture of {len(iq)} samples ({len(sent)} messages, synthesized in "
          f"{wall} s, {len(iq) / wall} samples/s): estimated {sig.params}, every message "
          f"bit-exact", flush=True)
    return rates


# -- B8 (IIR feedback), filters, spectrum, plot paths and awre -----------------

B8_NS = (1, 2, 4, 5, 9, 40)  # feedback taps: the register ring up to 8, then shared memory
B8_FULL_NS = (1, 2, 4, 9)  # the ones checked up to B8_PLAIN_N (the plain loop is slow)
B8_TIMED_N = 1 << 22
B8_TIMED_TAPS = 4  # a 4th-order Butterworth's feedback
B8_TIMED_RUNS = 3  # one launch at 2^22 takes tens of milliseconds
B8_PLAIN_N = 1 << 14
B8_BYTES_PER_SAMPLE = 8 + 8
B8_SOURCE = "urh_tpu_torch/csrc/iir_feedback.cu"
B8_REPLACES = "urh_tpu/dsp/filters.py:115"
BANDPASS = (-0.05, 0.05, 0.08)  # f_low, f_high, bandwidth: a 51-tap band-pass
FIR_ATOL = 1e-3  # the card's torch.fft against the CPU's, unit-scale samples
IIR_RTOL = 1e-3  # of max|y|: float32 recursion against lfilter in float64
DB_ATOL = 0.05
# below this power (dB) float32 FFT rounding, some 1e-8 of a unit-scale
# frame's amplitude, is a sizeable part of a bin's magnitude: on the FSK
# capture the port's CPU STFT against float64 stays within 0.013 dB above
# it and reaches 0.13 dB below it, and the card against the CPU within
# 0.05 dB above -110 dB (0.049) and 0.66 below.  40 dB under the
# colormap's floor; 99.9% of the capture's cells lie above it.
DB_FLOOR = -100.0
FSK_TONE_HZ = 25e3
AWRE_MESSAGES = 1000  # bench.py's awre protocol


def b8_inputs(n: int, n_taps: int, seed: int):
    """(n, 2) interleaved complex feed-forward sums, both planes non-zero,
    with a stretch of +-0 and a row of large amplitude, and stable taps of
    both signs (b reversed), on the host."""
    rng = np.random.default_rng(seed)
    ff = rng.normal(size=(n, 2)).astype(np.float32)
    ff[100:140] = np.where(rng.integers(0, 2, (40, 2)) == 1, 0.0, -0.0)
    ff[300:305] = rng.choice([-1e30, 1e30], size=(5, 2))
    taps = (rng.uniform(-0.9, 0.9, n_taps) / max(n_taps, 1)).astype(np.float32)
    return ff, taps


def b8_bound_ms(n: int, chain_cycles: float, clock_hz: float) -> tuple[float, str]:
    """The larger of the loop-carried chain (n steps of chain_cycles SM
    cycles at the maximum clock) and the bytes (each read and written once)."""
    chain_ms = n * chain_cycles / clock_hz * 1e3
    byte_ms = n * B8_BYTES_PER_SAMPLE / HBM_BYTES_PER_S * 1e3
    return max(chain_ms, byte_ms), "chain" if chain_ms >= byte_ms else "bytes"


def b8_phase(device, ns=B8_NS, full_ns=B8_FULL_NS, plain_n=B8_PLAIN_N,
             timed_n=B8_TIMED_N) -> dict:
    """B8 against its plain loop on the same CUDA tensors, every word: for
    each tap count, one plain run over the longest input and a kernel
    launch at each length n = 1, N + 1, N + 2 (where iir_filter's start
    falls), 1000 and around its 1,024-sample tile, and for full_ns also 2^14
    (the first n outputs of the plain run are those of the first n samples);
    the chain's latency measured (iir_kernels.chain_cycles); the kernel
    timed at timed_n (3 runs after 1) for several tap counts, the plain loop
    at plain_n (1 run)."""
    from urh_tpu_torch.dsp import iir_kernels as ik

    err, mismatch, cases = 0.0, 0, 0
    for n_taps in ns:
        sizes = sorted({1, n_taps + 1, n_taps + 2, 1000, 1023, 1024, 1025}
                       | ({plain_n} if n_taps in full_ns else set()))
        ff, taps = b8_inputs(max(sizes), n_taps, seed=n_taps)
        x = torch.from_numpy(ff).to(device)
        b_rev = torch.from_numpy(taps).to(device)
        want = ik.iir_feedback_plain(x, b_rev)
        for n in sizes:
            got = ik.iir_feedback(x[:n].clone(), b_rev)
            torch.cuda.synchronize()  # a fault in the kernel shows here
            bad = int((got.view(torch.int32) != want[:n].view(torch.int32)).sum())
            finite = torch.isfinite(got) & torch.isfinite(want[:n])
            e = (got - want[:n]).abs()[finite].max().item() if bool(finite.any()) else 0.0
            err, mismatch, cases = max(err, e), mismatch + bad, cases + 1
        print(f"iir feedback N={n_taps}: n {sizes}: max_abs_err {err}, mismatching words "
              f"{mismatch}", flush=True)
    if err or mismatch:
        raise AssertionError(f"iir feedback: max_abs_err {err}, {mismatch} mismatching words")

    cycles = ik.chain_cycles(device)
    ms = {}
    for n_taps in (1, B8_TIMED_TAPS, 9):
        ff, taps = b8_inputs(timed_n, n_taps, seed=n_taps)
        x = torch.from_numpy(ff).to(device)
        b_rev = torch.from_numpy(taps).to(device)
        ms[n_taps] = time_ms(lambda: ik.iir_feedback(x, b_rev), runs=B8_TIMED_RUNS, warmup=1)
    ff, taps = b8_inputs(plain_n, B8_TIMED_TAPS, seed=B8_TIMED_TAPS)
    x = torch.from_numpy(ff).to(device)
    b_rev = torch.from_numpy(taps).to(device)
    plain_ms = time_ms(lambda: ik.iir_feedback_plain(x, b_rev), runs=1, warmup=0)
    print(f"iir feedback: {cases} cases equal; chain step {cycles} SM cycles (FMUL + 2 FADD, "
          f"clock64); timed at n={timed_n}: {ms} ms by tap count (median of "
          f"{B8_TIMED_RUNS} after 1), plain {plain_ms} ms at n={plain_n}, "
          f"N={B8_TIMED_TAPS} (1 run)", flush=True)
    return {"err": err, "mismatch": mismatch, "cycles": cycles, "ms": ms, "plain_ms": plain_ms}


def check_filtered(card: np.ndarray, cpu: np.ndarray, label: str):
    """Filtered samples of the card against the port's on the CPU: float32
    within FIR_ATOL, int8 within 1 (a value on an integer boundary may
    truncate either way)."""
    diff = np.abs(card.astype(np.float64) - cpu)
    limit = 1 if card.dtype == np.int8 else FIR_ATOL
    print(f"filter_range {label}: card against CPU max diff {diff.max()} (limit {limit}) "
          f"over {len(card)} samples", flush=True)
    if diff.max() > limit:
        raise AssertionError(f"filter_range {label}: card and CPU differ by {diff.max()}")


def filter_range_phase(device, n: int, cpu_n: int = 1 << 20) -> dict:
    """Signal.filter_range with the 51-tap band-pass over each FSK capture
    (float32, int8) with qad cached, on the default device: demodulate()
    from the re-demodulated qad, then with the cache dropped through the
    capture's kernel (K1, K2), every message bit-exact both times; the
    first cpu_n filtered samples against the port's filter_range on the CPU
    over that cut (a causal filter: the cut's outputs are the capture's).
    -> walls (s) and the float32 capture as it was made (complex64)."""
    import urh_tpu_torch as ut
    from urh_tpu_torch.dsp import fused_kernels as fk
    from urh_tpu_torch.dsp.filters import Filter

    fir = Filter(Filter.design_windowed_sinc_bandpass(*BANDPASS))
    iq, bits = make_capture("FSK", n, 11)
    walls = {}
    for dtype, capture, key in (("float32", iq, "fsk_f32"), ("int8", to_int8(iq), "fsk_i8")):
        params = demod_params("FSK", capture.dtype)
        sig = ut.Signal.from_iq(capture.copy(), device=device)
        sig.params = params
        sig.qad
        t0 = time.perf_counter()
        sig.filter_range(0, n, fir)
        torch.cuda.synchronize()
        walls[dtype] = time.perf_counter() - t0
        check_messages(ut.demodulate(sig), bits, f"FSK {dtype} filtered, from qad")
        reset_launches()
        check_messages(ut.demodulate(sig, params), bits, f"FSK {dtype} filtered")
        if fk.LAUNCHES[key] != 1:
            raise AssertionError(f"filtered FSK {dtype}: launches {fk.LAUNCHES}")
        cut = ut.Signal.from_iq(capture[:cpu_n].copy(), device="cpu")
        cut.params = params
        cut.filter_range(0, cpu_n, fir)
        check_filtered(sig.iq_array.data[:cpu_n], cut.iq_array.data, dtype)
        print(f"filter_range FSK {dtype} ({n} samples): wall {walls[dtype]} s; "
              f"{len(bits)} messages bit-exact from qad and through {key}", flush=True)
    return {"walls": walls, "capture": iq.view(np.complex64).reshape(-1)}


def lfilter_reference(a, b, x: np.ndarray) -> np.ndarray:
    """urh_tpu's iir_filter in float64 by scipy: feed-forward from start =
    max(len(a), len(b) + 1) on, then the feedback (urh_tpu adds it, so the
    denominator is 1 - b) from a zero carry; zero before start."""
    from scipy.signal import lfilter

    start = max(len(a), len(b) + 1)
    ff = lfilter(a, [1.0], x.astype(np.complex128))[start:]
    out = np.zeros(len(x), np.complex128)
    out[start:] = lfilter([1.0], np.r_[1.0, -np.asarray(b, np.float64)], ff)
    return out


def iir_phase(device, x: np.ndarray) -> dict:
    """iir_filter over the complex capture x on the default device as a DC
    blocker and as a 4th-order Butterworth low-pass, against
    lfilter_reference within IIR_RTOL of max|y|, each through one B8 launch
    (counted from 0 just before).  -> walls (s) and launches."""
    from scipy.signal import butter

    from urh_tpu_torch.dsp.filters import iir_filter

    num, den = butter(4, 0.1)
    filters = {"DC blocker": ([1.0, -1.0], [0.995]),
               "Butterworth 4": (list(num), list(-den[1:]))}  # urh_tpu adds the feedback
    walls, launches = {}, 0
    for label, (a, b) in filters.items():
        reset_launches()
        t0 = time.perf_counter()
        y = iir_filter(a, b, x, device=device)
        walls[label] = time.perf_counter() - t0
        count = read_launches()["iir_feedback_f32"]
        want = lfilter_reference(a, b, x)
        rel = np.abs(y - want).max() / np.abs(want).max()
        print(f"iir_filter {label} over {len(x)} samples: wall {walls[label]} s, B8 launches "
              f"{count}, max error {rel} of max|y| (limit {IIR_RTOL})", flush=True)
        if count != 1 or not rel <= IIR_RTOL:
            raise AssertionError(f"iir_filter {label}: launches {count}, error {rel}")
        launches += count
    return {"walls": walls, "launches": launches}


def spectrum_phase(device, x: np.ndarray) -> dict:
    """Spectrogram(window 1024).create_spectrogram_image() of x on the
    default device; its dB image against the port's on the CPU (DB_ATOL on
    finite cells at or above DB_FLOOR, the same non-finite cells), colour
    indices within 1 on every cell, the FSK tones' peak bins at +-25 kHz;
    create_path over x's real part on the card equal to the CPU's.
    -> walls (s)."""
    from urh_tpu_torch.dsp.decimation import create_path
    from urh_tpu_torch.dsp.spectrogram import Spectrogram
    from urh_tpu_torch.util import colormaps

    spec = Spectrogram(x, window_size=1024, device=device)
    walls = {}
    t0 = time.perf_counter()
    image = spec.create_spectrogram_image()
    walls["spectrogram image"] = time.perf_counter() - t0
    card = spec._calculate_spectrogram(spec.samples)
    cpu = Spectrogram(x, window_size=1024, device="cpu")._calculate_spectrogram(spec.samples)
    finite = np.isfinite(card)
    same_cells = np.array_equal(finite, np.isfinite(cpu)) and np.array_equal(
        card[~finite], cpu[~finite])
    above = finite & (cpu >= DB_FLOOR)
    db_err = float(np.abs(card[above] - cpu[above]).max())
    low_err = float(np.abs(card[finite & ~above] - cpu[finite & ~above]).max(initial=0.0))
    n_colors = len(colormaps.chosen_colormap_numpy_bgra)
    index_err = int(np.abs(
        Spectrogram.color_indices(card, n_colors, spec.data_min, spec.data_max)
        - Spectrogram.color_indices(cpu, n_colors, spec.data_min, spec.data_max)).max())
    # column j of the flipped, shifted image is the frequency (511 - j) / 1024 fs
    power = np.mean(10.0 ** (card / 10.0), axis=0)
    freqs = (511 - np.arange(1024)) / 1024 * 1e6
    peaks = [float(freqs[np.flatnonzero(side)[np.argmax(power[side])]])
             for side in (freqs > 0, freqs < 0)]
    print(f"spectrogram {card.shape} ({card.nbytes} bytes of dB, image {image.shape}): wall "
          f"{walls['spectrogram image']} s; card against CPU max dB diff {db_err} (limit "
          f"{DB_ATOL}) on the {above.mean():.6%} of cells at or above {DB_FLOOR} dB, "
          f"{low_err} below; non-finite cells equal {same_cells}, colour index diff "
          f"{index_err}; peaks at {peaks} Hz", flush=True)
    if not (same_cells and db_err <= DB_ATOL and index_err <= 1
            and all(abs(abs(f) - FSK_TONE_HZ) <= 1e6 / 1024 for f in peaks)):
        raise AssertionError("spectrogram: card and CPU differ, or the tones are off")

    t0 = time.perf_counter()
    (xs, ys), = create_path(x.real, 0, len(x), device=device)
    walls["create_path"] = time.perf_counter() - t0
    (cpu_xs, cpu_ys), = create_path(x.real, 0, len(x), device="cpu")
    same = np.array_equal(xs, cpu_xs) and np.array_equal(ys, cpu_ys)
    print(f"create_path over {len(x)} samples: {len(ys) // 2} pixels, wall "
          f"{walls['create_path']} s, min/max equal to the CPU's {same}", flush=True)
    if not same or len(ys) != 2 * (len(x) // int(len(x) / 5000)):  # 5,000 pixels at 2^24
        raise AssertionError("create_path: card and CPU differ")
    return walls


def awre_protocol(n_msgs: int):
    """bench.py's awre protocol (bench.py:556-592) from the port's own
    ProtocolGenerator, every message on one shared empty message type."""
    from urh_tpu_torch.awre.message_type_builder import MessageTypeBuilder
    from urh_tpu_torch.awre.protocol_generator import ProtocolGenerator
    from urh_tpu_torch.protocol.labels import FieldType, MessageType, Participant

    f = FieldType.Function
    alice, bob = Participant("Alice", address_hex="1337"), Participant("Bob", address_hex="4711")
    mb = MessageTypeBuilder("data")
    for function, width in ((f.PREAMBLE, 16), (f.SYNC, 16), (f.LENGTH, 8), (f.SRC_ADDRESS, 16),
                            (f.DST_ADDRESS, 16), (f.SEQUENCE_NUMBER, 8)):
        mb.add_label(function, width)
    pg = ProtocolGenerator([mb.message_type], syncs_by_mt={mb.message_type: "0x9a7d"},
                           participants=[alice, bob])
    rng = np.random.default_rng(42)
    for i in range(n_msgs):
        data = "".join(rng.choice(["0", "1"], size=16 if i % 2 else 32))
        src, dst = (alice, bob) if i % 2 else (bob, alice)
        pg.generate_message(data=data, source=src, destination=dst)
    empty = MessageType("empty")
    for msg in pg.messages:
        msg.message_type = empty
    return pg.messages


def format_summary(ff) -> tuple:
    """(message types with their labels as (name, start, end, field type),
    their member indices) of a FormatFinder."""
    types = [(mt.name, [(lbl.name, int(lbl.start), int(lbl.end),
                         lbl.field_type.function.name if lbl.field_type else None)
                        for lbl in mt]) for mt in ff.message_types]
    members = sorted((mt.name, sorted(int(i) for i in indices))
                     for mt, indices in ff.existing_message_types.items())
    return types, members


def awre_phase(device, n_msgs: int = AWRE_MESSAGES) -> dict:
    """FormatFinder.run(10) over bench.py's protocol on the card and on the
    CPU: the same message types, labels and members, the messages
    unchanged; auto_assign_labels() on the default device; to_pcapng
    written under build/.  -> walls (s)."""
    import os

    from urh_tpu_torch import ProtocolAnalyzer
    from urh_tpu_torch.awre.format_finder import FormatFinder

    walls, found = {}, {}
    for where in (device, "cpu"):
        messages = awre_protocol(n_msgs)
        bits = [m.plain_bits_str for m in messages]
        t0 = time.perf_counter()
        ff = FormatFinder(messages, device=where)
        ff.run(max_iterations=10)
        walls[str(where)] = time.perf_counter() - t0
        found[str(where)] = format_summary(ff)
        if [m.plain_bits_str for m in messages] != bits:
            raise AssertionError(f"FormatFinder on {where} changed the messages")
    card, cpu = found[str(device)], found["cpu"]
    print(f"awre FormatFinder over {n_msgs} messages: walls (s) {walls}; message types "
          f"{len(card[0])}, labels {card[0][:3]}; card equal to CPU {card == cpu}", flush=True)
    if card != cpu or not card[0]:
        raise AssertionError("awre: the card's message types differ from the CPU's")

    proto = ProtocolAnalyzer(None)
    proto.messages = awre_protocol(n_msgs)
    t0 = time.perf_counter()
    proto.auto_assign_labels()
    walls["auto_assign_labels"] = time.perf_counter() - t0
    assigned = sorted({m.message_type.name for m in proto.messages})
    if assigned != sorted(name for name, _ in card[0]):
        raise AssertionError(f"auto_assign_labels: {assigned}")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke",
                        "awre.pcapng")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    proto.to_pcapng(path)
    print(f"auto_assign_labels over {n_msgs} messages: wall {walls['auto_assign_labels']} s, "
          f"types {assigned}; to_pcapng wrote {os.path.getsize(path)} bytes", flush=True)
    return walls


# -- the live loop: ProtocolSniffer over the Network SDR, TX back onto it -------

LIVE_DEADLINE_S = 120.0  # for every wait of the live phase
LIVE_SILENCE_GATES = 2  # silence sent after a capture, in pause gates
LIVE_TX_MESSAGES, LIVE_TX_BITS, LIVE_TX_PAUSE = 64, 256, 20000
LIVE_TX_FUZZ = 16  # values of the fuzzed 8-bit label (the first is its default)
NETWORK_SDR = "Network SDR"


class ThreadFaults:
    """Records every exception that ends a thread (threading.excepthook), so
    a fault on the sniffer's poll thread fails the phase."""

    def __init__(self):
        import threading

        self.faults, self._threading = [], threading

    def __enter__(self):
        self._saved = self._threading.excepthook
        self._threading.excepthook = lambda args: self.faults.append(
            f"{args.thread.name if args.thread else '?'}: {args.exc_type.__name__}: "
            f"{args.exc_value}")
        return self

    def __exit__(self, *exc):
        self._threading.excepthook = self._saved

    def check(self, label: str):
        if self.faults:
            raise AssertionError(f"{label}: threads raised {self.faults}")


def wait_for(condition, what: str, deadline_s: float = LIVE_DEADLINE_S):
    deadline = time.monotonic() + deadline_s
    while not condition():
        if time.monotonic() > deadline:
            raise AssertionError(f"live: {what} not reached within {deadline_s} s")
        time.sleep(0.001)


def live_sniffer(device, p, start: bool = True):
    """A port ProtocolSniffer on ``device`` with p's parameters, its Network
    SDR in raw mode on a free port, started unless ``start`` is False (then
    the port is None); -> (sniffer, its receive server port, a record of
    drain sizes and of the first sample's and each message's time)."""
    from urh_tpu_torch.dev.backend_handler import BackendHandler
    from urh_tpu_torch.protocol.sniffer import ProtocolSniffer

    sniffer = ProtocolSniffer(p.samples_per_symbol, p.center, p.center_spacing,
                              p.noise_threshold, p.tolerance, p.modulation, p.bits_per_symbol,
                              NETWORK_SDR, BackendHandler(), network_raw_mode=True,
                              compute_device=device)
    record = {"drains": [], "first_sample": None, "messages": []}
    ingest = sniffer._ingest

    def counted_ingest(chunk):
        record["drains"].append(len(chunk))
        ingest(chunk)

    sniffer._ingest = counted_ingest
    sniffer.message_sniffed.connect(lambda _: record["messages"].append(time.perf_counter()))
    sniffer.rcv_device.set_server_port(0)
    if not start:
        return sniffer, None, record
    sniffer.sniff()
    server = sniffer.rcv_device.underlying_device.server
    sink = server.sink

    def timed_sink(frames):
        if record["first_sample"] is None and len(frames):
            record["first_sample"] = time.perf_counter()
        sink(frames)

    server.sink = timed_sink  # read by each connection's handler
    return sniffer, sniffer.rcv_device.underlying_device.server_port, record


def wait_drained(sniffer, total: int, label: str):
    """Wait until the receive index reached ``total`` and the sniffer fed
    every sample up to it.  The receive buffer is larger than every capture
    sent, so its index must not wrap (C5: a wrap splices stale samples into
    the stream)."""
    dev = sniffer.rcv_device
    if total >= len(dev.data):
        raise AssertionError(f"{label}: {total} samples do not fit the receive buffer")
    wait_for(lambda: dev.current_index == total and sniffer.drain_position == total,
             f"{label}: {total} samples received and drained")


def drain_and_stop(sniffer, total: int, label: str):
    """wait_drained, then stop the sniffer; the index must not have wrapped."""
    dev = sniffer.rcv_device
    wait_drained(sniffer, total, label)
    sniffer.stop()
    if dev.current_index != total:
        raise AssertionError(f"{label}: the receive index wrapped ({dev.current_index})")


def send_raw(port: int, data: np.ndarray):
    from urh_tpu_torch import IQData
    from urh_tpu_torch.dev.network_sdr import NetworkSDRInterfacePlugin

    sender = NetworkSDRInterfacePlugin(raw_mode=True, sending=True)
    sender.client_port = port
    sender.send_raw_data(IQData(data, skip_conversion=True), 1)


def live_rx(device, iq: np.ndarray, p, label: str) -> dict:
    """Send iq, then LIVE_SILENCE_GATES pause gates of silence, to a sniffer
    on ``device``, and once those are fed one gate more, as a continuing
    stream sends.  -> the sniffer's messages' bits, the
    record of live_sniffer, the samples sent, the wall from the first
    sample received to the last message, the stream's kernel launches and
    sniffer.demodulate's report."""
    from urh_tpu_torch.dsp import costas
    from urh_tpu_torch.dsp import stream_kernels as sk
    from urh_tpu_torch.protocol import stream
    from urh_tpu_torch.util.metrics import metrics

    silence = np.zeros((LIVE_SILENCE_GATES * stream.PAUSE_GATE_SYMBOLS * p.samples_per_symbol,
                        2), np.float32)
    for counts in (sk.LAUNCHES, costas.LAUNCHES, stream.FALLBACKS, stream.HOST_ROUTE):
        for key in counts:
            counts[key] = 0
    metrics.clear()
    gate = silence[:len(silence) // LIVE_SILENCE_GATES]
    sniffer, port, record = live_sniffer(device, p)
    send_raw(port, iq)
    send_raw(port, silence)
    wait_drained(sniffer, len(iq) + len(silence), label)
    send_raw(port, gate)
    drain_and_stop(sniffer, len(iq) + len(silence) + len(gate), label)
    launches = {**sk.LAUNCHES, **costas.LAUNCHES}
    if stream.FALLBACKS["states"] or any(stream.HOST_ROUTE.values()):
        raise AssertionError(f"{label}: fallbacks {stream.FALLBACKS}, host route "
                             f"{stream.HOST_ROUTE}")
    if not record["messages"]:
        raise AssertionError(f"{label}: no message")
    return dict(bits=[m.plain_bits for m in sniffer.messages], record=record,
                total=len(iq) + len(silence) + len(gate),
                wall=record["messages"][-1] - record["first_sample"], launches=launches,
                report=metrics.report()["sniffer.demodulate"])


def device_busy_share(trace_path: str, wall_s: float) -> tuple[float, float]:
    """-> (the union of kernel, memcpy and memset time in a Chrome trace over
    wall_s, the same over the span from the first such event to the last)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
    if not spans:
        raise AssertionError("live: the trace holds no device activity")
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy * 1e-6 / wall_s, busy / (end - spans[0][0])


def pinned_allocation_ms(sizes) -> dict:
    """ms of a pinned host allocation of each size, as a stream's staging
    slot makes it, after the caching host allocator was emptied (where this
    torch has the call); -> {bytes: (ms, whether it called cudaHostAlloc)}."""
    empty_cache = next((getattr(torch._C, name) for name in (
        "_host_emptyCache", "_accelerator_emptyHostCache", "_cuda_hostEmptyCache")
        if hasattr(torch._C, name)), None)
    out = {}
    for nbytes in sizes:
        if empty_cache is not None:
            empty_cache()
        before = torch.cuda.host_memory_stats().get("num_host_alloc")
        t0 = time.perf_counter()
        buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        ms = (time.perf_counter() - t0) * 1e3
        after = torch.cuda.host_memory_stats().get("num_host_alloc")
        out[nbytes] = (ms, None if before is None else after > before)
        del buf
    return out


def live_tx_container(seed: int = 19):
    """LIVE_TX_MESSAGES messages of LIVE_TX_BITS random bits, the first with
    an 8-bit label fuzzed successively over LIVE_TX_FUZZ values."""
    from urh_tpu_torch.protocol.container import ProtocolAnalyzerContainer
    from urh_tpu_torch.protocol.message import Message

    rng = np.random.default_rng(seed)
    container = ProtocolAnalyzerContainer()
    container.messages = [
        Message.from_plain_bits_str("".join(map(str, bits)), pause=LIVE_TX_PAUSE)
        for bits in rng.integers(0, 2, (LIVE_TX_MESSAGES, LIVE_TX_BITS))]
    label = container.messages[0].message_type.add_protocol_label(16, 23)  # 8 bits
    label.fuzz_me = True
    label.fuzz_values = [format(v, "08b") for v in rng.choice(256, LIVE_TX_FUZZ, replace=False)]
    if len(container.fuzz_successive()) != LIVE_TX_FUZZ - 1:
        raise AssertionError("live TX: the container's fuzzing")
    return container


def native_host_route_phase(device, iq: np.ndarray, identity: str,
                            chunk: int = STREAM_CHUNK) -> dict:
    """The native library builds, and the stream's host route (its fused block
    and run-length encoder, one call each a chunk) gives the device route's
    segments on the FSK capture; -> the host route's counts."""
    import urh_tpu_torch as ut
    from urh_tpu_torch import native
    from urh_tpu_torch.protocol import stream

    if not native.is_available():
        raise AssertionError("live: the native library did not build")
    params = demod_params("FSK", np.float32)
    for key in stream.HOST_ROUTE:
        stream.HOST_ROUTE[key] = 0
    t0 = time.perf_counter()
    host = stream_segments(ut.StreamDemodulator(params, backend="host", device=device), iq, chunk)
    wall = time.perf_counter() - t0
    counts = dict(stream.HOST_ROUTE)
    card = stream_segments(ut.StreamDemodulator(params, backend="device", device=device), iq,
                           chunk)
    chunks = -(-len(iq) // chunk)
    if counts != {"native_block": chunks, "numpy_block": 0, "native_rle": chunks}:
        raise AssertionError(f"live: host route counts {counts} for {chunks} chunks")
    key = [(s.start_sample, s.num_samples, s.ppseq.tolist()) for s in host]
    if key != [(s.start_sample, s.num_samples, s.ppseq.tolist()) for s in card]:
        raise AssertionError("live: the host route's segments differ from the device route's")
    print(f"live native host route: library {native.build.build()}, {len(host)} segments equal "
          f"to the device route's, counts {counts}, {len(iq) / wall} samples/s (host clock) "
          f"on {identity}", flush=True)
    return counts


def live_phase(device, identity: str, n: int = N_FULL, psk_n: int = B5_TIMED_N) -> dict:
    """The live loop on ``device`` (None: the card): RX of the FSK and BPSK
    captures over the Network SDR through the sniffer (B6, B5), the same FSK
    run again under torch.profiler for the card's busy share, TX of a fuzzed
    container by GeneratorBackend (one buffer) and by ContinuousModulator
    (its spawned child) back through a sniffer; ``identity`` (the card's
    name and power limit) ends each line of numbers.  -> numbers for the
    summary."""
    import os

    import urh_tpu_torch as ut
    from urh_tpu_torch.dev.backend_handler import BackendHandler
    from urh_tpu_torch.dev.virtual_device import Mode, VirtualDevice
    from urh_tpu_torch.dsp.continuous_modulator import ContinuousModulator
    from urh_tpu_torch.protocol.generator import GeneratorBackend
    from urh_tpu_torch.util.metrics import TRACE_FILE, profile_trace

    out = {}
    with ThreadFaults() as faults:
        iq, bits = make_capture("FSK", n, seed=11)
        out["native"] = native_host_route_phase(device, iq, identity)

        p = demod_params("FSK", np.float32)
        rx = live_rx(device, iq, p, "live FSK")
        got, drains, wall, launches, report = (rx["bits"], rx["record"]["drains"], rx["wall"],
                                               rx["launches"], rx["report"])
        faults.check("live FSK")
        check_bits(got, bits, "live FSK")
        if launches["stream_block_f32"] != report["calls"] or not report["calls"]:
            raise AssertionError(f"live FSK: {launches['stream_block_f32']} stream block "
                                 f"launches for {report['calls']} drains")
        n_total = rx["total"]
        out["fsk"] = dict(drains=len(drains), min=min(drains), median=statistics.median(drains),
                          max=max(drains), wall=wall, rate=n_total / wall,
                          demod_rate=report["samples_per_second"],
                          launches=launches["stream_block_f32"])
        print(f"live FSK: {len(got)} messages bit-exact; {len(drains)} drains of min "
              f"{min(drains)}, median {statistics.median(drains)}, max {max(drains)} samples; "
              f"stream block launches {launches['stream_block_f32']} = sniffer.demodulate calls "
              f"{report['calls']}; no fallback, no host block, no wrap; wall from the first "
              f"sample received to the last message {wall} s ({n_total / wall} samples/s); "
              f"sniffer.demodulate {report['samples_per_second']} samples/s on {identity}",
              flush=True)
        out["pin_ms"] = pinned_allocation_ms((max(drains) * 8, len(iq) * 8))
        print(f"live: pinned staging buffers of the largest drain's and the whole capture's "
              f"bytes allocate in {out['pin_ms']} (bytes: ms, whether cudaHostAlloc ran) on "
              f"{identity}",
              flush=True)

        psk_iq, psk_bits = make_psk_capture(psk_n, seed=13)
        offline = [m.plain_bits for m in ut.demodulate(
            ut.Signal.from_iq(psk_iq, device=device), psk_params())]
        rx = live_rx(device, psk_iq, psk_params(), "live PSK")
        got, wall, launches, report = rx["bits"], rx["wall"], rx["launches"], rx["report"]
        faults.check("live PSK")
        check_psk_messages(got, psk_bits, "live PSK")
        if got != offline:
            raise AssertionError("live PSK: the sniffer's bits differ from demodulate()'s")
        if launches["costas_f32"] != report["calls"] or not report["calls"]:
            raise AssertionError(f"live PSK: {launches['costas_f32']} Costas launches for "
                                 f"{report['calls']} drains")
        out["psk"] = dict(drains=len(rx["record"]["drains"]), wall=wall,
                          launches=launches["costas_f32"])
        print(f"live PSK: {len(got)} bit lists equal to demodulate()'s on the card, Costas "
              f"launches {launches['costas_f32']} = drains {report['calls']}; wall {wall} s on "
              f"{identity}",
              flush=True)

        trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                 "chip_smoke", "live_trace")
        with profile_trace(trace_dir):
            rx = live_rx(device, iq, p, "live FSK traced")
        faults.check("live FSK traced")
        check_bits(rx["bits"], bits, "live FSK traced")
        wall, n_drains = rx["wall"], len(rx["record"]["drains"])
        share, active_share = device_busy_share(os.path.join(trace_dir, TRACE_FILE), wall)
        out["busy"] = dict(share=share, active_share=active_share, wall=wall, drains=n_drains)
        print(f"live FSK traced: the card busy {share:.4%} of the live wall ({wall} s, "
              f"{n_drains} drains; kernels, copies and fills), {active_share:.4%} "
              f"from its first device event to its last, on {identity}", flush=True)

        container = live_tx_container()
        fsk = tx_modulator("FSK", 1, [-25e3, 25e3])
        fsk.carrier_freq_hz = 0.0
        sent = [np.frombuffer(bytes(m.encoded_bits), np.uint8) for m in container.messages]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = GeneratorBackend(container, [fsk], device=device).generate()
        gen_wall = time.perf_counter() - t0
        cpu = GeneratorBackend(container, [fsk], device="cpu").generate()
        diff = np.abs(card.data.astype(np.float64) - cpu.data)
        limit = TX_FLOAT_ULPS * float(np.finfo(np.float32).eps)
        if card.data.dtype != np.float32 or card.data.shape != cpu.data.shape or \
                diff.max() > limit:
            raise AssertionError(f"live TX: the card's buffer differs from the CPU's by "
                                 f"{diff.max()} (limit {limit})")
        sniffer, port, _ = live_sniffer(device, p)
        sender = VirtualDevice(BackendHandler(), NETWORK_SDR, Mode.send,
                               samples_to_send=card, sending_repeats=1)
        sender.set_client_port(port)
        sender.start()
        wait_for(lambda: sender.sending_finished, "live TX: the buffer sent")
        sender.stop("sent")
        drain_and_stop(sniffer, len(card), "live TX buffer")
        faults.check("live TX buffer")
        check_bits([m.plain_bits for m in sniffer.messages], sent, "live TX buffer")
        out["tx"] = dict(samples=len(card), rate=len(card) / gen_wall, max_diff=diff.max())
        print(f"live TX buffer: GeneratorBackend over {len(sent)} messages ({LIVE_TX_FUZZ - 1} "
              f"fuzzed) -> {len(card)} samples in {gen_wall} s on the card "
              f"({len(card) / gen_wall} samples/s), max diff from the CPU {diff.max()} "
              f"(limit {limit}); every message back bit-exact through a sniffer; on {identity}",
              flush=True)

        continuous = ContinuousModulator(container.messages, [fsk], num_repeats=1,
                                         dtype=np.float32, device=device)
        sniffer, port, _ = live_sniffer(device, p)
        sender = VirtualDevice(BackendHandler(), NETWORK_SDR, Mode.send)
        sender.set_client_port(port)
        sender.continuous_send_ring_buffer = continuous.ring_buffer
        sender.is_send_continuous = True
        sender.num_samples_to_send = len(card)
        sender.num_sending_repeats = 1
        t0 = time.perf_counter()
        continuous.start()
        sender.start()
        # the child's cursor moves once its first message is in the ring
        wait_for(lambda: continuous.current_message_index.value > 0 or sender.current_index > 0
                 or not continuous.is_running, "live TX continuous: the first block")
        first_block = time.perf_counter() - t0
        continuous.process.join(LIVE_DEADLINE_S)
        if continuous.is_running or continuous.process.exitcode != 0:
            raise AssertionError(f"live TX continuous: the child is alive "
                                 f"{continuous.is_running}, exit code "
                                 f"{continuous.process.exitcode}")
        wait_for(lambda: sender.sending_finished, "live TX continuous: the stream sent")
        sender.stop("sent")
        drain_and_stop(sniffer, len(card), "live TX continuous")
        stream_wall = time.perf_counter() - t0
        continuous.stop()
        faults.check("live TX continuous")
        check_bits([m.plain_bits for m in sniffer.messages], sent, "live TX continuous")
        out["continuous"] = dict(first_block=first_block, rate=len(card) / stream_wall)
        print(f"live TX continuous: the child on the card exited 0 after its repeat; its first "
              f"block {first_block} s after start(); {len(card)} samples streamed in "
              f"{stream_wall} s ({len(card) / stream_wall} samples/s); every message back "
              f"bit-exact; on {identity}", flush=True)
    return out


# -- the simulator over the live loop, and the RTL-TCP receiver: phases 12, 13 --

SIM_ROUNDS = 32
# Alice's messages and Bob's answers, 256 bits: the checksum is a CRC-16
# over the sequence number and the data
SIM_FIELDS = (("preamble", 0, 16), ("synchronization", 16, 16), ("sequence number", 32, 8),
              ("data", 40, 200), ("checksum", 240, 16))
SIM_PREAMBLE, SIM_SYNC = "10" * 8, "1001101001111101"
SIM_CRC = "16_standard"
SIM_PAUSE = 1000  # samples after each of Bob's answers: one pause gate
SIM_TIMEOUT_MS = 30_000
SIM_FINAL_SLEEP_S = 0.5  # ROADMAP C7: lets the sender's 0.1 s ring poll send the last answer
CONSTANT, LIVE, FORMULA = 0, 1, 2  # SimulatorProtocolLabel.value_type_index
RTL_TCP = "RTL-TCP"
RTL2832U_MAX_RATE = 3.2e6  # samples/s: a live receiver must keep up with it


def sim_checksum(body: str) -> str:
    import array

    from urh_tpu_torch.coding.crc import GenericCRC

    crc = GenericCRC(polynomial=SIM_CRC).calculate(array.array("B", map(int, body)))
    return "".join(map(str, crc))


def sim_message(destination, source, name: str, values: dict, bits: str):
    """A SimulatorMessage of SIM_FIELDS from ``source`` to ``destination``;
    ``values``: field name -> (value type index, label attributes)."""
    from urh_tpu_torch.coding.crc import GenericCRC
    from urh_tpu_torch.protocol.labels import FieldType, MessageType
    from urh_tpu_torch.sim.items import SimulatorMessage, SimulatorProtocolLabel

    msg = SimulatorMessage(destination, list(map(int, bits)), pause=SIM_PAUSE,
                           message_type=MessageType(name), source=source)
    fields = MessageType(name + " fields")
    for field, start, length in SIM_FIELDS:
        field_type = (FieldType("checksum", FieldType.Function.CHECKSUM) if field == "checksum"
                      else FieldType.from_caption(field))
        label = fields.add_protocol_label_start_length(start, length, name=field,
                                                       type=field_type)
        if field == "checksum":
            label.checksum = GenericCRC(polynomial=SIM_CRC)
            label.data_ranges = [[32, 240]]
        sim_label = SimulatorProtocolLabel(label)
        sim_label.value_type_index, attrs = values.get(field, (CONSTANT, {}))
        for key, value in attrs.items():
            setattr(sim_label, key, value)
        msg.insert_child(-1, sim_label)
    return msg


def simulator_config(modulator, bob_data: str, rounds: int):
    """Alice (played by the phase) -> Bob: item1, sequence number and data
    live, the CRC checked; Bob -> Alice: item2, sequence number
    ``item1.sequence_number + 1``, ``bob_data``, the CRC recomputed; item3
    counts the rounds, and item4 sleeps SIM_FINAL_SLEEP_S after the last
    answer; ``rounds`` rounds.  -> (project manager, configuration, parser)."""
    from urh_tpu_torch.protocol.labels import Participant
    from urh_tpu_torch.sim.configuration import SimulatorConfiguration
    from urh_tpu_torch.sim.expression_parser import SimulatorExpressionParser
    from urh_tpu_torch.sim.items import (ConditionType, SimulatorCounterAction, SimulatorRule,
                                         SimulatorRuleCondition, SimulatorSleepAction)
    from urh_tpu_torch.util.project import ProjectManager

    pm = ProjectManager()
    alice = Participant("Alice", "A", simulate=False)
    bob = Participant("Bob", "B", simulate=True)
    pm.participants = [alice, bob]
    pm.modulators = [modulator]
    pm.simulator_num_repeat = rounds
    pm.simulator_timeout_ms = SIM_TIMEOUT_MS
    config = SimulatorConfiguration(pm)
    parser = SimulatorExpressionParser(config)
    config.attach_expression_parser(parser)
    blank = SIM_PREAMBLE + SIM_SYNC + "0" * 224
    heard = sim_message(bob, alice, "alice", {"sequence number": (LIVE, {}),
                                              "data": (LIVE, {})}, blank)
    answer = sim_message(alice, bob, "bob", {
        "sequence number": (FORMULA, {"formula": "item1.sequence_number + 1"})},
        SIM_PREAMBLE + SIM_SYNC + "0" * 8 + bob_data + "0" * 16)
    counter = SimulatorCounterAction()
    rule = SimulatorRule()
    last_round = SimulatorRuleCondition(ConditionType.IF)
    last_round.condition = f"item3.counter_value > {rounds}"
    sleep = SimulatorSleepAction()
    sleep.sleep_time = SIM_FINAL_SLEEP_S
    config.add_items([heard, answer, counter, rule], 0, None)
    config.add_items([last_round], 0, rule)
    config.add_items([sleep], 0, last_round)
    if not config.protocol_valid():
        raise AssertionError("simulator: the configuration is not valid")
    return pm, config, parser


def recv_exactly(conn, n: int) -> bytes:
    """n bytes from a socket whose timeout bounds each wait."""
    chunks, got = [], 0
    while got < n:
        chunk = conn.recv(min(1 << 20, n - got))
        if not chunk:
            raise AssertionError(f"simulator: the sink closed after {got} of {n} bytes")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def simulator_phase(device, identity: str, rounds: int = SIM_ROUNDS) -> dict:
    """The stateful simulator on ``device`` (None: the card): its sniffer
    (a Network SDR in raw mode, the stream on the card) hears Alice, played
    here over one loopback connection, and its EndlessSender answers into a
    socket read here; every answer is synthesized by Modulator.modulate on
    the card and decoded here by demodulate() on the card.  Each round Alice
    sends a message with a fresh random sequence number and data, then one
    pause gate of silence, and once that is fed one gate more (the
    channel goes on); the round's
    wall runs from that last gate sent to Bob's answer read.  -> numbers
    for the summary."""
    import socket

    import urh_tpu_torch as ut
    from urh_tpu_torch.core.iq import resolve_device
    from urh_tpu_torch.dev.backend_handler import BackendHandler
    from urh_tpu_torch.dev.endless_sender import EndlessSender
    from urh_tpu_torch.dsp import stream_kernels as sk
    from urh_tpu_torch.protocol import stream
    from urh_tpu_torch.sim.simulator import Simulator
    from urh_tpu_torch.util.metrics import metrics

    rng = np.random.default_rng(29)
    p = demod_params("FSK", np.float32)
    bob, alice = (tx_modulator("FSK", 1, [-25e3, 25e3]) for _ in range(2))
    for m in (bob, alice):
        m.carrier_freq_hz, m.carrier_phase_deg = 0.0, 0
    bob_data = "".join(map(str, rng.integers(0, 2, 200)))
    pm, config, parser = simulator_config(bob, bob_data, rounds)
    gate = np.zeros((stream.PAUSE_GATE_SYMBOLS * p.samples_per_symbol, 2), np.float32)
    answer_bytes = (256 * p.samples_per_symbol + SIM_PAUSE) * 8
    synthesized = []
    modulate = bob.modulate

    def counted_modulate(*args, **kwargs):
        synthesized.append(resolve_device(kwargs.get("device")).type)
        return modulate(*args, **kwargs)

    bob.modulate = counted_modulate
    for counts in (sk.LAUNCHES, stream.FALLBACKS, stream.HOST_ROUTE):
        for key in counts:
            counts[key] = 0
    metrics.clear()
    with ThreadFaults() as faults:
        sniffer, _, record = live_sniffer(device, p, start=False)
        sender = EndlessSender(BackendHandler(), NETWORK_SDR)
        sink = socket.socket()
        sink.bind(("127.0.0.1", 0))
        sink.listen(1)
        sink.settimeout(LIVE_DEADLINE_S)
        sender.device.set_client_port(sink.getsockname()[1])
        sim = Simulator(config, pm.modulators, parser, pm, sniffer, sender, device=device)
        t0 = time.perf_counter()
        sim.start()
        conn, _ = sink.accept()
        conn.settimeout(LIVE_DEADLINE_S)
        alice_tx = socket.create_connection(
            ("127.0.0.1", sniffer.rcv_device.underlying_device.server_port))
        sent, walls, heard = 0, [], []
        for r in range(rounds):
            seq = int(rng.integers(0, 255))  # its answer, seq + 1, fits 8 bits
            body = format(seq, "08b") + "".join(map(str, rng.integers(0, 2, 200)))
            bits = SIM_PREAMBLE + SIM_SYNC + body + sim_checksum(body)
            heard.append(bits)
            iq = alice.modulate(bits, pause=0, device=device).data
            alice_tx.sendall(np.concatenate((iq, gate)).tobytes())
            sent += len(iq) + len(gate)
            wait_for(lambda: sniffer.drain_position == sent, f"simulator round {r}: Alice fed")
            alice_tx.sendall(gate.tobytes())
            sent += len(gate)
            t_sent = time.perf_counter()
            raw = recv_exactly(conn, answer_bytes)
            walls.append(time.perf_counter() - t_sent)
            answer = ut.demodulate(np.frombuffer(raw, np.float32).reshape(-1, 2), p,
                                   device=device)
            got = [m.plain_bits_str for m in answer]
            want_head = SIM_PREAMBLE + SIM_SYNC + format(seq + 1, "08b") + bob_data
            if len(got) != 1 or got[0][:240] != want_head or \
                    got[0][240:] != sim_checksum(got[0][32:240]):
                raise AssertionError(f"simulator round {r}: Bob's answer {got} to sequence "
                                     f"number {seq}")
            heard.append(got[0])
        # the receive server's close waits for its connections' handlers
        alice_tx.close()
        sim.simulation_thread.join(LIVE_DEADLINE_S)
        wall = time.perf_counter() - t0
        conn.close()
        sink.close()
        if sim.simulation_thread.is_alive():
            raise AssertionError("simulator: the simulation did not end")
        faults.check("simulator")
    log = "\n".join(sim.log_messages)
    for fault in ("Receive timeout", "Mismatch", "not received", "Devices not ready"):
        if fault in log:
            raise AssertionError(f"simulator: the log has {fault!r}:\n{log}")
    if "Stop simulation (Finished)" not in log:
        raise AssertionError(f"simulator: the simulation did not finish:\n{log}")
    lines = [line for line in sim.transcript.get_for_all_participants(all_rounds=True) if line]
    want = [f"{i} ({a}): {b}" for k, b in enumerate(heard)
            for i, a in [("1", "A->B") if k % 2 == 0 else ("2", "B->A")]]
    if lines != want:
        raise AssertionError(f"simulator: the transcript ({len(lines)} entries) differs from "
                             f"the {len(want)} messages exchanged")
    report = metrics.report()["sniffer.demodulate"]
    launches = sk.LAUNCHES["stream_block_f32"]
    if launches != report["calls"] or launches != len(record["drains"]) or not launches or \
            stream.FALLBACKS["states"] or any(stream.HOST_ROUTE.values()) or \
            sum(v for k, v in sk.LAUNCHES.items() if k != "stream_block_f32"):
        raise AssertionError(f"simulator: launches {sk.LAUNCHES} for {report['calls']} drains, "
                             f"fallbacks {stream.FALLBACKS}, host route {stream.HOST_ROUTE}")
    if synthesized != [resolve_device(device).type] * rounds:
        raise AssertionError(f"simulator: Bob's answers synthesized on {synthesized}")
    out = dict(rounds=rounds, median=statistics.median(walls), max=max(walls), wall=wall,
               launches=launches, drains=len(record["drains"]))
    print(f"simulator: {rounds} rounds, every answer sequence number + 1 with a valid CRC, "
          f"{len(lines)} transcript entries in order, 'Finished'; stream block launches "
          f"{launches} = drains {report['calls']}, no fallback; Modulator.modulate on "
          f"{synthesized[0]} {len(synthesized)} times; round walls (Alice's last gate sent -> Bob's answer "
          f"read, s) {walls}, median {out['median']}, max {out['max']}; the whole simulation "
          f"{wall} s on {identity}", flush=True)
    return out


class FakeRtlTcpServer:
    """rtl_tcp on a loopback socket, as tests/test_rtl_tcp.py's
    FakeRtlTcpServer: the RTL0 greeting, every 5-byte command it receives
    recorded, and what ``send`` is given streamed as unsigned 8-bit IQ."""

    def __init__(self, tuner_type: int = 5, gain_count: int = 29):
        import socket
        import threading

        self.greeting = b"RTL0" + tuner_type.to_bytes(4, "big") + gain_count.to_bytes(4, "big")
        self.commands, self.conn = [], None
        self.connected = threading.Event()
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        try:
            self.conn, _ = self._srv.accept()
        except OSError:
            return
        self.conn.sendall(self.greeting)
        self.connected.set()
        buf = b""
        while True:
            try:
                chunk = self.conn.recv(4096)
            except OSError:
                break
            if not chunk:
                break
            buf += chunk
            while len(buf) >= 5:
                self.commands.append((buf[0], int.from_bytes(buf[1:5], "big")))
                buf = buf[5:]

    def send(self, data: bytes):
        if not self.connected.wait(LIVE_DEADLINE_S):
            raise AssertionError("RTL-TCP: no client connected to the server")
        self.conn.sendall(data)

    def close(self):
        import socket

        for sock in (self.conn, self._srv):
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                sock.close()
        self._thread.join(LIVE_DEADLINE_S)


def rtl_tcp_phase(device, identity: str, n: int = N_FULL) -> dict:
    """RTL-TCP's live int8 path on ``device`` (None: the card): a
    ProtocolSniffer(device="RTL-TCP") whose spawned RTLSDRTCP child reads a
    loopback fake rtl_tcp server streaming the int8 FSK capture as unsigned
    bytes, then two pause gates of silence, and once those are fed one gate
    more; the bytes reach the int8 receive buffer and the stream's int8
    ingest on the card.  -> numbers for the summary."""
    import urh_tpu_torch as ut
    from urh_tpu_torch.dev.backend_handler import BackendHandler
    from urh_tpu_torch.dev.rtl_tcp import PARAMETERS
    from urh_tpu_torch.dsp import stream_kernels as sk
    from urh_tpu_torch.protocol import stream
    from urh_tpu_torch.protocol.sniffer import ProtocolSniffer
    from urh_tpu_torch.util.metrics import metrics

    iq, bits = make_capture("FSK", n, seed=11)
    i8 = to_int8(iq)
    offline = [m.plain_bits for m in ut.demodulate(i8, demod_params("FSK", np.int8),
                                                    device=device)]
    check_bits(offline, bits, "RTL-TCP: demodulate() of the int8 capture")
    p = demod_params("FSK", np.float32)  # the stream's noise is in normalized units
    gate = np.full((stream.PAUSE_GATE_SYMBOLS * p.samples_per_symbol, 2), 128, np.uint8)
    wire = (i8.astype(np.int16) + 128).astype(np.uint8)
    for counts in (sk.LAUNCHES, stream.FALLBACKS, stream.HOST_ROUTE):
        for key in counts:
            counts[key] = 0
    metrics.clear()
    server = FakeRtlTcpServer()
    record = {"drains": [], "first_sample": None, "messages": []}
    try:
        with ThreadFaults() as faults:
            sniffer = ProtocolSniffer(p.samples_per_symbol, p.center, p.center_spacing,
                                      p.noise_threshold, p.tolerance, p.modulation,
                                      p.bits_per_symbol, RTL_TCP, BackendHandler(),
                                      compute_device=device)
            dev = sniffer.rcv_device._dev
            if type(dev).__name__ != "RTLSDRTCP" or sniffer.rcv_device.data_type != np.int8 \
                    or dev.port != 1234:
                raise AssertionError(f"RTL-TCP: {type(dev).__name__}, "
                                     f"{sniffer.rcv_device.data_type}, port {dev.port}")
            dev.port = server.port  # ROADMAP C6: RTL-TCP keeps 1234 otherwise
            ingest, commit = sniffer._ingest, dev._commit_samples

            def counted_ingest(chunk):
                record["drains"].append(len(chunk))
                ingest(chunk)

            def timed_commit(samples):
                if record["first_sample"] is None and len(samples):
                    record["first_sample"] = time.perf_counter()
                return commit(samples)

            sniffer._ingest, dev._commit_samples = counted_ingest, timed_commit
            sniffer.message_sniffed.connect(
                lambda _: record["messages"].append(time.perf_counter()))
            t0 = time.perf_counter()
            sniffer.sniff()
            wait_for(lambda: any("Connected to rtl_tcp" in m for m in dev.device_messages),
                     "RTL-TCP: the child's connection")
            connect_s = time.perf_counter() - t0
            config = dev.receive_process_arguments[2]
            startup = [(prm.opcode, int(config[prm.startup]) & 0xFFFFFFFF)
                       for prm in PARAMETERS if prm.startup and prm.startup in config]
            wait_for(lambda: len(server.commands) >= len(startup),
                     "RTL-TCP: the startup commands")
            server.send(wire.tobytes() + np.tile(gate, (LIVE_SILENCE_GATES, 1)).tobytes())
            total = len(wire) + LIVE_SILENCE_GATES * len(gate)
            wait_drained(sniffer, total, "RTL-TCP")
            server.send(gate.tobytes())
            wait_drained(sniffer, total + len(gate), "RTL-TCP")
            t0 = time.perf_counter()
            sniffer.stop()  # joins the child (Device.JOIN_TIMEOUT) before it flushes
            stop_s = time.perf_counter() - t0
            if sniffer.rcv_device.current_index != total + len(gate):
                raise AssertionError(f"RTL-TCP: the receive index wrapped "
                                     f"({sniffer.rcv_device.current_index})")
            exitcode = dev.receive_process.exitcode
            faults.check("RTL-TCP")
    finally:
        server.close()
    got = [m.plain_bits for m in sniffer.messages]
    check_bits(got, bits, "RTL-TCP")
    if got != offline:
        raise AssertionError("RTL-TCP: the sniffer's messages differ from demodulate()'s")
    if server.commands != startup:
        raise AssertionError(f"RTL-TCP: the server recorded {server.commands}, not the "
                             f"registry order {startup}")
    if exitcode != 0:
        raise AssertionError(f"RTL-TCP: the child exited {exitcode}")
    drains = record["drains"]
    report = metrics.report()["sniffer.demodulate"]
    launches = sk.LAUNCHES["stream_block_i8"]
    if launches != len(drains) or launches != report["calls"] or not launches or \
            stream.FALLBACKS["states"] or any(stream.HOST_ROUTE.values()) or \
            sum(v for k, v in sk.LAUNCHES.items() if k != "stream_block_i8"):
        raise AssertionError(f"RTL-TCP: launches {sk.LAUNCHES} for {len(drains)} drains, "
                             f"fallbacks {stream.FALLBACKS}, host route {stream.HOST_ROUTE}")
    n_total = total + len(gate)
    wall = record["messages"][-1] - record["first_sample"]
    rate = n_total / wall
    if rate <= RTL2832U_MAX_RATE:
        raise AssertionError(f"RTL-TCP: {rate} samples/s live, not above the RTL2832U's "
                             f"{RTL2832U_MAX_RATE}")
    out = dict(connect_s=connect_s, stop_s=stop_s, drains=len(drains), min=min(drains),
               median=statistics.median(drains), max=max(drains), wall=wall, rate=rate,
               launches=launches)
    print(f"RTL-TCP live int8: {len(got)} messages bit-exact, equal to demodulate()'s on the "
          f"int8 capture; the child connected {connect_s} s after sniff() and exited 0 "
          f"in stop(), which took {stop_s} s; "
          f"startup commands in registry order {[hex(c[0]) for c in startup]}; {len(drains)} "
          f"drains of min {min(drains)}, median {statistics.median(drains)}, max {max(drains)} "
          f"samples; urh_stream_block_i8 launches {launches} = drains, no float32 ingest, "
          f"no fallback, no host block, no wrap; wall from the first sample received to the "
          f"last message {wall} s ({rate} samples/s; sniffer.demodulate "
          f"{report['samples_per_second']} samples/s) on {identity}", flush=True)
    return out


B9_CS = (1, 2, 3, 33, 132)  # streams a launch, and one past the resident count
B9_LS = (1, 2, 3, 31, 32, 33, 2049, 5000)
B9_MAIN_CS = (8, 132)  # shards of the 2^22-sample BPSK capture
B9_MARGIN = 4096
B9_PLAIN_L = 1 << 12  # the plain batch at C = 132 is timed at this length
B9_REPLACES = "urh_tpu/parallel/sharded.py:263"
SHARDS = 8
FIR_SHARDED_ATOL = 1e-2  # tests/test_torch_filters.py: 40,000 samples and more
STFT_ATOL = 1e-4  # tests/test_sharded.py:105
DIST_TIMEOUT_S = 300


def b9_bound_ms(streams: torch.Tensor, noise_sqrd: float, resident: int,
                clock_hz: float) -> tuple[float, str]:
    """B9's least time on these (C, L, 2) streams: the chain of the row with
    the most samples above the gate (the loop steps those and skips the
    rest), once a wave of ``resident`` streams, at B5's cycles a sample;
    or its bytes (each sample read, each qad written) at the HBM rate."""
    stepped = int(((streams * streams).sum(-1) > noise_sqrd).sum(1).max()) if len(streams) \
        else 0
    waves = -(-len(streams) // resident)
    chain_ms = waves * stepped * B5_CHAIN_CYCLES / clock_hz * 1e3
    byte_ms = streams.shape[0] * streams.shape[1] * B5_BYTES_PER_SAMPLE / HBM_BYTES_PER_S * 1e3
    return max(chain_ms, byte_ms), "operations" if chain_ms >= byte_ms else "bytes"


def b9_rows(c: int, n: int, seed: int, offset: int, device):
    """(c, n, 2) streams with gated stretches, every 7th row wholly gated,
    from an allocation ``offset`` samples in (a row then starts 16-byte
    aligned or half a chunk late), and (c, 2) carries from the default to
    far outside the loop's range."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(0, 0.5, (c * n + offset, 2)).astype(np.float32)
    x = raw[offset:].reshape(c, n, 2)
    x[:, n // 3:n // 3 + 40] *= 0.001
    x[6::7] *= 0.001
    buf = torch.from_numpy(raw).to(device)
    phases = np.resize((1.5, *B5_FAR_PHASES, 0.3), c)
    carry = np.stack((phases, np.resize((0.0, 0.5, -0.5), c)), 1).astype(np.float32)
    return buf[offset:].view(c, n, 2), torch.from_numpy(carry).to(device)


def b9_main_streams_check(streams: torch.Tensor, got: torch.Tensor, final: torch.Tensor,
                          noise_sqrd: float, scale: float, shift: float, bandwidth: float,
                          piece: int = B5_PIECE) -> tuple[float, int]:
    """B9's words ``got`` and final carries ``final`` from one launch over
    the main path's (C, L, 2) streams, each from (1.5, 0), against the
    plain batch.  The plain loop steps sample by sample, so it runs each
    row in pieces of ``piece`` samples, every piece of every row stepped
    together, each from the carry the kernel holds at its start (B9 run
    piece by piece over all the rows).  Each piece must end on the next
    piece's starting carry and the last on the one-shot final carries, so
    the plain loop checks every row's whole chain.  Loop order 2, as
    sharded_psk_demod runs BPSK.  -> (max abs error, word and carry
    mismatches)."""
    from urh_tpu_torch.dsp import costas

    alpha, beta = costas.costas_alpha_beta(bandwidth)
    c, n = streams.shape[:2]
    n_pieces = -(-n // piece)
    padded = streams.new_zeros((c, n_pieces * piece, 2))
    padded[:, :n] = streams  # zero samples pad the last piece: gated, they keep the carry
    carry, starts = costas.new_carry(streams.device).repeat(c, 1), []
    for a in range(0, n, piece):
        starts.append(carry.clone())
        costas.costa_demod_scan_batch(streams[:, a:a + piece].contiguous(), noise_sqrd, scale,
                                      shift, 2, bandwidth, carry)
    starts = torch.stack(starts, 1)
    want, phases, freqs = costas.costa_demod_scan_plain(
        padded.view(c * n_pieces, piece, 2), noise_sqrd, scale, shift, 2, alpha, beta,
        starts[..., 0].reshape(-1), starts[..., 1].reshape(-1))
    want = want.view(c, -1)[:, :n]
    ends = torch.stack((phases, freqs), 1).view(c, n_pieces, 2)
    e = (got - want).abs().max().item()
    bad = (int((got != want).sum()) + int((ends[:, :-1] != starts[:, 1:]).sum())
           + int((ends[:, -1] != final).sum()))
    print(f"costas batch at C={c} L={n} against the plain batch in {c} x {n_pieces} pieces "
          f"of {piece}: max_abs_err {e}, mismatching words and carries {bad}", flush=True)
    return e, bad


def b9_phase(device, clock_hz: float, cs=B9_CS, ls=B9_LS, main_cs=B9_MAIN_CS,
             main_n=B5_TIMED_N, margin=B9_MARGIN, plain_l=B9_PLAIN_L,
             resident=None) -> dict:
    """B9 against its plain version on every word and final carry, for
    each C of ``cs`` and one past the resident count, each L of ``ls`` and
    both loop orders (one plain call over every C's rows at once: the rows
    are independent); then on the main path's streams of the BPSK capture
    (shards of main_n samples after a margin) at each C of ``main_cs``
    against the plain batch (b9_main_streams_check) and against B5 row by
    row, on every word and carry; timed there; last against the plain
    batch it times at C = max(main_cs), L = plain_l (``resident``: the
    streams a launch runs at once, from the occupancy API when None)."""
    from urh_tpu_torch.core.iq import normalize_scale_shift
    from urh_tpu_torch.dsp import costas
    from urh_tpu_torch.parallel import sharded

    resident = costas.batch_resident_streams(device) if resident is None else resident
    cs = (*cs, resident + 1)
    nsq = float(np.float32(B5_NOISE ** 2))
    alpha, beta = costas.costas_alpha_beta(0.1)
    err, mismatch = 0.0, 0
    for n in ls:
        rows = [b9_rows(c, n, seed=c * 7919 + n, offset=i % 2, device=device)
                for i, c in enumerate(cs)]
        x_all = torch.cat([x for x, _ in rows])
        carry_all = torch.cat([c for _, c in rows])
        for order in B5_ORDERS:
            want, phase, freq = costas.costa_demod_scan_plain(
                x_all, nsq, 1.0, 0.0, order, alpha, beta, carry_all[:, 0], carry_all[:, 1])
            got, got_carry = [], []
            for x, start in rows:
                carry = start.clone()
                got.append(costas.costa_demod_scan_batch(x, nsq, 1.0, 0.0, order, 0.1, carry))
                got_carry.append(carry)
            torch.cuda.synchronize()
            got, got_carry = torch.cat(got), torch.cat(got_carry)
            e = (got - want).abs().max().item() if got.numel() else 0.0
            bad = int((got != want).sum()) + int(
                (got_carry != torch.stack((phase, freq), 1)).sum())
            err, mismatch = max(err, e), mismatch + bad
        print(f"costas batch L={n} C={cs}: against the plain batch, orders {B5_ORDERS}: "
              f"max_abs_err so far {err}, mismatching words and carries so far {mismatch}",
              flush=True)

    p = psk_params()
    psk_nsq = float(np.float32(p.noise_threshold * p.noise_threshold))
    scale, shift = normalize_scale_shift(np.float32)
    iq = make_psk_capture(main_n, seed=13)[0]
    timings = {}
    for c in main_cs:
        mesh = sharded.make_mesh(c, device=device)
        x, _ = sharded.pad_to_blocks(iq, c)
        ((_, streams),) = sharded.costas_streams(mesh, sharded.shard_blocks(x, mesh),
                                                 min(margin, len(x) // c))
        carry = costas.new_carry(device).repeat(c, 1)
        got = costas.costa_demod_scan_batch(streams, psk_nsq, scale, shift, 2,
                                            p.costas_loop_bandwidth, carry)
        bad = 0
        for row in range(c):
            one = costas.new_carry(device)
            want = costas.costa_demod_scan(streams[row], psk_nsq, scale, shift, 2,
                                           p.costas_loop_bandwidth, one)
            bad += int((got[row] != want).sum()) + int((carry[row] != one).sum())
        torch.cuda.synchronize()
        e, plain_bad = b9_main_streams_check(streams, got, carry, psk_nsq, scale, shift,
                                             p.costas_loop_bandwidth)
        err, mismatch = max(err, e), mismatch + bad + plain_bad
        init = costas.new_carry(device).repeat(c, 1)
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
        ms = time_ms(lambda: costas.costa_demod_scan_batch(
            streams, psk_nsq, scale, shift, 2, p.costas_loop_bandwidth, carry),
            flush, before=lambda: carry.copy_(init))
        bound, bound_by = b9_bound_ms(streams, psk_nsq, resident, clock_hz)
        timings[c] = dict(ms=ms, n=streams.shape[1], bound_ms=bound, bound_by=bound_by)
        print(f"costas batch on the BPSK capture's streams, C={c} L={streams.shape[1]} "
              f"(margin {streams.shape[1] - len(x) // c}): against B5 row by row "
              f"{bad} mismatching words and carries; {ms} ms (median of {TIMED_RUNS} after "
              f"3 warm-ups), bound {bound} ms ({bound_by}), {bound / ms:.1%}", flush=True)
    if err > 0.0 or mismatch:
        raise AssertionError(f"costas batch: max_abs_err {err}, {mismatch} mismatches")

    xp, start = b9_rows(max(main_cs), plain_l, seed=3, offset=0, device=device)
    plain = []
    plain_ms = time_ms(lambda: plain.append(costas.costa_demod_scan_plain(
        xp, nsq, 1.0, 0.0, 2, alpha, beta, start[:, 0], start[:, 1])), runs=1, warmup=0)
    want, phase, freq = plain[-1]
    carry = start.clone()
    got = costas.costa_demod_scan_batch(xp, nsq, 1.0, 0.0, 2, 0.1, carry)
    torch.cuda.synchronize()
    e = (got - want).abs().max().item()
    bad = int((got != want).sum()) + int((carry != torch.stack((phase, freq), 1)).sum())
    err, mismatch = max(err, e), mismatch + bad
    print(f"costas batch: {resident} resident streams; plain batch {plain_ms} ms at "
          f"C={max(main_cs)} L={plain_l} (1 run), the kernel against it: max_abs_err {e}, "
          f"mismatching words and carries {bad}", flush=True)
    if err > 0.0 or mismatch:
        raise AssertionError(f"costas batch: max_abs_err {err}, {mismatch} mismatches")
    return dict(err=err, mismatch=mismatch, timings=timings, plain_ms=plain_ms,
                plain_shape=(max(main_cs), plain_l), resident=resident)


def psk_bit_lists(qad, p) -> list:
    """The messages' bits of a PSK qad, as demodulate() gets them."""
    from urh_tpu_torch.dsp import symbols
    from urh_tpu_torch.protocol.analyzer import ProtocolAnalyzer

    pulses = symbols.grab_pulse_lens(torch.as_tensor(qad), p.center, p.tolerance,
                                     p.modulation, p.samples_per_symbol, p.bits_per_symbol,
                                     p.center_spacing)
    return ProtocolAnalyzer._ppseq_to_bits(pulses, p.samples_per_symbol, p.bits_per_symbol,
                                           pause_threshold=p.pause_threshold)[0]


def distributed_child(device: str, folder: str, port: int, shards: int):
    """One rank (world size 1) of the distributed pipeline, NCCL on the card
    (gloo on the CPU): reads the FSK and BPSK captures with
    read_capture_slice, writes distributed_pulse_lens,
    distributed_psk_demod_exact and the Costas launch counts to
    folder/rank0.npz."""
    from urh_tpu_torch.dsp import costas
    from urh_tpu_torch.parallel import distributed as dist

    t0 = time.perf_counter()
    dist.initialize(f"localhost:{port}", 1, 0, device=device)
    backend = torch.distributed.get_backend()
    p = demod_params("FSK", np.float32)
    fsk = dist.read_capture_slice(f"{folder}/fsk.raw", np.float32)
    psk = dist.read_capture_slice(f"{folder}/psk.raw", np.float32)
    mesh = dist.global_mesh(shards, device=device)
    pulses = dist.distributed_pulse_lens(fsk, p.noise_threshold, "FSK", p.center,
                                         p.center_spacing, 1, p.tolerance,
                                         p.samples_per_symbol, mesh=mesh)
    q = psk_params()
    before = costas.LAUNCHES["costas_f32"]
    offset, qad = dist.distributed_psk_demod_exact(psk, q.noise_threshold, 2,
                                                   q.costas_loop_bandwidth, device=device)
    launches = costas.LAUNCHES["costas_f32"] - before
    dist.shutdown()
    np.savez(f"{folder}/rank0.npz", pulses=pulses, qad=qad, offset=offset, launches=launches,
             backend=backend, wall=time.perf_counter() - t0)


def distributed_world_one(device, fsk: np.ndarray, psk: np.ndarray,
                          shards: int = SHARDS) -> dict:
    """distributed_child in a spawned process, on raw captures written under
    build/; -> its results."""
    import socket

    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(folder, exist_ok=True)
    fsk.tofile(f"{folder}/fsk.raw")
    psk.tofile(f"{folder}/psk.raw")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = (f"import chip_smoke; chip_smoke.distributed_child({str(device)!r}, {folder!r}, "
            f"{port}, {shards})")
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable, "-c", code],
                             cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        rc = child.wait(timeout=DIST_TIMEOUT_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if rc != 0:
        raise AssertionError(f"distributed child exited {rc}")
    with np.load(f"{folder}/rank0.npz") as out:
        result = {k: out[k] for k in out.files}
    result["child_wall"] = time.perf_counter() - t0
    for name in ("fsk.raw", "psk.raw", "rank0.npz"):
        os.remove(f"{folder}/{name}")
    return result


def sharding_phase(device, identity: str, n: int = N_FULL, psk_n: int = B5_TIMED_N,
                   shards: int = SHARDS, main_cs=B9_MAIN_CS, margin: int = B9_MARGIN) -> dict:
    """The sharded pipeline on ``shards`` shards of ``device`` (None: the
    card), against the unsharded port on the same device: demod and
    states of the FSK and ASK captures to the bit, their pulses decoding
    every message; the FIR filter and the STFT within their tolerances;
    the exact PSK to the bit (one B5 launch a shard); the block-parallel
    PSK at each C of main_cs (one B9 launch a call), its exact messages
    printed; then the distributed pipeline at world size 1 in a spawned
    child (NCCL on the card) against the sharded results.  Launch counts
    from a reset before the first call.  -> numbers for the summary."""
    from urh_tpu_torch.core.iq import max_magnitude_for_dtype, resolve_device
    from urh_tpu_torch.dsp import demod, filters, symbols
    from urh_tpu_torch.dsp.filters import Filter
    from urh_tpu_torch.dsp.spectrogram import Spectrogram
    from urh_tpu_torch.parallel import sharded
    from urh_tpu_torch.protocol.analyzer import ProtocolAnalyzer

    dev = resolve_device(device)
    mesh = sharded.make_mesh(shards, device=dev)
    q = psk_params()
    psk_iq, psk_bits = make_psk_capture(psk_n, seed=13)
    offline = demod.afp_demod(psk_iq, q.noise_threshold, "PSK", 2, q.costas_loop_bandwidth,
                              device=dev).cpu().numpy()
    reset_launches()
    walls = {}

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        return out

    for kind, seed in (("FSK", 11), ("ASK", 12)):
        iq, bits = make_capture(kind, n, seed)
        p = demod_params(kind, np.float32)
        args = (iq, p.noise_threshold, kind, p.center, p.center_spacing, 1)
        qad, states = timed(f"sharded_demodulate {kind}",
                            lambda: sharded.sharded_demodulate(*args, mesh=mesh))
        x = torch.from_numpy(iq).to(dev)
        want = demod.afp_demod_vec(x, float(np.float32(p.noise_threshold ** 2)),
                                   max_magnitude_for_dtype(np.float32), kind)
        want_states = symbols.symbol_states(want, symbols.get_center_thresholds(
            p.center, p.center_spacing, 2), demod.noise_sentinel(kind))
        bad = int((torch.from_numpy(qad).to(dev) != want).sum()) + int(
            (torch.from_numpy(states).to(dev) != want_states).sum())
        if bad:
            raise AssertionError(f"sharded_demodulate {kind}: {bad} words differ from the "
                                 f"unsharded afp_demod_vec and symbol_states")
        pulses = timed(f"sharded_pulse_lens {kind}", lambda: sharded.sharded_pulse_lens(
            *args, p.tolerance, p.samples_per_symbol, mesh=mesh))
        bit_lists = ProtocolAnalyzer._ppseq_to_bits(pulses, p.samples_per_symbol, 1,
                                                    pause_threshold=p.pause_threshold)[0]
        check_bits(bit_lists, bits, f"sharded_pulse_lens {kind}")
        print(f"sharded {kind} float32 on {shards} shards: qad and states equal the "
              f"unsharded ones to the bit; {len(bit_lists)} messages bit-exact", flush=True)
        if kind == "FSK":
            fsk_iq, fsk_pulses = iq, pulses
            cx = iq[:, 0] + 1j * iq[:, 1]
            taps = Filter.design_windowed_sinc_bandpass(*BANDPASS)
            got = timed("sharded_fir_filter", lambda: sharded.sharded_fir_filter(
                cx, taps, mesh=mesh))
            fir_err = float(np.abs(got - filters.fir_filter(cx, taps, device=dev)).max())
            stft = timed("sharded_spectrogram", lambda: sharded.sharded_spectrogram(
                cx, mesh=mesh))
            single = Spectrogram(cx, window_size=1024, device=dev).stft(cx)
            stft_err = float(np.abs(stft - single).max()) if stft.shape == single.shape \
                else math.inf
            print(f"sharded_fir_filter ({len(taps)} taps) against fir_filter: max_abs_err "
                  f"{fir_err}; sharded_spectrogram {stft.shape} against Spectrogram.stft: "
                  f"max_abs_err {stft_err}", flush=True)
            if fir_err > FIR_SHARDED_ATOL or stft_err > STFT_ATOL:
                raise AssertionError(f"sharded FIR {fir_err} or STFT {stft_err} off")

    exact = timed("sharded_psk_demod_exact", lambda: sharded.sharded_psk_demod_exact(
        psk_iq, q.noise_threshold, 2, q.costas_loop_bandwidth, mesh=mesh))
    if not np.array_equal(exact, offline):
        raise AssertionError("sharded_psk_demod_exact differs from afp_demod")
    exact_msgs = count_exact(psk_bit_lists(exact, q), psk_bits)
    relocked = {}
    for c in main_cs:
        qad = timed(f"sharded_psk_demod C={c}", lambda: sharded.sharded_psk_demod(
            psk_iq, q.noise_threshold, 2, q.costas_loop_bandwidth, margin,
            mesh=sharded.make_mesh(c, device=dev)))
        relocked[c] = count_exact(psk_bit_lists(qad, q), psk_bits)
    launches = read_launches()
    print(f"sharded PSK: exact equal to afp_demod to the bit ({exact_msgs} of "
          f"{len(psk_bits)} messages exact); block-parallel with a {margin}-sample margin "
          f"decodes " + ", ".join(f"{k} of {len(psk_bits)} at C={c}"
                                  for c, k in relocked.items())
          + f" (not asserted); launches {launches}", flush=True)
    want = {"costas_batch_f32": len(main_cs), "costas_f32": shards}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"sharding launches {launches}, expected {want}")

    child = distributed_world_one(dev, fsk_iq, psk_iq, shards)
    # the child's launch count: on the card (the plain loop counts none)
    if not np.array_equal(child["pulses"], fsk_pulses) or int(child["offset"]) != 0 \
            or not np.array_equal(child["qad"], exact) \
            or (dev.type == "cuda" and int(child["launches"]) != 1):
        raise AssertionError(f"distributed world size 1 ({child['backend']}) differs from the "
                             f"sharded results (B5 launches {child['launches']})")
    print(f"distributed, world size 1 on {child['backend']}: distributed_pulse_lens and "
          f"distributed_psk_demod_exact equal the sharded results (B5 launches "
          f"{child['launches']}); child wall "
          f"{child['child_wall']} s, of it {child['wall']} s from initialize to shutdown",
          flush=True)
    print("sharding walls (s): " + "; ".join(f"{k} {v}" for k, v in walls.items())
          + f" on {identity}", flush=True)
    return dict(launches=launches, walls=walls, relocked=relocked, exact_msgs=exact_msgs,
                child_wall=child["child_wall"], backend=str(child["backend"]))


# -- placement: device="auto" between the card and the CPU -------------------

PLACEMENT_SMALL_DEMOD = 1 << 12  # below urh_tpu's DEVICE_MIN_DEMOD_SAMPLES: the host
PLACEMENT_SMALL_BODY = 1 << 16  # a TX body below urh_tpu's DEVICE_MIN_BODY_SAMPLES
PLACEMENT_CHILD_TIMEOUT_S = 120

PLACEMENT_REPLAY = r"""
import json
import sys
from collections import Counter
sys.modules["jax"] = None
from urh_tpu_torch.util import placement
calls = Counter()
def route(key, side):
    def fn():
        calls[key + " " + side] += 1
    return fn
placement._load_store()
keys = sorted(placement._RACE_VERDICTS)
for key in keys:
    placement.race(key, route(key, "card"), route(key, "host"))
print(json.dumps({"signature": placement._link_signature(), "keys": keys,
                  "calls": dict(calls)}))
"""


def route_side(route: str, before) -> str:
    """The one side the placed calls at ``route`` took since ``before``."""
    from urh_tpu_torch.util import placement

    sides = {side for (r, side), runs in placement.ROUTES.items()
             if r == route and runs > before[(r, side)]}
    if len(sides) != 1:
        raise AssertionError(f"placement {route}: sides {sides} in one placed call")
    return sides.pop()


def placed_route(label: str, route: str, call, same, card: str = "cuda") -> dict:
    """``call(device)`` (its result on the host) forced to the card, forced
    to "cpu", then placed ("auto"), each wall on the host clock around a
    synchronized call; the placed result must equal the forced result of
    the side it took (``same``).  -> verdict, walls and B7's launches in
    the placed call."""
    from collections import Counter

    from urh_tpu_torch.ai import median_kernels as mk
    from urh_tpu_torch.util import placement

    walls, results = {}, {}
    for key, device in (("cuda", card), ("cpu", "cpu"), ("auto", "auto")):
        before = Counter(placement.ROUTES)
        launched = mk.LAUNCHES["median_filter_f32"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[key] = call(device)
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t0
    b7 = mk.LAUNCHES["median_filter_f32"] - launched
    side = route_side(route, before)
    forced = "cuda" if side == "card" else "cpu"
    equal = same(results["auto"], results[forced])
    print(f"placement {label}: verdict {side}; walls (s) placed {walls['auto']}, card "
          f"{walls['cuda']}, CPU {walls['cpu']}; placed equal to forced {forced} {equal}; "
          f"B7 launched {b7} times by the placed call", flush=True)
    if not equal:
        raise AssertionError(f"placement {label}: the placed result differs from {forced}'s")
    return {"verdict": side, "walls": walls, "b7": b7}


def same_arrays(a, b) -> bool:
    """Equal shapes, types and words (NaN payloads included)."""
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.tobytes() == b.tobytes())


def pinned_s_per_byte(card) -> tuple:
    """(up, down) seconds a byte of placement.TRANSFER_BYTES copied between
    page-locked host buffers and the card, best of 2 after a warm copy each
    way: what a route would pay if it staged through pinned memory, which
    none does (placement prices the pageable copies)."""
    from urh_tpu_torch.util import placement

    src = torch.zeros(placement.TRANSFER_BYTES // 4, pin_memory=True)
    dst = torch.empty_like(src, pin_memory=True)

    def round_trip() -> tuple:
        t0 = time.perf_counter()
        x = src.to(card, non_blocking=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dst.copy_(x, non_blocking=True)
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    round_trip()
    times = [round_trip() for _ in range(2)]
    nbytes = src.numel() * 4
    return (min(t[0] for t in times) / nbytes, min(t[1] for t in times) / nbytes)


def placement_phase(identity: str, n: int = N_FULL, awre_n: int = AWRE_MESSAGES,
                    card: str = "cuda") -> dict:
    """device="auto" (urh_tpu_torch.util.placement) in a temporary config
    dir: the link signature, the dispatch probe and the transfer cost a
    byte each way (pageable, which the routes pay, and pinned); then each
    placed route at PERF.md's sizes forced to the card, forced to the CPU
    and placed, its verdict and walls printed, the placed result equal to
    the forced one of its side: estimate() (FSK float32, n samples),
    afp_demod (FSK, n and PLACEMENT_SMALL_DEMOD samples), the spectrogram
    image (n samples), median_filter_rows at the bucket (B7 on the card),
    modulate (TX_BODY and PLACEMENT_SMALL_BODY bodies);
    FormatFinder.run(10) over bench.py's protocol twice, the first racing
    and the second replaying.  A second placed median runs one route (B7's
    launch counter and placement.ROUTES); rows already on the card stay
    there under "auto" (one B7 launch, no route); the store holds the link's
    verdicts and a fresh child replays them without racing; a race whose
    card route raises lets the exception out and leaves no verdict.
    ``card`` names the card (a rehearsal on the CPU fakes one).  -> verdicts,
    walls, B7's launches on the placed paths, the probes."""
    import tempfile
    from collections import Counter

    import urh_tpu_torch as ut
    from urh_tpu_torch.ai import device as ai_device
    from urh_tpu_torch.ai import median_kernels as mk
    from urh_tpu_torch.awre.format_finder import FormatFinder
    from urh_tpu_torch.dsp import demod, modulate
    from urh_tpu_torch.dsp.spectrogram import Spectrogram
    from urh_tpu_torch.util import placement, settings

    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(folder, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=folder) as home:
        # neither the user's store nor a stale verdict decides anything here
        settings._config_dir = os.path.join(home, "urh_tpu")
        settings._settings_file = os.path.join(settings._config_dir, "settings.json")
        settings._store = None
        placement._RACE_VERDICTS.clear()
        placement._STORE_LOADED = False
        placement.ROUTES.clear()
        reset_launches()

        on_card = torch.device(card).type == "cuda"
        signature = placement._link_signature()
        dispatch = placement.dispatch_overhead_s()
        pageable = placement.transfer_s_per_byte()
        pinned = pinned_s_per_byte(card) if on_card else None
        print(f"placement link {signature!r}: dispatch {dispatch} s, transfer s/B up/down "
              f"pageable {pageable}, pinned {pinned}; scaled 2^15 -> "
              f"{placement.scaled_threshold(1 << 15)} on {identity}", flush=True)

        out = {"probes": {"signature": signature, "dispatch_s": dispatch,
                          "pageable_s_per_byte": pageable, "pinned_s_per_byte": pinned}}
        iq, _ = make_capture("FSK", n, 11, lead=quiet_lead(n))
        out["estimate"] = placed_route(
            f"estimate() FSK float32 {n}", "ai.estimate.staging",
            lambda dev: ut.estimate(iq, device=dev), lambda a, b: a == b, card)
        for size in (n, PLACEMENT_SMALL_DEMOD):
            x = iq[:size]
            out[f"afp_demod {size}"] = placed_route(
                f"afp_demod FSK {size}", "dsp.afp_demod",
                lambda dev: demod.afp_demod(x, 0.1, "FSK", device=dev).cpu().numpy(),
                same_arrays, card)
        cx = (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
        out["spectrogram"] = placed_route(
            f"spectrogram image {n}", "dsp.spectrogram",
            lambda dev: Spectrogram(cx, window_size=1024, device=dev).create_spectrogram_image(),
            same_arrays, card)
        # magnitudes, as classification filters them: no -0.0, no NaN
        rows = torch.from_numpy(np.abs(np.random.default_rng(29).normal(
            size=B7_MAIN_SHAPES[0])).astype(np.float32))
        out["median"] = placed_route(
            f"median_filter_rows {tuple(rows.shape)} k={B7_K}", "ai.median_filter_rows",
            lambda dev: ai_device.median_filter_rows(rows, B7_K, device=dev).cpu().numpy(),
            same_arrays, card)
        rng = np.random.default_rng(31)
        fsk = tx_modulator("FSK", 1, [-25e3, 25e3])
        for body in (TX_BODY, PLACEMENT_SMALL_BODY):
            bits = rng.integers(0, 2, -(-body // 100))
            out[f"modulate {body}"] = placed_route(
                f"modulate FSK body {len(bits) * 100}", "dsp.modulate",
                lambda dev: modulate.modulate(bits, 100, "fsk", [-25e3, 25e3], pause=1000,
                                              device=dev),
                same_arrays, card)
        b7_launches = sum(r["b7"] for r in out.values() if "b7" in r)

        # a second placed median runs one route, counted by B7 and ROUTES
        before, launched = Counter(placement.ROUTES), mk.LAUNCHES["median_filter_f32"]
        ai_device.median_filter_rows(rows, B7_K, device="auto")
        side = route_side("ai.median_filter_rows", before)
        delta = placement.ROUTES - before
        if (side != out["median"]["verdict"] or sum(delta.values()) != 1
                or mk.LAUNCHES["median_filter_f32"] - launched != (side == "card")):
            raise AssertionError(f"a second placed median: {dict(delta)}, B7 launched "
                                 f"{mk.LAUNCHES['median_filter_f32'] - launched} times")

        # rows already on the card stay there under "auto": one B7 launch, no
        # route, the forced card's result (a rehearsal on the CPU has no card)
        if on_card:
            before, launched = Counter(placement.ROUTES), mk.LAUNCHES["median_filter_f32"]
            staged = ai_device.median_filter_rows(rows.to(card), B7_K, device="auto")
            b7_staged = mk.LAUNCHES["median_filter_f32"] - launched
            print(f"placement median_filter_rows of rows on the card: on {staged.device}, "
                  f"B7 launched {b7_staged} times, routes {dict(placement.ROUTES - before)}",
                  flush=True)
            forced = ai_device.median_filter_rows(rows, B7_K, device=card).cpu().numpy()
            if (staged.device.type != "cuda" or b7_staged != 1 or placement.ROUTES != before
                    or not same_arrays(staged.cpu().numpy(), forced)):
                raise AssertionError("placed median of rows on the card left the card, "
                                     "was routed, or differs from the forced card's")

        # awre: the first placed run races its keys, the second replays them
        walls, found = {}, {}
        for label, device in (("card", card), ("CPU", "cpu"), ("placed, first", "auto"),
                              ("placed, second", "auto")):
            before = Counter(placement.ROUTES)
            messages = awre_protocol(awre_n)
            t0 = time.perf_counter()
            ff = FormatFinder(messages, device=device)
            ff.run(max_iterations=10)
            walls[label] = time.perf_counter() - t0
            found[label] = format_summary(ff)
            runs = placement.ROUTES - before
        raced = sorted(placement._RACE_VERDICTS)
        second_sides = Counter(key for key, _ in runs)
        print(f"placement FormatFinder.run(10) over {awre_n} messages: walls (s) {walls}; "
              f"verdicts {dict(placement._RACE_VERDICTS)}; the second placed run's routes "
              f"{dict(runs)}", flush=True)
        if any(f != found["card"] for f in found.values()) or not raced:
            raise AssertionError("placement FormatFinder: the types differ, or nothing raced")
        if any(c != 1 for c in second_sides.values()):
            raise AssertionError(f"the second placed FormatFinder raced again: {dict(runs)}")
        out["awre"] = {"verdicts": dict(placement._RACE_VERDICTS), "walls": walls}

        # the store holds this link's verdicts; a fresh process replays them
        with open(placement._store_path()) as f:
            stored = json.load(f)
        if stored.get(signature) != placement._RACE_VERDICTS:
            raise AssertionError(f"placement store {stored} lacks {signature!r}'s verdicts")
        env = dict(os.environ, XDG_CONFIG_HOME=home)
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, "-c", PLACEMENT_REPLAY], env=env,
                               cwd=os.path.dirname(os.path.abspath(__file__)),
                               capture_output=True, text=True,
                               timeout=PLACEMENT_CHILD_TIMEOUT_S)
        child_wall = time.perf_counter() - t0
        if child.returncode != 0:
            raise AssertionError(f"placement replay child exited {child.returncode}: "
                                 f"{child.stderr[-2000:]}")
        replay = json.loads(child.stdout.strip().splitlines()[-1])
        want = {f"{key} {'card' if v == 'device' else 'host'}": 1
                for key, v in placement._RACE_VERDICTS.items()}
        print(f"placement replay child ({child_wall} s): signature {replay['signature']!r}, "
              f"{len(replay['keys'])} keys, calls equal to the stored winners "
              f"{replay['calls'] == want}", flush=True)
        if replay["signature"] != signature or replay["calls"] != want:
            raise AssertionError(f"placement replay: {replay}, want {want}")

        # a card route that raises: the exception comes out, no verdict is kept
        def failing():
            return (torch.ones(2, device=card) + torch.ones(3, device=card)).cpu()

        try:
            placement.race("chip_smoke.failing", failing, lambda: "host")
        except RuntimeError as exc:
            print(f"placement race with a failing card route raised: {str(exc)[:80]!r}",
                  flush=True)
        else:
            raise AssertionError("a race whose card route raised returned a result")
        with open(placement._store_path()) as f:
            if "chip_smoke.failing" in placement._RACE_VERDICTS or "chip_smoke.failing" in (
                    json.load(f).get(signature, {})):
                raise AssertionError("a race whose card route raised kept a verdict")
    if b7_launches == 0:
        raise AssertionError("the placed paths launched B7 no time")
    out["b7_launches"] = b7_launches
    out["child_wall"] = child_wall
    return out


def placement_summary(placed: dict) -> str:
    parts = [f"{label} {r['verdict']} (placed {r['walls']['auto']}, card {r['walls']['cuda']}, "
             f"CPU {r['walls']['cpu']})" for label, r in placed.items()
             if isinstance(r, dict) and "verdict" in r]
    return "; ".join(parts) + f"; FormatFinder {placed['awre']['walls']}"


# -- the CLI and the UI's model layer (phase 16) -------------------------------

CLI_RECEIVE_S = 20.0  # -rx's -rt: the RTL-TCP child's start (7-8 s) and the stream
CLI_CHILD_TIMEOUT_S = 300
CLI_TX_PAUSE = "20ms"  # 20,000 samples at 1 Msps: make_capture's pause
CLI_SINE = dict(num_samples=10_000, frequency=10e3, amplitude=0.5)  # into a pause


class LoopbackReceiver:
    """A loopback server that reads one connection to its end: the Network
    SDR's client a -tx sends to."""

    def __init__(self):
        import socket
        import threading

        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self.chunks, self.error = [], None
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        try:
            conn, _ = self._srv.accept()
            with conn:
                while chunk := conn.recv(1 << 20):
                    self.chunks.append(chunk)
        except OSError as exc:
            self.error = exc
        finally:
            self._srv.close()

    def samples(self) -> np.ndarray:
        """Every float32 sample received, once the sender closed."""
        self._thread.join(LIVE_DEADLINE_S)
        if self._thread.is_alive() or self.error is not None:
            raise AssertionError(f"-tx: the receiver did not read to the end ({self.error})")
        return np.frombuffer(bytearray(b"".join(self.chunks)), np.float32).reshape(-1, 2)


def cli_lines(argv) -> tuple:
    """urh_tpu_torch.cli's main(argv) in this process: (stdout lines, wall)."""
    import contextlib
    import io

    from urh_tpu_torch.cli import main as cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue().splitlines(), time.perf_counter() - t0


def hex_lines(bits) -> list:
    return [np.packbits(np.asarray(b, np.uint8)).tobytes().hex() for b in bits]


def bit_lines(bits) -> list:
    return ["".join(map(str, np.asarray(b, np.uint8).tolist())) for b in bits]


def cli_estimate_step(device, folder: str, n: int, env: dict) -> dict:
    """--estimate -file capture.complex --hex in this process on the
    estimated FSK capture (phase 6's: a quiet lead, 360 messages), the
    launch counts set to 0 just before and read just after; then the same
    command started in its own process (python -m urh_tpu_torch.cli),
    whose output cli_and_ui_phase reads once -rx is done."""
    iq, bits = make_capture("FSK", n, 11, lead=quiet_lead(n))
    path = os.path.join(folder, "capture.complex")
    iq.tofile(path)
    argv = ["--estimate", "-file", path, "--hex"]
    buckets = width_buckets(iq)
    reset_launches()
    lines, wall = cli_lines(argv)
    counts = read_launches()
    head, messages = lines[:5], lines[5:]
    print(f"cli --estimate ({n} samples): {head}; {len(messages)} messages; wall {wall} s; "
          f"launches B7 {counts['median_filter_f32']} ({buckets} width buckets), K1 "
          f"{counts['fsk_f32']}", flush=True)
    if head[:2] != ["modulation: FSK", "samples_per_symbol: 100"]:
        raise AssertionError(f"cli --estimate: {head}")
    if messages != hex_lines(bits):
        raise AssertionError(f"cli --estimate: {len(messages)} messages printed, "
                             f"{sum(a == b for a, b in zip(messages, hex_lines(bits)))} "
                             f"of {len(bits)} equal to the sent bits")
    if counts["median_filter_f32"] != buckets or counts["fsk_f32"] != 1:
        raise AssertionError(f"cli --estimate: launches {counts}, {buckets} width buckets")
    return {"wall": wall, "lines": lines, "child": CliChild(argv, env),
            "b7": counts["median_filter_f32"], "k1": counts["fsk_f32"]}


class CliChild:
    """``python -m urh_tpu_torch.cli argv`` in its own process, read to its
    end on a thread: its output and its wall from start to exit."""

    def __init__(self, argv, env: dict):
        import threading

        t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-m", "urh_tpu_torch.cli", *argv],
                                     env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.out = self.err = ""
        self.wall = None

        def read():
            try:
                self.out, self.err = self.proc.communicate(timeout=CLI_CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                self.proc.kill()
            self.wall = time.perf_counter() - t0

        self._thread = threading.Thread(target=read, daemon=True)
        self._thread.start()

    def result(self) -> tuple:
        """(exit code, stdout lines, stderr, wall) once it ended."""
        self._thread.join(CLI_CHILD_TIMEOUT_S + LIVE_DEADLINE_S)
        if self._thread.is_alive():
            self.proc.kill()
            raise AssertionError("cli --estimate child: still running")
        return self.proc.returncode, self.out.splitlines(), self.err, self.wall


def cli_estimate_child(estimated: dict) -> float:
    """The --estimate child's lines must be this process's; -> its wall."""
    code, lines, err, wall = estimated["child"].result()
    print(f"cli --estimate as python -m urh_tpu_torch.cli: exit code {code}, its lines equal "
          f"this process's {lines == estimated['lines']}, wall {wall} s (from its start to its "
          f"exit, beside -tx and -rx)", flush=True)
    if code != 0 or lines != estimated["lines"]:
        raise AssertionError(f"cli --estimate child: exit code {code}, {err[-2000:]}")
    return wall


def cli_transmit_step(device, folder: str, iq: np.ndarray, bits) -> dict:
    """-tx -d "Network SDR" of the capture's messages (a messages file) to a
    loopback receiver: every sample equal to Modulator.modulate's of its
    message, the pauses zero, and demodulate() of what arrived (K1) gives
    every message."""
    import urh_tpu_torch as ut
    from urh_tpu_torch.cli import main as cli
    from urh_tpu_torch.dsp import fused_kernels as fk
    from urh_tpu_torch.util import settings

    path = os.path.join(folder, "messages.txt")
    with open(path, "w") as f:
        f.write("\n".join(bit_lines(bits)) + "\n")
    receiver = LoopbackReceiver()
    settings.write("network_sdr_client_port", receiver.port)
    lines, wall = cli_lines(["-tx", "-d", NETWORK_SDR, "-f", "433.92e6", "-s", "1e6", "-mo",
                             "FSK", "-sps", "100", "-pm", "-25000", "25000", "-p", CLI_TX_PAUSE,
                             "-file", path])
    got = receiver.samples()
    # the CLI's modulator: its flags, then its defaults
    modulator = ut.Modulator("CLI Modulator")
    modulator.modulation_type, modulator.samples_per_symbol = "FSK", 100
    modulator.sample_rate, modulator.parameters = 1e6, [-25e3, 25e3]
    modulator.carrier_freq_hz = cli.DEFAULT_CARRIER_FREQUENCY
    modulator.carrier_amplitude = cli.DEFAULT_CARRIER_AMPLITUDE
    modulator.carrier_phase_deg = cli.DEFAULT_CARRIER_PHASE
    body, pause = modulator.samples_per_symbol * len(bits[0]), 20_000
    if got.shape != (len(bits) * (body + pause), 2):
        raise AssertionError(f"cli -tx: {got.shape} samples received")
    t0 = time.perf_counter()
    for i, b in enumerate(bits):
        start = i * (body + pause)
        want = modulator.modulate("".join(map(str, b)), pause=0, device=device).data
        if not np.array_equal(got[start:start + body], want) or got[start + body:
                                                                   start + body + pause].any():
            raise AssertionError(f"cli -tx: message {i}'s samples differ from "
                                 "Modulator.modulate's")
    modulate_wall = time.perf_counter() - t0
    reset_launches()
    check_messages(ut.demodulate(got, demod_params("FSK", np.float32), device=device), bits,
                   "cli -tx, demodulated")
    if fk.LAUNCHES["fsk_f32"] != 1:
        raise AssertionError(f"cli -tx: demodulate() launches {fk.LAUNCHES}")
    sent = [line for line in lines if "Successfully modulated" in line]
    print(f"cli -tx over the Network SDR: {sent}; {len(got)} samples received, each "
          f"equal to Modulator.modulate's ({modulate_wall} s for {len(bits)} calls), the "
          f"pauses zero; demodulate() (K1) gives the {len(bits)} messages; wall {wall} s "
          f"({len(got) / wall} samples/s)", flush=True)
    return {"wall": wall, "rate": len(got) / wall}


def cli_receive_step(device, folder: str, iq: np.ndarray, bits,
                     receive_s: float = CLI_RECEIVE_S) -> dict:
    """-rx -d RTL-TCP -file out.txt, fed by a fake rtl_tcp server streaming
    the int8 capture (as rtl_tcp_phase), then two pause gates of silence and
    once those are fed one gate more: the file holds every message, and
    urh_stream_block_i8 launched once a drain.  RTL-TCP ignores its port
    (ROADMAP C6): the CLI's sniffer builder is wrapped to point the device at
    the server, to count the drains and to time the messages."""
    import contextlib
    import io
    import threading

    from urh_tpu_torch.cli import main as cli
    from urh_tpu_torch.core.iq import resolve_device
    from urh_tpu_torch.dsp import stream_kernels as sk
    from urh_tpu_torch.protocol import stream

    i8 = to_int8(iq)
    wire = (i8.astype(np.int16) + 128).astype(np.uint8)
    gate = np.full((stream.PAUSE_GATE_SYMBOLS * 100, 2), 128, np.uint8)
    out_path = os.path.join(folder, "out.txt")
    build, built = cli.build_protocol_sniffer_from_args, threading.Event()
    record = {"drains": [], "first_sample": None, "messages": []}

    def wrapped(args):
        sniffer = build(args)
        dev = sniffer.rcv_device._dev
        if type(dev).__name__ != "RTLSDRTCP" or sniffer.compute_device != resolve_device(
                device):
            raise AssertionError(f"cli -rx: {type(dev).__name__} on {sniffer.compute_device}")
        dev.port = server.port
        ingest, commit = sniffer._ingest, dev._commit_samples

        def counted_ingest(chunk):
            record["drains"].append(len(chunk))
            ingest(chunk)

        def timed_commit(samples):
            if record["first_sample"] is None and len(samples):
                record["first_sample"] = time.perf_counter()
            return commit(samples)

        sniffer._ingest, dev._commit_samples = counted_ingest, timed_commit
        sniffer.message_sniffed.connect(
            lambda _: record["messages"].append(time.perf_counter()))
        record["sniffer"] = sniffer
        built.set()
        return sniffer

    for counts in (sk.LAUNCHES, stream.FALLBACKS, stream.HOST_ROUTE):
        for key in counts:
            counts[key] = 0
    faults = []
    server = FakeRtlTcpServer()
    argv = ["-rx", "-d", RTL_TCP, "-f", "433.92e6", "-s", "1e6", "-mo", "FSK", "-sps", "100",
            "-c", "0", "-n", "0.15", "-t", "5", "-pm", "-25000", "25000", "-rt", str(receive_s),
            "-file", out_path]

    def run():
        try:
            cli.main(argv)
        except (Exception, SystemExit) as exc:  # a thread's SystemExit is silent otherwise
            faults.append(repr(exc))

    cli.build_protocol_sniffer_from_args = wrapped
    printed = io.StringIO()
    try:
        with ThreadFaults() as thread_faults, contextlib.redirect_stdout(printed):
            t0 = time.perf_counter()
            thread = threading.Thread(target=run, daemon=True)
            thread.start()
            if not built.wait(LIVE_DEADLINE_S):
                raise AssertionError(f"cli -rx: no sniffer built ({faults})")
            sniffer = record["sniffer"]
            if not server.connected.wait(LIVE_DEADLINE_S):
                raise AssertionError("cli -rx: the RTL-TCP child did not connect")
            connect_s = time.perf_counter() - t0
            server.send(wire.tobytes() + np.tile(gate, (LIVE_SILENCE_GATES, 1)).tobytes())
            total = len(wire) + LIVE_SILENCE_GATES * len(gate)
            wait_drained(sniffer, total, "cli -rx")
            server.send(gate.tobytes())
            wait_drained(sniffer, total + len(gate), "cli -rx")
            wait_for(lambda: len(record["messages"]) >= len(bits), "cli -rx: every message")
            fed_s = time.perf_counter() - t0
            thread.join(receive_s + LIVE_DEADLINE_S)
            wall = time.perf_counter() - t0
            if thread.is_alive() or faults:
                raise AssertionError(f"cli -rx: main() did not return ({faults})")
            exitcode = sniffer.rcv_device._dev.receive_process.exitcode
            thread_faults.check("cli -rx")
    finally:
        cli.build_protocol_sniffer_from_args = build
        server.close()
    with open(out_path) as f:
        written = f.read().splitlines()
    drains = record["drains"]
    launches = sk.LAUNCHES["stream_block_i8"]
    live_wall = record["messages"][-1] - record["first_sample"]
    print(f"cli -rx over RTL-TCP: {printed.getvalue().split()[:4]}; {len(written)} messages "
          f"written, equal to the sent bits {written == bit_lines(bits)}; the child connected "
          f"{connect_s} s after main() started and exited {exitcode}; {len(drains)} drains, "
          f"urh_stream_block_i8 launches {launches}; first sample received to the last "
          f"message {live_wall} s ({(total + len(gate)) / live_wall} samples/s); every "
          f"message in {fed_s} s, main() returned after {wall} s (-rt {receive_s})",
          flush=True)
    if written != bit_lines(bits):
        raise AssertionError(f"cli -rx: {len(written)} messages written, sent {len(bits)}")
    if launches != len(drains) or not launches or stream.FALLBACKS["states"] or any(
            stream.HOST_ROUTE.values()) or sum(v for k, v in sk.LAUNCHES.items()
                                               if k != "stream_block_i8") or exitcode != 0:
        raise AssertionError(f"cli -rx: launches {sk.LAUNCHES} for {len(drains)} drains, "
                             f"fallbacks {stream.FALLBACKS}, host route {stream.HOST_ROUTE}, "
                             f"the child exited {exitcode}")
    return {"wall": wall, "connect_s": connect_s, "live_wall": live_wall,
            "drains": len(drains), "launches": launches}


def undo_step(label: str, stack, proto, sig, iq: np.ndarray, bits, action) -> dict:
    """Push an edit, check what it left, undo it: the samples equal to the
    word and every message back through K1 (launched once).  -> walls."""
    from urh_tpu_torch.dsp import fused_kernels as fk

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stack.push(action())
    torch.cuda.synchronize()
    do_wall = time.perf_counter() - t0
    after = [np.frombuffer(bytes(m.plain_bits), np.uint8) for m in proto.messages]
    t0 = time.perf_counter()
    stack.undo()
    undo_wall = time.perf_counter() - t0
    if not np.array_equal(sig.iq_array.data, iq):
        raise AssertionError(f"undo {label}: the samples differ from the original")
    reset_launches()
    t0 = time.perf_counter()
    proto.get_protocol_from_signal()
    torch.cuda.synchronize()
    demod_wall = time.perf_counter() - t0
    check_messages(proto.messages, bits, f"undo {label}, demodulated again")
    if fk.LAUNCHES["fsk_f32"] != 1:
        raise AssertionError(f"undo {label}: demodulated again with launches {fk.LAUNCHES}")
    print(f"undo stack {label}: {len(after)} messages after it ({do_wall} s), undone in "
          f"{undo_wall} s, samples equal to the word, {len(bits)} messages through K1 in "
          f"{demod_wall} s", flush=True)
    return {"after": after, "walls": (do_wall, undo_wall, demod_wall)}


def undo_stack_phase(device, iq: np.ndarray, bits) -> dict:
    """The undo stack's signal edits on a Signal of the capture on
    ``device``, each with its protocol: the 51-tap band-pass over the whole
    capture (every message), muting the first message and the pause after it
    (a muted FSK range is zero frequency, decoded as zeros up to the next
    message: one message fewer, the rest exact), an InsertSine into the
    first pause (one message of ones more); each undone."""
    from urh_tpu_torch import Signal
    from urh_tpu_torch.dsp.filters import Filter
    from urh_tpu_torch.plugins.insert_sine import InsertSinePlugin
    from urh_tpu_torch.protocol.analyzer import ProtocolAnalyzer
    from urh_tpu_torch.ui.actions import EditAction, EditSignalAction
    from urh_tpu_torch.ui.undo import UndoStack

    sig = Signal.from_iq(iq.copy(), device=device)
    sig.params = demod_params("FSK", np.float32)
    proto = ProtocolAnalyzer(sig)
    reset_launches()
    proto.get_protocol_from_signal()
    check_messages(proto.messages, bits, "undo stack, first demodulation")
    launches = read_launches()["fsk_f32"]
    stack, n = UndoStack(), len(iq)
    sent = [np.asarray(b, np.uint8) for b in bits]
    fir = Filter(Filter.design_windowed_sinc_bandpass(*BANDPASS))
    out = {}
    out["filter"] = undo_step("filter", stack, proto, sig, iq, bits, lambda: EditSignalAction(
        sig, EditAction.filter, start=0, end=n, dsp_filter=fir, protocol=proto))
    launches += 1
    if not all(np.array_equal(a, b) for a, b in zip(out["filter"]["after"], sent)) or len(
            out["filter"]["after"]) != len(sent):
        raise AssertionError("undo stack filter: the filtered capture's messages differ")
    first = proto.messages[0].bit_sample_pos
    out["mute"] = undo_step("mute", stack, proto, sig, iq, bits, lambda: EditSignalAction(
        sig, EditAction.mute, start=int(first[0]), end=int(first[-1]), protocol=proto))
    launches += 1
    after = out["mute"]["after"]
    if len(after) != len(sent) - 1 or not all(
            np.array_equal(a, b) for a, b in zip(after[1:], sent[2:])) or not (
            np.array_equal(after[0][-len(sent[1]):], sent[1])
            and not after[0][:-len(sent[1])].any()):
        raise AssertionError(f"undo stack mute: {len(after)} messages after muting the first")
    sine = InsertSinePlugin()
    for key, value in CLI_SINE.items():
        setattr(sine, key, value)
    wave = sine.generate_sine_wave(sig.iq_array.dtype)
    position = int(first[-2]) + 20_000 // 2 - len(wave) // 2  # [-2]: the message's end
    out["insert"] = undo_step("InsertSine", stack, proto, sig, iq, bits, lambda: (
        EditSignalAction(sig, EditAction.insert, position=position, data_to_insert=wave,
                         protocol=proto)))
    launches += 1
    after = out["insert"]["after"]
    if len(after) != len(sent) + 1 or not after[1].all() or not all(
            np.array_equal(a, b) for a, b in zip(after[:1] + after[2:], sent)):
        raise AssertionError(f"undo stack InsertSine: {len(after)} messages after it")
    print(f"undo stack: the mute left a first message of {len(out['mute']['after'][0])} bits; "
          f"the sine a message of {len(after[1])} ones", flush=True)
    return {"walls": {k: v["walls"] for k, v in out.items()}, "k1": launches}


def cli_and_ui_phase(device, identity: str, n: int = N_FULL,
                     receive_s: float = CLI_RECEIVE_S) -> dict:
    """The port's CLI (urh_tpu_torch.cli.main, in this process, so the
    launch counts can be read) on ``device`` (None: the card, with
    URH_TPU_TORCH_DEVICE unset) in a temporary config dir: --estimate of the
    estimated FSK capture, also as python -m urh_tpu_torch.cli in its own
    process; -tx of the FSK capture's messages over the Network SDR; -rx
    over RTL-TCP of the int8 capture; then the undo stack's edits of the
    capture.  -> walls and the launches of K1, B7 and B6 int8 on this path."""
    import tempfile

    from urh_tpu_torch.cli import main as cli
    from urh_tpu_torch.util import logging as urh_logging
    from urh_tpu_torch.util import settings

    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(folder, exist_ok=True)
    saved_env, level = os.environ.get(cli.DEVICE_ENV), urh_logging.logger.level
    saved_log_path = urh_logging.LOG_LEVEL_PATH
    with tempfile.TemporaryDirectory(dir=folder) as home:
        settings._config_dir = os.path.join(home, "urh_tpu")
        settings._settings_file = os.path.join(settings._config_dir, "settings.json")
        settings._store = None
        urh_logging.LOG_LEVEL_PATH = os.path.join(home, "log_level")
        if device is None:
            os.environ.pop(cli.DEVICE_ENV, None)
        else:
            os.environ[cli.DEVICE_ENV] = str(device)
        env = dict(os.environ, XDG_CONFIG_HOME=home)
        try:
            t0 = time.perf_counter()
            estimated = cli_estimate_step(device, home, n, env)
            try:
                iq, bits = make_capture("FSK", n, 11)
                transmitted = cli_transmit_step(device, home, iq, bits)
                received = cli_receive_step(device, home, iq, bits, receive_s)
            finally:
                child_wall = cli_estimate_child(estimated)
            undone = undo_stack_phase(device, iq, bits)
            wall = time.perf_counter() - t0
        finally:
            urh_logging.LOG_LEVEL_PATH = saved_log_path
            urh_logging.logger.setLevel(level)
            if saved_env is None:
                os.environ.pop(cli.DEVICE_ENV, None)
            else:
                os.environ[cli.DEVICE_ENV] = saved_env
    out = {"estimate": estimated["wall"], "estimate_child": child_wall,
           "tx": transmitted, "rx": received, "undo": undone["walls"], "wall": wall,
           "launches": {"fsk_f32": estimated["k1"], "median_filter_f32": estimated["b7"],
                        "stream_block_i8": received["launches"]},
           "undo_k1": undone["k1"]}
    print(f"cli and UI phase: {wall} s on {identity}", flush=True)
    return out


WEB_SPECTROGRAM = (0, 1 << 20, 1024)  # start, end, window of the spectrogram route
WEB_SIM_ROUNDS = 4
WEB_POLL_S = 0.05


class WebApp:
    """A port WebUI served on 127.0.0.1:0 in this process, driven over HTTP
    with http.client as a browser's page drives it."""

    def __init__(self, device, label: str):
        import threading

        from urh_tpu_torch.ui.web import WebUI, make_server

        self.ui, self.label, self.walls = WebUI(device=device), label, {}
        self.server = make_server(self.ui, host="127.0.0.1", port=0)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def call(self, method: str, path: str, body=None, key: str = None):
        """The route's reply (JSON, or the PNG's bytes); any status but 200
        fails the phase with the route's error text.  The wall of the
        request is kept under ``key`` (default: the route, its signal id
        left out)."""
        import re
        from http.client import HTTPConnection

        conn = HTTPConnection("127.0.0.1", self.server.server_address[1],
                              timeout=LIVE_DEADLINE_S)
        t0 = time.perf_counter()
        try:
            conn.request(method, path, body=None if body is None else json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
        finally:
            conn.close()
        self.walls[key or re.sub(r"/\d+/", "/", path.split("?")[0])] = time.perf_counter() - t0
        reply = json.loads(data) if resp.getheader("Content-Type") == "application/json" else data
        if resp.status != 200:
            raise AssertionError(f"web {self.label}: {method} {path} answered {resp.status}: "
                                 f"{reply}")
        return reply

    def close(self):
        """Stop what the app started (its sniffer, simulator and devices),
        then the server."""
        for route in ("sniffer_stop", "simulator_stop", "device_send_stop",
                      "device_spectrum_stop", "device_rfcat_stop", "device_record_stop"):
            getattr(self.ui, route)(None, None)
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(LIVE_DEADLINE_S)


def png_pixels(png: bytes) -> np.ndarray:
    """(H, W, 4) BGRA of a PNG that urh_tpu_torch.ui.png wrote (one IDAT,
    filter 0 on every row)."""
    import struct
    import zlib

    w, h = struct.unpack(">II", png[16:24])
    (length,) = struct.unpack(">I", png[33:37])
    raw = np.frombuffer(zlib.decompress(png[41:41 + length]), np.uint8).reshape(h, 1 + 4 * w)
    return raw[:, 1:].reshape(h, w, 4)[..., [2, 1, 0, 3]]


def web_messages_step(app, path: str, bits, k1: int = None) -> dict:
    """/api/signal/open, /params (FSK, 100 samples a symbol, center 0, the
    noise and tolerance of demod_params), /messages: every message equal to
    the sent bits, and K1 launched ``k1`` times by /params and /messages
    when given (the noise threshold's change drops the cached qad).  -> K1's
    launches there."""
    p = demod_params("FSK", np.float32)
    opened = app.call("POST", "/api/signal/open", {"path": path})
    reset_launches()
    params = app.call("POST", f"/api/signal/{opened['id']}/params", {
        "modulation_type": "FSK", "samples_per_symbol": p.samples_per_symbol,
        "center": p.center, "noise_threshold": p.noise_threshold, "tolerance": p.tolerance,
        "pause_threshold": p.pause_threshold})
    messages = app.call("GET", f"/api/signal/{opened['id']}/messages?view=0")["messages"]
    launched = read_launches()["fsk_f32"]
    print(f"web {app.label} messages: {opened['name']} of {opened['num_samples']} samples, "
          f"{len(messages)} messages through /messages, K1 {launched}", flush=True)
    if messages != bit_lines(bits):
        raise AssertionError(f"web {app.label}: {len(messages)} messages through /messages, "
                             f"sent {len(bits)}, not all equal")
    if k1 is not None and launched != k1:
        raise AssertionError(f"web {app.label}: K1 launched {launched} times by /params and "
                             f"/messages, not {k1}")
    return {"id": opened["id"], "params": params, "k1": launched}


def web_spectrogram_step(app, cpu, path: str):
    """/spectrogram over WEB_SPECTROGRAM on the card and on the CPU app: PNGs
    of the expected size, colour indices within 1 on every cell, and the dB
    image the route renders within DB_ATOL at or above DB_FLOOR (the same
    non-finite cells)."""
    import struct

    from urh_tpu_torch.dsp.spectrogram import Spectrogram
    from urh_tpu_torch.util import colormaps

    samples = np.fromfile(path, np.complex64)
    start, end, window = WEB_SPECTROGRAM
    end = min(end, len(samples))
    query = f"/api/signal/0/spectrogram?window={window}&start={start}&end={end}"
    pngs = [a.call("GET", query) for a in (app, cpu)]
    frames = (end - start - window) // (window // 2) + 1
    sizes = [struct.unpack(">II", png[16:24]) for png in pngs]
    table = {tuple(row): i for i, row in enumerate(colormaps.chosen_colormap_numpy_bgra)}
    indices = [np.vectorize(lambda *px: table[px], otypes=[np.int64])(
        *np.moveaxis(png_pixels(png), -1, 0)) for png in pngs]
    db = [Spectrogram(samples, window_size=window, device=a.ui.device)
          ._calculate_spectrogram(samples[start:end]) for a in (app, cpu)]
    finite = np.isfinite(db[1])
    above = finite & (db[1] >= DB_FLOOR)
    db_err = float(np.abs(db[0] - db[1])[above].max())
    index_err = int(np.abs(indices[0] - indices[1]).max())
    print(f"web spectrogram: PNGs of {sizes[0]} (card) and {sizes[1]} (CPU), {len(pngs[0])} "
          f"bytes; colour index diff {index_err}; dB diff {db_err} (limit {DB_ATOL}) on the "
          f"{above.mean():.6%} of cells at or above {DB_FLOOR} dB", flush=True)
    if sizes != [(frames, window)] * 2 or index_err > 1 or db_err > DB_ATOL or not np.array_equal(
            np.isfinite(db[0]), finite):
        raise AssertionError("web spectrogram: the card's image differs from the CPU's")


def web_awre_step(app, cpu):
    """/api/analysis/add and /api/analysis/awre of signal 0 on both apps: the
    same message types and labels."""
    found = []
    for a in (app, cpu):
        rows = a.call("POST", "/api/analysis/add", {"signal_id": 0})["rows"]
        found.append((rows, a.call("POST", "/api/analysis/awre")["message_types"]))
    print(f"web awre over {found[0][0]} rows: {len(found[0][1])} message types, labels "
          f"{[[l['name'] for l in mt['labels']] for mt in found[0][1]]}; equal to the CPU "
          f"app's {found[0] == found[1]}", flush=True)
    if found[0] != found[1]:
        raise AssertionError(f"web awre: card {found[0]}, CPU {found[1]}")


def web_autodetect_step(app, path: str, iq: np.ndarray, bits) -> dict:
    """/api/signal/open of phase 6's capture (its quiet lead), /autodetect:
    FSK at 100 samples a bit with B7 once a width bucket; /messages at the
    detected parameters: every message exact."""
    signal_id = app.call("POST", "/api/signal/open", {"path": path},
                         key="/api/signal/open (phase 6's capture)")["id"]
    buckets = width_buckets(iq)
    reset_launches()
    found = app.call("POST", f"/api/signal/{signal_id}/autodetect")
    counts = read_launches()
    messages = app.call("GET", f"/api/signal/{signal_id}/messages?view=0",
                        key="/api/signal/messages (autodetected)")["messages"]
    params = found["params"]
    print(f"web autodetect: {params}; B7 launches {counts['median_filter_f32']} for {buckets} "
          f"width buckets, K1 {counts['fsk_f32']}; {len(messages)} messages", flush=True)
    if not found["success"] or (params["modulation_type"], params["samples_per_symbol"]) != (
            "FSK", 100.0) or counts["median_filter_f32"] != buckets:
        raise AssertionError(f"web autodetect: {found}, launches {counts}")
    if messages != bit_lines(bits):
        raise AssertionError(f"web autodetect: {len(messages)} messages at the detected "
                             f"parameters, sent {len(bits)}")
    return {"b7": counts["median_filter_f32"], "k1": counts["fsk_f32"]}


def web_bandpass_step(app, bits) -> dict:
    """/bandpass of signal 0 around the FSK band into a new signal, then its
    /messages: every message exact, K1 once."""
    f_low, f_high, bw = BANDPASS
    reset_launches()
    new = app.call("POST", "/api/signal/0/bandpass", {"f_low": f_low, "f_high": f_high,
                                                      "bw": bw})
    messages = app.call("GET", f"/api/signal/{new['id']}/messages?view=0",
                        key="/api/signal/messages (band-passed)")["messages"]
    k1 = read_launches()["fsk_f32"]
    print(f"web bandpass: {new['name']}, {len(messages)} messages, K1 {k1}", flush=True)
    if messages != bit_lines(bits) or k1 != 1:
        raise AssertionError(f"web bandpass: {len(messages)} messages, K1 launches {k1}")
    return {"k1": k1}


def web_edit_step(app, iq: np.ndarray, bits) -> dict:
    """/edit muting the first message of signal 0 and its pause, then /undo
    (ROADMAP C11): one message fewer, the first zeros up to the second; then
    every message back and the samples equal to the capture's to the word."""
    sent = bit_lines(bits)
    first = app.ui.main.signal_frames[0].proto_analyzer.messages[0].bit_sample_pos
    reset_launches()
    app.call("POST", "/api/signal/0/edit", {"action": "mute", "start": int(first[0]),
                                            "end": int(first[-1])})
    muted = app.call("GET", "/api/signal/0/messages?view=0",
                     key="/api/signal/messages (muted)")["messages"]
    app.call("POST", "/api/signal/0/undo")
    undone = app.call("GET", "/api/signal/0/messages?view=0",
                      key="/api/signal/messages (undone)")["messages"]
    k1 = read_launches()["fsk_f32"]
    same = np.array_equal(app.ui.main.signal_frames[0].signal.iq_array.data, iq)
    print(f"web edit: mute -> {len(muted)} messages, undo -> {len(undone)}, the samples "
          f"equal to the word {same}, K1 {k1}", flush=True)
    if len(muted) != len(sent) - 1 or muted[1:] != sent[2:] or not (
            muted[0].endswith(sent[1]) and set(muted[0][:-len(sent[1])]) == {"0"}):
        raise AssertionError(f"web edit: {len(muted)} messages after muting the first")
    if undone != sent or not same:
        raise AssertionError(f"web undo: {len(undone)} messages, samples equal {same}")
    return {"k1": k1}


def web_generator_step(app, folder: str, device, bits):
    """/api/generator/add of signal 0, /api/generator/generate to a file:
    every sample equal to Modulator.modulate's of its message with the
    generator's modulator, as the page shows it, and the pauses zero."""
    import urh_tpu_torch as ut

    rows = app.call("POST", "/api/generator/add", {"signal_id": 0})["rows"]
    path = os.path.join(folder, "generated.complex")
    reply = app.call("POST", "/api/generator/generate", {"filename": path})
    table = app.call("GET", "/api/generator/table")["rows"]
    fields = app.call("GET", "/api/generator/modulators")["modulators"][0]
    m = ut.Modulator(fields["name"])
    for key in ("modulation_type", "carrier_freq_hz", "carrier_amplitude",
                "carrier_phase_deg", "samples_per_symbol", "bits_per_symbol", "sample_rate",
                "parameters", "gauss_bt", "gauss_filter_width"):
        setattr(m, key, fields[key])
    got = np.fromfile(path, np.float32).reshape(-1, 2)
    t0, pos = time.perf_counter(), 0
    for i, row in enumerate(table):
        want = m.modulate(row["data"], pause=0, device=device).data
        if not np.array_equal(got[pos:pos + len(want)], want) or got[
                pos + len(want):pos + len(want) + row["pause"]].any():
            raise AssertionError(f"web generate: message {i}'s samples differ from "
                                 "Modulator.modulate's")
        pos += len(want) + row["pause"]
    modulate_wall = time.perf_counter() - t0
    print(f"web generate: {rows} rows, {reply['samples']} samples written, each equal to "
          f"Modulator.modulate's ({modulate_wall} s for {len(table)} calls), the pauses zero",
          flush=True)
    if pos != len(got) != reply["samples"] or [r["data"] for r in table] != bit_lines(bits):
        raise AssertionError(f"web generate: {len(got)} samples, {pos} checked")


def web_sniffer_step(app, iq: np.ndarray, bits) -> dict:
    """/api/sniffer/start over the Network SDR, the capture sent to its port
    over loopback with two pause gates of silence and, once those are
    drained, one more; /api/sniffer/messages until every message is there,
    /stop, /to_analysis: every message exact, one B6 float32 launch a
    drain."""
    from urh_tpu_torch.dsp import stream_kernels as sk
    from urh_tpu_torch.protocol import stream

    p = demod_params("FSK", np.float32)
    for counts in (sk.LAUNCHES, stream.FALLBACKS, stream.HOST_ROUTE):
        for key in counts:
            counts[key] = 0
    started = app.call("POST", "/api/sniffer/start", {
        "device": NETWORK_SDR, "server_port": 0, "samples_per_symbol": p.samples_per_symbol,
        "center": p.center, "noise": p.noise_threshold, "tolerance": p.tolerance,
        "modulation_type": "FSK"})
    sniffer, drains = app.ui._sniffer, []
    ingest = sniffer._ingest

    def counted_ingest(chunk):
        drains.append(len(chunk))
        ingest(chunk)

    sniffer._ingest = counted_ingest
    gate = np.zeros((stream.PAUSE_GATE_SYMBOLS * p.samples_per_symbol, 2), np.float32)
    t0 = time.perf_counter()
    send_raw(started["port"], iq)
    send_raw(started["port"], np.concatenate([gate] * LIVE_SILENCE_GATES))
    total = len(iq) + LIVE_SILENCE_GATES * len(gate)
    wait_drained(sniffer, total, "web sniffer")
    send_raw(started["port"], gate)
    wait_drained(sniffer, total + len(gate), "web sniffer")
    deadline = time.monotonic() + LIVE_DEADLINE_S
    while True:
        messages = app.call("GET", "/api/sniffer/messages?view=0")["messages"]
        if len(messages) >= len(bits) or time.monotonic() > deadline:
            break
        time.sleep(WEB_POLL_S)
    wall = time.perf_counter() - t0
    stopped = app.call("POST", "/api/sniffer/stop", {})
    rows = app.call("POST", "/api/sniffer/to_analysis", {})["rows"]
    launches = sk.LAUNCHES["stream_block_f32"]
    print(f"web sniffer: {len(messages)} messages equal to the sent bits "
          f"{messages == bit_lines(bits)}, {stopped['messages']} at /stop, {rows} analysis "
          f"rows after /to_analysis; {len(drains)} drains, urh_stream_block_f32 launches "
          f"{launches}; {total + len(gate)} samples sent to every message back in {wall} s "
          f"({(total + len(gate)) / wall} samples/s)", flush=True)
    if messages != bit_lines(bits) or stopped["messages"] != len(bits):
        raise AssertionError(f"web sniffer: {len(messages)} messages, sent {len(bits)}")
    if launches != len(drains) or not launches or stream.FALLBACKS["states"] or any(
            stream.HOST_ROUTE.values()):
        raise AssertionError(f"web sniffer: launches {sk.LAUNCHES} for {len(drains)} drains, "
                             f"fallbacks {stream.FALLBACKS}, host route {stream.HOST_ROUTE}")
    return {"b6": launches, "drains": len(drains), "wall": wall}


def web_simulator_step(app, folder: str, device, rounds: int = WEB_SIM_ROUNDS) -> dict:
    """Phase 12's simulator profile (``rounds`` rounds), saved as a .sim.xml
    and run through /api/project/settings, /api/generator/modulator,
    /api/simulator/load, /start, /log and /stop, the SDRs Network SDRs over
    loopback: every answer with sequence number + 1 and a valid CRC, "Finished"
    in the log, one B6 float32 launch a drain."""
    import socket
    import xml.etree.ElementTree as ET

    import urh_tpu_torch as ut
    from urh_tpu_torch.dsp import stream_kernels as sk
    from urh_tpu_torch.protocol import stream

    rng = np.random.default_rng(31)
    p = demod_params("FSK", np.float32)
    bob, alice = (tx_modulator("FSK", 1, [-25e3, 25e3]) for _ in range(2))
    for m in (bob, alice):
        m.carrier_freq_hz, m.carrier_phase_deg = 0.0, 0
    bob_data = "".join(map(str, rng.integers(0, 2, 200)))
    _, config, _ = simulator_config(bob, bob_data, rounds)
    path = os.path.join(folder, "profile.sim.xml")
    ET.ElementTree(config.save_to_xml(standalone=True)).write(path)
    app.call("POST", "/api/project/settings", {"simulator_num_repeat": rounds,
                                                "simulator_timeout_ms": SIM_TIMEOUT_MS})
    app.call("POST", "/api/generator/modulator", {
        "action": "edit", "index": 0, "modulation_type": "FSK", "samples_per_symbol": 100,
        "carrier_freq_hz": 0.0, "carrier_phase_deg": 0.0, "parameters": [-25e3, 25e3]})
    items = app.call("POST", "/api/simulator/load", {"path": path})
    if not items["valid"]:
        raise AssertionError(f"web simulator: the loaded profile is not valid: {items}")
    for counts in (sk.LAUNCHES, stream.FALLBACKS, stream.HOST_ROUTE):
        for key in counts:
            counts[key] = 0
    gate = np.zeros((stream.PAUSE_GATE_SYMBOLS * p.samples_per_symbol, 2), np.float32)
    answer_bytes = (256 * p.samples_per_symbol + SIM_PAUSE) * 8
    sink = socket.create_server(("127.0.0.1", 0))
    sink.settimeout(LIVE_DEADLINE_S)
    conn = alice_tx = None
    try:
        started = app.call("POST", "/api/simulator/start", {
            "samples_per_symbol": p.samples_per_symbol, "center": p.center,
            "noise": p.noise_threshold, "tolerance": p.tolerance, "modulation_type": "FSK",
            "rx_server_port": 0, "tx_client_port": sink.getsockname()[1]})
        sim, drains = app.ui.main.simulator_tab_controller.simulator, []
        ingest = sim.sniffer._ingest

        def counted_ingest(chunk):
            drains.append(len(chunk))
            ingest(chunk)

        sim.sniffer._ingest = counted_ingest
        conn, _ = sink.accept()
        conn.settimeout(LIVE_DEADLINE_S)
        alice_tx = socket.create_connection(("127.0.0.1", started["rx_port"]))
        sent, walls = 0, []
        for r in range(rounds):
            seq = int(rng.integers(0, 255))
            body = format(seq, "08b") + "".join(map(str, rng.integers(0, 2, 200)))
            iq = alice.modulate(SIM_PREAMBLE + SIM_SYNC + body + sim_checksum(body), pause=0,
                                device=device).data
            alice_tx.sendall(np.concatenate((iq, gate)).tobytes())
            sent += len(iq) + len(gate)
            wait_for(lambda: sim.sniffer.drain_position == sent, f"web simulator round {r}")
            alice_tx.sendall(gate.tobytes())
            sent += len(gate)
            t_sent = time.perf_counter()
            raw = recv_exactly(conn, answer_bytes)
            walls.append(time.perf_counter() - t_sent)
            got = [m.plain_bits_str for m in ut.demodulate(
                np.frombuffer(raw, np.float32).reshape(-1, 2), p, device=device)]
            want_head = SIM_PREAMBLE + SIM_SYNC + format(seq + 1, "08b") + bob_data
            if len(got) != 1 or got[0][:240] != want_head or \
                    got[0][240:] != sim_checksum(got[0][32:240]):
                raise AssertionError(f"web simulator round {r}: Bob's answer {got} to "
                                     f"sequence number {seq}")
        alice_tx.close()
        alice_tx = None
        deadline = time.monotonic() + LIVE_DEADLINE_S
        while True:
            log = app.call("GET", "/api/simulator/log")
            if not log["running"] or time.monotonic() > deadline:
                break
            time.sleep(WEB_POLL_S)
        app.call("POST", "/api/simulator/stop", {})
    finally:
        for s in (alice_tx, conn, sink):
            if s is not None:
                s.close()
    text = "\n".join(log["log"])
    launches = sk.LAUNCHES["stream_block_f32"]
    print(f"web simulator: {rounds} rounds, every answer sequence number + 1 with a valid CRC; "
          f"round walls (s) {walls}; {len(drains)} drains, urh_stream_block_f32 launches "
          f"{launches}; finished {'Stop simulation (Finished)' in text}", flush=True)
    for fault in ("Receive timeout", "Mismatch", "not received", "Devices not ready"):
        if fault in text:
            raise AssertionError(f"web simulator: the log has {fault!r}:\n{text}")
    if log["running"] or "Stop simulation (Finished)" not in text:
        raise AssertionError(f"web simulator: the simulation did not finish:\n{text}")
    if launches != len(drains) or not launches or stream.FALLBACKS["states"] or any(
            stream.HOST_ROUTE.values()):
        raise AssertionError(f"web simulator: launches {sk.LAUNCHES} for {len(drains)} drains")
    return {"b6": launches, "walls": walls}


def web_phase(device, identity: str, n: int = N_FULL, sim_rounds: int = WEB_SIM_ROUNDS) -> dict:
    """The port's web app (urh_tpu_torch.ui.web) served in this process on
    127.0.0.1:0 with ``WebUI(device=device)`` (None: the card, with
    URH_TPU_TORCH_DEVICE unset) and driven over HTTP, in a temporary config
    dir, beside a second ``WebUI(device="cpu")``, on phase 3's n-sample
    float32 FSK capture written as .complex: open, params and messages (K1);
    the spectrogram of its first 2^20 samples against the CPU app's; awre of
    its messages against the CPU app's (before the other signals open, so
    both apps analyze the same messages); autodetect of phase 6's capture
    (B7); a band-pass into a new signal and its messages (K1); a mute and
    its undo (C11); the generator's file against Modulator.modulate; the
    sniffer over the Network SDR (B6 float32); ``sim_rounds`` rounds of phase
    12's simulator profile.  Any reply but 200 fails the phase; the servers
    and what they started are stopped in a finally.  -> walls and the
    launches of K1, B7 and B6 float32 on the web routes."""
    import tempfile

    from urh_tpu_torch.cli import main as cli
    from urh_tpu_torch.util import settings

    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(folder, exist_ok=True)
    saved_env = os.environ.get(cli.DEVICE_ENV)
    saved_settings = (settings._config_dir, settings._settings_file, settings._store)
    with tempfile.TemporaryDirectory(dir=folder) as home:
        settings._config_dir = os.path.join(home, "urh_tpu")
        settings._settings_file = os.path.join(settings._config_dir, "settings.json")
        settings._store = None
        if device is None:
            os.environ.pop(cli.DEVICE_ENV, None)
        apps = []
        try:
            t0 = time.perf_counter()
            iq, bits = make_capture("FSK", n, 11)
            capture = os.path.join(home, "capture.complex")
            iq.tofile(capture)
            quiet, quiet_bits = make_capture("FSK", n, 11, lead=quiet_lead(n))
            quiet_path = os.path.join(home, "quiet.complex")
            quiet.tofile(quiet_path)
            app = WebApp(device, "card" if device is None else str(device))
            apps.append(app)
            cpu = WebApp("cpu", "CPU")
            apps.append(cpu)
            opened = web_messages_step(app, capture, bits, k1=1)
            web_messages_step(cpu, capture, bits)
            web_spectrogram_step(app, cpu, capture)
            web_awre_step(app, cpu)
            detected = web_autodetect_step(app, quiet_path, quiet, quiet_bits)
            band = web_bandpass_step(app, bits)
            edited = web_edit_step(app, iq, bits)
            web_generator_step(app, home, device, bits)
            sniffed = web_sniffer_step(app, iq, bits)
            simulated = web_simulator_step(app, home, device, sim_rounds)
            wall = time.perf_counter() - t0
        finally:
            for a in apps:
                a.close()
            settings._config_dir, settings._settings_file, settings._store = saved_settings
            if saved_env is not None:
                os.environ[cli.DEVICE_ENV] = saved_env
    launches = {"fsk_f32": opened["k1"] + detected["k1"] + band["k1"] + edited["k1"],
                "median_filter_f32": detected["b7"],
                "stream_block_f32": sniffed["b6"] + simulated["b6"]}
    print("web routes' walls (s): " + "; ".join(f"{k} {v}" for k, v in app.walls.items())
          + f"; the CPU app's {cpu.walls}", flush=True)
    print(f"web phase: {wall} s on {identity}; launches on the web routes {launches}",
          flush=True)
    return {"wall": wall, "walls": dict(app.walls), "launches": launches,
            "sniffer_wall": sniffed["wall"], "sim_walls": simulated["walls"]}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is available")
    from urh_tpu_torch import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)
    identity = card_identity()
    clock = sm_clock_hz()

    def elapsed(after: str):
        print(f"elapsed after {after}: {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = kernel_phase("cuda")
    stream_phase("cuda")
    b5 = b5_phase("cuda")
    b6 = b6_phase("cuda")
    elapsed("the kernel phases")
    launches, _ = main_path_phase(None, N_FULL)  # None: the default device
    card_vs_cpu_phase()
    launches["costas_f32"], psk_wall, offline, psk_iq, psk_bits = psk_main_path_phase(
        None, B5_TIMED_N)
    stream_launches, rates = stream_main_path_phase(None, N_FULL)
    launches.update(stream_launches)
    stream_layers_phase("cuda", N_FULL)
    launches["costas_f32"] += psk_stream_phase(None, psk_iq, psk_bits, offline)
    stream_card_vs_cpu_phase()
    elapsed("the demodulation and stream paths")
    b7 = b7_phase("cuda")
    estimated = estimate_phase(None)  # None: the default device
    estimate_card_vs_cpu_phase()
    gate = gate_phase("cuda")
    elapsed("B7, the estimation path and the power gate")
    tx_rates = tx_phase(None)
    elapsed("TX")
    b8 = b8_phase("cuda")
    filtered = filter_range_phase(None, N_FULL)  # None: the default device
    iir = iir_phase(None, filtered["capture"])
    spectrum_walls = spectrum_phase(None, filtered["capture"])
    awre_walls = awre_phase("cuda")
    elapsed("B8, the filter, spectrum and plot paths and awre")
    live = live_phase(None, identity)  # None: the default device
    elapsed("the live loop")
    simulated = simulator_phase(None, identity)  # None: the default device
    elapsed("the simulator")
    rtl = rtl_tcp_phase(None, identity)
    elapsed("RTL-TCP")
    b9 = b9_phase("cuda", clock)
    sharding = sharding_phase(None, identity)  # None: the default device
    elapsed("B9 and the sharded and distributed paths")
    placed = placement_phase(identity)
    elapsed("placement")
    cli_ui = cli_and_ui_phase(None, identity)  # None: the default device
    elapsed("the CLI and the UI's model layer")
    served = web_phase(None, identity)  # None: the default device
    elapsed("the web app")
    idle = [k for k, v in served["launches"].items() if not v]
    if idle:
        raise AssertionError(f"web phase: {idle} never launched on the web routes")

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
            **({"cli_launches": cli_ui["launches"]["fsk_f32"],
                "undo_launches": cli_ui["undo_k1"],
                "web_launches": served["launches"]["fsk_f32"]} if key == "fsk_f32" else {}),
        })
    bound, bound_by = b5_bound_ms(B5_TIMED_N, clock)
    rows.append({
        "name": "costa_demod_scan", "route": "cuda", "source": B5_SOURCE,
        "replaces": B5_REPLACES, "launches": launches["costas_f32"],
        "live_launches": live["psk"]["launches"],
        "max_abs_err": b5["err"], "state_mismatches": b5["mismatch"],
        "ms": b5["ms"], "n": B5_TIMED_N, "plain_ms": b5["plain_ms"],
        "plain_n": B5_PLAIN_N, "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None,
    })
    for ingest, ingest_bytes in (("f32", 8), ("i8", 2)):
        key = f"stream_block_{ingest}"
        ms, plain_ms = b6["timings"][(ingest, N_FULL)]
        rows.append({
            "name": key, "route": "cuda", "source": B6_SOURCE, "replaces": B6_REPLACES,
            "launches": launches[key],
            **({"live_launches": live["fsk"]["launches"],
                "simulator_launches": simulated["launches"],
                "web_launches": served["launches"]["stream_block_f32"]} if ingest == "f32"
               else {"live_launches": rtl["launches"],
                     "cli_launches": cli_ui["launches"]["stream_block_i8"]}),
            "max_abs_err": b6["err"][ingest],
            "state_mismatches": b6["mismatch"][ingest], "ms": ms,
            "chunk_ms": b6["timings"][(ingest, STREAM_CHUNK)][0], "plain_ms": plain_ms,
            "bound_ms": b6_bytes(N_FULL, ingest_bytes) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None,
        })
    main_shape = B7_MAIN_SHAPES[0]
    bound, bound_by = b7_bound(main_shape, B7_K)
    large_bound, _ = b7_bound(B7_LARGE, B7_K)
    rows.append({
        "name": "median_filter_rows", "route": "cuda", "source": B7_SOURCE,
        "replaces": B7_REPLACES, "launches": estimated["launches"],
        "max_abs_err": b7["err"], "mismatching_words": b7["mismatch"],
        **b7["timings"][main_shape], "rows": main_shape[0], "width": main_shape[1],
        "k": B7_K, "bound_ms": bound, "bound_by": bound_by,
        "large_rows": B7_LARGE[0], "large_width": B7_LARGE[1],
        **{f"large_{key}": v for key, v in b7["timings"][B7_LARGE].items()},
        "large_bound_ms": large_bound, "outputs_a_thread": b7["variant"]["outputs"],
        "registers": b7["variant"]["registers"], "placement_launches": placed["b7_launches"],
        "cli_launches": cli_ui["launches"]["median_filter_f32"],
        "web_launches": served["launches"]["median_filter_f32"],
    })
    bound, bound_by = b8_bound_ms(B8_TIMED_N, b8["cycles"], clock)
    rows.append({
        "name": "iir_feedback", "route": "cuda", "source": B8_SOURCE, "replaces": B8_REPLACES,
        "launches": iir["launches"], "max_abs_err": b8["err"],
        "mismatching_words": b8["mismatch"], "ms": b8["ms"][B8_TIMED_TAPS], "n": B8_TIMED_N,
        "taps": B8_TIMED_TAPS, "ms_by_taps": b8["ms"], "plain_ms": b8["plain_ms"],
        "plain_n": B8_PLAIN_N, "bound_ms": bound, "bound_by": bound_by,
        "chain_cycles": b8["cycles"], "library_ms": None,
    })
    for name, ingest_bytes in (("float32", 8), ("int8", 2)):
        t = gate["timings"][name]
        rows.append({
            "name": f"power_gate_{name}", "route": "cuda", "source": GATE_SOURCE,
            "replaces": GATE_REPLACES, "launches": estimated["gate_launches"],
            "mismatching_words": 0, "ms": t["stats_ms"] + t["crossings_ms"], **t,
            "n": N_FULL, "plain_ms": t["stats_plain_ms"] + t["crossings_plain_ms"],
            # each pass reads the capture; the crossings' positions are written
            "bound_ms": (2 * ingest_bytes * N_FULL + 4 * gate["crossings"][name])
            / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None, "wall_s": gate["walls"][name][0],
            "host_wall_s": gate["walls"][name][1], "settled_rows": gate["settled"][name],
        })
    main_c, wide_c = B9_MAIN_CS
    rows.append({
        "name": "costa_demod_scan_batch", "route": "cuda", "source": B5_SOURCE,
        "replaces": B9_REPLACES, "launches": sharding["launches"]["costas_batch_f32"],
        "max_abs_err": b9["err"], "mismatching_words": b9["mismatch"],
        **b9["timings"][main_c], "streams": main_c, "plain_ms": b9["plain_ms"],
        "plain_streams": b9["plain_shape"][0], "plain_n": b9["plain_shape"][1],
        "library_ms": None, "resident_streams": b9["resident"],
        **{f"wide_{k}": v for k, v in b9["timings"][wide_c].items()}, "wide_streams": wide_c,
    })
    for row in rows:
        print(f"{row['name']}: {row['ms']:.4f} ms (bound {row['bound_ms']:.4f} ms, "
              f"{row['bound_by']}), plain {row['plain_ms']:.4f} ms, "
              f"launches {row['launches']}", flush=True)
    print(f"offline PSK wall at {B5_TIMED_N} samples: {psk_wall} s; stream samples/s "
          f"(pass 1, pass 2): float32 {rates[('float32', 1)]}, {rates[('float32', 2)]}; "
          f"int8 {rates[('int8', 1)]}, {rates[('int8', 2)]} ({N_FULL} samples in "
          f"{STREAM_CHUNK}-sample chunks) on {identity}, SM clock {clock / 1e6:.0f} MHz",
          flush=True)
    print("estimate() and auto_detect() walls (s): " + "; ".join(
        f"{label} {w[0]}, {w[1]}" for label, w in estimated["walls"].items())
        + f"; TX FSK float32 {tx_rates[('FSK', 1, 'float32')]} samples/s at {TX_BODY} "
        f"samples; filter_range {filtered['walls']}, iir_filter {iir['walls']}, "
        f"{spectrum_walls}, awre {awre_walls}; live FSK {live['fsk']['rate']} samples/s over "
        f"{live['fsk']['drains']} drains (sniffer.demodulate {live['fsk']['demod_rate']}), "
        f"card busy {live['busy']['share']:.4%}, TX buffer {live['tx']['rate']} samples/s, "
        f"continuous child's first block {live['continuous']['first_block']} s; simulator "
        f"round median {simulated['median']} s, max {simulated['max']} s; RTL-TCP int8 "
        f"{rtl['rate']} samples/s, the child connected in {rtl['connect_s']} s; sharding "
        f"{sharding['walls']}, the distributed child ({sharding['backend']}) "
        f"{sharding['child_wall']} s, block-parallel PSK messages exact "
        f"{sharding['relocked']}; placement {placement_summary(placed)}; CLI --estimate "
        f"{cli_ui['estimate']} s (as its own process {cli_ui['estimate_child']} s), -tx "
        f"{cli_ui['tx']['rate']} samples/s, -rx over RTL-TCP {cli_ui['rx']['drains']} drains, "
        f"the child connected in {cli_ui['rx']['connect_s']} s; undo stack (do, undo, "
        f"demodulate again, s) {cli_ui['undo']}; the phase {cli_ui['wall']} s; the web app "
        f"{served['wall']} s (the sniffer's live wall {served['sniffer_wall']} s, simulator "
        f"rounds {served['sim_walls']} s) on {identity}", flush=True)
    print(json.dumps({"kernels": rows}))
    print(identity)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
