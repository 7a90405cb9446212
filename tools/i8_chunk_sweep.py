#!/usr/bin/env python3
"""Time the int8 demod kernels at other samples per thread, on a card.

    python3 tools/i8_chunk_sweep.py        # from the repository root, one CUDA card

A one-off measurement behind the kernels' 16 samples per thread
(``kUrhI8Chunk`` in fused_demod.cuh); nothing in the package depends on
it.  Builds urh_tpu_torch/csrc/fused_demod.cu once for each chunk of
``CHUNKS`` (nvcc with the library's own flags, -DURH_I8_CHUNK_SWEEP, which
nothing else passes, and -Xptxas -v, all builds at once) into its own
directory, points the wrappers at each build in turn, prints what ptxas
reports for each kernel, checks
K2 (urh_fsk_i8) and K4 (urh_ask_i8) of every build against their plain
PyTorch versions at lengths around the chunk (0 state mismatches), then
times both kernels of every build at 2^24 and 2^26 samples with
chip_smoke.py's timer (CUDA events, L2 flushed), the builds in turns over
``ROUNDS`` rounds.  Prints every run, the card's name and power limit
and, last, one JSON line of the medians.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from urh_tpu_torch import _build  # noqa: E402

CHUNKS = (16, 32)
ROUNDS = 5
SIZES = (cs.N_FULL, cs.N_STREAM)


def build_all() -> dict:
    """chunk -> (ctypes library, ptxas report), every nvcc started at once."""
    out_dir = os.path.join(_build.BUILD_DIR, "chunk_sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for chunk in CHUNKS:
        path = os.path.join(out_dir, f"libfused_demod_chunk{chunk}.so")
        cmd = [_build._nvcc(), *_build.FLAGS, f"-DURH_I8_CHUNK_SWEEP={chunk}", "-Xptxas", "-v",
               "-o", path, os.path.join(_build._SRC_DIR, "fused_demod.cu")]
        procs[chunk] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
    libs = {}
    for chunk, (path, proc) in procs.items():
        report = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for chunk {chunk}:\n{report}")
        lib = ctypes.CDLL(path)
        for name, argtypes in _build._SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        libs[chunk] = (lib, report)
    return libs


def check(chunk: int) -> int:
    """State mismatches of K2 and K4 against their plain versions at
    lengths around the chunk, with the library of this chunk loaded."""
    _, i8 = cs.kernel_inputs(cs.N_FULL + 17, seed=3)
    noise_sqrd = float(np.float32(cs.I8_FSK["noise"] ** 2))
    bad = 0
    for n in (1, 2, chunk - 1, chunk, chunk + 1, 1000, 32 * chunk + 5, cs.N_FULL + 17):
        x = torch.from_numpy(i8[:n]).cuda()
        for kernel, plain, args in cs.i8_calls(x, noise_sqrd).values():
            got = kernel(*args)
            torch.cuda.synchronize()
            bad += cs.compare(got, plain(*args))[1]
    return bad


def main():
    if not torch.cuda.is_available():
        raise SystemExit("i8_chunk_sweep.py needs a CUDA card; none is available")
    libs = build_all()
    for chunk, (_, report) in libs.items():
        print(f"--- ptxas, URH_I8_CHUNK_SWEEP={chunk}\n{report.strip()}", flush=True)
    mismatches = {}
    for chunk, (lib, _) in libs.items():
        _build._lib = lib  # the wrappers launch this build's kernels
        mismatches[chunk] = check(chunk)
    print(f"state mismatches by chunk: {mismatches}", flush=True)
    if any(mismatches.values()):
        raise AssertionError("a chunked int8 kernel disagrees with its plain version")

    _, i8 = cs.kernel_inputs(cs.N_FULL, seed=3)
    x_full = torch.from_numpy(i8).cuda()
    inputs = {n: x_full.repeat(n // cs.N_FULL, 1) for n in SIZES}
    noise_sqrd = float(np.float32(cs.I8_FSK["noise"] ** 2))
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    times = {}
    for r in range(ROUNDS):
        order = CHUNKS[r % len(CHUNKS):] + CHUNKS[:r % len(CHUNKS)]
        for chunk in order:
            _build._lib = libs[chunk][0]
            for n, x in inputs.items():
                for key, (kernel, _, args) in cs.i8_calls(x, noise_sqrd).items():
                    times.setdefault(f"{key} chunk={chunk} n={n}", []).append(
                        cs.time_ms(lambda f=kernel, a=args: f(*a), flush))
    medians = {k: statistics.median(v) for k, v in times.items()}
    for k, ms in medians.items():
        n = int(k.rsplit("=", 1)[1])
        bound = cs.KERNELS["fsk_i8"]["bytes_per_sample"] * n / cs.HBM_BYTES_PER_S * 1e3
        print(f"{k}: {ms} ms, {bound / ms:.1%} of the {bound} ms bound "
              f"(runs {times[k]})", flush=True)
    print(cs.card_identity())
    print(json.dumps({"median_ms": medians}))


if __name__ == "__main__":
    main()
