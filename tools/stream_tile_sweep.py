#!/usr/bin/env python3
"""Time the stream block kernel (B6) at other tile sizes, on a card.

    python3 tools/stream_tile_sweep.py     # from the repository root, one CUDA card

A one-off measurement behind the kernel's tile (``kUrhStreamThreads``,
``kUrhStreamF32Samples`` and ``kUrhStreamI8Samples`` in stream_block.cuh:
threads a block and the samples each owns); nothing in the package
depends on it.  Builds urh_tpu_torch/csrc/stream_block.cu once for each
tile of ``TILES`` (nvcc with the library's own flags, the
-DURH_STREAM_*_SWEEP macros, which nothing else passes, and -Xptxas -v,
all builds at once) into its own directory, points the wrappers at each
build in turn, prints what ptxas reports, checks both ingests of every
build against the plain version (bundles to the bit) around its tiles and
at a chunk, then times every build per 2^17-sample chunk and at 2^24
samples with chip_smoke.py's timer (CUDA events, L2 flushed), the builds
in turns over ``ROUNDS`` rounds.  Prints every run, the card's name and
power limit and, last, one JSON line of the medians.
"""

from __future__ import annotations

import ctypes
import json
import math
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
from urh_tpu_torch.dsp import stream_kernels as sk  # noqa: E402

# (threads a block, tiles an SM that urh_stream_groups aims at)
TILES = ((256, 2), (256, 4), (256, 8), (256, 16), (256, 32), (512, 8), (1024, 8))
ROUNDS = 5


def tile_name(tile) -> str:
    return "threads={} tiles/SM={}".format(*tile)


def build_all() -> dict:
    """tile -> (ctypes library, ptxas report), every nvcc started at once."""
    out_dir = os.path.join(_build.BUILD_DIR, "tile_sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for tile in TILES:
        path = os.path.join(out_dir, "libstream_block_{}_{}.so".format(*tile))
        cmd = [_build._nvcc(), *_build.FLAGS, f"-DURH_STREAM_THREADS_SWEEP={tile[0]}",
               f"-DURH_STREAM_TILES_PER_SM_SWEEP={tile[1]}",
               "-Xptxas", "-v", "-o", path, os.path.join(_build._SRC_DIR, "stream_block.cu")]
        procs[tile] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tile, (path, proc) in procs.items():
        report = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tile_name(tile)}:\n{report}")
        lib = ctypes.CDLL(path)
        for name, argtypes in _build._STREAM_SIGNATURES.items():
            if name.startswith("urh_stream"):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        fn = getattr(lib, _build._WORK_WORDS[0])
        fn.argtypes, fn.restype = _build._WORK_WORDS[1], ctypes.c_int64
        libs[tile] = (lib, report)
    return libs


def check(tile) -> int:
    """Bundle and state mismatches of both ingests against the plain
    version around this build's tiles and at a chunk."""
    bad = 0
    sizes = {n for per in (4, 16) for n in (per * tile[0] - 1, per * tile[0] + 1,
                                            2 * per * tile[0] + 1)}
    for n in sorted(sizes) + [cs.STREAM_CHUNK + 1]:
        xf_np, xi_np = cs.b6_inputs(n)
        xf, xi = torch.from_numpy(xf_np).cuda(), torch.from_numpy(xi_np).cuda()
        for halo in (False, True):
            for _, x, args in cs.b6_calls(xf, xi, halo):
                bad += cs.b6_compare(cs.b6_run(x, args), sk.stream_block_plain(x, *args))[1]
    return bad


def main():
    if not torch.cuda.is_available():
        raise SystemExit("stream_tile_sweep.py needs a CUDA card; none is available")
    libs = build_all()
    for tile, (_, report) in libs.items():
        print(f"--- ptxas, {tile_name(tile)}\n{report.strip()}", flush=True)
    mismatches = {}
    for tile, (lib, _) in libs.items():
        _build._lib = lib  # the wrappers launch this build's kernels
        mismatches[tile_name(tile)] = check(tile)
    print(f"mismatches by tile: {mismatches}", flush=True)
    if any(mismatches.values()):
        raise AssertionError("a build of the stream block disagrees with its plain version")

    xf_np, xi_np = cs.b6_inputs(cs.N_FULL)
    thr = torch.zeros(1, dtype=torch.float32, device="cuda")
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    inputs = {(ingest, n): torch.from_numpy(x_np[:n]).cuda()
              for ingest, x_np in (("f32", xf_np), ("i8", xi_np))
              for n in (cs.STREAM_CHUNK, cs.N_FULL)}
    times = {}
    for r in range(ROUNDS):
        order = TILES[r % len(TILES):] + TILES[:r % len(TILES)]
        for tile in order:
            _build._lib = libs[tile][0]
            for (ingest, n), x in inputs.items():
                args = (float(np.float32(cs.B6_NOISE ** 2)), float(np.float32(math.sqrt(2.0))),
                        thr, "FSK", True, n // 4 + 8, 2)
                times.setdefault(f"{ingest} {tile_name(tile)} n={n}", []).append(
                    cs.time_ms(lambda x=x, a=args: sk.stream_block(x, *a), flush))
    medians = {k: statistics.median(v) for k, v in times.items()}
    for k, ms in medians.items():
        ingest, n = k.split()[0], int(k.rsplit("=", 1)[1])
        bound = cs.b6_bytes(n, 8 if ingest == "f32" else 2) / cs.HBM_BYTES_PER_S * 1e3
        print(f"{k}: {ms} ms, {bound / ms:.1%} of the {bound} ms bound (runs {times[k]})",
              flush=True)
    print(cs.card_identity())
    print(json.dumps({"median_ms": medians}))


if __name__ == "__main__":
    main()
