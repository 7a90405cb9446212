#!/usr/bin/env python3
"""Where the stream block kernel (B6) spends a tile's life, on a card.

    python3 tools/stream_block_timeline.py     # from the repository root, one CUDA card

A one-off measurement; nothing in the package depends on it.  Builds a
copy of urh_tpu_torch/csrc/stream_block.cu with %globaltimer stamps that
thread 0 of each tile writes at its start (before the ticket), once it
holds its ticket and has issued its copies, once the copies have landed,
once the tile is decided, after the look-back, and at its end (build/
stream_timeline/, nvcc with the library's own flags), with the look-back
counting its rounds (each reads 32 * kLookBack predecessors), its spins
(re-reads of a predecessor that had published nothing yet) and the
distance of the inclusive prefix it found, and points the wrappers at
it.  For binary FSK at 0 (the stream's configuration) on
chip_smoke.py's captures, per 2^17-sample chunk and at 2^24 samples, both
ingests, it prints the CUDA-event time (chip_smoke.py's timer, L2
flushed), the kernel's span from the first tile's start to the last
tile's end, the median and 90th percentile of each phase and the most
tiles one SM ran.  Then, with the same timer, the floor the events put
under any launch: a one-element add, and a zero fill of a chunk's bundle
(131 KB) and of a 2^24-sample block's (16 MB).  Last, the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import math
import os
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

PHASES = ("ticket", "staged", "decided", "looked back", "ended")
MAX_TILES = 1 << 16


def _stamp(k: int) -> str:
    return ("    if (tid == 0) { unsigned long long g; asm volatile(\"mov.u64 %0, %%globaltimer;\""
            f" : \"=l\"(g)); g_stamps[t * 8 + {k}] = g; }}\n")


def stamped_source() -> str:
    """stream_block.cu with the stamps, each placed after a line of it."""
    src = open(os.path.join(_build._SRC_DIR, "stream_block.cu")).read()
    src = src.replace("namespace {\n", "__device__ unsigned long long* g_stamps;\nnamespace {\n", 1)
    marks = [
        ("    if (tid == 0) s_tile = atomicAdd(w.ticket, 1u);\n",
         "    unsigned long long g0; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g0));\n",
         True),
        ("    stage_tile(base, t, p, stage);\n",
         "    if (tid == 0) { g_stamps[t * 8] = g0; unsigned sm; asm(\"mov.u32 %0, %%smid;\" : "
         "\"=r\"(sm)); g_stamps[t * 8 + 7] = sm; }\n" + _stamp(1), False),
        ("    __pipeline_wait_prior(0);\n    __syncthreads();\n", _stamp(2), False),
        ("    if (tid > 0) before = s_tail[tid - 1];\n", _stamp(3), False),
        ("    const UrhRunAgg prefix = s_prefix, total = s_total;\n", _stamp(4), False),
        ("                       p.state_bits, out);\n}\n", None, False),
        ("    UrhRunAgg prefix = urh_run_agg_identity();\n    for (int64_t end = t;; end -= 32 * kLookBack) {\n",
         "    unsigned long long rounds = 0, spins = 0;\n", True),
        ("        while (__any_sync(0xffffffffu, pending)) {\n", "            ++spins;\n", False),
        ("        if (nearest < 32 * kLookBack) return prefix;\n",
         "        ++rounds;\n        if (nearest < 32 * kLookBack && lane == 0)\n"
         "            g_stamps[t * 8 + 6] = rounds << 40 | spins << 20 | (unsigned)nearest;\n", True),
    ]
    for line, text, before in marks:
        if src.count(line) < 1:
            raise RuntimeError(f"stream_block.cu no longer has the line {line!r}")
        if text is None:  # the kernel's last statement: stamp before its closing brace
            src = src.replace(line, line[:-2] + _stamp(5) + "}\n", 1)
        else:
            src = src.replace(line, text + line if before else line + text, 1)
    return src.replace("extern \"C\" {\n", "extern \"C\" {\nint stamps_set(unsigned long long* p) "
                       "{ return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof p); }\n", 1)


def build() -> ctypes.CDLL:
    out_dir = os.path.join(_build.BUILD_DIR, "stream_timeline")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "stream_block_stamped.cu")
    with open(src, "w") as f:
        f.write(stamped_source())
    path = os.path.join(out_dir, "libstream_block_stamped.so")
    subprocess.run([_build._nvcc(), *_build.FLAGS, "-I", _build._SRC_DIR, "-o", path, src],
                   check=True, timeout=600)
    lib = ctypes.CDLL(path)
    for name, argtypes in _build._STREAM_SIGNATURES.items():
        if name.startswith("urh_stream"):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    fn = getattr(lib, _build._WORK_WORDS[0])
    fn.argtypes, fn.restype = _build._WORK_WORDS[1], ctypes.c_int64
    return lib


def summary(stamps: np.ndarray) -> str:
    raw = stamps[stamps[:, 0] > 0]
    d = raw.astype(np.float64)
    rel = (d[:, :6] - d[:, 0].min()) / 1e3  # us from the first tile's start
    lines = [f"tiles {len(d)}, kernel span {rel[:, 5].max()} us, most tiles an SM "
             f"{np.bincount(d[:, 7].astype(int)).max()}"]
    for k, name in enumerate(PHASES, 1):
        dur = rel[:, k] - rel[:, k - 1]
        lines.append(f"  {name}: median {np.median(dur)} us, p90 {np.percentile(dur, 90)} us")
    life = rel[:, 5] - rel[:, 0]
    lines.append(f"  a tile's life: median {np.median(life)} us, p90 {np.percentile(life, 90)} us")
    lb = raw[:, 6][raw[:, 6] > 0]  # tiles that looked back
    if len(lb):
        rounds, spins, near = lb >> 40, (lb >> 20) & 0xFFFFF, lb & 0xFFFFF
        lines.append(f"  look-back: rounds median {np.median(rounds)} max {rounds.max()}, spins "
                     f"median {np.median(spins)} p90 {np.percentile(spins, 90)}, inclusive "
                     f"prefix at distance median {np.median((rounds - 1) * 128 + near + 1)}")
        # (128 predecessors a round: 32 lanes x kLookBack 4)
    return "\n".join(lines)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("stream_block_timeline.py needs a CUDA card; none is available")
    lib = build()
    stamps = torch.zeros(8 * MAX_TILES, dtype=torch.int64, device="cuda")
    if lib.stamps_set(ctypes.c_void_p(stamps.data_ptr())):
        raise RuntimeError("cudaMemcpyToSymbol failed")
    _build._lib = lib  # the wrappers launch the stamped kernels
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    thr = torch.zeros(1, dtype=torch.float32, device="cuda")
    xf_np, xi_np = cs.b6_inputs(cs.N_FULL)
    for n in (cs.STREAM_CHUNK, cs.N_FULL):
        for ingest, x_np in (("f32", xf_np), ("i8", xi_np)):
            x = torch.from_numpy(x_np[:n]).cuda()
            args = (float(np.float32(cs.B6_NOISE ** 2)), float(np.float32(math.sqrt(2.0))), thr,
                    "FSK", True, n // 4 + 8, 2)
            if not torch.equal(sk.stream_block(x, *args), sk.stream_block_plain(x, *args)[0]):
                raise AssertionError(f"the stamped kernel disagrees at {ingest} n={n}")
            ms = cs.time_ms(lambda: sk.stream_block(x, *args), flush)
            stamps.zero_()
            flush.zero_()
            sk.stream_block(x, *args)
            torch.cuda.synchronize()
            print(f"{ingest} n={n}: event {ms * 1e3} us, "
                  + summary(stamps.view(-1, 8).cpu().numpy()), flush=True)
    one = torch.zeros(1, device="cuda")
    floors = {"one-element add": lambda: one.add_(1.0)}
    for label, words in (("zero fill 131 KB", (1 << 17) // 4 + 10),
                         ("zero fill 16 MB", (1 << 24) // 4 + 10)):
        buf = torch.empty(words, dtype=torch.int32, device="cuda")
        floors[label] = lambda b=buf: b.zero_()
    for label, fn in floors.items():
        print(f"{label}: event {cs.time_ms(fn, flush) * 1e3} us", flush=True)
    print(cs.card_identity())


if __name__ == "__main__":
    main()
