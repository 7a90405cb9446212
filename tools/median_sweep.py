#!/usr/bin/env python3
"""Time the median filter's window kernel (B7) in other shapes, on a card.

    python3 tools/median_sweep.py [--baseline DIR]   # from the repository root, one CUDA card

A one-off measurement behind the window kernel's shape (``kUrhMedianT``
and ``kUrhMedianThreads`` in median_filter.cuh); nothing in the package
depends on it.  Builds urh_tpu_torch/csrc/median_filter.cu once for each
entry of ``VARIANTS`` (nvcc with the library's own flags,
-DURH_MEDIAN_T_SWEEP and -DURH_MEDIAN_THREADS_SWEEP, which nothing else
passes, and -Xptxas -v), and with ``--baseline`` the
median_filter.cu of DIR as it stands (an earlier version of the kernel
beside its header, as ``git archive`` unpacks it), all builds at once,
each into its own library.  Points the wrapper at each build in turn,
prints what ptxas reports for its k = 11 kernel (and with ``--sass`` its
machine instructions by opcode), checks every build against the plain
PyTorch version to the bit (k = 11 and 16, W = 1, 10, T - 1, T, T + 1, a
block's tile and one either side, 1000 and 16,368, on
chip_smoke.py's rows with ties, +-0, +-inf and NaN), then times every build
at the main path's bucket (2 x 100 rows of 16,368, k = 11) and at 2^25
cells with chip_smoke.py's timer (CUDA events, L2 flushed), the builds in
turns over ``ROUNDS`` rounds.  Prints every run, the card's name and power
limit and, last, one JSON line of the medians.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from urh_tpu_torch import _build  # noqa: E402
from urh_tpu_torch.ai import median_kernels as mk  # noqa: E402

# name -> (outputs a thread, threads a block)
VARIANTS = {**{f"T={t}": (t, 128) for t in (2, 3, 4, 5, 6, 8)},
            **{f"T=5 threads={n}": (5, n) for n in (64, 256)}}
ROUNDS = 5
SHAPES = (cs.B7_MAIN_SHAPES[0], cs.B7_LARGE)
_NAMES = ("urh_median_filter_f32", "urh_median_filter_variant")


def build_all(baseline: str | None) -> dict:
    """name -> (ctypes library, ptxas report of its k = 11 and rank-count
    kernels, (outputs a run, outputs a block), library path), every nvcc
    started at once."""
    out_dir = os.path.join(_build.BUILD_DIR, "median_sweep")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(_build._SRC_DIR, "median_filter.cu")
    jobs = {name: ([f"-DURH_MEDIAN_T_SWEEP={t}", f"-DURH_MEDIAN_THREADS_SWEEP={threads}"],
                   src, (t, t * threads))
            for name, (t, threads) in VARIANTS.items()}
    if baseline:  # one output a thread, 256 a block
        jobs["baseline"] = ([], os.path.join(baseline, "median_filter.cu"), (1, 256))
    procs = {}
    for i, (name, (defs, path, shape)) in enumerate(jobs.items()):
        lib_path = os.path.join(out_dir, f"libmedian_{i}.so")
        cmd = [_build._nvcc(), *_build.FLAGS, *defs, "-Xptxas", "-v", "-o", lib_path, path]
        procs[name] = (lib_path, shape, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                         stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib_path, shape, proc) in procs.items():
        report = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        lib = ctypes.CDLL(lib_path)
        for fn in _NAMES:
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = _build._STREAM_SIGNATURES[fn]
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, k11_report(report), shape, lib_path)
    return libs


def k11_report(report: str) -> str:
    """ptxas's lines for the k = 11 window kernel and the rank count."""
    blocks = report.split("ptxas info    : Compiling entry function")
    keep = [b for b in blocks[1:] if "kernelILi11E" in b or "median_kernelILb1E" in b
            or "median_rank_kernelILb1E" in b]
    return "\n".join("Compiling entry function" + b.rstrip() for b in keep)


def sass_counts(lib_path: str, out_path: str) -> dict:
    """Instructions of the k = 11 window kernel in the build's machine code
    (cuobjdump -sass), by opcode: the staging, the straight-line
    full-window path, the row end's loop and the copy out.  Writes that
    kernel's machine code to out_path."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    counts, inside, lines = {}, False, []
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "kernelILi11E" in line
        if not inside:
            continue
        lines.append(line)
        if "/*" in line and ";" in line:
            words = line.split("*/", 1)[1].split(";")[0].split()
            if words:
                op = words[1] if words[0].startswith("@") and len(words) > 1 else words[0]
                counts[op.split(".")[0]] = counts.get(op.split(".")[0], 0) + 1
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return counts


def check(t: int, tile: int) -> int:
    """Mismatching words against the plain version, the wrapper pointed at
    one build of t outputs a run and tile outputs a block."""
    bad = 0
    for k in (11, 16):
        for w in sorted({1, 10, t - 1, t, t + 1, tile - 1, tile, tile + 1, 1000, 16368} - {0}):
            rows = torch.from_numpy(cs.b7_rows(3, w, seed=k * 7919 + w, nan=w > 2)).cuda()
            got = mk.median_filter(rows, k)
            torch.cuda.synchronize()
            bad += cs.b7_compare(got, mk.median_filter_plain(rows, k))[1]
    return bad


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", help="directory of an earlier median_filter.cu and .cuh")
    parser.add_argument("--sass", metavar="DIR",
                        help="count the k = 11 kernel's machine instructions by opcode and "
                             "write its machine code into DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("median_sweep.py needs a CUDA card; none is available")
    libs = build_all(args.baseline)
    mismatches = {}
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
    for i, (name, (lib, report, shape, lib_path)) in enumerate(libs.items()):
        _build._lib = lib  # the wrapper launches this build's kernels
        variant = mk.kernel_variant(11) if hasattr(lib, _NAMES[1]) else "rank count"
        print(f"--- {name}: k=11 takes {variant}\n{report}", flush=True)
        if args.sass:
            counts = sass_counts(lib_path, os.path.join(args.sass, f"median_k11_{i}.sass"))
            print(f"SASS of the k=11 kernel: {sum(counts.values())} instructions, {counts}",
                  flush=True)
        mismatches[name] = check(*shape)
    print(f"mismatching words by build: {mismatches}", flush=True)
    if any(mismatches.values()):
        raise AssertionError("a build of the median filter disagrees with its plain version")

    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    rng = torch.Generator().manual_seed(1)
    inputs = {shape: torch.randn(shape, generator=rng).abs().cuda() for shape in SHAPES}
    names = list(libs)
    times = {}
    for r in range(ROUNDS):
        for name in names[r % len(names):] + names[:r % len(names)]:
            _build._lib = libs[name][0]
            for shape, rows in inputs.items():
                times.setdefault(f"{name} {shape[0]}x{shape[1]}", []).append(
                    cs.time_ms(lambda x=rows: mk.median_filter(x, cs.B7_K), flush))
    medians = {key: statistics.median(v) for key, v in times.items()}
    for key, ms in medians.items():
        rows, w = map(int, key.rsplit(" ", 1)[1].split("x"))
        bound, by = cs.b7_bound((rows, w), cs.B7_K)
        print(f"{key}: {ms} ms, {bound / ms:.1%} of the {bound} ms bound ({by}) "
              f"(runs {times[key]})", flush=True)
    print(cs.card_identity())
    print(json.dumps({"median_ms": medians}))


if __name__ == "__main__":
    main()
