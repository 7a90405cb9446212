"""The readings that a cell's limits are set from, on the card, in one process.

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds <s>

For each seed, the cell runs as a benchmark run does (inputs from the seed,
set-up, a window of ``--seconds``, the program's state freed) and prints the
numbers its check compares: the program's readings, whose largest over the
seeds is a limit's lower reading.  On the control seeds it also prints the
control's numbers: the plain reference one precision below the
configuration's samples, put in the program's place and judged as the
program is; their smallest is a limit's upper reading.  Each seed's line is
JSON, and the last line sums them up.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from benchmark import registry


def readings(check: dict) -> dict:
    return {k: v for k, (v, _) in check["numbers"].items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    bench = registry.benchmark()
    wl = registry.workload(bench, args.workload)
    cfg = registry.config(bench, wl["config"])
    traffic = registry.traffic(wl["traffic"])
    limits = registry.limits(wl["name"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    program, control = [], []
    for seed in seeds:
        cell = registry.driver(traffic["driver"]).Cell(cfg, traffic, seed, "cuda", args.seconds)
        try:
            cell.setup()
            result = cell.window(args.seconds, None)
            cell.release()
            t = time.perf_counter()
            check = cell.check(limits)
            ref_s = time.perf_counter() - t
            row = {"seed": seed, "program": readings(check), "correct": check["correct"],
                   "attempted": check["attempted"], "failed": check["failed"],
                   "e2e": {**result["e2e"], **check.get("e2e", {})},
                   "notes": check.get("notes", {}), "reference_s": ref_s}
            program.append(row["program"])
            if seed in controls:
                row["control"] = readings(cell.control(limits))
                control.append(row["control"])
        finally:
            cell.close()
        print(json.dumps(row), flush=True)
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"workload": wl["name"], "seeds": len(program),
               "lower": {k: max(r[k] for r in program) for k in limits},
               "upper": {k: min(r[k] for r in control) for k in limits} if control else None}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
