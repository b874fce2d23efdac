"""Readings that set a cell's limits: the program's compared numbers on
many seeds, and the control's (the plain reference computed in float8
e4m3, operands and stored volumes alike, one precision below the
configurations' bfloat16, in the program's place)
on the same calls of other seeds.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 3 \
        --control-seeds 4 5 6

Each seed sets the cell up anew (weights, inputs, warm-up) in this one
process and judges the cell's ``check_calls`` first calls, as many as a
run judges. Prints one JSON line per seed and side, then the largest
program reading and the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Iterable, List

import torch

from benchmark import harness


def readings(cell: harness.Cell, seeds: Iterable[int], side: str, device) -> List[Dict]:
    """[{seed, side, numbers}] for ``side`` 'program', 'control' (the
    reference in float8) or 'bfloat16' (the reference with bfloat16
    operands: how far rounding alone reads)."""
    out = []
    for seed in seeds:
        drv = cell.driver(seed, device)
        drv.setup()
        out.append({"seed": seed, "side": side, "numbers": drv.reading(side)})
        del drv
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def summary(rows: List[Dict]) -> Dict[str, Dict[str, float]]:
    """Per number: the program's largest reading (``lower``) and the
    control's smallest (``upper``)."""
    res: Dict[str, Dict[str, float]] = {}
    for r in rows:
        for name, v in r["numbers"].items():
            d = res.setdefault(name, {})
            if r["side"] == "program":
                d["lower"] = max(d.get("lower", 0.0), v)
            elif r["side"] == "control":
                d["upper"] = min(d.get("upper", float("inf")), v)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--bfloat16-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload)
    rows = []
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds),
                        ("bfloat16", args.bfloat16_seeds)):
        t0 = time.perf_counter()
        got = readings(cell, seeds, side, "cuda:0")
        for r in got:
            print(json.dumps(r), flush=True)
        print(f"{side}: {len(seeds)} seeds in {time.perf_counter() - t0:.1f} s", flush=True)
        rows += got
    print(json.dumps({"workload": args.workload, "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
