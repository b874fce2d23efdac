"""Run one cell of the benchmark of ``patch2pix_tpu_torch`` on CUDA cards.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell (kernels built into ``build/kernels`` inside the
checkout, seeded weights and inputs made on the card, the cell's shapes
warmed up), measures for ``--seconds``, judges a seeded sample of the
window's outputs against the plain reference, and prints one JSON line
last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s``), with ``--trace 1`` ``breakdown``, and last ``checks``:
each compared number beside its limit, which also close standard error.
Exits non-zero without a result where CUDA or the cell's cards are
missing, or where JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "patch2pix_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # every cache of the program stays inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    if not (ROOT / "patch2pix_tpu_torch").is_dir():
        print("benchmark: the package patch2pix_tpu_torch is not in this checkout",
              file=sys.stderr)
        return 2
    import torch

    from benchmark import harness

    cell = harness.Cell(args.workload, ROOT)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                              T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        if not math.isfinite(c["value"]):  # JSON has no infinity
            c["value"] = sys.float_info.max
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
