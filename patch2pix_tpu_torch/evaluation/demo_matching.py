"""Match image pairs and save their visualisations.

    python -m patch2pix_tpu_torch.evaluation.demo_matching --pairs DIR --out OUT \\
        [--ckpt patch2pix_pretrained.pth | RUN_DIR] [--method patch2pix|nc]

The port's twin of the JAX package's ``examples/demo_matching.py`` (the
same flags): every ``pair_*/`` subdirectory of ``--pairs`` holding two
images is matched and plotted to ``{out}/{pair}.png``. With ``--ckpt``
(a reference ``.pth`` or a training run directory) the matcher comes from
``init_patch2pix_matcher`` or, with ``--method nc``, ``init_ncn_matcher``;
without it, from a fresh bf16 Patch2Pix of the port's initialisers drawn
from a generator seeded with ``--seed`` (random weights: the pipeline
runs, the matches mean nothing). Runs on CUDA unless ``--device`` names
another device. ``--no_plot`` matches without drawing (the plots need
matplotlib).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from patch2pix_tpu_torch.config import ModelConfig
from patch2pix_tpu_torch.data.preprocess import load_image
from patch2pix_tpu_torch.evaluation.matcher import (
    Matcher,
    init_ncn_matcher,
    init_patch2pix_matcher,
)
from patch2pix_tpu_torch.models.patch2pix import seeded_patch2pix

IMAGE_SUFFIXES = (".jpg", ".png", ".jpeg", ".ppm")


def build_matcher(args) -> Matcher:
    if args.ckpt:
        if args.method == "nc":
            return init_ncn_matcher(args.ckpt, imsize=args.imsize, device=args.device)
        return init_patch2pix_matcher(args.ckpt, io_thres=args.io_thres, imsize=args.imsize,
                                      device=args.device)
    print("NOTE: no --ckpt given; matching with RANDOM weights")
    model = seeded_patch2pix(ModelConfig(dtype="bfloat16").resolved(), args.seed, args.device)
    return Matcher(model, io_thres=args.io_thres, imsize=args.imsize, device=args.device)


def pair_paths(pairs_dir: str):
    """(name, image 1, image 2) of every subdirectory holding two images
    or more (the first two by name), in name order."""
    out = []
    for pair_dir in sorted(os.listdir(pairs_dir)):
        full = os.path.join(pairs_dir, pair_dir)
        if not os.path.isdir(full):
            continue
        ims = sorted(f for f in os.listdir(full) if f.lower().endswith(IMAGE_SUFFIXES))
        if len(ims) >= 2:
            out.append((pair_dir, os.path.join(full, ims[0]), os.path.join(full, ims[1])))
    return out


def main(argv=None):
    """Run the demo; returns ``[(pair, matches, seconds), ...]``, the
    seconds of ``estimate_matches`` (decode, resize, matching)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--method", choices=["patch2pix", "nc"], default="patch2pix")
    ap.add_argument("--pairs", required=True,
                    help="directory of pair_*/ subdirs each holding two images")
    ap.add_argument("--out", default="output/demo_matches")
    ap.add_argument("--imsize", type=int, default=1024)
    ap.add_argument("--io_thres", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0, help="the random weights' seed")
    ap.add_argument("--device", default=None, help="cuda unless given (e.g. cpu)")
    ap.add_argument("--no_plot", action="store_true", help="match without drawing")
    args = ap.parse_args(argv)

    matcher = build_matcher(args)
    if args.no_plot:
        print("plots skipped (--no_plot)")
    else:
        from patch2pix_tpu_torch.utils.plotting import plot_matches

        os.makedirs(args.out, exist_ok=True)
    done = []
    for name, p1, p2 in pair_paths(args.pairs):
        t0 = time.perf_counter()
        matches, scores, _ = matcher.estimate_matches(p1, p2)
        secs = time.perf_counter() - t0
        line = f"{name}: {len(matches)} matches in {secs:.3f} s"
        if not args.no_plot:
            out_path = os.path.join(args.out, f"{name}.png")
            plot_matches(np.asarray(load_image(p1), np.float64) / 255.0,
                         np.asarray(load_image(p2), np.float64) / 255.0,
                         matches, scores, save_path=out_path)
            line += f" -> {out_path}"
        print(line)
        done.append((name, len(matches), secs))
    return done


if __name__ == "__main__":
    main()
