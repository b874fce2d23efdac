"""Generate MegaDepth training pairs from D2-Net scene_info npz files.

    python -m patch2pix_tpu_torch.data.prep_megadepth_pairs \
        --base_dir data/MegaDepth_undistort --save_dir data_pairs/generated

The port's twin of the JAX package's ``tools/prep_megadepth_pairs.py``
(the same flags, the same output), on the port's host-side numpy
geometry, so a machine without JAX can build the pair lists that
``python -m patch2pix_tpu_torch.train.cli`` reads. Per scene: keep pairs
with overlap in [min_overlap, 1), landscape orientation and a croppable
aspect (bottom-right crop to --im_target_ratio), recover the relative
pose from the stored absolute poses (float64), compute
F = pose2fund(K1, K2, R, t) and reject the pair if the mean Sampson
distance of its COLMAP-track correspondences exceeds 1 px; cap at
--max_scene_pairs per scene (a seeded permutation picks the order) and
skip the excluded test scenes.

Output: {scene: {'ims': [...], 'pairs': [SimpleNamespace]}} npy with
the fields the dataset consumes (im1/im2/K1/K2/R/t/q/crop1/crop2/overlap).
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import numpy as np

from patch2pix_tpu_torch.data.colmap_model import qvec2rotmat, rotmat2qvec
from patch2pix_tpu_torch.data.preprocess import crop_from_bottom_right
from patch2pix_tpu_torch.evaluation.geometry import abs2relapose, pose2fund
from patch2pix_tpu_torch.evaluation.measure import sampson_distance

EXCLUDE = {
    "excl_test": ["0024", "0021", "0025", "1589", "0019", "0008", "0032", "0063"],
    "excl_all": [
        "0024", "0021", "0025", "1589", "0019", "0008", "0032", "0063",
        "0015", "0022",
    ],
    "": [],
}


def process_scene(scene_info: dict, args, rng) -> tuple:
    overlap = scene_info["overlap_matrix"]
    valid = np.logical_and(overlap >= args.min_overlap_ratio, overlap < 1)
    ids = np.vstack(np.where(valid))
    n_valid = ids.shape[1]

    image_paths = scene_info["image_paths"]
    p3d_to_2d = scene_info["points3D_id_to_2D"]
    intrinsics = scene_info["intrinsics"]
    poses = scene_info["poses"]

    order = rng.permutation(n_valid)
    imlist, pairs = {}, []
    for pidx in order:
        i1, i2 = int(ids[0, pidx]), int(ids[1, pidx])
        K1, K2 = intrinsics[i1], intrinsics[i2]
        w1, h1 = 2 * K1[:2, 2]
        w2, h2 = 2 * K2[:2, 2]
        # landscape-only pairs with croppable aspect
        if not (w1 >= h1 and w2 >= h2):
            continue
        crop1 = crop_from_bottom_right(w1, h1, args.im_target_ratio)
        crop2 = crop_from_bottom_right(w2, h2, args.im_target_ratio)
        if crop1 is None or crop2 is None:
            continue

        common = np.array(
            sorted(p3d_to_2d[i1].keys() & p3d_to_2d[i2].keys())
        )
        if len(common) == 0:
            continue
        matches = np.array(
            [[*p3d_to_2d[i1][p], *p3d_to_2d[i2][p]] for p in common]
        )

        # relative pose from absolute world->cam poses
        def cam(pose):
            R, t = pose[:3, :3], pose[:3, 3]
            return -R.T @ t, rotmat2qvec(R)

        c1, q1 = cam(poses[i1])
        c2, q2 = cam(poses[i2])
        t, q = abs2relapose(c1, c2, q1, q2)
        R = qvec2rotmat(q)

        # sampson sanity gate (<= 1 px mean) against the track matches
        F = pose2fund(K1, K2, R, t)
        d = sampson_distance(matches[:, :2], matches[:, 2:4], F)
        if np.mean(d) > 1.0:
            continue

        n1 = str(image_paths[i1]).replace("Undistorted_SfM/", "")
        n2 = str(image_paths[i2]).replace("Undistorted_SfM/", "")
        imlist.setdefault(n1, SimpleNamespace(name=n1, crop=crop1))
        imlist.setdefault(n2, SimpleNamespace(name=n2, crop=crop2))
        pairs.append(
            SimpleNamespace(
                im1=n1, im2=n2, overlap=float(overlap[i1, i2]),
                K1=K1, K2=K2, t=t, q=q, R=R, crop1=crop1, crop2=crop2,
            )
        )
        if len(pairs) >= args.max_scene_pairs:
            break
    return list(imlist.values()), pairs, n_valid


def main(argv=None) -> str:
    """Run the CLI; returns the path of the npy written."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--base_dir", default="data/MegaDepth_undistort")
    ap.add_argument("--save_dir", default="data_pairs/generated")
    ap.add_argument("--min_overlap_ratio", type=float, default=0.35)
    ap.add_argument("--im_target_ratio", type=float, default=1.5)
    ap.add_argument("--max_scene_pairs", type=int, default=500)
    ap.add_argument("--exclude_tag", default="excl_test",
                    choices=list(EXCLUDE.keys()))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    scene_dir = os.path.join(args.base_dir, "scene_info")
    os.makedirs(args.save_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)

    match_dict, total_valid, total_sel = {}, 0, 0
    for fname in sorted(os.listdir(scene_dir)):
        scene = fname.split(".")[0]
        if scene in EXCLUDE[args.exclude_tag]:
            print(f"skip excluded scene {scene}")
            continue
        try:
            info = dict(np.load(os.path.join(scene_dir, fname),
                                allow_pickle=True))
        except Exception as e:
            print(f"cannot open {fname}: {e}")
            continue
        ims, pairs, n_valid = process_scene(info, args, rng)
        total_valid += n_valid
        if pairs:
            match_dict[scene] = {"ims": ims, "pairs": pairs}
            total_sel += len(pairs)
        print(f"scene {scene}: ims={len(ims)} valid={n_valid} selected={len(pairs)}")

    tag = f".{args.exclude_tag}" if args.exclude_tag else ""
    name = (
        f"megadepth_pairs.ov{args.min_overlap_ratio}"
        f"_imrat{args.im_target_ratio}.pair{args.max_scene_pairs}{tag}.npy"
    )
    out = os.path.join(args.save_dir, name)
    np.save(out, match_dict)
    print(f"saved {out}: scenes={len(match_dict)} pairs={total_sel} "
          f"(of {total_valid} valid)")
    return out


if __name__ == "__main__":
    main()
