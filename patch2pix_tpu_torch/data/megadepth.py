"""MegaDepth training-pair dataset (host side, numpy + PIL).

Port of ``patch2pix_tpu.data.megadepth``: pairs from a precomputed npy
(``{scene: {"ims": [...], "pairs": [...]}}``, each pair with ``im1``,
``im2``, ``K1``, ``K2``, ``R``, ``t`` and optional ``crop1``/``crop2``),
bottom-right aspect crops, a fixed (wt, ht) bicubic resize, intrinsics
rescaled for it and F = pose2fund cached per pair, an optional
cross-scene negative image per pair (triplets). :func:`batch_iterator`
stacks fixed-shape numpy batches (images ``(B, ht, wt, 3)`` float32 HWC,
ImageNet-normalised; ``F``, ``K1``, ``K2`` ``(B, 3, 3)``), decoding in a
thread pool; ``data/prefetch.py`` moves them onto the device.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from patch2pix_tpu_torch.data.preprocess import load_image, scale_intrinsic, to_array


def _skew(v) -> np.ndarray:
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=np.float64)


def _pose2fund_np(K1, K2, R, t):
    """F from intrinsics and the relative pose (x2^T F x1 = 0)."""
    t = np.asarray(t).reshape(3)
    return np.linalg.inv(K2).T @ R @ K1.T @ _skew((K1 @ R.T) @ t)


class MegaDepthPairDataset:
    """Map-style dataset over precomputed MegaDepth match pairs."""

    def __init__(self, data_root: str, match_file: str,
                 scene_list: Optional[Sequence[str]] = None, wt: int = 480, ht: int = 320,
                 dataset_dir: str = "MegaDepth_undistort", triplet: bool = False,
                 seed: int = 0):
        self.data_root = os.path.join(data_root, dataset_dir)
        self.match_file = match_file
        self.wt, self.ht = wt, ht
        match_dict = np.load(match_file, allow_pickle=True).item()
        self.scenes = list(scene_list) if scene_list else list(match_dict.keys())
        self.pairs: List = []
        self.pair_scene: List[str] = []
        self.ims: Dict[str, list] = {}
        for sc in self.scenes:
            sc_pairs = list(match_dict[sc]["pairs"])
            self.pairs += sc_pairs
            self.pair_scene += [sc] * len(sc_pairs)
            self.ims[sc] = match_dict[sc]["ims"]
        # triplets: a random image of another scene per pair
        self.triplet = triplet and len(self.scenes) > 1
        self._rng = np.random.default_rng(seed)
        self._F_cache: Dict = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.pairs)

    def _fundmat(self, pair, w1, h1, w2, h2):
        key = (pair.im1, pair.im2)
        with self._lock:
            hit = self._F_cache.get(key)
        if hit is not None:
            return hit
        # the intrinsics of the (cropped) image resized to (wt, ht)
        K1 = scale_intrinsic(np.asarray(pair.K1, np.float64), w1, h1, self.wt, self.ht)
        K2 = scale_intrinsic(np.asarray(pair.K2, np.float64), w2, h2, self.wt, self.ht)
        F = _pose2fund_np(K1, K2, np.asarray(pair.R, np.float64), pair.t)
        out = (F.astype(np.float32), K1.astype(np.float32), K2.astype(np.float32))
        with self._lock:
            self._F_cache[key] = out
        return out

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        pair = self.pairs[index]
        im1 = load_image(os.path.join(self.data_root, pair.im1),
                         crop=getattr(pair, "crop1", None))
        im2 = load_image(os.path.join(self.data_root, pair.im2),
                         crop=getattr(pair, "crop2", None))
        F, K1, K2 = self._fundmat(pair, im1.width, im1.height, im2.width, im2.height)
        im1 = im1.resize((self.wt, self.ht), Image.BICUBIC)
        im2 = im2.resize((self.wt, self.ht), Image.BICUBIC)
        out = {"im1": to_array(im1), "im2": to_array(im2), "F": F, "K1": K1, "K2": K2}
        if self.triplet:
            scene = self.pair_scene[index]
            others = [s for s in self.scenes if s != scene]
            neg_scene = others[int(self._rng.integers(len(others)))]
            neg_name = self.ims[neg_scene][int(self._rng.integers(len(self.ims[neg_scene])))]
            neg = load_image(os.path.join(self.data_root, neg_name))
            out["neg_im"] = to_array(neg.resize((self.wt, self.ht), Image.BICUBIC))
        return out


def batch_iterator(dataset: MegaDepthPairDataset, batch_size: int, shuffle: bool = True,
                   seed: int = 0, num_workers: int = 8,
                   drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Yield stacked fixed-shape batches in a ``seed``-shuffled order,
    decoding images in ``num_workers`` threads."""
    order = np.arange(len(dataset))
    rng = np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(order)
    n = len(order) - (len(order) % batch_size if drop_last else 0)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for start in range(0, n, batch_size):
            items = list(pool.map(dataset.__getitem__, order[start:start + batch_size]))
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
