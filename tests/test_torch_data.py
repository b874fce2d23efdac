"""The port's data side against the JAX package's, on the CPU.

  * ``data/preprocess.py``'s training helpers (``load_image`` with its
    bottom-right crop, ``crop_from_bottom_right``, ``scale_intrinsic``)
    and ``load_im_tensor(with_gray=True)``: exactly equal to JAX's on PNG
    files written here;
  * ``MegaDepthPairDataset`` + ``batch_iterator``: every batch exactly
    equal to JAX's on a two-scene fixture with crops, pairs and
    triplets; on a ``make_pair`` fixture the loader's F is proportional
    to ``make_pair``'s (rtol 1e-5 after unit-norm and sign);
  * ``prefetch_to_device`` on the CPU: order kept, producer errors raised
    in the consumer, the thread released on an early close;
  * ``MetricsWriter``: means, summaries and JSONL lines equal to JAX's.
"""

import json
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from patch2pix_tpu.data import megadepth as jax_megadepth
from patch2pix_tpu.data import preprocess as jax_preprocess
from patch2pix_tpu.utils.logging import MetricsWriter as JaxMetricsWriter
from patch2pix_tpu_torch.data import megadepth, preprocess
from patch2pix_tpu_torch.data.prefetch import prefetch_to_device
from patch2pix_tpu_torch.data.synthetic import write_megadepth_fixture
from patch2pix_tpu_torch.utils.logging import MetricsWriter
from tests.torch_threads import torch_threads_per_worker  # noqa: F401


def _png(path, h, w, seed):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(path)
    return str(path)


def test_preprocess_helpers_equal_jax(tmp_path):
    path = _png(tmp_path / "a.png", 70, 101, 0)
    for crop in (None, (0, 0), (5, 0), (3, 7)):
        a, b = preprocess.load_image(path, crop), jax_preprocess.load_image(path, crop)
        assert a.size == b.size
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for w, h in ((480, 320), (500, 320), (451, 320), (640, 480), (300, 100), (99, 67)):
        assert (preprocess.crop_from_bottom_right(w, h)
                == jax_preprocess.crop_from_bottom_right(w, h))
    K = np.array([[300.0, 0, 240], [0, 310, 160], [0, 0, 1]])
    np.testing.assert_array_equal(preprocess.scale_intrinsic(K, 640, 427, 480, 320),
                                  jax_preprocess.scale_intrinsic(K, 640, 427, 480, 320))
    for imsize in (None, 64):
        got = preprocess.load_im_tensor(path, imsize, with_gray=True)
        want = jax_preprocess.load_im_tensor(path, imsize, with_gray=True)
        assert len(got) == len(want) == 3 and got[2] == want[2]
        assert got[1].shape == want[1].shape == got[0].shape[:2] + (1,)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)
        rgb, scale = preprocess.load_im_tensor(path, imsize)
        np.testing.assert_array_equal(rgb, want[0])
        assert scale == want[2]


def _crop_fixture(tmp_path):
    """Two scenes of 3 images each (sizes that crop), 4 pairs per scene,
    some with bottom-right crops."""
    root = tmp_path / "data" / "MegaDepth_undistort"
    scenes = {}
    for s, (h, w) in enumerate(((80, 120), (72, 124))):
        scene = f"{s:04d}"
        (root / scene).mkdir(parents=True)
        names = [f"{scene}/im{i}.png" for i in range(3)]
        for i, name in enumerate(names):
            _png(root / name, h, w, 10 * s + i)
        crop = preprocess.crop_from_bottom_right(w, h)
        K = np.array([[100.0 + s, 0, w / 2], [0, 101, h / 2], [0, 0, 1]])
        pairs = [SimpleNamespace(im1=names[i % 3], im2=names[(i + 1) % 3], K1=K, K2=K * 1.01,
                                 R=np.eye(3), t=np.array([0.5, 0.1 * i, 0.02]),
                                 crop1=crop if i % 2 else None, crop2=crop)
                 for i in range(4)]
        scenes[scene] = {"ims": names, "pairs": pairs}
    (tmp_path / "pairs").mkdir()
    np.save(tmp_path / "pairs" / "p.npy", scenes)
    return str(tmp_path / "data"), str(tmp_path / "pairs" / "p.npy")


@pytest.mark.parametrize("triplet", [False, True], ids=["pairs", "triplets"])
def test_megadepth_batches_equal_jax(tmp_path, triplet):
    data_root, npy = _crop_fixture(tmp_path)
    kw = dict(wt=64, ht=48, triplet=triplet, seed=3)
    port = megadepth.MegaDepthPairDataset(data_root, npy, **kw)
    ref = jax_megadepth.MegaDepthPairDataset(data_root, npy, **kw)
    assert len(port) == len(ref) == 8 and port.triplet == triplet
    # one worker: the triplet negatives come from the dataset's generator
    # in call order
    got = list(megadepth.batch_iterator(port, 3, seed=5, num_workers=1))
    want = list(jax_megadepth.batch_iterator(ref, 3, seed=5, num_workers=1))
    assert len(got) == len(want) == 2
    keys = {"im1", "im2", "F", "K1", "K2"} | ({"neg_im"} if triplet else set())
    for g, w in zip(got, want):
        assert set(g) == set(w) == keys
        for k in keys:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got[0]["im1"].shape == (3, 48, 64, 3)


def test_loader_fundamental_matrix_is_make_pairs(tmp_path):
    data_root, pair_root, npy, Fs = write_megadepth_fixture(str(tmp_path), 3, 64, 96, seed=1)
    ds = megadepth.MegaDepthPairDataset(data_root, os.path.join(pair_root, npy), wt=96, ht=64)
    for i in range(3):
        item = ds[i]
        assert item["im1"].shape == (64, 96, 3)
        F = item["F"].astype(np.float64)
        F /= np.linalg.norm(F)
        F *= np.sign(F.ravel() @ Fs[i].ravel())
        np.testing.assert_allclose(F, Fs[i], rtol=1e-5, atol=1e-6)


def test_prefetch_keeps_order_and_raises_producer_errors():
    items = [{"a": np.full((2, 3), i, np.float32), "b": np.arange(i + 1)} for i in range(5)]
    got = list(prefetch_to_device(iter(items), size=2, device="cpu"))
    assert len(got) == 5
    for i, item in enumerate(got):
        assert isinstance(item["a"], torch.Tensor) and torch.equal(item["a"],
                                                                   torch.full((2, 3), float(i)))
        assert torch.equal(item["b"], torch.arange(i + 1))

    def failing():
        yield {"a": np.zeros(1)}
        raise ValueError("bad batch")

    it = prefetch_to_device(failing(), device="cpu")
    next(it)
    with pytest.raises(ValueError, match="bad batch"):
        next(it)


def test_prefetch_releases_its_thread_on_early_close():
    before = threading.active_count()
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield {"x": np.full(4, i)}
            i += 1

    it = prefetch_to_device(endless(), size=2, device="cpu")
    assert int(next(it)["x"][0]) == 0
    it.close()
    assert threading.active_count() == before
    n = len(produced)
    assert n <= 4  # the one taken, two staged, one blocked at the put
    threading.Event().wait(0.3)
    assert len(produced) == n


def test_metrics_writer_equals_jax(tmp_path):
    rs = np.random.RandomState(0)
    steps = [{"loss/pair": np.float32(rs.rand()), "skipped": np.float32(i % 2),
              "cls_mid/acc": np.float32(np.nan if i == 1 else rs.rand())} for i in range(4)]
    port = MetricsWriter(str(tmp_path / "port" / "m.jsonl"))
    ref = JaxMetricsWriter(str(tmp_path / "jax" / "m.jsonl"))
    for epoch in (1, 2):
        for m in steps:
            port.append({k: torch.tensor(v) for k, v in m.items()})
            ref.append(m)
        port.append({"stacked": torch.tensor([1.0, 2.0, 4.0])})
        ref.append({"stacked": np.array([1.0, 2.0, 4.0], np.float32)})
        assert port.summary(["loss/pair", "skipped"]) == ref.summary(["loss/pair", "skipped"])
        assert port.summary() == ref.summary()
        assert port.flush(epoch) == ref.flush(epoch)
    got = (tmp_path / "port" / "m.jsonl").read_text().splitlines()
    want = (tmp_path / "jax" / "m.jsonl").read_text().splitlines()
    assert got == want and len(got) == 2
    assert json.loads(got[1])["epoch"] == 2
