"""The port's evaluation protocols against the JAX package's, on the CPU.

  * ``eval_immatch_val_sets`` with the oracle matcher on the scene of
    ``tests/test_immatch_protocol.py`` (the same matches fed to both
    packages, the port's 5-point RANSAC fed JAX's sample ids): the same
    pairs sampled, qt within 0.02 deg of JAX's at every pair, the same
    pass rates, no failed pair; then the port's own draws;
  * ``eval_matches_relapose`` on 0, 3 and 5 matches: it raises where JAX
    raises (nowhere), with JAX's inliers where JAX's pose is finite;
  * the ``write_val_dense_fixture`` + ``oracle_matcher`` set that
    ``chip_smoke.py`` phase 13 runs, at a small size: every pair under
    1 deg in both packages;
  * ``eval_hpatches`` (per pair, through ``batch_matcher`` and with a
    failing matcher) on the layout of ``tests/test_evaluation.py``;
  * ``localize_query`` (the PnP RANSAC fed JAX's ids), ``lift_matches``
    and ``map_images_from_colmap`` on the layout of
    ``tests/test_localize.py``;
  * the entry points refuse to run without CUDA unless given a device.
"""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from patch2pix_tpu.data import colmap_model as jax_cm
from patch2pix_tpu.evaluation import hpatches as jax_hp
from patch2pix_tpu.evaluation import immatch as jax_im
from patch2pix_tpu.evaluation import localize as jax_loc
from patch2pix_tpu.evaluation import measure as jax_measure
from patch2pix_tpu_torch.data.synthetic import oracle_matcher, write_val_dense_fixture
from patch2pix_tpu_torch.evaluation import hpatches, immatch, localize, measure
from patch2pix_tpu_torch.sfm import fivepoint, pnp
from tests.test_colmap_io import synthetic_model
from tests.test_immatch_protocol import synthetic_scene  # noqa: F401
from tests.test_localize import K as LOC_K
from tests.test_localize import build_map_and_query
from tests.test_torch_sfm_geometry import jax_ids, rot_err
from tests.torch_threads import torch_threads_per_worker  # noqa: F401


def noop(*_):
    pass


def replay(matcher):
    """``matcher`` with each pair's first answer kept, so that both
    packages see the same matches; ``calls`` records the pairs asked."""
    seen = {}

    def call(p1, p2):
        call.calls.append((p1, p2))
        if (p1, p2) not in seen:
            seen[(p1, p2)] = matcher(p1, p2)
        return seen[(p1, p2)]

    call.calls = []
    return call


@pytest.fixture
def jax_sample_ids(monkeypatch):
    """The port's RANSACs draw JAX's ids for JAX's key (``PRNGKey(0)``,
    the protocols' seed)."""
    def draw(generator, valid, n_samples, k):
        return jax_ids(jax.random.PRNGKey(0), valid.cpu().numpy(), n_samples, k)

    monkeypatch.setattr(fivepoint, "draw_sample_ids", draw)
    monkeypatch.setattr(pnp, "draw_sample_ids", draw)


def test_immatch_oracle_equals_jax(synthetic_scene, jax_sample_ids):  # noqa: F811
    data_root, matcher = synthetic_scene
    matcher = replay(matcher)
    kw = dict(data_root=data_root, rthres=0.5, sample_max=20, min_overlap=0.3, log=noop)
    qt_j, pr_j, want = jax_im.eval_immatch_val_sets(matcher, **kw)
    pairs_j = list(matcher.calls)
    matcher.calls.clear()
    qt_t, pr_t, got = immatch.eval_immatch_val_sets(matcher, device="cpu", **kw)
    assert matcher.calls == pairs_j and len(pairs_j) > 3
    assert not (got.match_failed or got.geo_failed or want.match_failed or want.geo_failed)
    np.testing.assert_allclose(got.qt, want.qt, atol=0.02)
    assert abs(qt_t - qt_j) < 0.02 and qt_t < 2.0
    np.testing.assert_array_equal(pr_t, pr_j)
    assert got.best_ckpt_score == want.best_ckpt_score
    for a, b in zip(got.num_inls, want.num_inls):
        assert abs(a - b) <= max(1, a // 100)
    assert got.num_matches == want.num_matches
    for a, b in zip(got.fdist, want.fdist):
        np.testing.assert_array_equal(a, b)


def test_immatch_oracle_with_its_own_draws(synthetic_scene):  # noqa: F811
    data_root, matcher = synthetic_scene
    qt, pass_rate, errs = immatch.eval_immatch_val_sets(
        matcher, data_root=data_root, rthres=0.5, sample_max=20, min_overlap=0.3, log=noop,
        device="cpu")
    assert len(errs.qt) > 3 and not (errs.match_failed or errs.geo_failed)
    assert qt < 2.0 and pass_rate[4] > 90.0 and errs.best_ckpt_score > 50.0


@pytest.mark.parametrize("n", [0, 3, 5])
def test_eval_matches_relapose_few_matches(n, jax_sample_ids):
    rng = np.random.default_rng(n)
    K = np.array([[600.0, 0, 320], [0, 600, 240], [0, 0, 1]])
    matches = rng.uniform(0, 480, (n, 4))
    q, t = np.array([0.99, 0.1, -0.05, 0.02]), np.array([1.0, 0.1, 0.0])
    q /= np.linalg.norm(q)
    outcomes = []
    for fn, kw in ((jax_measure.eval_matches_relapose, {}),
                   (measure.eval_matches_relapose, {"device": "cpu"})):
        try:
            outcomes.append(fn(matches, K, K, q, t, 0.5, **kw))
        except Exception as e:  # noqa: BLE001 (either raises or neither)
            outcomes.append(type(e))
    assert [isinstance(o, type) for o in outcomes] == [False, False], outcomes
    (tj, rj, inl_j), (tt, rt, inl_t) = outcomes
    assert all(i < n for i in inl_t)
    if np.isfinite([tj, rj]).all():
        np.testing.assert_array_equal(inl_t, inl_j)


def test_val_dense_fixture_oracle(tmp_path, jax_sample_ids):
    scenes = write_val_dense_fixture(str(tmp_path), 2, 192, 256, seed=1, grid=(8, 6))
    assert sorted(os.listdir(tmp_path)) == ["scene00", "scene01"]
    sparse = tmp_path / "scene00" / "dense" / "sparse"
    ov = np.load(sparse / "ov_pairs.npy", allow_pickle=True).item()
    assert ov[0.3] == [("im2.png", "im1.png")]
    ims = jax_cm.read_model(str(sparse))[1]
    assert {im.name for im in ims.values()} == {"im1.png", "im2.png"}
    matcher = replay(oracle_matcher(scenes, n=300, seed=2))
    qt_t, pr_t, got = immatch.eval_immatch_val_sets(matcher, data_root=str(tmp_path),
                                                    log=noop, device="cpu")
    qt_j, pr_j, want = jax_im.eval_immatch_val_sets(matcher, data_root=str(tmp_path),
                                                    log=noop)
    assert len(got.qt) == 2 and not (got.match_failed or got.geo_failed)
    assert max(got.qt) < 1.0 and pr_t[0] == 100.0
    np.testing.assert_allclose(got.qt, want.qt, atol=0.02)


def _hpatches_layout(root):
    rng = np.random.default_rng(0)
    Hs = {"i_fake": np.eye(3), "v_fake": np.diag([2.0, 2.0, 1.0])}
    for seq, H in Hs.items():
        d = root / seq
        d.mkdir()
        for k in (1, 2, 3):
            Image.fromarray(rng.integers(0, 255, (32, 32, 3), np.uint8)).save(str(d / f"{k}.png"))
        for k in (2, 3):
            np.savetxt(str(d / f"H_1_{k}"), H)
    return Hs


def test_hpatches_equals_jax(tmp_path):
    Hs = _hpatches_layout(tmp_path)
    rng = np.random.default_rng(1)

    def matcher(p1, p2):
        pts1 = rng.uniform(0, 30, (50, 2))
        ph = np.concatenate([pts1, np.ones((50, 1))], 1) @ Hs[os.path.basename(
            os.path.dirname(p1))].T
        pts2 = ph[:, :2] / ph[:, 2:3] + rng.normal(0, 3, (50, 2))
        return np.concatenate([pts1, pts2], 1), np.ones(50), None

    matcher = replay(matcher)
    want = jax_hp.eval_hpatches(matcher, str(tmp_path), log=noop)
    got = hpatches.eval_hpatches(matcher, str(tmp_path), log=noop)
    for split in ("all", "i", "v"):
        np.testing.assert_array_equal(got.mma(split=split), want.mma(split=split))
    assert got.num_matches == want.num_matches and got.failed == want.failed == []
    assert 0 < got.mma()[2] < 1

    class Batch:
        def match_pairs(self, pairs):
            return [matcher(a, b) for a, b in pairs]

    via = hpatches.eval_hpatches(None, str(tmp_path), log=noop, batch_matcher=Batch())
    np.testing.assert_array_equal(via.mma(), got.mma())

    def broken(p1, p2):
        if p2.endswith("3.png"):
            raise RuntimeError("no matches")
        return matcher(p1, p2)

    want = jax_hp.eval_hpatches(broken, str(tmp_path), log=noop)
    got = hpatches.eval_hpatches(broken, str(tmp_path), log=noop)
    assert got.failed == want.failed and len(got.failed) == 2
    np.testing.assert_array_equal(got.mma(), want.mma())


def test_localize_equals_jax(jax_sample_ids):
    Rs, ts, db, matcher = build_map_and_query(seed=0)
    matcher = replay(matcher)
    want = jax_loc.localize_query(matcher, "query.jpg", LOC_K, db, px_thres=3.0)
    dbt = [localize.MapImage(d.path, d.xys, d.pts3d) for d in db]
    got = localize.localize_query(matcher, "query.jpg", LOC_K, dbt, px_thres=3.0,
                                  device="cpu")
    assert want.success and got.success and got.num_corrs == want.num_corrs
    assert abs(got.num_inliers - want.num_inliers) <= max(1, want.num_corrs // 100)
    assert rot_err(got.R, want.R) < 1e-3
    np.testing.assert_allclose(got.camera_center, want.camera_center, atol=1e-3)
    np.testing.assert_allclose(got.camera_center, -Rs[4].T @ ts[4], atol=0.05)
    own = localize.localize_query(matcher, "query.jpg", LOC_K, dbt, px_thres=3.0,
                                  device="cpu", seed=3)
    assert own.success and rot_err(own.R, Rs[4]) < np.radians(1.0)
    # too few correspondences: no RANSAC, as in JAX
    few = localize.localize_query(matcher, "query.jpg", LOC_K, dbt, min_corrs=10 ** 6,
                                  device="cpu")
    assert not few.success and few.num_corrs == got.num_corrs


def test_localize_helpers_equal_jax(tmp_path):
    db = localize.MapImage("x", np.array([[10.0, 10.0], [50.0, 50.0], [20.0, 5.0]]),
                           np.array([[0.0, 0, 1], [1.0, 0, 1], [2.0, 1, 3]]))
    matches = np.random.default_rng(0).uniform(0, 60, (40, 4))
    want = jax_loc.lift_matches(matches, jax_loc.MapImage(db.path, db.xys, db.pts3d), 8.0)
    got = localize.lift_matches(matches, db, 8.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) > 0
    jax_cm.write_model(*synthetic_model(n_ims=4, n_pts=10, seed=5), str(tmp_path))
    want = jax_loc.map_images_from_colmap(str(tmp_path), "imgs")
    got = localize.map_images_from_colmap(str(tmp_path), "imgs")
    assert want.keys() == got.keys() and len(got) >= 1
    for k in want:
        assert got[k].path == want[k].path
        np.testing.assert_array_equal(got[k].xys, want[k].xys)
        np.testing.assert_array_equal(got[k].pts3d, want[k].pts3d)


def test_entry_points_need_cuda_unless_given_a_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    write_val_dense_fixture(str(tmp_path), 1, 64, 96, grid=(4, 3))

    def matcher(p1, p2):
        raise AssertionError("the device is resolved before any pair")

    with pytest.raises(RuntimeError, match="CUDA"):
        immatch.eval_immatch_val_sets(matcher, data_root=str(tmp_path), log=noop)
    with pytest.raises(RuntimeError, match="CUDA"):
        localize.localize_query(matcher, "q.jpg", LOC_K, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        measure.eval_matches_relapose(np.zeros((8, 4)), LOC_K, LOC_K, np.array([1.0, 0, 0, 0]),
                                      np.ones(3))
