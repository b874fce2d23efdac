"""The port's incremental SfM, COLMAP export and scale demo against the
JAX package's, on the CPU.

  * the RNG-free steps, from the same state: JAX's
    ``IncrementalSfM(verify_pairs=False)`` after its ``init_pair`` (and
    one more registration), its poses and points copied into the port's
    (the same tracks, canonically equal to JAX's, then copied so that
    track ids agree): ``_triangulate_tracks`` (the same track ids, X
    within 1e-4), ``assemble_ba`` (identical arrays), one
    ``bundle_adjust`` (15 LM iterations in float32 on both sides, each
    accept/reject on costs that agree to ~1e-6: poses and points within
    1e-4) and ``filter_points`` (the same dropped observations and
    points);
  * ``run()`` on the 6-camera scene of ``tests/test_sfm_incremental.py``:
    every camera registered, ATE < 0.04 (that test's bounds), the
    registered set equal to JAX's;
  * the rescue pass's PnP RANSACs draw ``RESCUE_HYPS`` hypotheses, the
    main loop's JAX's 256;
  * ``export_colmap`` of one reconstruction: files byte-identical to
    JAX's (binary and text);
  * the demo's ``main`` at ``--cams 8 --pts 300 --mesh 2 --device cpu``
    (two gloo ranks) writes a ``summary.json`` with JAX's keys, the
    device's name and power limit;
  * without CUDA (``torch.cuda.is_available`` patched to False) the
    entry points refuse to run unless given a device.
"""

import copy
import json

import numpy as np
import pytest
import torch

from patch2pix_tpu.sfm import incremental as jax_inc
from patch2pix_tpu.sfm.metrics import ate_rmse
from patch2pix_tpu_torch.sfm import ba, dist_ba, incremental, scale_demo
from tests.test_native_tracks import canonical
from tests.test_sfm_incremental import K, make_pixel_scene
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

# the keys of tools/sfm_scale_demo.py's summary.json
JAX_SUMMARY_KEYS = {
    "cams", "pts", "pairs", "matches", "outlier_frac", "noise_px", "tracks", "points", "obs",
    "t_tracks_s", "t_incremental_s", "s_per_image", "t_dist_ba_s", "ate_incremental",
    "ate_after_dist_ba", "ate_pct_of_radius", "dist_ba_psum_mb_per_iter", "mesh",
    "stage_attribution",
}


def quiet(*_):
    pass


def copy_state(src, dst):
    """JAX's reconstruction state (poses, points) into the port's."""
    dst.rec.Rs = {k: v.copy() for k, v in src.rec.Rs.items()}
    dst.rec.ts = {k: v.copy() for k, v in src.rec.ts.items()}
    dst.rec.points = {k: v.copy() for k, v in src.rec.points.items()}


@pytest.fixture(scope="module")
def scene():
    return make_pixel_scene(noise_px=0.3, seed=1)


def test_rng_free_steps_equal_jax(scene):
    Rs, ts, X, pm = scene
    intr = {i: K for i in range(len(Rs))}
    jx = jax_inc.IncrementalSfM(pm, intr, px_thres=2.0, verify_pairs=False, log=quiet)
    pt = incremental.IncrementalSfM(pm, intr, px_thres=2.0, verify_pairs=False, log=quiet,
                                    device="cpu")
    assert canonical(pt.tracks) == canonical(jx.tracks)
    pt.tracks = copy.deepcopy(jx.tracks)
    pt.rec.track_obs = pt.tracks

    jx.init_pair()  # triangulates the pair's tracks
    pt.rec.Rs = {k: v.copy() for k, v in jx.rec.Rs.items()}
    pt.rec.ts = {k: v.copy() for k, v in jx.rec.ts.items()}
    pt._triangulate_tracks()
    assert pt.rec.points.keys() == jx.rec.points.keys() and len(pt.rec.points) > 20
    for t, x in jx.rec.points.items():
        np.testing.assert_allclose(pt.rec.points[t], x, atol=1e-4)

    assert jx.register_next() is not None
    jx._triangulate_tracks()
    copy_state(jx, pt)
    got, want = pt.assemble_ba(), jx.assemble_ba()
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w

    jx.bundle_adjust()
    pt.bundle_adjust()
    for im in jx.rec.Rs:
        np.testing.assert_allclose(pt.rec.Rs[im], jx.rec.Rs[im], atol=1e-4)
        np.testing.assert_allclose(pt.rec.ts[im], jx.rec.ts[im], atol=1e-4)
    for t, x in jx.rec.points.items():
        np.testing.assert_allclose(pt.rec.points[t], x, atol=1e-4)
    assert pt.stats["ba_calls"] == 1 and pt.stats["ba_shapes"] == 1

    copy_state(jx, pt)
    pt.tracks[:] = copy.deepcopy(jx.tracks)
    dropped = pt.filter_points(max_px=0.5)
    assert dropped == jx.filter_points(max_px=0.5) and dropped[0] > 0
    assert pt.rec.points.keys() == jx.rec.points.keys()
    assert canonical(pt.tracks) == canonical(jx.tracks)


def test_run_registers_every_camera_like_jax(scene):
    Rs, ts, X, pm = scene
    intr = {i: K for i in range(len(Rs))}
    rec = incremental.IncrementalSfM(pm, intr, px_thres=2.0, log=quiet, device="cpu").run()
    jrec = jax_inc.IncrementalSfM(pm, intr, px_thres=2.0, log=quiet).run()
    assert len(rec.registered) == len(Rs)
    assert rec.registered == jrec.registered
    gt_centers = np.stack([-R.T @ t for R, t in zip(Rs, ts)])
    assert ate_rmse(rec.centers(), gt_centers) < 0.04


def test_rescue_pass_draws_more_pnp_hypotheses(scene, monkeypatch):
    """The main loop's PnP RANSACs draw JAX's 256 hypotheses and the rescue
    pass's ``RESCUE_HYPS``; a camera taken out of the finished run comes
    back through a rescue-pass call, whose RANSAC draws that many."""
    Rs, ts, X, pm = scene
    sfm = incremental.IncrementalSfM(pm, {i: K for i in range(len(Rs))}, px_thres=2.0,
                                     log=quiet, device="cpu")
    drawn, calls = [], []
    ransac_pnp, register_batch = incremental.ransac_pnp, sfm.register_batch

    def count_hyps(gen, X, p, n_hyps, *args, **kwargs):
        drawn.append(n_hyps)
        return ransac_pnp(gen, X, p, n_hyps, *args, **kwargs)

    def record(**kwargs):
        calls.append(kwargs)
        return register_batch(**kwargs)

    monkeypatch.setattr(incremental, "ransac_pnp", count_hyps)
    monkeypatch.setattr(sfm, "register_batch", record)
    rec = sfm.run()
    assert len(rec.registered) == len(Rs) and set(drawn) == {256}
    assert [c.get("thres_scale", 1.0) > 1 for c in calls].count(True) >= 3
    assert all(c.get("n_hyps", 256) == (sfm.RESCUE_HYPS if c.get("thres_scale", 1.0) > 1
                                        else 256) for c in calls)

    im = rec.registered[-1]
    del rec.Rs[im], rec.ts[im]
    drawn.clear()
    assert register_batch(thres_scale=2.0, min_inliers=12, n_hyps=sfm.RESCUE_HYPS) == [im]
    assert drawn == [sfm.RESCUE_HYPS]


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_export_colmap_bytes_equal_jax(tmp_path, ext):
    rng = np.random.default_rng(5)
    tracks = [{im: rng.uniform(0, 600, 2) for im in rng.choice(5, 3, replace=False)}
              for _ in range(12)]
    fields = dict(
        K={i: K for i in range(5)},
        Rs={i: np.linalg.qr(rng.standard_normal((3, 3)))[0] for i in (0, 1, 3, 4)},
        ts={i: rng.standard_normal(3) for i in (0, 1, 3, 4)},
        points={t: rng.standard_normal(3) for t in range(0, 12, 2)},
        track_obs=tracks)
    names = {0: "a.jpg", 1: "b.jpg"}
    for module, out in ((incremental, "torch"), (jax_inc, "jax")):
        (tmp_path / out).mkdir()
        module.export_colmap(module.Reconstruction(**copy.deepcopy(fields)),
                             str(tmp_path / out), image_names=names, ext=ext)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "torch").iterdir()) and len(files) == 3
    for name in files:
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_scale_demo_main_writes_jax_summary(tmp_path):
    out = tmp_path / "demo"
    summary = scale_demo.main(["--cams", "8", "--pts", "300", "--mesh", "2", "--device", "cpu",
                               "--out", str(out)])
    on_disk = json.loads((out / "summary.json").read_text())
    assert on_disk == json.loads(json.dumps(summary))
    assert set(on_disk) == JAX_SUMMARY_KEYS | {"device", "power_limit"}
    assert on_disk["device"] == "cpu" and on_disk["mesh"] == 2
    assert on_disk["points"] > 0.6 * 300 and on_disk["ate_pct_of_radius"] < 1.0


def test_entry_points_need_cuda_or_a_device(scene, monkeypatch):
    Rs, ts, X, pm = scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sp = dist_ba.shard_problem(Rs, ts, X, np.zeros(3, np.int64), np.arange(3), np.zeros((3, 2)),
                               n_shards=1)
    calls = [
        lambda: incremental.IncrementalSfM(pm, {i: K for i in range(len(Rs))}, log=quiet),
        lambda: ba.build_problem(Rs, ts, X, np.zeros(3, np.int64), np.arange(3),
                                 np.zeros((3, 2))),
        lambda: dist_ba.run_dist_ba(sp),
        lambda: ba.run_ba(ba.build_problem(Rs, ts, X, np.zeros(3, np.int64), np.arange(3),
                                           np.zeros((3, 2)), device="cpu")),
        lambda: scale_demo.main(["--cams", "8", "--pts", "300"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
