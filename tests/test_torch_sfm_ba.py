"""The port's SfM backend against the JAX package's, on the CPU:
metrics, the synthetic scale scene, tracks, bundle adjustment and the
point-sharded distributed BA.

  * ``sfm/metrics.py`` to 1e-12, ``make_scale_scene`` (8 cameras, 300
    points) identical arrays and match dicts;
  * tracks: the port's Python and native (C++) paths against JAX's
    Python ``build_tracks`` on ``tests/test_native_tracks.py``'s random
    and structured inputs, in the same canonical form (6 decimals); the
    native path raises where its library cannot be built;
  * ``sfm/ba.py`` on 4-6 cameras: ``residuals_and_jacobians``, each
    output of ``schur_blocks``, ``solve_reduced``, ``backsub_points`` and
    one ``ba_step``, with and without Huber, to rtol 1e-4 / atol 1e-5
    (float32 on both sides, summed in other orders; the old cost to rtol
    1e-5, the new one as below); ``bucket=True`` gives the unpadded answer;
    ``run_ba`` converges as in ``test_ba_converges_to_noise_floor`` and
    ends within 0.5 relative of JAX's cost; a non-positive-definite
    point block, and unobserved pad points, give JAX's pattern of finite
    and NaN outputs, not an exception;
  * ``sfm/dist_ba.py``: ``shard_problem``'s arrays identical to JAX's
    (unbalanced shards included); then one spawned gloo group of 4 CPU
    ranks runs the first-step parity against the port's ``ba_step``
    (old cost rtol 1e-5, new cost rtol 1e-3, R and t atol 1e-5, as in
    ``tests/test_sfm_dist.py``), the unequal-shards case, ``run_dist_ba``
    against JAX's on a 4-device CPU mesh (both converged below 1e-3 of
    the initial cost, final costs within 0.5 relative), and
    ``debug_checks=True`` raising nothing.

A step's new cost is small beside its old cost, so it carries the
rounding of the reduced solve: it is held to rtol 1e-3 wherever the two
sides solve by another order (the padded problem, the group's summed
system), as ``tests/test_sfm_dist.py`` holds it.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from patch2pix_tpu.sfm import ba as jax_ba
from patch2pix_tpu.sfm import dist_ba as jax_dist
from patch2pix_tpu.sfm import metrics as jax_metrics
from patch2pix_tpu.sfm import synthetic as jax_synth
from patch2pix_tpu.sfm.tracks import build_tracks as jax_build_tracks
from patch2pix_tpu_torch import native
from patch2pix_tpu_torch.sfm import ba, dist_ba, metrics, synthetic
from patch2pix_tpu_torch.sfm.tracks import build_tracks
from tests.test_native_tracks import canonical, random_matches
from tests.test_sfm import make_scene, perturb_scene
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5


def close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


# ------------------------------------------------------------ metrics, synthetic


def test_metrics_equal_jax():
    rng = np.random.default_rng(0)
    src = rng.standard_normal((12, 3))
    R = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    dst = 1.7 * src @ R.T + [0.3, -1, 2] + 1e-3 * rng.standard_normal((12, 3))
    for with_scale in (True, False):
        got = metrics.umeyama_alignment(src, dst, with_scale)
        want = jax_metrics.umeyama_alignment(src, dst, with_scale)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
        assert metrics.ate_rmse(src, dst, with_scale) == pytest.approx(
            jax_metrics.ate_rmse(src, dst, with_scale), rel=1e-12)
    Rs = np.stack([np.linalg.qr(rng.standard_normal((3, 3)))[0] for _ in range(4)])
    np.testing.assert_allclose(metrics.rotation_errors_deg(Rs, Rs[::-1], R),
                               jax_metrics.rotation_errors_deg(Rs, Rs[::-1], R), atol=1e-12)


def test_make_scale_scene_equals_jax():
    got = synthetic.make_scale_scene(n_cams=8, n_pts=300)
    want = jax_synth.make_scale_scene(n_cams=8, n_pts=300)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    assert got[4].keys() == want[4].keys() and len(got[4]) > 10
    for k in want[4]:
        np.testing.assert_array_equal(got[4][k], want[4][k])


# ------------------------------------------------------------ tracks


def structured_matches():
    """``tests/test_native_tracks.py``'s chained matches."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(10, 400, (60, 2))
    pm = {}
    for i in range(4):
        a = pts + 0.3 * rng.standard_normal(pts.shape)
        b = pts + 0.3 * rng.standard_normal(pts.shape)
        pm[(i, i + 1)] = np.concatenate([a, b], axis=1)
    return pm


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("inputs", ["random", "structured"])
def test_tracks_equal_jax(inputs, use_native):
    pm, min_len = (random_matches(), 2) if inputs == "random" else (structured_matches(), 3)
    want = jax_build_tracks(pm, cell=4.0, min_track_len=min_len, use_native=False)
    got = build_tracks(pm, cell=4.0, min_track_len=min_len, use_native=use_native)
    assert len(want) > 0 and canonical(got) == canonical(want)


def test_native_tracks_raise_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot build"):
        build_tracks(structured_matches(), use_native=True)
    assert build_tracks(structured_matches(), min_track_len=3, use_native=False)


# ------------------------------------------------------------ ba


def problems(n_cams=5, n_pts=40, seed=21, bucket=False):
    Rs, ts, X, ci, pi, uv = make_scene(n_cams=n_cams, n_pts=n_pts, noise=1e-3, seed=seed)
    Rp, tp, Xp = perturb_scene(Rs, ts, X, seed=seed + 1)
    return (jax_ba.build_problem(Rp, tp, Xp, ci, pi, uv, bucket=bucket),
            ba.build_problem(Rp, tp, Xp, ci, pi, uv, bucket=bucket, device="cpu"))


HUBER = 3e-3  # normalized units: the residuals of a perturbed scene reach ~1e-1


@pytest.mark.parametrize("use_huber", [False, True])
def test_ba_blocks_equal_jax(use_huber):
    jp, tp = problems()
    for g, w in zip(ba.residuals_and_jacobians(tp), jax_ba.residuals_and_jacobians(jp)):
        close(g, w)
    hd = float(np.float32(HUBER))
    want = jax_ba.schur_blocks(jp, jnp.float32(1e-3), jnp.float32(hd), use_huber, 5)
    got = ba.schur_blocks(tp, 1e-3, hd, use_huber, 5)
    for name, g, w in zip(("S_cross_neg", "U", "b_red", "W", "Vinv", "bp"), got, want):
        w = np.asarray(w)
        close(g, w, err_msg=name)
    jdc = jax_ba.solve_reduced(*want[:3], jnp.float32(1e-3), jp.fixed_cams)
    dc = ba.solve_reduced(*got[:3], 1e-3, tp.fixed_cams)
    close(dc, jdc)
    close(ba.backsub_points(tp, *got[3:], dc), jax_ba.backsub_points(jp, *want[3:], jdc))
    jnew, jc, jo = jax_ba.ba_step(jp, jnp.float32(1e-3), jnp.float32(hd), use_huber)
    new, c, o = ba.ba_step(tp, 1e-3, hd, use_huber)
    assert float(o) == pytest.approx(float(jo), rel=1e-5)
    assert float(c) == pytest.approx(float(jc), rel=1e-3)
    for g, w in zip(new[:3], jnew[:3]):
        close(g, w)


def test_ba_bucket_gives_the_unpadded_answer():
    _, tp = problems(n_cams=6, n_pts=30, seed=31)
    _, tb = problems(n_cams=6, n_pts=30, seed=31, bucket=True)
    assert tb.Rs.shape[0] > 6 and tb.X.shape[0] > 30 and tb.uv.shape[0] > tp.uv.shape[0]
    new, c, o = ba.ba_step(tp, 1e-3, 1e9, False)
    newb, cb, ob = ba.ba_step(tb, 1e-3, 1e9, False)
    # the padded reduced system is solved by another pivot order: the
    # new cost, small beside the old, moves by its rounding (the dist
    # parity rules: old cost rtol 1e-5, new cost 1e-3)
    assert float(cb) == pytest.approx(float(c), rel=1e-3)
    assert float(ob) == pytest.approx(float(o), rel=1e-5)
    close(newb.Rs[:6], new.Rs)
    close(newb.ts[:6], new.ts)
    close(newb.X[:30], new.X)
    # pad cameras and points stay where they were
    close(newb.Rs[6:], tb.Rs[6:], rtol=0, atol=0)
    close(newb.X[30:], tb.X[30:], rtol=0, atol=0)


@pytest.mark.parametrize("huber", [float("inf"), HUBER])
def test_run_ba_converges_like_jax(huber):
    Rs, ts, X, ci, pi, uv = make_scene(noise=1e-4, seed=2)
    Rp, tp, Xp = perturb_scene(Rs, ts, X, seed=3)
    prob = ba.build_problem(Rp, tp, Xp, ci, pi, uv, device="cpu")
    c0 = float(ba.cost(prob))
    solved, c1 = ba.run_ba(prob, max_iters=25, huber_delta=huber, device="cpu")
    _, cj = jax_ba.run_ba(jax_ba.build_problem(Rp, tp, Xp, ci, pi, uv), max_iters=25,
                          huber_delta=huber)
    assert c1 < c0 * 1e-3
    assert ba.reprojection_rmse(solved) < 5e-4
    assert abs(c1 - cj) / max(cj, 1e-12) < 0.5


@pytest.mark.parametrize("bucket", [False, True])
def test_degenerate_point_blocks_give_jax_nan_pattern(bucket):
    """A negative observation weight makes one point's V (and so Vinv)
    negative definite: its Cholesky factor is NaN in both packages,
    where ``torch.linalg.cholesky`` would raise. With ``bucket=True`` the
    unobserved pad points (V only the damping floor) stay finite in
    both."""
    jp, tp = problems(n_cams=4, n_pts=12, seed=41, bucket=bucket)
    w = np.ones(tp.obs_w.shape[0], np.float32)
    w[np.asarray(tp.pt_idx) == 3] = -1.0
    jp = jp._replace(obs_w=jnp.asarray(w))
    tp = tp._replace(obs_w=torch.from_numpy(w))
    C = tp.Rs.shape[0]
    want = jax_ba.schur_blocks(jp, jnp.float32(1e-3), jnp.float32(1e9), False, C)
    got = ba.schur_blocks(tp, 1e-3, 1e9, False, C)
    assert not np.isfinite(np.asarray(want[0])).all()
    if bucket:
        assert tp.X.shape[0] > 12 and np.isfinite(got[4][12:].numpy()).all()
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(np.isfinite(g.numpy()), np.isfinite(np.asarray(wnt)))
    jnew, jc, _ = jax_ba.ba_step(jp, jnp.float32(1e-3), jnp.float32(1e9), False)
    new, c, _ = ba.ba_step(tp, 1e-3, 1e9, False)
    assert np.isfinite(float(c)) == np.isfinite(float(jc))
    for g, wnt in zip(new[:3], jnew[:3]):
        np.testing.assert_array_equal(np.isfinite(g.numpy()), np.isfinite(np.asarray(wnt)))


# ------------------------------------------------------------ dist_ba

DIST_SCENES = {  # name: make_scene arguments, perturb seed, shards (tests/test_sfm_dist.py)
    "first_step": ((4, 32, 1e-3, 21), 22, 4),
    "unequal": ((6, 10, 1e-3, 31), 32, 4),
    "run": ((5, 64, 1e-4, 11), 12, 4),
    "debug": ((4, 40, 1e-4, 21), 22, 4),
}


def dist_scene(name):
    (n_cams, n_pts, noise, seed), pseed, shards = DIST_SCENES[name]
    Rs, ts, X, ci, pi, uv = make_scene(n_cams=n_cams, n_pts=n_pts, noise=noise, seed=seed)
    Rp, tp, Xp = perturb_scene(Rs, ts, X, seed=pseed)
    return (Rp, tp, Xp, ci, pi, uv), shards


@pytest.mark.parametrize("name", ["unequal", "run"])
def test_shard_problem_equals_jax(name):
    args, shards = dist_scene(name)
    got = dist_ba.shard_problem(*args, n_shards=shards)
    want = jax_dist.shard_problem(*args, n_shards=shards)
    for field, g, w in zip(dist_ba.ShardedBA._fields, got, want):
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    if name == "unequal":  # padding exists
        assert got.obs_w.min() == 0 and (got.X_map < 0).any()


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    """One spawned gloo group of 4 CPU ranks runs every case."""
    from tests.torch_dist_worker import worker

    cases = {}
    for name in ("first_step", "unequal"):
        args, shards = dist_scene(name)
        cases[name] = ("step", dist_ba.shard_problem(*args, n_shards=shards), args[0].shape[0])
    args, shards = dist_scene("run")
    sp = dist_ba.shard_problem(*args, n_shards=shards)
    cases["run"] = ("run", sp, dict(max_iters=20))
    cases["run_huber"] = ("run", sp, dict(max_iters=20, huber_delta=HUBER))
    args, shards = dist_scene("debug")
    cases["debug"] = ("run", dist_ba.shard_problem(*args, n_shards=shards),
                      dict(max_iters=8, debug_checks=True))
    tmp = tmp_path_factory.mktemp("gloo")
    torch.multiprocessing.start_processes(worker, args=(4, str(tmp), cases, str(tmp)),
                                          nprocs=4, join=True, start_method="spawn")
    with open(tmp / "results.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("name", ["first_step", "unequal"])
def test_dist_first_step_equals_ba_step(gloo_results, name):
    args, _ = dist_scene(name)
    prob = ba.build_problem(*args, device="cpu")
    new, c_new, c_old = ba.ba_step(prob, 1e-3, 1e9, False)
    nR, nt, nX, nc, oc = gloo_results[name]
    assert oc == pytest.approx(float(c_old), rel=1e-5)
    assert nc == pytest.approx(float(c_new), rel=1e-3)
    close(nR, new.Rs, rtol=0, atol=1e-5)
    close(nt, new.ts, rtol=0, atol=1e-5)
    close(nX, new.X, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["run", "run_huber"])
def test_run_dist_ba_matches_jax(gloo_results, name):
    args, shards = dist_scene("run")
    huber = HUBER if name == "run_huber" else float("inf")
    c0 = float(ba.cost(ba.build_problem(*args, device="cpu")))
    mesh = Mesh(np.asarray(jax.devices()[:shards]), ("ba",))
    _, _, Xj, cj = jax_dist.run_dist_ba(jax_dist.shard_problem(*args, n_shards=shards), mesh,
                                         max_iters=20, huber_delta=huber)
    Rs, ts, X, c = gloo_results[name]
    assert c < c0 * 1e-3 and cj < c0 * 1e-3
    assert abs(c - cj) / max(cj, 1e-12) < 0.5
    assert X.shape == Xj.shape == args[2].shape and np.isfinite(X).all()
    assert Rs.shape == (5, 3, 3) and ts.shape == (5, 3)


def test_dist_debug_checks_clean(gloo_results):
    *_, c = gloo_results["debug"]
    assert np.isfinite(c)


@pytest.mark.parametrize("n_cams", [4, 6])
def test_dist_lm_iteration_volume_is_independent_of_points(n_cams, tmp_path):
    """One LM iteration of the point-sharded solver all-reduces the
    reduced camera system, O((6C)^2) floats, and its cost: the same
    bytes for 20 and 200 points (a group of one gloo rank, so the
    collectives run and are recorded)."""
    from patch2pix_tpu_torch.parallel import comm_stats, mesh

    volumes = []
    with mesh.process_group(1, 0, "gloo", str(tmp_path)) as group:
        for n_pts in (20, 200):
            Rs, ts, X, ci, pi, uv = make_scene(n_cams=n_cams, n_pts=n_pts, noise=1e-3, seed=5)
            sp = dist_ba.shard_problem(Rs, ts, X, ci, pi, uv, n_shards=1)
            step = dist_ba.make_dist_ba_step(n_cams, use_huber=False, group=group)
            with comm_stats.record_collectives() as stats:
                step(dist_ba.local_problem(sp, 0, "cpu"), 1e-3, 1e9)
            volumes.append(stats)
    c6 = 6 * n_cams
    assert volumes[0] == volumes[1] == {"all-reduce": {
        "count": 2, "bytes": 4 * (c6 * c6 + n_cams * 36 + c6) + 4 * 2}}
