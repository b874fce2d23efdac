"""The port's geometry and SfM solvers against the JAX package's, on the CPU.

  * the pose helpers of ``ops/geometry.py`` (rtol 1e-5 against the
    largest entry), one at a time and over a batch;
  * ``sfm/twoview.py``: ``eight_point`` up to sign, ``sampson_epipolar``,
    ``triangulate``, ``decompose_essential`` as a set of four poses,
    ``refine_pose_gn``;
  * ``five_point`` on 20 seeded samples: the sets of valid E, each
    within 1e-3 after unit norm and a sign fix (the null-space basis,
    and so the slot order and which close root pairs the grid misses,
    is not unique: see the test);
  * the three RANSACs (5-point, 8-point, PnP) at N = 200 with 30%
    outliers, fed JAX's own sample ids (the JAX expression on the same
    key): inlier masks equal but for <= 1% of rows, R within 1e-3 rad, t
    direction within 1e-3 rad; and degenerate inputs (0, 3 or 5 valid
    rows in a 64-row bucket, a collinear point set), where neither
    raises; the pixel front ends on the port's own draws;
  * the COLMAP model (files byte-equal both ways, read back equal; the
    port's text reader keeps an image's empty points line, which JAX's
    drops), database, overlap and NVM readers; ``measure.py`` to 1e-12.

Each JAX RANSAC is jitted once per shape, so each shape's JAX result is
computed once for the file.
"""

import functools
import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patch2pix_tpu.data import colmap_db as jax_db
from patch2pix_tpu.data import colmap_model as jax_cm
from patch2pix_tpu.data import nvm as jax_nvm
from patch2pix_tpu.data import overlap as jax_ov
from patch2pix_tpu.evaluation import measure as jax_measure
from patch2pix_tpu.ops import geometry as jax_geo
from patch2pix_tpu.sfm import fivepoint as jax_fp
from patch2pix_tpu.sfm import pnp as jax_pnp
from patch2pix_tpu.sfm import twoview as jax_tv
from patch2pix_tpu_torch.data import colmap_db, colmap_model, nvm, overlap
from patch2pix_tpu_torch.data.synthetic import rot_xyz
from patch2pix_tpu_torch.evaluation import measure
from patch2pix_tpu_torch.ops import geometry
from patch2pix_tpu_torch.sfm import fivepoint, pnp, twoview
from tests.test_colmap_io import synthetic_model
from tests.test_nvm import nvm_file  # noqa: F401
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

N = 200


def t32(a):
    return torch.from_numpy(np.array(a, np.float32))


def rot_err(Ra, Rb):
    """Angle (rad) of Ra^T Rb, by atan2 (accurate at small angles)."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    s = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]]) / 2
    return float(np.arctan2(s, (np.trace(M) - 1) / 2))


def dir_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.arctan2(np.linalg.norm(np.cross(a, b)), np.dot(a, b)))


def jax_ids(key, valid, n_samples, k):
    """JAX's sample ids: the expression inside its RANSACs on ``key``."""
    valid = jnp.asarray(valid)
    keys = jax.random.split(key, n_samples)

    def one(kk):
        r = jax.random.uniform(kk, (valid.shape[0],))
        return jnp.argsort(jnp.where(valid, r, 2.0))[:k]

    return torch.from_numpy(np.asarray(jax.vmap(one)(keys)).astype(np.int64))


def two_view_scene(seed, n, noise=0.0, outliers=0.0):
    """Normalized correspondences of random points under a random (R, t),
    the first ``outliers * n`` of p2 replaced by uniform draws."""
    rng = np.random.default_rng(seed)
    R = rot_xyz(*rng.uniform(-0.3, 0.3, 3))
    t = rng.uniform(-1, 1, 3)
    t /= np.linalg.norm(t)
    X = rng.uniform([-1, -1, 3], [1, 1, 8], (n, 3))
    p1 = X[:, :2] / X[:, 2:]
    Xc = X @ R.T + t
    p2 = Xc[:, :2] / Xc[:, 2:]
    p1 = p1 + rng.normal(0, noise, p1.shape)
    p2 = p2 + rng.normal(0, noise, p2.shape)
    n_out = int(outliers * n)
    p2[:n_out] = rng.uniform(-0.5, 0.5, (n_out, 2))
    return p1.astype(np.float32), p2.astype(np.float32), R, t


# ---------------------------------------------------------------- pose helpers


def _pose_inputs(rng):
    q1, q2 = rng.normal(size=4), rng.normal(size=4)
    R = np.asarray(jax_geo.quat2rot(jnp.asarray(q1, jnp.float32)))
    K1 = np.array([[600.0, 0, 320], [0, 610, 240], [0, 0, 1]], np.float32)
    K2 = np.array([[500.0, 0, 300], [0, 505, 200], [0, 0, 1]], np.float32)
    return dict(v=rng.normal(size=3), t=rng.normal(size=3), R=R, K1=K1, K2=K2,
                E=rng.normal(size=(3, 3)), F=rng.normal(size=(3, 3)) * 1e-5, q=q1, q2=q2,
                c1=rng.normal(size=3), c2=rng.normal(size=3))


HELPERS = {
    "skew": ("v",),
    "pose2ess": ("R", "t"),
    "ess2fund": ("K1", "K2", "E"),
    "fund2ess": ("F", "K2", "K1"),
    "pose2fund": ("K1", "K2", "R", "t"),
    "quat2rot": ("q",),
    "rot2quat": ("R",),
    "abs2relapose": ("c1", "c2", "q", "q2"),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_pose_helpers_equal_jax(name):
    """Each helper on 4 seeded inputs, then the 4 as one batch."""
    inputs = [_pose_inputs(np.random.default_rng(s)) for s in range(4)]
    wants, gots = [], []
    for inp in inputs:
        args = [np.asarray(inp[k], np.float32) for k in HELPERS[name]]
        want = getattr(jax_geo, name)(*map(jnp.asarray, args))
        got = getattr(geometry, name)(*map(t32, args))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        wants.append([np.asarray(w) for w in want])
        gots.append([g.numpy() for g in got])
        for w, g in zip(wants[-1], gots[-1]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
    batched = getattr(geometry, name)(
        *[t32(np.stack([inp[k] for inp in inputs])) for k in HELPERS[name]])
    batched = batched if isinstance(batched, tuple) else (batched,)
    for i, b in enumerate(batched):
        np.testing.assert_allclose(b.numpy(), np.stack([g[i] for g in gots]), rtol=1e-6,
                                   atol=1e-6 * np.abs(b.numpy()).max())


# ---------------------------------------------------------------- twoview pieces


def test_twoview_pieces_equal_jax():
    p1, p2, R, t = two_view_scene(0, 40, noise=1e-3)
    E_j = np.asarray(jax_tv.eight_point(jnp.asarray(p1), jnp.asarray(p2)))
    E_t = twoview.eight_point(t32(p1), t32(p2)).numpy()
    sign = np.sign(np.sum(E_j * E_t))
    np.testing.assert_allclose(sign * E_t, E_j, atol=1e-4)
    w = np.random.default_rng(1).uniform(0, 1, 40).astype(np.float32)
    E_jw = np.asarray(jax_tv.eight_point(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w)))
    E_tw = twoview.eight_point(t32(p1), t32(p2), t32(w)).numpy()
    np.testing.assert_allclose(np.sign(np.sum(E_jw * E_tw)) * E_tw, E_jw, atol=1e-4)

    d_j = np.asarray(jax_tv.sampson_epipolar(jnp.asarray(p1), jnp.asarray(p2), E_j))
    d_t = twoview.sampson_epipolar(t32(p1), t32(p2), t32(E_j)).numpy()
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-12)

    R32, t32_ = R.astype(np.float32), t.astype(np.float32)
    X_j = np.asarray(jax_tv.triangulate(jnp.eye(3), jnp.zeros(3), jnp.asarray(R32),
                                        jnp.asarray(t32_), jnp.asarray(p1), jnp.asarray(p2)))
    X_t = twoview.triangulate(torch.eye(3), torch.zeros(3), t32(R32), t32(t32_), t32(p1),
                              t32(p2)).numpy()
    np.testing.assert_allclose(X_t, X_j, rtol=1e-4, atol=1e-4)

    Rs_j, ts_j = map(np.asarray, jax_tv.decompose_essential(jnp.asarray(E_j)))
    Rs_t, ts_t = (x.numpy() for x in twoview.decompose_essential(t32(E_j)))
    for Rj, tj in zip(Rs_j, ts_j):  # the same four poses, in any order
        assert min(np.abs(Rt - Rj).max() + np.abs(tt - tj).max()
                   for Rt, tt in zip(Rs_t, ts_t)) < 1e-4

    R0 = (rot_xyz(0.01, -0.02, 0.015) @ R).astype(np.float32)
    t0 = (t + np.array([0.03, -0.02, 0.01])).astype(np.float32)
    t0 /= np.linalg.norm(t0)
    w = np.ones(40, np.float32)
    Rg_j, tg_j = jax_tv.refine_pose_gn(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(p1),
                                       jnp.asarray(p2), jnp.asarray(w), robust_scale=1e-3)
    Rg_t, tg_t = twoview.refine_pose_gn(t32(R0), t32(t0), t32(p1), t32(p2), t32(w),
                                        robust_scale=1e-3)
    assert rot_err(Rg_j, Rg_t.numpy()) < 1e-4 and dir_err(tg_j, tg_t.numpy()) < 1e-4
    assert rot_err(R, Rg_t.numpy()) < rot_err(R, R0)


def _canonical(Es, valid):
    """Valid essential matrices at unit norm, the largest entry positive."""
    out = []
    for E, ok in zip(np.asarray(Es, np.float64), np.asarray(valid)):
        if ok:
            E = E / np.linalg.norm(E)
            out.append(E * np.sign(E.flat[np.argmax(np.abs(E))]))
    return out


def _solves(E, p1, p2):
    """E (unit norm) satisfies the 10 cubic constraints and the 5
    epipolar equations to float32 precision."""
    h1, h2 = np.c_[p1, np.ones(5)], np.c_[p2, np.ones(5)]
    cubic = 2 * E @ E.T @ E - np.trace(E @ E.T) * E
    return (np.abs(np.sum((h1 @ E.T) * h2, 1)).max() < 1e-4 and abs(np.linalg.det(E)) < 1e-4
            and np.abs(cubic).max() < 1e-4)


def test_five_point_same_solution_sets_as_jax():
    """Both sides find the real roots of det B(z) as sign changes on one
    theta grid, so two roots in one grid cell are missed together; which
    roots share a cell depends on the null-space basis, which each SVD
    picks differently. So per sample: every solution either side returns
    solves the sample; the smaller set lies in the larger within 1e-3; the
    sizes differ by 0 or one such pair; on these 20 samples the sets are
    equal on at least 15."""
    samples = [two_view_scene(100 + s, 5) for s in range(20)]
    p1 = np.stack([s[0] for s in samples])
    p2 = np.stack([s[1] for s in samples])
    Es_j, v_j = jax.jit(jax.vmap(jax_fp.five_point))(jnp.asarray(p1), jnp.asarray(p2))
    Es_t, v_t = fivepoint.five_point(t32(p1), t32(p2))
    assert Es_t.shape == (20, 10, 3, 3) and v_t.shape == (20, 10)
    same = 0
    for s, (a, b, R, t) in enumerate(samples):
        want, got = _canonical(Es_j[s], v_j[s]), _canonical(Es_t[s], v_t[s])
        assert all(_solves(E, a, b) for E in want + got), s
        small, large = sorted((want, got), key=len)
        assert len(large) - len(small) in (0, 2), s
        for E in small:
            assert min(np.abs(G - E).max() for G in large) < 1e-3, s
        same += len(want) == len(got)
        # the sample's true E is among the port's solutions
        E = geometry.skew(torch.from_numpy(t)).numpy() @ R
        E = E / np.linalg.norm(E)
        E = E * np.sign(E.flat[np.argmax(np.abs(E))])
        assert min(np.abs(G - E).max() for G in got) < 1e-3, s
    assert same >= 15, same


# ---------------------------------------------------------------- RANSAC with JAX's ids


@functools.lru_cache(maxsize=None)
def _essential_case():
    p1, p2, R, t = two_view_scene(7, N, noise=5e-4, outliers=0.3)
    return p1, p2, R, t, jax.random.PRNGKey(11)


@functools.lru_cache(maxsize=None)
def _pnp_case():
    rng = np.random.default_rng(8)
    X = rng.uniform([-1, -1, 3], [1, 1, 8], (N, 3)).astype(np.float32)
    R = rot_xyz(*rng.uniform(-0.3, 0.3, 3))
    t = rng.uniform(-0.5, 0.5, 3)
    pc = X @ R.T + t
    p = pc[:, :2] / pc[:, 2:] + rng.normal(0, 3e-4, (N, 2))
    p[:int(0.3 * N)] = rng.uniform(-0.5, 0.5, (int(0.3 * N), 2))
    return X, p.astype(np.float32), R, t, jax.random.PRNGKey(12)


RANSACS = {
    # name: (JAX function, port function, sample size, hypotheses, threshold, case)
    "5pt": (jax_fp.ransac_essential_5pt, fivepoint.ransac_essential_5pt, 5, 256, 1e-5,
            _essential_case),
    "8pt": (jax_tv.ransac_essential, twoview.ransac_essential, 8, 512, 1e-5,
            _essential_case),
    "pnp": (jax_pnp.ransac_pnp, pnp.ransac_pnp, 6, 256, 1e-5, _pnp_case),
}


@pytest.mark.parametrize("name", sorted(RANSACS))
def test_ransac_with_jax_sample_ids_equals_jax(name):
    jax_fn, port_fn, k, n, thres, case = RANSACS[name]
    a, b, R, t, key = case()
    want = jax_fn(key, jnp.asarray(a), jnp.asarray(b), n, thres)
    ids = jax_ids(key, np.ones(N, bool), n, k)
    got = port_fn(None, t32(a), t32(b), n, thres, ids=ids)
    differ = int(np.sum(np.asarray(want.inliers) != got.inliers.numpy()))
    assert differ <= N // 100, differ
    assert int(got.num_inliers) == int(got.inliers.sum()) >= 0.6 * N
    assert rot_err(want.R, got.R.numpy()) < 1e-3
    assert dir_err(want.t, got.t.numpy()) < 1e-3
    assert rot_err(R, got.R.numpy()) < np.radians(1.0)
    # the port's own draws find the same pose
    own = port_fn(torch.Generator().manual_seed(0), t32(a), t32(b), n, thres)
    assert rot_err(R, own.R.numpy()) < np.radians(1.0)
    assert dir_err(t, own.t.numpy()) < np.radians(2.0)


def _bucket(n_valid, collinear=False):
    p1, p2, _, _, _ = _essential_case()
    if collinear:  # points on one 3D line: collinear in both views
        s = np.linspace(-1, 1, n_valid)[:, None]
        X = np.array([0.1, -0.2, 4.0]) + s * np.array([0.5, 0.3, 1.0])
        R, t = rot_xyz(0.1, -0.05, 0.02), np.array([0.3, 0.1, 0.05])
        Xc = X @ R.T + t
        p1 = (X[:, :2] / X[:, 2:]).astype(np.float32)
        p2 = (Xc[:, :2] / Xc[:, 2:]).astype(np.float32)
    q1, q2 = np.zeros((64, 2), np.float32), np.zeros((64, 2), np.float32)
    q1[:n_valid], q2[:n_valid] = p1[:n_valid], p2[:n_valid]
    valid = np.arange(64) < n_valid
    return q1, q2, valid


@pytest.mark.parametrize("n_valid,collinear", [(0, False), (3, False), (5, False),
                                               (12, True)],
                         ids=["n0", "n3", "n5", "collinear"])
def test_ransac_5pt_degenerate_inputs_do_not_raise(n_valid, collinear):
    """Fewer valid rows than a sample, or a point set on one line: JAX runs
    through, so the port runs through too. Where JAX's pose is finite (n =
    0, n = 5) the inlier counts are equal. At n = 3 (a sample holds two
    copies of the zero padding row, so its null space has five
    dimensions and each SVD returns a different four of them) and on the
    line, the solutions are not determined: JAX's Gauss-Newton polish
    meets a rank-deficient 5x5 system whose 1e-9 damping is below float32
    resolution, its LU an exactly zero pivot, and its pose is NaN with no
    inliers; the port's pose comes from other hypotheses. There only the
    validity of the port's inliers is held."""
    q1, q2, valid = _bucket(n_valid, collinear)
    key = jax.random.PRNGKey(5)
    want = jax_fp.ransac_essential_5pt(key, jnp.asarray(q1), jnp.asarray(q2), 256, 1e-5,
                                       jnp.asarray(valid))
    got = fivepoint.ransac_essential_5pt(None, t32(q1), t32(q2), 256, 1e-5,
                                         torch.from_numpy(valid),
                                         ids=jax_ids(key, valid, 256, 5))
    assert not got.inliers.numpy()[~valid].any()
    if np.isfinite(np.asarray(want.R)).all():
        assert int(got.num_inliers) == int(want.num_inliers)
    else:
        assert n_valid in (3, 12) and int(want.num_inliers) == 0
    own = fivepoint.ransac_essential_5pt(torch.Generator().manual_seed(1), t32(q1), t32(q2),
                                         256, 1e-5, torch.from_numpy(valid))
    assert own.R.shape == (3, 3) and not own.inliers.numpy()[~valid].any()


# ---------------------------------------------------------------- COLMAP, NVM, measures


def _port_model(model):
    cams, ims, pts = model
    return ({k: colmap_model.Camera(c.id, c.model, c.width, c.height, c.params)
             for k, c in cams.items()},
            {k: colmap_model.ImagePose(i.id, i.qvec, i.tvec, i.camera_id, i.name, i.xys,
                                       i.point3D_ids) for k, i in ims.items()},
            {k: colmap_model.Point3D(p.id, p.xyz, p.rgb, p.error, p.image_ids,
                                     p.point2D_idxs) for k, p in pts.items()})


def _same_model(a, b):
    for da, db in zip(a, b):
        assert da.keys() == db.keys()
        for k in da:
            for f, v in vars(da[k]).items():
                w = getattr(db[k], f)
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(v, w)
                else:
                    assert v == w, (k, f)


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_colmap_model_io_equals_jax(tmp_path, ext):
    model = synthetic_model(n_ims=4, n_pts=12, seed=3)
    jax_cm.write_model(*model, str(tmp_path / "jax"), ext=ext)
    colmap_model.write_model(*_port_model(model), str(tmp_path / "port"), ext=ext)
    for f in ("cameras", "images", "points3D"):
        assert ((tmp_path / "jax" / f"{f}{ext}").read_bytes()
                == (tmp_path / "port" / f"{f}{ext}").read_bytes())
    _same_model(colmap_model.read_model(str(tmp_path / "jax"), ext=ext), _port_model(model))
    if ext == ".bin":
        _same_model(jax_cm.read_model(str(tmp_path / "port"), ext=ext), model)
    else:
        # image 1 has no observations: its points line is empty, which the
        # JAX package's text reader drops (it then misreads the next line)
        assert len(model[1][1].point3D_ids) == 0
        with pytest.raises(ValueError):
            jax_cm.read_model(str(tmp_path / "port"), ext=ext)
    for q in np.random.default_rng(0).normal(size=(5, 4)):
        R = colmap_model.qvec2rotmat(q)
        np.testing.assert_array_equal(R, jax_cm.qvec2rotmat(q))
        np.testing.assert_array_equal(colmap_model.rotmat2qvec(R), jax_cm.rotmat2qvec(R))
    for cam in model[0].values():
        np.testing.assert_array_equal(_port_model(model)[0][cam.id].K, cam.K)


def test_overlap_and_database_equal_jax(tmp_path):
    model = synthetic_model(n_ims=6, n_pts=20, seed=4)
    for d in ("jax", "port"):
        jax_cm.write_model(*model, str(tmp_path / d))
    ims = model[1]
    want, got = jax_ov.cal_overlap_scores(list(ims), ims), overlap.cal_overlap_scores(
        list(ims), _port_model(model)[1])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    thresholds = [0.0, 0.1, 0.3]
    assert (overlap.model_multi_ov_pairs(str(tmp_path / "port"), thresholds)
            == jax_ov.model_multi_ov_pairs(str(tmp_path / "jax"), thresholds))
    a = np.load(tmp_path / "port" / "ov_pairs.npy", allow_pickle=True).item()
    assert a == np.load(tmp_path / "jax" / "ov_pairs.npy", allow_pickle=True).item()
    scene = {n: (im.name, im.K.tolist(), im.c.tolist(), im.q.tolist(), im.id)
             for n, im in jax_ov.load_model_ims(str(tmp_path / "jax")).items()}
    assert scene == {n: (im.name, im.K.tolist(), im.c.tolist(), im.q.tolist(), im.id)
                     for n, im in overlap.load_model_ims(str(tmp_path / "port")).items()}

    db_path = str(tmp_path / "test.db")
    conn = sqlite3.connect(db_path)
    conn.execute("CREATE TABLE images (image_id INTEGER, name TEXT, camera_id INTEGER)")
    conn.execute("CREATE TABLE cameras (camera_id INTEGER, model INTEGER, width INTEGER,"
                 " height INTEGER, params BLOB, prior_focal_length INTEGER)")
    conn.execute("CREATE TABLE keypoints (image_id INTEGER, rows INTEGER, cols INTEGER, "
                 "data BLOB)")
    conn.execute("CREATE TABLE matches (pair_id INTEGER, rows INTEGER, cols INTEGER, "
                 "data BLOB)")
    rng = np.random.default_rng(0)
    for i, name in ((1, "a.jpg"), (2, "b.jpg"), (3, "c.jpg")):
        conn.execute("INSERT INTO images VALUES (?, ?, 1)", (i, name))
        kp = rng.uniform(0, 100, (5, 6)).astype(np.float32)
        conn.execute("INSERT INTO keypoints VALUES (?, 5, 6, ?)", (i, kp.tobytes()))
    conn.execute("INSERT INTO cameras VALUES (1, 2, 640, 480, ?, 0)",
                 (np.array([500.0, 320, 240, -0.01]).tobytes(),))
    for a, b in ((1, 2), (3, 2)):
        m = rng.integers(0, 5, (3, 2)).astype(np.uint32)
        conn.execute("INSERT INTO matches VALUES (?, 3, 2, ?)",
                     (colmap_db.image_ids_to_pair_id(a, b), m.tobytes()))
    conn.commit()
    conn.close()
    assert colmap_db.image_ids_to_pair_id(7, 3) == jax_db.image_ids_to_pair_id(7, 3)
    assert colmap_db.pair_id_to_image_ids(2147483655) == jax_db.pair_id_to_image_ids(
        2147483655)
    dj, dt = jax_db.ColmapDatabase(db_path), colmap_db.ColmapDatabase(db_path)
    try:
        assert dt.load_images() == dj.load_images()
        assert dt.load_images(name_based=True) == dj.load_images(name_based=True)
        for k, v in dj.load_cameras().items():
            got = dt.load_cameras()[k]
            np.testing.assert_array_equal(got.pop("params"), v.pop("params"))
            assert got == v
        for load in ("load_keypoints", "load_matches"):
            want, got = getattr(dj, load)(), getattr(dt, load)()
            assert want.keys() == got.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        pairs = [(1, 2), (2, 3)]
        want, got = dj.load_pair_matches(pairs), dt.load_pair_matches(pairs)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    finally:
        dj.close()
        dt.close()
    names = [("a.jpg", "b.jpg"), ("c.jpg", "b.jpg")]
    want, got = jax_ov.load_colmap_matches(db_path, names), overlap.load_colmap_matches(
        db_path, names)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_nvm_readers_equal_jax(nvm_file, tmp_path):  # noqa: F811
    from types import SimpleNamespace

    assert nvm.parse_3d_points_from_nvm(nvm_file) == jax_nvm.parse_3d_points_from_nvm(
        nvm_file)
    assert nvm.parse_nvm_focals(nvm_file) == jax_nvm.parse_nvm_focals(nvm_file)
    poses = tmp_path / "poses.txt"
    poses.write_text("h\nh\nh\nim1.png 1.0 2.0 3.0 1.0 0.0 0.0 0.0\n"
                     "im2.png 4.0 5.0 6.0 0.0 1.0 0.0 0.0\n")
    for (kw, (cw, qw)), (kg, (cg, qg)) in zip(jax_nvm.parse_abs_pose_txt(str(poses)).items(),
                                              nvm.parse_abs_pose_txt(str(poses)).items()):
        assert kw == kg
        np.testing.assert_array_equal(cg, cw)
        np.testing.assert_array_equal(qg, qw)
    _, cam_points = nvm.parse_3d_points_from_nvm(nvm_file)
    rng = np.random.default_rng(0)
    ims = [SimpleNamespace(name=f"seq1/frame{i + 1}.png", K=np.eye(3), c=rng.normal(size=3),
                           q=rng.normal(size=4)) for i in range(3)]
    want = jax_nvm.get_positive_pairs(cam_points, ims, 0.15, 0.99)
    got = nvm.get_positive_pairs(cam_points, ims, 0.15, 0.99)
    assert len(want) == len(got) > 0
    for w, g in zip(want, got):
        assert (w.im1, w.im2, w.overlap) == (g.im1, g.im2, g.overlap)
        for f in ("K1", "K2", "t", "q", "R"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


def test_measures_equal_jax():
    rng = np.random.default_rng(3)
    pts1, pts2 = rng.uniform(0, 640, (50, 2)), rng.uniform(0, 480, (50, 2))
    F = rng.normal(size=(3, 3))
    for fn, args in (("sampson_distance", (pts1, pts2, F)),
                     ("symmetric_epipolar_distance", (pts1, pts2, F)),
                     ("vec_angle_error", (rng.normal(size=(5, 3)), rng.normal(size=(5, 3)))),
                     ("quat_angle_error", (rng.normal(size=(5, 4)), rng.normal(size=(5, 4)))),
                     ("rot_angle_error", (rot_xyz(0.1, 0.2, 0.3), rot_xyz(0.2, 0.1, 0.0)))):
        np.testing.assert_allclose(getattr(measure, fn)(*args),
                                   getattr(jax_measure, fn)(*args), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(measure.symmetric_epipolar_distance(pts1, pts2, F, sqrt=True),
                               jax_measure.symmetric_epipolar_distance(pts1, pts2, F, True),
                               rtol=1e-12)
    dists = [rng.uniform(0, 100, n) for n in (10, 0, 30)]
    assert (measure.inlier_distance_histogram(dists, tag="x")
            == jax_measure.inlier_distance_histogram(dists, tag="x"))


@pytest.mark.parametrize("name", ["5pt", "8pt"])
def test_pixel_front_ends_recover_the_pose(name):
    """``estimate_relative_pose_5pt`` / ``estimate_relative_pose`` on pixel
    matches (JAX's ``test_estimate_relative_pose_5pt_pixel_frontend``
    scene): the threshold in focal-normalized units, the pose within 1
    deg (t 2 deg) of the truth with the port's own draws."""
    p1, p2, R, t = two_view_scene(4, 120, noise=3e-4)
    K = np.array([[600.0, 0, 320], [0, 600, 240], [0, 0, 1]], np.float32)
    matches = np.concatenate([p1 * 600 + [320, 240], p2 * 600 + [320, 240]], axis=1)
    fn = (fivepoint.estimate_relative_pose_5pt if name == "5pt"
          else twoview.estimate_relative_pose)
    res = fn(torch.Generator().manual_seed(0), t32(matches), t32(K), t32(K), px_thres=1.0)
    assert rot_err(R, res.R.numpy()) < np.radians(1.0)
    assert dir_err(t, res.t.numpy()) < np.radians(2.0)
    assert int(res.num_inliers) > 100
