"""The two Pallas prototypes in ``tools/`` against their counterparts in
the port.

  * B6, ``tools/try_tapsum_v2.tap_sum_v2``: B1's function in the v2
    layout (z as (9, HW, Np), the cells on the lane axis after a left pad
    of w1+1). Its counterpart is B1, ``tap_sum``; exact in float32 (the
    same nine float32 adds in tap order).
  * B7, ``tools/try_expand_kernels.build``: one level's one-sided,
    unscaled window expansion, whose plain references are ``ref_expand``
    there and ``_xla_expand_side`` in the package. Its counterpart is
    ``expand_level`` (a second entry point of the B3 source); a pure
    gather, so bit-identical. Its kernel's plan (``level_plan``: table
    and divisor constants, 16-byte units or flat runs, proposals a block)
    is held exactly: the kernel's index arithmetic, replayed in numpy with
    the plan's multiply-shifts, against a brute-force loop and the plain
    version.

Both prototypes run in Pallas interpret mode here. The kernels run only
on a CUDA card: tests/test_torch_card.py.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from patch2pix_tpu.ops.patch_expand_pallas import _xla_expand_side
from patch2pix_tpu_torch.ops.patch_expand import expand_level, expand_level_plain, level_plan
from patch2pix_tpu_torch.ops.tap_sum import tap_sum
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
PSIZE = 16
LEVELS = ((16, 3), (8, 64), (4, 64), (2, 128))


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("bs,h1,w1,h2,w2", [(2, 8, 8, 4, 8), (1, 5, 7, 8, 4)])
def test_b6_tap_sum_v2_matches_b1(bs, h1, w1, h2, w2):
    tool = _tool("try_tapsum_v2")
    n, hw = bs * h1 * w1, h2 * w2
    z = np.random.default_rng(n).standard_normal((n, 9, hw)).astype(np.float32)
    bias = np.float32(-0.625)
    p = w1 + 1
    p_right = (-(n + p)) % 128
    while p_right < p:
        p_right += 128
    zt = np.pad(z.transpose(1, 2, 0), ((0, 0), (0, 0), (p, p_right)))  # (9, HW, Np)
    want = np.asarray(tool.tap_sum_v2(jnp.asarray(zt), jnp.float32(bias), bs, h1, w1, p,
                                      interpret=True))
    got = tap_sum(torch.from_numpy(z), torch.tensor([bias]), bs, h1, w1)
    np.testing.assert_array_equal(got.numpy(), want.T)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,c", LEVELS)
def test_b7_expand_level_matches_tool_and_package(t, c, dtype):
    tool = _tool("try_expand_kernels")
    m = 5
    rng = np.random.default_rng(t * 1000 + c)
    rows = rng.standard_normal((m, 4, t, t * c)).astype(np.float32)
    y0, x0 = (rng.integers(0, 8 * PSIZE, (m,)).astype(np.int32) for _ in range(2))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    jrows = jnp.asarray(rows, jdt)
    before = expand_level.launches
    got = expand_level(torch.from_numpy(rows).to(tdt), torch.from_numpy(y0),
                       torch.from_numpy(x0), PSIZE)
    assert expand_level.launches == before
    assert got.dtype == tdt and tuple(got.shape) == (m, PSIZE, PSIZE, c)
    got = got.float().numpy()
    # the tool's rows are pre-interleaved superblocks (M, 2t, 2t*C)
    il = jrows.reshape(m, 2, 2, t, t * c).transpose(0, 1, 3, 2, 4).reshape(m, 2 * t, 2 * t * c)
    want_tool = tool.ref_expand(il, jnp.asarray(y0)[:, None], jnp.asarray(x0)[:, None],
                                PSIZE, t, c, m)
    want_pkg = _xla_expand_side(jrows, jnp.asarray(y0), jnp.asarray(x0), PSIZE, t, c)
    np.testing.assert_array_equal(got, np.asarray(want_tool, np.float32))
    np.testing.assert_array_equal(got, np.asarray(want_pkg, np.float32))


def test_b7_plain_is_b3s_expansion():
    """expand_level_plain is the per-level expansion inside B3's plain
    version: every channel equals the superblock cell it indexes."""
    t, c, m = 4, 3, 3
    rows = torch.arange(m * 4 * t * t * c, dtype=torch.float32).reshape(m, 4, t, t * c)
    y0 = torch.tensor([0, 7, 21], dtype=torch.int32)
    x0 = torch.tensor([3, 16, 40], dtype=torch.int32)
    e = expand_level_plain(rows, y0, x0, PSIZE)
    ds = PSIZE // t
    for mi in range(m):
        for p in (0, 5, 15):
            for q in (0, 9, 15):
                iy = (int(y0[mi]) + p) // ds - (int(y0[mi]) // PSIZE) * t
                ix = (int(x0[mi]) + q) // ds - (int(x0[mi]) // PSIZE) * t
                cell = rows[mi, (iy // t) * 2 + ix // t, iy % t, (ix % t) * c:(ix % t + 1) * c]
                assert torch.equal(e[mi, p, q], cell)


def _fdiv(x, f):
    """The kernel's x / d for 0 <= x < 2^31: (umulhi(x, m) + x) >> s."""
    x = np.asarray(x, np.uint64)
    return ((((x * np.uint64(f.m)) >> np.uint64(32)) + x) >> np.uint64(f.s)).astype(np.int64)


def _level_kernel_replayed(rows, y0, x0, psize, aligned):
    """expand_level_kernel's index arithmetic in numpy, step for step,
    with the plan's constants: the row and column tables, then each
    thread's 16-byte unit, or its flat 16-byte run (the values stepped
    through (p, q, channel) without division) and the unaligned head and
    tail of each proposal's output (torch.empty's base is aligned)."""
    m, _, t, tc = rows.shape
    c, elsize = tc // t, rows.dtype.itemsize
    pl = level_plan(psize, t, c, elsize, aligned)
    d = np.arange(psize)
    tabs = []
    for axis, base in enumerate((y0, x0)):
        b = np.maximum(base.astype(np.int64), 0)[:, None]
        cell = _fdiv(b - _fdiv(b, pl.by_psize) * psize + d, pl.by_ds)
        hi = (cell >= t).astype(np.int64)
        lo = cell - hi * t
        tabs.append((hi * t * t + lo) * c if axis else (2 * hi * t + lo) * t * c)
    rt, ct = tabs
    src = rows.reshape(m, -1)
    v, row = 16 // elsize, psize * pl.per_pixel
    n = psize * row
    out = np.zeros((m, psize * psize * c), rows.dtype)
    if pl.vec:
        k = np.arange(n)
        p = _fdiv(k, pl.by_row)
        q = _fdiv(k - p * row, pl.by_pixel)
        j = k - p * row - q * pl.per_pixel
        off = (rt[:, p] + ct[:, q] + j * v)[..., None] + np.arange(v)
        out[:] = np.take_along_axis(src, off.reshape(m, -1), axis=1)
        return out.reshape(m, psize, psize, c)
    for mi in range(m):
        head = min(n, (-(mi * n * elsize) % 16) // elsize)
        chunks = (n - head) // v
        e0 = head + np.arange(chunks) * v
        p = _fdiv(e0, pl.by_row)
        q = _fdiv(e0 - p * row, pl.by_pixel)
        ch = e0 - p * row - q * c
        for j in range(v):
            out[mi, e0 + j] = src[mi, rt[mi, p] + ct[mi, q] + ch]
            ch = ch + 1
            q = q + (ch == c)
            ch[ch == c] = 0
            p = p + (q == psize)
            q[q == psize] = 0
        e = np.r_[0:head, head + chunks * v:n]
        p = _fdiv(e, pl.by_row)
        q = _fdiv(e - p * row, pl.by_pixel)
        out[mi, e] = src[mi, rt[mi, p] + ct[mi, q] + e - p * row - q * c]
    return out.reshape(m, psize, psize, c)


@pytest.mark.parametrize("psize,t,c,elsize,aligned", [
    (16, 16, 3, 2, True),   # the prolog's image level, bf16: flat runs, 2 proposals a block
    (16, 16, 1, 4, True),   # the prolog's square-sum levels, float32: 4 proposals a block
    (16, 2, 1, 4, True),
    (16, 8, 64, 2, True),   # phase 2's levels: 16-byte units
    (16, 2, 128, 4, True),
    (16, 1, 8, 2, True),    # one unit a pixel
    (16, 4, 64, 2, False),  # rows off a 16-byte boundary: flat runs
    (16, 4, 5, 2, True),
    (6, 3, 5, 2, True),     # proposals' outputs off 16-byte boundaries: heads and tails
    (8, 4, 2, 4, True),
])
def test_b7_level_plan_replayed_matches_brute_force(psize, t, c, elsize, aligned):
    m = 7
    rng = np.random.default_rng(psize * 1000 + t * 10 + c)
    dt = np.int16 if elsize == 2 else np.int32
    rows = rng.integers(-2 ** 15, 2 ** 15, (m, 4, t, t * c)).astype(dt)
    # negative, 0, psize - 1 (a t + 1-cell window), the last tile of a
    # 1024-wide map's padded corners, and random
    y0 = np.array([-20, 0, psize - 1, 1024 + psize - 1, 5, 2 ** 20 + 3, psize],
                  np.int32)
    x0 = np.roll(y0, 3) + rng.integers(0, 2, m).astype(np.int32)
    got = _level_kernel_replayed(rows, y0, x0, psize, aligned)
    ds = psize // t
    want = np.empty_like(got)
    for mi in range(m):
        yc, xc = max(int(y0[mi]), 0), max(int(x0[mi]), 0)
        for p in range(psize):
            for q in range(psize):
                iy = (yc + p) // ds - (yc // psize) * t
                ix = (xc + q) // ds - (xc // psize) * t
                want[mi, p, q] = rows[mi, (iy // t) * 2 + ix // t, iy % t,
                                      (ix % t) * c:(ix % t + 1) * c]
    np.testing.assert_array_equal(got, want)
    plain = expand_level_plain(torch.from_numpy(rows), torch.from_numpy(y0),
                               torch.from_numpy(x0), psize)
    np.testing.assert_array_equal(plain.numpy(), want)


def test_b7_level_plan_layout():
    """16-byte units where a cell is whole units and the rows aligned;
    small outputs share a block (the prolog's levels); bad shapes raise."""
    for (t, c, elsize, aligned), (vec, per_pixel, per_block) in {
            (8, 64, 2, True): (1, 8, 1), (2, 128, 4, True): (1, 32, 1),
            (4, 64, 2, False): (0, 64, 1), (16, 3, 2, True): (0, 3, 2),
            (16, 1, 4, True): (0, 1, 4), (1, 256, 2, True): (1, 32, 1),
            (16, 2, 2, True): (0, 2, 4), (16, 1, 2, True): (0, 1, 8)}.items():
        pl = level_plan(16, t, c, elsize, aligned)
        assert (pl.vec, pl.per_pixel, pl.per_block) == (vec, per_pixel, per_block)
        assert pl.per_block * 16 * 16 * c * elsize <= 16 * 256 or pl.per_block == 1
    for bad in ((16, 3, 3, 2), (16, 0, 3, 2), (16, 4, 3, 8), (16, 2, 2 ** 29, 4)):
        with pytest.raises(ValueError):
            level_plan(*bad, True)
