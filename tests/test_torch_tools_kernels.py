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
    gather, so bit-identical.

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
from patch2pix_tpu_torch.ops.patch_expand import expand_level, expand_level_plain
from patch2pix_tpu_torch.ops.tap_sum import tap_sum

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
