"""The port's fused fine-stage head (kernel B5 and its prolog) against
``patch2pix_tpu.ops.fine_stage_pallas``, float32, and against the port's
own unfused path (B3 + ``FeatRegressNet.forward``).

On the CPU ``fused_fine_head`` runs its plain version, held against
``fused_fine_head_pallas`` in interpret mode at F=64 with the JAX test's
tolerance (rtol/atol 2e-4: conv taps and segments are summed in another
order). ``head_prolog`` against ``head_prolog_xla``: ``inv`` to rtol 1e-6
(square-sums added in another order), ``partial0`` to atol 1e-5.
``segment_weights`` and ``bn_affine`` are exact, and so is the bf16
kernels' K layout (``head_chunks`` + ``kmajor_weights``) against the
per-segment convs, up to float32 summation order. The kernels themselves
run only on a CUDA card: tests/test_torch_card.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from patch2pix_tpu.ops.fine_stage_pallas import (
    _segment_weights,
    fused_fine_head_pallas,
    head_prolog_xla,
)
from patch2pix_tpu.ops.fine_stage_pallas import bn_affine as jax_bn_affine
from patch2pix_tpu_torch.models.regressor import FeatRegressNet
from patch2pix_tpu_torch.ops.fine_stage import (
    _conv_taps,
    bn_affine,
    fused_fine_head,
    fused_fine_stage,
    head_chunks,
    head_prolog,
    kmajor_weights,
    segment_weights,
)
from patch2pix_tpu_torch.ops.patch_expand import expand_scale_pair_plain, output_slice_map
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

LEVELS = ((16, 3), (8, 64), (4, 64), (2, 128))
CS = tuple(c for _, c in LEVELS)
PSIZE = 16
F = 64


def _inputs(seed, m):
    rng = np.random.default_rng(seed)
    rows = [[rng.standard_normal((m, 4, t, t * c)).astype(np.float32) for t, c in LEVELS]
            for _ in range(2)]
    corners = [rng.integers(0, 2 * PSIZE, (m,)).astype(np.int32) for _ in range(4)]
    d = sum(CS)
    k0 = (rng.standard_normal((3, 3, 2 * d, F)) * 0.05).astype(np.float32)
    k1 = (rng.standard_normal((3, 3, F, F)) * 0.05).astype(np.float32)
    bn = [(rng.uniform(0.5, 1.5, F).astype(np.float32),
           rng.uniform(-0.2, 0.2, F).astype(np.float32)) for _ in range(2)]
    return rows, corners, k0, k1, bn


def T(a):
    return torch.from_numpy(np.array(a))


def test_segment_weights_and_bn_affine_match_jax():
    _, _, k0, _, _ = _inputs(0, 1)
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = segment_weights(T(k0), CS, dtype)
        want = _segment_weights(jnp.asarray(k0), CS, jdt)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.dtype == dtype and tuple(g.shape) == w.shape
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
    rng = np.random.default_rng(1)
    scale, bias, mean = (rng.standard_normal(F).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 1.5, F).astype(np.float32)
    for g, w in zip(bn_affine(T(scale), T(bias), T(mean), T(var)),
                    jax_bn_affine(*(jnp.asarray(a) for a in (scale, bias, mean, var)))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_head_prolog_matches_jax():
    rows, corners, k0, _, _ = _inputs(2, 6)
    got = head_prolog([T(r) for r in rows[0]], [T(r) for r in rows[1]],
                      *(T(c) for c in corners), T(k0), PSIZE, torch.float32)
    want = head_prolog_xla([jnp.asarray(r) for r in rows[0]], [jnp.asarray(r) for r in rows[1]],
                           *(jnp.asarray(c) for c in corners), jnp.asarray(k0), PSIZE,
                           jnp.float32)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    assert tuple(got[2].shape) == want[2].shape == (6, PSIZE // 2, PSIZE // 2, F)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-5)


def test_fused_head_plain_matches_pallas_interpret():
    m = 8
    rows, corners, k0, k1, bn = _inputs(3, m)
    jrows = [[jnp.asarray(r) for r in side] for side in rows]
    jc = [jnp.asarray(c) for c in corners]
    inv1, inv2, partial0 = head_prolog_xla(*jrows, *jc, jnp.asarray(k0), PSIZE, jnp.float32)
    w0 = tuple(_segment_weights(jnp.asarray(k0), CS, jnp.float32))
    jbn = [tuple(jnp.asarray(a) for a in pair) for pair in bn]
    want = fused_fine_head_pallas(
        tuple(jrows[0][1:]), tuple(jrows[1][1:]), *jc, inv1, inv2, partial0, w0,
        jnp.asarray(k1).reshape(9, F, F), jbn[0], jbn[1], PSIZE, jnp.float32, 8, True)
    before = fused_fine_head.launches
    got = fused_fine_head(
        [T(r) for r in rows[0][1:]], [T(r) for r in rows[1][1:]], *(T(c) for c in corners),
        T(inv1), T(inv2), T(partial0), [T(w) for w in w0], T(k1).reshape(9, F, F),
        tuple(T(a) for a in bn[0]), tuple(T(a) for a in bn[1]), PSIZE, torch.float32)
    assert fused_fine_head.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, F)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def _regressor(seed, dtype):
    net = FeatRegressNet(feat_dim=sum(CS), conv_dims=(F, F), fc_dims=(32, 16),
                         dtype=dtype, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (0.05 if p.ndim > 1 else 0.3))
        for name, b in net.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=gen) * 0.1)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    return net.eval()


def test_fused_matches_unfused_regressor_f32():
    """Fused (prolog + B5 + fc_head) against B3 + FeatRegressNet.forward,
    float32: pooled features rtol/atol 2e-4, (M, 5) outputs atol 2e-4."""
    m = 6
    rows, corners, _, _, _ = _inputs(4, m)
    net = _regressor(0, torch.float32)
    r1, r2 = [T(r) for r in rows[0]], [T(r) for r in rows[1]]
    cs = [T(c) for c in corners]
    with torch.no_grad():
        pooled, out = fused_fine_stage(net, r1, r2, *cs, PSIZE)
        patches = expand_scale_pair_plain(r1, r2, *cs, PSIZE, torch.float32)
        smap = output_slice_map([PSIZE // t for t, _ in LEVELS], CS, PSIZE)
        want_pooled = net.pooled(patches, None, slice_map=smap)
        want = net(patches, None, slice_map=smap)
    np.testing.assert_allclose(pooled.numpy(), want_pooled.numpy(), rtol=2e-4, atol=2e-4)
    assert tuple(out.shape) == (m, 5)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_regressor_forward_is_fc_head_of_pooled(dtype):
    rows, corners, _, _, _ = _inputs(5, 3)
    net = _regressor(1, dtype)
    r1 = [T(r).to(dtype) for r in rows[0]]
    r2 = [T(r).to(dtype) for r in rows[1]]
    with torch.no_grad():
        patches = expand_scale_pair_plain(r1, r2, *(T(c) for c in corners), PSIZE, dtype)
        smap = output_slice_map([PSIZE // t for t, _ in LEVELS], CS, PSIZE)
        whole = net(patches, None, slice_map=smap)
        split = net.fc_head(net.pooled(patches, None, slice_map=smap))
    assert torch.equal(whole, split)


@pytest.mark.parametrize("f", [96, 512])
def test_bf16_kernel_k_layout_is_the_segment_convs(f):
    """The bf16 kernels' implicit GEMMs, written out: im2col columns in
    (64-channel chunk, tap, channel) order from ``head_chunks``, times
    ``kmajor_weights``, equal conv0 over the segments and conv1 (F not a
    multiple of 64 pads its channels with zeros)."""
    rng = np.random.default_rng(3)
    m, cs = 3, CS[1:]
    levels = [(None, None, t, c) for t, c in LEVELS[1:]]
    expanded = [[T(rng.standard_normal((m, PSIZE, PSIZE, c)).astype(np.float32))
                 for _ in range(2)] for c in cs]
    k0 = T((rng.standard_normal((3, 3, 2 * sum(CS), f)) * 0.05).astype(np.float32))
    segs = segment_weights(k0, CS, torch.float32)

    def implicit_gemm(chunks, wt, stride):
        cols = []
        for x in chunks:
            xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
            span = stride * 7 + 1
            cols += [xp[:, dy:dy + span:stride, dx:dx + span:stride, :]
                     for dy in range(3) for dx in range(3)]
        return torch.cat(cols, dim=-1) @ wt.T

    chunks = [expanded[li][side][..., off:off + 64] for li, side, off in head_chunks(levels)]
    got = implicit_gemm(chunks, kmajor_weights(torch.cat(segs, dim=1), 64 * len(chunks)), 2)
    want, it = None, iter(segs)
    for (e1, e2), c in zip(expanded, cs):
        for x in ([torch.cat([e1, e2], dim=-1)] if c == 64 else [e1, e2]):
            want = _conv_taps(want, x, next(it), 2, 8)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    x1 = T(rng.standard_normal((m, 8, 8, f)).astype(np.float32))
    w1 = T((rng.standard_normal((9, f, f)) * 0.05).astype(np.float32))
    fp = -(-f // 64) * 64
    x1p = torch.nn.functional.pad(x1, (0, fp - f))
    got = implicit_gemm(list(x1p.split(64, dim=-1)), kmajor_weights(w1, fp), 1)
    torch.testing.assert_close(got, _conv_taps(None, x1, w1, 1, 8), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):  # a level of 96 channels is not whole chunks
        head_chunks([(None, None, 4, 96)])
