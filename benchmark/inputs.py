"""Seeded inputs and weights, made on the run's device in a few large
draws from one ``torch.Generator``.

Copies of the repository's seeded makers, kept here so that they do not
move with the program: the weight rules of ``tests/ref_loader.py``'s
``seeded_state_dict`` (fan-in scaled normals for kernels, small biases,
BatchNorm statistics near identity) and the image transform of
``chip_smoke.py``'s ``seeded_images``. Pairs of images match: with
seeded weights, noise images that share nothing give volumes of
near-ties everywhere, where no comparison can tell a fault from a
rounding.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``seed`` (any whole number: it is
    folded into 64 bits) and an independent ``stream``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (2 ** 63))
    return g


def make_weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights for a {key: shape} map: one normal and one uniform
    draw for all keys (sorted), sliced and scaled by the key's kind."""
    g = generator(seed, device, stream=1)
    keys = sorted(shapes)
    sizes = [int(np.prod(shapes[k], dtype=np.int64)) for k in keys]
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uniform = torch.rand(sum(sizes), generator=g, device=device)
    out, off = {}, 0
    for key, n in zip(keys, sizes):
        shape = shapes[key]
        z = normal[off:off + n].reshape(shape)
        u = uniform[off:off + n].reshape(shape)
        off += n
        if key.endswith("num_batches_tracked"):
            out[key] = torch.ones((), dtype=torch.int64, device=device)
        elif key.endswith("running_mean"):
            out[key] = z * 0.1
        elif key.endswith("running_var"):
            out[key] = u + 0.5
        elif key.endswith(".weight") and len(shape) == 1:  # BatchNorm scale
            out[key] = 1.0 + 0.1 * z
        elif len(shape) == 1:  # biases
            out[key] = z * 0.05
        else:
            # a conv4d weight is stored (k1, out, in, k2, k3, k4)
            fan_in = int(np.prod(shape[2:]) * shape[0] if len(shape) == 6 else np.prod(shape[1:]))
            out[key] = z * (2.0 / max(fan_in, 1)) ** 0.5
    return out


def shifted_pairs(seed: int, n: int, h: int, w: int, device, max_shift: int, noise: float,
                  smooth: int = 8):
    """``n`` pairs of NHWC float32 noise images that match. A canvas is
    uniform noise on a grid ``smooth`` times coarser, bilinearly enlarged,
    plus a third of that amplitude of pixel noise (a spectrum that falls
    off, as photographs' does, so features survive a move by less than
    their stride). The second image of a pair is its first moved by a
    whole-pixel offset (dx, dy) drawn in [-max_shift, max_shift] along
    each axis (the canvas's own content where it moves in), plus
    Gaussian noise of standard deviation ``noise``: a pixel (x, y) of
    the first shows at (x - dx, y - dy) in the second. Both normalised
    as ``seeded_images`` does, ``(u - 0.45) / 0.25``. Returns (first
    images, second images, offsets (n, 2) as (dy, dx))."""
    g = generator(seed, device, stream=2)
    m = max_shift
    hc, wc = h + 2 * m, w + 2 * m
    coarse = torch.rand((n, 3, hc // smooth + 2, wc // smooth + 2), generator=g, device=device)
    big = torch.nn.functional.interpolate(coarse, scale_factor=smooth, mode="bilinear",
                                          align_corners=False)[:, :, :hc, :wc]
    fine = torch.rand((n, 3, hc, wc), generator=g, device=device)
    canvas = ((0.75 * big + 0.25 * fine)).permute(0, 2, 3, 1)
    mag = torch.randint(0, m + 1, (n, 2), generator=g, device=device)
    sign = torch.randint(0, 2, (n, 2), generator=g, device=device) * 2 - 1
    shifts = (mag * sign).tolist()
    im1 = canvas[:, m:m + h, m:m + w]
    im2 = torch.stack([canvas[j, m + dy:m + dy + h, m + dx:m + dx + w]
                       for j, (dy, dx) in enumerate(shifts)])
    im2 = im2 + noise * torch.randn(im2.shape, generator=g, device=device)
    return (im1 - 0.45) / 0.25, (im2 - 0.45) / 0.25, shifts


def traffic_pairs(seed: int, traffic, device, n: int = 0):
    """The traffic's pool of pairs (``n`` of them, else ``pool_pairs``)."""
    t = traffic
    return shifted_pairs(seed, n or t["pool_pairs"], t["height"], t["width"], device,
                         t["max_shift"], t["noise"])
