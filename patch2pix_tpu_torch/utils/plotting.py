"""Match / epipolar-line visualisation (matplotlib/cv2, host side).

Port of ``patch2pix_tpu.utils.plotting``, a numpy copy: ``plot_matches``,
``plot_matches_cv``, ``plot_epilines``, the loader visualisers, pdf
export and the undo-normalisation helper. Images are channels-last; each
helper also takes tensors (moved to the host with ``.cpu().numpy()``).
matplotlib (with the Agg backend) and cv2 are imported when a helper
draws, never at import.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from patch2pix_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD


def _np(x):
    """A tensor (any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def undo_normalize(im: np.ndarray) -> np.ndarray:
    """ImageNet-normalised HWC float -> displayable [0, 1] RGB."""
    return np.clip(_np(im) * IMAGENET_STD + IMAGENET_MEAN, 0.0, 1.0)


def side_by_side(im1: np.ndarray, im2: np.ndarray) -> Tuple[np.ndarray, int]:
    """Concatenate two HWC images horizontally; returns (canvas, x-offset
    of the second image)."""
    im1, im2 = _np(im1), _np(im2)
    h = max(im1.shape[0], im2.shape[0])
    w1, w2 = im1.shape[1], im2.shape[1]
    canvas = np.zeros((h, w1 + w2, 3), dtype=np.float64)
    canvas[: im1.shape[0], :w1] = im1
    canvas[: im2.shape[0], w1:] = im2
    return canvas, w1


def plot_matches(
    im1: np.ndarray,
    im2: np.ndarray,
    matches: np.ndarray,
    scores: Optional[np.ndarray] = None,
    max_draw: int = 200,
    lines: bool = True,
    save_path: Optional[str] = None,
    dpi: int = 100,
):
    """Draw correspondences across a side-by-side pair.

    im1/im2: HWC arrays in [0, 1] (use :func:`undo_normalize` first if
    normalised). matches: (N, 4) as (x1, y1, x2, y2).
    Returns the matplotlib figure.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    canvas, xoff = side_by_side(im1, im2)
    matches = _np(matches)
    scores = None if scores is None else _np(scores)
    n = len(matches)
    if n > max_draw:
        sel = np.random.default_rng(0).choice(n, max_draw, replace=False)
        matches = matches[sel]
        scores = scores[sel] if scores is not None else None

    fig, ax = plt.subplots(figsize=(12, 6), dpi=dpi)
    ax.imshow(canvas)
    ax.axis("off")
    cmap = plt.get_cmap("hsv")
    for i, (x1, y1, x2, y2) in enumerate(np.asarray(matches)):
        c = cmap(i / max(len(matches), 1))
        ax.plot(x1, y1, "o", markersize=3, color=c)
        ax.plot(x2 + xoff, y2, "o", markersize=3, color=c)
        if lines:
            ax.plot([x1, x2 + xoff], [y1, y2], "-", linewidth=0.6, color=c)
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_matches_cv(
    im1,
    im2,
    matches: np.ndarray,
    inliers: Optional[np.ndarray] = None,
    max_draw: int = 1000,
    save_path: Optional[str] = None,
):
    """cv2 ``drawMatches`` renderer (the reference's fast path,
    plotting.py:205-250). im1/im2: HWC arrays in [0, 1], uint8 arrays,
    or image paths. Returns the rendered uint8 canvas."""
    import cv2

    def load(im):
        if isinstance(im, str):
            from PIL import Image

            return np.array(Image.open(im).convert("RGB"))
        im = _np(im)
        if im.dtype != np.uint8:
            return (np.clip(im, 0.0, 1.0) * 255).astype(np.uint8)
        return im

    I1, I2 = load(im1), load(im2)
    matches = _np(matches)
    ids = np.arange(len(matches)) if inliers is None else _np(inliers)
    ids = ids[:max_draw]
    kp1 = [cv2.KeyPoint(float(matches[i, 0]), float(matches[i, 1]), 1) for i in ids]
    kp2 = [cv2.KeyPoint(float(matches[i, 2]), float(matches[i, 3]), 1) for i in ids]
    dm = [cv2.DMatch(j, j, 1) for j in range(len(ids))]
    canvas = cv2.drawMatches(I1, kp1, I2, kp2, dm, None)
    if save_path:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(14, 7))
        ax.imshow(canvas)
        ax.axis("off")
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return canvas


def plot_imlist(ims: Sequence[np.ndarray], cols: Optional[int] = None):
    """Grid of images on one figure (reference plotting.py:17-30)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(ims)
    cols = cols or n
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows),
                             squeeze=False)
    for ax in axes.ravel():
        ax.axis("off")
    for i, im in enumerate(ims):
        axes[i // cols][i % cols].imshow(np.clip(_np(im), 0, 1))
    fig.tight_layout()
    return fig


def plot_imlist_to_pdf(
    imlists: Sequence[Sequence[np.ndarray]], save_path: str, dpi: int = 150
):
    """Multi-page pdf, one image grid per page (reference
    plotting.py:5-15)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib.backends.backend_pdf import PdfPages
    import matplotlib.pyplot as plt

    with PdfPages(save_path) as pdf:
        for ims in imlists:
            fig = plot_imlist(ims)
            pdf.savefig(fig, dpi=dpi)
            plt.close(fig)


def plot_pair_loader(
    batches, row_max: int = 2, normalized: bool = True, save_path=None
):
    """Visualise (im1, im2) pairs from a batch iterator (reference's
    ``plot_pair_loader``/``plot_immatch_loader``, plotting.py:101-162).

    ``batches`` yields dicts with ``im1``/``im2`` ``(B, H, W, 3)``;
    up to ``row_max`` pairs are drawn, one pair per row.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = []
    for batch in batches:
        for b in range(len(batch["im1"])):
            im1, im2 = _np(batch["im1"][b]), _np(batch["im2"][b])
            if normalized:
                im1, im2 = undo_normalize(im1), undo_normalize(im2)
            rows.append((im1, im2))
            if len(rows) >= row_max:
                break
        if len(rows) >= row_max:
            break
    fig, axes = plt.subplots(len(rows), 2, figsize=(8, 3 * len(rows)),
                             squeeze=False)
    for r, (im1, im2) in enumerate(rows):
        axes[r][0].imshow(im1)
        axes[r][1].imshow(im2)
        axes[r][0].axis("off")
        axes[r][1].axis("off")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_triple_loader(
    batches, row_max: int = 2, normalized: bool = True, save_path=None
):
    """Visualise (src, pos, neg) triplets (reference plotting.py:163-204)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = []
    for batch in batches:
        for b in range(len(batch["im1"])):
            ims = [_np(batch[k][b]) for k in ("im1", "im2", "neg_im")]
            if normalized:
                ims = [undo_normalize(im) for im in ims]
            rows.append(ims)
            if len(rows) >= row_max:
                break
        if len(rows) >= row_max:
            break
    fig, axes = plt.subplots(len(rows), 3, figsize=(12, 3 * len(rows)),
                             squeeze=False)
    for r, ims in enumerate(rows):
        for c, im in enumerate(ims):
            axes[r][c].imshow(im)
            axes[r][c].axis("off")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_epilines(
    im1: np.ndarray,
    im2: np.ndarray,
    matches: np.ndarray,
    F: np.ndarray,
    max_draw: int = 30,
    save_path: Optional[str] = None,
):
    """Draw points in image 1 and their epipolar lines (F x1) in image 2."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    im1, im2, matches, F = _np(im1), _np(im2), _np(matches), _np(F)
    n = len(matches)
    if n > max_draw:
        sel = np.random.default_rng(0).choice(n, max_draw, replace=False)
        matches = matches[sel]

    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    axes[0].imshow(im1)
    axes[1].imshow(im2)
    for ax in axes:
        ax.axis("off")
    w2 = im2.shape[1]
    cmap = plt.get_cmap("hsv")
    for i, (x1, y1, x2, y2) in enumerate(np.asarray(matches)):
        c = cmap(i / max(len(matches), 1))
        axes[0].plot(x1, y1, "o", markersize=4, color=c)
        a, b, cc = F @ np.array([x1, y1, 1.0])
        if abs(b) > 1e-12:
            xs = np.array([0.0, w2])
            ys = -(a * xs + cc) / b
            axes[1].plot(xs, ys, "-", linewidth=0.8, color=c)
        axes[1].plot(x2, y2, "o", markersize=4, color=c)
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_train_curves(rows: Sequence[dict], save_path: str) -> None:
    """The synthetic training demo's curves (``train.synth_demo``), one
    row per step: the total loss, the mid and fine epipolar losses (raw
    and a 9-step moving mean), and the held-out fine Sampson error at
    each evaluation (all matches, confidence-gated, and the fixable ones)
    -> a PNG at ``save_path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(13, 3.5))
    steps = [r["step"] for r in rows]

    def smooth(key):
        v = np.asarray([r[key] for r in rows])
        n = min(9, len(v))
        return np.convolve(v, np.ones(n) / n, mode="same")

    axes[0].plot(steps, [r["loss_pair"] for r in rows], alpha=0.3)
    axes[0].plot(steps, smooth("loss_pair"))
    axes[0].set_title("total loss")
    for key, label in (("loss_epi_mid", "mid"), ("loss_epi_fine", "fine")):
        axes[1].plot(steps, [r[key] for r in rows], alpha=0.3, label=label)
        axes[1].plot(steps, smooth(key))
    axes[1].set_title("epipolar loss (px)")
    axes[1].legend()
    for key, marker, label in (("val_fine_sampson_px", "o", "all (conf-gated)"),
                               ("val_fine_fixable_px", "s", "fixable (coarse<16px)")):
        vs = [(r["step"], r[key]) for r in rows if key in r]
        axes[2].plot([s for s, _ in vs], [v for _, v in vs], marker=marker, label=label)
    axes[2].legend()
    axes[2].set_title("held-out fine sampson (px, clipped@50)")
    for ax in axes:
        ax.set_xlabel("step")
    fig.tight_layout()
    fig.savefig(save_path, dpi=110)
    plt.close(fig)
