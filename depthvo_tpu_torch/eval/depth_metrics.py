"""KITTI Eigen-split depth evaluation metrics (the port's own copy of
``depthvo_tpu/eval/depth_metrics.py``: the same numpy operations in the
same order, so both packages give equal metrics on equal inputs).

Per frame, after the prediction is resized to the ground truth's
resolution: Garg crop, cap at 50/80 m, (median) scaling, then
abs_rel / sq_rel / rmse / rmse_log / delta<1.25 / <1.25^2 / <1.25^3.
Pure numpy on the host; the network inference is the batched forward in
``eval/runner.py``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

DEPTH_METRIC_NAMES = (
    "abs_rel",
    "sq_rel",
    "rmse",
    "rmse_log",
    "a1",
    "a2",
    "a3",
)


def eigen_crop_mask(height: int, width: int) -> np.ndarray:
    """Garg crop: the evaluation region used by Eigen-split protocols.

    crop = [0.40810811 * H, 0.99189189 * H] x [0.03594771 * W,
    0.96405229 * W] — the standard constants from Garg et al., as used by
    the reference's eval script and everything derived from it.
    """
    mask = np.zeros((height, width), bool)
    y0, y1 = int(0.40810811 * height), int(0.99189189 * height)
    x0, x1 = int(0.03594771 * width), int(0.96405229 * width)
    mask[y0:y1, x0:x1] = True
    return mask


def _single_frame_metrics(
    pred: np.ndarray, gt: np.ndarray, min_depth: float, max_depth: float,
    median_scale: bool, crop: bool,
) -> np.ndarray | None:
    valid = (gt > min_depth) & (gt < max_depth)
    if crop:
        valid &= eigen_crop_mask(*gt.shape)
    if valid.sum() == 0:
        return None
    p = pred[valid]
    g = gt[valid]
    if median_scale:
        p = p * (np.median(g) / (np.median(p) + 1e-12))
    p = np.clip(p, min_depth, max_depth)
    thresh = np.maximum(g / p, p / g)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25**2).mean()
    a3 = (thresh < 1.25**3).mean()
    rmse = np.sqrt(((g - p) ** 2).mean())
    rmse_log = np.sqrt(((np.log(g) - np.log(p)) ** 2).mean())
    abs_rel = (np.abs(g - p) / g).mean()
    sq_rel = (((g - p) ** 2) / g).mean()
    return np.array([abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3])


def compute_depth_metrics(
    preds: Sequence[np.ndarray],
    gts: Sequence[np.ndarray],
    min_depth: float = 1e-3,
    max_depth: float = 80.0,
    median_scale: bool = True,
    crop: bool = True,
) -> Dict[str, float]:
    """Average Eigen-protocol metrics over frames.

    Args:
      preds: per-frame predicted depth maps, already resized to each gt's
        resolution (the reference resizes pred -> gt size, SURVEY §3.2).
      gts: per-frame ground-truth depth (0 where invalid).
      max_depth: cap (80 m default; pass 50.0 for the 50 m protocol).
      median_scale: per-frame median scaling (monocular protocols); the
        reference's stereo-trained models can also evaluate unscaled.
    """
    rows = []
    for pred, gt in zip(preds, gts):
        assert pred.shape == gt.shape, (pred.shape, gt.shape)
        row = _single_frame_metrics(
            pred, gt, min_depth, max_depth, median_scale, crop
        )
        if row is not None:
            rows.append(row)
    if not rows:
        raise ValueError(
            "depth eval produced no valid frames: every gt map has zero "
            "valid pixels inside the Garg crop / depth caps (empty split, "
            "or gt and crop conventions disagree)"
        )
    mean = np.mean(np.stack(rows), axis=0)
    return dict(zip(DEPTH_METRIC_NAMES, mean.tolist()))
