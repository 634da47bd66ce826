"""Trained networks against the exact geometry of synthetic scenes.

The port's copy of the protocol of the reference's
``benchmarks/feat_ab.py`` (``depth_abs_rel``, ``pose_err``), which the
reference's learning checks use: one fixed batch of the first scenes
(``SyntheticScenes.fixed_batch``), the depth net in eval mode, its finest
disparity inverted, median scaled against the scenes' true depth and
scored by the mean abs-rel; the odometry net's relative pose against the
scenes' true ``T_ts``. Added here: the Pearson correlation of log depth
(median scaling does not change it) and each scene's translation error
relative to its true translation.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from depthvo_tpu_torch.geometry import se3
from depthvo_tpu_torch.utils.images import to_unit


def _fixed_batch(models, scenes, batch_size: int):
    device = next(models.depth.parameters()).device
    batch = scenes.fixed_batch(batch_size)
    idx = [i % len(scenes._scenes) for i in range(batch_size)]
    images = {k: to_unit(torch.as_tensor(batch[k]).to(device)) for k in ("image_t", "image_s")}
    return images, idx


@torch.no_grad()
def depth_metrics(models, scenes, batch_size: int) -> Dict[str, float]:
    """``abs_rel`` (feat_ab's ``depth_abs_rel``) and ``log_corr`` of the
    depth net on the fixed batch; the net's train/eval mode is restored."""
    images, idx = _fixed_batch(models, scenes, batch_size)
    gt = np.stack([scenes._scenes[i]["depth"] for i in idx])
    training = models.depth.training
    models.depth.eval()
    try:
        disp = models.depth(images["image_t"])[-1]
    finally:
        models.depth.train(training)
    pred = 1.0 / disp[..., 0].float().cpu().numpy()
    scale = np.median(gt) / np.median(pred)
    abs_rel = float(np.mean(np.abs(pred * scale - gt) / gt))
    log_corr = float(np.corrcoef(np.log(pred).ravel(), np.log(gt).ravel())[0, 1])
    return {"abs_rel": abs_rel, "log_corr": log_corr}


@torch.no_grad()
def pose_metrics(models, scenes, batch_size: int) -> Dict[str, object]:
    """feat_ab's ``pose_err`` of the odometry net on the fixed batch:
    ``t_err_m`` (mean translation error, metres) and ``r_err_deg`` (mean
    rotation error), plus ``t_err_rel``, each scene's ‖t_pred − t_true‖ /
    ‖t_true‖, and its largest value ``t_err_rel_max``."""
    images, idx = _fixed_batch(models, scenes, batch_size)
    gt_T = np.stack([scenes._scenes[i]["T_ts"] for i in idx]).astype(np.float64)
    twist = models.odom(torch.cat([images["image_t"], images["image_s"]], dim=-1))
    T_pred = se3.exp(twist).cpu().numpy().astype(np.float64)
    t_err = np.linalg.norm(T_pred[:, :3, 3] - gt_T[:, :3, 3], axis=-1)
    t_rel = t_err / np.linalg.norm(gt_T[:, :3, 3], axis=-1)
    rel = np.einsum("bij,bkj->bik", T_pred[:, :3, :3], gt_T[:, :3, :3])
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) * 0.5, -1.0, 1.0)
    return {"t_err_m": float(np.mean(t_err)), "r_err_deg": float(np.degrees(np.mean(np.arccos(cos)))),
            "t_err_rel": [float(x) for x in t_rel], "t_err_rel_max": float(np.max(t_rel))}
