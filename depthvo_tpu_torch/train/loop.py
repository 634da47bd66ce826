"""The staged loss graph and the held-out loss pass (counterpart of
``depthvo_tpu/train/loop.py``: ``compute_losses``, ``make_eval_step``,
``run_validation``).

Loss graph (full variant; the config's switches select the stage):

  disp_pyramid = DepthNet(I_t)                         # multi-scale
  twist        = OdomNet([I_t, I_s]);  T_ts = se3.exp(twist)
  per scale s:
    stereo:   warp(I_r -> I_t view, depth_s, fx*b)     -> masked L1  (K1)
    temporal: warp(I_s -> I_t view, depth_s, T_ts)     -> masked L1  (K4, C=3)
    smoothness(disp_s, I_t)
  finest scale only:
    temporal + feature: one warp of [I_s, F(I_s)]      -> masked L1  (K4, C=3+16)

Images are NHWC in [-1, 1] (or raw uint8) at the entry, as in the
reference; the photometric region runs in the kernels' (B, C, H, W)
layout. Only the evaluation pass (``train=False``: BatchNorm running
statistics, no gradients) is ported; the train step comes with the
training slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator

import numpy as np
import torch

from depthvo_tpu_torch import ops
from depthvo_tpu_torch.configs import base as config_base
from depthvo_tpu_torch.configs.base import ExperimentConfig
from depthvo_tpu_torch.geometry import se3
from depthvo_tpu_torch.geometry.camera import scale_intrinsics
from depthvo_tpu_torch.losses.photometric import masked_l1_chw, photometric_loss_chw
from depthvo_tpu_torch.losses.smoothness import smoothness_loss
from depthvo_tpu_torch.models.layers import resize_bilinear_chw
from depthvo_tpu_torch.train.state import DTYPES, Models
from depthvo_tpu_torch.utils.device import resolve_device
from depthvo_tpu_torch.utils.images import to_unit


def compute_losses(config: ExperimentConfig, models: Models,
                   batch: Dict[str, torch.Tensor], train: bool = False):
    """Evaluate the staged loss graph.

    Args:
      models: the stage's networks (``train.state.Models``), on the
        batch's device.
      batch: tensors on one device: 'image_t', 'image_r' (if use_stereo),
        'image_s' (if use_temporal) as (B,H,W,3) float in [-1,1] or raw
        uint8; 'K' (B,3,3) at full resolution; optional 'baseline' (B,).

    Returns: (total_loss, metrics dict of scalar tensors).
    """
    if train:
        raise NotImplementedError(
            "the train-mode loss graph (BN batch statistics, warp gradients) "
            "comes with the training slice"
        )
    if config.use_feature and not config.use_temporal:
        raise ValueError(
            "use_feature requires use_temporal (the feature loss warps "
            "with the predicted pose)"
        )
    depth_net, odom_net, feat_net = models
    batch = {
        k: to_unit(v) if v.dtype == torch.uint8 else v for k, v in batch.items()
    }
    image_t = batch["image_t"]
    K = batch["K"]
    B, H, W, _ = image_t.shape
    baseline = batch.get("baseline")
    if baseline is None:
        baseline = config.stereo_baseline

    disps = depth_net(image_t)
    metrics: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=image_t.device)

    T_ts = None
    if config.use_temporal:
        twist = odom_net(torch.cat([image_t, batch["image_s"]], dim=-1))
        T_ts = se3.exp(twist)
        metrics["twist_norm"] = torch.mean(torch.linalg.norm(twist, dim=-1))

    loss_dtype = DTYPES[config.loss_dtype]

    def to_chw(x):
        return x.to(loss_dtype).permute(0, 3, 1, 2)

    image_t_chw = to_chw(image_t)
    image_r_chw = to_chw(batch["image_r"]) if config.use_stereo else None
    image_s_chw = to_chw(batch["image_s"]) if config.use_temporal else None

    def at_scale(img_chw, h, w):
        return img_chw if (h, w) == (H, W) else resize_bilinear_chw(img_chw, h, w)

    n_scales = len(disps)
    stereo_total = torch.zeros((), device=image_t.device)
    temporal_total = torch.zeros((), device=image_t.device)
    smooth_total = torch.zeros((), device=image_t.device)
    for i, disp in enumerate(disps):  # coarsest -> finest
        h, w = disp.shape[1:3]
        Ks = scale_intrinsics(K, w / W, h / H)
        img_t = at_scale(image_t_chw, h, w)
        depth = 1.0 / disp[..., 0]
        if config.use_stereo:
            fxb = Ks[..., 0, 0] * baseline
            warped, valid = ops.stereo_warp_chw(
                at_scale(image_r_chw, h, w), depth, fxb,
                dmax=config_base.stereo_dmax(config, w),
            )
            stereo_total = stereo_total + photometric_loss_chw(
                warped, img_t, valid, config.ssim_weight
            )
        if config.use_temporal and not ((h, w) == (H, W) and config.use_feature):
            warped, valid = ops.frozen_warp_chw(
                at_scale(image_s_chw, h, w), depth, T_ts, Ks,
                pad_v=config.warp_pad_v,
            )
            temporal_total = temporal_total + photometric_loss_chw(
                warped, img_t, valid, config.ssim_weight
            )
        smooth_total = smooth_total + smoothness_loss(
            disp, img_t, edge_aware=config.edge_aware_smoothness,
            image_layout="chw",
        ) / (2.0 ** (n_scales - 1 - i))

    # Finest scale: temporal and feature losses sample the source at the
    # same coordinates, so RGB and features share one 19-channel warp.
    feat_loss = None
    if config.use_temporal and config.use_feature:
        feat_t_chw = feat_net.forward_chw(image_t.permute(0, 3, 1, 2)).to(loss_dtype)
        feat_s_chw = feat_net.forward_chw(
            batch["image_s"].permute(0, 3, 1, 2)
        ).to(loss_dtype)
        depth_full = 1.0 / disps[-1][..., 0]
        payload = torch.cat([image_s_chw, feat_s_chw], dim=1)
        warped, valid = ops.frozen_warp_chw(
            payload, depth_full, T_ts, K, pad_v=config.warp_pad_v
        )
        temporal_total = temporal_total + photometric_loss_chw(
            warped[:, :3], image_t_chw, valid, config.ssim_weight
        )
        feat_loss = config.feature_weight * masked_l1_chw(
            warped[:, 3:], feat_t_chw, valid
        )

    if config.use_stereo:
        metrics["loss/stereo"] = config.stereo_weight * stereo_total / n_scales
        total = total + metrics["loss/stereo"]
    if config.use_temporal:
        metrics["loss/temporal"] = config.temporal_weight * temporal_total / n_scales
        total = total + metrics["loss/temporal"]
    metrics["loss/smooth"] = config.smooth_weight * smooth_total / n_scales
    total = total + metrics["loss/smooth"]
    if feat_loss is not None:
        metrics["loss/feature"] = feat_loss
        total = total + feat_loss
    metrics["loss/total"] = total
    metrics["disp/mean"] = torch.mean(disps[-1])
    return total, metrics


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """Host batch (numpy) -> tensors on ``device``; uint8 stays uint8."""
    return {
        k: torch.as_tensor(np.asarray(v)).to(device, non_blocking=True)
        for k, v in batch.items()
    }


def make_eval_step(config: ExperimentConfig, device: str | torch.device | None = None
                   ) -> Callable[[Models, Dict[str, np.ndarray]], Dict[str, torch.Tensor]]:
    """Eval-mode loss evaluation (no update, BN running statistics).

    Returns ``eval_fn(models, host_batch) -> metrics`` running on
    ``device`` (default ``cuda``; raises when there is no GPU unless
    ``device="cpu"``).
    """
    dev = resolve_device(device)

    def eval_fn(models: Models, batch: Dict[str, np.ndarray]):
        with torch.inference_mode():
            _, metrics = compute_losses(
                config, models, batch_to_device(batch, dev), train=False
            )
        return metrics

    return eval_fn


def run_validation(eval_fn, models: Models, eval_iter: Iterator[Dict[str, np.ndarray]],
                   eval_steps: int) -> Dict[str, float]:
    """Average the loss terms over ``eval_steps`` held-out batches (the
    Caffe solver test phase). Returns metrics under a ``val/`` prefix."""
    totals: Dict[str, float] = {}
    for _ in range(eval_steps):
        metrics = eval_fn(models, next(eval_iter))
        for k, v in metrics.items():
            totals[k] = totals.get(k, 0.0) + float(v)
    return {f"val/{k}": v / max(eval_steps, 1) for k, v in totals.items()}
