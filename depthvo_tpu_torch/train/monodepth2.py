"""Monodepth2's loss graph (``trainer.py``: ``predict_poses``,
``generate_images_pred``, ``compute_losses``), for configs whose
``architecture`` is ``"monodepth2"``; ``train.loop.compute_losses``
hands them here.

  disps      = DepthNet(I_0)                           # scales 0..3, sigmoid
  T_-1       = inverse of PoseNet([I_-1, I_0])        # frames -1, +1
  T_+1       = PoseNet([I_0, I_+1])                    #   (use_temporal)
  T_s        = stereo_T: x translation -0.1            # frame "s" (use_stereo)
  identity_f = reproj(I_f, I_0)                        # once, no gradient
  per scale s:
    depth  = 1 / (min_disp + max_disp * upsample(disp_s to H x W))
    warp_f = border warp of I_f at Project3D(depth, K, T_f)   # full size
    reproj_f = 0.85 SSIM(warp_f, I_0) + 0.15 L1(warp_f, I_0)  # channel means
    pixel  = min over [identity_f + 1e-5 N(0, 1), reproj_f]   # auto-masking
    loss_s = mean(pixel) + 1e-3 smooth(disp_s / mean, I_0 at scale s) / 2^s
  total = sum_s loss_s / num_scales

Images are (B, H, W, 3) uint8 (or floats in [-1, 1]) at the entry and
(B, 3, H, W) in [0, 1] inside, as Monodepth2's. The three sources of a
scale warp at full resolution through ``gen_fwd_border`` (one launch each,
12 a step at 4 scales), differentiated with respect to the sample
coordinates by ``gen_bwd_uv_border``; the sources are data. Each
reprojection error, SSIM and L1 together, is one ``reproj_fwd`` launch
(``ops/reproj.py``: 3 identity errors and 12 warped ones, 15 a step),
and each warped one's gradient one ``reproj_bwd`` (12 a step). The
tie-breaking noise is drawn on the batch's device from its default
generator, which a CUDA graph of the step replays with fresh draws.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from depthvo_tpu_torch import ops
from depthvo_tpu_torch.geometry import monodepth2 as geo
from depthvo_tpu_torch.losses import monodepth2 as md2_loss
from depthvo_tpu_torch.models.layers import resize_bilinear_chw
from depthvo_tpu_torch.parallel.mesh import global_metrics
from depthvo_tpu_torch.utils import spans

STEREO_T = 0.1  # Monodepth2's stereo baseline, its units (depth x 5.4 = metres)
NOISE_STD = 1e-5  # the identity errors' tie-breaking noise


def default_noise(shape, like: torch.Tensor) -> torch.Tensor:
    """N(0, 1) draws of ``shape`` on ``like``'s device, float32."""
    return torch.randn(shape, dtype=torch.float32, device=like.device)


def to_md2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8, or floats in [-1, 1] -> contiguous (B, 3, H, W)
    float32 in [0, 1]. The divisor is a tensor (a CUDA division by a Python
    number multiplies by its reciprocal)."""
    x = x.permute(0, 3, 1, 2)
    if x.dtype == torch.uint8:
        x = x.float()
        return (x / torch.full_like(x, 255.0)).contiguous()
    return ((x.float() + 1.0) / 2.0).contiguous()


def automasked_minimum(identity: torch.Tensor, reproj):
    """Auto-masking and the per-pixel minimum: over the channels of
    ``identity`` (the unwarped sources' errors, (B, n, H, W)) and the warped
    sources' errors ``reproj`` ((B, 1, H, W) each), the least at each pixel
    and its index (below n: an identity error won)."""
    return torch.min(torch.cat([identity] + list(reproj), 1), dim=1)


def frame_keys(config) -> list:
    """The batch's image keys the config's frames read."""
    return (["image_t"] + (["image_p", "image_s"] if config.use_temporal else [])
            + (["image_r"] if config.use_stereo else []))


def compute_losses(config, models, batch: Dict[str, torch.Tensor], train: bool = False,
                   mesh=None, noise: Callable = default_noise):
    """(total, metrics) of Monodepth2's loss graph on ``batch``: 'image_t'
    (frame 0), with use_temporal 'image_p' (frame -1) and 'image_s'
    (frame +1), with use_stereo 'image_r' (frame "s"), and 'K' (B, 3, 3)
    at full resolution. ``models`` is ``train.state.Models`` with the depth
    net and, with frames -1 and +1, the pose net in the odometry slot.

    Metrics: ``loss/total``; per scale s ``loss/reproj/{s}`` (the mean of
    the per-pixel minimum) and ``loss/smooth/{s}`` (weighted, over 2^s);
    ``md2/automask_share``, the share of pixels (over every scale) where an
    identity error wins, and ``md2/source_share/{-1,+1,s}``, those won by
    each warped source; ``disp/mean``. With ``mesh`` (this rank's rows of
    the global batch) ``total`` is this rank's share of the global batch's
    loss and the metrics are the global batch's, as in
    ``train.loop.compute_losses``. ``noise(shape, like)`` draws the
    tie-breaking noise (N(0, 1), scaled by :data:`NOISE_STD` here)."""
    if not (config.use_temporal or config.use_stereo):
        raise ValueError("monodepth2 needs a source frame: use_temporal and/or use_stereo")
    if config.use_feature:
        raise ValueError("the monodepth2 architecture has no feature loss")
    with spans.span("md2.loss"):
        return _losses(config, models, batch, train, mesh, noise)


def _losses(config, models, batch, train, mesh, noise):
    depth_net, pose_net, _ = models.train(train)
    img = {k: to_md2(batch[k]) for k in frame_keys(config)}
    target = img["image_t"]
    B, _, H, W = target.shape
    share = 1.0 if mesh is None else 1.0 / mesh.size

    disps = depth_net(target)
    frames = []
    if config.use_temporal:
        axisangle, translation = pose_net(torch.cat([img["image_p"], target], 1))
        T_prev = geo.transformation_from_parameters(axisangle[:, 0], translation[:, 0],
                                                    invert=True)
        axisangle, translation = pose_net(torch.cat([target, img["image_s"]], 1))
        T_next = geo.transformation_from_parameters(axisangle[:, 0], translation[:, 0])
        frames += [("-1", img["image_p"], T_prev), ("+1", img["image_s"], T_next)]
    if config.use_stereo:
        frames.append(("s", img["image_r"], geo.stereo_transform(B, STEREO_T, target.device)))

    K = batch["K"].float()
    K4 = geo.homogeneous_K(K)
    rays = geo.pixel_rays(K, H, W)
    with torch.no_grad():
        identity = torch.cat([md2_loss.reprojection_loss(src, target, config.ssim_weight)
                              for _, src, _ in frames], 1)
    n_id = identity.shape[1]

    metrics: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=target.device)
    won = torch.zeros(len(frames) + 1, device=target.device)
    n_scales = len(disps)
    mc = config.model
    for s, disp in enumerate(disps):
        up = disp if disp.shape[-2:] == (H, W) else F.interpolate(
            disp, [H, W], mode="bilinear", align_corners=False)
        depth = 1.0 / (mc.min_disp + mc.max_disp * up[:, 0])
        reproj = []
        for _, src, T in frames:
            gx, gy = geo.project_normalised(depth, rays, K4, T)
            warped = ops.border_warp_chw(src, gx, gy)
            reproj.append(md2_loss.reprojection_loss(warped, target, config.ssim_weight))
        to_optimise, idxs = automasked_minimum(
            identity + noise(identity.shape, identity) * NOISE_STD, reproj)
        with torch.no_grad():
            won[0] += (idxs < n_id).float().mean()
            for k in range(len(frames)):
                won[k + 1] += (idxs == n_id + k).float().mean()
        h, w = disp.shape[-2:]
        color = target if (h, w) == (H, W) else resize_bilinear_chw(target, h, w)
        smooth = md2_loss.smooth_loss(md2_loss.normalised_disp(disp), color)
        reproj_term = to_optimise.mean() * share
        smooth_term = config.smooth_weight * smooth / (2 ** s) * share
        metrics[f"loss/reproj/{s}"] = reproj_term
        metrics[f"loss/smooth/{s}"] = smooth_term
        total = total + reproj_term + smooth_term
    total = total / n_scales
    metrics["loss/total"] = total
    won = won * (share / n_scales)
    metrics["md2/automask_share"] = won[0]
    for k, (name, _, _) in enumerate(frames):
        metrics[f"md2/source_share/{name}"] = won[k + 1]
    metrics["disp/mean"] = torch.mean(disps[0]) * share
    if mesh is not None:
        metrics = global_metrics(metrics, mesh)
    return total, metrics
