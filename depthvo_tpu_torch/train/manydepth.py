"""ManyDepth's loss graph (``trainer.py``: ``process_batch``,
``predict_poses``, ``generate_images_pred``, ``compute_losses``,
``compute_matching_mask``, ``update_adaptive_depth_bins``), for configs
whose ``architecture`` is ``"manydepth"``; ``train.loop.compute_losses``
hands them here. The phase before ``freeze_teacher_epoch``: the teacher
and the pose net train with the multi-frame net.

  T_-1, T_+1  = PoseNet([I_-1, I_0]) inverted, PoseNet([I_0, I_+1])
  T_match     = PoseNet([I_-1, I_0]) inverted, no_grad    # BN moves a 3rd time
                0 where I_-1 sums to 0
  per row, u = aug_u:  u < 0.25  lookup = I_0 (static camera)
                       u < 0.5   T_match = 0 (zero cost volume)
                       aug = 1 in either case
  teacher     = Monodepth2 DepthNet(I_0)
  disps, lowest, conf = ManyDepthNet(I_0, lookup, K / 4, T_match)
  identity    = min_f reproj(I_f, I_0)                     # once, no gradient
  M           = up(conf) x [|1/up(lowest) - D_t| / D_t < 1 and the
                 converse over 1/up(lowest)] x (1 - aug)   # D_t teacher depth, scale 0
  per scale s, for the teacher (t) and the multi-frame net (m):
    depth = 1 / (min_disp + max_disp * upsample(disp_s to H x W))
    r     = min_f reproj(border warp of I_f at Project3D(depth, K, T_f), I_0)
    t: mask = r <= identity + 1e-5 N(0, 1);  term = sum(r mask) / (sum(mask) + 1e-7)
    m: term = sum(r M) / (sum(M) + 1e-7) + mean(|depth - depth_t.detach()| (1 - M))
    loss_s = term + 1e-3 smooth(disp_s / mean, I_0 at scale s) / 2^s
  total = sum_s loss_s(m) / 4 + sum_s loss_s(t) / 4
  then the trackers move toward the teacher's depth range (train mode).

The order is the public trainer's, which matters for the BatchNorm
running averages: the pose passes (-1, 0), (0, +1) and the matching pass
(-1, 0); the teacher; the multi-frame stem on I_0, then on the lookup
frames. Two sharings of work, neither a change of result: the identity
errors are computed once for both nets (the public code computes them in
each ``compute_losses`` call, from the same images), and the multi-frame
net's tie-breaking noise is not drawn (the public code draws it, then
replaces the auto-mask it would break ties in by ones). The trackers move
in train mode only (the public trainer also moves them in its validation
passes). The batch carries the per-row augmentation draws (``aug_u``,
where the public trainer calls ``random.random()`` per row on the host),
so that a CUDA graph of the step replays them and the reference sees the
same rows; the trackers are buffers of the multi-frame net, read and
moved on the device. Images are (B, H, W, 3) uint8 (or floats in
[-1, 1]) at the entry, (B, 3, H, W) in [0, 1] inside; each scale warps
both nets' two sources at full resolution (16 border warps a step at 4
scales) and the cost volume is one ``cost_volume`` launch.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from depthvo_tpu_torch import ops
from depthvo_tpu_torch.geometry import monodepth2 as geo
from depthvo_tpu_torch.losses import monodepth2 as md2_loss
from depthvo_tpu_torch.models.layers import resize_bilinear_chw
from depthvo_tpu_torch.models.manydepth import MATCHING_SCALE
from depthvo_tpu_torch.train.monodepth2 import NOISE_STD, default_noise, to_md2
from depthvo_tpu_torch.utils import spans

MASK_EPS = 1e-7  # the masked means' normaliser
# The rows' draws: below STATIC_SHARE the static camera, below the sum the
# zero cost volume (trainer.py process_batch).
STATIC_SHARE = ZERO_CV_SHARE = 0.25


def compute_losses(config, models, batch: Dict[str, torch.Tensor], train: bool = False,
                   mesh=None, noise: Callable = default_noise):
    """(total, metrics) of ManyDepth's loss graph on ``batch``: 'image_t'
    (frame 0), 'image_p' (frame -1), 'image_s' (frame +1), 'K' (B, 3, 3)
    at full resolution and, in train mode, 'aug_u' (B,) in [0, 1).
    ``models`` is ``train.state.ManyDepthModels``. In train mode the
    BatchNorm statistics and the multi-frame net's trackers move in place.

    Metrics: ``loss/total``; per scale s ``loss/reproj/{s}``,
    ``loss/consistency/{s}`` and ``loss/smooth/{s}`` (the multi-frame
    net's), ``loss/teacher_reproj/{s}`` and ``loss/teacher_smooth/{s}``;
    ``md2/automask_share`` (the teacher's pixels an identity error wins,
    over every scale); ``mf/confident_share`` (cost-volume pixels with
    every bin valid), ``mf/consistency_share`` (pixels under the
    consistency term), ``mf/static_rows``, ``mf/zero_cv_rows``,
    ``mf/depth_bin_min``, ``mf/depth_bin_max`` (the bins of this step);
    ``disp/mean``. ``noise(shape, like)`` draws the teacher's tie-breaking
    noise (N(0, 1), scaled by ``NOISE_STD``)."""
    if mesh is not None:
        raise ValueError("the manydepth architecture trains on one process (its depth-bin "
                         "trackers are not reduced over a mesh)")
    if not config.use_temporal or config.use_stereo or config.use_feature:
        raise ValueError("manydepth reads frames 0, -1 and +1: use_temporal only")
    with spans.span("mf.loss"):
        return _losses(config, models, batch, train, noise)


def _warped_min(depth, frames, rays, K4, target, ssim_weight):
    """The per-pixel minimum over ``frames`` of the reprojection error of
    each source warped into the target at ``depth``: (B, 1, H, W)."""
    errs = []
    for src, T in frames:
        gx, gy = geo.project_normalised(depth, rays, K4, T)
        errs.append(md2_loss.reprojection_loss(ops.border_warp_chw(src, gx, gy), target,
                                               ssim_weight))
    return torch.min(torch.cat(errs, 1), 1, keepdim=True)[0]


def _losses(config, models, batch, train, noise):
    models.train(train)
    depth_net, pose_net, teacher = models.depth, models.odom, models.teacher
    target, prev, nxt = (to_md2(batch[k]) for k in ("image_t", "image_p", "image_s"))
    B, _, H, W = target.shape
    mc = config.model
    dev = target.device

    # predict_poses: the two pairs with gradients, then the matching pose.
    axisangle, translation = pose_net(torch.cat([prev, target], 1))
    T_prev = geo.transformation_from_parameters(axisangle[:, 0], translation[:, 0], invert=True)
    axisangle, translation = pose_net(torch.cat([target, nxt], 1))
    T_next = geo.transformation_from_parameters(axisangle[:, 0], translation[:, 0])
    with torch.no_grad():
        axisangle, translation = pose_net(torch.cat([prev, target], 1))
        T_match = geo.transformation_from_parameters(axisangle[:, 0], translation[:, 0],
                                                     invert=True)
        T_match = T_match * (prev.flatten(1).sum(1) != 0).float().view(B, 1, 1)
        static = torch.zeros(B, dtype=torch.bool, device=dev)
        zero_cv = static
        if train:  # the static-camera and zero-cost-volume augmentations
            u = batch["aug_u"].float()
            static = u < STATIC_SHARE
            zero_cv = ~static & (u < STATIC_SHARE + ZERO_CV_SHARE)
        lookup = torch.where(static.view(B, 1, 1, 1), target, prev)
        T_match = T_match * (~zero_cv).float().view(B, 1, 1)
        aug = (static | zero_cv).float().view(B, 1, 1, 1)

    t_disps = teacher(target)
    K = batch["K"].float()
    K_match = torch.cat([K[:, :2] / 2 ** MATCHING_SCALE, K[:, 2:]], 1)
    disps, lowest, conf, bins = depth_net(target, lookup, K_match, T_match)

    K4 = geo.homogeneous_K(K)
    rays = geo.pixel_rays(K, H, W)
    frames = ((prev, T_prev), (nxt, T_next))
    with torch.no_grad():
        identity = torch.min(torch.cat([md2_loss.reprojection_loss(src, target,
                                                                   config.ssim_weight)
                                        for src, _ in frames], 1), 1, keepdim=True)[0]

    def depth_at(disp):
        up = disp if disp.shape[-2:] == (H, W) else F.interpolate(
            disp, [H, W], mode="bilinear", align_corners=False)
        return 1.0 / (mc.min_disp + mc.max_disp * up)

    def smooth_term(disp, s):
        h, w = disp.shape[-2:]
        color = target if (h, w) == (H, W) else resize_bilinear_chw(target, h, w)
        return config.smooth_weight * md2_loss.smooth_loss(md2_loss.normalised_disp(disp),
                                                           color) / (2 ** s)

    metrics: Dict[str, torch.Tensor] = {}
    n_scales = len(disps)
    teacher_total = torch.zeros((), device=dev)
    automask = torch.zeros((), device=dev)
    t_depths = []
    for s, disp in enumerate(t_disps):
        depth = depth_at(disp)
        t_depths.append(depth.detach())
        r = _warped_min(depth[:, 0], frames, rays, K4, target, config.ssim_weight)
        with torch.no_grad():
            mask = (r <= identity + noise(identity.shape, identity) * NOISE_STD).float()
            automask += 1.0 - mask.mean()
        reproj = (r * mask).sum() / (mask.sum() + MASK_EPS)
        smooth = smooth_term(disp, s)
        metrics[f"loss/teacher_reproj/{s}"] = reproj
        metrics[f"loss/teacher_smooth/{s}"] = smooth
        teacher_total = teacher_total + (reproj + smooth)

    with torch.no_grad():  # compute_matching_mask and the augmentation mask
        up = [F.interpolate(x.unsqueeze(1), [H, W], mode="nearest") for x in (lowest, conf)]
        matching = 1 / up[0]
        mono = t_depths[0]
        agree = ((matching - mono) / mono < 1.0) & ((mono - matching) / matching < 1.0)
        M = up[1] * agree.float() * (1 - aug)
        outside = 1 - M

    multi_total = torch.zeros((), device=dev)
    for s, disp in enumerate(disps):
        depth = depth_at(disp)
        r = _warped_min(depth[:, 0], frames, rays, K4, target, config.ssim_weight)
        reproj = (r * M).sum() / (M.sum() + MASK_EPS)
        consistency = (torch.abs(depth - t_depths[s]) * outside).mean()
        smooth = smooth_term(disp, s)
        metrics[f"loss/reproj/{s}"] = reproj
        metrics[f"loss/consistency/{s}"] = consistency
        metrics[f"loss/smooth/{s}"] = smooth
        multi_total = multi_total + ((reproj + consistency) + smooth)
    total = multi_total / n_scales + teacher_total / n_scales
    metrics["loss/total"] = total

    if train:
        depth_net.encoder.update_trackers(t_depths[0], 1.0 / (mc.min_disp + mc.max_disp))
    metrics["md2/automask_share"] = automask / n_scales
    metrics["mf/confident_share"] = conf.mean()
    metrics["mf/consistency_share"] = outside.mean()
    metrics["mf/static_rows"] = static.float().sum()
    metrics["mf/zero_cv_rows"] = zero_cv.float().sum()
    metrics["mf/depth_bin_min"] = bins[0]
    metrics["mf/depth_bin_max"] = bins[-1]
    metrics["disp/mean"] = torch.mean(disps[0])
    return total, metrics
