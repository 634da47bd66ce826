"""ManyDepth (Watson et al., "The Temporal Opportunist", CVPR 2021,
arXiv:2104.14540; github.com/nianticlabs/manydepth) in plain PyTorch, and
its train step: the benchmark's frozen copy of the repository's
``references/manydepth.py`` (which holds the port to it in the CPU
tests), kept here so that later changes cannot move the yardstick, with
one addition: the control's rounding (``precision``, through
:mod:`gpubench.reference.monodepth2`'s networks, which round where the
system holds a tensor in bfloat16 under autocast; the cost volume reads
the rounded feature maps).

What the repository's copy says of the public code holds here. It
follows ``networks/resnet_encoder.py`` (``ResnetEncoderMatching``) and
``trainer.py`` (``process_batch``, ``predict_poses``, the static-camera
and zero-cost-volume augmentations, ``generate_images_pred``,
``compute_losses``, ``compute_matching_mask``,
``update_adaptive_depth_bins``) function by function, for the KITTI_HR
options in the phase before ``freeze_teacher_epoch``; Monodepth2's
networks, geometry and losses are :mod:`gpubench.reference.monodepth2`'s.
The networks are functions of one flat parameter dict keyed
``"<net>.<path>"`` (``depth.*`` the multi-frame net, ``odom.*`` the pose
net, ``teacher.*`` the Monodepth2 teacher); the depth-bin trackers are
Python floats, as the public trainer's.

Departures from the public code: those of the Monodepth2 reference that
apply (no colour or flip augmentation, random weights, the smoothness
pyramid's downscale, BatchNorm's biased running variance, ``inv_K`` by a
float64 inverse, the tie-breaking noise from the caller, TF32 off); the
per-row augmentation draws from the batch (``aug_u``) where the public
trainer calls ``random.random()``; ``K`` at the matching scale as the
batch's full-resolution ``K`` with its first two rows over 4; no
validation passes.

It imports nothing of the port, of the JAX package or of JAX
(``gpubench/tests/test_gpubench_guard.py`` checks it).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference import monodepth2 as md2

NUM_DEPTH_BINS = 96  # options.py num_depth_bins, linear binning
MIN_DEPTH_TRACKER, MAX_DEPTH_TRACKER = 0.1, 10.0  # trainer.py's start
STATIC_SHARE = ZERO_CV_SHARE = 0.25  # process_batch's augmentation draws
FRAME_IDS = (0, -1, 1)
MATCHING_IDS = (0, -1)
FRAME_KEYS = {0: "image_t", -1: "image_p", 1: "image_s"}
MATCHING_SCALE = 2
TRAINABLE_KINDS = md2.TRAINABLE_KINDS


# --------------------------------------------------------------------------
# Parameter layout.
# --------------------------------------------------------------------------


def matching_encoder_specs(prefix: str) -> list:
    """``ResnetEncoderMatching``'s parameters and buffers under ``prefix``,
    in its state dict's order: the two trackers (kind ``tracker``), then
    torchvision's ResNet18 body renamed as the public module holds it, then
    ``reduce_conv``."""
    out = [(f"{prefix}min_depth_bin", (), "tracker"), (f"{prefix}max_depth_bin", (), "tracker")]
    for name, shape, kind in md2.encoder_specs("", 1):
        name = name.replace("conv1.", "layer0.0.", 1) if name.startswith("conv1.") else name
        name = name.replace("bn1.", "layer0.1.", 1) if name.startswith("bn1.") else name
        name = name.replace("layer1.", "layer1.1.", 1) if name.startswith("layer1.") else name
        out.append((prefix + name, shape, kind))
    md2._conv_spec(out, f"{prefix}reduce_conv.0", md2.NUM_CH_ENC[1] + NUM_DEPTH_BINS,
                   md2.NUM_CH_ENC[1], 3, True)
    return out


def specs(num_scales: int = 4, num_ch_dec=md2.NUM_CH_DEC) -> list:
    """Every parameter and buffer of the multi-frame depth net
    ("depth.*"), the pose net ("odom.*") and the teacher ("teacher.*") as
    (name, shape, kind), in the port's order."""
    scales = range(num_scales)
    return (matching_encoder_specs("depth.encoder.")
            + md2.depth_decoder_specs("depth.decoder.", scales, num_ch_dec)
            + md2.encoder_specs("odom.encoder.encoder.", 2)
            + md2.pose_decoder_specs("odom.decoder.")
            + md2.encoder_specs("teacher.encoder.encoder.", 1)
            + md2.depth_decoder_specs("teacher.decoder.", scales, num_ch_dec))


# --------------------------------------------------------------------------
# ResnetEncoderMatching.
# --------------------------------------------------------------------------


def feature_extraction(p, stats, prefix: str, image, train: bool,
                       return_all_feats: bool = False):
    """The first two blocks of the ResNet18: [layer0, layer1] or layer1."""
    image = (image - 0.45) / 0.225
    x = md2.conv(image, p, f"{prefix}layer0.0", 2, 3)
    feats_0 = F.relu(md2.batch_norm(x, p, stats, f"{prefix}layer0.1", train))
    x = F.max_pool2d(feats_0, 3, 2, 1)
    for j in range(2):
        x = md2.basic_block(x, p, stats, f"{prefix}layer1.1.{j}", 1, train)
    return [feats_0, x] if return_all_feats else x


def compute_depth_bins(min_depth_bin: float, max_depth_bin: float, num_depth_bins: int,
                       height: int, width: int, device) -> tuple:
    """Linear bins: (depth_bins (D,), warp_depths (D, 1, h, w)), float32."""
    depth_bins = torch.from_numpy(np.linspace(min_depth_bin, max_depth_bin,
                                              num_depth_bins)).float()
    warp_depths = torch.stack([torch.ones((1, height, width)) * d for d in depth_bins], 0)
    return depth_bins.to(device), warp_depths.float().to(device)


def match_features(current_feats, lookup_feats, relative_poses, K, invK, warp_depths):
    """The cost volume (B, D, h, w), missing bins set to their pixel's
    maximum, and the mask of missing bins, by ``grid_sample`` on D copies
    of each lookup map, row by row."""
    num_depth_bins, _, h, w = warp_depths.shape
    batch_cost_volume = []
    cost_volume_masks = []
    for batch_idx in range(len(current_feats)):
        volume_shape = (num_depth_bins, h, w)
        cost_volume = torch.zeros(volume_shape, dtype=torch.float, device=current_feats.device)
        counts = torch.zeros(volume_shape, dtype=torch.float, device=current_feats.device)
        _lookup_feats = lookup_feats[batch_idx:batch_idx + 1]
        _lookup_poses = relative_poses[batch_idx:batch_idx + 1]
        _K = K[batch_idx:batch_idx + 1]
        _invK = invK[batch_idx:batch_idx + 1]
        world_points = md2.backproject_depth(warp_depths, _invK, h, w)
        for lookup_idx in range(_lookup_feats.shape[1]):
            lookup_feat = _lookup_feats[:, lookup_idx]
            lookup_pose = _lookup_poses[:, lookup_idx]
            if lookup_pose.sum() == 0:  # ignore missing images
                continue
            lookup_feat = lookup_feat.repeat([num_depth_bins, 1, 1, 1])
            pix_locs = md2.project_3d(world_points, _K, lookup_pose, h, w)
            warped = F.grid_sample(lookup_feat, pix_locs, padding_mode="zeros", mode="bilinear",
                                   align_corners=True)
            x_vals = (pix_locs[..., 0].detach() / 2 + 0.5) * (w - 1)
            y_vals = (pix_locs[..., 1].detach() / 2 + 0.5) * (h - 1)
            edge_mask = (x_vals >= 2.0) * (x_vals <= w - 2) * (y_vals >= 2.0) * (y_vals <= h - 2)
            edge_mask = edge_mask.float()
            current_mask = torch.zeros_like(edge_mask)
            current_mask[:, 2:-2, 2:-2] = 1.0
            edge_mask = edge_mask * current_mask
            diffs = torch.abs(warped - current_feats[batch_idx:batch_idx + 1]).mean(1) * edge_mask
            cost_volume = cost_volume + diffs
            counts = counts + (diffs > 0).float()
        cost_volume = cost_volume / (counts + 1e-7)
        missing_val_mask = (cost_volume == 0).float()
        cost_volume = (cost_volume * (1 - missing_val_mask)
                       + cost_volume.max(0)[0].unsqueeze(0) * missing_val_mask)
        batch_cost_volume.append(cost_volume)
        cost_volume_masks.append(missing_val_mask)
    return torch.stack(batch_cost_volume, 0), torch.stack(cost_volume_masks, 0)


def compute_confidence_mask(cost_volume, num_bins_threshold: int):
    """1 where every depth bin was observed."""
    return ((cost_volume > 0).sum(1) == num_bins_threshold).float()


def indices_to_disparity(depth_bins, indices):
    """Cost-volume indices to 1 / depth."""
    batch, height, width = indices.shape
    depth = depth_bins[indices.reshape(-1)]
    return 1 / depth.reshape((batch, height, width))


def lowest_cost_and_volume(cost_volume, missing_mask, depth_bins):
    """``forward``'s tail after ``match_features``: (confidence, lowest
    cost, the volume times the confidence)."""
    confidence_mask = compute_confidence_mask(cost_volume.detach()
                                              * (1 - missing_mask.detach()), len(depth_bins))
    viz_cost_vol = cost_volume.clone().detach()
    viz_cost_vol[viz_cost_vol == 0] = 100
    _, argmin = torch.min(viz_cost_vol, 1)
    lowest_cost = indices_to_disparity(depth_bins, argmin)
    cost_volume = cost_volume * confidence_mask.unsqueeze(1)
    return confidence_mask, lowest_cost, cost_volume


def matching_encoder(p, stats, prefix: str, current_image, lookup_images, poses, K, invK,
                     min_depth_bin: float, max_depth_bin: float, train: bool,
                     num_depth_bins: int = NUM_DEPTH_BINS):
    """``ResnetEncoderMatching.forward``: (features, lowest_cost,
    confidence_mask); ``lookup_images`` (B, F, 3, H, W), ``poses`` (B, F,
    4, 4), ``K`` and ``invK`` (B, 4, 4) at the matching scale."""
    features = feature_extraction(p, stats, prefix, current_image, train, True)
    current_feats = features[-1]
    with torch.no_grad():
        h, w = current_feats.shape[-2:]
        depth_bins, warp_depths = compute_depth_bins(min_depth_bin, max_depth_bin,
                                                     num_depth_bins, h, w, current_feats.device)
        batch_size, num_frames, chns, height, width = lookup_images.shape
        lookup_images = lookup_images.reshape(batch_size * num_frames, chns, height, width)
        lookup_feats = feature_extraction(p, stats, prefix, lookup_images, train)
        _, chns, height, width = lookup_feats.shape
        lookup_feats = lookup_feats.reshape(batch_size, num_frames, chns, height, width)
        cost_volume, missing_mask = match_features(current_feats, lookup_feats, poses, K, invK,
                                                   warp_depths)
    confidence_mask, lowest_cost, cost_volume = lowest_cost_and_volume(cost_volume,
                                                                       missing_mask, depth_bins)
    x = F.relu(md2.conv(torch.cat([features[-1], cost_volume], 1), p,
                        f"{prefix}reduce_conv.0", 1, 1))
    for layer in (2, 3, 4):
        for j in range(2):
            x = md2.basic_block(x, p, stats, f"{prefix}layer{layer}.{j}", 2 if j == 0 else 1,
                                train)
        features.append(x)
    return features, lowest_cost, confidence_mask


# --------------------------------------------------------------------------
# The trainer.
# --------------------------------------------------------------------------


def generate_images_pred(inputs, outputs, opt):
    """Each scale's depth at full size, and the sources warped by it."""
    H, W = opt["height"], opt["width"]
    for scale in opt["scales"]:
        disp = F.interpolate(outputs[("disp", scale)], [H, W], mode="bilinear",
                             align_corners=False)
        _, depth = md2.disp_to_depth(disp, opt["min_depth"], opt["max_depth"])
        outputs[("depth", 0, scale)] = depth
        for frame_id in FRAME_IDS[1:]:
            T = outputs[("cam_T_cam", 0, frame_id)]
            cam_points = md2.backproject_depth(depth, inputs[("inv_K", 0)], H, W)
            pix_coords = md2.project_3d(cam_points, inputs[("K", 0)], T, H, W)
            outputs[("color", frame_id, scale)] = F.grid_sample(
                inputs[("color", frame_id, 0)], pix_coords, padding_mode="border",
                align_corners=True)


def compute_loss_masks(reprojection_loss, identity_reprojection_loss):
    """Auto-masking: 1 where the reprojection error beats the identity."""
    all_losses = torch.cat([reprojection_loss, identity_reprojection_loss], dim=1)
    idxs = torch.argmin(all_losses, dim=1, keepdim=True)
    return (idxs == 0).float()


def compute_losses(inputs, outputs, opt, noise, is_multi: bool) -> Dict[str, torch.Tensor]:
    """One net's losses: ``reproj_loss/{s}``, ``consistency_loss/{s}``
    (multi-frame), ``smooth_loss/{s}``, ``loss/{s}``, ``loss`` and, for the
    teacher, ``automask_share``."""
    losses = {}
    total_loss = 0
    target = inputs[("color", 0, 0)]
    automask = 0.0
    for scale in opt["scales"]:
        loss = 0
        disp = outputs[("disp", scale)]
        color = inputs[("color", 0, scale)]
        reprojection_losses = torch.cat([md2.compute_reprojection_loss(
            outputs[("color", frame_id, scale)], target) for frame_id in FRAME_IDS[1:]], 1)
        identity_reprojection_losses = torch.cat([md2.compute_reprojection_loss(
            inputs[("color", frame_id, 0)], target) for frame_id in FRAME_IDS[1:]], 1)
        # differently to Monodepth2, compute mins as we go
        identity_reprojection_loss, _ = torch.min(identity_reprojection_losses, dim=1,
                                                  keepdim=True)
        reprojection_loss, _ = torch.min(reprojection_losses, dim=1, keepdim=True)
        identity_reprojection_loss = (identity_reprojection_loss
                                      + noise(identity_reprojection_loss.shape) * 0.00001)
        reprojection_loss_mask = compute_loss_masks(reprojection_loss,
                                                    identity_reprojection_loss)
        automask += float(1 - reprojection_loss_mask.mean())
        if is_multi:
            reprojection_loss_mask = torch.ones_like(reprojection_loss_mask)
            reprojection_loss_mask = (reprojection_loss_mask
                                      * outputs["consistency_mask"].unsqueeze(1))
            reprojection_loss_mask = reprojection_loss_mask * (1 - outputs["augmentation_mask"])
            consistency_mask = (1 - reprojection_loss_mask).float()
        reprojection_loss = reprojection_loss * reprojection_loss_mask
        reprojection_loss = reprojection_loss.sum() / (reprojection_loss_mask.sum() + 1e-7)
        if is_multi:
            multi_depth = outputs[("depth", 0, scale)]
            mono_depth = outputs[("mono_depth", 0, scale)].detach()
            consistency_loss = torch.abs(multi_depth - mono_depth) * consistency_mask
            consistency_loss = consistency_loss.mean()
            losses[f"consistency_loss/{scale}"] = consistency_loss
            outputs["consistency_share"] = consistency_mask.mean()
        else:
            consistency_loss = 0
        losses[f"reproj_loss/{scale}"] = reprojection_loss
        loss += reprojection_loss + consistency_loss
        mean_disp = disp.mean(2, True).mean(3, True)
        norm_disp = disp / (mean_disp + 1e-7)
        smooth_loss = md2.get_smooth_loss(norm_disp, color)
        losses[f"smooth_loss/{scale}"] = opt["disparity_smoothness"] * smooth_loss / (2 ** scale)
        loss += opt["disparity_smoothness"] * smooth_loss / (2 ** scale)
        total_loss += loss
        losses[f"loss/{scale}"] = loss
    total_loss /= len(opt["scales"])
    losses["loss"] = total_loss
    losses["automask_share"] = automask / len(opt["scales"])
    return losses


def compute_matching_mask(outputs):
    """Where the cost volume's lowest cost and the teacher disagree by a
    factor of 2 or more: 0."""
    mono_output = outputs[("mono_depth", 0, 0)]
    matching_depth = 1 / outputs["lowest_cost"].unsqueeze(1).to(mono_output.device)
    mask = ((matching_depth - mono_output) / mono_output) < 1.0
    mask *= ((mono_output - matching_depth) / matching_depth) < 1.0
    return mask[:, 0]


def update_adaptive_depth_bins(outputs, trackers: Dict[str, float], min_depth: float) -> None:
    """The trackers' exponential moving averages toward the teacher's
    depth range, in Python floats."""
    min_depth_ = outputs[("mono_depth", 0, 0)].detach().min(-1)[0].min(-1)[0]
    max_depth_ = outputs[("mono_depth", 0, 0)].detach().max(-1)[0].max(-1)[0]
    min_depth_ = min_depth_.mean().cpu().item()
    max_depth_ = max_depth_.mean().cpu().item()
    min_depth_ = max(min_depth, min_depth_ * 0.9)
    max_depth_ = max_depth_ * 1.1
    trackers["max"] = trackers["max"] * 0.99 + max_depth_ * 0.01
    trackers["min"] = trackers["min"] * 0.99 + min_depth_ * 0.01


def predict_poses(p, stats, inputs, outputs, train: bool) -> None:
    """The pose to each source frame, then the matching pose without
    gradients (a zero pose where the lookup image sums to 0)."""
    pose_feats = {f_i: inputs[("color", f_i, 0)] for f_i in FRAME_IDS}
    for f_i in FRAME_IDS[1:]:
        pose_inputs = ([pose_feats[f_i], pose_feats[0]] if f_i < 0
                       else [pose_feats[0], pose_feats[f_i]])
        pose_inputs = [md2.resnet_encoder(p, stats, "odom.encoder.encoder.",
                                          torch.cat(pose_inputs, 1), train)]
        axisangle, translation = md2.pose_decoder(p, "odom.decoder.", pose_inputs)
        outputs[("cam_T_cam", 0, f_i)] = md2.transformation_from_parameters(
            axisangle[:, 0], translation[:, 0], invert=(f_i < 0))
    pose_feats = {f_i: inputs[("color", f_i, 0)] for f_i in MATCHING_IDS}
    with torch.no_grad():
        for fi in MATCHING_IDS[1:]:
            pose_inputs = [pose_feats[fi], pose_feats[fi + 1]]
            pose_inputs = [md2.resnet_encoder(p, stats, "odom.encoder.encoder.",
                                              torch.cat(pose_inputs, 1), train)]
            axisangle, translation = md2.pose_decoder(p, "odom.decoder.", pose_inputs)
            pose = md2.transformation_from_parameters(axisangle[:, 0], translation[:, 0],
                                                      invert=True)
            for batch_idx, feat in enumerate(pose_feats[fi]):
                if feat.sum() == 0:
                    pose[batch_idx] *= 0
            inputs[("relative_pose", fi)] = pose


def forward(p: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
            trackers: Dict[str, float], batch: Dict[str, torch.Tensor], opt: dict,
            noise: Callable[[tuple], torch.Tensor], train: bool = True,
            precision: str = "float32"):
    """:func:`_forward` in ``precision`` ("float32", or the control's "fp8"),
    which :mod:`gpubench.reference.monodepth2`'s networks apply."""
    md2._PRECISION[0] = precision
    try:
        return _forward(p, stats, trackers, batch, opt, noise, train)
    finally:
        md2._PRECISION[0] = "float32"


def _forward(p, stats, trackers, batch, opt, noise, train):
    """One ``process_batch`` of the trainer: (total, terms, outputs); in
    train mode ``stats`` and ``trackers`` ({"min", "max"}) move.

    ``batch``: 'image_t', 'image_p', 'image_s' (B, H, W, 3) uint8 (frames
    0, -1, +1), 'K' (B, 3, 3) at full resolution, 'aug_u' (B,) in [0, 1).
    ``opt``: :func:`options`. ``noise(shape)``: N(0, 1) draws for the
    tie-breaking noise, one call per scale and net. ``terms``: the port's
    metric names."""
    H, W = opt["height"], opt["width"]
    scales = list(opt["scales"])
    inputs = {("color", f, 0): md2.to_color(batch[FRAME_KEYS[f]]) for f in FRAME_IDS}
    for s in scales[1:]:
        inputs[("color", 0, s)] = md2.downscale(inputs[("color", 0, 0)], H // 2 ** s,
                                                W // 2 ** s)
    B = inputs[("color", 0, 0)].shape[0]
    K3 = batch["K"].float()
    for scale, factor in ((0, 1.0), (MATCHING_SCALE, 1.0 / 2 ** MATCHING_SCALE)):
        K = torch.zeros(B, 4, 4, device=K3.device)
        K[:, :2, :3] = K3[:, :2] * factor
        K[:, 2, :3] = K3[:, 2]
        K[:, 3, 3] = 1
        inputs[("K", scale)] = K
        inputs[("inv_K", scale)] = torch.linalg.inv(K.double()).float()

    outputs: Dict = {}
    predict_poses(p, stats, inputs, outputs, train)
    relative_poses = torch.stack([inputs[("relative_pose", idx)] for idx in MATCHING_IDS[1:]], 1)
    lookup_frames = torch.stack([inputs[("color", idx, 0)] for idx in MATCHING_IDS[1:]], 1)

    # the static-camera and zero-cost-volume augmentations
    augmentation_mask = torch.zeros([B, 1, 1, 1], device=K3.device).float()
    static_rows = zero_cv_rows = 0
    if train:
        for batch_idx in range(B):
            rand_num = float(batch["aug_u"][batch_idx])
            if rand_num < opt["static_share"]:
                replace_frames = [inputs[("color", 0, 0)][batch_idx] for _ in MATCHING_IDS[1:]]
                lookup_frames[batch_idx] = torch.stack(replace_frames, 0)
                augmentation_mask[batch_idx] += 1
                static_rows += 1
            elif rand_num < opt["static_share"] + opt["zero_cv_share"]:
                relative_poses[batch_idx] *= 0
                augmentation_mask[batch_idx] += 1
                zero_cv_rows += 1
    outputs["augmentation_mask"] = augmentation_mask

    # the teacher
    mono_outputs = {k: v for k, v in outputs.items() if k[0] == "cam_T_cam"}
    feats = md2.resnet_encoder(p, stats, "teacher.encoder.encoder.", inputs[("color", 0, 0)],
                               train)
    for s, d in md2.depth_decoder(p, "teacher.decoder.", feats, scales).items():
        mono_outputs[s] = d
    generate_images_pred(inputs, mono_outputs, opt)
    mono_losses = compute_losses(inputs, mono_outputs, opt, noise, is_multi=False)
    for s in scales:
        outputs[("mono_depth", 0, s)] = mono_outputs[("depth", 0, s)]

    # the multi-frame net
    features, lowest_cost, confidence_mask = matching_encoder(
        p, stats, "depth.encoder.", inputs[("color", 0, 0)], lookup_frames, relative_poses,
        inputs[("K", MATCHING_SCALE)], inputs[("inv_K", MATCHING_SCALE)], trackers["min"],
        trackers["max"], train, opt["num_depth_bins"])
    outputs.update(md2.depth_decoder(p, "depth.decoder.", features, scales))
    outputs["lowest_cost"] = F.interpolate(lowest_cost.unsqueeze(1), [H, W],
                                           mode="nearest")[:, 0]
    outputs["consistency_mask"] = F.interpolate(confidence_mask.unsqueeze(1), [H, W],
                                                mode="nearest")[:, 0]
    outputs["consistency_mask"] = outputs["consistency_mask"] * compute_matching_mask(outputs)
    generate_images_pred(inputs, outputs, opt)
    losses = compute_losses(inputs, outputs, opt, noise, is_multi=True)
    total = losses["loss"] + mono_losses["loss"]

    bins = compute_depth_bins(trackers["min"], trackers["max"], opt["num_depth_bins"], 1, 1,
                              "cpu")[0]
    if train:
        update_adaptive_depth_bins(outputs, trackers, opt["min_depth"])

    terms = {"loss/total": total}
    for s in scales:
        terms[f"loss/reproj/{s}"] = losses[f"reproj_loss/{s}"]
        terms[f"loss/consistency/{s}"] = losses[f"consistency_loss/{s}"]
        terms[f"loss/smooth/{s}"] = losses[f"smooth_loss/{s}"]
        terms[f"loss/teacher_reproj/{s}"] = mono_losses[f"reproj_loss/{s}"]
        terms[f"loss/teacher_smooth/{s}"] = mono_losses[f"smooth_loss/{s}"]
    terms["md2/automask_share"] = mono_losses["automask_share"]
    terms["mf/confident_share"] = confidence_mask.mean()
    terms["mf/consistency_share"] = outputs["consistency_share"]
    terms["mf/static_rows"] = float(static_rows)
    terms["mf/zero_cv_rows"] = float(zero_cv_rows)
    terms["mf/depth_bin_min"] = float(bins[0])
    terms["mf/depth_bin_max"] = float(bins[-1])
    return total, terms, outputs


def options(config: dict) -> dict:
    """ManyDepth's options from the port's config as a dict."""
    m = config["model"]
    return {"height": m["height"], "width": m["width"], "scales": list(range(m["num_scales"])),
            "min_depth": 1.0 / (m["min_disp"] + m["max_disp"]), "max_depth": 1.0 / m["min_disp"],
            "disparity_smoothness": config["smooth_weight"],
            "num_depth_bins": NUM_DEPTH_BINS, "static_share": STATIC_SHARE,
            "zero_cv_share": ZERO_CV_SHARE}


# --------------------------------------------------------------------------
# The train step.
# --------------------------------------------------------------------------


def trainable(config: dict) -> List[str]:
    """The parameters the solver updates, in the system's order."""
    m = config["model"]
    return [n for n, _, k in specs(m["num_scales"], tuple(reversed(m["decoder_features"])))
            if k in TRAINABLE_KINDS]


class Trainer:
    """The train state and step: parameters, BatchNorm statistics, the
    trackers and Adam's moments (bias-corrected in float32, eps outside the
    root, the ``step`` learning-rate policy, no clip), float32, on one
    device; the forward in ``precision``. ``noise_seed`` seeds the
    tie-breaking noise's generator there."""

    def __init__(self, config: dict, params: Dict[str, torch.Tensor],
                 precision: str = "float32", noise_seed: int = 0):
        oc = config["optim"]
        if (oc["optimizer"] != "adam" or oc["iter_size"] != 1 or oc["weight_decay"] != 0.0
                or oc["grad_clip_norm"] is not None or oc["warmup_steps"] != 0
                or oc["lr_policy"] != "step"):
            raise ValueError("the reference covers Adam without weight decay, clip or warm-up, "
                             "iter_size 1, the step policy")
        if config["architecture"] != "manydepth":
            raise ValueError("the reference covers ManyDepth")
        self.config, self.precision = config, precision
        self.opt = options(config)
        self.names = trainable(config)
        self.p = {k: params[k].detach().clone().float() for k in self.names}
        self.stats = {k: v.detach().clone() for k, v in params.items()
                      if k.endswith(("running_mean", "running_var"))}
        self.trackers = {"min": float(params["depth.encoder.min_depth_bin"]),
                         "max": float(params["depth.encoder.max_depth_bin"])}
        self.mu = {k: torch.zeros_like(self.p[k]) for k in self.names}
        self.nu = {k: torch.zeros_like(self.p[k]) for k in self.names}
        self.count = 0
        self.first_grads: Dict[str, torch.Tensor] | None = None
        device = next(iter(self.p.values())).device
        self.gen = torch.Generator(device=device).manual_seed(noise_seed)

    def noise(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.gen.device)

    def forward(self, batch, train: bool = True):
        return forward(self.p, self.stats, self.trackers, batch, self.opt, self.noise, train,
                       self.precision)

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One train step; returns the loss terms and the shares."""
        oc = self.config["optim"]
        for k in self.names:
            self.p[k].requires_grad_(True)
        total, terms, _ = self.forward(batch)
        grads = torch.autograd.grad(total, [self.p[k] for k in self.names], allow_unused=True)
        with torch.no_grad():
            grads = [torch.zeros_like(self.p[k]) if g is None else g
                     for k, g in zip(self.names, grads)]
            if self.first_grads is None:
                self.first_grads = dict(zip(self.names, [g.clone() for g in grads]))
            t = self.count + 1
            b1, b2, eps = oc["beta1"], oc["beta2"], oc["delta"]
            bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
            bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
            f32 = np.float32
            lr = float(f32(oc["learning_rate"]) * f32(oc["lr_decay_factor"]) ** np.floor(
                f32(self.count) / f32(max(1, oc["lr_decay_steps"]))))
            for k, g in zip(self.names, grads):
                self.mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
                self.nu[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + eps)
                self.p[k].requires_grad_(False)
                self.p[k].add_(upd * (-lr))
            self.count = t
        return {k: float(torch.as_tensor(v).detach()) for k, v in terms.items()}
