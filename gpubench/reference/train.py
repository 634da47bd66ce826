"""The staged loss graph, one train step and the solver, in plain PyTorch.

Loss graph (the full stage; the configuration's switches select a stage):
the depth net on the target frame, the odometry net on (target, source),
then per scale, coarsest first, a masked L1 of the stereo warp of the
right frame and of the temporal warp of the source frame, and an
edge-aware smoothness term halved per coarser scale; at the finest scale
the temporal warp carries the frozen feature net's features of the source
too, and their masked L1 against the target's features, weighted, is the
feature term. The warps' sources are data: gradients reach depth and pose
through the sample coordinates only.

Solver: the global norm clipped at ``grad_clip_norm``, Adam (bias
corrected, eps outside the root), a learning rate warmed up linearly from
0 over ``warmup_steps`` updates and then Caffe's ``step`` policy, the
frozen feature net left out; the bias corrections and the learning rate
are float32 numbers.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference import geometry as geo
from gpubench.reference import nets


def to_unit(x: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> [-1, 1] float32."""
    return x.float() / 127.5 - 1.0


def masked_l1(pred, target, mask):
    m = mask.float()[:, None]
    return torch.sum(torch.abs(pred - target) * m) / (torch.sum(m) * pred.shape[1] + 1e-6)


def smoothness(disp, img_chw):
    d = disp / (torch.mean(disp, dim=(1, 2, 3), keepdim=True) + 1e-7)
    dx = torch.abs(d[:, :, 1:, :] - d[:, :, :-1, :])
    dy = torch.abs(d[:, 1:, :, :] - d[:, :-1, :, :])
    wx = torch.exp(-torch.mean(torch.abs(img_chw[:, :, :, 1:] - img_chw[:, :, :, :-1]), dim=1))
    wy = torch.exp(-torch.mean(torch.abs(img_chw[:, :, 1:, :] - img_chw[:, :, :-1, :]), dim=1))
    return torch.mean(dx * wx[..., None]) + torch.mean(dy * wy[..., None])


def resize(x_chw, h: int, w: int):
    """Bilinear with half-pixel centres, antialiased when shrinking."""
    if tuple(x_chw.shape[2:]) == (h, w):
        return x_chw
    return F.interpolate(x_chw, size=(h, w), mode="bilinear", align_corners=False,
                         antialias=True)


def losses(config: dict, p: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
           batch: Dict[str, torch.Tensor], train: bool = True, precision: str = "float32"):
    """(total, terms) of the loss graph on one batch (tensors on one
    device; images uint8 NHWC). In train mode ``stats`` moves."""
    if config["model"]["compute_dtype"] not in ("bfloat16", "float32"):
        raise ValueError(f"unknown compute dtype {config['model']['compute_dtype']!r}")
    if config["ssim_weight"] != 0.0 or not config["edge_aware_smoothness"] or config["train_feat"]:
        raise ValueError("the reference covers pure L1, edge-aware smoothness and a frozen "
                         "feature net")
    image_t = to_unit(batch["image_t"])
    K = batch["K"].float()
    B, H, W, _ = image_t.shape
    baseline = batch["baseline"].float().reshape(B)
    disps = nets.depth_net(p, image_t, config["model"], train, stats, precision)
    n = len(disps)
    t_chw = image_t.permute(0, 3, 1, 2)
    hws = [tuple(d.shape[1:3]) for d in disps]
    Kss = [geo.scale_intrinsics(K, w / W, h / H) for h, w in hws]
    depths = [1.0 / d[..., 0] for d in disps]
    terms: Dict[str, torch.Tensor] = {}
    fused = config["use_temporal"] and config["use_feature"]
    if config["use_temporal"]:
        image_s = to_unit(batch["image_s"])
        s_chw = image_s.permute(0, 3, 1, 2)
        T = geo.se3_exp(nets.odom_net(p, torch.cat([image_t, image_s], dim=-1), precision))
    if config["use_stereo"]:
        r_chw = to_unit(batch["image_r"]).permute(0, 3, 1, 2)
    if fused:
        with torch.no_grad():
            feat_t = nets.feat_net(p, t_chw, precision)
            feat_s = nets.feat_net(p, s_chw, precision)
    stereo_total = temporal_total = smooth_total = torch.zeros((), device=image_t.device)
    for i, ((h, w), disp, depth, Ks) in enumerate(zip(hws, disps, depths, Kss)):
        img_t = resize(t_chw, h, w)
        if config["use_stereo"]:
            u, valid = geo.stereo_coords(depth, Ks[:, 0, 0] * baseline, geo.stereo_dmax(config, w))
            warped = geo.stereo_sample(resize(r_chw, h, w), u)
            stereo_total = stereo_total + masked_l1(warped, img_t, valid)
        if config["use_temporal"] and not (fused and (h, w) == (H, W)):
            u, v, valid = geo.general_coords(depth, T, Ks, config["warp_pad_v"])
            warped = geo.general_sample(resize(s_chw, h, w), u, v)
            temporal_total = temporal_total + masked_l1(warped, img_t, valid)
        smooth_total = smooth_total + smoothness(disp, img_t) / (2.0 ** (n - 1 - i))
    if fused:
        u, v, valid = geo.general_coords(depths[-1], T, K, config["warp_pad_v"])
        warped = geo.general_sample(torch.cat([s_chw, feat_s], dim=1), u, v)
        temporal_total = temporal_total + masked_l1(warped[:, :3], t_chw, valid)
        terms["loss/feature"] = config["feature_weight"] * masked_l1(warped[:, 3:], feat_t, valid)
    total = torch.zeros((), device=image_t.device)
    if config["use_stereo"]:
        terms["loss/stereo"] = config["stereo_weight"] * stereo_total / n
    if config["use_temporal"]:
        terms["loss/temporal"] = config["temporal_weight"] * temporal_total / n
    terms["loss/smooth"] = config["smooth_weight"] * smooth_total / n
    for term in terms.values():
        total = total + term
    terms["loss/total"] = total
    return total, terms


def learning_rate(optim: dict, count: int) -> float:
    """The float32 learning rate of update ``count`` (0 first)."""
    f32 = np.float32
    lr = f32(optim["learning_rate"])
    warm = optim["warmup_steps"]
    if warm > 0 and count < warm:
        return float(-lr * (f32(1.0) - f32(count) / f32(warm)) + lr)
    i = count - max(warm, 0)
    if optim["lr_policy"] == "step":
        return float(lr * f32(optim["lr_decay_factor"])
                     ** np.floor(f32(i) / f32(max(1, optim["lr_decay_steps"]))))
    if optim["lr_policy"] == "fixed":
        return float(lr)
    raise ValueError(f"the reference covers lr_policy step and fixed, not {optim['lr_policy']!r}")


class Trainer:
    """The reference's train state and step: parameters, BatchNorm
    statistics and Adam's moments, all float32, on one device."""

    def __init__(self, config: dict, params: Dict[str, torch.Tensor],
                 precision: str = "float32"):
        oc = config["optim"]
        if oc["optimizer"] != "adam" or oc["iter_size"] != 1 or oc["weight_decay"] != 0.0:
            raise ValueError("the reference covers Adam without weight decay, iter_size 1")
        self.config, self.precision = config, precision
        self.names = nets.trainable(config)
        kinds = {name: kind for name, _, kind in nets.specs(config)}
        self.p = {k: v.detach().clone().float() for k, v in params.items()
                  if kinds[k] in nets.TRAINABLE_KINDS}
        self.stats = {k: v.detach().clone() for k, v in params.items()
                      if kinds[k] in ("bn_mean", "bn_var")}
        self.mu = {k: torch.zeros_like(self.p[k]) for k in self.names}
        self.nu = {k: torch.zeros_like(self.p[k]) for k in self.names}
        self.count = 0
        self.first_grads: Dict[str, torch.Tensor] | None = None

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One train step; returns the loss terms."""
        oc = self.config["optim"]
        for k in self.names:
            self.p[k].requires_grad_(True)
        total, terms = losses(self.config, self.p, self.stats, batch, True, self.precision)
        grads = torch.autograd.grad(total, [self.p[k] for k in self.names], allow_unused=True)
        with torch.no_grad():
            grads = [torch.zeros_like(self.p[k]) if g is None else g
                     for k, g in zip(self.names, grads)]
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                         for g in grads]))
            clip = oc["grad_clip_norm"]
            scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
            grads = [g * scale for g in grads]
            if self.first_grads is None:
                self.first_grads = dict(zip(self.names, [g.clone() for g in grads]))
            t = self.count + 1
            b1, b2, eps = oc["beta1"], oc["beta2"], oc["delta"]
            bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
            bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
            lr = learning_rate(oc, self.count)
            for k, g in zip(self.names, grads):
                self.mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
                self.nu[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + eps)
                self.p[k].requires_grad_(False)
                self.p[k].add_(upd * (-lr))
            self.count = t
        return {k: float(v.detach()) for k, v in terms.items()}

