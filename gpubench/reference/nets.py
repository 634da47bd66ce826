"""DepthNet, OdomNet and FeatNet as plain functions of a flat parameter dict.

Parameters are keyed ``"<net>.<path>"`` with the networks' published
layout (Depth-VO-Feat, Zhan et al., CVPR 2018, arXiv:1803.03893, as the
system builds it): a ResNet50-1by2 encoder (7x7/2 stem of 32, bottleneck
stages [3, 4, 6, 3] with planes [32, 64, 128, 256]) and a five-stage
nearest-upsample decoder with skips predicting ``max_disp * sigmoid + min_disp``
at the last ``num_scales`` resolutions; a seven-conv odometry net with two
dense layers of 512 and a 6-vector twist scaled by 0.01; a dilated feature
net with L2-normalised outputs. Convolutions pad as XLA's ``SAME``
(asymmetric on stride 2). BatchNorm is flax's (momentum 0.95, eps 1e-5,
the biased variance folded into the running one). Everything runs in
float32, or with :mod:`precision`'s control rounding where the system holds bfloat16.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from gpubench.reference.precision import rnd

BN_EPS = 1e-5
BN_MOMENTUM = 0.95
STAGE_PLANES = (32, 64, 128, 256)
STAGE_BLOCKS = (3, 4, 6, 3)
STEM = 32
ODOM_CONVS = (16, 32, 64, 128, 256, 256, 256)
ODOM_FC = (512, 512)
ODOM_SCALE = 0.01
FEAT_CONVS = (32, 64, 64)
FEAT_DILATIONS = (1, 2, 4)


# --------------------------------------------------------------------------
# Parameter layout.
# --------------------------------------------------------------------------


def _conv_spec(specs, name, cin, cout, k, bias):
    specs.append((f"{name}.weight", (cout, cin, k, k), "conv"))
    if bias:
        specs.append((f"{name}.bias", (cout,), "bias"))


def _block_spec(specs, name, cin, cout, k, use_bn):
    _conv_spec(specs, f"{name}.Conv_0", cin, cout, k, not use_bn)
    if use_bn:
        for leaf, kind in (("weight", "bn_scale"), ("bias", "bn_bias"),
                           ("running_mean", "bn_mean"), ("running_var", "bn_var"),
                           ("num_batches_tracked", "bn_count")):
            specs.append((f"{name}.BatchNorm_0.{leaf}", () if kind == "bn_count" else (cout,),
                          kind))


def depth_specs(model: dict) -> List[Tuple[str, tuple, str]]:
    specs: list = []
    _block_spec(specs, "ConvBlock_0", 3, STEM, 7, True)
    skip_ch, cin = [STEM], STEM
    for i, (planes, blocks) in enumerate(zip(STAGE_PLANES, STAGE_BLOCKS)):
        for j in range(blocks):
            name = f"ResNetStage_{i}.Bottleneck_{j}"
            stride = (1 if i == 0 else 2) if j == 0 else 1
            out = 4 * planes
            _block_spec(specs, f"{name}.ConvBlock_0", cin, planes, 1, True)
            _block_spec(specs, f"{name}.ConvBlock_1", planes, planes, 3, True)
            _block_spec(specs, f"{name}.ConvBlock_2", planes, out, 1, True)
            if cin != out or stride != 1:
                _block_spec(specs, f"{name}.ConvBlock_3", cin, out, 1, True)
            cin = out
        skip_ch.append(cin)
    decoder = tuple(model["decoder_features"])
    heads = 0
    for i, feats in enumerate(decoder):
        _block_spec(specs, f"UpConv_{i}.ConvBlock_0", cin, feats, 3, False)
        skip_idx = len(skip_ch) - 2 - i
        cat = feats + (skip_ch[skip_idx] if skip_idx >= 0 else 0)
        _block_spec(specs, f"ConvBlock_{i + 1}", cat, feats, 3, False)
        if i - (len(decoder) - model["num_scales"]) >= 0:
            _conv_spec(specs, f"Conv_{heads}", feats, 1, 3, True)
            heads += 1
        cin = feats
    return specs


def odom_specs() -> List[Tuple[str, tuple, str]]:
    specs: list = []
    cin = 6
    for i, feats in enumerate(ODOM_CONVS):
        _block_spec(specs, f"ConvBlock_{i}", cin, feats, 7 if i == 0 else (5 if i == 1 else 3),
                    False)
        cin = feats
    for i, feats in enumerate(ODOM_FC + (6,)):
        specs.append((f"Dense_{i}.weight", (feats, cin), "dense"))
        specs.append((f"Dense_{i}.bias", (feats,), "twist" if i == len(ODOM_FC) else "bias"))
        cin = feats
    return specs


def feat_specs(model: dict) -> List[Tuple[str, tuple, str]]:
    specs: list = []
    cin = 3
    for i, feats in enumerate(FEAT_CONVS):
        _block_spec(specs, f"ConvBlock_{i}", cin, feats, 3, False)
        cin = feats
    _conv_spec(specs, "Conv_0", cin, model["feat_channels"], 3, True)
    return specs


def nets_of(config: dict) -> Tuple[str, ...]:
    """The networks a stage uses."""
    return ("depth",) + (("odom",) if config["use_temporal"] else ()) + (
        ("feat",) if config["use_feature"] else ())


def specs(config: dict) -> List[Tuple[str, tuple, str]]:
    """Every parameter and buffer of the stage as ("net.path", shape, kind)."""
    per = {"depth": depth_specs(config["model"]), "odom": odom_specs(),
           "feat": feat_specs(config["model"])}
    return [(f"{net}.{name}", shape, kind) for net in nets_of(config)
            for name, shape, kind in per[net]]


TRAINABLE_KINDS = ("conv", "bias", "bn_scale", "bn_bias", "dense", "twist")


def trainable(config: dict) -> List[str]:
    """The parameters the solver updates, in the system's order (the
    frozen feature net is left out)."""
    return [name for name, _, kind in specs(config)
            if kind in TRAINABLE_KINDS and (config["train_feat"] or not name.startswith("feat."))]


# --------------------------------------------------------------------------
# Layers.
# --------------------------------------------------------------------------


def same_pads(size: int, kernel: int, stride: int, dilation: int = 1):
    eff = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def conv(x, w, b, stride=1, dilation=1, precision="float32"):
    k = w.shape[-1]
    ph = same_pads(x.shape[-2], k, stride, dilation)
    pw = same_pads(x.shape[-1], k, stride, dilation)
    x = F.pad(rnd(x, precision), (pw[0], pw[1], ph[0], ph[1]))
    return rnd(F.conv2d(x, rnd(w, precision), b, stride, 0, dilation), precision)


def batch_norm(x, p: Dict[str, torch.Tensor], name: str, train: bool, stats: Dict,
               precision: str = "float32"):
    """flax BatchNorm on (B, C, H, W). In train mode the batch's mean and
    biased variance normalise, and ``stats`` (running averages keyed like
    the parameters) move 5% towards them."""
    g, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
        with torch.no_grad():
            for key, value in (("running_mean", mean), ("running_var", var)):
                prev = stats[f"{name}.{key}"]
                stats[f"{name}.{key}"] = BN_MOMENTUM * prev + (1.0 - BN_MOMENTUM) * value.detach()
    else:
        mean, var = stats[f"{name}.running_mean"], stats[f"{name}.running_var"]
    inv = torch.rsqrt(var + BN_EPS) * g
    return rnd((x - mean[None, :, None, None]) * inv[None, :, None, None]
               + b[None, :, None, None], precision)


def block(x, p, name, stride=1, bn=True, act=True, dilation=1, train=False, stats=None,
          precision="float32"):
    x = conv(x, p[f"{name}.Conv_0.weight"], p.get(f"{name}.Conv_0.bias"), stride, dilation,
             precision)
    if bn:
        x = batch_norm(x, p, f"{name}.BatchNorm_0", train, stats, precision)
    return F.relu(x) if act else x


def max_pool_same(x, kernel=3, stride=2):
    ph = same_pads(x.shape[-2], kernel, stride)
    pw = same_pads(x.shape[-1], kernel, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


# --------------------------------------------------------------------------
# Networks.
# --------------------------------------------------------------------------


def depth_net(p, x_nhwc, model: dict, train: bool, stats: Dict, precision="float32"):
    """(B, H, W, 3) in [-1, 1] -> inverse depth [(B, h, w, 1)], finest last."""
    kw = dict(train=train, stats=stats, precision=precision)
    x = block(x_nhwc.permute(0, 3, 1, 2), p, "depth.ConvBlock_0", 2, **kw)
    skips = [x]
    x = max_pool_same(x)
    for i, blocks in enumerate(STAGE_BLOCKS):
        for j in range(blocks):
            name = f"depth.ResNetStage_{i}.Bottleneck_{j}"
            stride = (1 if i == 0 else 2) if j == 0 else 1
            y = block(x, p, f"{name}.ConvBlock_0", 1, **kw)
            y = block(y, p, f"{name}.ConvBlock_1", stride, **kw)
            y = block(y, p, f"{name}.ConvBlock_2", 1, act=False, **kw)
            res = (block(x, p, f"{name}.ConvBlock_3", stride, act=False, **kw)
                   if f"{name}.ConvBlock_3.Conv_0.weight" in p else x)
            x = F.relu(rnd(y + res, precision))
        skips.append(x)
    decoder = tuple(model["decoder_features"])
    disps, heads = [], 0
    for i in range(len(decoder)):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = block(x, p, f"depth.UpConv_{i}.ConvBlock_0", bn=False, **kw)
        skip_idx = len(skips) - 2 - i
        if skip_idx >= 0:
            x = torch.cat([x, skips[skip_idx]], dim=1)
        x = block(x, p, f"depth.ConvBlock_{i + 1}", bn=False, **kw)
        if i - (len(decoder) - model["num_scales"]) >= 0:
            raw = conv(x, p[f"depth.Conv_{heads}.weight"], p[f"depth.Conv_{heads}.bias"],
                       precision=precision)
            disps.append((model["max_disp"] * torch.sigmoid(raw) + model["min_disp"])
                         .permute(0, 2, 3, 1))
            heads += 1
    return disps


def odom_net(p, pair_nhwc, precision="float32"):
    """(B, H, W, 6) in [-1, 1] -> (B, 6) twist [v, w]."""
    x = pair_nhwc.permute(0, 3, 1, 2)
    for i in range(len(ODOM_CONVS)):
        x = block(x, p, f"odom.ConvBlock_{i}", 2, bn=False, precision=precision)
    x = x.mean(dim=(2, 3))
    for i in range(len(ODOM_FC)):
        x = F.relu(rnd(F.linear(rnd(x, precision), rnd(p[f"odom.Dense_{i}.weight"], precision),
                                p[f"odom.Dense_{i}.bias"]), precision))
    n = len(ODOM_FC)  # the twist's dense layer runs in float32, outside autocast
    return ODOM_SCALE * F.linear(x, p[f"odom.Dense_{n}.weight"], p[f"odom.Dense_{n}.bias"])


def feat_net(p, x_chw, precision="float32"):
    """(B, 3, H, W) in [-1, 1] -> (B, C, H, W), L2-normalised over C."""
    x = x_chw
    for i, dil in enumerate(FEAT_DILATIONS):
        x = block(x, p, f"feat.ConvBlock_{i}", 1, bn=False, dilation=dil, precision=precision)
    x = conv(x, p["feat.Conv_0.weight"], p["feat.Conv_0.bias"], precision=precision)
    return x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + 1e-8)
