"""Monodepth2's networks (Godard et al., ICCV 2019; github.com/nianticlabs/
monodepth2 ``networks/``): a ResNet18 encoder of BasicBlocks, the depth
decoder and, for frame pairs, a 6-channel ResNet18 pose encoder with the
pose decoder.

The modules keep the public code's structure and parameter names, so a
network's state dict is Monodepth2's files under one prefix: the depth
net's ``encoder.*`` is ``encoder.pth`` and its ``decoder.*`` is
``depth.pth``; the pose net's are ``pose_encoder.pth`` and ``pose.pth``
(torchvision's unused ``fc`` layer left out). Three departures, each the
port's way of running its other networks:

* BatchNorm is :class:`EncoderBatchNorm`, a :class:`layers.BatchNorm` with
  torchvision's momentum (0.1) and eps (1e-5): its running variance folds
  the biased batch variance, over a data-parallel mesh its statistics are
  the global batch's, and on one card in train mode it runs the port's
  kernels (``ops/md2_batch_norm.py``), with the ReLU that follows the stem's
  and each block's ``bn1`` fused into them;
* ``compute_dtype="bfloat16"`` runs the convolutions under autocast; the
  disparity heads' sigmoid and the pose decoder's last 1x1 convolution,
  spatial mean and 0.01 scale run in float32;
* inputs are (B, C, H, W) float images in [0, 1], as Monodepth2's.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from depthvo_tpu_torch.models.depth_net import autocast_for
from depthvo_tpu_torch.models.layers import _RECOMPUTE, BatchNorm
from depthvo_tpu_torch.ops.md2_batch_norm import Md2BatchNorm

BN_MOMENTUM = 0.1  # torchvision's nn.BatchNorm2d default
NUM_CH_ENC = (64, 64, 128, 256, 512)


class EncoderBatchNorm(BatchNorm):
    """:class:`layers.BatchNorm` at torchvision's momentum, followed by a
    ReLU when ``relu``. Eval mode and the global statistics of a mesh
    (``group`` set) are the parent's, with ``F.relu`` after them; train
    mode on one process is :class:`ops.md2_batch_norm.Md2BatchNorm`, the
    ReLU fused (a remat recompute moves no running average)."""

    def __init__(self, features: int, relu: bool = False):
        super().__init__(features, momentum=BN_MOMENTUM)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.group is not None:
            y = super().forward(x)
            return F.relu(y) if self.relu else y
        return Md2BatchNorm.apply(x, self.weight, self.bias, self.running_mean,
                                  self.running_var, self.momentum, self.eps, self.relu,
                                  not getattr(_RECOMPUTE, "on", False))


class BasicBlock(nn.Module):
    """torchvision's ResNet BasicBlock (3x3, 3x3, identity or 1x1 shortcut)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = EncoderBatchNorm(planes, relu=True)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = EncoderBatchNorm(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                                            EncoderBatchNorm(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn1(self.conv1(x))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet18(nn.Module):
    """torchvision's ``resnet18`` body (``resnet_multiimage_input`` for
    ``num_input_images`` > 1: conv1 takes 3 channels per image)."""

    def __init__(self, num_input_images: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(3 * num_input_images, 64, 7, 2, 3, bias=False)
        self.bn1 = EncoderBatchNorm(64, relu=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for i, planes in enumerate((64, 128, 256, 512)):
            stride = 1 if i == 0 else 2
            self.add_module(f"layer{i + 1}", nn.Sequential(BasicBlock(inplanes, planes, stride),
                                                           BasicBlock(planes, planes)))
            inplanes = planes


class ResnetEncoder(nn.Module):
    """``networks/resnet_encoder.py``: the five feature maps of a ResNet18
    on ``(x - 0.45) / 0.225``."""

    def __init__(self, num_input_images: int = 1):
        super().__init__()
        self.num_ch_enc = NUM_CH_ENC
        self.encoder = ResNet18(num_input_images)

    def forward(self, input_image: torch.Tensor) -> List[torch.Tensor]:
        e = self.encoder
        x = (input_image - 0.45) / 0.225
        features = [e.bn1(e.conv1(x))]
        features.append(e.layer1(e.maxpool(features[-1])))
        features.append(e.layer2(features[-1]))
        features.append(e.layer3(features[-1]))
        features.append(e.layer4(features[-1]))
        return features


class Conv3x3(nn.Module):
    """Reflection padding of one pixel, then a 3x3 convolution."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.pad = nn.ReflectionPad2d(1)
        self.conv = nn.Conv2d(in_channels, out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.pad(x))


class ConvBlock(nn.Module):
    """:class:`Conv3x3` then ELU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv3x3(in_channels, out_channels)
        self.nonlin = nn.ELU(inplace=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.nonlin(self.conv(x))


class DepthDecoder(nn.Module):
    """``networks/depth_decoder.py``: per stage i = 4..0 a ConvBlock, nearest
    x2 upsampling, the skip from encoder feature i-1, a second ConvBlock,
    and a sigmoid disparity head at each scale of ``scales``.
    ``decoder`` is the public code's ModuleList: (upconv i, 0), (upconv i,
    1) for i = 4..0, then the heads (dispconv s) for s in ``scales``."""

    def __init__(self, num_ch_enc: Sequence[int] = NUM_CH_ENC,
                 num_ch_dec: Sequence[int] = (16, 32, 64, 128, 256),
                 scales: Sequence[int] = range(4), num_output_channels: int = 1):
        super().__init__()
        self.scales = tuple(scales)
        convs = []
        for i in range(4, -1, -1):
            num_ch_in = num_ch_enc[-1] if i == 4 else num_ch_dec[i + 1]
            convs.append(ConvBlock(num_ch_in, num_ch_dec[i]))
            num_ch_in = num_ch_dec[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            convs.append(ConvBlock(num_ch_in, num_ch_dec[i]))
        for s in self.scales:
            convs.append(Conv3x3(num_ch_dec[s], num_output_channels))
        self.decoder = nn.ModuleList(convs)

    def forward(self, input_features: List[torch.Tensor]) -> List[torch.Tensor]:
        """Disparities in (0, 1), float32, (B, 1, H / 2^s, W / 2^s), indexed
        by scale s (finest first)."""
        outputs = {}
        x = input_features[-1]
        for k, i in enumerate(range(4, -1, -1)):
            x = self.decoder[2 * k](x)
            x = [F.interpolate(x, scale_factor=2, mode="nearest")]
            if i > 0:
                x += [input_features[i - 1]]
            x = torch.cat(x, 1)
            x = self.decoder[2 * k + 1](x)
            if i in self.scales:
                head = self.decoder[10 + self.scales.index(i)]
                outputs[i] = torch.sigmoid(head(x).float())
        return [outputs[s] for s in self.scales]


class PoseDecoder(nn.Module):
    """``networks/pose_decoder.py`` for one input feature set: a 1x1
    squeeze to 256, two 3x3 convolutions, a 1x1 convolution to 6 numbers
    per predicted frame, the spatial mean, x 0.01. ``net`` is the public
    code's ModuleList: squeeze, pose 0, pose 1, pose 2."""

    def __init__(self, num_ch_enc: Sequence[int] = NUM_CH_ENC, num_input_features: int = 1,
                 num_frames_to_predict_for: int = 2):
        super().__init__()
        self.num_frames_to_predict_for = num_frames_to_predict_for
        self.net = nn.ModuleList([
            nn.Conv2d(num_ch_enc[-1], 256, 1),
            nn.Conv2d(num_input_features * 256, 256, 3, 1, 1),
            nn.Conv2d(256, 256, 3, 1, 1),
            nn.Conv2d(256, 6 * num_frames_to_predict_for, 1),
        ])

    def forward(self, last_features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out = F.relu(self.net[0](last_features))
        out = F.relu(self.net[1](out))
        out = F.relu(self.net[2](out))
        with torch.autocast(device_type=out.device.type, enabled=False):
            out = self.net[3](out.float())
        out = out.mean(3).mean(2)
        out = 0.01 * out.view(-1, self.num_frames_to_predict_for, 1, 6)
        return out[..., :3], out[..., 3:]


class Monodepth2DepthNet(nn.Module):
    """The depth encoder and decoder: (B, 3, H, W) in [0, 1] -> the
    sigmoid disparities of :class:`DepthDecoder`."""

    def __init__(self, decoder_features: Sequence[int] = (256, 128, 64, 32, 16),
                 num_scales: int = 4, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.encoder = ResnetEncoder(1)
        self.decoder = DepthDecoder(NUM_CH_ENC, tuple(reversed(decoder_features)),
                                    range(num_scales))

    def forward(self, image: torch.Tensor) -> List[torch.Tensor]:
        with autocast_for(image, self.compute_dtype):
            return self.decoder(self.encoder(image))


class Monodepth2PoseNet(nn.Module):
    """The 6-channel pose encoder and the pose decoder: a frame pair
    (B, 6, H, W) in [0, 1] -> (axisangle, translation), each (B, 2, 1, 3),
    float32 (Monodepth2 uses the first of the two predictions)."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.encoder = ResnetEncoder(2)
        self.decoder = PoseDecoder(NUM_CH_ENC, 1, 2)

    def forward(self, pair: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with autocast_for(pair, self.compute_dtype):
            return self.decoder(self.encoder(pair)[-1])
