"""ManyDepth's multi-frame depth network (Watson et al., CVPR 2021;
github.com/nianticlabs/manydepth ``networks/resnet_encoder.py``
``ResnetEncoderMatching`` and ``networks/depth_decoder.py``).

The encoder is Monodepth2's ResNet18 (``models/monodepth2.py``
:class:`ResNet18`, its modules regrouped as the public code regroups
torchvision's) with a plane-sweep cost volume after its first two
blocks:

  F0     = layer1(layer0((I_0 - 0.45) / 0.225))             # 64 x H/4 x W/4
  F-1    = the same stem on the lookup frame                # no_grad, BN in train mode
  bins   = linspace(min_depth_bin, max_depth_bin, 96)       # the trackers
  volume, conf, lowest = cost_volume(F0, F-1, K/4, T_match, bins)
  feats  = [layer0 out, F0, layer2(reduce_conv([F0, volume])), layer3, layer4]

and Monodepth2's ``DepthDecoder`` over ``feats``. The modules keep the
public code's names: ``layer0`` (conv1, bn1; the ReLU fused into bn1),
``layer1`` (maxpool, the first stage), ``layer2``-``layer4``,
``reduce_conv`` (3x3, 64 + 96 -> 64, with bias, then ReLU), and the
depth-bin trackers as the buffers ``min_depth_bin`` and
``max_depth_bin`` (the public trainer's ``min_depth_tracker`` and
``max_depth_tracker``, which it saves into ``encoder.pth`` under these
names). The trackers are float64, as the public trainer's Python floats
are; the bins are made on the device in float64 as ``np.linspace`` makes
them and cast to float32, with no host read, so a CUDA graph of the step
captures them.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from depthvo_tpu_torch.geometry import monodepth2 as geo
from depthvo_tpu_torch.geometry.se3 import _matmul
from depthvo_tpu_torch.models.depth_net import autocast_for
from depthvo_tpu_torch.models.monodepth2 import NUM_CH_ENC, DepthDecoder, ResNet18
from depthvo_tpu_torch.ops import cost_volume as cv
from depthvo_tpu_torch.utils import spans

MATCHING_SCALE = 2  # the cost volume's resolution: 1 / 2^2 of the image's
NUM_DEPTH_BINS = 96  # options.py num_depth_bins, linear binning
MIN_DEPTH_BIN, MAX_DEPTH_BIN = 0.1, 10.0  # the trackers' start (trainer.py)


class ResnetEncoderMatching(nn.Module):
    """The ResNet18 encoder with the cost volume. ``forward`` returns the
    five feature maps, the lowest-cost inverse depth and the confidence
    (both (B, H/4, W/4)) and the bins it used."""

    def __init__(self):
        super().__init__()
        self.num_ch_enc = NUM_CH_ENC
        self.num_depth_bins = NUM_DEPTH_BINS
        e = ResNet18()
        self.layer0 = nn.Sequential(e.conv1, e.bn1)
        self.layer1 = nn.Sequential(e.maxpool, e.layer1)
        self.layer2, self.layer3, self.layer4 = e.layer2, e.layer3, e.layer4
        self.reduce_conv = nn.Sequential(
            nn.Conv2d(NUM_CH_ENC[1] + NUM_DEPTH_BINS, NUM_CH_ENC[1], 3, 1, 1),
            nn.ReLU(inplace=True))
        self.register_buffer("min_depth_bin", torch.tensor(MIN_DEPTH_BIN, dtype=torch.float64))
        self.register_buffer("max_depth_bin", torch.tensor(MAX_DEPTH_BIN, dtype=torch.float64))

    def stem(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``feature_extraction``: (layer0's output, layer1's)."""
        f0 = self.layer0((image - 0.45) / 0.225)
        return f0, self.layer1(f0)

    def depth_bins(self) -> torch.Tensor:
        """``np.linspace(min_depth_bin, max_depth_bin, D)`` in float64
        (i * step + start, the last bin the stop), as float32 (D,)."""
        lo, hi = self.min_depth_bin, self.max_depth_bin
        i = torch.arange(self.num_depth_bins - 1, dtype=torch.float64, device=lo.device)
        step = (hi - lo) / (self.num_depth_bins - 1)
        return torch.cat([i * step + lo, hi.view(1)]).float()

    @torch.no_grad()
    def update_trackers(self, depth: torch.Tensor, min_depth: float) -> None:
        """``update_adaptive_depth_bins``: toward 0.9 x the batch mean of the
        rows' least depth (at least ``min_depth``) and 1.1 x that of their
        greatest, by 0.01, in float64 (the public trainer's Python floats);
        ``depth`` (B, ..., H, W) is the teacher's at scale 0."""
        rows = depth.detach().flatten(1)
        least = torch.clamp_min(rows.amin(1).mean().double() * 0.9, min_depth)
        most = rows.amax(1).mean().double() * 1.1
        self.max_depth_bin.copy_(self.max_depth_bin * 0.99 + most * 0.01)
        self.min_depth_bin.copy_(self.min_depth_bin * 0.99 + least * 0.01)

    def forward(self, image: torch.Tensor, lookup: torch.Tensor, K: torch.Tensor,
                T: torch.Tensor):
        """``image``, ``lookup``: (B, 3, H, W) in [0, 1]; ``K`` (B, 3, 3)
        intrinsics at the matching scale; ``T`` (B, 4, 4) the matching pose
        (all zero for a row without one). Returns (features, lowest, conf,
        bins)."""
        f0, f1 = self.stem(image)
        with spans.span("mf.match"), torch.no_grad():
            bins = self.depth_bins()
            _, look = self.stem(lookup)
            h, w = f1.shape[-2:]
            rays = geo.pixel_rays(K, h, w)
            P = _matmul(geo.homogeneous_K(K.float()), T.float())[:, :3].contiguous()
            valid = T.flatten(1).sum(1) != 0
            volume, conf, lowest = cv.cost_volume(f1, look, rays, P, bins, valid)
        x = self.reduce_conv(torch.cat([f1, volume], 1))
        feats = [f0, f1]
        for layer in (self.layer2, self.layer3, self.layer4):
            x = layer(x)
            feats.append(x)
        return feats, lowest, conf, bins


class ManyDepthNet(nn.Module):
    """The multi-frame depth net: :class:`ResnetEncoderMatching` and
    Monodepth2's ``DepthDecoder``. ``forward(image, lookup, K, T)`` ->
    (disparities by scale, finest first, float32 sigmoids; lowest; conf;
    bins), the encoder's arguments as there."""

    def __init__(self, decoder_features: Sequence[int] = (256, 128, 64, 32, 16),
                 num_scales: int = 4, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.encoder = ResnetEncoderMatching()
        self.decoder = DepthDecoder(NUM_CH_ENC, tuple(reversed(decoder_features)),
                                    range(num_scales))

    def forward(self, image: torch.Tensor, lookup: torch.Tensor, K: torch.Tensor,
                T: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
        with autocast_for(image, self.compute_dtype):
            feats, lowest, conf, bins = self.encoder(image, lookup, K, T)
            return self.decoder(feats), lowest, conf, bins
