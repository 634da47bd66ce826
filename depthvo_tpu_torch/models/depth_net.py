"""DepthNet: single-view inverse-depth network (counterpart of
``depthvo_tpu/models/depth_net.py``).

ResNet50-1by2 encoder (stem 7x7/2 with 32 channels + max pool, bottleneck
stages [3, 4, 6, 3] with planes [32, 64, 128, 256]) and a five-stage
nearest-upsample + conv decoder with skip connections that predicts
inverse depth ``max_disp * sigmoid(x) + min_disp`` (in float32) at the
last ``num_scales`` resolutions, finest last.

Finest stage: the reference's default ``s2d_finest=True`` is an exact
space-to-depth rewrite of the standard finest stage for the TPU's matrix
unit, with the same parameters and the same function. The port always
runs the standard stage, which is therefore what ``s2d_finest=True``
computes here too. ``fast_final_upsample``, ``subpixel_head`` and
``remat`` (the reference's rematerialised stages, the same function with
less memory) are not ported yet and raise ``NotImplementedError``.

``compute_dtype="bfloat16"`` runs the convolutions under
``torch.autocast``; the parameters stay float32 and the disp heads'
sigmoid runs in float32, as in the reference.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from depthvo_tpu_torch.models.layers import (
    Conv,
    ConvBlock,
    ResNetStage,
    UpConv,
    max_pool_same,
)


def autocast_for(x: torch.Tensor, compute_dtype: torch.dtype):
    """The networks' mixed-precision region: bf16 convs under autocast,
    a no-op for float32. Without autocast's cache of casted weights: each
    weight is cast once per forward anyway, and a cast kept from before a
    CUDA-graph capture would be replayed stale."""
    return torch.autocast(
        device_type=x.device.type,
        dtype=torch.bfloat16,
        enabled=compute_dtype == torch.bfloat16,
        cache_enabled=False,
    )


class DepthNet(nn.Module):
    """ResNet50-1by2 encoder / skip-decoder inverse-depth network."""

    def __init__(
        self,
        stem_features: int = 32,
        stage_planes: Sequence[int] = (32, 64, 128, 256),
        stage_blocks: Sequence[int] = (3, 4, 6, 3),
        decoder_features: Sequence[int] = (256, 128, 64, 32, 16),
        num_scales: int = 4,
        max_disp: float = 0.3,
        min_disp: float = 0.00625,
        compute_dtype: torch.dtype = torch.float32,
        fast_final_upsample: bool = False,
        subpixel_head: bool = False,
        remat: bool = False,
    ):
        super().__init__()
        if fast_final_upsample or subpixel_head or remat:
            raise NotImplementedError(
                "fast_final_upsample, subpixel_head and remat are not ported yet"
            )
        self.num_scales = num_scales
        self.max_disp = max_disp
        self.min_disp = min_disp
        self.compute_dtype = compute_dtype
        self.num_stages = len(stage_planes)
        self.num_up = len(decoder_features)

        self.ConvBlock_0 = ConvBlock(3, stem_features, 7, 2)
        skip_ch = [stem_features]
        in_ch = stem_features
        for i, (planes, blocks) in enumerate(zip(stage_planes, stage_blocks)):
            self.add_module(
                f"ResNetStage_{i}",
                ResNetStage(in_ch, planes, blocks, 1 if i == 0 else 2),
            )
            in_ch = 4 * planes
            skip_ch.append(in_ch)
        for i, feats in enumerate(decoder_features):
            self.add_module(f"UpConv_{i}", UpConv(in_ch, feats))
            skip_idx = len(skip_ch) - 2 - i
            cat_ch = feats + (skip_ch[skip_idx] if skip_idx >= 0 else 0)
            self.add_module(
                f"ConvBlock_{i + 1}", ConvBlock(cat_ch, feats, 3, 1, use_bn=False)
            )
            scale_idx = i - (self.num_up - num_scales)
            if scale_idx >= 0:
                self.add_module(f"Conv_{scale_idx}", Conv(feats, 1, 3))
            in_ch = feats

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3) in [-1, 1] -> inverse-depth maps
        [(B, H/8, W/8, 1), ..., (B, H, W, 1)], finest last, float32."""
        x = x.permute(0, 3, 1, 2).float()
        disps = []
        with autocast_for(x, self.compute_dtype):
            x = self.ConvBlock_0(x)
            skips = [x]
            x = max_pool_same(x, 3, 2)
            for i in range(self.num_stages):
                x = getattr(self, f"ResNetStage_{i}")(x)
                skips.append(x)
            x = skips[-1]
            for i in range(self.num_up):
                x = getattr(self, f"UpConv_{i}")(x)
                skip_idx = len(skips) - 2 - i
                if skip_idx >= 0:
                    x = torch.cat([x, skips[skip_idx].to(x.dtype)], dim=1)
                x = getattr(self, f"ConvBlock_{i + 1}")(x)
                scale_idx = i - (self.num_up - self.num_scales)
                if scale_idx >= 0:
                    raw = getattr(self, f"Conv_{scale_idx}")(x)
                    disp = self.max_disp * torch.sigmoid(raw.float()) + self.min_disp
                    disps.append(disp.permute(0, 2, 3, 1))
        return disps

