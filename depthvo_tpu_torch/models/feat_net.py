"""FeatNet: dense-feature extractor for the feature reconstruction loss
(counterpart of ``depthvo_tpu/models/feat_net.py``).

A stride-1 dilated 3x3 stack (dilations 1, 2, 4), a 3x3 conv to
``out_features`` channels, then float32 L2 normalisation over channels
with ``+1e-8`` inside the square root.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from depthvo_tpu_torch.models.depth_net import autocast_for
from depthvo_tpu_torch.models.layers import Conv, ConvBlock


class FeatNet(nn.Module):
    """Stride-1 dilated conv stack -> L2-normalized dense features."""

    def __init__(
        self,
        conv_features: Sequence[int] = (32, 64, 64),
        dilations: Sequence[int] = (1, 2, 4),
        out_features: int = 16,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        in_ch = 3
        for i, (feats, dil) in enumerate(zip(conv_features, dilations)):
            self.add_module(
                f"ConvBlock_{i}",
                ConvBlock(in_ch, feats, 3, 1, use_bn=False, dilation=dil),
            )
            in_ch = feats
        self.num_convs = len(conv_features)
        self.Conv_0 = Conv(in_ch, out_features, 3)

    def forward_chw(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) in [-1, 1] -> (B, out_features, H, W) float32."""
        x = x.float()
        with autocast_for(x, self.compute_dtype):
            for i in range(self.num_convs):
                x = getattr(self, f"ConvBlock_{i}")(x)
            x = self.Conv_0(x)
        x = x.float()
        return x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + 1e-8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [-1, 1] -> (B, H, W, out_features), L2-normalized
        along channels, float32."""
        return self.forward_chw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
