"""OdomNet: two-frame visual odometry network (counterpart of
``depthvo_tpu/models/odom_net.py``).

Seven stride-2 convs (7x7, 5x5, then 3x3; flax ``SAME`` padding), a
global mean, Dense 512 / 512 with ReLU, a float32 Dense(6), scaled by
``output_scale`` so that a random network starts near the identity.
The twist is ``[v, w]`` and ``se3.exp(twist)`` maps target-camera points
into the source camera.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from depthvo_tpu_torch.models.depth_net import autocast_for
from depthvo_tpu_torch.models.layers import ConvBlock


class OdomNet(nn.Module):
    """Conv stack + FC head -> 6-DoF se(3) twist."""

    def __init__(
        self,
        conv_features: Sequence[int] = (16, 32, 64, 128, 256, 256, 256),
        fc_features: Sequence[int] = (512, 512),
        output_scale: float = 0.01,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.output_scale = output_scale
        self.compute_dtype = compute_dtype
        in_ch = 6
        for i, feats in enumerate(conv_features):
            kernel = 7 if i == 0 else (5 if i == 1 else 3)
            self.add_module(
                f"ConvBlock_{i}", ConvBlock(in_ch, feats, kernel, 2, use_bn=False)
            )
            in_ch = feats
        self.num_convs = len(conv_features)
        self.num_fc = len(fc_features)
        for i, feats in enumerate(fc_features):
            self.add_module(f"Dense_{i}", nn.Linear(in_ch, feats))
            in_ch = feats
        self.add_module(f"Dense_{self.num_fc}", nn.Linear(in_ch, 6))

    def forward(self, frame_pair: torch.Tensor) -> torch.Tensor:
        """frame_pair (B, H, W, 6) in [-1, 1] -> (B, 6) twist, float32."""
        x = frame_pair.permute(0, 3, 1, 2).float()
        with autocast_for(x, self.compute_dtype):
            for i in range(self.num_convs):
                x = getattr(self, f"ConvBlock_{i}")(x)
            x = x.mean(dim=(2, 3))
            for i in range(self.num_fc):
                x = F.relu(getattr(self, f"Dense_{i}")(x))
        twist = getattr(self, f"Dense_{self.num_fc}")(x.float())
        return self.output_scale * twist
