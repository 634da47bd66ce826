"""Building blocks of the three networks (counterpart of
``depthvo_tpu/models/layers.py``).

Submodules carry flax's auto-names (``Conv_0``, ``BatchNorm_0``,
``ConvBlock_k``, ``Bottleneck_j``), so a parameter's path in the port's
state dict is its path in the JAX tree with ``/`` read as ``.``
(``io/from_jax.py`` relies on that).

Tensors are NCHW inside the networks. Three places where PyTorch and
flax differ, each pinned by a parity test (tests/test_torch_models.py):

* ``padding="SAME"`` in flax pads ``(total // 2, total - total // 2)``,
  which is asymmetric on stride 2; torch's ``padding=`` is symmetric.
  :func:`same_pads` computes flax's pads from the input size and the
  layers apply them with ``F.pad`` where they are asymmetric.
* BatchNorm in eval mode: running averages and eps 1e-5. Train mode
  (flax momentum 0.95) belongs to the training slice.
* ``resize_bilinear(_chw)`` is ``jax.image.resize(method="linear")``,
  which antialiases when it shrinks: ``F.interpolate(...,
  antialias=True)``. ``upsample2x`` is nearest-neighbour.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size: int, kernel: int, stride: int, dilation: int = 1):
    """flax/XLA ``SAME`` padding of one spatial dim: (low, high)."""
    eff = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with flax ``padding="SAME"`` semantics."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 dilation: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=0,
                         dilation=dilation, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s, d = self.kernel_size[0], self.stride[0], self.dilation[0]
        ph = same_pads(x.shape[-2], k, s, d)
        pw = same_pads(x.shape[-1], k, s, d)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, self.weight, self.bias, s, (ph[0], pw[0]), d)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight, self.bias, s, 0, d)


def max_pool_same(x: torch.Tensor, kernel: int = 3, stride: int = 2):
    """``nn.max_pool(x, (k, k), (s, s), padding="SAME")``: pads with -inf."""
    ph = same_pads(x.shape[-2], kernel, stride)
    pw = same_pads(x.shape[-1], kernel, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


class ConvBlock(nn.Module):
    """Conv -> (BN) -> activation, the basic unit of every tower. The conv
    has a bias only without BN, as in the reference."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, use_bn: bool = True, act: bool = True,
                 dilation: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, kernel, stride, dilation,
                           bias=not use_bn)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-5) if use_bn else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        return F.relu(x) if self.act else x


class Bottleneck(nn.Module):
    """ResNet bottleneck block (1x1 -> 3x3 -> 1x1, x4 expansion)."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = 4 * planes
        self.ConvBlock_0 = ConvBlock(in_ch, planes, 1, 1)
        self.ConvBlock_1 = ConvBlock(planes, planes, 3, stride)
        self.ConvBlock_2 = ConvBlock(planes, out_ch, 1, 1, act=False)
        self.ConvBlock_3 = (
            ConvBlock(in_ch, out_ch, 1, stride, act=False)
            if in_ch != out_ch or stride != 1 else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ConvBlock_2(self.ConvBlock_1(self.ConvBlock_0(x)))
        residual = x if self.ConvBlock_3 is None else self.ConvBlock_3(x)
        return F.relu(y + residual)


class ResNetStage(nn.Module):
    """A stack of bottleneck blocks; the first block may downsample."""

    def __init__(self, in_ch: int, planes: int, num_blocks: int, stride: int):
        super().__init__()
        for i in range(num_blocks):
            self.add_module(
                f"Bottleneck_{i}",
                Bottleneck(in_ch if i == 0 else 4 * planes, planes,
                           stride if i == 0 else 1),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling of (B, C, H, W)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def resize_bilinear_chw(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, (b, c, h, w), "linear")`` on (B, C, H, W):
    half-pixel centers, antialiased when shrinking."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                         antialias=True)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``resize_bilinear_chw`` for (B, H, W, C) tensors."""
    return resize_bilinear_chw(x.permute(0, 3, 1, 2), h, w).permute(0, 2, 3, 1)


class UpConv(nn.Module):
    """Nearest 2x upsample, then a 3x3 conv + ReLU (the decoder unit)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(in_ch, features, 3, 1, use_bn=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvBlock_0(upsample2x(x))
