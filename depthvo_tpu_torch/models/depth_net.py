"""DepthNet: single-view inverse-depth network (counterpart of
``depthvo_tpu/models/depth_net.py``).

ResNet50-1by2 encoder (stem 7x7/2 with 32 channels + max pool, bottleneck
stages [3, 4, 6, 3] with planes [32, 64, 128, 256]) and a five-stage
nearest-upsample + conv decoder with skip connections that predicts
inverse depth ``max_disp * sigmoid(x) + min_disp`` (in float32) at the
last ``num_scales`` resolutions, finest last.

Finest stage, one of four modes (at most one of the last three):

* standard: ``UpConv_4``, ``ConvBlock_5`` and a disp head at full
  resolution;
* ``s2d_finest`` (the reference's default): an exact space-to-depth
  rewrite of the standard stage for the TPU's matrix unit, with the same
  parameters and the same function. The port runs the standard stage,
  which is therefore what ``s2d_finest=True`` computes here too;
* ``subpixel_head``: no full-resolution convs; a 3x3 conv to 4 channels
  at 1/2 resolution, the bounded sigmoid, then depth-to-space;
* ``fast_final_upsample``: no full-resolution convs; the 1/2-resolution
  disparity (which this mode always predicts) resized bilinearly.

Submodules carry flax's auto-names, so a disp head is ``Conv_k`` with k
counting the heads made before it (the subpixel conv is the one after
the coarse heads) and reference checkpoints of every mode load as they
are. ``remat`` runs the stem, each ``ResNetStage``, ``UpConv`` and
decoder ``ConvBlock`` under ``layers.remat`` when training: the same
values with less memory held for the backward, and the same parameter
names.

``compute_dtype="bfloat16"`` runs the convolutions under
``torch.autocast``; the parameters stay float32 and the disp heads'
sigmoid runs in float32, as in the reference.

``quant_mode`` ("off", "calibrate", "int8") is the reference's w8a8
serving switch: every conv of the encoder and the decoder becomes a
``layers.QuantConv`` with the same parameters; the 1-channel disparity
heads and the 4-channel subpixel head stay float. ``s2d_finest`` with a
quant mode raises, as in the reference (``train/state.py::build_models``
turns it off for quantized serving). :meth:`DepthNet.set_quant_mode`
moves a quantized net between "calibrate" and "int8", and
:meth:`DepthNet.quant_tree` gives the recorded ``a_max`` keyed like the
reference's ``quant`` collection.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from depthvo_tpu_torch.models.layers import (
    QUANT_MODES,
    Conv,
    ConvBlock,
    QuantConv,
    ResNetStage,
    UpConv,
    depth_to_space2,
    max_pool_same,
    remat,
    resize_bilinear,
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
        s2d_finest: bool = False,
        quant_mode: str = "off",
    ):
        super().__init__()
        if sum((fast_final_upsample, subpixel_head, s2d_finest)) > 1:
            raise ValueError(
                "fast_final_upsample, subpixel_head and s2d_finest are "
                "mutually exclusive finest-stage modes"
            )
        if quant_mode not in QUANT_MODES:
            raise ValueError(f"quant_mode must be one of {QUANT_MODES}, got {quant_mode!r}")
        if s2d_finest and quant_mode != "off":
            raise ValueError(
                "s2d_finest is a training-graph lever; int8 serving uses "
                "the standard or subpixel head (quant_mode must be 'off')"
            )
        self.quant_mode = quant_mode
        q = quant_mode
        self.num_scales = num_scales
        self.max_disp = max_disp
        self.min_disp = min_disp
        self.compute_dtype = compute_dtype
        self.fast_final_upsample = fast_final_upsample
        self.subpixel_head = subpixel_head
        self.remat = remat
        self.num_stages = len(stage_planes)
        self.num_up = len(decoder_features)

        self.ConvBlock_0 = ConvBlock(3, stem_features, 7, 2, quant_mode=q)
        skip_ch = [stem_features]
        in_ch = stem_features
        for i, (planes, blocks) in enumerate(zip(stage_planes, stage_blocks)):
            self.add_module(
                f"ResNetStage_{i}",
                ResNetStage(in_ch, planes, blocks, 1 if i == 0 else 2, q),
            )
            in_ch = 4 * planes
            skip_ch.append(in_ch)
        # The decoder stage -> its disp head's name, in flax's order.
        self.heads: Dict[int, str] = {}
        last = self.num_up - 1
        for i, feats in enumerate(decoder_features):
            if i == last and subpixel_head:
                self.heads[i] = f"Conv_{len(self.heads)}"
                self.add_module(self.heads[i], Conv(in_ch, 4, 3))
                break
            if i == last and fast_final_upsample:
                break
            self.add_module(f"UpConv_{i}", UpConv(in_ch, feats, q))
            skip_idx = len(skip_ch) - 2 - i
            cat_ch = feats + (skip_ch[skip_idx] if skip_idx >= 0 else 0)
            self.add_module(
                f"ConvBlock_{i + 1}",
                ConvBlock(cat_ch, feats, 3, 1, use_bn=False, quant_mode=q)
            )
            scale_idx = i - (self.num_up - num_scales)
            # fast_final_upsample needs the 1/2-resolution disp to resize.
            if scale_idx >= 0 or (fast_final_upsample and i == last - 1):
                self.heads[i] = f"Conv_{len(self.heads)}"
                self.add_module(self.heads[i], Conv(feats, 1, 3))
            in_ch = feats

    def quant_convs(self) -> Dict[str, QuantConv]:
        """The quantized convs by module path (empty with ``quant_mode="off"``)."""
        return {n: m for n, m in self.named_modules() if isinstance(m, QuantConv)}

    def set_quant_mode(self, mode: str) -> "DepthNet":
        """Move a quantized net between "calibrate" and "int8"; "int8"
        fixes the scales and quantizes the weights once
        (``QuantConv.quantize``)."""
        if self.quant_mode == "off":
            raise ValueError("set_quant_mode: this DepthNet was built with quant_mode='off'")
        if mode not in ("calibrate", "int8"):
            raise ValueError(f"set_quant_mode: calibrate|int8, got {mode!r}")
        for conv in self.quant_convs().values():
            conv.mode = mode
            if mode == "int8":
                conv.quantize()
        self.quant_mode = mode
        return self

    def quant_tree(self) -> Dict[str, Any]:
        """``a_max`` of each quantized conv as float32 numpy scalars, nested
        like the reference's ``quant`` collection
        (``{"ConvBlock_0": {"Conv_0": {"a_max": ...}}, ...}``)."""
        tree: Dict[str, Any] = {}
        for name, conv in self.quant_convs().items():
            node = tree
            for part in name.split("."):
                node = node.setdefault(part, {})
            node["a_max"] = np.asarray(conv.a_max.detach().cpu().numpy(), np.float32)
        return tree

    def _disp(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Stage ``i``'s head: ``max_disp * sigmoid + min_disp`` in float32,
        NHWC."""
        raw = getattr(self, self.heads[i])(x)
        return (self.max_disp * torch.sigmoid(raw.float()) + self.min_disp).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3) in [-1, 1] -> inverse-depth maps
        [(B, H/8, W/8, 1), ..., (B, H, W, 1)], finest last, float32."""
        x = x.permute(0, 3, 1, 2).float()
        if self.remat and self.training and torch.is_grad_enabled():
            run = remat
        else:
            def run(module, t):
                return module(t)
        disps = []
        last = self.num_up - 1
        with autocast_for(x, self.compute_dtype):
            x = run(self.ConvBlock_0, x)
            skips = [x]
            x = max_pool_same(x, 3, 2)
            for i in range(self.num_stages):
                x = run(getattr(self, f"ResNetStage_{i}"), x)
                skips.append(x)
            x = skips[-1]
            for i in range(self.num_up):
                if i == last and self.subpixel_head:
                    disps.append(depth_to_space2(self._disp(i, x)))
                    break
                if i == last and self.fast_final_upsample:
                    prev = disps[-1]
                    disps.append(resize_bilinear(prev, 2 * prev.shape[1], 2 * prev.shape[2]))
                    break
                x = run(getattr(self, f"UpConv_{i}"), x)
                skip_idx = len(skips) - 2 - i
                if skip_idx >= 0:
                    x = torch.cat([x, skips[skip_idx].to(x.dtype)], dim=1)
                x = run(getattr(self, f"ConvBlock_{i + 1}"), x)
                if i in self.heads:
                    disps.append(self._disp(i, x))
        return disps
