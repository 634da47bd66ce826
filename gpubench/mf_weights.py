"""The ManyDepth cell's weights, made from the seed on the device in two
draws, as ``gpubench/md2_weights.py`` makes Monodepth2's: lecun-normal
convolution kernels, small random biases, BatchNorm affine parameters
and statistics; the pose decoder's last bias holds cell A's forward motion
(``md2_weights.POSE_BIAS``); the depth-bin trackers start at the public
trainer's 0.1 and 10.0, in float64 (the public trainer's Python floats).
"""

from __future__ import annotations

from typing import Dict

import torch

from gpubench import md2_weights
from gpubench.reference import manydepth as mf


def specs(config: dict) -> list:
    m = config["model"]
    return mf.specs(m["num_scales"], tuple(reversed(m["decoder_features"])))


def make(config: dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of the three nets, keyed "net.path",
    float32 on ``device`` (the BatchNorm counts int64, the trackers
    float64)."""
    items = specs(config)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in items]
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    start = {"min_depth_bin": mf.MIN_DEPTH_TRACKER, "max_depth_bin": mf.MAX_DEPTH_TRACKER}
    out, at = {}, 0
    for (name, shape, kind), n in zip(items, sizes):
        z = normal[at:at + n].view(shape)
        r = uniform[at:at + n].view(shape)
        at += n
        if kind == "conv":
            value = z * max(1, n // shape[0]) ** -0.5
        elif kind == "bias":
            value = 0.02 * z
        elif kind == "pose":
            value = 0.02 * z + torch.tensor(md2_weights.POSE_BIAS, device=device)
        elif kind == "bn_scale":
            value = 1.0 + 0.1 * z
        elif kind in ("bn_bias", "bn_mean"):
            value = 0.1 * z
        elif kind == "bn_var":
            value = 0.5 + r
        elif kind == "bn_count":
            value = torch.zeros((), dtype=torch.int64, device=device)
        elif kind == "tracker":
            value = torch.tensor(start[name.rsplit(".", 1)[1]], dtype=torch.float64,
                                 device=device)
        else:
            raise ValueError(f"unknown parameter kind {kind!r} of {name}")
        out[name] = value.contiguous()
    return out
