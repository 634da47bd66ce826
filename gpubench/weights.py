"""The cell's weights, made from the seed on the device in two draws.

Convolution and dense kernels are lecun-normal (variance 1 / fan_in), as
the system initialises them; biases, BatchNorm's affine parameters and
running statistics get small random values, so that every term of their
arithmetic is exercised. The odometry net's last bias holds a forward
motion of 0.55 m: a random net would predict no motion, which puts every
temporal sample on the bilinear kink.
"""

from __future__ import annotations

from typing import Dict

import torch

from gpubench.reference import nets

TWIST_BIAS = (0.0, 0.0, 55.0, 0.0, 0.0, 0.0)  # x 0.01: 0.55 m forward


def make(config: dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of the stage, keyed "net.path", float32
    on ``device`` (the BatchNorm counts int64)."""
    specs = nets.specs(config)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, kind), n in zip(specs, sizes):
        z = normal[at:at + n].view(shape)
        r = uniform[at:at + n].view(shape)
        at += n
        if kind in ("conv", "dense"):
            fan_in = max(1, n // shape[0])
            value = z * fan_in ** -0.5
        elif kind == "bias":
            value = 0.02 * z
        elif kind == "twist":
            value = 0.02 * z + torch.tensor(TWIST_BIAS, device=device)
        elif kind == "bn_scale":
            value = 1.0 + 0.1 * z
        elif kind in ("bn_bias", "bn_mean"):
            value = 0.1 * z
        elif kind == "bn_var":
            value = 0.5 + r
        elif kind == "bn_count":
            value = torch.zeros((), dtype=torch.int64, device=device)
        else:
            raise ValueError(f"unknown parameter kind {kind!r} of {name}")
        out[name] = value.contiguous()
    return out


def state_dicts(params: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"depth": {...}, ...}: the per-network state dicts the system loads."""
    per: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in params.items():
        net, name = key.split(".", 1)
        per.setdefault(net, {})[name] = value
    return per
