"""The arithmetic the reference runs in.

``"float32"`` is the reference. ``"fp8"`` is the control: the nearest
precision below the configuration's bfloat16. Wherever the system holds a
tensor in bfloat16 under autocast (the operands and outputs of every
convolution and of the odometry net's hidden dense layers, BatchNorm's
outputs, the residual sums), the control rounds it to float8 e4m3 with one
scale per tensor (its largest magnitude maps to e4m3's largest value), and
the gradient flowing back through that point to float8 e5m2 likewise, as
float8 training keeps its gradients. The arithmetic between those points
stays float32.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to per-tensor scaled e4m3; its gradient to e5m2."""
    return _Fp8.apply(x)


def rnd(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` where the system would hold it in bfloat16."""
    if precision == "float32":
        return x
    if precision == "fp8":
        return fp8_round(x)
    raise ValueError(f"unknown precision {precision!r}")
