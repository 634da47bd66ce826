"""Photometric reconstruction losses over (B, C, H, W) tensors
(counterpart of the ``_chw`` functions of
``depthvo_tpu/losses/photometric.py``).

Masked L1 between the warped source and the target, normalised by the
valid count; an optional SSIM term (``ssim_weight=0``, the default, is
the reference's pure L1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def masked_l1_chw(pred: torch.Tensor, target: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """sum(|pred - target| * mask) / (sum(mask) * C + 1e-6) with a
    (B, H, W) mask."""
    m = mask.float()[:, None]
    err = torch.abs(pred.float() - target.float()) * m
    return torch.sum(err) / (torch.sum(m) * pred.shape[1] + 1e-6)


def _pool3(z: torch.Tensor) -> torch.Tensor:
    """3x3 VALID window sum / 9 (``lax.reduce_window`` add)."""
    return F.avg_pool2d(z, 3, 1)


def ssim_chw(x: torch.Tensor, y: torch.Tensor, c1: float = 0.01**2,
             c2: float = 0.03**2) -> torch.Tensor:
    """Per-pixel SSIM over 3x3 windows: (B, C, H-2, W-2)."""
    x = x.float()
    y = y.float()
    mu_x, mu_y = _pool3(x), _pool3(y)
    sig_x = _pool3(x * x) - mu_x * mu_x
    sig_y = _pool3(y * y) - mu_y * mu_y
    sig_xy = _pool3(x * y) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sig_xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (sig_x + sig_y + c2)
    return num / den


def photometric_loss_chw(warped: torch.Tensor, target: torch.Tensor,
                         valid: torch.Tensor,
                         ssim_weight: float = 0.0) -> torch.Tensor:
    """Masked L1, mixed with ``(1 - SSIM) / 2`` when ``ssim_weight > 0``.

    The mask is applied BEFORE pooling and eroded to fully valid 3x3
    windows (a 3x3 min), so invalid warp outputs, which are unspecified,
    never reach a scored window.
    """
    l1 = masked_l1_chw(warped, target, valid)
    if ssim_weight == 0.0:
        return l1
    mv = valid.float()[:, None]
    s = ssim_chw(warped * mv, target * mv)
    m = -F.max_pool2d(-mv, 3, 1)
    dssim = torch.sum((1.0 - s) * 0.5 * m) / (torch.sum(m) * s.shape[1] + 1e-6)
    return (1.0 - ssim_weight) * l1 + ssim_weight * dssim
