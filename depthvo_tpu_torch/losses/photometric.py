"""Photometric reconstruction losses (counterpart of
``depthvo_tpu/losses/photometric.py``), computed over (B, C, H, W)
tensors; :func:`masked_l1`, :func:`ssim` and :func:`photometric_loss` are
the reference's (B, H, W, C) surface, transposed into the same functions.

Masked L1 between the warped source and the target, normalised by the
valid count; an optional SSIM term (``ssim_weight=0``, the default, is
the reference's pure L1). A data-parallel step passes the global batch's
counts (``counts=``, from :func:`valid_counts` reduced over the ranks):
each rank's term is then its share of the reference's loss on the global
batch, and the shares sum to it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def masked_l1_chw(pred: torch.Tensor, target: torch.Tensor,
                  mask: torch.Tensor, count: torch.Tensor | None = None) -> torch.Tensor:
    """sum(|pred - target| * mask) / (sum(mask) * C + 1e-6) with a
    (B, H, W) mask; ``count`` replaces sum(mask) (the global count)."""
    m = mask.float()[:, None]
    err = torch.abs(pred.float() - target.float()) * m
    n = torch.sum(m) if count is None else count
    return torch.sum(err) / (n * pred.shape[1] + 1e-6)


def _eroded(mv: torch.Tensor) -> torch.Tensor:
    """The (B, 1, H, W) float mask eroded to fully valid 3x3 windows."""
    return -F.max_pool2d(-mv, 3, 1)


def valid_counts(valid: torch.Tensor, ssim_weight: float = 0.0) -> torch.Tensor:
    """The denominators' counts of :func:`photometric_loss_chw` on this
    batch: [sum(valid)], and with SSIM also the eroded mask's sum."""
    mv = valid.float()[:, None]
    if ssim_weight == 0.0:
        return torch.sum(mv).reshape(1)
    return torch.stack([torch.sum(mv), torch.sum(_eroded(mv))])


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
                         valid: torch.Tensor, ssim_weight: float = 0.0,
                         counts: torch.Tensor | None = None) -> torch.Tensor:
    """Masked L1, mixed with ``(1 - SSIM) / 2`` when ``ssim_weight > 0``.

    The mask is applied BEFORE pooling and eroded to fully valid 3x3
    windows (a 3x3 min), so invalid warp outputs, which are unspecified,
    never reach a scored window. ``counts`` (:func:`valid_counts` of the
    global batch) replace the denominators' sums.
    """
    l1 = masked_l1_chw(warped, target, valid, None if counts is None else counts[0])
    if ssim_weight == 0.0:
        return l1
    mv = valid.float()[:, None]
    s = ssim_chw(warped * mv, target * mv)
    m = _eroded(mv)
    n = torch.sum(m) if counts is None else counts[1]
    dssim = torch.sum((1.0 - s) * 0.5 * m) / (n * s.shape[1] + 1e-6)
    return (1.0 - ssim_weight) * l1 + ssim_weight * dssim


def _chw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def masked_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """:func:`masked_l1_chw` over (B, H, W, C) tensors with a (B, H, W) mask."""
    return masked_l1_chw(_chw(pred), _chw(target), mask)


def ssim(x: torch.Tensor, y: torch.Tensor, c1: float = 0.01**2,
         c2: float = 0.03**2) -> torch.Tensor:
    """:func:`ssim_chw` over (B, H, W, C) tensors: (B, H-2, W-2, C)."""
    return ssim_chw(_chw(x), _chw(y), c1, c2).permute(0, 2, 3, 1)


def photometric_loss(warped: torch.Tensor, target: torch.Tensor, valid: torch.Tensor,
                     ssim_weight: float = 0.0) -> torch.Tensor:
    """:func:`photometric_loss_chw` over (B, H, W, C) tensors with a
    (B, H, W) mask: ``ssim_weight=0`` is the reference's pure L1,
    ``ssim_weight=a`` scores ``(1-a)*L1 + a*(1-SSIM)/2``."""
    return photometric_loss_chw(_chw(warped), _chw(target), valid, ssim_weight)
