"""Inverse-depth smoothness regularizer (counterpart of
``depthvo_tpu/losses/smoothness.py``)."""

from __future__ import annotations

import torch


def smoothness_loss(disp: torch.Tensor, image: torch.Tensor | None = None,
                    edge_aware: bool = True, normalize: bool = True,
                    image_layout: str = "nhwc") -> torch.Tensor:
    """Mean |d disp| penalty on a (B, H, W, 1) inverse-depth map.

    ``image`` is (B, H, W, 3) for ``image_layout="nhwc"`` or (B, 3, H, W)
    for ``"chw"``; with ``edge_aware`` the disparity gradients are weighted
    by exp(-mean_c |dI|). ``normalize`` divides disp by its per-image mean.
    """
    d = disp.float()
    if normalize:
        d = d / (torch.mean(d, dim=(1, 2, 3), keepdim=True) + 1e-7)
    dx = torch.abs(d[:, :, 1:, :] - d[:, :, :-1, :])
    dy = torch.abs(d[:, 1:, :, :] - d[:, :-1, :, :])
    if edge_aware:
        if image is None:
            raise ValueError("edge_aware smoothness requires the image")
        img = image.float()
        if image_layout == "chw":
            gx = torch.abs(img[:, :, :, 1:] - img[:, :, :, :-1])
            gy = torch.abs(img[:, :, 1:, :] - img[:, :, :-1, :])
            wx = torch.exp(-torch.mean(gx, dim=1))[..., None]
            wy = torch.exp(-torch.mean(gy, dim=1))[..., None]
        else:
            gx = torch.abs(img[:, :, 1:, :] - img[:, :, :-1, :])
            gy = torch.abs(img[:, 1:, :, :] - img[:, :-1, :, :])
            wx = torch.exp(-torch.mean(gx, dim=-1, keepdim=True))
            wy = torch.exp(-torch.mean(gy, dim=-1, keepdim=True))
        dx = dx * wx
        dy = dy * wy
    return torch.mean(dx) + torch.mean(dy)
