"""Inverse warping with a plain bilinear sampler (counterpart of
``depthvo_tpu/geometry/warp.py``).

Out-of-bounds semantics are the reference's: a sample is valid when its
4-tap footprint lies inside the image and the point is in front of the
source camera; the gather clamps its indices, and values outside
``valid`` are unspecified (callers must mask).
"""

from __future__ import annotations

import torch

from depthvo_tpu_torch.geometry import camera as _camera


def warp_coords(depth: torch.Tensor, T: torch.Tensor, K: torch.Tensor):
    """Source-image sampling coordinates for inverse warping.

    Args: depth (B, H, W[, 1]) target-view depth; T (B, 4, 4) target-cam
    -> source-cam; K (B, 3, 3) or (3, 3).
    Returns: coords (B, H, W, 2) pixel (u, v); valid (B, H, W) bool.
    """
    points = _camera.backproject(depth, K)
    return _camera.project(_camera.transform_points(points, T), K)


def in_bounds(u: torch.Tensor, v: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The 4-tap bilinear footprint at (u, v) lies inside an H x W image."""
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    return (u0 >= 0) & (u0 + 1 <= W - 1) & (v0 >= 0) & (v0 + 1 <= H - 1)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor):
    """Bilinear sampling of (B, H, W, C) ``img`` at (B, Ho, Wo, 2) pixel
    coordinates. Returns (sampled (B, Ho, Wo, C), in_bounds (B, Ho, Wo))."""
    B, H, W, C = img.shape
    coords = coords.float()
    Ho, Wo = coords.shape[1:3]
    u, v = coords[..., 0], coords[..., 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    au = (u - u0)[..., None]
    av = (v - v0)[..., None]
    u0i = u0.long().clamp(0, W - 1)
    v0i = v0.long().clamp(0, H - 1)
    u1i = (u0i + 1).clamp(0, W - 1)
    v1i = (v0i + 1).clamp(0, H - 1)
    flat = img.reshape(B, H * W, C)

    def tap(vi, ui):
        idx = (vi * W + ui).reshape(B, Ho * Wo, 1).expand(B, Ho * Wo, C)
        return torch.gather(flat, 1, idx).reshape(B, Ho, Wo, C)

    sampled = (
        (1.0 - au) * (1.0 - av) * tap(v0i, u0i)
        + au * (1.0 - av) * tap(v0i, u1i)
        + (1.0 - au) * av * tap(v1i, u0i)
        + au * av * tap(v1i, u1i)
    )
    return sampled, in_bounds(u, v, H, W)


def inverse_warp(src: torch.Tensor, depth: torch.Tensor, T, K):
    """Synthesize the target view from the (B, H, W, C) source view.
    Returns (warped (B, H, W, C), valid (B, H, W))."""
    coords, front = warp_coords(depth, T, K)
    warped, inside = bilinear_sample(src, coords)
    return warped, inside & front
