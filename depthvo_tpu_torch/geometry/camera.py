"""Pinhole camera model in PyTorch (counterpart of
``depthvo_tpu/geometry/camera.py``).

* backproject:  X = D(u,v) * K^{-1} [u, v, 1]^T     (per pixel)
* transform:    X' = R X + t
* project:      [u', v'] = pi(K X'),  pi([x,y,z]) = [x/z, y/z]

Points are (..., H, W, 3) as in the reference; intrinsics (..., 3, 3).
All geometry runs in float32 (float64 inputs stay float64, for
``gradcheck``), with the 3x3 products written as
broadcast multiply + sum so that no TF32 setting can reach them (the
reference pins ``Precision.HIGHEST`` for the same reason: a bf16- or
TF32-class K^{-1} chain puts 0.1+ px of error into the warp).
"""

from __future__ import annotations

import torch

from depthvo_tpu_torch.geometry.se3 import as_real

# Pixels at or behind this depth are flagged invalid instead of dividing.
MIN_DEPTH = 1e-3


def intrinsics_matrix(fx, fy, cx, cy) -> torch.Tensor:
    """A (..., 3, 3) float32 intrinsics matrix from scalars or batched
    tensors (broadcast together)."""
    fx, fy, cx, cy = torch.broadcast_tensors(
        *(torch.as_tensor(a, dtype=torch.float32) for a in (fx, fy, cx, cy)))
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack([torch.stack([fx, z, cx], -1), torch.stack([z, fy, cy], -1),
                        torch.stack([z, z, o], -1)], -2)


def scale_intrinsics(K: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """Rescale intrinsics for an image resized by (sx, sy) = (W'/W, H'/H).

    Pixel centers sit at integer coordinates here while the pyramid
    resizes use half-pixel centers, so the principal point picks up a
    ``(s-1)/2`` offset on top of the plain scaling (see the reference's
    docstring for the derivation).
    """
    # K * [[sx, 1, sx], [1, sy, sy], [1, 1, 1]] + the offsets, written
    # on the entries that change, so that no constant is copied from the
    # host: such a copy waits for the device, and a CUDA graph of the
    # train step cannot hold it.
    K = as_real(K).clone()
    K[..., 0, 0::2] *= sx
    K[..., 0, 2] += (sx - 1.0) / 2.0
    K[..., 1, 1:] *= sy
    K[..., 1, 2] += (sy - 1.0) / 2.0
    return K


def pixel_grid(height: int, width: int, device=None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Homogeneous pixel grid (H, W, 3) of (u, v, 1), centers at integers."""
    u = torch.arange(width, dtype=dtype, device=device)
    v = torch.arange(height, dtype=dtype, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return torch.stack([uu, vv, torch.ones_like(uu)], dim=-1)


def backproject(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(..., H, W) or (..., H, W, 1) depth -> (..., H, W, 3) points."""
    depth = as_real(depth)
    if depth.shape[-1] == 1 and depth.ndim >= 3:
        depth = depth[..., 0]
    H, W = depth.shape[-2:]
    grid = pixel_grid(H, W, device=depth.device, dtype=depth.dtype)
    # inv_ex: inv's values without its check for singular K, which
    # reads a flag back from the device (a CUDA graph cannot hold that).
    K_inv = torch.linalg.inv_ex(as_real(K)).inverse
    rays = (K_inv[..., None, None, :, :] * grid[..., None, :]).sum(-1)
    return rays * depth[..., None]


def transform_points(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """X' = R X + t for points (..., H, W, 3) and T (..., 4, 4)."""
    points = as_real(points)
    T = as_real(T)
    R = T[..., None, None, :3, :3]
    t = T[..., None, None, :3, 3]
    return (R * points[..., None, :]).sum(-1) + t


def project(points: torch.Tensor, K: torch.Tensor):
    """Camera-frame points (..., H, W, 3) -> (coords (..., H, W, 2), valid).

    ``valid`` is z > MIN_DEPTH; elsewhere the coordinates come from a
    safe divide (finite garbage the caller must mask).
    """
    K = as_real(K)
    proj = (K[..., None, None, :, :] * as_real(points)[..., None, :]).sum(-1)
    z = proj[..., 2]
    valid = z > MIN_DEPTH
    z_safe = torch.where(valid, z, torch.ones_like(z))
    return proj[..., :2] / z_safe[..., None], valid
