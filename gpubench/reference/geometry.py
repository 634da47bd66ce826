"""SE(3), the pinhole camera and the warps' sample coordinates and masks,
in float32.

Conventions: a twist is ``[v, w]`` and ``exp`` gives ``[[R, V v], [0, 1]]``
(target camera -> source camera); pixel centres sit at integers; the 3x3
products are written as multiply + sum so that no TF32 setting reaches
them. The warps' masks are the system's: a stereo sample is valid where
its two taps lie inside the image, off the last row, in front, and its
disparity within the static bound; a general sample is valid where its
four taps lie inside the image, in front, and inside the vertical window
of the warp kernel's row tiles (8 rows, half-window ``pad_v``, halved at
coarse scales until it fits) and 127 columns of its own.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-4
MIN_DEPTH = 1e-3
TILE_ROWS = 8
LANE = 128
KITTI_FX_608 = 355.0


def _matmul(a, b):
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _matvec(a, x):
    return (a * x[..., None, :]).sum(-1)


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _guarded(t2):
    small = t2 < EPS ** 2
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    return small, t2_safe, torch.sqrt(t2_safe)


def se3_exp(xi):
    """(..., 6) twist -> (..., 4, 4) transform."""
    v, w = xi[..., :3], xi[..., 3:]
    t2 = torch.sum(w * w, dim=-1)
    small, t2_safe, t = _guarded(t2)
    a = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0, (1.0 - torch.cos(t)) / t2_safe)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0,
                    (t - torch.sin(t)) / (t2_safe * t))
    W = hat(w)
    WW = _matmul(W, W)
    eye = torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * WW
    V = eye + b[..., None, None] * W + c[..., None, None] * WW
    top = torch.cat([R, _matvec(V, v)[..., None]], dim=-1)
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def scale_intrinsics(K, sx: float, sy: float):
    """Intrinsics of an image resized by (sx, sy), half-pixel centres."""
    K = K.clone()
    K[..., 0, 0::2] *= sx
    K[..., 0, 2] += (sx - 1.0) / 2.0
    K[..., 1, 1:] *= sy
    K[..., 1, 2] += (sy - 1.0) / 2.0
    return K


def warp_coords(depth, T, K):
    """Sample coordinates (u, v) and "in front" of inverse warping the
    source at pose ``T`` into the target view of ``depth`` (B, H, W)."""
    H, W = depth.shape[-2:]
    u = torch.arange(W, dtype=depth.dtype, device=depth.device)
    v = torch.arange(H, dtype=depth.dtype, device=depth.device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    grid = torch.stack([uu, vv, torch.ones_like(uu)], dim=-1)
    K_inv = torch.linalg.inv(K)
    pts = (K_inv[..., None, None, :, :] * grid[..., None, :]).sum(-1) * depth[..., None]
    pts = (T[..., None, None, :3, :3] * pts[..., None, :]).sum(-1) + T[..., None, None, :3, 3]
    proj = (K[..., None, None, :, :] * pts[..., None, :]).sum(-1)
    z = proj[..., 2]
    front = z > MIN_DEPTH
    z = torch.where(front, z, torch.ones_like(z))
    return proj[..., 0] / z, proj[..., 1] / z, front


def in_bounds(u, v, H: int, W: int):
    u0, v0 = torch.floor(u), torch.floor(v)
    return (u0 >= 0) & (u0 + 1 <= W - 1) & (v0 >= 0) & (v0 + 1 <= H - 1)


def window_pad(H: int, pad_v: int):
    """The general warp's vertical half-window at height ``H``, or None
    where no window fits (the plain warp's mask then)."""
    Hp = -(-H // TILE_ROWS) * TILE_ROWS
    while pad_v > 8 and Hp < 2 * pad_v + 8:
        pad_v = max(8, (pad_v // 2 + 7) // 8 * 8)
    return pad_v if Hp >= 2 * pad_v + 8 else None


def window_mask(u, v, H: int, pad_v: int):
    v0 = torch.floor(v)
    rows = torch.arange(v.shape[1], dtype=torch.float32, device=v.device)
    cols = torch.arange(u.shape[2], dtype=torch.float32, device=u.device)
    rv = 2 * pad_v + TILE_ROWS
    Hp = -(-H // TILE_ROWS) * TILE_ROWS
    s = torch.clamp(torch.floor(rows / TILE_ROWS) * TILE_ROWS - pad_v, 0, Hp - rv)[None, :, None]
    return (v0 >= s) & (v0 + 1 <= s + rv - 1) & (torch.abs(u - cols[None, None, :]) <= LANE - 1)


def general_coords(depth, T, K, pad_v: int):
    """(u, v, valid) of the general warp at ``depth``'s size."""
    H, W = depth.shape[-2:]
    u, v, front = warp_coords(depth, T, K)
    valid = in_bounds(u, v, H, W) & front
    pad = window_pad(H, pad_v)
    if pad is not None:
        valid = valid & window_mask(u, v, H, pad)
    return u, v, valid


def stereo_dmax(config: dict, width: int) -> int:
    """The stereo warp's static disparity bound (pixels) at ``width``."""
    m = config["model"]
    if config["stereo_dmax"]:
        d = config["stereo_dmax"] * width / m["width"]
    else:
        d = (config["stereo_dmax_margin"] * (KITTI_FX_608 / 608.0) * width
             * config["stereo_baseline"] * (m["max_disp"] + m["min_disp"]))
    return max(8, int(math.ceil(d / 8.0)) * 8)


def stereo_coords(depth, fx_baseline, dmax: int):
    """(u, valid) of the rectified stereo warp: u = col - fx b / depth."""
    H, W = depth.shape[-2:]
    disparity = fx_baseline.reshape(-1, 1, 1) / depth
    u = torch.arange(W, dtype=torch.float32, device=depth.device)[None, None, :] - disparity
    u0 = torch.floor(u)
    rows_ok = (torch.arange(H, device=u.device) + 1 <= H - 1)[None, :, None]
    valid = ((u0 >= 0) & (u0 + 1 <= W - 1) & (depth > 0) & rows_ok
             & (disparity >= 0) & (disparity <= dmax))
    return u, valid


def stereo_sample(src, u):
    """src (B, C, H, W) at columns clip(u, 0, W-1); differentiable in u."""
    B, C, H, W = src.shape
    u = u.clamp(0.0, W - 1)
    u0f = torch.floor(u.detach())
    x0 = u0f.long().clamp(0, W - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    au = (u - u0f)[:, None]
    s0 = torch.gather(src, 3, x0[:, None].expand(B, C, H, W))
    s1 = torch.gather(src, 3, x1[:, None].expand(B, C, H, W))
    return (1.0 - au) * s0 + au * s1


def general_sample(src, u, v):
    """src (B, C, H, W) bilinearly at (clip(u), clip(v)); differentiable
    in (u, v)."""
    B, C, H, W = src.shape
    u = u.clamp(0.0, W - 1)
    v = v.clamp(0.0, H - 1)
    u0f, v0f = torch.floor(u.detach()), torch.floor(v.detach())
    au, av = (u - u0f)[:, None], (v - v0f)[:, None]
    x0 = u0f.long().clamp(0, W - 1)
    y0 = v0f.long().clamp(0, H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    flat = src.reshape(B, C, H * W)

    def tap(y, x):
        idx = (y * W + x).reshape(B, 1, H * W).expand(B, C, H * W)
        return torch.gather(flat, 2, idx).reshape(B, C, H, W)

    h0 = (1.0 - au) * tap(y0, x0) + au * tap(y0, x1)
    h1 = (1.0 - au) * tap(y1, x0) + au * tap(y1, x1)
    return (1.0 - av) * h0 + av * h1
