"""Warp kernels and their coordinate/mask math (counterpart of
``depthvo_tpu/ops/warp_pallas.py``).

Two kernels, each a hand-written CUDA kernel (``csrc/warp.cu``) with a
plain PyTorch version of the same function beside it:

* ``stereo_fwd`` (replaces ``_stereo_fwd_kernel``): the rectified-stereo
  warp, a horizontal-only bilinear resample of each source row.
* ``gen_fwd`` (replaces ``_gen_fwd_kernel``): the general warp of a
  frozen source, a 2-D bilinear sample, optionally with the gradient
  factors S = d out / d u and D = d out / d v.

Dispatch is on the tensor's device: a CPU tensor goes to the plain
version; a CUDA tensor goes to the kernel, or the call raises. Each
wrapper counts its launches in :data:`LAUNCHES`.

The masks follow the reference's kernel path: ``valid`` of the general
warp includes the TPU kernel's reach (``window_mask``: the 8-row tile
window of ``pad_v`` rows and |u - col| <= 127), so the port drops exactly
the pixels the reference drops on the TPU.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from depthvo_tpu_torch.geometry import warp as geo_warp
from depthvo_tpu_torch.geometry.warp import in_bounds
from depthvo_tpu_torch.ops import _build

TILE_ROWS = 8  # the reference kernel's row tile; it shapes window_mask
LANE = 128  # the reference kernel's lane block; |u - col| <= LANE - 1
GEN_PAD_V = 16  # default vertical half-window (rows, a multiple of 8)

# Launches per (kernel name, src shape); only the CUDA wrappers count,
# where they launch.
LAUNCHES: collections.Counter = collections.Counter()


def launch_count(name: str) -> int:
    """Launches of kernel ``name`` since the last :func:`reset_launches`."""
    return sum(n for (k, _), n in LAUNCHES.items() if k == name)


def reset_launches() -> None:
    LAUNCHES.clear()


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    """The built ``warp.cu`` library with its C signatures declared."""
    lib = _build.load("warp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.depthvo_stereo_fwd.argtypes = [p, p, p, i, i, i, i, p]
    lib.depthvo_stereo_fwd.restype = i
    lib.depthvo_gen_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.depthvo_gen_fwd.restype = i
    return lib


def _check_cuda(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() >= 2**31:
        raise ValueError(f"{name} has {t.numel()} elements; the kernel takes < 2**31")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# --------------------------------------------------------------------------
# K1: stereo forward.
# --------------------------------------------------------------------------


def stereo_sample_plain(src: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain version of ``stereo_fwd``: src (B,C,H,W), u (B,H,W) ->
    (1-au) src[..,u0] + au src[..,min(u0+1,W-1)] with u clipped to
    [0, W-1]. Works on any device."""
    B, C, H, W = src.shape
    u = u.float().clamp(0.0, W - 1)
    u0f = torch.floor(u)
    au = (u - u0f)[:, None]
    x0 = u0f.long().clamp(0, W - 1)[:, None].expand(B, C, H, W)
    x1 = (x0 + 1).clamp(max=W - 1)
    s0 = torch.gather(src, 3, x0)
    s1 = torch.gather(src, 3, x1)
    return (1.0 - au) * s0 + au * s1


def stereo_sample_cuda(src: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Launch ``stereo_fwd`` (csrc/warp.cu). Raises on anything the kernel
    does not take or when the launch fails; never falls back."""
    if src.ndim != 4:
        raise ValueError(f"src must be (B, C, H, W), got {tuple(src.shape)}")
    B, C, H, W = src.shape
    _check_cuda("src", src, (B, C, H, W), src.device)
    _check_cuda("u", u, (B, H, W), src.device)
    out = torch.empty_like(src)
    lib = _kernels()
    err = lib.depthvo_stereo_fwd(
        src.data_ptr(), u.data_ptr(), out.data_ptr(), B, C, H, W,
        _stream(src.device),
    )
    if err:
        raise RuntimeError(f"stereo_fwd launch failed with CUDA error {err}")
    LAUNCHES[("stereo_fwd", (B, C, H, W))] += 1
    return out


def stereo_sample(src: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """K1 on the tensor's device: plain version on the CPU, kernel on CUDA."""
    if src.device.type == "cpu":
        return stereo_sample_plain(src, u)
    return stereo_sample_cuda(src, u)


# --------------------------------------------------------------------------
# K4: general frozen-source forward (optionally with gradient factors).
# --------------------------------------------------------------------------


def gen_sample_plain(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     emit_grad_aux: bool = False):
    """Plain version of ``gen_fwd``: 2-D bilinear sample of src (B,C,H,W)
    at (clip(u,0,W-1), clip(v,0,H-1)) with four ``torch.gather`` taps on
    the flattened H*W. With ``emit_grad_aux`` also returns
    S = (1-av)(s01-s00) + av(s11-s10) and D = h1 - h0."""
    B, C, H, W = src.shape
    u = u.float().clamp(0.0, W - 1)
    v = v.float().clamp(0.0, H - 1)
    u0f = torch.floor(u)
    v0f = torch.floor(v)
    au = (u - u0f)[:, None]
    av = (v - v0f)[:, None]
    x0 = u0f.long().clamp(0, W - 1)
    y0 = v0f.long().clamp(0, H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    flat = src.reshape(B, C, H * W)

    def tap(y, x):
        idx = (y * W + x).reshape(B, 1, H * W).expand(B, C, H * W)
        return torch.gather(flat, 2, idx).reshape(B, C, H, W)

    s00, s01, s10, s11 = tap(y0, x0), tap(y0, x1), tap(y1, x0), tap(y1, x1)
    h0 = (1.0 - au) * s00 + au * s01
    h1 = (1.0 - au) * s10 + au * s11
    out = (1.0 - av) * h0 + av * h1
    if not emit_grad_aux:
        return out
    s_aux = (1.0 - av) * (s01 - s00) + av * (s11 - s10)
    return out, s_aux, h1 - h0


def gen_sample_cuda(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    emit_grad_aux: bool = False):
    """Launch ``gen_fwd`` (csrc/warp.cu). Raises on anything the kernel
    does not take or when the launch fails; never falls back."""
    if src.ndim != 4:
        raise ValueError(f"src must be (B, C, H, W), got {tuple(src.shape)}")
    B, C, H, W = src.shape
    _check_cuda("src", src, (B, C, H, W), src.device)
    _check_cuda("u", u, (B, H, W), src.device)
    _check_cuda("v", v, (B, H, W), src.device)
    out = torch.empty_like(src)
    s_aux = torch.empty_like(src) if emit_grad_aux else None
    d_aux = torch.empty_like(src) if emit_grad_aux else None
    lib = _kernels()
    err = lib.depthvo_gen_fwd(
        src.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(),
        s_aux.data_ptr() if emit_grad_aux else None,
        d_aux.data_ptr() if emit_grad_aux else None,
        B, C, H, W, _stream(src.device),
    )
    if err:
        raise RuntimeError(f"gen_fwd launch failed with CUDA error {err}")
    LAUNCHES[("gen_fwd", (B, C, H, W))] += 1
    return (out, s_aux, d_aux) if emit_grad_aux else out


def gen_sample(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               emit_grad_aux: bool = False):
    """K4 on the tensor's device: plain version on the CPU, kernel on CUDA."""
    if src.device.type == "cpu":
        return gen_sample_plain(src, u, v, emit_grad_aux)
    return gen_sample_cuda(src, u, v, emit_grad_aux)


# --------------------------------------------------------------------------
# Coordinate and mask math shared by both paths.
# --------------------------------------------------------------------------


def window_mask(u: torch.Tensor, v: torch.Tensor, H: int, W: int,
                pad_v: int) -> torch.Tensor:
    """The reference kernel's reach: the (u, v) footprint lies inside the
    per-tile source window (vertical) and |u - col| <= 127."""
    v0 = torch.floor(v)
    rows = torch.arange(v.shape[1], dtype=torch.float32, device=v.device)
    cols = torch.arange(u.shape[2], dtype=torch.float32, device=u.device)
    rv = 2 * pad_v + TILE_ROWS
    Hp = -(-H // TILE_ROWS) * TILE_ROWS
    tile = torch.div(rows, TILE_ROWS, rounding_mode="floor")
    s = torch.clamp(tile * TILE_ROWS - pad_v, 0, Hp - rv)[None, :, None]
    return (
        (v0 >= s)
        & (v0 + 1 <= s + rv - 1)
        & (torch.abs(u - cols[None, None, :]) <= LANE - 1)
    )


def _gen_warp_prep(depth, T, K, H: int, W: int, pad_v: int):
    """Coordinates and validity of the general warp: (u, v, valid)."""
    if pad_v <= 0 or pad_v % TILE_ROWS:
        raise ValueError(f"pad_v must be a positive multiple of {TILE_ROWS}, got {pad_v}")
    Hp = -(-H // TILE_ROWS) * TILE_ROWS
    if Hp < 2 * pad_v + TILE_ROWS:
        raise ValueError(
            f"padded height {Hp} < window {2 * pad_v + TILE_ROWS}; reduce pad_v"
        )
    coords, front = geo_warp.warp_coords(depth, T, K)
    u = coords[..., 0].contiguous()
    v = coords[..., 1].contiguous()
    valid = in_bounds(u, v, H, W) & front & window_mask(u, v, H, W, pad_v)
    return u, v, valid


def general_warp_frozen_src_chw(src_chw: torch.Tensor, depth, T, K,
                                pad_v: int = GEN_PAD_V):
    """General inverse warp of a frozen (B,C,H,W) source through K4.
    Returns (warped (B,C,H,W) float32, valid (B,H,W))."""
    B, C, H, W = src_chw.shape
    u, v, valid = _gen_warp_prep(depth, T, K, H, W, pad_v)
    warped = gen_sample(src_chw.detach().float().contiguous(), u, v)
    return warped, valid


def stereo_disparity_u(depth: torch.Tensor, fx_baseline, W: int):
    """``disparity = fx*b / depth`` and the sample column ``u = col - disparity``."""
    if depth.ndim == 4:
        depth = depth[..., 0]
    fxb = torch.as_tensor(fx_baseline, dtype=torch.float32, device=depth.device)
    disparity = fxb.reshape(-1, 1, 1) / depth
    cols = torch.arange(W, dtype=torch.float32, device=depth.device)[None, None, :]
    return disparity, cols - disparity


def stereo_valid_mask(depth, disparity, u, H: int, W: int, dmax) -> torch.Tensor:
    """Footprint in-image (the last row is invalid, as in bilinear_sample),
    positive depth, and the static disparity bound ``dmax``."""
    u0 = torch.floor(u)
    rows_ok = (torch.arange(H, device=u.device) + 1 <= H - 1)[None, :, None]
    valid = (u0 >= 0) & (u0 + 1 <= W - 1) & (depth > 0) & rows_ok
    if dmax is not None:
        valid = valid & (disparity >= 0) & (disparity <= dmax)
    return valid


def stereo_warp_chw(src_chw: torch.Tensor, depth: torch.Tensor, fx_baseline,
                    dmax: int = 128):
    """Rectified-stereo inverse warp of a (B,C,H,W) source through
    ``stereo_fwd``: samples at u = col - fx*b/depth. ``dmax`` is the static
    disparity bound in pixels (derive it with ``configs.base.stereo_dmax``;
    ``None`` drops the bound). Returns (warped, valid (B,H,W))."""
    B, C, H, W = src_chw.shape
    if depth.ndim == 4:
        depth = depth[..., 0]
    disparity, u = stereo_disparity_u(depth, fx_baseline, W)
    valid = stereo_valid_mask(depth, disparity, u, H, W, dmax)
    warped = stereo_sample(src_chw.float().contiguous(), u.contiguous())
    return warped, valid
