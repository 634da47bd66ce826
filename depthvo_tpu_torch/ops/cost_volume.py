"""ManyDepth's plane-sweep cost volume (``networks/resnet_encoder.py``
``ResnetEncoderMatching``: ``match_features``, ``compute_confidence_mask``
and the lowest-cost argmin of ``forward``): one forward-only CUDA kernel
(``csrc/cost_volume.cu``) and its plain PyTorch version. The volume is
built under ``no_grad`` in the public code, so there is no backward.

Per pixel p of the current features F0 (B, C, h, w) and depth bin d
(``bins``, (D,)), with ``rays`` = K^-1 [x, y, 1] (B, 3, h, w) at the
features' scale and ``P`` = (K T)[:3] (B, 3, 4) of the matching pose::

    q    = P [bins[d] ray_p; 1], normalised as Project3D's, to [-1, 1]
    cost = edge(p, q) ? mean_c |bilinear_c(F-1, q) - F0_c(p)| : 0
    v    = cost / ((cost > 0) + 1e-7)

with the lookup features F-1 (B, C, h, w) sampled bilinearly with zero
padding and align_corners=True (``grid_sample``'s), ``edge`` keeping
samples within [2, w - 2] x [2, h - 2] and current pixels at least 2
from the border. A row whose ``valid`` is 0 (a zero matching pose) adds
nothing: v = 0 at every bin. Then, per pixel:

* ``conf``: 1 where no bin is missing (v > 0 at all D), else 0;
* ``volume`` (B, D, h, w): v times ``conf``; the public code first sets a
  missing bin to the pixel's maximum, which the confidence then zeroes;
* ``lowest`` (B, h, w): 1 / bins[argmin_d], the argmin over the volume
  with missing bins at the pixel's maximum and zeros read as 100 (the
  first bin where every bin is missing).

C is 64 (ResNet18's layer1). The features are float32 or bfloat16 (the
configuration's compute dtype); the arithmetic is float32.

* ``cost_volume_plain``: the function in the kernel's order of operations
  (the geometry term by term, the corners' weights as ``grid_sample``
  forms them and summed nw, ne, sw, se, the channels summed from 0 and
  divided by 64), so that the kernel equals it bit for bit on the card.
  Divisions by w - 1 and h - 1 take a tensor divisor (a CUDA division by
  a Python number multiplies by its reciprocal).
* ``cost_volume_fwd``: the kernel. The wrapper copies F-1 once into NHWC
  (each bilinear corner is then 64 contiguous channels) and allocates the
  three outputs.

Dispatch is on the tensors' device: CPU tensors take the plain version,
CUDA tensors the kernel, or the call raises; it never falls back. The
CUDA wrapper launches through ``_build.launch``, on the current stream,
which counts each launch in the ops package's ledger
(``_build.LAUNCHES``) as ``cost_volume``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from depthvo_tpu_torch.ops import _build

CHANNELS = 64
THREADS = 128  # csrc/cost_volume.cu's pixels a block (the library checks)
COUNT_EPS = 1e-7  # match_features' count normaliser
EMPTY_COST = 100.0  # what a zero cost reads as in the lowest-cost argmin
# Launch key -> the device kernel one launch runs, by its name in a
# profiler trace.
KERNELS = {"cost_volume": ("cost_volume_fwd_kernel",)}


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    """The built ``cost_volume.cu`` library with its C signature declared."""
    lib = _build.load("cost_volume")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.depthvo_cost_volume_fwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.depthvo_cost_volume_fwd.restype = i
    lib.depthvo_cost_volume_layout.argtypes = [p]
    lib.depthvo_cost_volume_layout.restype = None
    layout = (ctypes.c_int * 2)()
    lib.depthvo_cost_volume_layout(layout)
    if tuple(layout) != (CHANNELS, THREADS):
        raise RuntimeError(f"cost_volume.cu lays out {tuple(layout)}; cost_volume.py assumes "
                           f"{(CHANNELS, THREADS)}")
    return lib


def _check(cur, look, rays, P, bins, valid) -> Tuple[int, int, int, int]:
    """(B, h, w, D) of the arguments, or raises."""
    if cur.ndim != 4 or cur.shape[1] != CHANNELS:
        raise ValueError(f"cur must be (B, {CHANNELS}, h, w), got {tuple(cur.shape)}")
    B, _, h, w = cur.shape
    if cur.dtype not in (torch.float32, torch.bfloat16) or look.dtype != cur.dtype:
        raise ValueError(f"cur and look must share float32 or bfloat16, got {cur.dtype} and "
                         f"{look.dtype}")
    if tuple(look.shape) != tuple(cur.shape):
        raise ValueError(f"look must be {tuple(cur.shape)}, got {tuple(look.shape)}")
    for name, t, shape in (("rays", rays, (B, 3, h, w)), ("P", P, (B, 3, 4)),
                           ("bins", bins, (bins.shape[0],))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if tuple(valid.shape) != (B,):
        raise ValueError(f"valid must be ({B},), got {tuple(valid.shape)}")
    if bins.shape[0] < 1 or h < 1 or w < 1:
        raise ValueError("the cost volume needs a bin and a pixel")
    return B, h, w, bins.shape[0]


def cost_volume_plain(cur: torch.Tensor, look: torch.Tensor, rays: torch.Tensor,
                      P: torch.Tensor, bins: torch.Tensor, valid: torch.Tensor):
    """Plain version of ``cost_volume_fwd``: (volume, conf, lowest)."""
    B, h, w, D = _check(cur, look, rays, P, bins, valid)
    cur, look = cur.float(), look.float()
    dev = cur.device
    d = bins.view(1, D, 1, 1)
    X, Y, Z = (d * rays[:, None, i] for i in range(3))  # (B, D, h, w)
    p = P[:, :, :, None, None, None]
    cam = [((p[:, r, 0] * X + p[:, r, 1] * Y) + p[:, r, 2] * Z) + p[:, r, 3] for r in range(3)]
    z = cam[2] + 1e-7
    gx = (cam[0] / z / torch.full_like(z, w - 1) - 0.5) * 2
    gy = (cam[1] / z / torch.full_like(z, h - 1) - 0.5) * 2
    xv = (gx * 0.5 + 0.5) * (w - 1)
    yv = (gy * 0.5 + 0.5) * (h - 1)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inner = (ys >= 2) & (ys <= h - 3) & (xs >= 2) & (xs <= w - 3)
    edge = (inner & (xv >= 2.0) & (xv <= w - 2) & (yv >= 2.0) & (yv <= h - 2)
            & valid.bool().view(B, 1, 1, 1))
    ix = ((gx + 1) * 0.5) * (w - 1)
    iy = ((gy + 1) * 0.5) * (h - 1)
    x0, y0 = ix.floor(), iy.floor()
    x1, y1 = x0 + 1, y0 + 1
    weights = ((x1 - ix) * (y1 - iy), (ix - x0) * (y1 - iy), (x1 - ix) * (iy - y0),
               (ix - x0) * (iy - y0))
    flat = look.reshape(B, CHANNELS, h * w)
    gathers = []
    for cx, cy in ((x0, y0), (x1, y0), (x0, y1), (x1, y1)):
        inb = edge & (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
        at = torch.where(inb, cy * w + cx, torch.zeros_like(cx)).long().view(B, -1)
        gathers.append((inb, at))
    acc = None
    for c in range(CHANNELS):
        s = None
        for (inb, at), wt in zip(gathers, weights):
            v = torch.where(inb, torch.gather(flat[:, c], 1, at).view(B, D, h, w),
                            torch.zeros_like(wt))
            s = v * wt if s is None else s + v * wt
        diff = (s - cur[:, c, None]).abs()
        acc = diff if acc is None else acc + diff
    cost = torch.where(edge, acc / CHANNELS, torch.zeros_like(acc))
    v = cost / ((cost > 0).float() + COUNT_EPS)
    missing = v == 0
    conf = (~missing).all(1)
    vmax = v.amax(1, keepdim=True)
    filled = torch.where(missing, vmax, v)
    viz = torch.where(filled == 0, torch.full_like(filled, EMPTY_COST), filled)
    arg = torch.min(viz, 1)[1]
    lowest = 1 / bins[arg]
    volume = v * conf[:, None].float()
    return volume, conf.float(), lowest


def cost_volume_fwd_cuda(cur: torch.Tensor, look: torch.Tensor, rays: torch.Tensor,
                         P: torch.Tensor, bins: torch.Tensor, valid: torch.Tensor):
    """Launch ``cost_volume_fwd`` (csrc/cost_volume.cu): (volume, conf,
    lowest). Raises on anything the kernel does not take or when the launch
    fails; never falls back."""
    B, h, w, D = _check(cur, look, rays, P, bins, valid)
    dev = cur.device
    if dev.type != "cuda":
        raise ValueError(f"cur must be a CUDA tensor, got {dev}")
    for name, t in (("look", look), ("rays", rays), ("P", P), ("bins", bins),
                    ("valid", valid)):
        if t.device != dev:
            raise ValueError(f"{name} must be on {dev}, got {t.device}")
    if cur.numel() >= 2**31 or B * D * h * w >= 2**31:
        raise ValueError("the cost volume kernel takes fewer than 2**31 elements")
    cur = cur.contiguous()
    look_nhwc = look.permute(0, 2, 3, 1).contiguous()
    rays, P, bins = rays.contiguous(), P.contiguous(), bins.contiguous()
    valid = valid.to(torch.int32).contiguous()
    volume = torch.empty((B, D, h, w), dtype=torch.float32, device=dev)
    conf = torch.empty((B, h, w), dtype=torch.float32, device=dev)
    lowest = torch.empty((B, h, w), dtype=torch.float32, device=dev)
    _build.launch("cost_volume", _kernels().depthvo_cost_volume_fwd, cur.data_ptr(),
                  look_nhwc.data_ptr(), rays.data_ptr(), P.data_ptr(), bins.data_ptr(),
                  valid.data_ptr(), volume.data_ptr(), conf.data_ptr(), lowest.data_ptr(),
                  B, h, w, D, int(cur.dtype == torch.bfloat16), device=dev,
                  key=(B, h, w, D, str(cur.dtype)))
    return volume, conf, lowest


def cost_volume(cur: torch.Tensor, look: torch.Tensor, rays: torch.Tensor, P: torch.Tensor,
                bins: torch.Tensor, valid: torch.Tensor):
    """``cost_volume_fwd`` on the tensors' device: the plain version on the
    CPU, the kernel on CUDA. No gradient flows (the public code builds the
    volume under ``no_grad``)."""
    with torch.no_grad():
        if cur.device.type == "cpu":
            return cost_volume_plain(cur, look, rays, P, bins, valid)
        return cost_volume_fwd_cuda(cur, look, rays, P, bins, valid)
