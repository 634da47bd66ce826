"""Monodepth2's reprojection error (``trainer.py``
``compute_reprojection_loss``, ``layers.py`` ``SSIM``): two CUDA kernels
(``csrc/reproj.cu``) and their plain PyTorch versions, behind one
autograd boundary.

The function, per pixel of (B, 3, H, W) images ``pred`` and ``target`` in
float32::

    ssim_weight * mean_c clamp((1 - SSIM_c) / 2, 0, 1)
        + (1 - ssim_weight) * mean_c |target - pred|

with SSIM over the 3x3 windows of the reflection-padded images, written
as (B, 1, H, W). No TPU kernel: the JAX package has no Monodepth2. What
it replaces is the composition of :func:`reproj_fwd_plain` (two reflection
pads, five average pools, some twenty elementwise kernels and autograd's
backward of each), which reads and writes a full-size image per op.

* ``reproj_fwd``: the function above. The plain version is that
  composition.
* ``reproj_bwd``: the gradient with respect to ``pred`` under the
  cotangent ``g`` (B, 1, H, W); ``target`` is data and gets none. Per
  window centre p and channel, three coefficients (:func:`_centre_grads`):
  the derivatives with respect to the window's mu_x, E[x^2] and E[xy],
  each carrying g(p) ssim_weight / (2 * 3) and zero where the clamp does
  not pass; their transposed 3x3 box sum onto the padded grid (each over
  9), times 1, 2 pred and target; folded back through the reflection
  (padded row or column -1 onto 1, H or W onto H - 2 or W - 2) as
  ``F.pad(mode="reflect")``'s backward folds it; plus the L1 term
  ``(1 - ssim_weight) / 3 * g * sign(pred - target)`` (sign(0) = 0, as
  ``torch.abs``'s backward has it). The plain version is autograd's chain
  of the composition written out (the same floats on the CPU); the kernel
  takes the same operations in the same order.

Dispatch is on the tensors' device: CPU tensors take the plain versions,
CUDA tensors the kernels, or the call raises; it never falls back. The
CUDA wrappers allocate only their output and launch through
``_build.launch``, on the current stream, which counts each launch in the
ops package's ledger (``_build.LAUNCHES``) as ``reproj_fwd`` or
``reproj_bwd``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from depthvo_tpu_torch.ops import _build

SSIM_C1 = 0.01 ** 2
SSIM_C2 = 0.03 ** 2
# csrc/reproj.cu's tiling: output columns and rows a warp takes, warps a
# block (the library checks them when it loads).
FWD_COLS, FWD_ROWS = 30, 8
BWD_COLS, BWD_ROWS = 28, 10
WARPS = 4
# Launch key -> the device kernel one launch runs, by its name in a
# profiler trace.
KERNELS = {"reproj_fwd": ("reproj_ssim_l1_fwd_kernel",),
           "reproj_bwd": ("reproj_ssim_l1_bwd_kernel",)}


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    """The built ``reproj.cu`` library with its C signatures declared."""
    lib = _build.load("reproj")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.depthvo_reproj_fwd.argtypes = [p, p, p, i, i, i, f, f, p]
    lib.depthvo_reproj_bwd.argtypes = [p, p, p, p, i, i, i, f, f, p]
    lib.depthvo_reproj_fwd.restype = i
    lib.depthvo_reproj_bwd.restype = i
    lib.depthvo_reproj_layout.argtypes = [p]
    lib.depthvo_reproj_layout.restype = None
    layout = (ctypes.c_int * 5)()
    lib.depthvo_reproj_layout(layout)
    if tuple(layout) != (FWD_COLS, FWD_ROWS, BWD_COLS, BWD_ROWS, WARPS):
        raise RuntimeError(f"reproj.cu tiles as {tuple(layout)}; reproj.py assumes "
                           f"{(FWD_COLS, FWD_ROWS, BWD_COLS, BWD_ROWS, WARPS)}")
    return lib


# --------------------------------------------------------------------------
# Plain versions.
# --------------------------------------------------------------------------


def ssim_dissimilarity(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``clamp((1 - SSIM) / 2, 0, 1)`` per pixel and channel over 3x3
    windows of the reflection-padded images: (B, C, H, W), full size."""
    x = F.pad(x, (1, 1, 1, 1), mode="reflect")
    y = F.pad(y, (1, 1, 1, 1), mode="reflect")
    mu_x = F.avg_pool2d(x, 3, 1)
    mu_y = F.avg_pool2d(y, 3, 1)
    sigma_x = F.avg_pool2d(x ** 2, 3, 1) - mu_x ** 2
    sigma_y = F.avg_pool2d(y ** 2, 3, 1) - mu_y ** 2
    sigma_xy = F.avg_pool2d(x * y, 3, 1) - mu_x * mu_y
    n = (2 * mu_x * mu_y + SSIM_C1) * (2 * sigma_xy + SSIM_C2)
    d = (mu_x ** 2 + mu_y ** 2 + SSIM_C1) * (sigma_x + sigma_y + SSIM_C2)
    return torch.clamp((1 - n / d) / 2, 0, 1)


def reproj_fwd_plain(pred: torch.Tensor, target: torch.Tensor,
                     ssim_weight: float = 0.85) -> torch.Tensor:
    """Plain version of ``reproj_fwd``: ``ssim_weight * SSIM + (1 -
    ssim_weight) * L1``, each averaged over the channels: (B, 1, H, W)."""
    l1 = torch.abs(target - pred).mean(1, True)
    ssim = ssim_dissimilarity(pred, target).mean(1, True)
    return ssim_weight * ssim + (1.0 - ssim_weight) * l1


def _centre_grads(pred: torch.Tensor, target: torch.Tensor, g: torch.Tensor,
                  ssim_weight: float) -> tuple:
    """Per window centre, the gradient of :func:`reproj_fwd_plain` under
    the cotangent ``g`` with respect to the window's mu_x, E[x^2] and
    E[xy]: autograd's chain of :func:`ssim_dissimilarity` and the means,
    op for op and in its order of accumulation (the same floats on the
    CPU), zero where the clamp does not pass."""
    x = F.pad(pred, (1, 1, 1, 1), mode="reflect")
    y = F.pad(target, (1, 1, 1, 1), mode="reflect")
    mx = F.avg_pool2d(x, 3, 1)
    my = F.avg_pool2d(y, 3, 1)
    mxx, myy, mxy = mx * mx, my * my, mx * my
    sx = F.avg_pool2d(x * x, 3, 1) - mxx
    sy = F.avg_pool2d(y * y, 3, 1) - myy
    sxy = F.avg_pool2d(x * y, 3, 1) - mxy
    a = (2 * mx) * my + SSIM_C1
    bn = 2 * sxy + SSIM_C2
    cd = (mxx + myy) + SSIM_C1
    dd = (sx + sy) + SSIM_C2
    d = cd * dd
    q = (a * bn) / d
    v = (1 - q) / 2
    gs = (g * ssim_weight) / 3
    gq = -(torch.where((v >= 0) & (v <= 1), gs, torch.zeros_like(v)) / 2)
    gn = gq / d
    gd = -gq * (q / d)
    ga, gbn = gn * bn, gn * a
    gcd, gdd = gd * dd, gd * cd
    gsxy = gbn * 2
    gmx = ((gcd * (2 * mx) + (ga * my) * 2) + (-gsxy) * my) + (-gdd) * (2 * mx)
    return gmx, gdd, gsxy


def reproj_bwd_plain(pred: torch.Tensor, target: torch.Tensor, g: torch.Tensor,
                     ssim_weight: float = 0.85) -> torch.Tensor:
    """Plain version of ``reproj_bwd``: d pred (B, 3, H, W) of
    :func:`reproj_fwd_plain` under the cotangent ``g`` (B, 1, H, W). The
    centres' gradients (:func:`_centre_grads`) go back through the
    transposed window sums (``avg_pool2d``'s backward: each window's value
    over 9, summed at each padded pixel), times 2 pred for E[x^2] and
    target for E[xy], are folded through the reflection
    (``reflection_pad2d``'s backward: padded row or column -1 onto 1, H or
    W onto H - 2 or W - 2), and the L1 term joins them."""
    gmx, gxx, gxy = _centre_grads(pred, target, g, ssim_weight)
    x = F.pad(pred, (1, 1, 1, 1), mode="reflect")
    y = F.pad(target, (1, 1, 1, 1), mode="reflect")

    def unpool(c):
        return torch.ops.aten.avg_pool2d_backward(c, x, [3, 3], [1, 1], [0, 0], False, True,
                                                  None)

    d_x = (unpool(gxx) * (2 * x) + unpool(gxy) * y) + unpool(gmx)
    d_pred = torch.ops.aten.reflection_pad2d_backward(d_x, pred, [1, 1, 1, 1])
    return d_pred + ((g * (1.0 - ssim_weight)) / 3) * torch.sign(pred - target)


# --------------------------------------------------------------------------
# The kernels' wrappers.
# --------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_card(pred: torch.Tensor, **others: torch.Tensor) -> None:
    """Every tensor on pred's card (checked after every shape and dtype)."""
    if pred.device.type != "cuda":
        raise ValueError(f"pred must be a CUDA tensor, got {pred.device}")
    for name, t in others.items():
        if t.device != pred.device:
            raise ValueError(f"{name} must be on {pred.device}, got {t.device}")


def _images(pred: torch.Tensor, target: torch.Tensor) -> tuple:
    """(B, H, W) of the images the kernels take: (B, 3, H, W), H and W at
    least 2 (the reflection pad needs a row and a column beside the edge),
    float32, contiguous, fewer than 2**31 elements, at most 65535 images."""
    if pred.ndim != 4 or pred.shape[1] != 3:
        raise ValueError(f"pred must be (B, 3, H, W), got {tuple(pred.shape)}")
    B, _, H, W = pred.shape
    if H < 2 or W < 2:
        raise ValueError(f"pred is {H}x{W}; the reflection pad needs H and W of at least 2")
    if pred.numel() >= 2**31 or not 0 < B <= 65535:
        raise ValueError(f"pred {tuple(pred.shape)}: the kernels take 1 to 65535 images "
                         f"and fewer than 2**31 elements")
    _check("pred", pred, pred.shape)
    _check("target", target, pred.shape)
    return B, H, W


def reproj_fwd_cuda(pred: torch.Tensor, target: torch.Tensor,
                    ssim_weight: float = 0.85) -> torch.Tensor:
    """Launch ``reproj_fwd`` (csrc/reproj.cu): (B, 1, H, W). Raises on
    anything the kernel does not take or when the launch fails; never
    falls back."""
    B, H, W = _images(pred, target)
    _on_card(pred, target=target)
    out = torch.empty((B, 1, H, W), dtype=torch.float32, device=pred.device)
    _build.launch("reproj_fwd", _kernels().depthvo_reproj_fwd, pred.data_ptr(),
                  target.data_ptr(), out.data_ptr(), B, H, W, ssim_weight, 1.0 - ssim_weight,
                  device=pred.device, key=tuple(pred.shape))
    return out


def reproj_bwd_cuda(pred: torch.Tensor, target: torch.Tensor, g: torch.Tensor,
                    ssim_weight: float = 0.85) -> torch.Tensor:
    """Launch ``reproj_bwd`` (csrc/reproj.cu): d pred (B, 3, H, W). Raises
    on anything the kernel does not take or when the launch fails; never
    falls back."""
    B, H, W = _images(pred, target)
    _check("g", g, (B, 1, H, W))
    _on_card(pred, target=target, g=g)
    d_pred = torch.empty_like(pred)
    _build.launch("reproj_bwd", _kernels().depthvo_reproj_bwd, pred.data_ptr(),
                  target.data_ptr(), g.data_ptr(), d_pred.data_ptr(), B, H, W, ssim_weight,
                  1.0 - ssim_weight, device=pred.device, key=tuple(pred.shape))
    return d_pred


def reproj_fwd(pred: torch.Tensor, target: torch.Tensor, ssim_weight: float) -> torch.Tensor:
    """``reproj_fwd`` on the tensors' device: the plain version on the
    CPU, the kernel on CUDA."""
    if pred.device.type == "cpu":
        return reproj_fwd_plain(pred, target, ssim_weight)
    return reproj_fwd_cuda(pred, target, ssim_weight)


def reproj_bwd(pred: torch.Tensor, target: torch.Tensor, g: torch.Tensor,
               ssim_weight: float) -> torch.Tensor:
    """``reproj_bwd`` on the tensors' device."""
    if pred.device.type == "cpu":
        return reproj_bwd_plain(pred, target, g, ssim_weight)
    return reproj_bwd_cuda(pred, target, g, ssim_weight)


class ReprojectionError(torch.autograd.Function):
    """``apply(pred, target, ssim_weight)``: the reprojection error
    (B, 1, H, W) of ``pred`` against the data ``target``; the backward is
    ``reproj_bwd``, from the saved images, to ``pred`` alone."""

    @staticmethod
    def forward(ctx, pred, target, ssim_weight):
        if ctx.needs_input_grad[1]:
            raise ValueError("the reprojection error's target is data: it gets no gradient")
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(pred, target)
        ctx.ssim_weight = ssim_weight
        return reproj_fwd(pred, target, ssim_weight)

    @staticmethod
    def backward(ctx, g):
        pred, target = ctx.saved_tensors
        return reproj_bwd(pred, target, g.contiguous(), ctx.ssim_weight), None, None
