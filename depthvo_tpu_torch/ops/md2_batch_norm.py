"""Single-card train-mode BatchNorm with an optional ReLU epilogue, for
Monodepth2's encoders: four CUDA kernels (``csrc/md2_batch_norm.cu``),
their plain PyTorch versions, and the autograd boundary between them.

What it replaces: ``F.batch_norm(x, ..., training=True)`` followed by
``F.relu`` (Monodepth2's ``BasicBlock`` and stem) or alone (``bn2``, the
downsample), whose NCHW kernels put one block on each channel. No TPU
kernel: the JAX package has no Monodepth2.

* ``stats``: per channel of (N, C, H, W) ``x`` the count, mean and M2 of
  each block's share, as float32 partials (the plain version gives the
  channel's mean and biased variance directly).
* ``normalize``: the partials merged by Chan's formula, var = M2 / n
  (biased), rstd = 1 / sqrt(var + eps), ``y = (x - mean) * (rstd * weight)
  + bias`` in float32, ``relu`` if asked, cast to x's dtype; ``save`` =
  [mean | rstd] (2C) for the backward; unless ``update`` is False (a remat
  recompute) the running averages move as ``prev * (1 - m) + stat * m``
  with the biased variance, as :class:`layers.BatchNorm` moves them.
* ``bwd_reduce``: per channel the sums of g' and g' * xhat, xhat = (x -
  mean) * rstd, where g' is g masked by the ReLU: the pre-activation is
  recomputed from x and ``save`` by the forward's operations, so the mask
  is the forward's bit for bit.
* ``bwd_elemt``: dx = (weight * rstd) * ((g' - Sg'/n) - xhat * Sg'xhat/n);
  dweight = Sg'xhat, dbias = Sg'.

:class:`Md2BatchNorm` runs stats, normalize forward and bwd_reduce,
bwd_elemt backward. Dispatch is on the tensor's device: a CPU tensor goes
to the plain versions; a CUDA tensor goes to the kernels, or the call
raises. The CUDA wrappers launch through ``_build.launch``, which counts
each launch under its key of :data:`KERNELS` in the ops package's one
ledger (``_build.LAUNCHES``, so a CUDA graph's replays count them too).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from depthvo_tpu_torch.ops import _build
from depthvo_tpu_torch.ops.batch_norm import DTYPES, _like, _nchw, _on_card, _vec

# Launch key -> the device kernel one launch runs, by its name in a
# profiler trace (``batch_norm`` in every name: the profiler and the
# benchmark file them under BatchNorm).
KERNELS = {
    "md2_bn_stats": ("md2_batch_norm_stats_kernel",),
    "md2_bn_normalize": ("md2_batch_norm_normalize_kernel",),
    "md2_bn_bwd_reduce": ("md2_batch_norm_bwd_reduce_kernel",),
    "md2_bn_bwd_elemt": ("md2_batch_norm_bwd_elemt_kernel",),
}
# Blocks a launch aims at: the H100's 132 SMs at four resident blocks each
# (csrc/md2_batch_norm.cu kMinBlocks), so that the grid is one wave.
TARGET_BLOCKS = 528
THREADS = 256  # csrc/md2_batch_norm.cu kThreads
VEC_BYTES = 16
MIN_VECTORS = 2  # vectors a thread is given at the least


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    """The built ``md2_batch_norm.cu`` library with its C signatures declared."""
    lib = _build.load("md2_batch_norm")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.depthvo_md2_bn_stats.argtypes = [p, i, i, i, i, i, p, p]
    lib.depthvo_md2_bn_normalize.argtypes = [p, i, i, i, i, i, p, p, p, f, f, i, i, p, p, p, p,
                                             p]
    lib.depthvo_md2_bn_bwd_reduce.argtypes = [p, p, i, i, i, i, i, p, p, p, i, p, p]
    lib.depthvo_md2_bn_bwd_elemt.argtypes = [p, p, i, i, i, i, i, p, p, p, p, i, p, p, p]
    for fn in (lib.depthvo_md2_bn_stats, lib.depthvo_md2_bn_normalize,
               lib.depthvo_md2_bn_bwd_reduce, lib.depthvo_md2_bn_bwd_elemt):
        fn.restype = i
    return lib


def chunks_of(N: int, C: int, HW: int, itemsize: int) -> int:
    """Blocks per channel: as many as fill :data:`TARGET_BLOCKS` with C
    channels, no more than leave each thread :data:`MIN_VECTORS` vectors."""
    per_block = THREADS * MIN_VECTORS * (VEC_BYTES // itemsize)
    return max(1, min(TARGET_BLOCKS // C, -(-(N * HW) // per_block)))


# --------------------------------------------------------------------------
# Plain versions.
# --------------------------------------------------------------------------


def stats_plain(x: torch.Tensor, eps: float) -> tuple:
    """Per channel of (N, C, H, W) ``x``: (mean, biased var, rstd) in
    float32, by two passes as PyTorch's CPU BatchNorm takes them: the mean
    from a float64 sum, the variance from the float64 sum of the float32
    (x - mean)^2, rstd = 1 / sqrt(var + eps) in float64, each rounded once
    to float32. A channel whose mean is far from its deviation loses
    nothing to cancellation."""
    xf = x.float()
    dims = (0, 2, 3)
    n = torch.full((xf.shape[1],), xf.numel() // xf.shape[1], dtype=torch.float32,
                   device=xf.device)
    mean = (xf.double().sum(dims) / n.double()).float()
    d = xf - mean.view(1, -1, 1, 1)
    var = (d * d).double().sum(dims).float() / n
    return mean, var, (1.0 / torch.sqrt(var.double() + eps)).float()


def _pre(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor, weight: torch.Tensor,
         bias: torch.Tensor) -> tuple:
    """(x - mean) and the pre-activation (x - mean) * (rstd * weight) +
    bias in float32, each op rounded on its own."""
    shape = (1, -1, 1, 1)
    d = x.float() - mean.view(shape)
    return d, d * (rstd * weight).view(shape) + bias.view(shape)


def normalize_plain(x: torch.Tensor, save: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """Plain version of ``normalize``'s y from ``save`` = [mean | rstd]."""
    c = x.shape[1]
    _, y = _pre(x, save[:c], save[c:], weight, bias)
    if relu:
        y = torch.where(y < 0, torch.zeros_like(y), y)
    return y.to(x.dtype)


def _grad_in(g, x, save, weight, bias, relu) -> tuple:
    """(g', xhat) in float32: g masked where the recomputed pre-activation
    is not > 0 (with the ReLU), and (x - mean) * rstd."""
    c = x.shape[1]
    d, pre = _pre(x, save[:c], save[c:], weight, bias)
    gp = g.float()
    if relu:
        gp = torch.where(pre > 0, gp, torch.zeros_like(gp))
    return gp, d * save[c:].view(1, -1, 1, 1)


def bwd_reduce_plain(g: torch.Tensor, x: torch.Tensor, save: torch.Tensor,
                     weight: torch.Tensor, bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """Plain version of ``bwd_reduce``: [sum g' xhat | sum g'] per channel,
    which are [dweight | dbias]."""
    gp, xhat = _grad_in(g, x, save, weight, bias, relu)
    return torch.cat([(gp * xhat).sum((0, 2, 3)), gp.sum((0, 2, 3))])


def bwd_elemt_plain(g: torch.Tensor, x: torch.Tensor, save: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, dwb: torch.Tensor, relu: bool) -> torch.Tensor:
    """Plain version of ``bwd_elemt``: dx in x's dtype from ``dwb`` =
    [sum g' xhat | sum g'] (the kernel's own, or :func:`bwd_reduce_plain`'s)."""
    c = x.shape[1]
    # n as a tensor: a tensor divided by a Python number multiplies by its
    # reciprocal on the card, which rounds otherwise than the kernel's
    # division.
    n = torch.full_like(dwb[:c], x.numel() // c)
    gp, xhat = _grad_in(g, x, save, weight, bias, relu)
    shape = (1, c, 1, 1)
    a, b = dwb[c:] / n, dwb[:c] / n
    k = weight * save[c:]
    dx = k.view(shape) * ((gp - a.view(shape)) - xhat * b.view(shape))
    return dx.to(x.dtype)


def forward_plain(x, weight, bias, running_mean, running_var, momentum, eps, relu,
                  update=True) -> tuple:
    """The forward on the CPU: (y, save); the running averages move in
    place when ``update``."""
    mean, var, rstd = stats_plain(x, eps)
    if update:
        with torch.no_grad():
            running_mean.copy_(running_mean * (1.0 - momentum) + mean * momentum)
            running_var.copy_(running_var * (1.0 - momentum) + var * momentum)
    save = torch.cat([mean, rstd])
    return normalize_plain(x, save, weight, bias, relu), save


def backward_plain(g, x, save, weight, bias, relu) -> tuple:
    """The backward on the CPU: (dx, dwb = [dweight | dbias])."""
    dwb = bwd_reduce_plain(g, x, save, weight, bias, relu)
    return bwd_elemt_plain(g, x, save, weight, bias, dwb, relu), dwb


# --------------------------------------------------------------------------
# The kernels.
# --------------------------------------------------------------------------


def _params(x: torch.Tensor, **vecs: torch.Tensor) -> tuple:
    N, C, HW = _nchw("x", x)
    for name, t in vecs.items():
        _vec(name, t, 2 * C if name == "save" else C)
    return N, C, HW, chunks_of(N, C, HW, x.element_size())


def stats_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch ``stats``: the partials (C * chunks * 3). Raises on anything
    the kernel does not take or when the launch fails; never falls back."""
    N, C, HW, chunks = _params(x)
    _on_card(x)
    partial = torch.empty(C * chunks * 3, dtype=torch.float32, device=x.device)
    _build.launch("md2_bn_stats", _kernels().depthvo_md2_bn_stats, x.data_ptr(),
                  DTYPES[x.dtype], N, C, HW, chunks, partial.data_ptr(), device=x.device,
                  key=tuple(x.shape))
    return partial


def normalize_cuda(x, partial, weight, bias, running_mean, running_var, momentum, eps, relu,
                   update=True) -> tuple:
    """Launch ``normalize`` on the partials of :func:`stats_cuda`: (y,
    save); the running averages move in place when ``update``."""
    vecs = dict(weight=weight, bias=bias, running_mean=running_mean, running_var=running_var)
    N, C, HW, chunks = _params(x, **vecs)
    _vec("partial", partial, C * chunks * 3)
    _on_card(x, partial=partial, **vecs)
    y = torch.empty_like(x)
    save = torch.empty(2 * C, dtype=torch.float32, device=x.device)
    _build.launch("md2_bn_normalize", _kernels().depthvo_md2_bn_normalize, x.data_ptr(),
                  DTYPES[x.dtype], N, C, HW, chunks, partial.data_ptr(), weight.data_ptr(),
                  bias.data_ptr(), eps, momentum, int(update), int(relu), y.data_ptr(),
                  save.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
                  device=x.device, key=tuple(x.shape))
    return y, save


def bwd_reduce_cuda(g, x, save, weight, bias, relu) -> torch.Tensor:
    """Launch ``bwd_reduce``: the partials (C * chunks * 2)."""
    N, C, HW, chunks = _params(x, save=save, weight=weight, bias=bias)
    _like("g", g, x)
    _on_card(x, g=g, save=save, weight=weight, bias=bias)
    partial = torch.empty(C * chunks * 2, dtype=torch.float32, device=x.device)
    _build.launch("md2_bn_bwd_reduce", _kernels().depthvo_md2_bn_bwd_reduce, g.data_ptr(),
                  x.data_ptr(), DTYPES[x.dtype], N, C, HW, chunks, save.data_ptr(),
                  weight.data_ptr(), bias.data_ptr(), int(relu), partial.data_ptr(),
                  device=x.device, key=tuple(x.shape))
    return partial


def bwd_elemt_cuda(g, x, save, weight, bias, partial, relu) -> tuple:
    """Launch ``bwd_elemt`` on the partials of :func:`bwd_reduce_cuda`:
    (dx, dwb = [dweight | dbias])."""
    N, C, HW, chunks = _params(x, save=save, weight=weight, bias=bias)
    _like("g", g, x)
    _vec("partial", partial, C * chunks * 2)
    _on_card(x, g=g, save=save, weight=weight, bias=bias, partial=partial)
    dx = torch.empty_like(x)
    dwb = torch.empty(2 * C, dtype=torch.float32, device=x.device)
    _build.launch("md2_bn_bwd_elemt", _kernels().depthvo_md2_bn_bwd_elemt, g.data_ptr(),
                  x.data_ptr(), DTYPES[x.dtype], N, C, HW, chunks, save.data_ptr(),
                  weight.data_ptr(), bias.data_ptr(), partial.data_ptr(), int(relu),
                  dx.data_ptr(), dwb.data_ptr(), device=x.device, key=tuple(x.shape))
    return dx, dwb


# --------------------------------------------------------------------------
# The autograd boundary.
# --------------------------------------------------------------------------


class Md2BatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of (N, C, H, W) ``x`` on one card, with the
    ReLU after it when ``relu``: forward ``stats`` and ``normalize``,
    backward ``bwd_reduce`` and ``bwd_elemt``; the plain versions on the
    CPU.

    ``apply(x, weight, bias, running_mean, running_var, momentum, eps,
    relu, update)``: torch's ``momentum``; the running averages move in
    place towards the batch's mean and biased variance when ``update``
    (not in a remat recompute)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps, relu, update):
        x = x.contiguous()
        if x.device.type == "cpu":
            y, save = forward_plain(x, weight, bias, running_mean, running_var, momentum, eps,
                                    relu, update)
        else:
            partial = stats_cuda(x)
            y, save = normalize_cuda(x, partial, weight, bias, running_mean, running_var,
                                     momentum, eps, relu, update)
        ctx.save_for_backward(x, weight, bias, save)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, save = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        if x.device.type == "cpu":
            dx, dwb = backward_plain(g, x, save, weight, bias, ctx.relu)
        else:
            partial = bwd_reduce_cuda(g, x, save, weight, bias, ctx.relu)
            dx, dwb = bwd_elemt_cuda(g, x, save, weight, bias, partial, ctx.relu)
        c = x.shape[1]
        return (dx if ctx.needs_input_grad[0] else None, dwb[:c], dwb[c:], None, None, None,
                None, None, None)
