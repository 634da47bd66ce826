"""Train-mode BatchNorm over a data-parallel mesh: four CUDA kernels
(``csrc/batch_norm.cu``) and their plain PyTorch versions, and the
autograd boundary that puts the all-reduces between them.

What it replaces: flax ``nn.BatchNorm(use_running_average=False)`` under a
jit whose batch is sharded over a mesh (``depthvo_tpu/models/layers.py``,
``ConvBlock``), whose statistics XLA reduces over the global batch. That
is not a Pallas kernel; the port writes the reduction explicitly:

* ``bn_stats``: per channel the local sum and sum of squares of x, and the
  element count, in one float32 buffer of 2C + 1, the buffer that is
  all-reduced.
* ``bn_normalize``: from the reduced buffer, mean = S/n, var = max(Q/n -
  mean^2, 0) (flax's ``use_fast_variance``), rstd = 1/sqrt(var + eps),
  ``y = (x - mean) * (rstd * scale) + bias`` in float32, cast to x's dtype;
  unless ``update`` is False (a remat recompute), the running averages move
  as ``prev * (1 - m) + stat * m`` with flax's biased variance. It returns
  what the backward needs: ``save`` = [mean | rstd | live | n] (3C + 1;
  ``live`` 0 where the clamp was on).
* ``bn_bwd_reduce``: per channel the local sum of g and of g * xhat, xhat =
  (x - mean) * rstd, written twice (4C): the first 2C are all-reduced, the
  last 2C are this rank's dbias and dscale.
* ``bn_bwd_elemt``: dx = (scale * rstd) * ((g - SG/n) - xhat * SGX/n) from
  the reduced sums, without the xhat term where the clamp was on (autograd
  through ``clamp`` drops it there).

:class:`GlobalBatchNorm` runs stats, a SUM all-reduce, normalize forward
and reduce, a SUM all-reduce, elemt backward: two all-reduces per layer and
step, as the composed autograd formula it replaces made.

Dispatch is on the tensor's device: a CPU tensor goes to the plain
version; a CUDA tensor goes to the kernel, or the call raises. The CUDA
wrappers launch through ``_build.launch``, which counts each launch under
its key of :data:`KERNELS` in the ops package's one ledger
(``_build.LAUNCHES``, so a CUDA graph's replays count them as they count
the warps').
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.distributed as dist

from depthvo_tpu_torch.ops import _build

# Launch key -> the device kernels one launch runs, by their names in a
# profiler trace: bn_stats and bn_bwd_reduce write partial sums and then
# sum them in a fixed order.
KERNELS = {
    "bn_stats": ("bn_stats_partial_kernel", "bn_sum_partials_kernel"),
    "bn_normalize": ("bn_normalize_kernel",),
    "bn_bwd_reduce": ("bn_bwd_partial_kernel", "bn_sum_partials_kernel"),
    "bn_bwd_elemt": ("bn_bwd_elemt_kernel",),
}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Blocks a launch aims at: a few per SM of the H100's 132, so that a
# layer of C = 32 channels fills the card as one of C = 1024 does.
TARGET_BLOCKS = 528
THREADS = 256  # csrc/batch_norm.cu kThreads
VEC_BYTES = 16


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    """The built ``batch_norm.cu`` library with its C signatures declared."""
    lib = _build.load("batch_norm")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.depthvo_bn_stats.argtypes = [p, i, i, i, i, i, p, p, p]
    lib.depthvo_bn_normalize.argtypes = [p, i, i, i, i, i, p, p, p, f, f, f, i, p, p, p, p, p]
    lib.depthvo_bn_bwd_reduce.argtypes = [p, p, i, i, i, i, i, p, p, p, p]
    lib.depthvo_bn_bwd_elemt.argtypes = [p, p, i, i, i, i, i, p, p, p, p, p]
    for fn in (lib.depthvo_bn_stats, lib.depthvo_bn_normalize, lib.depthvo_bn_bwd_reduce,
               lib.depthvo_bn_bwd_elemt):
        fn.restype = i
    return lib


def chunks_of(C: int, HW: int, itemsize: int) -> int:
    """Blocks per channel: enough that the launch has about
    :data:`TARGET_BLOCKS` blocks, no more than give each thread one 16-byte
    load per run."""
    per_block = THREADS * (VEC_BYTES // itemsize)
    return max(1, min(-(-TARGET_BLOCKS // C), -(-HW // per_block)))


def _nchw(name: str, x: torch.Tensor) -> tuple:
    """(N, C, HW) of a tensor the kernels take: float32 or bfloat16, (N, C,
    H, W), contiguous, 1 to 2**31 - 1 elements, at most 65535 channels."""
    if x.dtype not in DTYPES:
        raise ValueError(f"{name} must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"{name} must be (N, C, H, W), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous (NCHW)")
    if not 0 < x.numel() < 2**31:
        raise ValueError(f"{name} has {x.numel()} elements; the kernels take 1 to 2**31 - 1")
    N, C, H, W = x.shape
    if C > 65535:
        raise ValueError(f"{name} has {C} channels; the kernels take at most 65535")
    return N, C, H * W


def _like(name: str, t: torch.Tensor, x: torch.Tensor) -> None:
    if t.dtype != x.dtype or t.shape != x.shape or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {x.dtype} {tuple(x.shape)} like x, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _vec(name: str, t: torch.Tensor, n: int) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != (n,) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 ({n},) tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _on_card(x: torch.Tensor, **others: torch.Tensor) -> None:
    """Every tensor on x's card (checked after every shape and dtype)."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    for name, t in others.items():
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")


# --------------------------------------------------------------------------
# bn_stats
# --------------------------------------------------------------------------


def bn_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``bn_stats``: [sum x | sum x^2 | count] per channel
    of (N, C, H, W) ``x`` in float32 (2C + 1)."""
    xf = x.float()
    c = xf.shape[1]
    return torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                      xf.new_full((1,), xf.numel() // c)])


def bn_stats_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch ``bn_stats`` (csrc/batch_norm.cu). Raises on anything the
    kernel does not take or when the launch fails; never falls back."""
    N, C, HW = _nchw("x", x)
    _on_card(x)
    chunks = chunks_of(C, HW, x.element_size())
    partial = torch.empty(C * chunks * 2, dtype=torch.float32, device=x.device)
    stats = torch.empty(2 * C + 1, dtype=torch.float32, device=x.device)
    _build.launch("bn_stats", _kernels().depthvo_bn_stats, x.data_ptr(), DTYPES[x.dtype],
                  N, C, HW, chunks, partial.data_ptr(), stats.data_ptr(), device=x.device,
                  key=tuple(x.shape))
    return stats


def bn_stats(x: torch.Tensor) -> torch.Tensor:
    """``bn_stats`` on x's device: the plain version on the CPU, the
    kernel on CUDA."""
    return bn_stats_plain(x) if x.device.type == "cpu" else bn_stats_cuda(x)


# --------------------------------------------------------------------------
# bn_normalize
# --------------------------------------------------------------------------


def bn_normalize_plain(x: torch.Tensor, stats: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, running_mean: torch.Tensor,
                       running_var: torch.Tensor, momentum: float, eps: float,
                       update: bool = True) -> tuple:
    """Plain version of ``bn_normalize``: (y, save) from the reduced
    ``stats``; the running averages move in place when ``update``."""
    c = x.shape[1]
    n = stats[2 * c]
    mean = stats[:c] / n
    var_raw = stats[c:2 * c] / n - mean * mean
    var = torch.clamp(var_raw, min=0.0)
    rstd = torch.sqrt(var + eps).reciprocal()
    if update:
        with torch.no_grad():
            running_mean.copy_(running_mean * (1.0 - momentum) + mean * momentum)
            running_var.copy_(running_var * (1.0 - momentum) + var * momentum)
    shape = (1, c, 1, 1)
    mul = rstd * weight
    y = (x.float() - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    save = torch.cat([mean, rstd, (~(var_raw < 0)).float(), n.view(1)])
    return y.to(x.dtype), save


def bn_normalize_cuda(x: torch.Tensor, stats: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, running_mean: torch.Tensor,
                      running_var: torch.Tensor, momentum: float, eps: float,
                      update: bool = True) -> tuple:
    """Launch ``bn_normalize`` (csrc/batch_norm.cu): (y, save); the running
    averages move in place when ``update``. Raises on anything the kernel
    does not take or when the launch fails; never falls back."""
    N, C, HW = _nchw("x", x)
    vecs = dict(weight=weight, bias=bias, running_mean=running_mean, running_var=running_var)
    _vec("stats", stats, 2 * C + 1)
    for name, t in vecs.items():
        _vec(name, t, C)
    _on_card(x, stats=stats, **vecs)
    y = torch.empty_like(x)
    save = torch.empty(3 * C + 1, dtype=torch.float32, device=x.device)
    _build.launch("bn_normalize", _kernels().depthvo_bn_normalize, x.data_ptr(),
                  DTYPES[x.dtype], N, C, HW, chunks_of(C, HW, x.element_size()),
                  stats.data_ptr(), weight.data_ptr(), bias.data_ptr(), eps, momentum,
                  1.0 - momentum, int(update), y.data_ptr(), save.data_ptr(),
                  running_mean.data_ptr(), running_var.data_ptr(), device=x.device,
                  key=tuple(x.shape))
    return y, save


def bn_normalize(x, stats, weight, bias, running_mean, running_var, momentum, eps,
                 update=True) -> tuple:
    """``bn_normalize`` on x's device: the plain version on the CPU, the
    kernel on CUDA."""
    fn = bn_normalize_plain if x.device.type == "cpu" else bn_normalize_cuda
    return fn(x, stats, weight, bias, running_mean, running_var, momentum, eps, update)


# --------------------------------------------------------------------------
# bn_bwd_reduce
# --------------------------------------------------------------------------


def bn_bwd_reduce_plain(g: torch.Tensor, x: torch.Tensor, save: torch.Tensor) -> torch.Tensor:
    """Plain version of ``bn_bwd_reduce``: [sum g | sum g xhat] per channel,
    twice (4C)."""
    c = x.shape[1]
    shape = (1, c, 1, 1)
    xhat = (x.float() - save[:c].view(shape)) * save[c:2 * c].view(shape)
    gf = g.float()
    sums = torch.cat([gf.sum((0, 2, 3)), (gf * xhat).sum((0, 2, 3))])
    return torch.cat([sums, sums])


def bn_bwd_reduce_cuda(g: torch.Tensor, x: torch.Tensor, save: torch.Tensor) -> torch.Tensor:
    """Launch ``bn_bwd_reduce`` (csrc/batch_norm.cu). Raises on anything the
    kernel does not take or when the launch fails; never falls back."""
    N, C, HW = _nchw("x", x)
    _like("g", g, x)
    _vec("save", save, 3 * C + 1)
    _on_card(x, g=g, save=save)
    chunks = chunks_of(C, HW, x.element_size())
    partial = torch.empty(C * chunks * 2, dtype=torch.float32, device=x.device)
    sums = torch.empty(4 * C, dtype=torch.float32, device=x.device)
    _build.launch("bn_bwd_reduce", _kernels().depthvo_bn_bwd_reduce, g.data_ptr(),
                  x.data_ptr(), DTYPES[x.dtype], N, C, HW, chunks, save.data_ptr(),
                  partial.data_ptr(), sums.data_ptr(), device=x.device, key=tuple(x.shape))
    return sums


def bn_bwd_reduce(g: torch.Tensor, x: torch.Tensor, save: torch.Tensor) -> torch.Tensor:
    """``bn_bwd_reduce`` on x's device: the plain version on the CPU, the
    kernel on CUDA."""
    return bn_bwd_reduce_plain(g, x, save) if x.device.type == "cpu" \
        else bn_bwd_reduce_cuda(g, x, save)


# --------------------------------------------------------------------------
# bn_bwd_elemt
# --------------------------------------------------------------------------


def bn_bwd_elemt_plain(g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                       save: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
    """Plain version of ``bn_bwd_elemt``: dx in x's dtype from the reduced
    ``sums`` (the first 2C are read)."""
    c = x.shape[1]
    shape = (1, c, 1, 1)
    mean, rstd, live, n = save[:c], save[c:2 * c], save[2 * c:3 * c], save[3 * c]
    a = sums[:c] / n
    b = torch.where(live != 0, sums[c:2 * c] / n, torch.zeros_like(live))
    k = weight * rstd
    xhat = (x.float() - mean.view(shape)) * rstd.view(shape)
    dx = k.view(shape) * ((g.float() - a.view(shape)) - xhat * b.view(shape))
    return dx.to(x.dtype)


def bn_bwd_elemt_cuda(g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                      save: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
    """Launch ``bn_bwd_elemt`` (csrc/batch_norm.cu). Raises on anything the
    kernel does not take or when the launch fails; never falls back."""
    N, C, HW = _nchw("x", x)
    _like("g", g, x)
    _vec("weight", weight, C)
    _vec("save", save, 3 * C + 1)
    if sums.dtype != torch.float32 or sums.ndim != 1 or sums.numel() < 2 * C \
            or not sums.is_contiguous():
        raise ValueError(f"sums must be a contiguous float32 vector of >= {2 * C} values, got "
                         f"{sums.dtype} {tuple(sums.shape)}")
    _on_card(x, g=g, weight=weight, save=save, sums=sums)
    dx = torch.empty_like(x)
    _build.launch("bn_bwd_elemt", _kernels().depthvo_bn_bwd_elemt, g.data_ptr(),
                  x.data_ptr(), DTYPES[x.dtype], N, C, HW, chunks_of(C, HW, x.element_size()),
                  weight.data_ptr(), save.data_ptr(), sums.data_ptr(), dx.data_ptr(),
                  device=x.device, key=tuple(x.shape))
    return dx


def bn_bwd_elemt(g, x, weight, save, sums) -> torch.Tensor:
    """``bn_bwd_elemt`` on x's device: the plain version on the CPU, the
    kernel on CUDA."""
    fn = bn_bwd_elemt_plain if x.device.type == "cpu" else bn_bwd_elemt_cuda
    return fn(g, x, weight, save, sums)


# --------------------------------------------------------------------------
# The autograd boundary.
# --------------------------------------------------------------------------


class GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of (N, C, H, W) ``x`` with the statistics of
    the global batch over ``group``: forward ``bn_stats``, a SUM all-reduce
    of its buffer, ``bn_normalize``; backward ``bn_bwd_reduce``, a SUM
    all-reduce of its first 2C sums, ``bn_bwd_elemt``. Every rank's dx
    carries every rank's cotangent through the statistics, as the
    differentiable all-reduce of the composed formula did; dscale and dbias
    are this rank's, which the step's gradient all-reduce sums.

    ``apply(x, weight, bias, running_mean, running_var, group, momentum,
    eps, update)``: torch's ``momentum``; the running averages move in
    place towards the global batch's mean and biased variance when
    ``update`` (not in a remat recompute)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, group, momentum, eps,
                update):
        x = x.contiguous()
        stats = bn_stats(x)
        dist.all_reduce(stats, group=group)
        y, save = bn_normalize(x, stats, weight, bias, running_mean, running_var,
                               momentum, eps, update)
        ctx.save_for_backward(x, weight, save)
        ctx.group = group
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, save = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        c = x.shape[1]
        sums = bn_bwd_reduce(g, x, save)
        dist.all_reduce(sums[:2 * c], group=ctx.group)
        dx = bn_bwd_elemt(g, x, weight, save, sums) if ctx.needs_input_grad[0] else None
        return dx, sums[3 * c:], sums[2 * c:3 * c], None, None, None, None, None, None

