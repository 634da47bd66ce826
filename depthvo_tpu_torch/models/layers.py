"""Building blocks of the three networks (counterpart of
``depthvo_tpu/models/layers.py``).

Submodules carry flax's auto-names (``Conv_0``, ``BatchNorm_0``,
``ConvBlock_k``, ``Bottleneck_j``), so a parameter's path in the port's
state dict is its path in the JAX tree with ``/`` read as ``.``
(``io/from_jax.py`` relies on that).

Tensors are NCHW inside the networks. Three places where PyTorch and
flax differ, each pinned by a parity test (tests/test_torch_models.py):

* ``padding="SAME"`` in flax pads ``(total // 2, total - total // 2)``,
  which is asymmetric on stride 2; torch's ``padding=`` is symmetric.
  :func:`same_pads` computes flax's pads from the input size and the
  layers apply them with ``F.pad`` where they are asymmetric.
* BatchNorm (:class:`BatchNorm`): eps 1e-5; train mode uses flax's
  momentum 0.95 (torch 0.05) and folds the biased batch variance into
  the running variance, where torch's own folds the unbiased one. Over a
  data-parallel mesh (:func:`global_statistics`) its statistics are the
  global batch's, as flax's are under a sharded jit.
* ``resize_bilinear(_chw)`` is ``jax.image.resize(method="linear")``,
  which antialiases when it shrinks: ``F.interpolate(...,
  antialias=True)``. ``upsample2x`` is nearest-neighbour.

``quant_mode`` ("off", "calibrate", "int8") threads through
``ConvBlock``, ``Bottleneck``, ``ResNetStage`` and ``UpConv`` as in the
reference: anything but "off" makes each block's ``Conv_0`` a
:class:`QuantConv`, which has the same parameters under the same name.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from depthvo_tpu_torch.ops import int8_conv
from depthvo_tpu_torch.ops.batch_norm import GlobalBatchNorm

QUANT_MODES = ("off", "calibrate", "int8")
_RECOMPUTE = threading.local()  # .on: inside the recompute of a remat region


def same_pads(size: int, kernel: int, stride: int, dilation: int = 1):
    """flax/XLA ``SAME`` padding of one spatial dim: (low, high)."""
    eff = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with flax ``padding="SAME"`` semantics."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 dilation: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=0,
                         dilation=dilation, bias=bias)

    def pads(self, x: torch.Tensor):
        """flax's ``SAME`` pads of ``x`` as ``F.pad`` takes them: (left,
        right, top, bottom)."""
        k, s, d = self.kernel_size[0], self.stride[0], self.dilation[0]
        ph = same_pads(x.shape[-2], k, s, d)
        pw = same_pads(x.shape[-1], k, s, d)
        return pw[0], pw[1], ph[0], ph[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        left, right, top, bottom = self.pads(x)
        s, d = self.stride[0], self.dilation[0]
        if left == right and top == bottom:
            return F.conv2d(x, self.weight, self.bias, s, (top, left), d)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, s, 0, d)


class QuantConv(Conv):
    """int8 x int8 -> int32 convolution for w8a8 serving (the reference's
    ``layers.QuantConv``).

    The parameters are :class:`Conv`'s (``weight`` OIHW, optional
    ``bias``), so state dicts load unchanged in every mode. The buffers
    are not part of the state dict:

    * ``a_max``: the running max of ``|x|`` that ``mode="calibrate"``
      records while it runs the convolution in the compute dtype;
    * ``a_scale``, ``w_q``, ``y_scale``: made by :meth:`quantize` once per
      calibration (the reference folds them into its serving program):
      ``a_scale = a_max / 127`` (NaN where ``a_max`` is 0, so an
      uncalibrated layer fails loudly), the symmetric per-output-channel
      int8 weights ``w_q = clip(round(W / w_scale), -127, 127)`` with
      ``w_scale = max(max|W|, 1e-12) / 127``, and ``y_scale = a_scale *
      w_scale``. They are computed on the CPU and then moved, so every
      device has the same bits (a CUDA division by a Python number
      multiplies by its reciprocal, which can differ in the last bit).

    ``mode="int8"``: ``x_q = clip(round(x / a_scale), -127, 127)`` (round
    half to even in both stacks), the int32 convolution of
    :mod:`ops.int8_conv`, then ``y * y_scale`` cast to the compute dtype
    and the bias. Every cast is explicit: the compute dtype is autocast's
    where autocast is on, else float32.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 dilation: int = 1, bias: bool = True, mode: str = "calibrate"):
        super().__init__(in_ch, out_ch, kernel, stride, dilation, bias)
        if mode not in ("calibrate", "int8"):
            raise ValueError(f"QuantConv mode must be calibrate|int8, got {mode!r}")
        self.mode = mode
        self.register_buffer("a_max", torch.zeros(()), persistent=False)
        self.register_buffer("a_scale", torch.zeros(()), persistent=False)
        self.register_buffer("w_q", torch.zeros(0, dtype=torch.int8), persistent=False)
        self.register_buffer("y_scale", torch.zeros(0), persistent=False)

    @torch.no_grad()
    def quantize(self) -> None:
        """``a_scale``, ``w_q`` (as :func:`int8_conv.weight_matrix`'s (O, Kp)
        matrix) and ``y_scale`` from the current ``a_max`` and weights."""
        dev = self.weight.device
        a_max = self.a_max.cpu()
        a_scale = a_max.masked_fill(~(a_max > 0), float("nan")) / 127.0
        w = self.weight.detach().float().cpu()
        w_scale = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12) / 127.0
        w_q = torch.round(w / w_scale[:, None, None, None]).clamp(-127, 127)
        self.a_scale = a_scale.to(dev)
        self.w_q = int8_conv.weight_matrix(w_q.to(torch.int8)).to(dev)
        self.y_scale = (a_scale * w_scale).to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "calibrate":
            with torch.no_grad():
                self.a_max.copy_(torch.maximum(self.a_max, x.detach().abs().amax().float()))
            return super().forward(x)
        if self.w_q.numel() == 0:
            raise RuntimeError("QuantConv: call quantize() before the int8 forward")
        dev = x.device.type
        dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else torch.float32
        # No op below is on autocast's lists (the GEMM is _int_mm, the rest
        # elementwise), so autocast leaves every dtype as cast here; an
        # autocast-off region per conv would only split an exported graph.
        x_q = torch.round(x.float() / self.a_scale).clamp(-127, 127).to(torch.int8)
        y = int8_conv.int8_conv2d(x_q, self.w_q, self.kernel_size[0], self.stride[0],
                                  self.dilation[0], self.pads(x))
        y = (y.float() * self.y_scale[:, None, None]).to(dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype)[:, None, None]
        return y


def max_pool_same(x: torch.Tensor, kernel: int = 3, stride: int = 2):
    """``nn.max_pool(x, (k, k), (s, s), padding="SAME")``: pads with -inf."""
    ph = same_pads(x.shape[-2], kernel, stride)
    pw = same_pads(x.shape[-1], kernel, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.95, epsilon=1e-5)``.

    Eval mode normalises with the running averages. Train mode normalises
    with the batch mean and the biased batch variance and moves the
    running averages by 5% towards them (flax momentum 0.95 is torch
    momentum 0.05). torch folds the UNBIASED variance n/(n-1) var into
    ``running_var``; flax folds the biased one, so the update is redone
    here from the previous running variance. The statistics are float32
    whatever the activations' dtype (cuDNN computes them so under bf16
    autocast, and the buffers are float32).

    With ``group`` set (:func:`global_statistics`, a data-parallel train
    step) train mode takes the statistics of the GLOBAL batch, as flax's
    BatchNorm does under a jit whose batch is sharded: per channel the
    float32 sum, sum of squares and count go through one differentiable
    all-reduce, mean = S/n and var = max(Q/n - mean^2, 0) (flax's
    ``use_fast_variance``), and ``y = (x - mean) * (rsqrt(var + eps) *
    scale) + bias`` in float32, as flax writes it.
    """

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.05)
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            return self._global_forward(x)
        if getattr(_RECOMPUTE, "on", False):
            # The backward's recompute of a remat region (:func:`remat`):
            # the same op on the batch's statistics, but the running
            # averages were moved by the forward, so it moves copies.
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(),
                                self.weight, self.bias, True, self.momentum, self.eps)
        # torch's op moves a copy (autograd keeps it, so it is not
        # touched again): var_u = k prev + m var n/(n-1), k = 1 - m. Then
        # r var_u + (1 - r) k prev = k prev + m var with r = (n-1)/n.
        var_u = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var_u, self.weight, self.bias,
                         True, self.momentum, self.eps)
        r = 1.0 - 1.0 / (x.numel() // x.shape[1])
        with torch.no_grad():
            self.running_var.mul_((1.0 - r) * (1.0 - self.momentum)).add_(var_u, alpha=r)
        return y

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        # A remat recompute runs the reduction again, in the same order on
        # every rank, and moves nothing.
        return GlobalBatchNorm.apply(x, self.weight, self.bias, self.running_mean,
                                     self.running_var, self.group, self.momentum, self.eps,
                                     not getattr(_RECOMPUTE, "on", False))

    def eval_ieee(self, x: torch.Tensor) -> torch.Tensor:
        """Eval mode as flax writes it, ``(x - mean) * (scale / sqrt(var +
        eps)) + bias``, in separate correctly rounded float32 ops, so every
        device gives the same bits (cuDNN's and the CPU's fused kernels
        differ in the last bit). The int8 forward uses it: a last-bit
        difference flips an activation's int8 code where it sits on a
        rounding edge, and the flips compound over the encoder."""
        shape = (1, -1, 1, 1)
        mul = self.weight / torch.sqrt(self.running_var + self.eps)
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class ConvBlock(nn.Module):
    """Conv -> (BN) -> activation, the basic unit of every tower. The conv
    has a bias only without BN, as in the reference."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, use_bn: bool = True, act: bool = True,
                 dilation: int = 1, quant_mode: str = "off"):
        super().__init__()
        if quant_mode not in QUANT_MODES:
            raise ValueError(f"quant_mode must be one of {QUANT_MODES}, got {quant_mode!r}")
        if quant_mode == "off":
            self.Conv_0 = Conv(in_ch, features, kernel, stride, dilation, bias=not use_bn)
        else:
            self.Conv_0 = QuantConv(in_ch, features, kernel, stride, dilation,
                                    bias=not use_bn, mode=quant_mode)
        self.BatchNorm_0 = BatchNorm(features) if use_bn else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        if self.BatchNorm_0 is not None:
            if getattr(self.Conv_0, "mode", None) == "int8" and not self.training:
                x = self.BatchNorm_0.eval_ieee(x)
            else:
                x = self.BatchNorm_0(x)
        return F.relu(x) if self.act else x


class Bottleneck(nn.Module):
    """ResNet bottleneck block (1x1 -> 3x3 -> 1x1, x4 expansion)."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1, quant_mode: str = "off"):
        super().__init__()
        out_ch = 4 * planes
        q = quant_mode
        self.ConvBlock_0 = ConvBlock(in_ch, planes, 1, 1, quant_mode=q)
        self.ConvBlock_1 = ConvBlock(planes, planes, 3, stride, quant_mode=q)
        self.ConvBlock_2 = ConvBlock(planes, out_ch, 1, 1, act=False, quant_mode=q)
        self.ConvBlock_3 = (
            ConvBlock(in_ch, out_ch, 1, stride, act=False, quant_mode=q)
            if in_ch != out_ch or stride != 1 else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ConvBlock_2(self.ConvBlock_1(self.ConvBlock_0(x)))
        residual = x if self.ConvBlock_3 is None else self.ConvBlock_3(x)
        return F.relu(y + residual)


class ResNetStage(nn.Module):
    """A stack of bottleneck blocks; the first block may downsample."""

    def __init__(self, in_ch: int, planes: int, num_blocks: int, stride: int,
                 quant_mode: str = "off"):
        super().__init__()
        for i in range(num_blocks):
            self.add_module(
                f"Bottleneck_{i}",
                Bottleneck(in_ch if i == 0 else 4 * planes, planes,
                           stride if i == 0 else 1, quant_mode),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x


@contextlib.contextmanager
def _recomputing():
    prev = getattr(_RECOMPUTE, "on", False)
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = prev


def remat(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module(x)`` keeping none of its inner activations for the
    backward, which runs the module again to get them (flax ``nn.remat``).

    The recompute sees the forward's autocast state and no random state
    (the networks draw none), and its BatchNorm layers write no running
    average: flax discards the recompute's statistics too, so remat
    changes no value, only what is held between forward and backward."""
    return torch.utils.checkpoint.checkpoint(
        module, x, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputing()))


@contextlib.contextmanager
def global_statistics(nets, group):
    """Inside the block, every :class:`BatchNorm` of ``nets`` (modules, or
    None) takes its train-mode statistics over ``group``'s global batch
    (``group`` None: each its own batch, the default). Keep the block open
    through the backward: a remat region's recompute runs the reduction
    again, every rank in the same order."""
    norms = [m for net in nets if net is not None for m in net.modules()
             if isinstance(m, BatchNorm)]
    for m in norms:
        m.group = group
    try:
        yield
    finally:
        for m in norms:
            m.group = None


def depth_to_space2(x: torch.Tensor) -> torch.Tensor:
    """(B, H/2, W/2, 4C) -> (B, H, W, C), input channel (2a + b) * C + c
    going to row offset a and column offset b (the reference's
    ``layers.depth_to_space2``; for C = 1 this is ``F.pixel_shuffle``'s
    order)."""
    b, h2, w2, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, h2, w2, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h2, 2 * w2, c)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling of (B, C, H, W)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def resize_bilinear_chw(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, (b, c, h, w), "linear")`` on (B, C, H, W):
    half-pixel centers, antialiased when shrinking."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                         antialias=True)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``resize_bilinear_chw`` for (B, H, W, C) tensors."""
    return resize_bilinear_chw(x.permute(0, 3, 1, 2), h, w).permute(0, 2, 3, 1)


class UpConv(nn.Module):
    """Nearest 2x upsample, then a 3x3 conv + ReLU (the decoder unit)."""

    def __init__(self, in_ch: int, features: int, quant_mode: str = "off"):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(in_ch, features, 3, 1, use_bn=False,
                                     quant_mode=quant_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvBlock_0(upsample2x(x))
