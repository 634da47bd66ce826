"""The int8 x int8 -> int32 convolution of w8a8 serving (``QuantConv``).

The reference computes it with XLA's ``lax.conv_general_dilated(...,
preferred_element_type=int32)``, not in Pallas, so it is a library call
here too: an int8 im2col, then ``torch._int_mm``, which is cuBLASLt's
int8 tensor-core GEMM on the GPU and an integer GEMM on the CPU. The
same code runs on both devices:

1. the int8 codes are padded with flax's ``SAME`` pads (``F.pad``);
2. the patches are strided views of the padded tensor in NHWC order,
   copied into an int8 ``(rows, Kp)`` matrix, ``K = C * kh * kw`` in
   OIHW's order and zero-padded to a multiple of 8 (cuBLASLt's rule;
   zeros change no int32 sum). The copy runs over chunks of the batch,
   so the matrix stays under ``IM2COL_BUDGET_BYTES`` (one chunk when the
   batch is symbolic, under ``torch.export``);
3. ``torch._int_mm(patches, w_mat.t())`` accumulates in int32. cuBLASLt
   wants more than 16 rows: where one image has 16 output pixels or
   fewer, 17 zero rows are appended (and dropped after).

No shape falls back to another path: a shape ``_int_mm`` refuses is an
error. :func:`int8_conv2d_plain` is the plain version, ``F.conv2d`` in
float64 on the codes, exact because ``|sum| <= 127**2 * K < 2**53``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# The largest im2col matrix one chunk of the batch may take.
IM2COL_BUDGET_BYTES = 64 << 20
K_ALIGN = 8
MIN_ROWS = 17  # cuBLASLt's int8 GEMM takes more than 16 rows

# Calls of _int_mm made by int8_conv2d (one per chunk), for checks that
# a sweep went through the int8 path.
CALLS = 0


def reset_calls() -> None:
    global CALLS
    CALLS = 0


def _exporting() -> bool:
    is_exporting = getattr(torch.compiler, "is_exporting", None)
    return bool(is_exporting and is_exporting()) or torch.compiler.is_compiling()


def weight_matrix(w_q: torch.Tensor) -> torch.Tensor:
    """(O, C, kh, kw) int8 codes -> the (O, Kp) int8 matrix, K = C*kh*kw
    zero-padded to a multiple of ``K_ALIGN``."""
    o = w_q.shape[0]
    k = w_q[0].numel()
    kp = -(-k // K_ALIGN) * K_ALIGN
    return F.pad(w_q.reshape(o, k), (0, kp - k)).contiguous()


def int8_conv2d(x_q: torch.Tensor, w_mat: torch.Tensor, kernel: int, stride: int,
                dilation: int, pads: Tuple[int, int, int, int]) -> torch.Tensor:
    """int32 convolution of (B, C, H, W) int8 codes with :func:`weight_matrix`'s
    (O, Kp) matrix of a (O, C, kernel, kernel) kernel.

    ``pads`` is ``(left, right, top, bottom)``. Returns (B, O, Ho, Wo) int32
    (NHWC in memory)."""
    global CALLS
    if x_q.dtype != torch.int8 or w_mat.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {x_q.dtype} and {w_mat.dtype}")
    b, c = x_q.shape[:2]
    o, kp = w_mat.shape
    k = c * kernel * kernel
    if kp != -(-k // K_ALIGN) * K_ALIGN:
        raise ValueError(f"weight matrix {tuple(w_mat.shape)} does not fit {c} channels "
                         f"and a {kernel}x{kernel} kernel")
    eff = (kernel - 1) * dilation + 1
    xh = F.pad(x_q, pads).permute(0, 2, 3, 1)  # (B, Hp, Wp, C)
    patches = xh.unfold(1, eff, stride).unfold(2, eff, stride)  # (B, Ho, Wo, C, eff, eff)
    if dilation > 1:
        patches = patches[..., ::dilation, ::dilation]
    ho, wo = patches.shape[1:3]
    pix = ho * wo
    extra = MIN_ROWS if pix < MIN_ROWS else 0
    w_t = w_mat.t()
    if _exporting():  # the batch is symbolic: one chunk
        parts = [patches]
    else:
        chunk = max(1, IM2COL_BUDGET_BYTES // max(1, pix * kp))
        parts = [patches[b0:b0 + chunk] for b0 in range(0, b, chunk)]
    outs = []
    for part in parts:
        nb = part.shape[0]
        mat = torch.empty((nb * pix + extra, kp), dtype=torch.int8, device=x_q.device)
        if kp != k or extra:
            mat.zero_()
        mat[:nb * pix].view(nb, ho, wo, kp)[..., :k].unflatten(
            -1, (c, kernel, kernel)).copy_(part)
        y = torch._int_mm(mat, w_t)
        CALLS += 1
        outs.append(y[:nb * pix] if extra else y)
    y = outs[0] if len(outs) == 1 else torch.cat(outs)
    return y.view(b, ho, wo, o).permute(0, 3, 1, 2)


def int8_conv2d_plain(x_q: torch.Tensor, w_q: torch.Tensor, stride: int, dilation: int,
                      pads: Tuple[int, int, int, int]) -> torch.Tensor:
    """The plain version: ``F.conv2d`` in float64 on the int8 codes,
    rounded to int32 (exact: every partial sum is an integer below 2**53)."""
    y = F.conv2d(F.pad(x_q.double(), pads), w_q.double(), None, stride, 0, dilation)
    return y.round().to(torch.int32)
