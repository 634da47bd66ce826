"""Hot-path warp ops and their dispatch (counterpart of
``depthvo_tpu/ops/__init__.py``).

* ``stereo_warp_chw`` - rectified-stereo warp through the ``stereo_fwd``
  kernel (every scale of the stereo loss).
* ``frozen_warp_chw`` - general warp of a constant source through the
  ``gen_fwd`` kernel (temporal and frozen-feature losses), with the
  reference's adaptive vertical window.

Dispatch is on the tensor's device (``warp_kernels``): CPU tensors take
the plain PyTorch versions, CUDA tensors the kernels, never both.
"""

from __future__ import annotations

from depthvo_tpu_torch.geometry import warp as geo_warp
from depthvo_tpu_torch.ops import warp_kernels
from depthvo_tpu_torch.ops.warp_kernels import stereo_warp_chw  # noqa: F401


def kernel_pad_v(H: int, pad_v: int | None = None) -> int | None:
    """The vertical half-window of the general warp's mask at height ``H``.

    ``pad_v`` (default ``GEN_PAD_V``) halves at coarse scales until the
    reference kernel's window (2 * pad_v + 8 rows) fits the padded height.
    ``None`` where even 8 rows do not fit: there the reference leaves its
    kernel for the plain inverse warp, whose ``valid`` has no window term.
    """
    Hp = -(-H // 8) * 8
    if pad_v is None:
        pad_v = warp_kernels.GEN_PAD_V
    if pad_v % 8:
        raise ValueError(f"pad_v must be a multiple of 8, got {pad_v}")
    while pad_v > 8 and Hp < 2 * pad_v + 8:
        pad_v = max(8, (pad_v // 2 + 7) // 8 * 8)
    return pad_v if Hp >= 2 * pad_v + 8 else None


def frozen_warp_chw(src_chw, depth, T, K, pad_v: int | None = None):
    """General inverse warp of a NON-differentiated (B,C,H,W) source.

    Returns (warped (B,C,H,W), valid (B,H,W)); ``valid`` carries the
    window of :func:`kernel_pad_v`. Where no window fits, ``valid`` is the
    plain warp's, as in the reference, and the sample still runs on the
    same kernel (it reads any row).
    """
    H, W = src_chw.shape[2:]
    pad_v = kernel_pad_v(H, pad_v)
    if pad_v is not None:
        return warp_kernels.general_warp_frozen_src_chw(
            src_chw, depth, T, K, pad_v=pad_v
        )
    coords, front = geo_warp.warp_coords(depth, T, K)
    u = coords[..., 0].contiguous()
    v = coords[..., 1].contiguous()
    warped = warp_kernels.gen_sample(src_chw.detach().float().contiguous(), u, v)
    return warped, geo_warp.in_bounds(u, v, H, W) & front
