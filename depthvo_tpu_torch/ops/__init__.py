"""Hot-path warp ops and their dispatch (counterpart of
``depthvo_tpu/ops/__init__.py``).

* ``stereo_warp_pyramid_chw`` - rectified-stereo warp of each scale of
  a loss pyramid through one ``stereo_fwd`` launch, differentiated by
  ``stereo_bwd_u``, one launch for the finest scale and one for the
  coarse scales together (and per scale by ``stereo_bwd_src`` when the
  source needs a gradient).
* ``frozen_warp_pyramid_chw`` - general warp of each scale's constant
  source through one ``gen_fwd`` launch, differentiated per scale with
  respect to the sample coordinates by ``gen_bwd_uv``, which recomputes
  the taps from the saved source, with the reference's adaptive vertical
  window.
* ``stereo_warp_chw`` / ``frozen_warp_chw`` - the same on one scale.
* ``stereo_warp`` / ``frozen_warp`` - the reference's (B, H, W, C)
  surface, transposed into the CHW functions; ``stereo_warp`` keeps the
  source differentiable (on the card its backward launches
  ``stereo_bwd_src`` too).
* ``border_warp_chw`` - Monodepth2's warp: a frozen source sampled
  anywhere at normalised coordinates with border padding (``gen_fwd_border``),
  differentiated with respect to the coordinates (``gen_bwd_uv_border``).
* ``fused_warp`` - the general warp with a differentiated source: the
  plain ``geometry.warp.inverse_warp`` on both devices, as in the
  reference, whose TPU kernels do not cover this case.

Dispatch is on the tensor's device (``warp_kernels``): CPU tensors take
the plain PyTorch versions, CUDA tensors the kernels, never both.

:data:`KERNELS` names every CUDA kernel of the port: the tables of
``warp_kernels``, ``batch_norm``, ``md2_batch_norm`` and ``reproj``
merged, each launch key (what ``_build.LAUNCHES`` counts) mapped to the
device kernels one launch runs. The profiler's report and ``chip_smoke.py`` read it.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

from depthvo_tpu_torch.geometry import warp as geo_warp
from depthvo_tpu_torch.ops import batch_norm, md2_batch_norm, reproj, warp_kernels

KERNELS = {**warp_kernels.KERNELS, **batch_norm.KERNELS, **md2_batch_norm.KERNELS,
           **reproj.KERNELS}


def symbols(table: Mapping[str, Sequence[str]]) -> list:
    """The ``__global__`` functions a kernel table names, each once, in
    order: its trace names without their template arguments."""
    return list(dict.fromkeys(n.partition("<")[0] for names in table.values() for n in names))


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


def _frozen_warp_prep(hw, depth, T, K, pad_v: int | None):
    """Coordinates and validity of the general warp at (H, W) ``hw``:
    (u, v, valid), ``valid`` with the window of :func:`kernel_pad_v` or,
    where none fits, the plain warp's."""
    H, W = hw
    pad = kernel_pad_v(H, pad_v)
    if pad is not None:
        return warp_kernels._gen_warp_prep(depth, T, K, H, W, pad)
    coords, front = geo_warp.warp_coords(depth, T, K)
    u = coords[..., 0].contiguous()
    v = coords[..., 1].contiguous()
    return u, v, geo_warp.in_bounds(u, v, H, W) & front


class Scales(list):
    """Per scale, a call, to be made once, that makes its warped output's
    gradient node and returns (warped, valid); ``valids`` holds every
    scale's valid mask before any call (a data-parallel step reduces their
    counts in one all-reduce)."""

    def __init__(self, calls, valids):
        super().__init__(calls)
        self.valids = list(valids)


def _per_scale(makers, valids) -> Scales:
    valids = list(valids)
    return Scales(warp_kernels._taken_once(zip(makers, valids),
                                           lambda make, valid: (make(), valid)), valids)


def stereo_warp_pyramid_chw(srcs: Sequence, depths: Sequence, fx_baselines: Sequence,
                            dmaxs: Sequence) -> list[Callable[[], tuple]]:
    """Rectified-stereo inverse warp of each scale k: the (B,C,H,W)
    ``srcs[k]`` sampled at u = col - fx*b/depth (``fx_baselines[k]``,
    ``depths[k]``), all scales in one ``stereo_fwd`` launch, made now
    (:func:`warp_kernels.stereo_sample_grouped`). ``dmaxs[k]`` is the
    static disparity bound in pixels (derive it with
    ``configs.base.stereo_dmax``; ``None`` drops the bound).

    Returns, per scale, a call that returns (warped, valid (B,H,W)). Make
    each call once, where that scale's loss is built: the finest scale's
    gradient node then runs right after that loss's backward, and frees
    its cotangent there; the coarse scales' shared node, made by the first
    of their calls, runs once after all their losses' backwards. Each
    warped output lives only as long as the loss needs it.
    """
    prep = [warp_kernels.stereo_warp_prep(s.shape[2:], d, f, m)
            for s, d, f, m in zip(srcs, depths, fx_baselines, dmaxs)]
    makers = warp_kernels.stereo_sample_grouped(
        [s.float().contiguous() for s in srcs], [u for u, _ in prep], dmaxs)
    return _per_scale(makers, [valid for _, valid in prep])


def frozen_warp_pyramid_chw(srcs: Sequence, depths: Sequence, T, Ks: Sequence,
                            pad_v: int | None = None) -> list[Callable[[], tuple]]:
    """General inverse warp of each scale k's NON-differentiated (B,C,H,W)
    ``srcs[k]`` (``depths[k]``, the shared pose ``T``, ``Ks[k]``), all
    scales in one ``gen_fwd`` launch, made now
    (:func:`warp_kernels.frozen_gen_sample_grouped`).

    Returns, per scale, a call that returns (warped (B,C,H,W) float32,
    valid (B,H,W)), to be made as in :func:`stereo_warp_pyramid_chw`.
    Gradients reach depth, T and K through (u, v), none reaches the
    source. ``valid`` carries the window of :func:`kernel_pad_v` at each
    scale's own height. Where no window fits, ``valid`` is the plain
    warp's, as in the reference, and the sample still runs on the same
    kernel (it reads any row) behind the same gradient boundary.
    """
    prep = [_frozen_warp_prep(s.shape[2:], d, T, K, pad_v)
            for s, d, K in zip(srcs, depths, Ks)]
    makers = warp_kernels.frozen_gen_sample_grouped(
        [s.detach().float().contiguous() for s in srcs],
        [u for u, _, _ in prep], [v for _, v, _ in prep])
    return _per_scale(makers, [valid for _, _, valid in prep])


def border_warp_chw(src_chw, gx, gy):
    """``F.grid_sample(src_chw, stack([gx, gy], -1), padding_mode="border",
    align_corners=True)`` of a frozen (B, C, H, W) source at the (B, H, W)
    normalised coordinates, differentiable with respect to them."""
    return warp_kernels.BorderSample.apply(src_chw, gx, gy)


def stereo_warp_chw(src_chw, depth, fx_baseline, dmax: int = 128):
    """:func:`stereo_warp_pyramid_chw` on one scale: (warped, valid)."""
    return stereo_warp_pyramid_chw([src_chw], [depth], [fx_baseline], [dmax])[0]()


def frozen_warp_chw(src_chw, depth, T, K, pad_v: int | None = None):
    """:func:`frozen_warp_pyramid_chw` on one scale: (warped, valid)."""
    return frozen_warp_pyramid_chw([src_chw], [depth], T, [K], pad_v)[0]()


STEREO_DMAX = 128  # the reference kernel's default disparity bound (pixels)


def _dispatch(x, use_pallas: bool | None, what: str) -> None:
    """``use_pallas`` (the reference's name) asks for the CUDA kernels
    (True) or their plain versions (False); None takes what the tensor's
    device runs. The kernels run on CUDA tensors and the plain versions on
    CPU tensors, never the other way round, so a request the tensor's
    device cannot serve raises."""
    on_cuda = x.device.type == "cuda"
    if use_pallas is None or bool(use_pallas) == on_cuda:
        return
    if use_pallas:
        raise ValueError(f"{what}(use_pallas=True) runs the CUDA kernels; the tensor is on "
                         f"{x.device} (pass use_pallas=None for the plain versions there)")
    raise ValueError(f"{what}(use_pallas=False) runs the plain versions, which take CPU "
                     f"tensors; this one is on {x.device} (move it with .cpu(), or pass "
                     "use_pallas=None for the kernels)")


def stereo_warp(src, depth, fx_baseline, use_pallas: bool | None = None,
                dmax: int | None = None):
    """Rectified-stereo inverse warp of a (B, H, W, C) ``src`` (sample at
    x - fx*b/depth): :func:`stereo_warp_chw` on its transpose.

    ``depth`` (B, H, W) or (B, H, W, 1); ``fx_baseline`` a scalar or (B,).
    ``dmax`` is the static disparity bound in pixels; ``None`` takes the
    reference kernel's default (:data:`STEREO_DMAX`), on both devices, as
    the reference's kernel path does. ``src`` stays differentiable.
    Returns (warped (B, H, W, C) float32, valid (B, H, W))."""
    _dispatch(src, use_pallas, "stereo_warp")
    warped, valid = stereo_warp_chw(src.permute(0, 3, 1, 2), depth, fx_baseline,
                                    STEREO_DMAX if dmax is None else dmax)
    return warped.permute(0, 2, 3, 1), valid


def frozen_warp(src, depth, T, K, use_pallas: bool | None = None, pad_v: int | None = None):
    """General inverse warp of a NON-differentiated (B, H, W, C) ``src``:
    :func:`frozen_warp_chw` on its transpose, with the reference's
    adaptive vertical window (:func:`kernel_pad_v`). Gradients reach
    depth, T and K; none reaches ``src``. Returns (warped (B, H, W, C)
    float32, valid (B, H, W))."""
    _dispatch(src, use_pallas, "frozen_warp")
    warped, valid = frozen_warp_chw(src.permute(0, 3, 1, 2), depth, T, K, pad_v)
    return warped.permute(0, 2, 3, 1), valid


def fused_warp(src, depth, T, K, use_pallas: bool | None = None):
    """General inverse warp with a differentiated (B, H, W, C) source:
    ``geometry.warp.inverse_warp`` on either device. ``use_pallas`` is
    accepted for API stability, as in the reference; no kernel covers
    this case."""
    del use_pallas
    return geo_warp.inverse_warp(src, depth, T, K)
