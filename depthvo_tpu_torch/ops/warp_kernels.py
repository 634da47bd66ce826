"""Warp kernels, their gradient boundaries and their coordinate/mask math
(counterpart of ``depthvo_tpu/ops/warp_pallas.py``).

Five kernels, each a hand-written CUDA kernel (``csrc/warp.cu``) with a
plain PyTorch version of the same function beside it:

* ``stereo_fwd`` (replaces ``_stereo_fwd_kernel``): the rectified-stereo
  warp, a horizontal-only bilinear resample of each source row, over up
  to :data:`MAX_SEGMENTS` segments (the pyramid's scales) in one launch.
* ``stereo_bwd_u`` (replaces ``_stereo_bwd_u_kernel``): its gradient with
  respect to the sample column u, d_u = sum_c g * (s1 - s0), over up to
  :data:`MAX_SEGMENTS` segments in one launch.
* ``stereo_bwd_src`` (replaces ``_stereo_bwd_src_kernel``): its gradient
  with respect to the source: each output's two taps, with the taps of
  outputs more than ``dmax + 1`` columns right of the source pixel
  dropped, as in the reference's shift sum.
* ``gen_fwd`` (replaces ``_gen_fwd_kernel``): the general warp of a
  frozen source, a 2-D bilinear sample, optionally with the gradient
  factors S = d out / d u and D = d out / d v; grouped like
  ``stereo_fwd``.
* ``gen_bwd_uv`` (replaces ``_gen_sample_chw_bwd``'s contraction of those
  factors): d_u = sum_c g * S, d_v = sum_c g * D, with the taps and the
  factors recomputed from the source.

Dispatch is on the tensor's device: a CPU tensor goes to the plain
version; a CUDA tensor goes to the kernel, or the call raises. Each
wrapper counts its launches in :data:`LAUNCHES` (``gen_fwd`` with the
gradient factors counts as ``gen_fwd_aux``); under CUDA-graph capture it
counts in :data:`CAPTURED` instead, and each replay of the graph adds
those to :data:`LAUNCHES`. The kernels launch on the current stream,
so a graph of the train step captures them.

Two ``torch.autograd.Function``s sit where the reference puts its custom
VJPs, so autograd on either device runs the same backward contract:
:class:`StereoSample` (``_stereo_sample_chw``: backward K2 and, when the
source needs a gradient, K3) and :class:`FrozenGenSample`
(``_gen_sample_chw``: backward ``gen_bwd_uv`` from the saved source, no
source gradient). They hold forwards already made by
:func:`stereo_sample_grouped` / :func:`frozen_gen_sample_grouped`, which
launch K1 or K4 once over all scales and hand back, per scale, a call
that returns that scale's output behind its gradient node. Autograd runs
a node after every node made later, so a caller that makes each call
where it builds that scale's loss gets each backward, and the release of
its cotangent, right after that scale's loss terms, as with one launch
per scale. :class:`FrozenGenSample` holds one scale. :class:`StereoSample`
holds the finest scale alone and the coarse scales together: their node,
made by the first of their calls, runs one K2 launch for all of them
after the last of their losses' backwards. A single scale is a group of
one.
Gradients go to the unclipped coordinates with no clip derivative, as in
the reference.

The masks follow the reference's kernel path: ``valid`` of the general
warp includes the TPU kernel's reach (``window_mask``: the 8-row tile
window of ``pad_v`` rows and |u - col| <= 127), so the port drops exactly
the pixels the reference drops on the TPU.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Callable, NamedTuple, Sequence

import torch

from depthvo_tpu_torch.geometry import warp as geo_warp
from depthvo_tpu_torch.geometry.warp import in_bounds
from depthvo_tpu_torch.ops import _build

TILE_ROWS = 8  # the reference kernel's row tile; it shapes window_mask
LANE = 128  # the reference kernel's lane block; |u - col| <= LANE - 1
GEN_PAD_V = 16  # default vertical half-window (rows, a multiple of 8)
# stereo_bwd_src stages 44 W bytes per row in shared memory (227 KB a block)
MAX_BWD_SRC_WIDTH = 5120
# The launch table of the forwards and of stereo_bwd_u; the library checks
# them against its own (csrc/warp.cu kMaxSegments, kFwdThreads, kPix) when
# it loads.
MAX_SEGMENTS = 8
FWD_THREADS = 128
FWD_PIX = 2
# A segment's pointers in that table, in csrc/warp.cu fill_table's order.
TABLE_FIELDS = ("src", "u", "v", "g", "out", "s_aux", "d_aux")

# Launches per (kernel name, src shape); only the CUDA wrappers count,
# where they launch.
LAUNCHES: collections.Counter = collections.Counter()
# What the wrappers were called for while their stream was capturing a
# CUDA graph: the capture runs no kernel. Whoever replays the graph adds
# the capture's counts to LAUNCHES at each replay.
CAPTURED: collections.Counter = collections.Counter()


def launch_count(name: str) -> int:
    """Launches of kernel ``name`` since the last :func:`reset_launches`."""
    return sum(n for (k, _), n in LAUNCHES.items() if k == name)


def reset_launches() -> None:
    LAUNCHES.clear()


def _count(key: tuple) -> None:
    (CAPTURED if torch.cuda.is_current_stream_capturing() else LAUNCHES)[key] += 1



@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    """The built ``warp.cu`` library with its C signatures declared."""
    lib = _build.load("warp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.depthvo_stereo_fwd.argtypes = [i, p, p, p]
    lib.depthvo_stereo_fwd.restype = i
    lib.depthvo_stereo_bwd_u.argtypes = [i, p, p, p]
    lib.depthvo_stereo_bwd_u.restype = i
    lib.depthvo_stereo_bwd_src.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.depthvo_stereo_bwd_src.restype = i
    lib.depthvo_gen_fwd.argtypes = [i, p, p, i, p]
    lib.depthvo_gen_fwd.restype = i
    lib.depthvo_gen_bwd_uv.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.depthvo_gen_bwd_uv.restype = i
    lib.depthvo_fwd_layout.argtypes = [p]
    lib.depthvo_fwd_layout.restype = None
    layout = (ctypes.c_int * 3)()
    lib.depthvo_fwd_layout(layout)
    if tuple(layout) != (MAX_SEGMENTS, FWD_THREADS, FWD_PIX):
        raise RuntimeError(f"warp.cu lays out the forwards as (segments, threads, pixels) = "
                           f"{tuple(layout)}; pack_segments assumes "
                           f"{(MAX_SEGMENTS, FWD_THREADS, FWD_PIX)}")
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


def _check_src(src: torch.Tensor, name: str = "src"):
    if src.ndim != 4:
        raise ValueError(f"{name} must be (B, C, H, W), got {tuple(src.shape)}")
    return src.shape


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def n_shifts(dmax: int | None, W: int) -> int:
    """Shifts of the scatter-free d_src: ``min(dmax + 2, W)`` (all W
    without a bound), the range of the reference kernel."""
    return W if dmax is None else min(dmax + 2, W)


# --------------------------------------------------------------------------
# The forwards' launch table: one launch over the segments of a pyramid.
# --------------------------------------------------------------------------


class SegmentPlan(NamedTuple):
    """Where one segment of a forward launch lies in its 1-D grid: its
    B*H*W pixels, :data:`FWD_PIX` per thread and :data:`FWD_THREADS`
    threads per block, take blocks ``[block_begin, block_end)``. Warp w of
    the segment takes its pixels ``[32 FWD_PIX w, 32 FWD_PIX (w + 1))``,
    pixel k of a lane the k-th run of 32 (``csrc/warp.cu``,
    ``segment_of``)."""

    B: int
    C: int
    H: int
    W: int
    block_begin: int
    block_end: int


def pack_segments(shapes: Sequence[tuple]) -> list[SegmentPlan]:
    """The launch table of ``stereo_fwd``/``gen_fwd``/``stereo_bwd_u`` for
    segments of (B, C, H, W) ``shapes``, in order."""
    if not 1 <= len(shapes) <= MAX_SEGMENTS:
        raise ValueError(f"a grouped launch takes 1 to {MAX_SEGMENTS} segments, "
                         f"got {len(shapes)}")
    plans, begin = [], 0
    for k, (B, C, H, W) in enumerate(shapes):
        if min(B, C, H, W) < 1:
            raise ValueError(f"segment {k} is empty: {(B, C, H, W)}")
        end = begin - (-(B * H * W) // (FWD_THREADS * FWD_PIX))
        plans.append(SegmentPlan(B, C, H, W, begin, end))
        begin = end
    if begin >= 2**31:
        raise ValueError(f"{begin} blocks; a launch takes < 2**31")
    return plans


def _check_segments(srcs, *maps, gs=None) -> list[SegmentPlan]:
    """Checks the segments of a grouped CUDA wrapper as :func:`_check_cuda`
    does, all on the first source's device, every shape before any
    device: the sources (B,C,H,W), the coordinate ``maps`` (B,H,W) and the
    cotangents ``gs`` (B,C,H,W), if any. Returns their launch table."""
    if any(len(m) != len(srcs) for m in maps):
        raise ValueError("every segment needs its source and its coordinate maps")
    if gs is not None and len(gs) != len(srcs):
        raise ValueError("every segment needs its source and its cotangent")
    plans = pack_segments([tuple(_check_src(s, f"src[{k}]")) for k, s in enumerate(srcs)])
    checks = []
    for k, (src, pl) in enumerate(zip(srcs, plans)):
        checks.append((f"src[{k}]", src, tuple(src.shape)))
        checks += [(f"{name}[{k}]", m[k], (pl.B, pl.H, pl.W)) for name, m in zip("uv", maps)]
        if gs is not None:
            checks.append((f"g[{k}]", gs[k], tuple(src.shape)))
    for name, t, shape in checks:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    for name, t, shape in checks:
        _check_cuda(name, t, shape, srcs[0].device)
    return plans


def _launch_table(name: str, fn, plans, *flags, **fields) -> None:
    """One grouped launch: packs the segments' tensors (``fields``, one
    list per name of :data:`TABLE_FIELDS` the kernel reads or writes) and
    plans into the host arrays ``csrc/warp.cu``'s ``fill_table`` reads,
    and counts it in :data:`LAUNCHES` under the sources' shapes."""
    srcs = fields["src"]
    none = [None] * len(plans)
    ptrs = [None if t is None else t.data_ptr()
            for row in zip(*(fields.get(f, none) for f in TABLE_FIELDS)) for t in row]
    ints = [x for pl in plans for x in (pl.B, pl.C, pl.H, pl.W, pl.block_end)]
    _launch(name, fn, len(plans), (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_int * len(ints))(*ints), *flags, _stream(srcs[0].device))
    _count((name, tuple(tuple(s.shape) for s in srcs)))


# --------------------------------------------------------------------------
# K1: stereo forward.
# --------------------------------------------------------------------------


def _stereo_taps(u: torch.Tensor, W: int, dtype: torch.dtype):
    """Clipped u -> (u0, x1 = min(u0+1, W-1), au), as the kernels compute
    them."""
    u = u.to(dtype).clamp(0.0, W - 1)
    u0f = torch.floor(u)
    x0 = u0f.long().clamp(0, W - 1)
    return x0, (x0 + 1).clamp(max=W - 1), u - u0f


def stereo_sample_plain(src: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain version of ``stereo_fwd``: src (B,C,H,W), u (B,H,W) ->
    (1-au) src[..,u0] + au src[..,min(u0+1,W-1)] with u clipped to
    [0, W-1]. Works on any device and floating dtype."""
    B, C, H, W = src.shape
    x0, x1, au = _stereo_taps(u, W, src.dtype)
    s0 = torch.gather(src, 3, x0[:, None].expand(B, C, H, W))
    s1 = torch.gather(src, 3, x1[:, None].expand(B, C, H, W))
    au = au[:, None]
    return (1.0 - au) * s0 + au * s1


def stereo_sample_pyramid_cuda(srcs: Sequence[torch.Tensor],
                               us: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Launch ``stereo_fwd`` (csrc/warp.cu) once over the segments
    (srcs[k], us[k]), up to :data:`MAX_SEGMENTS`. Raises on anything the
    kernel does not take or when the launch fails; never falls back."""
    plans = _check_segments(srcs, us)
    outs = [torch.empty_like(s) for s in srcs]
    _launch_table("stereo_fwd", _kernels().depthvo_stereo_fwd, plans, src=srcs, u=us, out=outs)
    return outs


def stereo_sample_cuda(src: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``stereo_fwd`` on one segment."""
    return stereo_sample_pyramid_cuda([src], [u])[0]


def stereo_sample_pyramid(srcs: Sequence[torch.Tensor],
                          us: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """K1 over a pyramid on the tensors' device: the plain version per
    segment on the CPU, one kernel launch on CUDA."""
    if srcs[0].device.type == "cpu":
        return [stereo_sample_plain(s, u) for s, u in zip(srcs, us)]
    return stereo_sample_pyramid_cuda(srcs, us)


# --------------------------------------------------------------------------
# K2: stereo backward with respect to u.
# --------------------------------------------------------------------------


def stereo_bwd_u_plain(src: torch.Tensor, g: torch.Tensor,
                       u: torch.Tensor) -> torch.Tensor:
    """Plain version of ``stereo_bwd_u``: d_u[b,i,j] = sum_c g[b,c,i,j] *
    (s1 - s0) with the taps of ``stereo_fwd``, summed in channel order."""
    B, C, H, W = src.shape
    x0, x1, _ = _stereo_taps(u, W, src.dtype)
    s0 = torch.gather(src, 3, x0[:, None].expand(B, C, H, W))
    s1 = torch.gather(src, 3, x1[:, None].expand(B, C, H, W))
    prod = g * (s1 - s0)
    acc = torch.zeros_like(prod[:, 0])
    for c in range(C):
        acc = acc + prod[:, c]
    return acc


def stereo_bwd_u_grouped_cuda(srcs: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                              us: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Launch ``stereo_bwd_u`` (csrc/warp.cu) once over the segments
    (srcs[k], gs[k], us[k]), up to :data:`MAX_SEGMENTS`: d_u per segment.
    Raises on anything the kernel does not take or when the launch fails;
    never falls back."""
    plans = _check_segments(srcs, us, gs=gs)
    d_us = [torch.empty_like(u) for u in us]
    _launch_table("stereo_bwd_u", _kernels().depthvo_stereo_bwd_u, plans, src=srcs, u=us,
                  g=gs, out=d_us)
    return d_us


def stereo_bwd_u_cuda(src: torch.Tensor, g: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    """``stereo_bwd_u`` on one segment."""
    return stereo_bwd_u_grouped_cuda([src], [g], [u])[0]


def stereo_bwd_u_grouped(srcs: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                         us: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """K2 over segments on the tensors' device: the plain version per
    segment on the CPU, one kernel launch on CUDA."""
    if srcs[0].device.type == "cpu":
        return [stereo_bwd_u_plain(s, g, u) for s, g, u in zip(srcs, gs, us)]
    return stereo_bwd_u_grouped_cuda(srcs, gs, us)


def stereo_bwd_u(src: torch.Tensor, g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """K2 on one segment."""
    return stereo_bwd_u_grouped([src], [g], [u])[0]


# --------------------------------------------------------------------------
# K3: stereo backward with respect to the source.
# --------------------------------------------------------------------------


def stereo_bwd_src_plain(g: torch.Tensor, u: torch.Tensor,
                         dmax: int | None) -> torch.Tensor:
    """Plain version of ``stereo_bwd_src``, the reference's shift form:
    d_src[b,c,i,x] = sum_{s < n_shifts(dmax, W), x+s < W} g[b,c,i,x+s] * w_s
    with w_s = (1-au) where u0[x+s] == x and au where u0[x+s] == x-1.
    Taps of outputs more than ``dmax + 1`` columns right of x drop, as in
    the reference; the sum runs over s ascending."""
    B, C, H, W = g.shape
    x0, _, au = _stereo_taps(u, W, g.dtype)
    cols = torch.arange(W, device=g.device)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    acc = torch.zeros_like(g)
    for s in range(n_shifts(dmax, W)):
        x = cols[: W - s]
        u0_s, au_s = x0[..., s:], au[..., s:]
        w = (torch.where(u0_s == x, 1.0 - au_s, zero)
             + torch.where(u0_s == x - 1, au_s, zero))
        acc[..., : W - s] = acc[..., : W - s] + g[..., s:] * w[:, None]
    return acc


def stereo_bwd_src_cuda(g: torch.Tensor, u: torch.Tensor,
                        dmax: int | None) -> torch.Tensor:
    """Launch ``stereo_bwd_src`` (csrc/warp.cu); raises, never falls back."""
    B, C, H, W = _check_src(g, "g")
    _check_cuda("g", g, (B, C, H, W), g.device)
    _check_cuda("u", u, (B, H, W), g.device)
    if W > MAX_BWD_SRC_WIDTH:
        raise ValueError(f"stereo_bwd_src takes W <= {MAX_BWD_SRC_WIDTH}, got {W}")
    d_src = torch.empty_like(g)
    _launch("stereo_bwd_src", _kernels().depthvo_stereo_bwd_src,
            g.data_ptr(), u.data_ptr(), d_src.data_ptr(), B, C, H, W,
            n_shifts(dmax, W), _stream(g.device))
    _count(("stereo_bwd_src", (B, C, H, W)))
    return d_src


def stereo_bwd_src(g: torch.Tensor, u: torch.Tensor, dmax: int | None) -> torch.Tensor:
    """K3 on the tensor's device: plain version on the CPU, kernel on CUDA."""
    if g.device.type == "cpu":
        return stereo_bwd_src_plain(g, u, dmax)
    return stereo_bwd_src_cuda(g, u, dmax)


def _shared_once(items, make, first: int = 0) -> list[Callable[[], torch.Tensor]]:
    """Per item k (scale ``first + k``), a call, to be made once, that
    returns item k's output from one node for all the items: the first
    call makes it, ``make(items) -> outputs``, and lets go of the items;
    each other output is held only until its own call takes it."""
    items, held = list(items), [None] * len(items)

    def take(k):
        if items:
            held[:] = make(items)
            items.clear()
        out, held[k] = held[k], None
        if out is None:
            raise RuntimeError(f"the grouped sample's scale {first + k} was taken already")
        return out

    return [functools.partial(take, k) for k in range(len(held))]


def _taken_once(items, make) -> list[Callable[[], torch.Tensor]]:
    """Per item k, a call that returns ``make(*items[k])`` and lets go of
    the item: once a scale's output is taken, what it held (the output
    itself, its source and coordinates) lives only as long as the caller's
    graph needs it, as with one launch per scale (:func:`_shared_once`
    with a node of its own per item)."""
    return [_shared_once([item], lambda one: [make(*one[0])], k)[0]
            for k, item in enumerate(items)]


class StereoSample(torch.autograd.Function):
    """``_stereo_sample_chw``'s custom VJP for n scales whose forwards are
    already made, as one node: ``apply(dmaxs, *srcs, *us, *outs)`` with
    outs[k] = K1(srcs[k], us[k]) returns the outs; srcs[k] (B,C,H,W),
    us[k] (B,H,W), ``dmaxs[k]`` bounds K3. The backward runs one K2 launch
    over the scales whose output got a cotangent and whose u needs a
    gradient and, for each such scale whose source needs a gradient, K3.
    Made by :func:`stereo_sample_grouped`."""

    @staticmethod
    def forward(ctx, dmaxs, *tensors):
        n = len(dmaxs)
        ctx.dmaxs = dmaxs
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*tensors[:2 * n])
        return tensors[2 * n:]

    @staticmethod
    def backward(ctx, *gs):
        n = len(ctx.dmaxs)
        srcs, us = ctx.saved_tensors[:n], ctx.saved_tensors[n:]
        need_src, need_u = ctx.needs_input_grad[1:n + 1], ctx.needs_input_grad[n + 1:2 * n + 1]
        gs = [None if g is None else g.contiguous() for g in gs]
        d_srcs = [stereo_bwd_src(g, u, dmax) if g is not None and need else None
                  for g, u, dmax, need in zip(gs, us, ctx.dmaxs, need_src)]
        d_us = [None] * n
        ks = [k for k in range(n) if gs[k] is not None and need_u[k]]
        if ks:
            d_ks = stereo_bwd_u_grouped([srcs[k] for k in ks], [gs[k] for k in ks],
                                        [us[k] for k in ks])
            for k, d_u in zip(ks, d_ks):
                d_us[k] = d_u
        return (None, *d_srcs, *d_us, *[None] * n)


def stereo_sample_grouped(srcs: Sequence[torch.Tensor], us: Sequence[torch.Tensor],
                          dmaxs: Sequence) -> list[Callable[[], torch.Tensor]]:
    """K1 of each scale k (``srcs[k]``, ``us[k]``; ``dmaxs[k]`` bounds K3)
    in one grouped forward launch, made now. Item k of the result is a
    call, to be made once, that returns scale k's output behind a
    :class:`StereoSample`: the last (finest) scale's own, or one shared by
    all earlier (coarse) scales, made by the first of their calls."""
    with torch.no_grad():
        outs = stereo_sample_pyramid(srcs, us)
    items = list(zip(srcs, us, dmaxs, outs))

    def make(scales):
        s, u, dmax, out = zip(*scales)
        return StereoSample.apply(dmax, *s, *u, *out)

    return _shared_once(items[:-1], make) + _shared_once(items[-1:], make, len(items) - 1)


# --------------------------------------------------------------------------
# K4: general frozen-source forward (optionally with gradient factors) and
# K5, its backward with respect to (u, v).
# --------------------------------------------------------------------------


def _gen_taps(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """The four bilinear taps of src (B,C,H,W) at (clip(u,0,W-1),
    clip(v,0,H-1)), gathered on the flattened H*W, and the weights:
    (s00, s01, s10, s11, au, av), au and av (B,1,H,W)."""
    B, C, H, W = src.shape
    u = u.to(src.dtype).clamp(0.0, W - 1)
    v = v.to(src.dtype).clamp(0.0, H - 1)
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

    return tap(y0, x0), tap(y0, x1), tap(y1, x0), tap(y1, x1), au, av


def gen_sample_plain(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     emit_grad_aux: bool = False):
    """Plain version of ``gen_fwd``: 2-D bilinear sample of src (B,C,H,W)
    at (clip(u,0,W-1), clip(v,0,H-1)) with four ``torch.gather`` taps on
    the flattened H*W. With ``emit_grad_aux`` also returns
    S = (1-av)(s01-s00) + av(s11-s10) and D = h1 - h0."""
    s00, s01, s10, s11, au, av = _gen_taps(src, u, v)
    h0 = (1.0 - au) * s00 + au * s01
    h1 = (1.0 - au) * s10 + au * s11
    out = (1.0 - av) * h0 + av * h1
    if not emit_grad_aux:
        return out
    s_aux = (1.0 - av) * (s01 - s00) + av * (s11 - s10)
    return out, s_aux, h1 - h0


def gen_sample_pyramid_cuda(srcs: Sequence[torch.Tensor], us: Sequence[torch.Tensor],
                            vs: Sequence[torch.Tensor], emit_grad_aux: bool = False) -> list:
    """Launch ``gen_fwd`` (csrc/warp.cu) once over the segments (srcs[k],
    us[k], vs[k]), up to :data:`MAX_SEGMENTS`: a list of the warped
    sources, or of (out, S, D) with ``emit_grad_aux``. Raises on anything
    the kernel does not take or when the launch fails; never falls back."""
    plans = _check_segments(srcs, us, vs)
    outs = [torch.empty_like(s) for s in srcs]
    if emit_grad_aux:
        s_auxs = [torch.empty_like(s) for s in srcs]
        d_auxs = [torch.empty_like(s) for s in srcs]
    else:
        s_auxs = d_auxs = [None] * len(srcs)
    _launch_table("gen_fwd_aux" if emit_grad_aux else "gen_fwd", _kernels().depthvo_gen_fwd,
                  plans, int(emit_grad_aux), src=srcs, u=us, v=vs, out=outs, s_aux=s_auxs,
                  d_aux=d_auxs)
    return list(zip(outs, s_auxs, d_auxs)) if emit_grad_aux else outs


def gen_sample_cuda(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    emit_grad_aux: bool = False):
    """``gen_fwd`` on one segment."""
    return gen_sample_pyramid_cuda([src], [u], [v], emit_grad_aux)[0]


def gen_sample_pyramid(srcs: Sequence[torch.Tensor], us: Sequence[torch.Tensor],
                       vs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """K4 (without the factors) over a pyramid on the tensors' device: the
    plain version per segment on the CPU, one kernel launch on CUDA."""
    if srcs[0].device.type == "cpu":
        return [gen_sample_plain(s, u, v) for s, u, v in zip(srcs, us, vs)]
    return gen_sample_pyramid_cuda(srcs, us, vs)


def gen_bwd_uv_plain(src: torch.Tensor, g: torch.Tensor, u: torch.Tensor,
                     v: torch.Tensor):
    """Plain version of ``gen_bwd_uv``: (d_u, d_v) with d_u[b,i,j] =
    sum_c g[b,c,i,j] * S and d_v = sum_c g * D, S and D the factors of
    ``gen_sample_plain(..., emit_grad_aux=True)``, summed in channel
    order."""
    s00, s01, s10, s11, au, av = _gen_taps(src, u, v)
    s_aux = (1.0 - av) * (s01 - s00) + av * (s11 - s10)
    d_aux = ((1.0 - au) * s10 + au * s11) - ((1.0 - au) * s00 + au * s01)
    prod_u, prod_v = g * s_aux, g * d_aux
    d_u = torch.zeros_like(prod_u[:, 0])
    d_v = torch.zeros_like(prod_v[:, 0])
    for c in range(src.shape[1]):
        d_u = d_u + prod_u[:, c]
        d_v = d_v + prod_v[:, c]
    return d_u, d_v


def gen_bwd_uv_cuda(src: torch.Tensor, g: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor):
    """Launch ``gen_bwd_uv`` (csrc/warp.cu); raises, never falls back."""
    B, C, H, W = _check_src(src)
    _check_cuda("src", src, (B, C, H, W), src.device)
    _check_cuda("g", g, (B, C, H, W), src.device)
    _check_cuda("u", u, (B, H, W), src.device)
    _check_cuda("v", v, (B, H, W), src.device)
    d_u = torch.empty_like(u)
    d_v = torch.empty_like(v)
    _launch("gen_bwd_uv", _kernels().depthvo_gen_bwd_uv,
            src.data_ptr(), g.data_ptr(), u.data_ptr(), v.data_ptr(),
            d_u.data_ptr(), d_v.data_ptr(), B, C, H, W, _stream(src.device))
    _count(("gen_bwd_uv", (B, C, H, W)))
    return d_u, d_v


def gen_bwd_uv(src: torch.Tensor, g: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """K5 on the tensor's device: plain version on the CPU, kernel on CUDA."""
    if src.device.type == "cpu":
        return gen_bwd_uv_plain(src, g, u, v)
    return gen_bwd_uv_cuda(src, g, u, v)


class FrozenGenSample(torch.autograd.Function):
    """``_gen_sample_chw``'s custom VJP for one scale whose forward is
    already made: ``apply(src, u, v, out)`` with out = K4(src, u, v)
    returns ``out``; src is frozen (it gets no gradient). When u or v
    needs a gradient it saves (src, u, v), and the backward recomputes the
    taps in ``gen_bwd_uv``: d_u = sum_c g * S, d_v = sum_c g * D. The
    reference's forward emits S and D instead; the gradient is the same.
    Made by :func:`frozen_gen_sample_grouped`."""

    @staticmethod
    def forward(ctx, src, u, v, out):
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            ctx.save_for_backward(src, u, v)
        return out

    @staticmethod
    def backward(ctx, g):
        src, u, v = ctx.saved_tensors
        d_u, d_v = gen_bwd_uv(src, g.contiguous(), u, v)
        return (None, d_u if ctx.needs_input_grad[1] else None,
                d_v if ctx.needs_input_grad[2] else None, None)


def frozen_gen_sample_grouped(srcs: Sequence[torch.Tensor], us: Sequence[torch.Tensor],
                              vs: Sequence[torch.Tensor]) -> list[Callable[[], torch.Tensor]]:
    """K4 of each scale k (frozen ``srcs[k]`` at ``us[k]``, ``vs[k]``) in
    one grouped forward launch, made now. Item k of the result is a call,
    to be made once, that returns scale k's output behind its own
    :class:`FrozenGenSample`."""
    with torch.no_grad():
        outs = gen_sample_pyramid(srcs, us, vs)
    return _taken_once(zip(srcs, us, vs, outs), FrozenGenSample.apply)


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


def stereo_warp_prep(hw, depth: torch.Tensor, fx_baseline, dmax):
    """Sample columns and validity of the stereo warp at (H, W) ``hw``:
    (u contiguous, valid)."""
    H, W = hw
    if depth.ndim == 4:
        depth = depth[..., 0]
    disparity, u = stereo_disparity_u(depth, fx_baseline, W)
    return u.contiguous(), stereo_valid_mask(depth, disparity, u, H, W, dmax)
