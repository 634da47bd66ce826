"""The port's warp ops held against the JAX package's Pallas kernels.

The Pallas kernels run in interpret mode (``warp_pallas.INTERPRET``, as
in tests/test_warp_pallas_interpret.py); the port runs on the CPU, where
each of its CUDA kernels is replaced by its plain PyTorch version. Same
numpy inputs on both sides.

Both sides sample at the same (u, v): the general-warp tests hand the
port the JAX ``warp_coords`` (the two agree to 2e-5 px, which
tests/test_torch_geometry.py holds; here the point is the sampler and
its masks). Tolerances: ``valid`` must be identical; warped values, and
the gradient factors S = d out / d u and D = d out / d v, agree to 1e-6
absolute wherever ``valid`` holds (float32 bilinear taps of unit-scale
sources; outside ``valid`` both sides are unspecified by contract).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthvo_tpu import ops as jops
from depthvo_tpu.geometry import camera as jcam, se3 as jse3, warp as jwarp
from depthvo_tpu.ops import warp_pallas
from chip_smoke import adversarial_stereo_u
from depthvo_tpu_torch import ops as tops
from depthvo_tpu_torch.geometry import warp as twarp
from depthvo_tpu_torch.ops import warp_kernels

torch.set_num_threads(2)
torch.exp(torch.zeros(1))  # MKL's first call on one thread (test_torch_models.py)

FXB = 74.0 * 0.54


@pytest.fixture(autouse=True)
def interpret_mode():
    warp_pallas.INTERPRET = True
    yield
    warp_pallas.INTERPRET = False


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _assert_match(got, valid, ref, ref_valid, atol=1e-6):
    ref_valid = np.asarray(ref_valid)
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    assert ref_valid.mean() > 0.3, "too few valid pixels to compare"
    mask = np.broadcast_to(ref_valid[:, None], got.shape)
    diff = np.abs(got.numpy() - np.asarray(ref))[mask]
    assert diff.max() <= atol, diff.max()


def test_masks_identical_on_the_same_coordinates(rng):
    """in_bounds, window_mask and the stereo mask on identical (u, v),
    including samples on integer boundaries, off the image and beyond
    the window in both directions."""
    B, H, W, pad_v = 2, 40, 300, 8
    rows = np.arange(H, dtype=np.float32)[None, :, None]
    cols = np.arange(W, dtype=np.float32)[None, None, :]
    u = cols + rng.uniform(-140, 140, (B, H, W)).astype(np.float32)
    v = rows + rng.uniform(-14, 14, (B, H, W)).astype(np.float32)
    u[:, ::3] = np.round(u[:, ::3])
    v[:, :, ::4] = np.round(v[:, :, ::4])
    ref_win = np.asarray(warp_pallas.window_mask(u, v, H, W, pad_v))
    win = warp_kernels.window_mask(_t(u), _t(v), H, W, pad_v).numpy()
    np.testing.assert_array_equal(win, ref_win)
    assert 0.1 < ref_win.mean() < 0.9
    _, ref_ib = jwarp.bilinear_sample(jnp.zeros((B, H, W, 1)), np.stack([u, v], -1))
    np.testing.assert_array_equal(
        warp_kernels.in_bounds(_t(u), _t(v), H, W).numpy(), np.asarray(ref_ib)
    )
    depth = rng.uniform(0.5, 40.0, (B, H, W)).astype(np.float32)
    depth[0, 0, :10] = -1.0
    disp, u_s = warp_pallas.stereo_disparity_u(depth, FXB, W)
    tdisp, tu_s = warp_kernels.stereo_disparity_u(_t(depth), FXB, W)
    np.testing.assert_array_equal(tu_s.numpy(), np.asarray(u_s))
    for dmax in (16, None):
        np.testing.assert_array_equal(
            warp_kernels.stereo_valid_mask(_t(depth), tdisp, tu_s, H, W, dmax).numpy(),
            np.asarray(warp_pallas.stereo_valid_mask(depth, disp, u_s, H, W, dmax)),
        )


@pytest.mark.parametrize("W,dmax", [(128, 24), (150, 128)])
def test_stereo_warp_matches_pallas(rng, W, dmax):
    B, C, H = 1, 3, 16
    src = rng.normal(size=(B, C, H, W)).astype(np.float32)
    depth = rng.uniform(1.5, 40.0, (B, H, W)).astype(np.float32)
    ref, ref_valid = jops.stereo_warp_chw(src, depth, FXB, use_pallas=True, dmax=dmax)
    got, valid = tops.stereo_warp_chw(_t(src), _t(depth), FXB, dmax=dmax)
    _assert_match(got, valid, ref, ref_valid)
    if dmax == 24:  # the disparity bound really bites
        assert not np.asarray(ref_valid)[:, :-1, 30:-1].all()


def _scene(rng, C, H, W, twist):
    src = rng.normal(size=(1, C, H, W)).astype(np.float32)
    depth = rng.uniform(4.0, 40.0, (1, H, W)).astype(np.float32)
    K = np.asarray(jcam.intrinsics_matrix(0.58 * W, 1.0 * H, W / 2, H / 2))[None]
    T = np.asarray(jse3.exp(np.asarray([twist], np.float32)))
    return src, depth, T, K


SMALL = [0.02, -0.01, -0.3, 0.002, -0.003, 0.001]
PITCH = [0.0, 0.0, -0.2, 0.3, 0.0, 0.0]  # ~10 px vertical flow: beyond pad_v=8


@pytest.mark.parametrize(
    "C,H,W,pad_v,twist",
    [
        (3, 24, 128, 8, SMALL),  # coarse-scale temporal warp
        (19, 24, 128, 8, SMALL),  # fused RGB + feature payload
        (3, 20, 150, 16, SMALL),  # pad_v halves to 8; ragged H and W
        (3, 16, 128, 16, SMALL),  # window cannot fit: no window term
        (3, 32, 128, 8, PITCH),  # the window mask drops pixels
    ],
)
def test_frozen_warp_matches_pallas(rng, monkeypatch, C, H, W, pad_v, twist):
    src, depth, T, K = _scene(rng, C, H, W, twist)
    coords, front = jwarp.warp_coords(depth, T, K)
    monkeypatch.setattr(
        twarp, "warp_coords",
        lambda *_: (_t(coords), torch.from_numpy(np.array(front))),
    )
    ref, ref_valid = jops.frozen_warp_chw(src, depth, T, K, use_pallas=True, pad_v=pad_v)
    got, valid = tops.frozen_warp_chw(_t(src), _t(depth), _t(T), _t(K), pad_v=pad_v)
    _assert_match(got, valid, ref, ref_valid)
    if twist is PITCH:
        _, plain_valid = jwarp.inverse_warp(np.zeros((1, H, W, 1), np.float32), depth, T, K)
        dropped = np.asarray(plain_valid) & ~np.asarray(ref_valid)
        assert dropped.sum() > 0, "the window mask should drop pixels here"


def test_general_sample_grad_factors_match_pallas(rng, monkeypatch):
    """K4 with ``emit_grad_aux``: the port's plain out/S/D against the
    Pallas kernel's, on the same (u, v)."""
    C, H, W, pad_v = 3, 24, 128, 8
    src, depth, T, K = _scene(rng, C, H, W, SMALL)
    coords, front = jwarp.warp_coords(depth, T, K)
    monkeypatch.setattr(
        twarp, "warp_coords",
        lambda *_: (_t(coords), torch.from_numpy(np.array(front))),
    )
    u, v, ref_valid = warp_pallas._gen_warp_prep(depth, T, K, H, W, pad_v)
    ref = warp_pallas._gen_sample_chw_impl(src, u, v, pad_v, emit_grad_aux=True)
    ref = [np.asarray(r)[:, :, :H, :W] for r in ref]
    tu, tv, valid = warp_kernels._gen_warp_prep(None, None, None, H, W, pad_v)
    got = warp_kernels.gen_sample_plain(_t(src), tu, tv, emit_grad_aux=True)
    for g, r in zip(got, ref):
        _assert_match(g, valid, r, ref_valid)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers check their inputs before building or launching
    anything, and never fall back to the plain versions: CPU tensors,
    more than MAX_SEGMENTS segments, a segment without its maps, and a
    launch that reports an error all raise."""
    src = torch.zeros(1, 3, 8, 16)
    u = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        warp_kernels.stereo_sample_cuda(src, u)
    with pytest.raises(ValueError, match="CUDA tensor"):
        warp_kernels.gen_sample_cuda(src, u, u)
    with pytest.raises(ValueError, match="CUDA tensor"):
        warp_kernels.stereo_sample_pyramid_cuda([src, src], [u, u])
    with pytest.raises(ValueError, match="CUDA tensor"):
        warp_kernels.gen_sample_pyramid_cuda([src, src], [u, u], [u, u])
    n = warp_kernels.MAX_SEGMENTS + 1
    with pytest.raises(ValueError, match="1 to 8 segments"):
        warp_kernels.stereo_sample_pyramid_cuda([src] * n, [u] * n)
    with pytest.raises(ValueError, match="1 to 8 segments"):
        warp_kernels.gen_sample_pyramid_cuda([src] * n, [u] * n, [u] * n)
    with pytest.raises(ValueError, match="its coordinate maps"):
        warp_kernels.gen_sample_pyramid_cuda([src, src], [u, u], [u])
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        warp_kernels._launch("stereo_fwd", lambda *args: 1)
    assert warp_kernels.launch_count("stereo_fwd") == 0
    assert warp_kernels.launch_count("gen_fwd") == 0


class _FakeEntry:
    """A C entry of a fake kernel library: returns 0, and ``fill`` (if
    any) writes its first argument."""

    def __init__(self, fill=None):
        self.fill = fill

    def __call__(self, *args):
        if self.fill:
            self.fill(args[0])
        return 0


@pytest.mark.parametrize("pix", [warp_kernels.FWD_PIX, warp_kernels.FWD_PIX + 1])
def test_kernel_library_must_lay_out_the_forwards_as_pack_segments_does(monkeypatch, pix):
    """The library reports its forward layout when it loads; one that
    differs from pack_segments' (which would leave pixels unwritten) is
    refused before any launch."""
    layout = (warp_kernels.MAX_SEGMENTS, warp_kernels.FWD_THREADS, pix)

    class Lib:
        depthvo_fwd_layout = _FakeEntry(lambda out: out.__setitem__(slice(0, 3), layout))

        def __getattr__(self, name):
            setattr(self, name, _FakeEntry())
            return getattr(self, name)

    monkeypatch.setattr(warp_kernels._build, "load", lambda stem: Lib())
    warp_kernels._kernels.cache_clear()
    try:
        if pix == warp_kernels.FWD_PIX:
            assert isinstance(warp_kernels._kernels(), Lib)
        else:
            with pytest.raises(RuntimeError, match="pack_segments assumes"):
                warp_kernels._kernels()
    finally:
        warp_kernels._kernels.cache_clear()


# --------------------------------------------------------------------------
# The grouped forwards' launch table: every pixel of every segment is
# stored by exactly one thread of the one launch.
# --------------------------------------------------------------------------


def _thread_pixels(plans):
    """(segment, q) of pixel k of every thread of a grouped launch over
    ``plans``, as ``csrc/warp.cu``'s ``segment_of`` and ``pixel_at``
    compute them: the segment by the blocks' ends; then pixel k of a
    thread is q0 + 32 k in the segment's run of B*H*W pixels, q0 = 32
    FWD_PIX (warp) + lane. q may lie past the run: such a pixel is
    computed and not stored."""
    T, P, n = warp_kernels.FWD_THREADS, warp_kernels.FWD_PIX, len(plans)
    ends = [pl.block_end for pl in plans]
    blk = np.repeat(np.arange(ends[-1]), T)
    thread = np.tile(np.arange(T), ends[-1])
    s = sum(((k + 1 < n) & (blk >= ends[k])).astype(int)
            for k in range(min(n, warp_kernels.MAX_SEGMENTS - 1)))
    g = (blk - np.array([0] + ends[:-1])[s]) * T + thread
    lane = g % 32
    q0 = (g - lane) * P + lane
    return np.tile(s, P), np.concatenate([q0 + 32 * k for k in range(P)])


def _stored_pixels(plans):
    """Flat indices of the pixels stored by the threads of a grouped
    launch over ``plans`` (:func:`_thread_pixels`); pixels past a
    segment's run store nothing. Pixel q of segment s is ``first[s] + q``."""
    s, q = _thread_pixels(plans)
    pixels = np.array([pl.B * pl.H * pl.W for pl in plans])
    first = np.cumsum([0, *pixels])
    return (first[s] + q)[q < pixels[s]], first[-1]


@pytest.mark.parametrize("shapes", [
    # the full_feat loss pyramid, coarsest first: 76x20 .. 608x160, C=19 finest
    [(4, 3, 20, 76), (4, 3, 40, 152), (4, 3, 80, 304), (4, 19, 160, 608)],
    # H*W % 4 = 2 and 1 (a warp's run crosses images), a one-pixel-wide and
    # a one-pixel segment
    [(2, 3, 37, 150), (1, 19, 19, 75), (3, 2, 9, 1), (1, 1, 1, 1)],
    [(1, 3, 5, 7)] * 8,
])
def test_pack_segments_covers_every_pixel_once(shapes):
    plans = warp_kernels.pack_segments(shapes)
    assert [pl.block_begin for pl in plans] == [0] + [pl.block_end for pl in plans[:-1]]
    for pl, shape in zip(plans, shapes):
        assert (pl.B, pl.C, pl.H, pl.W) == shape and pl.block_end > pl.block_begin
    stored, total = _stored_pixels(plans)
    assert total == sum(B * H * W for B, _, H, W in shapes)
    np.testing.assert_array_equal(np.bincount(stored, minlength=total), np.ones(total, int))


def test_pack_segments_refuses_what_one_launch_cannot_take():
    with pytest.raises(ValueError, match="1 to 8 segments"):
        warp_kernels.pack_segments([(1, 3, 4, 4)] * (warp_kernels.MAX_SEGMENTS + 1))
    with pytest.raises(ValueError, match="1 to 8 segments"):
        warp_kernels.pack_segments([])
    with pytest.raises(ValueError, match="empty"):
        warp_kernels.pack_segments([(1, 3, 4, 4), (0, 3, 4, 4)])


# --------------------------------------------------------------------------
# The gradient boundaries. Tolerance: 1e-5 absolute between the port's
# autograd.Functions and jax.vjp of the reference's custom VJPs (Pallas in
# interpret mode) on the same inputs; the cotangent is zero outside
# `valid`, as the loss makes it (outside `valid` both sides are
# unspecified). gradcheck runs the plain routes at float64.
# --------------------------------------------------------------------------


def _masked_cotangent(rng, shape, valid):
    g = rng.normal(size=shape).astype(np.float32)
    return g * np.asarray(valid)[:, None]


@pytest.mark.parametrize("W,dmax", [(128, 24), (150, 64)])
def test_stereo_function_grads_match_pallas_vjp(rng, W, dmax):
    import jax

    B, C, H = 2, 3, 16
    src = rng.normal(size=(B, C, H, W)).astype(np.float32)
    depth = rng.uniform(1.5, 40.0, (B, H, W)).astype(np.float32)
    disp, u = warp_pallas.stereo_disparity_u(depth, FXB, W)
    valid = warp_pallas.stereo_valid_mask(depth, disp, u, H, W, dmax)
    assert np.asarray(valid).mean() > 0.3
    g = _masked_cotangent(rng, src.shape, valid)
    ref_out, vjp = jax.vjp(lambda s, uu: warp_pallas._stereo_sample_chw(s, uu, dmax), src, u)
    ref_dsrc, ref_du = vjp(g)

    tsrc = _t(src).requires_grad_(True)
    tu = _t(u).requires_grad_(True)
    out = warp_kernels.stereo_sample_grouped([tsrc], [tu], [dmax])[0]()
    out.backward(_t(g))
    _assert_match(out.detach(), torch.from_numpy(np.array(valid)), ref_out, valid)
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(ref_du), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tsrc.grad.numpy(), np.asarray(ref_dsrc), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(ref_dsrc)).max() > 0.1 and np.abs(np.asarray(ref_du)).max() > 0.1


@pytest.mark.parametrize(
    "C,H,W,pad_v,twist",
    [(3, 24, 128, 8, SMALL), (19, 24, 128, 8, SMALL), (3, 32, 128, 8, PITCH)],
)
def test_gen_function_grads_match_pallas_vjp(rng, C, H, W, pad_v, twist):
    import jax

    src, depth, T, K = _scene(rng, C, H, W, twist)
    u, v, valid = warp_pallas._gen_warp_prep(depth, T, K, H, W, pad_v)
    u, v = np.asarray(u), np.asarray(v)
    g = _masked_cotangent(rng, src.shape, valid)
    _, vjp = jax.vjp(lambda uu, vv: warp_pallas._gen_sample_chw(src, uu, vv, pad_v), u, v)
    ref_du, ref_dv = vjp(g)

    tu, tv = _t(u).requires_grad_(True), _t(v).requires_grad_(True)
    warp_kernels.frozen_gen_sample_grouped([_t(src)], [tu], [tv])[0]().backward(_t(g))
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(ref_du), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(ref_dv), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(ref_du)).max() > 0.1


def test_gen_function_grads_on_the_no_window_branch(rng):
    """Where no window fits (16 rows), the reference differentiates the
    plain bilinear sampler; the port's no-window branch runs the same
    Function, whose gradient must equal jax.vjp of that sampler."""
    import jax

    C, H, W = 3, 16, 128
    assert tops.kernel_pad_v(H, 16) is None
    src, depth, T, K = _scene(rng, C, H, W, SMALL)
    coords, front = jwarp.warp_coords(depth, T, K)
    coords = np.asarray(coords)
    src_hwc = np.ascontiguousarray(src.transpose(0, 2, 3, 1))
    (_, ib), vjp = jax.vjp(lambda c: jwarp.bilinear_sample(src_hwc, c), coords)
    valid = np.asarray(ib) & np.asarray(front)
    g = _masked_cotangent(rng, src.shape, valid)
    (ref_dc,) = vjp((g.transpose(0, 2, 3, 1), np.zeros(valid.shape, jax.dtypes.float0)))

    tu = _t(coords[..., 0]).requires_grad_(True)
    tv = _t(coords[..., 1]).requires_grad_(True)
    warp_kernels.frozen_gen_sample_grouped([_t(src)], [tu], [tv])[0]().backward(_t(g))
    ref_dc = np.asarray(ref_dc)
    np.testing.assert_allclose(tu.grad.numpy(), ref_dc[..., 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), ref_dc[..., 1], rtol=0, atol=1e-5)


def test_frozen_warp_on_the_no_window_branch_differentiates_depth_and_pose(rng):
    C, H, W = 3, 16, 128
    src, depth, T, K = _scene(rng, C, H, W, SMALL)
    tdepth = _t(depth).requires_grad_(True)
    ttwist = torch.tensor([SMALL], requires_grad=True)
    from depthvo_tpu_torch.geometry import se3 as tse3

    warped, valid = tops.frozen_warp_chw(_t(src), tdepth, tse3.exp(ttwist), _t(K))
    assert warped.grad_fn is not None
    (warped * valid[:, None]).sum().backward()
    assert tdepth.grad.abs().max() > 0 and ttwist.grad.abs().max() > 0


def _fractional(x, lo=0.2, hi=0.8):
    """Move x off the integer grid (the bilinear taps' kinks)."""
    return np.floor(x) + lo + (hi - lo) * (x - np.floor(x))


def test_stereo_function_gradcheck_float64(rng):
    """Disparities in (0, dmax]; column 0, where no positive disparity
    stays in the image, is left out of the checked output."""
    B, C, H, W, dmax = 1, 2, 3, 12, 6
    cols = np.arange(W, dtype=np.float64)[None, None, :]
    disp = rng.uniform(0.2, 1.0, (B, H, W)) * np.minimum(np.maximum(cols, 0.25), dmax - 1)
    src = torch.tensor(rng.normal(size=(B, C, H, W)), requires_grad=True)
    tu = torch.tensor(_fractional(cols - disp), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda s, uu: warp_kernels.stereo_sample_grouped([s], [uu], [dmax])[0]()[..., 1:],
        (src, tu),
    )


def test_gen_function_gradcheck_float64(rng):
    B, C, H, W = 1, 3, 5, 7
    src = torch.tensor(rng.normal(size=(B, C, H, W)))
    u = torch.tensor(_fractional(rng.uniform(0.0, W - 2.0, (B, H, W))), requires_grad=True)
    v = torch.tensor(_fractional(rng.uniform(0.0, H - 2.0, (B, H, W))), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda uu, vv: warp_kernels.frozen_gen_sample_grouped([src], [uu], [vv])[0](), (u, v)
    )


def _stereo_scatter(g, u, dmax):
    """d_src as the scatter of (1-au) g to u0 and au g to u0+1 (u clipped
    to [0, W-1]), keeping only taps with 0 <= j - x < dmax + 2."""
    B, C, H, W = g.shape
    uc = np.clip(u, 0, W - 1)
    u0 = np.floor(uc).astype(int)
    au = uc - u0
    ref = np.zeros_like(g)
    for b, i, j in np.ndindex(B, H, W):
        for x, w in ((u0[b, i, j], 1 - au[b, i, j]), (u0[b, i, j] + 1, au[b, i, j])):
            if x < W and 0 <= j - x < dmax + 2:
                ref[b, :, i, x] += w * g[b, :, i, j]
    return ref


def test_stereo_bwd_src_plain_equals_a_scatter_within_the_bound(rng):
    """The shift form of d_src is the scatter of (1-au) g to u0 and au g
    to u0+1, for outputs whose disparity is within [0, dmax]; farther
    taps drop, as in the reference. Also on the smoke's adversarial
    sample columns (negative and over-bound disparities, runs sharing one
    u0, integer u, u left of 0 and right of W - 1) with a dense
    cotangent."""
    B, C, H, W, dmax = 2, 3, 4, 40, 8
    u = np.arange(W, dtype=np.float32)[None, None, :] - rng.uniform(0, 14, (B, H, W))
    for u in (u.astype(np.float32), adversarial_stereo_u(rng, B, H, W, dmax)):
        g = rng.normal(size=(B, C, H, W)).astype(np.float32)
        got = warp_kernels.stereo_bwd_src_plain(_t(g), _t(u), dmax).numpy()
        np.testing.assert_allclose(got, _stereo_scatter(g, u, dmax), rtol=0, atol=1e-5)


def test_reference_stereo_bwd_src_differs_only_where_its_rolls_wrap(rng):
    """Outside ``valid`` the reference's d_src is not the shift sum: its
    rolls wrap at the padded row end, so at W = 128 (no padding) outputs
    near the row start that sample past the right edge send gradient to
    the last two columns. Everywhere else the port's plain version equals
    it. The loss's cotangent is zero there, so the train step never sees
    the difference."""
    import jax

    B, C, H, W, dmax = 1, 2, 8, 128, 24
    u = adversarial_stereo_u(rng, B, H, W, dmax)
    src = rng.normal(size=(B, C, H, W)).astype(np.float32)
    g = rng.normal(size=(B, C, H, W)).astype(np.float32)
    _, vjp = jax.vjp(lambda s: warp_pallas._stereo_sample_chw(s, u, dmax), src)
    ref = np.asarray(vjp(g)[0])
    got = warp_kernels.stereo_bwd_src_plain(_t(g), _t(u), dmax).numpy()
    cols = set(np.nonzero(np.abs(got - ref) > 1e-5)[3].tolist())
    assert W - 1 in cols and cols <= {W - 2, W - 1}
    np.testing.assert_allclose(got[..., : W - 2], ref[..., : W - 2], rtol=0, atol=1e-5)


@pytest.mark.parametrize("W,dmax", [(76, 9), (152, 80)])
def test_adversarial_stereo_u_has_what_it_claims(rng, W, dmax):
    """The smoke's stress input for stereo_bwd_src: every row has 16 or
    more outputs sharing one u0, and the set has negative and over-bound
    disparities, integer u and u on both sides of the image."""
    B, H = 2, 6
    u = adversarial_stereo_u(rng, B, H, W, dmax)
    assert u.dtype == np.float32 and u.shape == (B, H, W)
    u0 = np.floor(np.clip(u, 0, W - 1)).astype(int)
    for b, i in np.ndindex(B, H):
        assert np.bincount(u0[b, i]).max() >= 16
    disp = np.arange(W)[None, None, :] - u
    inside = (u >= 0) & (u <= W - 1)
    assert (disp[inside] < 0).any() and (disp[inside] > dmax + 1).any()
    assert (u == np.round(u)).mean() > 0.1 and (u < 0).any() and (u > W - 1).any()


def test_stereo_bwd_src_dense_taps_drop_beyond_the_shift_range():
    """With W <= dmax + 2 every tap of a nonnegative disparity counts; with
    a tight bound the far taps drop, and a negative disparity never
    counts."""
    g = torch.ones(1, 1, 1, 6)
    u = torch.tensor([[[0.0, 0.0, 0.0, 0.5, 5.0, 5.0]]])  # disparities 0 1 2 2.5 -1 0
    full = warp_kernels.stereo_bwd_src_plain(g, u, None)
    torch.testing.assert_close(full, torch.tensor([[[[3.5, 0.5, 0.0, 0.0, 0.0, 1.0]]]]))
    tight = warp_kernels.stereo_bwd_src_plain(g, u, 0)  # n_shifts 2: j - x in {0, 1}
    torch.testing.assert_close(tight, torch.tensor([[[[2.0, 0.0, 0.0, 0.0, 0.0, 1.0]]]]))


@pytest.mark.parametrize("C", [3, 19])
def test_gen_bwd_uv_plain_is_the_channel_order_contraction_of_the_factors(rng, C):
    """d_u = sum_c g * S and d_v = sum_c g * D over gen_sample_plain's
    factors, summed in channel order: bit for bit, on a dense cotangent
    and coordinates reaching past every edge (u and v are clipped)."""
    B, H, W = 2, 9, 13
    src = _t(rng.normal(size=(B, C, H, W)))
    g = _t(rng.normal(size=(B, C, H, W)))
    u = _t(rng.uniform(-3.0, W + 2.0, (B, H, W)))
    v = _t(rng.uniform(-3.0, H + 2.0, (B, H, W)))
    _, s_aux, d_aux = warp_kernels.gen_sample_plain(src, u, v, emit_grad_aux=True)
    ref_u, ref_v = torch.zeros(B, H, W), torch.zeros(B, H, W)
    for c in range(C):
        ref_u = ref_u + g[:, c] * s_aux[:, c]
        ref_v = ref_v + g[:, c] * d_aux[:, c]
    d_u, d_v = warp_kernels.gen_bwd_uv_plain(src, g, u, v)
    assert torch.equal(d_u, ref_u) and torch.equal(d_v, ref_v)
    assert d_u.abs().max() > 0.1 and d_v.abs().max() > 0.1


def test_frozen_gen_sample_saves_only_the_source(rng):
    """The general warp's Function keeps (src, u, v) for its backward: no
    (B,C,H,W) tensor but the source itself (the reference's forward
    emits the factors S and D instead; the port recomputes them)."""
    B, C, H, W = 1, 19, 8, 16
    src = _t(rng.normal(size=(B, C, H, W)))
    u = _t(rng.uniform(0, W - 1, (B, H, W))).requires_grad_(True)
    v = _t(rng.uniform(0, H - 1, (B, H, W))).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        out = warp_kernels.frozen_gen_sample_grouped([src], [u], [v])[0]()
    assert len(saved) == 3
    full = [t for t in saved if t.ndim == 4]
    assert len(full) == 1 and full[0].data_ptr() == src.data_ptr()
    out.sum().backward()
    assert u.grad.shape == (B, H, W) and v.grad.shape == (B, H, W)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        warp_kernels.frozen_gen_sample_grouped([src], [u.detach()], [v.detach()])[0]()
    assert len(saved) == 3, "nothing is saved when no coordinate needs a gradient"


@pytest.mark.parametrize("wrapper", ["stereo_bwd_u", "stereo_bwd_src", "gen_fwd_aux",
                                     "gen_bwd_uv", "stereo_fwd_pyramid", "gen_fwd_pyramid",
                                     "gen_fwd_aux_pyramid", "stereo_bwd_u_grouped"])
def test_new_cuda_wrappers_refuse_cpu_tensors(wrapper):
    src = torch.zeros(1, 3, 8, 16)
    u = torch.zeros(1, 8, 16)
    call = {
        "stereo_bwd_u": lambda: warp_kernels.stereo_bwd_u_cuda(src, src, u),
        "stereo_bwd_src": lambda: warp_kernels.stereo_bwd_src_cuda(src, u, 8),
        "gen_fwd_aux": lambda: warp_kernels.gen_sample_cuda(src, u, u, emit_grad_aux=True),
        "gen_bwd_uv": lambda: warp_kernels.gen_bwd_uv_cuda(src, src, u, u),
        "stereo_fwd_pyramid": lambda: warp_kernels.stereo_sample_pyramid_cuda([src] * 4, [u] * 4),
        "gen_fwd_pyramid": lambda: warp_kernels.gen_sample_pyramid_cuda([src] * 4, [u] * 4,
                                                                        [u] * 4),
        "gen_fwd_aux_pyramid": lambda: warp_kernels.gen_sample_pyramid_cuda(
            [src] * 2, [u] * 2, [u] * 2, emit_grad_aux=True),
        "stereo_bwd_u_grouped": lambda: warp_kernels.stereo_bwd_u_grouped_cuda(
            [src] * 3, [src] * 3, [u] * 3),
    }[wrapper]
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()
    assert sum(warp_kernels.LAUNCHES.values()) == 0


# --------------------------------------------------------------------------
# The grouped gradient boundaries: one forward over a pyramid of mixed
# channel counts against the reference's per-scale custom VJPs (Pallas in
# interpret mode). Tolerances as above: forward 1e-6 under `valid`, VJPs
# 1e-5 absolute on a cotangent that is zero outside `valid`.
# --------------------------------------------------------------------------

STEREO_PYRAMID = [(3, 8, 128, 24), (19, 16, 150, 64), (3, 16, 128, 24)]  # C, H, W, dmax
GEN_PYRAMID = [(3, 24, 128, 8, SMALL), (19, 24, 128, 8, SMALL), (3, 32, 128, 8, PITCH)]


def test_stereo_pyramid_function_matches_pallas_per_scale(rng):
    import jax

    B = 2
    srcs, us, gs, refs = [], [], [], []
    for C, H, W, dmax in STEREO_PYRAMID:
        src = rng.normal(size=(B, C, H, W)).astype(np.float32)
        depth = rng.uniform(1.5, 40.0, (B, H, W)).astype(np.float32)
        disp, u = warp_pallas.stereo_disparity_u(depth, FXB, W)
        valid = np.array(warp_pallas.stereo_valid_mask(depth, disp, u, H, W, dmax))
        g = _masked_cotangent(rng, src.shape, valid)
        out, vjp = jax.vjp(lambda s, uu, d=dmax: warp_pallas._stereo_sample_chw(s, uu, d), src, u)
        refs.append((out, valid, *vjp(g)))
        srcs.append(_t(src).requires_grad_(True))
        us.append(_t(u).requires_grad_(True))
        gs.append(_t(g))
    dmaxs = tuple(dmax for *_, dmax in STEREO_PYRAMID)
    outs = [make() for make in warp_kernels.stereo_sample_grouped(srcs, us, dmaxs)]
    torch.autograd.backward(outs, gs)
    for out, src, u, (ref, valid, ref_dsrc, ref_du) in zip(outs, srcs, us, refs):
        _assert_match(out.detach(), torch.from_numpy(valid), ref, valid)
        np.testing.assert_allclose(u.grad.numpy(), np.asarray(ref_du), rtol=0, atol=1e-5)
        np.testing.assert_allclose(src.grad.numpy(), np.asarray(ref_dsrc), rtol=0, atol=1e-5)
        assert np.abs(np.asarray(ref_du)).max() > 0.1


def test_gen_pyramid_function_matches_pallas_per_scale(rng):
    import jax

    srcs, us, vs, gs, refs = [], [], [], [], []
    for C, H, W, pad_v, twist in GEN_PYRAMID:
        src, depth, T, K = _scene(rng, C, H, W, twist)
        u, v, valid = map(np.array, warp_pallas._gen_warp_prep(depth, T, K, H, W, pad_v))
        g = _masked_cotangent(rng, src.shape, valid)
        out, vjp = jax.vjp(
            lambda uu, vv, s=src, p=pad_v: warp_pallas._gen_sample_chw(s, uu, vv, p), u, v)
        refs.append((out, valid, *vjp(g)))
        srcs.append(_t(src))
        us.append(_t(u).requires_grad_(True))
        vs.append(_t(v).requires_grad_(True))
        gs.append(_t(g))
    outs = [make() for make in warp_kernels.frozen_gen_sample_grouped(srcs, us, vs)]
    torch.autograd.backward(outs, gs)
    for out, u, v, (ref, valid, ref_du, ref_dv) in zip(outs, us, vs, refs):
        _assert_match(out.detach(), torch.from_numpy(valid), ref, valid)
        np.testing.assert_allclose(u.grad.numpy(), np.asarray(ref_du), rtol=0, atol=1e-5)
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(ref_dv), rtol=0, atol=1e-5)
        assert np.abs(np.asarray(ref_du)).max() > 0.1


def _grouped(rng, family, shapes, need=None):
    """A grouped sample of ``family`` over B=2 segments of (C, H, W)
    ``shapes``: (its per-scale calls, the sources, the sample columns u).
    The coordinates of scale k need a gradient unless ``need[k]`` is
    False."""
    B = 2
    need = need or [True] * len(shapes)
    srcs = [_t(rng.normal(size=(B, C, H, W))) for C, H, W in shapes]
    us = [_t(rng.uniform(0, W - 1, (B, H, W))).requires_grad_(r)
          for (_, H, W), r in zip(shapes, need)]
    if family == "stereo":
        return warp_kernels.stereo_sample_grouped(srcs, us, [8] * len(shapes)), srcs, us
    vs = [_t(rng.uniform(0, H - 1, (B, H, W))).requires_grad_(r)
          for (_, H, W), r in zip(shapes, need)]
    return warp_kernels.frozen_gen_sample_grouped(srcs, us, vs), srcs, us


@pytest.mark.parametrize("family", ["stereo", "gen"])
def test_pyramid_functions_run_the_backward_only_where_a_cotangent_arrives(
        rng, monkeypatch, family):
    """Only the middle scale's output reaches the loss: its backward
    kernel runs once (for the stereo family, the coarse scales' launch
    over that scale alone), the other scales get no gradient."""
    shapes = [(3, 4, 12), (19, 6, 10), (3, 8, 16)]
    stereo = family == "stereo"
    bwd = "stereo_bwd_u_grouped" if stereo else "gen_bwd_uv"
    calls = []
    real = getattr(warp_kernels, bwd)
    monkeypatch.setattr(warp_kernels, bwd, lambda *a: calls.append(
        [s.shape for s in a[0]] if stereo else a[0].shape) or real(*a))
    makers, _, us = _grouped(rng, family, shapes)
    outs = [make() for make in makers]
    assert [tuple(o.shape[1:]) for o in outs] == shapes
    outs[1].sum().backward()
    one = torch.Size((2, 19, 6, 10))
    assert calls == ([[one]] if stereo else [one])
    assert us[0].grad is None and us[2].grad is None and us[1].grad.abs().max() > 0


def test_pyramid_functions_save_what_the_per_scale_functions_save(rng):
    """The grouped stereo sample keeps (src, u) of every scale; the
    grouped general one (src, u, v) of each scale whose coordinates need
    a gradient, and nothing of the others."""
    shapes = [(3, 4, 12), (19, 6, 10), (3, 8, 16)]
    saved = []
    makers, _, _ = _grouped(rng, "stereo", shapes)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        [make() for make in makers]
    assert len(saved) == 6
    makers, srcs, _ = _grouped(rng, "gen", shapes, need=[True, False, True])
    saved.clear()
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        [make() for make in makers]
    assert len(saved) == 6
    assert [t.data_ptr() for t in saved if t.ndim == 4] == [srcs[0].data_ptr(), srcs[2].data_ptr()]


@pytest.mark.parametrize("family", ["stereo", "gen"])
@pytest.mark.parametrize("mode", ["enable_grad", "no_grad", "inference_mode"])
def test_grouped_sample_calls_let_go_of_what_they_took(rng, family, mode):
    """A per-scale call, once made, holds neither its output nor its
    inputs: with the caller's result, its graph and its inputs dropped, the
    output's memory goes, as with one launch per scale (where the loss
    does not keep a warped output, the train step's peak depends on it).
    A second call of the same scale raises."""
    import weakref

    with getattr(torch, mode)():
        makers, srcs, us = _grouped(rng, family, [(3, 4, 12), (19, 6, 10)])
        out = makers[1]()
        kept = [weakref.ref(t) for t in (srcs[1], us[1], out if out._base is None else out._base)]
        del srcs, us, out
        assert [k() for k in kept] == [None] * 3
        with pytest.raises(RuntimeError, match="scale 1 was taken already"):
            makers[1]()
        assert makers[0]().shape[1:] == (3, 4, 12)


class _Probe(torch.autograd.Function):
    """Identity whose backward appends ``tag`` to ``log``."""

    @staticmethod
    def forward(ctx, x, log, tag):
        ctx.log, ctx.tag = log, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.log.append(ctx.tag)
        return g, None, None


@pytest.mark.parametrize("family", ["stereo", "gen"])
def test_each_scale_backward_runs_right_after_its_loss(rng, monkeypatch, family):
    """One forward launch for all scales. With each scale's call made
    where its loss is built, as the loss graph does: the general warp has
    one gradient node per scale, and each scale's backward kernel runs
    (and frees its cotangent) right after that loss's backward, before the
    earlier scales' losses, as with one launch per scale. The stereo warp
    has a node for the finest scale, whose K2 runs right after the finest
    loss, and one for the coarse scales, made at the coarsest loss, whose
    one K2 launch runs after all the coarse losses."""
    shapes = [(3, 4, 12), (19, 6, 10), (3, 8, 16)]
    log = []
    if family == "stereo":
        bwd = "stereo_bwd_u_grouped"
        tag = lambda a: f"stereo_bwd_u {[s.shape[1] for s in a[0]]}"  # noqa: E731
        want = ["loss 2", "stereo_bwd_u [3]", "loss 1", "loss 0", "stereo_bwd_u [3, 19]"]
    else:
        bwd = "gen_bwd_uv"
        tag = lambda a: f"gen_bwd_uv {a[0].shape[1]}"  # noqa: E731
        want = [entry for k in (2, 1, 0) for entry in (f"loss {k}", f"gen_bwd_uv {shapes[k][0]}")]
    real = getattr(warp_kernels, bwd)
    monkeypatch.setattr(warp_kernels, bwd, lambda *a: log.append(tag(a)) or real(*a))
    makers, _, us = _grouped(rng, family, shapes)
    total = 0.0
    for k, make in enumerate(makers):
        total = total + (_Probe.apply(make(), log, f"loss {k}") ** 2).sum()
    total.backward()
    assert log == want
    assert all(u.grad.abs().max() > 0 for u in us)


# --------------------------------------------------------------------------
# K2 over a group of segments: the coarse scales share one node and one
# launch. Tolerances as above (1e-5 absolute against jax.vjp of the
# reference's per-scale custom VJP); the plain and the simulated kernel
# are held bit for bit.
# --------------------------------------------------------------------------

# C, H, W, dmax: H*W odd or not a multiple of the block, C = 1 and 19
STEREO_RAGGED = [(3, 5, 37, 8), (1, 9, 75, 16), (19, 10, 150, 32), (3, 13, 128, 24)]


def test_stereo_coarse_node_matches_pallas_per_scale(rng):
    """Four ragged scales taken in the loss's order (coarsest first): the
    three coarse scales' shared node and the finest scale's own give each
    scale's d_u and, where the source needs a gradient, its d_src, as the
    reference's per-scale VJP does."""
    import jax

    B = 2
    need_src = [True, False, True, False]
    srcs, us, gs, refs = [], [], [], []
    for (C, H, W, dmax), need in zip(STEREO_RAGGED, need_src):
        src = rng.normal(size=(B, C, H, W)).astype(np.float32)
        depth = rng.uniform(1.5, 40.0, (B, H, W)).astype(np.float32)
        disp, u = warp_pallas.stereo_disparity_u(depth, FXB * W / 150, W)
        valid = np.array(warp_pallas.stereo_valid_mask(depth, disp, u, H, W, dmax))
        g = _masked_cotangent(rng, src.shape, valid)
        _, vjp = jax.vjp(lambda s, uu, d=dmax: warp_pallas._stereo_sample_chw(s, uu, d), src, u)
        refs.append(vjp(g))
        srcs.append(_t(src).requires_grad_(need))
        us.append(_t(u).requires_grad_(True))
        gs.append(_t(g))
    makers = warp_kernels.stereo_sample_grouped(srcs, us, [d for *_, d in STEREO_RAGGED])
    outs = [make() for make in makers]
    assert len({o.grad_fn for o in outs[:-1]}) == 1 and outs[-1].grad_fn != outs[0].grad_fn
    torch.autograd.backward(outs, gs)
    for src, u, need, (ref_dsrc, ref_du) in zip(srcs, us, need_src, refs):
        np.testing.assert_allclose(u.grad.numpy(), np.asarray(ref_du), rtol=0, atol=1e-5)
        assert np.abs(np.asarray(ref_du)).max() > 0.1
        if need:
            np.testing.assert_allclose(src.grad.numpy(), np.asarray(ref_dsrc), rtol=0, atol=1e-5)
        else:
            assert src.grad is None


def test_stereo_bwd_u_grouped_on_the_cpu_is_the_plain_version_per_segment(rng):
    """Bit for bit, on a dense cotangent and sample columns past both
    edges."""
    srcs = [_t(rng.normal(size=(2, C, H, W))) for C, H, W, _ in STEREO_RAGGED]
    gs = [_t(rng.normal(size=s.shape)) for s in srcs]
    us = [_t(rng.uniform(-3.0, W + 2.0, (2, H, W))) for _, H, W, _ in STEREO_RAGGED]
    got = warp_kernels.stereo_bwd_u_grouped(srcs, gs, us)
    assert len(got) == len(srcs)
    for d_u, src, g, u in zip(got, srcs, gs, us):
        assert torch.equal(d_u, warp_kernels.stereo_bwd_u_plain(src, g, u))
        assert d_u.abs().max() > 0.1


def _simulated_stereo_bwd_u(srcs, gs, us):
    """``csrc/warp.cu``'s stereo_bwd_u_pyramid_kernel run in numpy, thread
    by thread of the grouped launch (:func:`_thread_pixels`): each thread
    clamps its pixel to the segment, recomputes the taps, reads g and both
    taps of channel min(c, C-1) for kStereoChan (3) channels at a time and
    sums g * (s1 - s0) in float32 in channel order; a pixel past the end
    stores nothing. Returns d_u per segment and how often each of its
    pixels was stored."""
    plans = warp_kernels.pack_segments([tuple(s.shape) for s in srcs])
    seg, q = _thread_pixels(plans)
    d_us = [np.full(u.shape, np.nan, np.float32).reshape(-1) for u in us]
    counts = [np.zeros(u.numel(), int) for u in us]
    for s, (pl, src, g, u) in enumerate(zip(plans, srcs, gs, us)):
        C, H, W = pl.C, pl.H, pl.W
        HW, pixels = H * W, pl.B * H * W
        qs = q[seg == s]
        qc = np.minimum(qs, pixels - 1)
        b = qc // HW
        p = qc - b * HW
        uc = np.clip(u.numpy().reshape(-1)[qc], np.float32(0), np.float32(W - 1))
        x0 = np.floor(uc).astype(np.int64)
        gp = b * C * HW + p
        t0 = gp - p % W + x0
        dx = (x0 + 1 < W).astype(np.int64)
        flat_g, flat_src = g.numpy().reshape(-1), src.numpy().reshape(-1)
        acc = np.zeros(qs.shape, np.float32)
        for c in range(-(-C // 3) * 3):
            plane = min(c, C - 1) * HW
            gv, s0, s1 = flat_g[plane + gp], flat_src[plane + t0], flat_src[plane + t0 + dx]
            if c < C:
                acc = (acc + gv * (s1 - s0)).astype(np.float32)
        stored = qs < pixels
        d_us[s][qs[stored]] = acc[stored]
        np.add.at(counts[s], qs[stored], 1)
    return [d.reshape(u.shape) for d, u in zip(d_us, us)], counts


@pytest.mark.parametrize("shapes", [
    [(2, C, H, W) for C, H, W, _ in STEREO_RAGGED],
    # a one-pixel-wide and a one-pixel segment
    [(3, 1, 9, 1), (1, 3, 1, 1), (2, 19, 7, 33)],
])
def test_stereo_bwd_u_launch_table_stores_every_pixel_once_and_equals_plain(rng, shapes):
    """The grouped K2 launch, simulated thread by thread from the table
    ``pack_segments`` lays out, stores every pixel of every segment exactly
    once, and what it stores is the plain version's d_u bit for bit."""
    srcs = [_t(rng.normal(size=s)) for s in shapes]
    gs = [_t(rng.normal(size=s)) for s in shapes]
    us = [_t(rng.uniform(-3.0, W + 2.0, (B, H, W))) for B, _, H, W in shapes]
    d_us, counts = _simulated_stereo_bwd_u(srcs, gs, us)
    for d_u, count, src, g, u in zip(d_us, counts, srcs, gs, us):
        np.testing.assert_array_equal(count, np.ones_like(count))
        np.testing.assert_array_equal(d_u, warp_kernels.stereo_bwd_u_plain(src, g, u).numpy())


def test_grouped_stereo_bwd_u_refuses_what_the_kernel_does_not_take():
    """Before building or launching anything: more than MAX_SEGMENTS
    segments, a segment without its cotangent, a cotangent or u of
    another shape than its source's, and CPU tensors."""
    src = torch.zeros(1, 3, 8, 16)
    u = torch.zeros(1, 8, 16)
    n = warp_kernels.MAX_SEGMENTS + 1
    with pytest.raises(ValueError, match="1 to 8 segments"):
        warp_kernels.stereo_bwd_u_grouped_cuda([src] * n, [src] * n, [u] * n)
    with pytest.raises(ValueError, match="its cotangent"):
        warp_kernels.stereo_bwd_u_grouped_cuda([src, src], [src], [u, u])
    with pytest.raises(ValueError, match=r"g\[1\] must have shape \(1, 3, 8, 16\)"):
        warp_kernels.stereo_bwd_u_grouped_cuda([src, src], [src, src[:, :1]], [u, u])
    with pytest.raises(ValueError, match=r"u\[0\] must have shape \(1, 8, 16\)"):
        warp_kernels.stereo_bwd_u_grouped_cuda([src, src], [src, src], [u[:, :4], u])
    with pytest.raises(ValueError, match="CUDA tensor"):
        warp_kernels.stereo_bwd_u_grouped_cuda([src, src], [src, src], [u, u])
    assert warp_kernels.launch_count("stereo_bwd_u") == 0


@pytest.mark.parametrize("mode", ["enable_grad", "no_grad", "inference_mode"])
def test_coarse_scale_taken_after_the_shared_node_is_held_only_until_taken(rng, mode):
    """The coarsest scale's call makes the coarse scales' node (with a
    graph) or returns its output (without one). The middle scale's output
    is then held by its call alone: once taken and dropped by the caller
    it goes, while the coarsest output and its graph live on; its source
    and u go with that graph at the latest."""
    import weakref

    with getattr(torch, mode)():
        makers, srcs, us = _grouped(rng, "stereo", [(3, 4, 12), (19, 6, 10), (3, 8, 16)])
        out0 = makers[0]()
        kept = [weakref.ref(t) for t in (srcs[1], us[1])]
        del srcs, us
        out1 = makers[1]()
        assert out1.shape[1:] == (19, 6, 10)
        kept.append(weakref.ref(out1 if out1._base is None else out1._base))
        del out1
        assert kept[2]() is None
        with pytest.raises(RuntimeError, match="scale 1 was taken already"):
            makers[1]()
        del out0
        assert [k() for k in kept] == [None] * 3
        assert makers[2]().shape[1:] == (3, 8, 16)


def test_four_scale_train_loss_makes_two_stereo_bwd_u_launches(monkeypatch):
    """``compute_losses(train=True)`` at 4 scales, backward: one K2 call
    for the finest scale and then one over the three coarse scales."""
    import dataclasses

    from depthvo_tpu_torch import configs as tconfigs
    from depthvo_tpu_torch.data.synthetic import SyntheticScenes
    from depthvo_tpu_torch.train import loop as tloop, state as tstate

    calls = []
    real = warp_kernels.stereo_bwd_u_grouped
    monkeypatch.setattr(warp_kernels, "stereo_bwd_u_grouped",
                        lambda *a: calls.append([tuple(s.shape[2:]) for s in a[0]]) or real(*a))
    cfg = tconfigs.tiny_test()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, num_scales=4))
    models = tstate.load_params(tstate.build_models(cfg), tstate.init_params(
        cfg, torch.Generator().manual_seed(0)), torch.device("cpu"))
    batch = tloop.batch_to_device(SyntheticScenes(cfg, seed=3, num_scenes=2).fixed_batch(2),
                                  torch.device("cpu"))
    total, _ = tloop.compute_losses(cfg, models, batch, train=True)
    assert calls == []
    total.backward()
    assert calls == [[(32, 96)], [(4, 12), (8, 24), (16, 48)]]
