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
from depthvo_tpu_torch import ops as tops
from depthvo_tpu_torch.geometry import warp as twarp
from depthvo_tpu_torch.ops import warp_kernels

torch.set_num_threads(2)

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
    anything, and never fall back to the plain versions."""
    src = torch.zeros(1, 3, 8, 16)
    u = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        warp_kernels.stereo_sample_cuda(src, u)
    with pytest.raises(ValueError, match="CUDA tensor"):
        warp_kernels.gen_sample_cuda(src, u, u)
    assert warp_kernels.launch_count("stereo_fwd") == 0
    assert warp_kernels.launch_count("gen_fwd") == 0
