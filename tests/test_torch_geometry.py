"""The port's geometry core held against the JAX reference.

Same inputs (numpy, from a seed) through ``depthvo_tpu.geometry`` and
``depthvo_tpu_torch.geometry``. Tolerances: SE(3) maps agree to 1e-6
absolute (float32 with full-precision 3x3 products on both sides);
pixel coordinates to 2e-5 px (a few float32 ulps at |u| ~ 100).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthvo_tpu.geometry import camera as jcam, se3 as jse3, warp as jwarp
from depthvo_tpu_torch.geometry import camera as tcam, se3 as tse3, warp as twarp

torch.set_num_threads(2)


def _twists(rng, n=16):
    xi = rng.normal(size=(n, 6)).astype(np.float32) * np.float32(0.3)
    # Rotation norms across the Taylor switch (1e-4) and at 0 exactly.
    for k, scale in enumerate((0.0, 1e-6, 9e-5, 1e-4, 1.1e-4, 1e-3)):
        w = rng.normal(size=3).astype(np.float32)
        xi[k, 3:] = w / np.linalg.norm(w) * np.float32(scale)
    return xi


def _close(got, ref, atol):
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol)


@pytest.mark.parametrize("fn", ["exp", "exp_so3", "left_jacobian_so3"])
def test_exp_maps_match_jax(rng, fn):
    xi = _twists(rng)
    arg = xi if fn == "exp" else xi[:, 3:]
    _close(getattr(tse3, fn)(torch.from_numpy(arg)), getattr(jse3, fn)(arg), 1e-6)


def test_log_compose_inverse_match_jax(rng):
    T = np.asarray(jse3.exp(_twists(rng)))
    T2 = np.asarray(jse3.exp(_twists(rng)))
    tT, tT2 = torch.from_numpy(T.copy()), torch.from_numpy(T2.copy())
    _close(tse3.log(tT), jse3.log(T), 1e-6)
    _close(tse3.log_so3(tT[:, :3, :3]), jse3.log_so3(T[:, :3, :3]), 1e-6)
    _close(tse3.compose(tT, tT2), jse3.compose(T, T2), 1e-6)
    _close(tse3.inverse(tT), jse3.inverse(T), 1e-6)
    _close(tse3.hat(tT[:, :3, 3]), jse3.hat(T[:, :3, 3]), 0)
    _close(tse3.vee(tse3.hat(tT[:, :3, 3])), T[:, :3, 3], 0)


def test_exp_is_finite_and_identity_at_zero():
    T = tse3.exp(torch.zeros(2, 6))
    assert torch.equal(T, torch.eye(4).expand(2, 4, 4))


def _scene(rng, B=2, H=20, W=48):
    depth = rng.uniform(3.0, 30.0, (B, H, W)).astype(np.float32)
    K = np.array([[0.58 * W, 0, 0.5 * W], [0, 1.92 * H, 0.5 * H], [0, 0, 1]],
                 np.float32)
    K = np.broadcast_to(K, (B, 3, 3)).copy()
    xi = np.array([[0.05, -0.02, -0.4, 0.003, -0.01, 0.002]] * B, np.float32)
    T = np.array(jse3.exp(xi))
    return depth, T, K


def test_camera_and_warp_coords_match_jax(rng):
    depth, T, K = _scene(rng)
    tK = torch.from_numpy(K)
    _close(tcam.scale_intrinsics(tK, 0.5, 0.25),
           jcam.scale_intrinsics(K, 0.5, 0.25), 0)
    _close(tcam.pixel_grid(5, 7), jcam.pixel_grid(5, 7), 0)
    pts_ref = jcam.backproject(depth, K)
    pts = tcam.backproject(torch.from_numpy(depth), tK)
    _close(pts, pts_ref, 2e-5)
    _close(tcam.transform_points(pts, torch.from_numpy(T)),
           jcam.transform_points(pts_ref, T), 2e-5)
    coords_ref, front_ref = jwarp.warp_coords(depth, T, K)
    coords, front = twarp.warp_coords(torch.from_numpy(depth), torch.from_numpy(T), tK)
    _close(coords, coords_ref, 2e-5)
    assert np.array_equal(front.numpy(), np.asarray(front_ref))


def test_inverse_warp_matches_jax(rng):
    depth, T, K = _scene(rng)
    src = rng.uniform(-1, 1, (2, 20, 48, 3)).astype(np.float32)
    w_ref, v_ref = jwarp.inverse_warp(src, depth, T, K)
    w, v = twarp.inverse_warp(torch.from_numpy(src), torch.from_numpy(depth),
                              torch.from_numpy(T), torch.from_numpy(K))
    v_ref = np.asarray(v_ref)
    assert np.array_equal(v.numpy(), v_ref)
    assert v_ref.mean() > 0.5
    diff = np.abs(w.numpy() - np.asarray(w_ref))[v_ref]
    assert diff.max() <= 1e-5


def test_bilinear_sample_matches_jax_off_grid(rng):
    img = rng.normal(size=(1, 6, 9, 2)).astype(np.float32)
    coords = rng.uniform(-1.5, 9.5, (1, 4, 5, 2)).astype(np.float32)
    s_ref, ib_ref = jwarp.bilinear_sample(jnp.asarray(img), coords)
    s, ib = twarp.bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords))
    assert np.array_equal(ib.numpy(), np.asarray(ib_ref))
    _close(s, s_ref, 1e-6)
