"""The port's losses held against the JAX reference at 1e-5 absolute
(float32 on both sides; the sums run over a few thousand terms in
different orders)."""

import numpy as np
import pytest
import torch

from depthvo_tpu.losses import photometric as jphoto, smoothness as jsmooth
from depthvo_tpu_torch.losses import photometric as tphoto, smoothness as tsmooth

torch.set_num_threads(2)


def _inputs(rng, B=2, C=3, H=16, W=40):
    warped = rng.uniform(-1, 1, (B, C, H, W)).astype(np.float32)
    target = rng.uniform(-1, 1, (B, C, H, W)).astype(np.float32)
    valid = rng.uniform(size=(B, H, W)) > 0.2
    return warped, target, valid


@pytest.mark.parametrize("ssim_weight", [0.0, 0.85])
def test_photometric_loss_chw_matches_jax(rng, ssim_weight):
    warped, target, valid = _inputs(rng)
    ref = float(jphoto.photometric_loss_chw(warped, target, valid, ssim_weight))
    got = float(tphoto.photometric_loss_chw(
        torch.from_numpy(warped), torch.from_numpy(target),
        torch.from_numpy(valid), ssim_weight,
    ))
    assert abs(got - ref) <= 1e-5


def test_masked_l1_and_ssim_chw_match_jax(rng):
    warped, target, valid = _inputs(rng, C=19)
    tw, tt = torch.from_numpy(warped), torch.from_numpy(target)
    ref = float(jphoto.masked_l1_chw(warped, target, valid))
    assert abs(float(tphoto.masked_l1_chw(tw, tt, torch.from_numpy(valid))) - ref) <= 1e-5
    np.testing.assert_allclose(
        tphoto.ssim_chw(tw, tt).numpy(),
        np.asarray(jphoto.ssim_chw(warped, target)), rtol=0, atol=1e-5,
    )


@pytest.mark.parametrize("edge_aware", [True, False])
def test_smoothness_chw_matches_jax(rng, edge_aware):
    disp = rng.uniform(0.01, 0.3, (2, 16, 40, 1)).astype(np.float32)
    img = rng.uniform(-1, 1, (2, 3, 16, 40)).astype(np.float32)
    ref = float(jsmooth.smoothness_loss(disp, img, edge_aware=edge_aware,
                                        image_layout="chw"))
    got = float(tsmooth.smoothness_loss(torch.from_numpy(disp), torch.from_numpy(img),
                                        edge_aware=edge_aware, image_layout="chw"))
    assert abs(got - ref) <= 1e-5


def test_smoothness_nhwc_matches_jax(rng):
    disp = rng.uniform(0.01, 0.3, (2, 16, 40, 1)).astype(np.float32)
    img = rng.uniform(-1, 1, (2, 16, 40, 3)).astype(np.float32)
    ref = float(jsmooth.smoothness_loss(disp, img))
    got = float(tsmooth.smoothness_loss(torch.from_numpy(disp), torch.from_numpy(img)))
    assert abs(got - ref) <= 1e-5
