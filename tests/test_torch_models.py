"""The port's networks held against the flax reference.

JAX parameters from ``create_state``'s initialisers, with the BatchNorm
scale/bias/mean/var perturbed by numpy noise so that eval-mode BatchNorm
is exercised, are carried across with ``io/from_jax.py``. Same numpy
inputs on both sides. Tolerance: 2e-5 relative to the largest output
magnitude, the bar tests/test_models.py holds the s2d rewrite to (float32
convolutions summed in different orders by XLA and by PyTorch).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthvo_tpu import configs as jconfigs
from depthvo_tpu.models import layers as jlayers
from depthvo_tpu.train.state import build_models as jbuild_models
from depthvo_tpu_torch import configs as tconfigs
from depthvo_tpu_torch.io import from_jax
from depthvo_tpu_torch.models import layers as tlayers
from depthvo_tpu_torch.models.depth_net import DepthNet
from depthvo_tpu_torch.train.state import build_models

torch.set_num_threads(2)

RTOL = 2e-5


def _perturb_bn(tree, rng, in_bn=False):
    """Noise on every BatchNorm leaf: scale/bias in params, mean/var in
    batch_stats."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_bn(v, rng, k.startswith("BatchNorm_"))
        elif in_bn and k == "var":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif in_bn:
            base = 1.0 if k == "scale" else 0.0
            out[k] = (base + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def jax_state(cfg, rng):
    """flax params for the stage's three networks (the trees
    ``create_state`` builds) with BatchNorm perturbed."""
    dn, on, fn = jbuild_models(cfg)
    mc = cfg.model
    img = jnp.zeros((1, mc.height, mc.width, 3))
    k_d, k_o, k_f = jax.random.split(jax.random.PRNGKey(0), 3)
    dvars = jax.device_get(jax.jit(dn.init)(k_d, img))
    params = {
        "depth": dvars["params"],
        "odom": jax.device_get(jax.jit(on.init)(k_o, jnp.zeros((1,) + img.shape[1:3] + (6,))))["params"],
        "feat": jax.device_get(jax.jit(fn.init)(k_f, img))["params"],
    }
    params["depth"] = _perturb_bn(params["depth"], rng)
    batch_stats = _perturb_bn(dvars["batch_stats"], rng)
    return (dn, on, fn), params, batch_stats


def _close(got, ref):
    got = got.detach().numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= RTOL, err


@pytest.fixture(scope="module")
def nets():
    cfg = jconfigs.tiny_test()
    assert cfg.model.s2d_finest, "the reference runs its s2d finest stage"
    jnets, params, batch_stats = jax_state(cfg, np.random.default_rng(1))
    bn = params["depth"]["ConvBlock_0"]["BatchNorm_0"]
    assert not np.allclose(bn["scale"], 1.0) and not np.allclose(bn["bias"], 0.0)
    models = from_jax.load_jax_params(
        build_models(tconfigs.tiny_test()), params, batch_stats
    )
    return jnets, params, batch_stats, models


def test_depth_net_matches_flax_at_every_scale(nets):
    (dn, _, _), params, batch_stats, models = nets
    x = np.random.default_rng(2).uniform(-1, 1, (2, 32, 96, 3)).astype(np.float32)
    ref = jax.jit(lambda v, x: dn.apply(v, x))(
        {"params": params["depth"], "batch_stats": batch_stats}, x
    )
    with torch.no_grad():
        got = models.depth(torch.from_numpy(x))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("hw", [(32, 96), (33, 97)])
def test_odom_and_feat_nets_match_flax(nets, hw):
    """(33, 97) is odd: there flax's SAME pads of the stride-2 convs are
    symmetric, at (32, 96) they are not."""
    (_, on, fn), params, _, models = nets
    rng = np.random.default_rng(3)
    pair = rng.uniform(-1, 1, (2,) + hw + (6,)).astype(np.float32)
    img = pair[..., :3]
    twist = jax.jit(lambda p, x: on.apply({"params": p}, x))(params["odom"], pair)
    feats = jax.jit(lambda p, x: fn.apply({"params": p}, x))(params["feat"], img)
    with torch.no_grad():
        _close(models.odom(torch.from_numpy(pair)), twist)
        _close(models.feat(torch.from_numpy(img)), feats)


@pytest.mark.parametrize(
    "src_hw,hw",
    [((160, 608), (80, 304)), ((160, 608), (40, 152)), ((160, 608), (20, 76)),
     ((32, 96), (64, 192))],
)
def test_resize_matches_jax(src_hw, hw):
    """The loss pyramid's shrinks (antialiased in jax.image.resize) and a
    growth."""
    x = np.random.default_rng(4).normal(size=(1, 3) + src_hw).astype(np.float32)
    ref = jlayers.resize_bilinear_chw(x, *hw)
    got = tlayers.resize_bilinear_chw(torch.from_numpy(x), *hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-6)


def test_upsample_and_max_pool_match_flax(rng):
    x = rng.normal(size=(2, 5, 7, 4)).astype(np.float32)
    ref_up = jlayers.upsample2x(x)
    got_up = tlayers.upsample2x(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got_up.permute(0, 2, 3, 1).numpy(), np.asarray(ref_up))
    ref_mp = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME")
    got_mp = tlayers.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got_mp.permute(0, 2, 3, 1).numpy(), np.asarray(ref_mp))


def test_from_jax_consumes_every_leaf(nets):
    _, params, batch_stats, _ = nets
    cfg = tconfigs.tiny_test()
    extra = {**params, "odom": {**params["odom"], "Dense_9": params["odom"]["Dense_0"]}}
    with pytest.raises(KeyError, match="unexpected"):
        from_jax.load_jax_params(build_models(cfg), extra, batch_stats)
    missing = {**params, "feat": {k: v for k, v in params["feat"].items() if k != "Conv_0"}}
    with pytest.raises(KeyError, match="missing"):
        from_jax.load_jax_params(build_models(cfg), missing, batch_stats)
    no_feat = {k: v for k, v in params.items() if k != "feat"}
    with pytest.raises(KeyError, match="feat"):
        from_jax.load_jax_params(build_models(cfg), no_feat, batch_stats)


def test_unported_finest_modes_raise():
    for kw in ({"fast_final_upsample": True}, {"subpixel_head": True}):
        with pytest.raises(NotImplementedError):
            DepthNet(**kw)
