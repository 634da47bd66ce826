"""The benchmark's plain reference against the system's plain path on the
CPU at ``tiny_test`` sizes (float32), and its data path against the
system's loader."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from depthvo_tpu_torch.configs import base as config_base
from depthvo_tpu_torch.train import loop
from depthvo_tpu_torch.train.state import (
    TrainState, build_models, load_params, make_optimizer, param_tree)
from gpubench import compare, flops, scenes, weights
from gpubench.reference import nets, png, precision
from gpubench.reference import train as reference


@pytest.mark.parametrize("stage", ["full_feat", "stereo", "tiny_test"])
def test_layout_is_the_systems(stage):
    cfg = getattr(config_base, stage)()
    models = build_models(cfg)
    system = {f"{n}.{k}": tuple(v.shape) for n, net in zip(("depth", "odom", "feat"), models)
              if net is not None for k, v in net.state_dict().items()}
    ours = {name: tuple(shape) for name, shape, _ in nets.specs(config_base.to_dict(cfg))}
    assert list(ours) == list(system) and ours == system
    assert nets.trainable(config_base.to_dict(cfg)) == [
        k for k in param_tree(models) if not k.startswith("feat.")]


@pytest.mark.parametrize("use_feature", [True, False])
def test_train_step_is_the_systems(use_feature):
    cfg = config_base.tiny_test(batch_size=2, use_feature=use_feature,
                                use_temporal=use_feature)
    config = config_base.to_dict(cfg)
    cpu = torch.device("cpu")
    params = weights.make(config, 3, cpu)
    models = load_params(build_models(cfg), weights.state_dicts(params), cpu).train()
    state = TrainState(0, models, make_optimizer(cfg).init(param_tree(models)))
    rows = scenes.SyntheticScenes(32, 96, config["stereo_baseline"], 5, 2).batch([0, 1])
    state, got = loop.make_train_step(cfg, device="cpu")(state, rows)
    ref = reference.Trainer(config, params)
    want = ref.step({k: torch.as_tensor(v) for k, v in rows.items()})
    for k, v in want.items():
        assert compare.rel(float(got[k]), v) < 1e-5, k
    pt = param_tree(state.models)
    change = {k: pt[k].detach() - params[k] for k in ref.names}
    ref_change = {k: ref.p[k] - params[k] for k in ref.names}
    # Train-mode gradients are chaotic elementwise in float32; leaf norms
    # are steady (a few 1e-4 here).
    assert compare.worst_leaf(change, ref_change, compare.moved(ref.first_grads)) < 1e-2
    buffers = dict(state.models.depth.named_buffers())
    for k, v in ref.stats.items():
        assert float((buffers[k.split(".", 1)[1]] - v).abs().max()) < 1e-4, k


def test_png_and_resize_are_the_loaders(tmp_path):
    from depthvo_tpu_torch.data import native_loader

    img = scenes.SyntheticScenes(375, 1242, 0.54, 8, 1).scenes[0]["image_r"]
    path = str(tmp_path / "f.png")
    scenes.write_png(path, img)
    np.testing.assert_array_equal(png.decode(path), img)
    ours = png.resize_u8(img, 160, 608).astype(int)
    theirs = native_loader.load_resized_u8(path, 160, 608).astype(int)
    # The loader accumulates in float32 in an order its compiler may
    # contract: a code here and there is one off, never more.
    assert np.abs(ours - theirs).max() <= 1
    assert (ours != theirs).mean() < 1e-4


def test_fp8_keeps_three_mantissa_bits():
    x = torch.linspace(-3.0, 5.0, 1001)
    q = precision.fp8_round(x)
    assert float((q - x).abs().max()) <= 5.0 / 16 + 1e-6
    scaled = q[q != 0].double() / (5.0 / precision.E4M3_MAX)
    mant = torch.frexp(scaled)[0].abs() * 16
    assert float((mant - mant.round()).abs().max()) < 1e-4


def test_flop_count_covers_the_backward():
    from torch.utils.flop_counter import FlopCounterMode

    config = config_base.to_dict(config_base.full_feat())
    m, batch = config["model"], config["batch_size"]
    p = {name: torch.zeros(shape, device="meta") for name, shape, _ in nets.specs(config)}
    x = torch.zeros((batch, m["height"], m["width"], 3), device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as forward:
        nets.depth_net(p, x, m, True, dict(p))
        nets.odom_net(p, torch.cat([x, x], dim=-1))
    step = flops.train_step(config)
    # Forward of the depth and odometry nets, then their backward (about
    # twice the forward); the frozen feature net forward only.
    assert 2.2 * forward.get_total_flops() < step < 3.2 * forward.get_total_flops() + 4e11
