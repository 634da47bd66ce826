"""The port's held-out loss pass and serving, held against the JAX package.

The JAX ``make_eval_step`` and the port's ``make_eval_step(device="cpu")``
run on the same weights (flax initialisers with BatchNorm perturbed,
carried across with ``io/from_jax.py``) and the same ``SyntheticScenes``
uint8 batch. On the CPU the JAX package takes its jnp warp path, which has
no window mask, while the port's ``valid`` follows the kernel path; the
test asserts that the kernel's window drops no pixel of these inputs, so
the two compute the same function here.

Tolerance per metric: 1e-4 relative. Each metric is a mean over a few
thousand pixels of float32 terms that went through two conv stacks (2e-5
apart, tests/test_torch_models.py) and two projection chains (2e-5 px
apart, tests/test_torch_geometry.py), summed in different orders.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthvo_tpu import configs as jconfigs
from depthvo_tpu.api import DepthVO as JDepthVO
from depthvo_tpu.data.synthetic import SyntheticScenes as JScenes
from depthvo_tpu.geometry import camera as jcam, se3 as jse3, warp as jwarp
from depthvo_tpu.ops import warp_pallas
from depthvo_tpu.train import loop as jloop
from depthvo_tpu.train.state import TrainState
from depthvo_tpu.utils.images import to_unit as jto_unit
from depthvo_tpu_torch import DepthVO, cli, configs as tconfigs, ops as tops
from depthvo_tpu_torch.data.synthetic import SyntheticScenes
from depthvo_tpu_torch.io.from_jax import load_jax_params
from depthvo_tpu_torch.train import loop as tloop
from depthvo_tpu_torch.train.state import build_models
from depthvo_tpu_torch.utils import profiling
from depthvo_tpu_torch.utils.device import resolve_device
from test_torch_models import jax_state

torch.set_num_threads(2)
torch.exp(torch.zeros(1))  # MKL's first call on one thread (test_torch_models.py)


@pytest.fixture(scope="module")
def setup():
    cfg = jconfigs.tiny_test()
    nets, params, batch_stats = jax_state(cfg, np.random.default_rng(5))
    batch = next(JScenes(cfg, seed=11, u8=True).iterator(cfg.batch_size))
    return cfg, nets, params, batch_stats, batch


def test_window_drops_no_pixel_of_the_eval_inputs(setup):
    cfg, (dn, on, _), params, batch_stats, batch = setup
    img_t, img_s = jto_unit(batch["image_t"]), jto_unit(batch["image_s"])
    disps = dn.apply({"params": params["depth"], "batch_stats": batch_stats}, img_t)
    twist = on.apply({"params": params["odom"]}, jnp.concatenate([img_t, img_s], -1))
    T = jse3.exp(twist)
    H, W = cfg.model.height, cfg.model.width
    checked = 0
    for disp in disps:
        h, w = disp.shape[1:3]
        pad_v = tops.kernel_pad_v(h, cfg.warp_pad_v)
        if pad_v is None:
            continue
        Ks = jcam.scale_intrinsics(batch["K"], w / W, h / H)
        depth = 1.0 / disp[..., 0]
        kernel_valid = warp_pallas._gen_warp_prep(depth, T, Ks, h, w, pad_v)[2]
        plain_valid = jwarp.inverse_warp(jnp.zeros((2, h, w, 1)), depth, T, Ks)[1]
        np.testing.assert_array_equal(np.asarray(kernel_valid), np.asarray(plain_valid))
        assert np.asarray(plain_valid).mean() > 0.5
        checked += 1
    assert checked >= 1  # the finest scale runs the windowed kernel


def test_eval_step_matches_jax(setup):
    cfg, _, params, batch_stats, batch = setup
    tcfg = tconfigs.tiny_test()
    tbatch = next(SyntheticScenes(tcfg, seed=11, u8=True).iterator(tcfg.batch_size))
    for k in batch:  # the port's own copy of the scenes makes the same batch
        np.testing.assert_array_equal(tbatch[k], batch[k])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=batch_stats, opt_state=None)
    ref = jax.device_get(jloop.make_eval_step(cfg)(state, batch))
    models = load_jax_params(build_models(tcfg), params, batch_stats)
    got = tloop.make_eval_step(tcfg, device="cpu")(models, tbatch)
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = float(got[k])
        assert abs(g - float(r)) <= 1e-4 * abs(float(r)), (k, g, float(r))
    # The same graph in train mode: batch statistics, a differentiable
    # total, the frozen feature net left in eval mode (held against
    # jax.grad in tests/test_torch_train.py).
    total, train_metrics = tloop.compute_losses(
        tcfg, models, tloop.batch_to_device(tbatch, "cpu"), train=True
    )
    assert set(train_metrics) == set(ref) and total.requires_grad
    assert models.depth.training and not models.feat.training
    assert float(train_metrics["loss/total"].detach()) != float(got["loss/total"])


def test_serving_matches_jax(setup):
    cfg, _, params, batch_stats, batch = setup
    ref_model = JDepthVO(cfg, params, batch_stats)
    model = DepthVO.from_jax_params(tconfigs.tiny_test(), params, batch_stats,
                                    device="cpu")
    pairs = np.concatenate([batch["image_t"], batch["image_s"]], axis=-1)
    for got, ref in [
        (model.depth(batch["image_t"]), ref_model.depth(batch["image_t"])),
        (model.inverse_depth(batch["image_t"]), ref_model.inverse_depth(batch["image_t"])),
        (model.pose(pairs), ref_model.pose(pairs)),
        (model.features(batch["image_s"]), ref_model.features(batch["image_s"])),
    ]:
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 2e-5 * np.abs(ref).max()


def test_cli_test_on_cpu(capsys):
    assert cli.main(["test", "--variant", "tiny_test", "--device", "cpu",
                     "--iterations", "2", "--batch-size", "2"]) == 0
    out = capsys.readouterr().out
    metrics = json.loads(out[out.index("{"):])
    assert {"val/loss/total", "val/loss/stereo", "val/loss/temporal",
            "val/loss/feature", "val/loss/smooth"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a GPU")
    cfg = tconfigs.tiny_test()
    for call in (
        lambda: resolve_device(None),
        lambda: DepthVO.from_random(cfg),
        lambda: tloop.make_eval_step(cfg),
        lambda: cli.main(["test", "--variant", "tiny_test", "--iterations", "1"]),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_profiling_finds_what_is_live_at_the_memory_peak():
    """The allocator history replay: the peak of allocated bytes, and the
    bytes live at its first occurrence by the innermost frame of the
    package; blocks from before the history count under their own name,
    minus those the step frees."""
    def frame(path, line):
        return [{"filename": "/x/torch/functional.py", "line": 1, "name": "f"},
                {"filename": f"/ck/depthvo_tpu_torch/{path}", "line": line, "name": "g"},
                {"filename": "/ck/depthvo_tpu_torch/utils/profiling.py", "line": 9, "name": "h"}]

    ev = [
        {"action": "alloc", "addr": 1, "size": 100, "frames": frame("train/loop.py", 7)},
        {"action": "free_requested", "addr": 99, "size": 30, "frames": []},  # from before
        {"action": "alloc", "addr": 2, "size": 50, "frames": frame("ops/warp_kernels.py", 3)},
        {"action": "free_completed", "addr": 2, "size": 50, "frames": []},  # not counted
        {"action": "alloc", "addr": 3, "size": 40, "frames": frame("train/loop.py", 7)},
        {"action": "free_requested", "addr": 2, "size": 50, "frames": []},
        {"action": "alloc", "addr": 4, "size": 60, "frames": []},
        {"action": "free_requested", "addr": 1, "size": 100, "frames": []},
    ]
    out = profiling.peak_by_site(ev, baseline=1000, top=5)
    assert out["peak_bytes"] == 1000 - 30 + 100 + 40 + 60
    assert out["live_at_peak_by_site"] == {
        "(before the step)": 970, "depthvo_tpu_torch/train/loop.py:7 g": 140,
        "(outside depthvo_tpu_torch)": 60}
    assert profiling.peak_by_site([], 10, 5) == {
        "peak_bytes": 10, "live_at_peak_by_site": {"(before the step)": 10}}


def test_profiling_sorts_kernels_and_unions_busy_time():
    assert profiling._busy_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert profiling.category(
        "void (anonymous namespace)::stereo_fwd_pyramid_kernel(SegmentTable)") == "warp_kernels"
    assert profiling.category(
        "void (anonymous namespace)::gen_fwd_pyramid_kernel<false>(SegmentTable)"
    ) == "warp_kernels"
    assert profiling.category("sm90_xmma_fprop_implicit_gemm_bf16") == "convolution"
    assert profiling.category("Memcpy HtoD (Pageable -> Device)") == "memcpy"
    assert profiling.category("ampere_bf16_s16816gemm_128x64") == "matmul"
    assert profiling.category("vectorized_elementwise_kernel") == "other"
    assert profiling.category(
        "void (anonymous namespace)::stereo_bwd_u_pyramid_kernel(SegmentTable)") == "warp_kernels"
    assert profiling.category("void stereo_bwd_src_kernel(float const*)") == "warp_kernels"
    assert profiling.category("void gen_bwd_uv_kernel(float const*)") == "warp_kernels"
    if not torch.cuda.is_available():
        for mode in ("eval", "train"):
            with pytest.raises(RuntimeError, match="GPU"):
                profiling.profile(mode, "tiny_test")
