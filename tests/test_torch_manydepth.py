"""The port's ManyDepth (``configs.manydepth``: ``models/manydepth.py``,
``ops/cost_volume.py``, ``train/manydepth.py``, the three-network train
state) held against the plain float32 reference ``references/manydepth.py``
on the CPU, at 64x128 (the cost volume at 16x32), batch 3, four scales, on
seeded random weights (the pose decoder's last bias holds a forward
motion; the trackers start at 1 and 10 and the teacher's disparity heads
are biased toward farther depths, so that the cost volume has confident
pixels and the teacher agrees with its lowest cost at some) and synthetic
scenes with frames t-1, t and t+1. The batch's
draws put row 0 under the static-camera augmentation, row 1 under the
zero cost volume and leave row 2 alone. ManyDepth is the port's alone:
nothing here is held against JAX.

Tolerances, each with its reason:

* the cost volume, 1e-5 of the volume's scale, the confidence exactly,
  and the lowest cost's bin a minimum of the reference's volume to within
  that: ``cost_volume_plain`` takes the geometry term by term and the
  bilinear sample as ``grid_sample`` forms it, the reference takes matrix
  products and ``grid_sample``, so two bins whose costs tie to a rounding
  (the static-camera row has such) may swap;
* loss terms, 2e-5 relative: Monodepth2's bar (the networks' float32
  order of operations through the warps, SSIM and the means); the
  tie-breaking noise is drawn from one seeded CPU generator on both sides;
  the multi-frame net's reprojection terms 1e-4: each is a mean over the
  few pixels under the matching mask (some thirty here), where the SSIM's
  per-pixel gaps of up to some 5e-5 do not average out;
* first gradients, 2e-4 relative per leaf (the repo's bar); BatchNorm
  statistics, 2e-5;
* the trackers after two steps, 1e-6 relative: they move by 1% of the
  teacher's depth range a step.

Two steps through ``fit(steps_per_call=2)`` equal two single steps bit for
bit, and a checkpoint of ``cli train`` restores all three networks and
both trackers.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from depthvo_tpu_torch import cli as tcli, configs as tconfigs
from depthvo_tpu_torch.data import kitti as tkitti
from depthvo_tpu_torch.data.synthetic import SyntheticScenes
from depthvo_tpu_torch.geometry import monodepth2 as tgeo
from depthvo_tpu_torch.geometry.se3 import _matmul
from depthvo_tpu_torch.io import checkpoint as ckpt_io
from depthvo_tpu_torch.ops import cost_volume as tcv
from depthvo_tpu_torch.train import loop as tloop, manydepth as tmf, state as tstate
from depthvo_tpu_torch.utils import spans

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
from references import manydepth as ref  # noqa: E402

H, W, BATCH = 64, 128, 3
AUG_U = (0.1, 0.3, 0.7)  # static camera, zero cost volume, neither
LOSS_RTOL = 2e-5
GRAD_RTOL = 2e-4
STAT_RTOL = 2e-5
CV_RTOL = 1e-5
TRACKER_RTOL = 1e-6
POSE_BIAS = [0.0, 0.0, 0.0, 0.0, 0.0, 10.0] * 2  # x 0.01: 0.1 forward, both frames
TRACKERS = (1.0, 10.0)
TEACHER_HEAD_BIAS = -1.0  # sigmoid(-1) = 0.27: depths near 0.4
MASKED_RTOL = 1e-4


def _cfg(batch_size=BATCH):
    model = tconfigs.ModelConfig(height=H, width=W, num_scales=4, max_disp=9.99, min_disp=0.01,
                                 s2d_finest=False, compute_dtype="float32")
    return tconfigs.manydepth(batch_size=batch_size, model=model)


def _params(seed=3):
    """Every parameter and buffer of ``ref.specs()``, seeded; the trackers
    at :data:`TRACKERS`, the teacher's disparity heads biased by
    :data:`TEACHER_HEAD_BIAS`."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, kind in ref.specs():
        z = torch.randn(shape, generator=g)
        if kind == "conv":
            v = z * max(1, z.numel() // shape[0]) ** -0.5
        elif kind == "bias":
            v = 0.02 * z
        elif kind == "pose":
            v = 0.02 * z + torch.tensor(POSE_BIAS)
        elif kind == "bn_scale":
            v = 1.0 + 0.1 * z
        elif kind in ("bn_bias", "bn_mean"):
            v = 0.1 * z
        elif kind == "bn_var":
            v = 0.5 + torch.rand(shape, generator=g)
        elif kind == "tracker":
            v = torch.tensor(TRACKERS[name.endswith("max_depth_bin")], dtype=torch.float64)
        else:
            v = torch.zeros((), dtype=torch.int64)
        if name.startswith("teacher.decoder.decoder.1") and name.endswith("conv.bias"):
            v = v + TEACHER_HEAD_BIAS  # the heads, decoder.10 to decoder.13
        out[name] = v
    return out


def _models(cfg, params):
    per = {"depth": {}, "odom": {}, "teacher": {}}
    for key, value in params.items():
        net, name = key.split(".", 1)
        per[net][name] = value.clone()
    return tstate.load_params(tstate.build_models(cfg), per, torch.device("cpu"))


def _batch(cfg, seed=5):
    b = {k: torch.from_numpy(v)
         for k, v in SyntheticScenes(cfg, seed=seed, u8=True).fixed_batch(BATCH).items()}
    b["aug_u"] = torch.tensor(AUG_U, dtype=torch.float32)
    return b


def _noise(seed=9):
    return torch.Generator().manual_seed(seed)


def _rel(a, b):
    a, b = torch.as_tensor(a).detach().double(), torch.as_tensor(b).detach().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _reference(cfg, params, batch, train=True, seed=9):
    p = {k: v.clone().requires_grad_(kind in ref.TRAINABLE_KINDS)
         for (k, _, kind), v in zip(ref.specs(), params.values()) if kind != "tracker"}
    stats = {k: v.clone() for k, v in params.items() if "running" in k}
    trackers = {"min": float(params["depth.encoder.min_depth_bin"]),
                "max": float(params["depth.encoder.max_depth_bin"])}
    g = _noise(seed)
    total, terms, _ = ref.forward(p, stats, trackers, batch,
                                  ref.options(tconfigs.base.to_dict(cfg)),
                                  lambda shape: torch.randn(shape, generator=g), train)
    return total, terms, p, stats, trackers


def _port(cfg, params, batch, train=True, seed=9):
    models = _models(cfg, params)
    g = _noise(seed)
    total, metrics = tmf.compute_losses(cfg, models, batch, train,
                                        noise=lambda shape, like: torch.randn(shape, generator=g))
    return total, metrics, models


@pytest.fixture(scope="module")
def step():
    """One train-mode forward and backward of the port and the reference."""
    cfg = _cfg()
    params, batch = _params(), _batch(cfg)
    total, metrics, models = _port(cfg, params, batch)
    total.backward()
    rtotal, terms, p, stats, trackers = _reference(cfg, params, batch)
    rtotal.backward()
    return cfg, params, batch, metrics, models, terms, p, stats, trackers


def test_reference_layout_is_the_ports_state_dict():
    models = tstate.build_models(_cfg())
    sd = {f"{net}.{k}": v for net in ("depth", "odom", "teacher")
          for k, v in getattr(models, net).state_dict().items()}
    assert [(n, tuple(s)) for n, s, _ in ref.specs()] == [(k, tuple(v.shape))
                                                          for k, v in sd.items()]
    assert list(tstate.param_tree(models)) == [n for n, _, k in ref.specs()
                                               if k in ref.TRAINABLE_KINDS]


def test_loss_terms_and_shares_equal_the_reference(step):
    _, _, _, metrics, _, terms, _, _, _ = step
    assert metrics["mf/static_rows"] == 1 and metrics["mf/zero_cv_rows"] == 1
    for k, v in terms.items():
        assert k in metrics, k
        assert _rel(metrics[k], v) < _rtol(k), (k, float(metrics[k]), float(v))
    assert 0.0 < float(metrics["mf/confident_share"]) < 1.0
    assert 2 / 3 < float(metrics["mf/consistency_share"]) < 1.0


def _rtol(term):
    return MASKED_RTOL if term.startswith("loss/reproj/") else LOSS_RTOL


def test_gradients_of_all_three_nets_equal_the_reference(step):
    _, _, _, _, models, _, p, _, _ = step
    got = tstate.param_tree(models)
    assert {k.split(".")[0] for k in got} == {"depth", "odom", "teacher"}
    for k, v in got.items():
        assert v.grad is not None and p[k].grad is not None, k
        assert _rel(v.grad, p[k].grad) < GRAD_RTOL, k


def test_batch_norm_statistics_after_the_extra_passes_equal_the_reference(step):
    _, params, _, _, models, _, _, stats, trackers = step
    moved = 0
    for k, want in stats.items():
        net, name = k.split(".", 1)
        got = getattr(models, net).state_dict()[name]
        assert _rel(got, want) < STAT_RTOL, k
        moved += not torch.equal(want, params[k])
    assert moved == len(stats)
    enc = models.depth.encoder
    assert float(enc.min_depth_bin) == pytest.approx(trackers["min"], rel=TRACKER_RTOL)
    assert float(enc.max_depth_bin) == pytest.approx(trackers["max"], rel=TRACKER_RTOL)


def test_trackers_after_two_steps_equal_the_reference():
    cfg = _cfg()
    params, batch = _params(), _batch(cfg)
    trainer = ref.Trainer(tconfigs.base.to_dict(cfg), params, noise_seed=9)
    models = _models(cfg, params)
    state = tstate.TrainState(0, models.train(), tstate.make_optimizer(cfg).init(
        tstate.param_tree(models)))
    step_fn = tloop.make_train_step(cfg, device="cpu")
    for _ in range(2):
        trainer.step(batch)
        state, _ = step_fn(state, batch)
    enc = state.models.depth.encoder
    assert (trainer.trackers["min"], trainer.trackers["max"]) != TRACKERS
    assert float(enc.min_depth_bin) == pytest.approx(trainer.trackers["min"], rel=TRACKER_RTOL)
    assert float(enc.max_depth_bin) == pytest.approx(trainer.trackers["max"], rel=TRACKER_RTOL)


def _pose(tx, ty, tz, yaw=0.02):
    T = torch.eye(4)
    T[0, 0] = T[2, 2] = float(np.cos(yaw))
    T[0, 2], T[2, 0] = float(np.sin(yaw)), -float(np.sin(yaw))
    T[:3, 3] = torch.tensor([tx, ty, tz])
    return T


def test_cost_volume_plain_equals_the_references_match_features():
    """Rows: a moving camera; a zero pose; samples that all leave the image
    (missing to max = 0); a static camera (the lookup is the current map)."""
    cfg = _cfg()
    h, w = H // 4, W // 4
    g = torch.Generator().manual_seed(11)
    cur = torch.rand(4, 64, h, w, generator=g)
    look = torch.rand(4, 64, h, w, generator=g)
    look[3] = cur[3]
    T = torch.stack([_pose(0.05, 0.0, -0.3), torch.zeros(4, 4), _pose(1e3, 0.0, 0.0),
                     _pose(0.05, 0.0, -0.3)])
    K = torch.from_numpy(SyntheticScenes(cfg, seed=1, u8=True).K)[None].repeat(4, 1, 1)
    Kq = torch.cat([K[:, :2] / 4, K[:, 2:]], 1)
    bins = torch.from_numpy(np.linspace(0.1, 10.0, 96)).float()
    rays = tgeo.pixel_rays(Kq, h, w)
    P = _matmul(tgeo.homogeneous_K(Kq), T)[:, :3].contiguous()
    volume, conf, lowest = tcv.cost_volume_plain(cur, look, rays, P, bins, T.flatten(1).sum(1) != 0)

    K4 = torch.zeros(4, 4, 4)
    K4[:, :3, :3] = Kq
    K4[:, 3, 3] = 1
    warp_depths = torch.stack([torch.ones((1, h, w)) * d for d in bins], 0)
    rv, missing = ref.match_features(cur, look[:, None], T[:, None], K4,
                                     torch.linalg.inv(K4.double()).float(), warp_depths)
    rconf, rlowest, rvolume = ref.lowest_cost_and_volume(rv, missing, bins)
    scale = float(rvolume.abs().max())
    assert torch.equal(conf, rconf)
    assert float((volume - rvolume).abs().max()) < CV_RTOL * scale
    viz = torch.where(rv == 0, torch.full_like(rv, 100.0), rv)
    picked = torch.argmax(((1 / bins).view(1, -1, 1, 1) == lowest[:, None]).int(), 1)
    at = torch.gather(viz, 1, picked[:, None])[:, 0]
    assert float((at - viz.amin(1)).abs().max()) < CV_RTOL * scale
    assert float((lowest != rlowest).float().mean()) < 0.01
    assert 0.0 < float(conf[0].mean()) < 1.0 and float(conf[3].mean()) > 0.0
    for row in (1, 2):  # every bin missing: no confidence, the first bin
        assert not conf[row].any() and not volume[row].any()
        assert torch.equal(lowest[row], torch.full_like(lowest[row], 1 / bins[0]))


def test_a_zero_lookup_image_gets_a_zero_pose():
    """Eval mode (no augmentation) with row 1's frame t-1 all zero: that
    row's matching pose is zero, so none of its pixels is confident."""
    cfg = _cfg()
    params, batch = _params(), _batch(cfg)
    batch["image_p"][1] = 0
    with torch.no_grad():
        _, metrics, models = _port(cfg, params, batch, train=False)
        _, terms, _, _, _ = _reference(cfg, params, batch, train=False)
        conf = models.depth.encoder
    for k, v in terms.items():
        assert _rel(metrics[k], v) < _rtol(k), k
    assert float(metrics["mf/confident_share"]) <= 2 / 3
    assert (float(conf.min_depth_bin), float(conf.max_depth_bin)) == TRACKERS


def test_the_match_is_a_span_inside_the_loss():
    cfg = _cfg()
    spans.enable()
    spans.reset()
    try:
        with torch.no_grad():
            _port(cfg, _params(), _batch(cfg))
        names = [n for n, _, _ in spans.RECORDS]
    finally:
        spans.enable(False)
        spans.reset()
    assert names == ["mf.match", "mf.loss"]


def test_fit_with_two_steps_a_call_equals_two_single_steps():
    cfg = _cfg()
    params, batch = _params(), {k: v.numpy() for k, v in _batch(cfg).items()}

    def fresh():
        models = _models(cfg, params)
        return tstate.TrainState(0, models.train(), tstate.make_optimizer(cfg).init(
            tstate.param_tree(models)))

    torch.manual_seed(0)
    single = fresh()
    step_fn = tloop.make_train_step(cfg, device="cpu")
    for _ in range(2):
        single, _ = step_fn(single, batch)
    torch.manual_seed(0)
    scanned = tloop.fit(cfg, iter([batch] * 2), 2, state=fresh(), steps_per_call=2,
                        prefetch=0, device="cpu")
    assert scanned.step == single.step == 2
    for net in ("depth", "odom", "teacher"):
        a = getattr(single.models, net).state_dict()
        b = getattr(scanned.models, net).state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), (net, k)


@pytest.fixture
def ckpt_dir(tmp_path):
    yield str(tmp_path)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_a_cli_checkpoint_restores_all_three_nets_and_both_trackers(ckpt_dir):
    assert tcli.main(["train", "--variant", "manydepth", "--device", "cpu", "--height", str(H),
                      "--width", str(W), "--batch-size", str(BATCH), "--steps", "2",
                      "--log-every", "1", "--checkpoint-dir", ckpt_dir]) == 0
    cfg = tconfigs.base.load_json(os.path.join(ckpt_dir, "config.json"))
    assert cfg.architecture == "manydepth"
    state = tstate.create_state(cfg, torch.device("cpu"))
    saved = ckpt_io.read_weights(ckpt_dir)
    assert sorted(saved) == ["depth", "odom", "teacher"]
    assert float(saved["depth"]["encoder.min_depth_bin"]) != 0.1
    assert float(saved["depth"]["encoder.max_depth_bin"]) != 10.0
    state = ckpt_io.maybe_restore(ckpt_io.make_manager(ckpt_dir), state, cfg)
    assert state.step == 2
    for net, sd in saved.items():
        got = getattr(state.models, net).state_dict()
        assert sorted(got) == sorted(sd)
        for k, v in sd.items():
            assert torch.equal(got[k].cpu(), v), (net, k)
    assert state.models.depth.encoder.min_depth_bin.dtype == torch.float64


def test_the_config_and_its_batches():
    cfg = tconfigs.manydepth()
    assert (cfg.model.height, cfg.model.width, cfg.batch_size) == (320, 1024, 12)
    enc = tstate.build_models(cfg).depth.encoder
    assert (enc.num_depth_bins, float(enc.min_depth_bin), float(enc.max_depth_bin)) == (
        96, 0.1, 10.0)
    assert cfg.use_temporal and not cfg.use_stereo and cfg.optim.learning_rate == 1e-4
    assert tconfigs.base.from_dict(tconfigs.base.to_dict(cfg)) == cfg
    assert "manydepth" in tconfigs.VARIANTS
    b = SyntheticScenes(_cfg(), seed=2, u8=True)
    first, again = b.fixed_batch(BATCH), b.fixed_batch(BATCH)
    assert "image_p" in first and first["aug_u"].dtype == np.float32
    np.testing.assert_array_equal(first["aug_u"], again["aug_u"])
    drawn = b.batch(BATCH)["aug_u"]
    assert drawn.shape == (BATCH,) and ((drawn >= 0) & (drawn < 1)).all()


@pytest.fixture(scope="module")
def raw_drive(tmp_path_factory):
    """One KITTI raw drive of 6 frames a camera at 40x128, each frame a
    constant code."""
    from PIL import Image

    root = str(tmp_path_factory.mktemp("kitti_mf"))
    date, drive = "2011_09_26", "2011_09_26_drive_0001_sync"
    for cam, base in (("image_02", 10), ("image_03", 100)):
        os.makedirs(os.path.join(root, date, drive, cam, "data"))
        for i in range(6):
            Image.fromarray(np.full((40, 128, 3), base + 10 * i, np.uint8)).save(
                os.path.join(root, date, drive, cam, "data", f"{i:010d}.png"))
    with open(os.path.join(root, date, "calib_cam_to_cam.txt"), "w") as f:
        f.write("P_rect_02: 7.2e+02 0.0 6.0e+02 4.5e+01 0.0 7.2e+02 1.8e+02 0.0 0.0 0.0 1.0 0.0\n")
    yield root, drive
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("ring", [False, True], ids=["python", "native_ring"])
def test_kitti_raw_draws_a_float_a_row_from_the_seed(raw_drive, ring):
    root, drive = raw_drive
    ds = tkitti.KittiRawStereo(root, [drive], 16, 48, u8=True, prev=True, aug_draws=True)
    draws = []
    for seed in (3, 3, 4):
        it = ds.iterator(2, seed=seed, native_ring=ring)
        b = [next(it) for _ in range(2)]
        it.close()
        assert sorted(b[0]) == ["K", "aug_u", "baseline", "image_p", "image_r", "image_s",
                                "image_t"]
        draws.append(np.stack([x["aug_u"] for x in b]))
    assert draws[0].dtype == np.float32 and draws[0].shape == (2, 2)
    assert ((draws[0] >= 0) & (draws[0] < 1)).all()
    np.testing.assert_array_equal(draws[0], draws[1])
    assert not np.array_equal(draws[0], draws[2])
