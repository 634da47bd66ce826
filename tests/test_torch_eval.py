"""The port's eval runner (``eval/``, ``data/velodyne.py``,
``data/eigen.py::prep_eigen`` and the commands ``eval-depth``,
``eval-odom``, ``infer`` and ``prep-eigen``), held against the JAX
package on the same inputs, on the CPU.

* The numpy parts (depth metrics, odometry errors and ATE, trajectories,
  the velodyne projection, ``prep_eigen``) are the reference's operations
  in the reference's order: equal results.
* The resize to the ground truth is Pillow's float bilinear resample
  without Pillow: equal to Pillow at KITTI's sizes and at downscales.
* ``run_depth_eval`` on a synthetic Eigen tree (3 frames, as
  tests/test_eval_runner.py builds it) with the same weights in both
  packages: the continuous metrics within 1e-4 relative, the threshold
  fractions a1..a3 within one pixel per frame (1/n_valid: a pixel on a
  1.25^k boundary may fall either way between two float32 networks). The
  saved-prediction path (no model) is equal; the SHA pin and the
  non-canonical warning behave as the reference's.
* ``run_odometry_eval``: the model's trajectory within 1e-4 of the
  reference's translations; the pose-file path equal.
* The trees live in directories that are deleted at teardown.
"""

import hashlib
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from depthvo_tpu import api as japi, configs as jconfigs
from depthvo_tpu.data import eigen as jeigen, velodyne as jvelo
from depthvo_tpu.eval import depth_metrics as jmetrics, odometry as jodom
from depthvo_tpu.eval import runner as jrunner
from depthvo_tpu_torch import api as tapi, cli as tcli, configs as tconfigs
from depthvo_tpu_torch.data import eigen as teigen, velodyne as tvelo
from depthvo_tpu_torch.eval import depth_metrics as tmetrics, odometry as todom
from depthvo_tpu_torch.eval import runner as trunner
from depthvo_tpu_torch.eval.resize import resize_bilinear_f32
from depthvo_tpu_torch.train import state as tstate
from test_torch_checkpoint import _to_flax

torch.set_num_threads(2)
torch.exp(torch.zeros(1))  # MKL's first call on one thread (test_torch_models.py)

CPU = torch.device("cpu")
RTOL = 1e-4
CONTINUOUS = ("abs_rel", "sq_rel", "rmse", "rmse_log")
THRESHOLDS = ("a1", "a2", "a3")
MOTION_BIAS = np.array([2.0, -1.0, -30.0, 0.2, -0.3, 0.1], np.float32)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, deleted at teardown."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def tmp_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def models():
    """The same tiny_test weights (the port's initial draw, a real motion
    in the odometry net) in both packages: (port, reference)."""
    tcfg, jcfg = tconfigs.tiny_test(), jconfigs.tiny_test()
    state = tstate.create_state(tcfg, CPU, torch.Generator().manual_seed(21))
    params, stats = _to_flax(state.models)
    params["odom"]["Dense_2"]["bias"] = MOTION_BIAS
    tmodel = tapi.DepthVO.from_jax_params(tcfg, params, stats, device="cpu")
    jmodel = japi.DepthVO(jcfg, jax.tree.map(jnp.asarray, params),
                          jax.tree.map(jnp.asarray, stats))
    return tmodel, jmodel


def _threshold_tol(gts, max_depth=80.0):
    """One pixel per frame: the mean over frames of 1 / n_valid."""
    inv = []
    for gt in gts:
        valid = (gt > 1e-3) & (gt < max_depth) & tmetrics.eigen_crop_mask(*gt.shape)
        inv.append(1.0 / valid.sum())
    return float(np.mean(inv))


def _same_metrics(got, ref, gts):
    for k in CONTINUOUS:
        assert abs(got[k] - ref[k]) <= RTOL * abs(ref[k]), (k, got[k], ref[k])
    tol = _threshold_tol(gts)
    for k in THRESHOLDS:
        assert abs(got[k] - ref[k]) <= tol, (k, got[k], ref[k], tol)


# --------------------------------------------------------------------------
# The numpy parts: equal to the reference's.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("median_scale,crop,max_depth", [
    (True, True, 80.0), (False, True, 80.0), (True, False, 80.0), (True, True, 50.0)])
def test_depth_metrics_equal_the_references(median_scale, crop, max_depth):
    rng = np.random.default_rng(1)
    gts = [rng.uniform(1.0, 90.0, (37, 121)).astype(np.float32) for _ in range(3)]
    for g in gts:
        g[:10] = 0.0
    preds = [(g + rng.normal(0, 3.0, g.shape)).clip(0.5).astype(np.float32) * 0.7
             for g in gts]
    kw = dict(max_depth=max_depth, median_scale=median_scale, crop=crop)
    got = tmetrics.compute_depth_metrics(preds, gts, **kw)
    assert got == jmetrics.compute_depth_metrics(preds, gts, **kw)
    assert list(got) == list(tmetrics.DEPTH_METRIC_NAMES) == list(jmetrics.DEPTH_METRIC_NAMES)
    np.testing.assert_array_equal(tmetrics.eigen_crop_mask(375, 1242),
                                  jmetrics.eigen_crop_mask(375, 1242))


def _curved_poses(n, step=1.7, seed=2):
    """Cam-to-world poses along a curving, climbing path (~n * step m)."""
    rng = np.random.default_rng(seed)
    poses, T = [np.eye(4)], np.eye(4)
    for _ in range(n):
        a, b = rng.normal(0, 0.02, 2)
        d = np.eye(4)
        d[0, 0] = d[2, 2] = np.cos(a)
        d[0, 2], d[2, 0] = np.sin(a), -np.sin(a)
        d[1, 3], d[2, 3] = b, step
        T = T @ d
        poses.append(T.copy())
    return np.asarray(poses)


@pytest.mark.parametrize("fn", ["compose_trajectory", "align_scale", "ate", "snippet_ate",
                                "snippet_ate_umeyama", "kitti_odometry_errors"])
def test_odometry_functions_equal_the_references(fn):
    gt = _curved_poses(150)
    noisy = gt.copy()
    noisy[:, :3, 3] += np.random.default_rng(3).normal(0, 0.3, (len(gt), 3)).cumsum(0) * 0.1
    if fn == "compose_trajectory":
        rel = np.linalg.inv(noisy[1:]) @ noisy[:-1]  # frame i -> i+1 coordinates
        args = (rel,)
    else:
        args = (noisy, gt)
    got, ref = getattr(todom, fn)(*args), getattr(jodom, fn)(*args)
    if isinstance(ref, dict):
        assert got == ref and len(ref) > 1
        if fn == "kitti_odometry_errors":
            assert np.isfinite(ref["t_err_pct"])
    else:
        np.testing.assert_array_equal(got, ref)


def test_pose_files_round_trip_between_packages(tmp_path):
    poses = _curved_poses(12)
    todom.write_kitti_poses(poses, str(tmp_path / "t.txt"))
    jodom.write_kitti_poses(poses, str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    np.testing.assert_array_equal(todom.read_kitti_poses(str(tmp_path / "t.txt")),
                                  jodom.read_kitti_poses(str(tmp_path / "t.txt")))


# The velodyne fixture of tests/test_velodyne_eigen.py: velodyne (x fwd,
# y left, z up) -> camera (x right, y down, z fwd), a small lever arm.
R_VELO2CAM = np.array([[0.0, -1, 0], [0, 0, -1], [1, 0, 0]])
T_VELO2CAM = np.array([0.05, -0.08, -0.27])
FX, FY, CX, CY = 100.0, 90.0, 64.0, 20.0
VH, VW = 40, 128


def _projection(velo_mod):
    cam2cam = {"R_rect_00": np.eye(3).reshape(-1),
               "P_rect_02": np.array([[FX, 0, CX, 0], [0, FY, CY, 0], [0, 0, 1, 0]]).reshape(-1)}
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R_VELO2CAM, T_VELO2CAM
    return velo_mod.velo_to_image_projection(cam2cam, T)


def _velo_at(pixels):
    """Velodyne points that project to protocol pixels (pu, pv) at depth z
    (the protocol takes round(u) - 1, so u = pu + 1)."""
    cam = np.array([[(pu + 1 - CX) * z / FX, (pv + 1 - CY) * z / FY, z] for pu, pv, z in pixels])
    velo = (cam - T_VELO2CAM) @ R_VELO2CAM
    return np.concatenate([velo, np.ones((len(velo), 1))], axis=1).astype(np.float32)


@pytest.mark.parametrize("case", ["offset", "duplicates", "behind", "random"])
def test_depth_map_from_velo_equals_the_references(case):
    if case == "offset":  # each point on its protocol pixel, one pixel left/up of round(u)
        velo = _velo_at([(10, 5, 7.0), (100, 30, 23.5), (64, 20, 4.25)])
    elif case == "duplicates":  # three hits on one pixel: the nearest wins
        velo = _velo_at([(50, 15, 31.0), (50, 15, 6.0), (50, 15, 18.0)])
    elif case == "behind":
        velo = _velo_at([(50, 15, 5.0), (20, 10, 9.0)])
        velo[0, 0] *= -1
    else:
        rng = np.random.default_rng(4)
        velo = np.concatenate([rng.uniform([-20, -30, -3], [80, 30, 3], (4000, 3)),
                               rng.uniform(0, 1, (4000, 1))], axis=1).astype(np.float32)
    P = _projection(tvelo)
    np.testing.assert_array_equal(P, _projection(jvelo))
    got = tvelo.depth_map_from_velo(velo, P, (VH, VW))
    np.testing.assert_array_equal(got, jvelo.depth_map_from_velo(velo, P, (VH, VW)))
    if case == "offset":
        assert got[5, 10] == pytest.approx(7.0, rel=1e-5) and int((got > 0).sum()) == 3
    elif case == "duplicates":
        assert got[15, 50] == pytest.approx(6.0, rel=1e-5) and int((got > 0).sum()) == 1
    elif case == "behind":
        assert int((got > 0).sum()) == 1 and got[10, 20] > 0
    else:
        assert (got > 0).sum() > 100


@pytest.fixture(scope="module")
def velo_tree(tmp_dir):
    """A raw drive with 3 frames at 128x40, velodyne scans and both
    calibration files (tests/test_velodyne_eigen.py's fixture)."""
    root = str(tmp_dir / "kitti_velo")
    date, drive = "2011_09_26", "2011_09_26_drive_0002_sync"
    ddir = os.path.join(root, date, drive)
    rng = np.random.default_rng(5)
    for i in range(3):
        path = os.path.join(ddir, "image_02", "data", f"{i:010d}.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (VH, VW, 3), dtype=np.uint8)).save(path)
        velo = _velo_at([(pu, pv, 4.0 + (pu + pv + i) % 26)
                         for pu in range(8, VW - 8, 8) for pv in range(8, VH - 4, 4)])
        vpath = os.path.join(ddir, "velodyne_points", "data", f"{i:010d}.bin")
        os.makedirs(os.path.dirname(vpath), exist_ok=True)
        velo.tofile(vpath)
    P = f"{FX} 0.0 {CX} 0.0 0.0 {FY} {CY} 0.0 0.0 0.0 1.0 0.0"
    with open(os.path.join(root, date, "calib_cam_to_cam.txt"), "w") as f:
        f.write(f"R_rect_00: 1 0 0 0 1 0 0 0 1\nP_rect_02: {P}\n")
    with open(os.path.join(root, date, "calib_velo_to_cam.txt"), "w") as f:
        f.write("R: " + " ".join(str(x) for x in R_VELO2CAM.reshape(-1)) + "\n")
        f.write("T: " + " ".join(str(x) for x in T_VELO2CAM) + "\n")
    return root, drive


@pytest.mark.parametrize("how", ["scenes", "split_file", "cli"])
def test_prep_eigen_equals_the_references(velo_tree, tmp_path, how, capsys):
    root, drive = velo_tree
    kw = dict(scenes=[drive])
    if how == "split_file":
        split = tmp_path / "split.txt"
        split.write_text(f"2011_09_26/{drive} 2 l\n2011_09_26/{drive} 0 l\n")
        kw = dict(split_file=str(split))
    outs = {"port": str(tmp_path / "port"), "ref": str(tmp_path / "ref")}
    if how == "cli":
        assert tcli.main(["prep-eigen", "--kitti-root", root, "--output-dir", outs["port"],
                          "--scenes", drive]) == 0
        assert "wrote 3 gt depth maps" in capsys.readouterr().out
    else:
        assert teigen.prep_eigen(root, outs["port"], **kw)[0] == (2 if kw.get("split_file") else 3)
    jeigen.prep_eigen(root, outs["ref"], **kw)
    lines = {who: open(os.path.join(d, "eigen_list.txt")).read().splitlines()
             for who, d in outs.items()}
    assert lines["port"][0] == lines["ref"][0]
    assert lines["port"][0] in ("# split-source: derived-scene-list",
                                "# split-source: canonical split.txt")
    assert len(lines["port"]) == len(lines["ref"]) > 1
    for a, b in zip(lines["port"][1:], lines["ref"][1:]):
        (img_a, gt_a), (img_b, gt_b) = a.split(), b.split()
        assert img_a == img_b and os.path.basename(gt_a) == os.path.basename(gt_b)
        np.testing.assert_array_equal(np.load(gt_a), np.load(gt_b))


# --------------------------------------------------------------------------
# The resize to the ground truth, against Pillow.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [
    ((160, 608), (375, 1242)), ((160, 608), (370, 1226)), ((375, 1242), (160, 608)),
    ((160, 608), (47, 101)), ((32, 96), (32, 96)), ((33, 50), (100, 17)),
])
def test_resize_to_gt_equals_pillow(src, dst):
    p = np.random.default_rng(6).uniform(1.0, 80.0, src).astype(np.float32)
    ref = np.asarray(Image.fromarray(p, mode="F").resize(dst[::-1], Image.BILINEAR))
    got = resize_bilinear_f32(p, *dst)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


# --------------------------------------------------------------------------
# The depth eval end to end.
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def eigen_tree(tmp_dir):
    """3 frames at 1242x375 and their ground truth, with sky rows empty
    (tests/test_eval_runner.py's tree)."""
    root = str(tmp_dir / "eigen")
    rng = np.random.default_rng(0)
    lines = []
    for i in range(3):
        img_rel, gt_rel = f"imgs/{i:06d}.png", f"gt/{i:06d}.npy"
        for rel in (img_rel, gt_rel):
            os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (375, 1242, 3), dtype=np.uint8)).save(
            os.path.join(root, img_rel))
        gt = rng.uniform(1.0, 70.0, size=(375, 1242)).astype(np.float32)
        gt[:150] = 0.0
        np.save(os.path.join(root, gt_rel), gt)
        lines.append(f"{img_rel} {gt_rel}")
    split = os.path.join(root, "eigen_test.txt")
    with open(split, "w") as f:
        f.write("\n".join(lines) + "\n")
    gts = [np.load(os.path.join(root, ln.split()[1])) for ln in lines]
    return root, split, gts


@pytest.fixture(scope="module")
def depth_evals(models, eigen_tree, tmp_dir):
    """Both packages' ``run_depth_eval`` of the same weights, batch 2 (a
    padded tail), the port's predictions saved."""
    tmodel, jmodel = models
    root, split, _ = eigen_tree
    preds = str(tmp_dir / "preds")
    kw = dict(checkpoint_dir=None, kitti_root=root, split_file=split, height=32, width=96,
              batch_size=2)
    with pytest.warns(UserWarning, match="NON-CANONICAL"):
        got = trunner.run_depth_eval(model=tmodel, save_preds_dir=preds, **kw)
    with pytest.warns(UserWarning, match="NON-CANONICAL"):
        ref = jrunner.run_depth_eval(model=jmodel, **kw)
    return got, ref, preds


def test_run_depth_eval_matches_the_reference(depth_evals, eigen_tree):
    got, ref, _ = depth_evals
    _same_metrics(got, ref, eigen_tree[2])
    assert got["split"] == ref["split"]
    assert got["quant"] == ref["quant"] == "off"
    assert got["split"]["canonical"] is False and got["split"]["n_frames"] == 3


def _per_frame_dir(stack, path, inverse=False):
    """frame_0 .. frame_N written unpadded, so that a lexicographic order
    would put frame_10 before frame_2."""
    os.makedirs(path)
    for i, p in enumerate(stack):
        np.save(os.path.join(path, f"frame_{i}.npy"), 1.0 / np.maximum(p, 1e-6) if inverse else p)


@pytest.mark.parametrize("form", ["stack", "directory", "frames", "npz", "inverse"])
def test_saved_predictions_match_the_reference(depth_evals, eigen_tree, tmp_path, form):
    """The metric pass alone (no model, no device): the same table as the
    reference's on the same files, and the live run's table for the
    port's own saved stack."""
    got_live, _, preds = depth_evals
    root, split, gts = eigen_tree
    stack = np.load(os.path.join(preds, "depth_predictions.npy"))
    assert stack.shape == (3, 32, 96)
    inverse = form == "inverse"
    if form == "stack":
        path = os.path.join(preds, "depth_predictions.npy")
    elif form == "directory":
        path = preds
    elif form == "npz":
        path = str(tmp_path / "p.npz")
        np.savez(path, depth=stack)
    else:
        path = str(tmp_path / "frames")
        _per_frame_dir(stack, path, inverse)
    kw = dict(checkpoint_dir=None, kitti_root=root, split_file=split, pred_path=path,
              pred_inverse=inverse)
    with pytest.warns(UserWarning, match="NON-CANONICAL"):
        got = trunner.run_depth_eval(**kw)
    with pytest.warns(UserWarning, match="NON-CANONICAL"):
        ref = jrunner.run_depth_eval(**kw)
    assert got == ref
    assert got["quant"] == "external" and got["split"]["pred_inverse"] is inverse
    _same_metrics(got, got_live, gts)


def test_saved_frames_are_read_in_natural_order(tmp_path):
    path = str(tmp_path / "frames")
    _per_frame_dir(np.arange(12, dtype=np.float32)[:, None, None] * np.ones((12, 2, 2)), path)
    frames = trunner._load_saved_predictions(path)
    assert [float(f[0, 0]) for f in frames] == list(range(12))


def test_split_sha_pins_and_refuses(eigen_tree, tmp_path):
    root, split, _ = eigen_tree
    digest = hashlib.sha256(open(split, "rb").read()).hexdigest()
    preds = str(tmp_path / "p.npy")
    np.save(preds, np.full((3, 24, 80), 10.0, np.float32))
    kw = dict(checkpoint_dir=None, kitti_root=root, split_file=split, pred_path=preds)
    with pytest.warns(UserWarning, match="NON-CANONICAL"):
        pinned = trunner.run_depth_eval(split_sha=digest.upper(), **kw)
    assert pinned["split"]["sha256"] == digest and pinned["split"]["pinned"] is True
    for mod in (trunner, jrunner):
        with pytest.raises(ValueError, match="does not match the pinned"):
            mod.run_depth_eval(split_sha="0" * 64, **kw)


def test_predict_depths_keeps_frame_order_and_pads_the_tail(models, monkeypatch):
    """7 frames in batches of 3: every forward sees 3 frames (the tail is
    padded by repeating its last frame), results come back in frame
    order, with a postprocess too and with only 2 batches in flight."""
    tmodel, _ = models
    frames = np.random.default_rng(7).integers(0, 256, (7, 32, 96, 3), dtype=np.uint8)
    seen = []
    hook = tmodel.models.depth.register_forward_pre_hook(lambda m, a: seen.append(a[0].shape[0]))
    try:
        plain = trunner.predict_depths(tmodel, frames, batch_size=3)
        monkeypatch.setattr(trunner, "MAX_IN_FLIGHT", 2)
        posted = trunner.predict_depths(tmodel, frames, batch_size=3,
                                        postprocess=lambda i, p: (i, p * 2.0))
    finally:
        hook.remove()
    assert seen == [3] * 6
    assert plain.shape == (7, 32, 96)
    assert [i for i, _ in posted] == list(range(7))
    np.testing.assert_array_equal(np.stack([p for _, p in posted]), plain * 2.0)
    np.testing.assert_allclose(plain[6:], tmodel.depth(np.repeat(frames[6:], 3, 0))[:1],
                               rtol=1e-6)
    np.testing.assert_allclose(plain, tmodel.depth(frames), rtol=2e-5)
    with pytest.raises(NotImplementedError, match="A.8"):
        trunner.predict_depths(tmodel, frames, mesh=object())


# --------------------------------------------------------------------------
# The odometry eval.
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def odom_tree(tmp_dir):
    """Sequence 09: 6 frames at 128x40, calib.txt and ground-truth poses."""
    root = str(tmp_dir / "odom")
    rng = np.random.default_rng(8)
    seq_dir = os.path.join(root, "sequences", "09")
    os.makedirs(os.path.join(seq_dir, "image_2"))
    base = rng.integers(0, 255, (40, 160, 3), dtype=np.uint8)
    for i in range(6):  # a scene sliding sideways, plus noise
        frame = np.clip(base[:, 4 * i:4 * i + 128].astype(int)
                        + rng.integers(-8, 8, (40, 128, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(frame).save(os.path.join(seq_dir, "image_2", f"{i:06d}.png"))
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        f.write("P2: 7.2e+02 0.0 6.1e+02 4.4e+01 0.0 7.3e+02 1.9e+02 0.0 0.0 0.0 1.0 0.0\n")
    os.makedirs(os.path.join(root, "poses"))
    # 25 m per frame: the devkit's shortest segment (100 m) fits in 5 steps.
    todom.write_kitti_poses(_curved_poses(5, step=25.0), os.path.join(root, "poses", "09.txt"))
    return root


def test_run_odometry_eval_matches_the_reference(models, odom_tree, tmp_path):
    """The model path: the trajectory's translations within 1e-4 of the
    reference's largest; the scores from it; then the written pose file
    scored alone (no model) gives the same numbers in both packages."""
    tmodel, jmodel = models
    kw = dict(checkpoint_dir=None, kitti_odom_root=odom_tree, sequence="09", height=32, width=96)
    got = trunner.run_odometry_eval(model=tmodel, output_dir=str(tmp_path / "t"), **kw)
    ref = jrunner.run_odometry_eval(model=jmodel, output_dir=str(tmp_path / "j"), **kw)
    assert set(got) == set(ref) and got["frames"] == 6
    tp = todom.read_kitti_poses(str(tmp_path / "t" / "09.txt"))
    jp = jodom.read_kitti_poses(str(tmp_path / "j" / "09.txt"))
    assert np.abs(jp[:, :3, 3]).max() > 1e-3  # a real motion
    assert np.abs(tp[:, :3, 3] - jp[:, :3, 3]).max() <= RTOL * np.abs(jp[:, :3, 3]).max()
    assert np.abs(tp - jp).max() <= RTOL
    assert (tmp_path / "t" / "09.png").is_file()
    pose_kw = dict(checkpoint_dir=None, kitti_odom_root=odom_tree, sequence="09",
                   output_dir=None, pose_file=str(tmp_path / "t" / "09.txt"))
    scored = trunner.run_odometry_eval(**pose_kw)
    assert scored == jrunner.run_odometry_eval(**pose_kw)
    assert np.isfinite(scored["t_err_pct"])
    # The file holds 10 significant digits.
    assert scored["ate_m"] == pytest.approx(got["ate_m"], rel=1e-6)


def test_predict_trajectory_pair_path_matches_the_frames_path(models, odom_tree):
    """A sequence object without ``frames_u8`` goes through padded pair
    batches; both paths compose the same trajectory."""
    from depthvo_tpu_torch.data.kitti import KittiOdometrySequence

    tmodel, _ = models
    seq = KittiOdometrySequence(odom_tree, "09", 32, 96)

    class Pairs:
        def pair_iterator(self, batch_size):
            return seq.pair_iterator(batch_size)

    np.testing.assert_allclose(trunner.predict_trajectory(tmodel, Pairs(), batch_size=4),
                               trunner.predict_trajectory(tmodel, seq, batch_size=4),
                               rtol=0, atol=1e-5)


def test_odometry_eval_without_matplotlib_writes_no_figure(odom_tree, tmp_path, monkeypatch,
                                                           capsys):
    gt = os.path.join(odom_tree, "poses", "09.txt")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = trunner.run_odometry_eval(None, odom_tree, "09", output_dir=str(tmp_path),
                                    pose_file=gt)
    assert out["ate_m"] == pytest.approx(0.0, abs=1e-9)
    assert "no figure written" in capsys.readouterr().out
    assert not (tmp_path / "09.png").exists()


# --------------------------------------------------------------------------
# The commands on the CPU.
# --------------------------------------------------------------------------


def _json_out(capsys):
    return json.loads(capsys.readouterr().out)


def test_cli_eval_depth_and_saved_predictions(eigen_tree, depth_evals, tmp_path, capsys):
    root, split, _ = eigen_tree
    ref = depth_evals[1]
    common = ["--kitti-root", root, "--split-file", split]
    with pytest.warns(UserWarning, match="NON-CANONICAL"):
        assert tcli.main(["eval-depth", "--variant", "tiny_test", "--device", "cpu",
                          "--save-preds", str(tmp_path)] + common) == 0
    live = _json_out(capsys)
    assert set(live) == set(ref) and set(live["split"]) == set(ref["split"])
    with pytest.warns(UserWarning, match="NON-CANONICAL"):
        assert tcli.main(["eval-depth", "--pred-path", str(tmp_path)] + common) == 0
    saved = _json_out(capsys)
    assert saved["quant"] == "external"
    assert all(saved[k] == live[k] for k in CONTINUOUS + THRESHOLDS)


@pytest.mark.parametrize("flags,match", [(["--int8"], "A.6"), (["--num-devices", "2"], "A.8")])
def test_cli_unported_flags_raise(eigen_tree, tmp_path, flags, match, capsys):
    """``--num-devices 2`` (A.8) raises in the CLI and in the runner.
    ``--int8`` raised until A.6 ported it: now ``eval-depth --int8`` runs the
    w8a8 sweep and says so (``quant``, ``split.int8``), as the reference's
    does, and ``run_depth_eval(int8=True)`` too."""
    root, split, _ = eigen_tree
    argv = ["eval-depth", "--variant", "tiny_test", "--device", "cpu", "--kitti-root", root,
            "--split-file", split] + flags
    kw = {"int8": True} if match == "A.6" else {"num_devices": 2}
    if match == "A.6":
        with pytest.warns(UserWarning, match="NON-CANONICAL"):
            assert tcli.main(argv) == 0
        out = _json_out(capsys)
        assert out["quant"] == "int8" and out["split"]["int8"] is True
        model = tapi.DepthVO.from_random(tconfigs.tiny_test(), device="cpu")
        with pytest.warns(UserWarning, match="NON-CANONICAL"):
            table = trunner.run_depth_eval(None, root, split, height=32, width=96, model=model,
                                           **kw)
        assert table["quant"] == "int8" and model.quant is not None
        assert all(np.isfinite(table[k]) for k in CONTINUOUS + THRESHOLDS)
        return
    with pytest.raises(NotImplementedError, match=match):
        tcli.main(argv)
    with pytest.raises(NotImplementedError):
        trunner.run_depth_eval(None, root, split, **kw)


def test_cli_eval_odom(odom_tree, tmp_path, capsys):
    assert tcli.main(["eval-odom", "--variant", "tiny_test", "--device", "cpu",
                      "--kitti-root", odom_tree, "--output-dir", str(tmp_path)]) == 0
    out = _json_out(capsys)
    assert {"sequence", "frames", "t_err_pct", "r_err_deg_per_100m", "ate_m",
            "snippet_ate_mean", "snippet_ate_std", "snippets"} == set(out)
    assert tcli.main(["eval-odom", "--kitti-root", odom_tree,
                      "--pose-file", str(tmp_path / "09.txt"), "--output-dir", ""]) == 0
    scored = _json_out(capsys)
    assert scored["ate_m"] == pytest.approx(out["ate_m"], rel=1e-6)
    assert scored["pose_file"].endswith("09.txt")


@pytest.fixture
def image_dir(tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.default_rng(9)
    for i in range(5):
        Image.fromarray(rng.integers(0, 255, (40, 128, 3), dtype=np.uint8)).save(
            d / f"f{i:03d}.png")
    return d


def test_cli_infer_matches_depth_vo(image_dir, tmp_path, capsys):
    from depthvo_tpu_torch.data.kitti import load_image_u8

    out = tmp_path / "depths"
    assert tcli.main(["infer", "--variant", "tiny_test", "--device", "cpu", "--images",
                      str(image_dir), "--output-dir", str(out), "--batch-size", "2",
                      "--save-png"]) == 0
    assert "frames/s steady" in capsys.readouterr().out
    paths = sorted(image_dir.glob("*.png"))
    frames = np.stack([load_image_u8(str(p), 32, 96) for p in paths])
    model = tapi.DepthVO.from_random(tconfigs.tiny_test(batch_size=2), device="cpu")
    want = np.concatenate([model.depth(frames[i:i + 2]) for i in range(0, 5, 2)])
    got = np.stack([np.load(out / f"{p.stem}_depth.npy") for p in paths])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert len(list(out.glob("*_depth.png"))) == 5


def test_cli_infer_save_png_needs_matplotlib(image_dir, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        tcli.main(["infer", "--variant", "tiny_test", "--device", "cpu", "--images",
                   str(image_dir), "--output-dir", str(tmp_path / "o"), "--save-png"])


@pytest.mark.parametrize("fn", ["predict_depths", "predict_trajectory", "run_depth_eval",
                                "run_odometry_eval"])
def test_runner_has_the_references_signature(fn):
    import inspect

    ref = inspect.signature(getattr(jrunner, fn)).parameters
    got = inspect.signature(getattr(trunner, fn)).parameters
    assert [(p.name, p.default, p.kind) for p in got.values()] == [
        (p.name, p.default, p.kind) for p in ref.values()]
