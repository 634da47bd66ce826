"""The evaluations: batched inference and the metric passes over KITTI
(counterpart of ``depthvo_tpu/eval/runner.py``, with its parameters).

* :func:`predict_depths`: the depth sweep. On the GPU each batch goes up
  from pinned memory without blocking, is normalised and run there in
  ``torch.inference_mode()``, and its depth comes back into pinned host
  memory behind a CUDA event. Up to ``MAX_IN_FLIGHT`` batches are enqueued
  before the first is read, so the host's work on batch i (the resize to
  the ground truth) overlaps the forward of the batches after it.
* :func:`predict_trajectory`: the odometry net over a sequence, composed.
* :func:`run_depth_eval` / :func:`run_odometry_eval`: the Eigen depth
  table and the KITTI odometry errors, from a model or from saved
  predictions / a pose file alone (no model, no device).

``int8`` calibrates on the split's first frames and sweeps the w8a8
program (``DepthVO.calibrate_int8``). Not ported: ``mesh`` /
``num_devices > 1`` (A.8) raise ``NotImplementedError``. Pillow is not
needed: the resize to the ground truth is ``eval/resize.py``; matplotlib
draws the odometry figure where it is installed, and the run says so
where it is not.
"""

from __future__ import annotations

import collections
import hashlib
import importlib.util
import os
import re
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from depthvo_tpu_torch.api import DepthVO
from depthvo_tpu_torch.data.kitti import KittiOdometrySequence, load_images_u8
from depthvo_tpu_torch.eval.depth_metrics import compute_depth_metrics
from depthvo_tpu_torch.eval.odometry import (
    ate,
    compose_trajectory,
    kitti_odometry_errors,
    plot_trajectory,
    read_kitti_poses,
    snippet_ate,
    write_kitti_poses,
)
from depthvo_tpu_torch.eval.resize import resize_bilinear_f32
from depthvo_tpu_torch.utils.images import to_unit

# Bound on enqueued-but-unread batches (inputs and outputs stay in device
# memory until drained): enough to overlap the host with the device,
# small enough that a sweep of any length stays memory-bounded.
MAX_IN_FLIGHT = 32


def predict_depths(
    model: DepthVO,
    frames: np.ndarray,
    batch_size: int = 16,
    mesh=None,
    postprocess=None,
    postprocess_workers: int = 4,
):
    """Batched depth inference over (N, H, W, 3) frames -> (N, H, W).

    The trailing batch is padded by repeating its last frame, so every
    forward has one shape (cuDNN may choose other algorithms for another
    batch size). Pass uint8 frames (``data/kitti.py::load_image_u8``):
    they cross to the device at a quarter of float32's bytes and are
    normalised there with the loaders' formula.

    ``postprocess``: optional ``fn(frame_idx, depth_2d) -> Any`` run per
    frame on a pool of ``postprocess_workers`` threads as results drain;
    the ordered list of its results is returned instead of the stack.

    ``mesh`` (data-parallel eval) is not ported and raises.
    """
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel eval over a device mesh is not ported yet (ROADMAP A.8)")
    dev = model.device
    cuda = dev.type == "cuda"
    frames = np.asarray(frames)
    n = len(frames)
    pool = ThreadPoolExecutor(max_workers=postprocess_workers) if postprocess else None
    pending: collections.deque = collections.deque()
    out: list = []

    def drain_one():
        host, event, count, start = pending.popleft()
        if event is not None:
            event.synchronize()
        arr = host.numpy()[:count]  # a view: keeps the pinned block alive
        if pool is not None:
            out.extend(pool.submit(postprocess, start + j, arr[j]) for j in range(count))
        else:
            out.append(arr)

    try:
        with torch.inference_mode():
            for start in range(0, n, batch_size):
                batch = torch.from_numpy(np.ascontiguousarray(frames[start:start + batch_size]))
                count = len(batch)
                staged = torch.empty((batch_size,) + batch.shape[1:], dtype=batch.dtype,
                                     pin_memory=cuda)
                staged[:count] = batch
                if count < batch_size:
                    staged[count:] = staged[count - 1]
                x = staged.to(dev, non_blocking=True)
                disp = model.models.depth(to_unit(x))[-1]
                depth = 1.0 / disp[..., 0]
                if cuda:
                    host = torch.empty(depth.shape, dtype=depth.dtype, pin_memory=True)
                    host.copy_(depth, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                else:
                    host, event = depth, None
                pending.append((host, event, count, start))
                if len(pending) >= MAX_IN_FLIGHT:
                    drain_one()
            while pending:
                drain_one()
        if pool is not None:
            return [f.result() for f in out]
        return np.concatenate(out, axis=0)
    finally:
        if pool is not None:
            pool.shutdown(wait=False)


def predict_trajectory(model: DepthVO, seq, batch_size: int = 16) -> np.ndarray:
    """The odometry net over a sequence, composed into (N, 4, 4) poses.

    A sequence with ``frames_u8`` (``KittiOdometrySequence``) goes to the
    device in one uint8 copy and is paired there
    (``DepthVO.pose_sequence``); other sequence objects give float32 pair
    batches through ``pair_iterator``, the last one padded."""
    if hasattr(seq, "frames_u8"):
        return compose_trajectory(model.pose_sequence(seq.frames_u8(), chunk=batch_size))
    rels = []
    for pairs in seq.pair_iterator(batch_size):
        pad = batch_size - len(pairs)
        padded = np.concatenate([pairs, np.repeat(pairs[-1:], pad, 0)]) if pad else pairs
        rels.append(model.pose(padded)[:len(pairs)])
    return compose_trajectory(np.concatenate(rels, axis=0))


def run_depth_eval(
    checkpoint_dir: str | None,
    kitti_root: str,
    split_file: str,
    max_depth: float = 80.0,
    height: int = 160,
    width: int = 608,
    batch_size: int = 16,
    save_preds_dir: str | None = None,
    model: DepthVO | None = None,
    num_devices: int | None = None,
    median_scale: bool = True,
    pred_path: str | None = None,
    pred_inverse: bool = False,
    int8: bool = False,
    split_sha: str | None = None,
) -> Dict[str, float]:
    """Eigen-split depth benchmark: read the test frames and their ground
    truth, run the batched inference, resize each prediction to its ground
    truth and compute the metric table. Without ``model`` (and without
    ``pred_path``) it loads the checkpoint's weights, or random ones, on
    the GPU.

    ``split_file`` lines: ``<relative_image_path> <relative_gt_depth_npy>``;
    ``#`` lines are skipped, and a ``# split-source: ...`` header (written
    by ``prep-eigen``) is read as provenance.

    ``pred_path`` runs the metric pass alone on saved predictions (a
    stack, an npz, a ``save_preds_dir`` directory or per-frame ``.npy``
    files; ``pred_inverse`` for inverse depth): no model and no device.

    ``int8`` calibrates on the split's first ``max(batch_size, 32)``
    frames and runs the w8a8 program (``DepthVO.calibrate_int8``).

    The result holds a ``split`` block ``{split_file, n_frames, canonical,
    source, median_scale, sha256, pinned, ...}`` and ``quant`` ("off",
    "int8", or "external" for saved predictions); a warning
    is raised unless the split is the canonical 697-frame list.
    ``split_sha`` pins the split file's SHA-256: a file that differs is
    refused.

    Not ported: ``num_devices > 1`` (A.8) raises.
    """
    if num_devices is not None and num_devices > 1:
        raise NotImplementedError(
            f"num_devices={num_devices}: data-parallel eval is not ported yet (ROADMAP A.8)")
    with open(split_file, "rb") as fb:
        digest = hashlib.sha256(fb.read()).hexdigest()
    if split_sha is not None and digest != split_sha.strip().lower():
        raise ValueError(
            f"split file {split_file} has SHA-256 {digest}, which does "
            f"not match the pinned --split-sha {split_sha}: refusing to "
            "evaluate against the wrong split"
        )
    sha_prov = {"sha256": digest, "pinned": split_sha is not None}

    if model is None and pred_path is None:
        model = DepthVO.from_checkpoint(checkpoint_dir) if checkpoint_dir else DepthVO.from_random()
    images, gts = [], []
    split_source = "unknown"
    with open(split_file) as f:
        for line in f:
            if line.startswith("#"):
                if line[1:].strip().startswith("split-source:"):
                    split_source = line.split(":", 1)[1].strip()
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            images.append(os.path.join(kitti_root, parts[0]))
            gts.append(np.load(os.path.join(kitti_root, parts[1])))
    if pred_path is not None:
        metrics = _eval_saved_predictions(
            pred_path, gts, split_file, split_source,
            max_depth=max_depth, median_scale=median_scale, pred_inverse=pred_inverse,
        )
        metrics["split"].update(sha_prov)
        # Saved predictions may come from any tool and precision.
        metrics["quant"] = "external"
        return metrics

    raw_preds: list | None = [None] * len(images) if save_preds_dir else None

    def _resize_to_gt(i: int, p: np.ndarray) -> np.ndarray:
        if raw_preds is not None:
            raw_preds[i] = p
        return resize_bilinear_f32(p, *gts[i].shape)

    # Decoded as uint8 on host threads, normalised on the device.
    frames = load_images_u8(images, height, width)
    if int8:
        # The split's first frames are representative by construction.
        model.calibrate_int8(frames[:max(batch_size, 32)])
    preds_resized = predict_depths(model, frames, batch_size, postprocess=_resize_to_gt)
    if save_preds_dir:
        os.makedirs(save_preds_dir, exist_ok=True)
        np.save(os.path.join(save_preds_dir, "depth_predictions.npy"), np.stack(raw_preds))
    metrics = _finish_depth_eval(
        preds_resized, gts, split_file, split_source,
        max_depth=max_depth, median_scale=median_scale, extra_split=sha_prov,
    )
    metrics["quant"] = "int8" if int8 else "off"
    return metrics


def _finish_depth_eval(
    preds_resized, gts, split_file, split_source, *,
    max_depth, median_scale, extra_split: Dict | None = None,
) -> Dict[str, float]:
    n = len(gts)
    canonical = n == 697 and "derived" not in split_source
    if not canonical:
        warnings.warn(
            f"depth eval ran on a NON-CANONICAL split ({n} frames, "
            f"source: {split_source}): metrics are not comparable to "
            "published Eigen-697 tables",
            stacklevel=3,
        )
    metrics = compute_depth_metrics(
        preds_resized, gts, max_depth=max_depth, median_scale=median_scale)
    metrics["split"] = {
        "split_file": os.path.abspath(split_file),
        "n_frames": n,
        "canonical": canonical,
        "source": split_source,
        # Stereo-trained models are metric and reported unscaled;
        # monocular protocols median-scale.
        "median_scale": median_scale,
        **(extra_split or {}),
    }
    return metrics


def _natural(s: str):
    """frame_2 before frame_10: dumps numbered without zero padding."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def _load_saved_predictions(pred_path: str) -> List[np.ndarray]:
    """Saved predictions: a stacked ``.npy``/``.npz`` (N, H, W), or a
    directory holding ``depth_predictions.npy`` (the ``save_preds_dir``
    format) or per-frame ``*.npy`` in natural order."""
    if os.path.isdir(pred_path):
        stack = os.path.join(pred_path, "depth_predictions.npy")
        if os.path.isfile(stack):
            return list(np.load(stack))
        files = sorted((f for f in os.listdir(pred_path) if f.endswith(".npy")), key=_natural)
        if not files:
            raise FileNotFoundError(f"{pred_path}: no depth_predictions.npy and no *.npy files")
        return [np.load(os.path.join(pred_path, f)) for f in files]
    arr = np.load(pred_path)
    if hasattr(arr, "files"):  # npz: the first array
        arr = arr[arr.files[0]]
    if arr.ndim != 3:
        raise ValueError(f"{pred_path}: expected a (N, H, W) stack, got {arr.shape}")
    return list(arr)


def _eval_saved_predictions(
    pred_path, gts, split_file, split_source, *,
    max_depth, median_scale, pred_inverse,
) -> Dict[str, float]:
    preds = _load_saved_predictions(pred_path)
    if len(preds) != len(gts):
        raise ValueError(
            f"{pred_path} holds {len(preds)} predictions but the split "
            f"file lists {len(gts)} frames"
        )
    resized = []
    for p, g in zip(preds, gts):
        p = np.asarray(p, np.float32)
        if pred_inverse:
            p = 1.0 / np.maximum(p, 1e-6)
        resized.append(resize_bilinear_f32(p, *g.shape))
    return _finish_depth_eval(
        resized, gts, split_file, split_source,
        max_depth=max_depth, median_scale=median_scale,
        extra_split={"predictions": os.path.abspath(pred_path), "pred_inverse": pred_inverse},
    )


def _plot(poses, gt_poses, path: str, title: str) -> None:
    """The trajectory figure, where matplotlib is installed. The figure is
    optional output (no score depends on it): without matplotlib the run
    says that it drew none."""
    if importlib.util.find_spec("matplotlib") is None:
        print(f"eval-odom: matplotlib is not installed, no figure written ({path})")
        return
    plot_trajectory(poses, gt_poses, path, title=title)


def _scores(poses, gt_poses) -> Dict[str, float]:
    out: Dict[str, float] = dict(kitti_odometry_errors(poses, gt_poses))
    out["ate_m"] = ate(poses, gt_poses)
    out.update(snippet_ate(poses, gt_poses))
    return out


def run_odometry_eval(
    checkpoint_dir: str | None,
    kitti_odom_root: str,
    sequence: str = "09",
    output_dir: str | None = None,
    height: int = 160,
    width: int = 608,
    model: DepthVO | None = None,
    pose_file: str | None = None,
) -> Dict[str, float]:
    """Sequence eval: predict the trajectory, write the KITTI pose file and
    figure to ``output_dir``, and score the devkit errors, ATE and snippet
    ATE against the ground truth. Without ``model`` it loads the
    checkpoint's weights, or random ones, on the GPU.

    ``pose_file`` runs the devkit phase alone: an existing KITTI-format
    pose file is scored against the sequence's ground truth; no model
    runs."""
    if pose_file is not None:
        poses = read_kitti_poses(pose_file)
        gt_path = os.path.join(kitti_odom_root, "poses", sequence + ".txt")
        if not os.path.isfile(gt_path):
            raise FileNotFoundError(
                f"no ground-truth poses at {gt_path}: check --kitti-root/--sequence")
        gt_poses = read_kitti_poses(gt_path)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            _plot(poses, gt_poses, os.path.join(output_dir, f"{sequence}.png"),
                  f"seq {sequence} ({os.path.basename(pose_file)})")
        if len(gt_poses) != len(poses):
            raise ValueError(
                f"{pose_file} holds {len(poses)} poses but ground "
                f"truth for seq {sequence} has {len(gt_poses)}"
            )
        result: Dict[str, float] = {
            "sequence": sequence, "frames": len(poses),
            "pose_file": os.path.abspath(pose_file),
        }
        result.update(_scores(poses, gt_poses))
        return result

    if model is None:
        model = DepthVO.from_checkpoint(checkpoint_dir) if checkpoint_dir else DepthVO.from_random()
    seq = KittiOdometrySequence(kitti_odom_root, sequence, height, width)
    poses = predict_trajectory(model, seq)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        write_kitti_poses(poses, os.path.join(output_dir, f"{sequence}.txt"))
        _plot(poses, seq.gt_poses, os.path.join(output_dir, f"{sequence}.png"),
              f"seq {sequence}")
    result = {"sequence": sequence, "frames": len(seq)}
    if seq.gt_poses is not None:
        result.update(_scores(poses, seq.gt_poses))
    return result
