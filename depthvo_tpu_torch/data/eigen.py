"""The Eigen split of KITTI raw (the port's own copy of
``depthvo_tpu/data/eigen.py``, numpy only).

``EIGEN_TEST_SCENES`` are the drives the Eigen depth test frames come
from; ``prep --eigen-train`` leaves them out of a training list, so that
training never sees the evaluation scenes. ``parse_split_file`` and
``enumerate_test_frames`` read a split. ``prep_eigen`` generates the
ground-truth depth maps from the velodyne scans (``data/velodyne.py``)
and writes the list that ``eval-depth`` reads, with the
``# split-source:`` header that ``eval/runner.py::run_depth_eval`` reads
back.

PROVENANCE NOTE (the reference's): ``EIGEN_TEST_SCENES`` is reconstructed
from model knowledge of the public Eigen/monodepth ``test_scenes_eigen.txt``;
frame-level membership of the canonical 697-image list is not
reproducible from it. Pass the canonical file for exact-protocol parity.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


# Best-recall reconstruction of the Eigen test scene list (the drives the
# 697 test frames are drawn from; city/residential/road categories).
EIGEN_TEST_SCENES: Tuple[str, ...] = (
    "2011_09_26_drive_0002_sync",
    "2011_09_26_drive_0009_sync",
    "2011_09_26_drive_0013_sync",
    "2011_09_26_drive_0020_sync",
    "2011_09_26_drive_0023_sync",
    "2011_09_26_drive_0027_sync",
    "2011_09_26_drive_0029_sync",
    "2011_09_26_drive_0036_sync",
    "2011_09_26_drive_0046_sync",
    "2011_09_26_drive_0048_sync",
    "2011_09_26_drive_0052_sync",
    "2011_09_26_drive_0056_sync",
    "2011_09_26_drive_0059_sync",
    "2011_09_26_drive_0064_sync",
    "2011_09_26_drive_0084_sync",
    "2011_09_26_drive_0086_sync",
    "2011_09_26_drive_0093_sync",
    "2011_09_26_drive_0096_sync",
    "2011_09_26_drive_0101_sync",
    "2011_09_26_drive_0106_sync",
    "2011_09_26_drive_0117_sync",
    "2011_09_28_drive_0002_sync",
    "2011_09_29_drive_0071_sync",
    "2011_09_30_drive_0016_sync",
    "2011_10_03_drive_0047_sync",
)


def parse_split_file(path: str) -> List[Tuple[str, int]]:
    """Parse an Eigen-style test-file list into (drive, frame_idx) pairs.

    Accepts the two circulating formats:
    * path format  — ``<date>/<drive>/image_02/data/<frame>.png [...]``
      (monodepth's eigen_test_files.txt; extra columns ignored)
    * field format — ``<date>/<drive> <frame> [l|r]``
      (Eigen/KITTI prep scripts)
    """
    out: List[Tuple[str, int]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            first = parts[0]
            if first.endswith(".png") or "/image_0" in first:
                comps = first.split("/")
                drive = comps[1] if len(comps) > 1 else comps[0]
                frame = int(os.path.splitext(comps[-1])[0])
            else:
                drive = first.split("/")[-1]
                frame = int(parts[1])
            out.append((drive, frame))
    return out


def enumerate_test_frames(
    kitti_root: str, scenes: Sequence[str] = EIGEN_TEST_SCENES,
    cam: int = 2,
) -> List[Tuple[str, int]]:
    """All frames of the given drives that have BOTH an image (of the
    target camera) and a velodyne scan on disk (the derivable stand-in
    when no canonical split file is supplied)."""
    out: List[Tuple[str, int]] = []
    for drive in scenes:
        date = drive.split("_drive_")[0]
        img_dir = os.path.join(
            kitti_root, date, drive, f"image_{cam:02d}", "data"
        )
        velo_dir = os.path.join(
            kitti_root, date, drive, "velodyne_points", "data"
        )
        if not os.path.isdir(img_dir) or not os.path.isdir(velo_dir):
            continue
        velo = {os.path.splitext(f)[0] for f in os.listdir(velo_dir)}
        for f in sorted(os.listdir(img_dir)):
            stem, ext = os.path.splitext(f)
            if ext == ".png" and stem in velo:
                out.append((drive, int(stem)))
    return out


def prep_eigen(
    kitti_root: str,
    out_dir: str,
    split_file: Optional[str] = None,
    scenes: Optional[Sequence[str]] = None,
    cam: int = 2,
) -> Tuple[int, str]:
    """Generate gt depth maps + the eval split list for ``eval-depth``.

    Writes ``<out_dir>/gt/<drive>_<frame>.npy`` (sparse gt depth at the
    image's native resolution) and ``<out_dir>/eigen_list.txt`` whose
    lines are ``<image_path_rel_to_root> <gt_npy_abs_path>`` — directly
    consumable by ``eval-depth --split-file``.

    Returns (num_frames, list_path). Frames whose velodyne scan is
    missing are skipped with a warning count.
    """
    from depthvo_tpu_torch.data.velodyne import generate_gt_depth

    frames = (
        parse_split_file(split_file)
        if split_file
        else enumerate_test_frames(
            kitti_root, scenes or EIGEN_TEST_SCENES, cam=cam
        )
    )
    gt_dir = os.path.join(out_dir, "gt")
    os.makedirs(gt_dir, exist_ok=True)
    list_path = os.path.join(out_dir, "eigen_list.txt")
    n, skipped = 0, 0
    source = (
        f"canonical {os.path.basename(split_file)}"
        if split_file
        else "derived-scene-list"
    )
    with open(list_path, "w") as lf:
        # Provenance header read back by eval.runner.run_depth_eval: a
        # derived (non-canonical) list is flagged so its metrics are
        # never silently compared to published Eigen-697 tables.
        lf.write(f"# split-source: {source}\n")
        for drive, frame in frames:
            date = drive.split("_drive_")[0]
            # The image paired with the gt must come from the SAME camera
            # the gt was projected into (cam=3 with image_02 frames would
            # skew every metric by the stereo baseline).
            img_rel = os.path.join(
                date, drive, f"image_{cam:02d}", "data", f"{frame:010d}.png"
            )
            velo = os.path.join(
                kitti_root, date, drive, "velodyne_points", "data",
                f"{frame:010d}.bin",
            )
            if not os.path.isfile(os.path.join(kitti_root, img_rel)) or not os.path.isfile(velo):
                skipped += 1
                continue
            depth = generate_gt_depth(kitti_root, drive, frame, cam=cam)
            gt_path = os.path.abspath(
                os.path.join(gt_dir, f"{drive}_{frame:010d}.npy")
            )
            np.save(gt_path, depth)
            lf.write(f"{img_rel} {gt_path}\n")
            n += 1
    if skipped:
        print(f"prep-eigen: skipped {skipped} frames with missing files")
    return n, list_path
