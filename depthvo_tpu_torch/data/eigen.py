"""The Eigen split of KITTI raw (the port's own copy of the numpy-only
part of ``depthvo_tpu/data/eigen.py``).

``EIGEN_TEST_SCENES`` are the drives the Eigen depth test frames come
from; ``prep --eigen-train`` leaves them out of a training list, so that
training never sees the evaluation scenes. ``parse_split_file`` and
``enumerate_test_frames`` read a split. Generating ground-truth depth
from the velodyne scans (the reference's ``prep_eigen``) belongs to the
depth evaluation, which is not ported yet.

PROVENANCE NOTE (the reference's): ``EIGEN_TEST_SCENES`` is reconstructed
from model knowledge of the public Eigen/monodepth ``test_scenes_eigen.txt``;
frame-level membership of the canonical 697-image list is not
reproducible from it. Pass the canonical file for exact-protocol parity.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple


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
