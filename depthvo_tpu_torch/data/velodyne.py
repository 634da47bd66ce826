"""KITTI raw velodyne -> ground-truth depth maps (Eigen eval protocol; the
port's own copy of ``depthvo_tpu/data/velodyne.py``, numpy only).

Reference parity (SURVEY.md §3.2): the reference's depth eval loads
"gt (KITTI raw velodyne-derived)" depth. The standard Eigen/Garg protocol
(used by the reference and every successor codebase) generates the gt by
projecting the raw velodyne scan of each test frame into the rectified
left color camera:

    x_img ~ P_rect_02 @ R_rect_00(4x4) @ T_cam_velo @ X_velo

with points behind the sensor discarded, image coords rounded to pixel
centers with a 1-pixel offset (the protocol's MATLAB 1-indexing legacy —
kept for metric parity), and duplicate hits per pixel resolved to the
minimum depth (the nearest surface wins). Missing pixels stay 0 and are
excluded by the metric masks downstream (eval/depth_metrics.py).

Everything here is host-side numpy: gt generation is a one-off prep step
(the `prep-eigen` CLI), not part of the compute on the device.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from depthvo_tpu_torch.data.kitti import _image_size, read_raw_calib


def read_velodyne(path: str) -> np.ndarray:
    """Read a KITTI velodyne scan: packed float32 (x, y, z, reflectance).

    Returns (N, 4); x points forward, y left, z up, in meters.
    """
    pts = np.fromfile(path, dtype=np.float32)
    if pts.size % 4 != 0:
        raise ValueError(f"{path}: velodyne payload not a multiple of 4 floats")
    return pts.reshape(-1, 4)


def read_velo_to_cam(path: str) -> np.ndarray:
    """Parse calib_velo_to_cam.txt -> 4x4 T_cam<-velo (R|T rows)."""
    calib = read_raw_calib(path)  # same key: value float-list format
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = calib["R"].reshape(3, 3)
    T[:3, 3] = calib["T"].reshape(3)
    return T


def velo_to_image_projection(
    cam2cam: Dict[str, np.ndarray], T_cam_velo: np.ndarray, cam: int = 2
) -> np.ndarray:
    """(3, 4) projection taking homogeneous velodyne points to image
    coords of the rectified camera ``cam`` (2 = left color)."""
    R_rect = np.eye(4, dtype=np.float64)
    R_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4).astype(np.float64)
    return P_rect @ R_rect @ T_cam_velo


def depth_map_from_velo(
    velo: np.ndarray,
    P_velo_img: np.ndarray,
    im_shape: Tuple[int, int],
) -> np.ndarray:
    """Project a scan into a sparse depth map (H, W), nearest-hit wins.

    Follows the Eigen/Garg gt protocol exactly, including the 1-pixel
    rounding offset; deviating here moves abs-rel by >1% against
    published numbers.
    """
    H, W = im_shape
    pts = velo[velo[:, 0] >= 0.0]  # keep points in front of the sensor
    hom = np.concatenate(
        [pts[:, :3].astype(np.float64), np.ones((len(pts), 1))], axis=1
    )
    proj = hom @ P_velo_img.T  # (N, 3)
    z = proj[:, 2]
    ok = z > 1e-6
    proj, z = proj[ok], z[ok]
    # Pixel coords: protocol rounds then subtracts 1 (MATLAB legacy).
    u = np.round(proj[:, 0] / z) - 1
    v = np.round(proj[:, 1] / z) - 1
    inb = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    u = u[inb].astype(np.int64)
    v = v[inb].astype(np.int64)
    z = z[inb]

    depth = np.full(H * W, np.inf, dtype=np.float64)
    # Vectorized nearest-hit resolution for duplicate pixels.
    np.minimum.at(depth, v * W + u, z)
    depth[~np.isfinite(depth)] = 0.0
    depth[depth < 0] = 0.0
    return depth.reshape(H, W).astype(np.float32)


def generate_gt_depth(
    kitti_root: str, drive: str, frame_idx: int, cam: int = 2
) -> np.ndarray:
    """gt depth map for one raw-tree frame: <root>/<date>/<drive>/...

    Reads the frame's native image size (per-drive; varies by campaign),
    the two calib files, and the matching velodyne scan.
    """
    date = drive.split("_drive_")[0]
    ddir = os.path.join(kitti_root, date, drive)
    # The projection target camera's own image plane (cam=3 frames can
    # differ in native size from cam=2 only across campaigns, but the gt
    # must be sized for the camera it is projected into).
    img = os.path.join(ddir, f"image_{cam:02d}", "data", f"{frame_idx:010d}.png")
    velo_path = os.path.join(
        ddir, "velodyne_points", "data", f"{frame_idx:010d}.bin"
    )
    date_dir = os.path.join(kitti_root, date)
    cam2cam = read_raw_calib(os.path.join(date_dir, "calib_cam_to_cam.txt"))
    T_cam_velo = read_velo_to_cam(os.path.join(date_dir, "calib_velo_to_cam.txt"))
    P = velo_to_image_projection(cam2cam, T_cam_velo, cam)
    w, h = _image_size(img)
    return depth_map_from_velo(read_velodyne(velo_path), P, (h, w))
