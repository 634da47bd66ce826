"""The benchmark's traffic: synthetic KITTI-like scenes, and a KITTI raw
drive written as PNG files.

Frozen copies, so that later changes to the system cannot move the
yardstick: ``SyntheticScenes`` is ``depthvo_tpu_torch/data/synthetic.py``'s
class without its photometric stressors (a ground plane receding upward,
four fronto-parallel walls, a band-limited texture; the right view
rendered at the stereo baseline, the source view after 0.3-0.8 m of
forward motion and up to 0.01 rad of yaw), and ``write_png`` /
``write_kitti_raw`` are ``chip_smoke.py``'s writers with a frame count.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict

import numpy as np

KITTI_HW = (375, 1242)  # the rectified size of KITTI raw's 2011_09_26 drives
KITTI_DATE, KITTI_DRIVE = "2011_09_26", "2011_09_26_drive_0001_sync"
KITTI_CALIB = (7.215377e02, 6.095593e02, 1.728540e02)  # fx, cx, cy
KITTI_TX = (("02", 4.485728e01), ("03", -3.395242e02))  # P_rect_0k[0, 3]


def _smooth_texture(rng: np.random.Generator, h: int, w: int, c: int = 3) -> np.ndarray:
    small = rng.uniform(-1.0, 1.0, size=(h // 8 + 2, w // 8 + 2, c)).astype(np.float32)
    ys = np.linspace(0, small.shape[0] - 1.001, h).astype(np.float32)
    xs = np.linspace(0, small.shape[1] - 1.001, w).astype(np.float32)
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    ay, ax = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    t = (small[y0][:, x0] * (1 - ay) * (1 - ax) + small[y0][:, x0 + 1] * (1 - ay) * ax
         + small[y0 + 1][:, x0] * ay * (1 - ax) + small[y0 + 1][:, x0 + 1] * ay * ax)
    return t.astype(np.float32)


def _scene_depth(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    v = np.arange(h, dtype=np.float32)[:, None]
    depth = np.broadcast_to(4.0 + 40.0 * (1.0 - v / max(h - 1, 1)), (h, w)).copy()
    for _ in range(4):
        x0 = rng.integers(0, w - w // 4)
        width = rng.integers(w // 8, w // 4)
        d = rng.uniform(6.0, 25.0)
        top = rng.integers(0, h // 2)
        depth[top:, x0:x0 + width] = np.minimum(depth[top:, x0:x0 + width], d)
    return depth.astype(np.float32)


class SyntheticScenes:
    """Geometrically consistent (target, right, source) uint8 triples."""

    def __init__(self, height: int, width: int, baseline: float, seed: int, num_scenes: int):
        self.h, self.w, self.baseline = height, width, baseline
        rng = np.random.default_rng(seed)
        self.K = np.array([[0.58 * width, 0.0, 0.5 * width], [0.0, 1.92 * height, 0.5 * height],
                           [0.0, 0.0, 1.0]], np.float32)
        self.scenes = [self._make_scene(rng) for _ in range(num_scenes)]

    def _bilinear(self, img, u, v):
        h, w, _ = img.shape
        u = np.clip(u, 0.0, w - 1.001)
        v = np.clip(v, 0.0, h - 1.001)
        u0, v0 = np.floor(u).astype(int), np.floor(v).astype(int)
        au, av = (u - u0)[..., None], (v - v0)[..., None]
        return (img[v0, u0] * (1 - au) * (1 - av) + img[v0, u0 + 1] * au * (1 - av)
                + img[v0 + 1, u0] * (1 - au) * av
                + img[v0 + 1, u0 + 1] * au * av).astype(np.float32)

    def _render(self, tex, depth, T):
        h, w = depth.shape
        uu, vv = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        pix = np.stack([uu, vv, np.ones_like(uu)], axis=-1)
        pts = (pix @ np.linalg.inv(self.K).T) * depth[..., None]
        Tinv = np.linalg.inv(T)
        proj = (pts @ Tinv[:3, :3].T + Tinv[:3, 3]) @ self.K.T
        z = np.maximum(proj[..., 2], 1e-3)
        return self._bilinear(tex, proj[..., 0] / z, proj[..., 1] / z)

    def _make_scene(self, rng) -> Dict[str, np.ndarray]:
        tex = _smooth_texture(rng, self.h, self.w)
        depth = _scene_depth(rng, self.h, self.w)
        T_lr = np.eye(4, dtype=np.float32)
        T_lr[0, 3] = -self.baseline
        fwd = rng.uniform(0.3, 0.8)
        yaw = rng.uniform(-0.01, 0.01)
        T_ts = np.eye(4, dtype=np.float32)
        T_ts[0, 0] = T_ts[2, 2] = np.cos(yaw)
        T_ts[0, 2], T_ts[2, 0] = np.sin(yaw), -np.sin(yaw)
        T_ts[2, 3] = fwd
        views = {"image_t": tex, "image_r": self._render(tex, depth, T_lr),
                 "image_s": self._render(tex, depth, T_ts)}
        return {k: np.clip(np.round((v + 1.0) * 127.5), 0, 255).astype(np.uint8)
                for k, v in views.items()}

    def batch(self, rows) -> Dict[str, np.ndarray]:
        """The scenes ``rows`` as one batch of the train loop's contract."""
        out = {k: np.stack([self.scenes[i][k] for i in rows])
               for k in ("image_t", "image_r", "image_s")}
        out["K"] = np.stack([self.K] * len(rows))
        out["baseline"] = np.full(len(rows), self.baseline, np.float32)
        return out


def write_png(path: str, rgb: np.ndarray) -> None:
    """A (H, W, 3) uint8 array as an 8-bit RGB PNG, filter 0 on every row."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def write_kitti_raw(root: str, frames: int, seed: int, baseline: float) -> str:
    """One KITTI raw drive of ``frames`` frames per camera at 375x1242:
    frame i is scene i's target view on the left camera and its right view
    on the right, and ``calib_cam_to_cam.txt`` holds KITTI's 2011_09_26
    rectified projections (a 0.537 m baseline) and size. Returns the
    drive's name."""
    scenes = SyntheticScenes(*KITTI_HW, baseline, seed, frames)
    for cam, key in (("image_02", "image_t"), ("image_03", "image_r")):
        d = os.path.join(root, KITTI_DATE, KITTI_DRIVE, cam, "data")
        os.makedirs(d, exist_ok=True)
        for i in range(frames):
            write_png(os.path.join(d, f"{i:010d}.png"), scenes.scenes[i][key])
    fx, cx, cy = KITTI_CALIB
    with open(os.path.join(root, KITTI_DATE, "calib_cam_to_cam.txt"), "w") as f:
        f.write(f"S_rect_02: {KITTI_HW[1]:.6e} {KITTI_HW[0]:.6e}\n")
        for cam, tx in KITTI_TX:
            f.write(f"P_rect_{cam}: {fx:e} 0 {cx:e} {tx:e} 0 {fx:e} {cy:e} 2.163791e-01 "
                    "0 0 1 2.745884e-03\n")
    return KITTI_DRIVE
