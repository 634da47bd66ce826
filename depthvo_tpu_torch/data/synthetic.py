"""Procedural multi-view scenes with exact geometry.

The port's own copy of ``depthvo_tpu/data/synthetic.py`` (numpy only):
the same seed yields the same scenes in both packages, which is what the
parity tests rely on.

Serves two roles (SURVEY.md §4 test plan):
* integration tests — "overfit one batch, loss goes down" needs frames
  that are *geometrically consistent* (a real 3D scene seen from a stereo
  rig and a moving camera), so the photometric loss has a true minimum at
  the correct depth/pose;
* benchmarks on machines without KITTI (this one): realistic shapes
  (608x160) with the true data-flow (host numpy -> device).

Scene model: a textured "ground plane + fronto-parallel walls" depth
field, smooth random texture, rendered by inverse-warping a canonical
texture view — the same warp math the framework trains with, but executed
in numpy/JAX outside the training graph.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from depthvo_tpu_torch.configs.base import ExperimentConfig


def _smooth_texture(rng: np.random.Generator, h: int, w: int, c: int = 3) -> np.ndarray:
    """Band-limited random texture in [-1, 1] (numpy bilinear upsample)."""
    small = rng.uniform(-1.0, 1.0, size=(h // 8 + 2, w // 8 + 2, c)).astype(np.float32)
    ys = np.linspace(0, small.shape[0] - 1.001, h).astype(np.float32)
    xs = np.linspace(0, small.shape[1] - 1.001, w).astype(np.float32)
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    ay, ax = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    t = (
        small[y0][:, x0] * (1 - ay) * (1 - ax)
        + small[y0][:, x0 + 1] * (1 - ay) * ax
        + small[y0 + 1][:, x0] * ay * (1 - ax)
        + small[y0 + 1][:, x0 + 1] * ay * ax
    )
    return t.astype(np.float32)


def _scene_depth(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Depth field: ground plane receding upward + random wall segments."""
    v = np.arange(h, dtype=np.float32)[:, None]
    # Ground plane: depth grows toward the top of the image (KITTI-like).
    depth = 4.0 + 40.0 * (1.0 - v / max(h - 1, 1))
    depth = np.broadcast_to(depth, (h, w)).copy()
    for _ in range(4):
        x0 = rng.integers(0, w - w // 4)
        width = rng.integers(w // 8, w // 4)
        d = rng.uniform(6.0, 25.0)
        top = rng.integers(0, h // 2)
        depth[top:, x0 : x0 + width] = np.minimum(depth[top:, x0 : x0 + width], d)
    return depth.astype(np.float32)


class SyntheticScenes:
    """Generates geometrically consistent (target, stereo, temporal) triples.

    Views are rendered from per-pixel scene depth via inverse warping with
    the true transforms, so a depth net + odom net that recover the truth
    exactly minimize the photometric losses.
    """

    def __init__(
        self,
        config: ExperimentConfig,
        seed: int = 0,
        num_scenes: int = 8,
        u8: bool = False,
        exposure_jitter: float = 0.0,
        gamma_jitter: float = 0.0,
        repeat_texture: bool = False,
    ):
        """``u8=True`` quantizes the rendered views to the uint8 grid
        (what camera data is anyway) so batches ship 4x fewer bytes to
        the device; the train step normalizes on-device.

        Photometric-ambiguity stressors (the conditions the reference's
        feature-reconstruction loss exists for — its §1 motivation is
        that pure photometric matching fails under brightness change and
        repeated structure):

        * ``exposure_jitter`` — the temporal source view is rendered
          with a per-scene exposure gain of up to ±this many STOPS
          (2**U(-e, e)), simulating auto-exposure drift between frames.
          Stereo pairs stay matched (hardware-synchronized shutters).
        * ``gamma_jitter`` — per-scene gamma perturbation
          exp(U(-g, g)) on the same view (tone-curve drift).
        * ``repeat_texture`` — the scene texture is a narrow tile
          repeated horizontally, so photometric matching has multiple
          near-equal minima along the epipolar direction; only a wider
          receptive field (the feature loss) can disambiguate.

        Used by benchmarks/feat_ab.py --stress (VERDICT r3 item 2).
        """
        self.config = config
        self.exposure_jitter = float(exposure_jitter)
        self.gamma_jitter = float(gamma_jitter)
        self.repeat_texture = bool(repeat_texture)
        mc = config.model
        self.h, self.w = mc.height, mc.width
        rng = np.random.default_rng(seed)
        # Jitter draws come from their own stream so enabling stress
        # leaves the scene geometry/texture draws bit-identical to the
        # unstressed instance (feat_ab's clean-vs-stress arms then
        # differ ONLY in the photometric nuisance).
        self._stress_rng = np.random.default_rng(seed ^ 0x5DEECE66D)
        # KITTI-ish intrinsics scaled to (h, w).
        self.K = np.array(
            [
                [0.58 * self.w, 0.0, 0.5 * self.w],
                [0.0, 1.92 * self.h, 0.5 * self.h],
                [0.0, 0.0, 1.0],
            ],
            np.float32,
        )
        self._scenes = [self._make_scene(rng) for _ in range(num_scenes)]
        if u8:
            for s in self._scenes:
                for k in ("image_t", "image_r", "image_s"):
                    s[k] = (
                        np.clip(np.round((s[k] + 1.0) * 127.5), 0, 255)
                        .astype(np.uint8)
                    )
        self._rng = rng

    # -- rendering helpers (numpy; mirrors geometry/warp semantics) --
    def _bilinear(self, img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        h, w, _ = img.shape
        u = np.clip(u, 0.0, w - 1.001)
        v = np.clip(v, 0.0, h - 1.001)
        u0, v0 = np.floor(u).astype(int), np.floor(v).astype(int)
        au, av = (u - u0)[..., None], (v - v0)[..., None]
        return (
            img[v0, u0] * (1 - au) * (1 - av)
            + img[v0, u0 + 1] * au * (1 - av)
            + img[v0 + 1, u0] * (1 - au) * av
            + img[v0 + 1, u0 + 1] * au * av
        ).astype(np.float32)

    def _render(self, tex: np.ndarray, depth: np.ndarray, T: np.ndarray) -> np.ndarray:
        """Render the scene from pose T (canonical-cam -> view-cam) by
        sampling the canonical texture at reprojected coordinates."""
        h, w = depth.shape
        uu, vv = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        ones = np.ones_like(uu)
        pix = np.stack([uu, vv, ones], axis=-1)
        Kinv = np.linalg.inv(self.K)
        # View-cam points: backproject view depth (approx: use canonical depth
        # field as the view's depth — poses are small so the approximation is
        # consistent across views), transform into canonical frame, project.
        pts = (pix @ Kinv.T) * depth[..., None]
        Tinv = np.linalg.inv(T)
        pts_canon = pts @ Tinv[:3, :3].T + Tinv[:3, 3]
        proj = pts_canon @ self.K.T
        z = np.maximum(proj[..., 2], 1e-3)
        u, v = proj[..., 0] / z, proj[..., 1] / z
        return self._bilinear(tex, u, v)

    def _photometric_jitter(
        self, img: np.ndarray, rng: np.random.Generator
    ) -> np.ndarray:
        """Exposure (stops) + gamma drift on one view, in linear [0, 1]."""
        y = (img + 1.0) * 0.5
        if self.exposure_jitter:
            y = y * 2.0 ** rng.uniform(-self.exposure_jitter,
                                       self.exposure_jitter)
        if self.gamma_jitter:
            y = np.clip(y, 0.0, 1.0) ** np.exp(
                rng.uniform(-self.gamma_jitter, self.gamma_jitter)
            )
        return (np.clip(y, 0.0, 1.0) * 2.0 - 1.0).astype(np.float32)

    def _make_scene(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        if self.repeat_texture:
            # A narrow band-limited tile repeated across the image width:
            # horizontal repeats put near-equal photometric minima along
            # the stereo/temporal epipolar direction.
            tile = _smooth_texture(rng, self.h, max(self.w // 4, 8))
            reps = -(-self.w // tile.shape[1])
            tex = np.ascontiguousarray(
                np.tile(tile, (1, reps, 1))[:, : self.w]
            )
        else:
            tex = _smooth_texture(rng, self.h, self.w)
        depth = _scene_depth(rng, self.h, self.w)
        b = self.config.stereo_baseline
        # Stereo: right cam at +b x. Temporal: forward motion + small yaw.
        T_lr = np.eye(4, dtype=np.float32)
        T_lr[0, 3] = -b  # left-cam point coords in right-cam frame
        fwd = rng.uniform(0.3, 0.8)
        yaw = rng.uniform(-0.01, 0.01)
        T_ts = np.eye(4, dtype=np.float32)
        T_ts[0, 0] = T_ts[2, 2] = np.cos(yaw)
        T_ts[0, 2], T_ts[2, 0] = np.sin(yaw), -np.sin(yaw)
        T_ts[2, 3] = fwd  # source cam is `fwd` meters behind along z
        image_t = tex
        image_r = self._render(tex, depth, T_lr)
        image_s = self._render(tex, depth, T_ts)
        if self.exposure_jitter or self.gamma_jitter:
            # Temporal view only: stereo rigs share exposure, consecutive
            # frames under auto-exposure do not (reference §1 motivation).
            image_s = self._photometric_jitter(image_s, self._stress_rng)
        return {
            "image_t": image_t,
            "image_r": image_r,
            "image_s": image_s,
            "depth": depth,
            "T_ts": T_ts,
            "K": self.K,
            # Per-sample baseline (batch contract field): the config's
            # value, since the scenes were rendered with it.
            "baseline": np.float32(b),
        }

    def batch(self, batch_size: int, rng: np.random.Generator | None = None) -> Dict[str, np.ndarray]:
        rng = rng or self._rng
        idx = rng.integers(0, len(self._scenes), size=batch_size)
        keys = ("image_t", "image_r", "image_s", "K", "baseline")
        out = {k: np.stack([self._scenes[i][k] for i in idx]) for k in keys}
        return out

    def fixed_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        """Deterministic batch (first scenes) — for overfit tests."""
        idx = [i % len(self._scenes) for i in range(batch_size)]
        keys = ("image_t", "image_r", "image_s", "K", "baseline")
        return {k: np.stack([self._scenes[i][k] for i in idx]) for k in keys}

    def iterator(self, batch_size: int, fixed: bool = False) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.fixed_batch(batch_size) if fixed else self.batch(batch_size)
