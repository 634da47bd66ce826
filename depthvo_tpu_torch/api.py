"""Public inference API of the port (counterpart of ``depthvo_tpu/api.py``).

``DepthVO`` bundles a config and the three networks on one device:

* ``depth`` / ``inverse_depth``: RGB frames -> depth (1/disp) maps;
* ``pose``: frame pairs -> 4x4 relative transforms (target-cam ->
  source-cam), ``se3.exp`` of the odometry twist; ``pose_sequence`` the
  same over consecutive frames, paired on the device;
* ``features``: frames -> L2-normalised dense features.

Inputs are NHWC, float32 in [-1, 1] or raw uint8 (normalised on the
device with the loaders' ``x / 127.5 - 1``), numpy arrays or tensors;
outputs are numpy arrays. The handle runs on ``cuda`` unless it was made
with ``device="cpu"``, and raises when there is no GPU otherwise.
``from_checkpoint`` / :func:`load_model` read a checkpoint directory of
either package (``io/checkpoint.py``); :func:`predict_depth` and
:func:`predict_pose` are the reference's functional aliases.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from depthvo_tpu_torch.configs import base as config_base
from depthvo_tpu_torch.configs.base import ExperimentConfig, full_feat
from depthvo_tpu_torch.geometry import se3
from depthvo_tpu_torch.io import checkpoint as ckpt_io
from depthvo_tpu_torch.io.from_jax import load_jax_params
from depthvo_tpu_torch.train.state import Models, build_models, init_params, load_params
from depthvo_tpu_torch.utils.device import resolve_device
from depthvo_tpu_torch.utils.images import to_unit


class DepthVO:
    """Inference handle over Depth-VO-Feat weights."""

    def __init__(self, config: ExperimentConfig, models: Models,
                 device: torch.device):
        self.config = config
        self.models = models
        self.device = device

    # ---- constructors ----
    @classmethod
    def from_random(cls, config: ExperimentConfig | None = None, seed: int = 0,
                    device: str | torch.device | None = None) -> "DepthVO":
        """Random weights (flax's initialisers) drawn from ``seed``."""
        config = config or full_feat()
        dev = resolve_device(device)
        params = init_params(config, torch.Generator().manual_seed(seed))
        return cls(config, load_params(build_models(config), params, dev), dev)

    @classmethod
    def from_checkpoint(cls, directory: str, config: ExperimentConfig | None = None,
                        device: str | torch.device | None = None) -> "DepthVO":
        """The newest checkpoint's weights in ``directory``, written by the
        port or by the JAX package. Without ``config`` the architecture
        comes from the ``config.json`` that training saved beside it (so a
        checkpoint of any variant or resolution restores as trained), else
        ``full_feat()``."""
        cfg_path = os.path.join(directory, "config.json")
        if config is None:
            config = config_base.load_json(cfg_path) if os.path.isfile(cfg_path) else full_feat()
        dev = resolve_device(device)
        models = load_params(build_models(config),
                             init_params(config, torch.Generator().manual_seed(0)), dev)
        return cls(config, ckpt_io.load_weights(directory, models), dev)

    @classmethod
    def from_jax_params(cls, config: ExperimentConfig, params: Dict[str, Any],
                        batch_stats: Dict[str, Any],
                        device: str | torch.device | None = None) -> "DepthVO":
        """Weights of a ``depthvo_tpu`` state (``state.params`` and
        ``state.batch_stats`` as nested dicts of arrays)."""
        dev = resolve_device(device)
        models = load_jax_params(build_models(config), params, batch_stats)
        for net in models:
            if net is not None:
                net.to(dev)
        return cls(config, models, dev)

    # ---- inference ----
    def _as_batch(self, images) -> torch.Tensor:
        """Device tensor, batch dim added, uint8 kept, others float32."""
        x = images if torch.is_tensor(images) else torch.as_tensor(np.asarray(images))
        if x.dtype not in (torch.uint8, torch.float32):
            x = x.float()
        x = x.to(self.device)
        return x[None] if x.ndim == 3 else x

    def inverse_depth(self, images) -> np.ndarray:
        """(B, H, W, 3) frames -> (B, H, W) finest inverse depth."""
        with torch.inference_mode():
            disp = self.models.depth(to_unit(self._as_batch(images)))[-1]
            return disp[..., 0].cpu().numpy()

    def depth(self, images) -> np.ndarray:
        """(B, H, W, 3) frames -> (B, H, W) metric depth (1/disparity)."""
        with torch.inference_mode():
            disp = self.models.depth(to_unit(self._as_batch(images)))[-1]
            return (1.0 / disp[..., 0]).cpu().numpy()

    def pose(self, pairs) -> np.ndarray:
        """(B, H, W, 6) frame pairs -> (B, 4, 4) relative transforms."""
        if self.models.odom is None:
            raise ValueError(f"stage {self.config.name!r} has no odometry net")
        with torch.inference_mode():
            twist = self.models.odom(to_unit(self._as_batch(pairs)))
            return se3.exp(twist).cpu().numpy()

    def pose_sequence(self, frames, chunk: int = 16) -> np.ndarray:
        """(N, H, W, 3) consecutive frames -> (N-1, 4, 4) relative transforms.

        The frames go to the device in one copy (pass uint8: each frame
        crosses the link once, as 1 byte per channel), and consecutive
        pairs are formed there, ``chunk`` pairs per odometry-net call. The
        last chunk is padded by repeating the last frame and trimmed.
        """
        if self.models.odom is None:
            raise ValueError(f"stage {self.config.name!r} has no odometry net")
        n = len(frames)
        if n < 2:
            return np.zeros((0, 4, 4), np.float32)
        m = n - 1
        pad = (-m) % chunk
        with torch.inference_mode():
            x = self._as_batch(frames)
            if pad:
                x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
            out = []
            for c in range(0, m + pad, chunk):
                pairs = torch.cat([to_unit(x[c:c + chunk]), to_unit(x[c + 1:c + chunk + 1])],
                                  dim=-1)
                out.append(se3.exp(self.models.odom(pairs)))
            return torch.cat(out)[:m].cpu().numpy()

    def features(self, images) -> np.ndarray:
        """(B, H, W, 3) frames -> (B, H, W, feat_channels) features."""
        if self.models.feat is None:
            raise ValueError(f"stage {self.config.name!r} has no feature net")
        with torch.inference_mode():
            return self.models.feat(to_unit(self._as_batch(images))).cpu().numpy()


def load_model(checkpoint_dir: str, config: ExperimentConfig | None = None,
               device: str | torch.device | None = None) -> DepthVO:
    """A trained model from a checkpoint directory of either package."""
    return DepthVO.from_checkpoint(checkpoint_dir, config, device)


def predict_depth(model: DepthVO, images) -> np.ndarray:
    """Functional alias: model + frames -> depth maps."""
    return model.depth(images)


def predict_pose(model: DepthVO, frame_a, frame_b) -> np.ndarray:
    """Functional alias: two frames (or batches) -> 4x4 relative transforms."""
    a = np.asarray(frame_a, np.float32)
    b = np.asarray(frame_b, np.float32)
    if a.ndim == 3:
        a, b = a[None], b[None]
    return model.pose(np.concatenate([a, b], axis=-1))
