"""Public inference API of the port (counterpart of ``depthvo_tpu/api.py``).

``DepthVO`` bundles a config and the three networks on one device:

* ``depth`` / ``inverse_depth``: RGB frames -> depth (1/disp) maps;
* ``pose``: frame pairs -> 4x4 relative transforms (target-cam ->
  source-cam), ``se3.exp`` of the odometry twist;
* ``features``: frames -> L2-normalised dense features.

Inputs are NHWC, float32 in [-1, 1] or raw uint8 (normalised on the
device with the loaders' ``x / 127.5 - 1``), numpy arrays or tensors;
outputs are numpy arrays. The handle runs on ``cuda`` unless it was made
with ``device="cpu"``, and raises when there is no GPU otherwise.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from depthvo_tpu_torch.configs.base import ExperimentConfig, full_feat
from depthvo_tpu_torch.geometry import se3
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

    def features(self, images) -> np.ndarray:
        """(B, H, W, 3) frames -> (B, H, W, feat_channels) features."""
        if self.models.feat is None:
            raise ValueError(f"stage {self.config.name!r} has no feature net")
        with torch.inference_mode():
            return self.models.feat(to_unit(self._as_batch(images))).cpu().numpy()
