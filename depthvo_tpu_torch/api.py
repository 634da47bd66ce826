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

``calibrate_int8`` switches depth inference to the w8a8 program
(``layers.QuantConv``: int8 weights per output channel, static int8
activations per tensor, int32 accumulation through cuBLASLt's int8 GEMM
on the GPU); ``uncalibrate`` restores the float forward. ``quant`` holds
the recorded scales, nested like the reference's ``quant`` collection,
and ``set_quant`` seats such a tree (the port's or the reference's).
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
from depthvo_tpu_torch.io.from_jax import load_jax_params, quant_from_jax
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
        self._float_depth = None  # the float DepthNet while int8 is on
        self._quant_net = None  # the quantized DepthNet, once calibration began

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

    # ---- quantized serving ----
    @property
    def quant(self) -> Dict[str, Any] | None:
        """The recorded activation scales (``a_max`` per quantized conv,
        nested like the reference's ``quant`` collection), or ``None``."""
        return None if self._quant_net is None else self._quant_net.quant_tree()

    def _quantized_depth(self):
        if self._quant_net is None:
            net = build_models(self.config, depth_quant="calibrate").depth
            depth = self.models.depth if self._float_depth is None else self._float_depth
            net.load_state_dict(depth.state_dict())
            self._quant_net = net.to(self.device).eval()
        return self._quant_net

    def _use_int8(self) -> None:
        net = self._quant_net.set_quant_mode("int8")
        if self._float_depth is None:
            self._float_depth = self.models.depth
        self.models = self.models._replace(depth=net)

    def calibrate_int8(self, images) -> "DepthVO":
        """Switch depth inference to w8a8 int8 convolutions.

        Runs the calibration forward (the convs in the compute dtype) over
        ``images`` (representative frames, uint8 or [-1, 1] float),
        recording each quantized conv's running max ``|x|``; repeated calls
        accumulate it. Raises ``ValueError`` naming the layers whose scale
        is still zero (the images never reached them). The 1-channel disp
        heads and BatchNorm stay float. ``depth``, ``inverse_depth`` and
        the eval sweeps run the int8 program after this call. Returns
        self."""
        net = self._quantized_depth().set_quant_mode("calibrate")
        with torch.inference_mode():
            net(to_unit(self._as_batch(images)))
        bad = ["/".join(name.split(".")) + "/a_max" for name, conv in net.quant_convs().items()
               if not float(conv.a_max) > 0]
        if bad:
            raise ValueError(
                "calibrate_int8: calibration recorded zero activation "
                f"scales at {bad} — the calibration images never reached "
                "those convs (all-zero input?)"
            )
        self._use_int8()
        return self

    def set_quant(self, quant: Dict[str, Any]) -> "DepthVO":
        """Seat recorded scales (:attr:`quant` of this package or of the
        reference, leaf for leaf) and switch depth inference to int8.
        Every quantized conv must get its ``a_max`` and every leaf must
        find its conv. Returns self."""
        net = self._quantized_depth()
        convs = net.quant_convs()
        given = quant_from_jax(quant)
        missing = sorted(set(convs) - set(given))
        extra = sorted(set(given) - set(convs))
        if missing or extra:
            raise KeyError(f"quant: missing {missing[:8]}, unexpected {extra[:8]}")
        for name, a_max in given.items():
            convs[name].a_max.copy_(a_max)
        self._use_int8()
        return self

    def uncalibrate(self) -> "DepthVO":
        """Undo :meth:`calibrate_int8`: the float depth forward again (the
        same module as before, so bit for bit), scales dropped. Returns
        self."""
        if self._float_depth is not None:
            self.models = self.models._replace(depth=self._float_depth)
        self._float_depth = None
        self._quant_net = None
        return self

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
