"""The three networks and their initial parameters (counterpart of
``depthvo_tpu/train/state.py``).

The reference keeps parameters in a pytree beside stateless flax
modules; here the modules hold them. ``params`` below are the port's
state dicts, one per network: ``{"depth": ..., "odom": ..., "feat": ...}``
with only the networks the stage uses (the stereo stage has no odometry
or feature net, as in the reference's ``create_state``). The optimizer
state and ``create_state`` come with the training slice.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from depthvo_tpu_torch.configs.base import ExperimentConfig
from depthvo_tpu_torch.models import DepthNet, FeatNet, OdomNet

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# flax's lecun_normal: a normal truncated at 2 std, rescaled so that the
# truncated distribution has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


class Models(NamedTuple):
    depth: DepthNet
    odom: Optional[OdomNet]
    feat: Optional[FeatNet]


def compute_dtype(config: ExperimentConfig) -> torch.dtype:
    try:
        return DTYPES[config.model.compute_dtype]
    except KeyError:
        raise ValueError(
            f"compute_dtype {config.model.compute_dtype!r} not in {sorted(DTYPES)}"
        ) from None


def stage_nets(config: ExperimentConfig):
    """Names of the networks the config's stage uses."""
    return ("depth",) + (("odom",) if config.use_temporal else ()) + (
        ("feat",) if config.use_feature else ()
    )


def build_models(config: ExperimentConfig) -> Models:
    """The stage's networks on the CPU, in eval mode, with torch's default
    initialisation (load parameters with :func:`load_params`)."""
    mc = config.model
    dt = compute_dtype(config)
    nets = stage_nets(config)
    depth = DepthNet(
        num_scales=mc.num_scales,
        max_disp=mc.max_disp,
        min_disp=mc.min_disp,
        compute_dtype=dt,
        fast_final_upsample=mc.fast_final_upsample,
        subpixel_head=mc.subpixel_head,
        decoder_features=tuple(mc.decoder_features),
    )
    odom = OdomNet(compute_dtype=dt).eval() if "odom" in nets else None
    feat = (
        FeatNet(out_features=mc.feat_channels, compute_dtype=dt).eval()
        if "feat" in nets else None
    )
    return Models(depth.eval(), odom, feat)


def _init_module_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisation: lecun-normal kernels, zero biases,
    identity BatchNorm (scale 1, bias 0, mean 0, var 1)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
            with torch.no_grad():
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def init_params(config: ExperimentConfig,
                generator: torch.Generator) -> Dict[str, Dict[str, torch.Tensor]]:
    """Initial parameters of the stage's networks, drawn from ``generator``."""
    models = build_models(config)
    params = {}
    for name in stage_nets(config):
        net = getattr(models, name)
        _init_module_(net, generator)
        params[name] = net.state_dict()
    return params


def load_params(models: Models, params: Dict[str, Dict[str, torch.Tensor]],
                device: torch.device) -> Models:
    """Load ``params`` strictly into the stage's networks and move them to
    ``device``. Every stage network must have parameters."""
    for name in ("depth", "odom", "feat"):
        net = getattr(models, name)
        if net is None:
            continue
        if name not in params:
            raise KeyError(f"no parameters for the {name} network")
        net.load_state_dict(params[name], strict=True)
        net.to(device)
    return models
