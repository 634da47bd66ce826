"""The three networks, their initial parameters, the learning-rate
schedule, the solver chain and the train state (counterpart of
``depthvo_tpu/train/state.py``).

The reference keeps parameters in a pytree beside stateless flax
modules; here the modules hold them. ``params`` below are the port's
state dicts, one per network: ``{"depth": ..., "odom": ..., "feat": ...}``
with only the networks the stage uses (the stereo stage has no odometry
or feature net, as in the reference's ``create_state``). The optimizer
sees the parameters as one flat dict ``{"depth.<name>": tensor, ...}``
(:func:`param_tree`); the BatchNorm statistics are the depth net's
buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from depthvo_tpu_torch.configs.base import ExperimentConfig
from depthvo_tpu_torch.models import DepthNet, FeatNet, OdomNet
from depthvo_tpu_torch.train import optim

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# flax's lecun_normal: a normal truncated at 2 std, rescaled so that the
# truncated distribution has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


class Models(NamedTuple):
    depth: DepthNet
    odom: Optional[OdomNet]
    feat: Optional[FeatNet]

    def train(self, mode: bool = True) -> "Models":
        """Train or eval mode for the stage's networks (the feature net
        stays in eval mode, see ``FeatNet.train``)."""
        for net in self:
            if net is not None:
                net.train(mode)
        return self


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


def build_models(config: ExperimentConfig, depth_quant: str = "off") -> Models:
    """The stage's networks on the CPU, in eval mode, with torch's default
    initialisation (load parameters with :func:`load_params`).

    ``depth_quant``: the DepthNet's quantization mode, "off" for training
    and the float forward, "calibrate" / "int8" for w8a8 serving
    (``api.DepthVO.calibrate_int8``). Quantized serving runs the standard
    finest stage: the reference's s2d rewrite is a training-speed lever,
    and its scales are defined on the standard conv shapes."""
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
        remat=mc.remat,
        # The standard stage's function; it still counts as a finest-stage
        # mode for the heads' mutual exclusion, as in the reference.
        s2d_finest=mc.s2d_finest and depth_quant == "off",
        decoder_features=tuple(mc.decoder_features),
        quant_mode=depth_quant,
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


# --------------------------------------------------------------------------
# Learning-rate schedule and the solver chain.
# --------------------------------------------------------------------------


def lr_schedule(oc) -> Callable[[int], float]:
    """The Caffe ``lr_policy`` family (``solver.cpp::GetLearningRate``) as
    a function of the optimizer-update count, evaluated in float32 as the
    reference's jnp expressions are. ``stepsize`` = ``lr_decay_steps``,
    ``gamma`` = ``lr_decay_factor``, ``power`` = ``lr_power``,
    ``max_iter`` = ``total_steps``."""
    f32 = np.float32
    base = f32(oc.learning_rate)
    gamma = f32(oc.lr_decay_factor)
    power = f32(oc.lr_power)
    stepsize = max(1, oc.lr_decay_steps)
    max_iter = max(1, oc.total_steps)
    policy = oc.lr_policy

    if policy == "fixed":
        return lambda i: float(base)
    if policy == "step":
        return lambda i: float(base * gamma ** np.floor(f32(i) / f32(stepsize)))
    if policy == "exp":
        return lambda i: float(base * gamma ** f32(i))
    if policy == "inv":
        return lambda i: float(base * (f32(1.0) + gamma * f32(i)) ** -power)
    if policy == "multistep":
        values = tuple(int(v) for v in oc.lr_step_values)
        if not values:
            raise ValueError("lr_policy='multistep' needs non-empty lr_step_values")
        return lambda i: float(base * gamma ** f32(sum(i >= v for v in values)))
    if policy == "poly":
        return lambda i: float(
            base * max(f32(0.0), f32(1.0) - f32(i) / f32(max_iter)) ** power
        )
    if policy == "sigmoid":
        return lambda i: float(
            base / (f32(1.0) + np.exp(-gamma * f32(i - stepsize)))
        )
    raise ValueError(
        f"unknown lr_policy {policy!r} (expected fixed/step/exp/inv/"
        f"multistep/poly/sigmoid)"
    )


def warmup_schedule(oc) -> Callable[[int], float]:
    """``optax.join_schedules([linear 0 -> lr over warmup_steps, decay],
    [warmup_steps])``: update 0 gets lr 0, and the decay policy counts
    from the end of the warmup. No warmup: the decay policy alone."""
    decay = lr_schedule(oc)
    warmup = oc.warmup_steps
    if warmup <= 0:
        return decay
    lr = np.float32(oc.learning_rate)

    def schedule(i: int) -> float:
        if i >= warmup:
            return decay(i - warmup)
        frac = np.float32(1.0) - np.float32(i) / np.float32(warmup)
        return float(-lr * frac + lr)

    return schedule


OPTIMIZERS = ("adam", "sgd", "nesterov", "adagrad", "rmsprop", "adadelta")


def make_optimizer(config: ExperimentConfig) -> optim.Transform:
    """The reference's chain: clip_by_global_norm, then the solver with
    the warmed-up schedule (adam as adamw with decoupled decay; the
    others with Caffe's L2 added first), with the feature net frozen
    unless ``train_feat`` and, for ``iter_size > 1``, gradient averaging
    over micro-batches (``optax.MultiSteps``)."""
    oc = config.optim
    schedule = warmup_schedule(oc)
    l2 = [optim.add_decayed_weights(oc.weight_decay)] if oc.weight_decay > 0.0 else []
    lr = optim.scale_by_learning_rate(schedule)
    if oc.optimizer == "adam":
        base = [optim.scale_by_adam(oc.beta1, oc.beta2, oc.delta), *l2, lr]
    elif oc.optimizer in ("sgd", "nesterov"):
        base = [*l2, optim.trace(oc.beta1, nesterov=oc.optimizer == "nesterov"), lr]
    elif oc.optimizer == "adagrad":
        base = [*l2, optim.scale_by_rss(0.1, oc.delta), lr]
    elif oc.optimizer == "rmsprop":
        base = [*l2, optim.scale_by_rms(oc.rms_decay, oc.delta), lr]
    elif oc.optimizer == "adadelta":
        base = [*l2, optim.scale_by_adadelta(oc.beta1, oc.delta), lr]
    else:
        raise ValueError(
            f"unknown optimizer {oc.optimizer!r} (expected {'/'.join(OPTIMIZERS)})"
        )
    tx = optim.chain(optim.clip_by_global_norm(oc.grad_clip_norm), *base)
    tx = optim.masked(
        tx, lambda key: config.train_feat or not key.startswith("feat.")
    )
    if oc.iter_size > 1:
        tx = optim.multi_steps(tx, oc.iter_size)
    return tx


# --------------------------------------------------------------------------
# Train state.
# --------------------------------------------------------------------------


def param_tree(models: Models) -> Dict[str, nn.Parameter]:
    """Every parameter of the stage's networks, ``"<net>.<name>"`` ->
    the live parameter, in a fixed order."""
    return {
        f"{name}.{k}": p
        for name, net in zip(Models._fields, models) if net is not None
        for k, p in net.named_parameters()
    }


@dataclasses.dataclass
class TrainState:
    """The networks (parameters and BatchNorm statistics), the solver's
    state and the count of train steps (micro-batches) taken."""

    step: int
    models: Models
    opt_state: Any


def create_state(config: ExperimentConfig, device: torch.device,
                 generator: torch.Generator | None = None,
                 tx: optim.Transform | None = None) -> TrainState:
    """Initial parameters of the stage's networks (drawn from
    ``generator``, default seeded with ``config.seed``) on ``device``,
    in train mode, with a fresh solver state."""
    if generator is None:
        generator = torch.Generator().manual_seed(config.seed)
    models = load_params(build_models(config), init_params(config, generator), device)
    tx = make_optimizer(config) if tx is None else tx
    return TrainState(0, models.train(), tx.init(param_tree(models)))


# --------------------------------------------------------------------------
# The train state as plain data (checkpoints).
# --------------------------------------------------------------------------


def _map_tree(tree: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    """Apply ``fn`` to every tensor of a solver state (nested tuples and
    lists of tensors and Python numbers, as ``train/optim.py`` builds)."""
    if torch.is_tensor(tree):
        return fn(tree)
    if type(tree) in (tuple, list):
        return type(tree)(_map_tree(t, fn) for t in tree)
    if type(tree) in (int, float):
        return tree
    raise TypeError(f"unexpected solver-state leaf {type(tree).__name__}")


def _same_structure(a: Any, b: Any, path: str = "opt_state") -> None:
    """Raise unless the solver states ``a`` and ``b`` have the same
    containers (a list and a tuple count as one: ``torch._foreach_*``
    return either), the same Python number types and the same tensor
    shapes and dtypes."""
    if torch.is_tensor(a) and torch.is_tensor(b):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"{path}: {tuple(b.shape)} {b.dtype} where the "
                             f"state has {tuple(a.shape)} {a.dtype}")
        return
    seqs = (tuple, list)
    if type(a) is not type(b) and not (type(a) in seqs and type(b) in seqs):
        raise ValueError(f"{path}: {type(b).__name__} where the state has "
                         f"{type(a).__name__}")
    if type(a) in seqs:
        if len(a) != len(b):
            raise ValueError(f"{path}: {len(b)} entries where the state has {len(a)}")
        for i, (x, y) in enumerate(zip(a, b)):
            _same_structure(x, y, f"{path}[{i}]")


def state_dict(state: TrainState) -> Dict[str, Any]:
    """The whole train state as plain data that ``torch.load(...,
    weights_only=True)`` reads back: ``step`` (int), ``nets`` (each stage
    network's ``state_dict()``, BatchNorm statistics included),
    ``param_keys`` (the solver's parameter order, :func:`param_tree`) and
    ``opt_state`` (the solver chain's nested tuples and lists, with its
    counts as Python ints). Every tensor is a CPU copy."""

    def cpu(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", copy=True)

    return {
        "step": int(state.step),
        "nets": {name: {k: cpu(v) for k, v in net.state_dict().items()}
                 for name, net in zip(Models._fields, state.models) if net is not None},
        "param_keys": list(param_tree(state.models)),
        "opt_state": _map_tree(state.opt_state, cpu),
    }


def _copy_into(dst: Any, src: Any) -> Any:
    """``src``'s numbers in ``dst``'s containers, with ``src``'s tensors
    copied into ``dst``'s (the same structure, :func:`_same_structure`)."""
    if torch.is_tensor(dst):
        return dst.copy_(src)
    if type(dst) in (tuple, list):
        return type(dst)(_copy_into(a, b) for a, b in zip(dst, src))
    return src


def load_state_dict(state: TrainState, d: Dict[str, Any]) -> TrainState:
    """Load :func:`state_dict`'s output into ``state`` in place (onto its
    networks' device). The stage's networks, the solver's parameter order
    and the solver state's structure must be the state's own. Every tensor
    keeps its storage (parameters, BatchNorm statistics, the solver's
    tensors), so a CUDA graph captured on ``state`` stays valid."""
    nets = {name: net for name, net in zip(Models._fields, state.models) if net is not None}
    if sorted(d["nets"]) != sorted(nets):
        raise KeyError(f"checkpoint networks {sorted(d['nets'])}, the state's {sorted(nets)}")
    if list(d["param_keys"]) != list(param_tree(state.models)):
        raise ValueError("the checkpoint's solver parameter order differs from the state's")
    _same_structure(state.opt_state, d["opt_state"])
    for name, net in nets.items():
        net.load_state_dict(d["nets"][name], strict=True)
    with torch.no_grad():
        state.opt_state = _copy_into(state.opt_state, d["opt_state"])
    state.step = int(d["step"])
    return state
