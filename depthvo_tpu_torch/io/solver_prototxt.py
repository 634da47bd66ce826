"""Caffe ``solver.prototxt`` reader: run reference solver files unchanged.

The reference drives training with ``caffe train --solver=solver.prototxt``
(SURVEY §2a "Train launchers", §2b(ii) solver.cpp row). The rebuild's
native config surface is :class:`~depthvo_tpu_torch.configs.base.OptimConfig`,
but every knob a Depth-VO-Feat solver file sets now has an exact native
target (all six solver types, all seven lr policies, iter_size, clip,
snapshot cadence), so this module maps the file format itself:

    cfg, extras = apply_solver_prototxt(text, base_cfg)

``SolverParameter`` is a flat message, so the text format is line-based
``key: value`` pairs (protobuf TextFormat); no general prototxt parser is
needed. Unknown keys are collected — callers warn, not fail, because
solver files in the wild carry deploy-time fields (``solver_mode: GPU``,
``device_id``) that have no meaning here.

Parity map (Caffe field -> rebuild field):

    base_lr        -> optim.learning_rate
    lr_policy      -> optim.lr_policy        (same seven names)
    gamma          -> optim.lr_decay_factor
    power          -> optim.lr_power
    stepsize       -> optim.lr_decay_steps
    stepvalue*     -> optim.lr_step_values   (repeated)
    max_iter       -> optim.total_steps
    momentum       -> optim.beta1            (sgd/nesterov; adadelta rho)
    momentum2      -> optim.beta2            (adam)
    rms_decay      -> optim.rms_decay
    delta          -> optim.delta
    weight_decay   -> optim.weight_decay
    clip_gradients -> optim.grad_clip_norm
    iter_size      -> optim.iter_size
    type / solver_type -> optim.optimizer    (SGD/Nesterov/AdaGrad/
                                              RMSProp/AdaDelta/Adam)
    snapshot       -> config.checkpoint_every
    display        -> config.log_every
    test_interval  -> extras["eval_every"]   (loop args, not config)
    test_iter      -> extras["eval_steps"]

The port's own copy of ``depthvo_tpu/io/solver_prototxt.py``, over the
port's own ``configs/base.py``: numpy and the standard library only, the
same functions and the same results.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Tuple

from depthvo_tpu_torch.configs.base import ExperimentConfig, OptimConfig

# Caffe `type:` strings (new style) and `solver_type:` enums (old style).
_SOLVER_TYPES = {
    "sgd": "sgd",
    "nesterov": "nesterov",
    "adagrad": "adagrad",
    "rmsprop": "rmsprop",
    "adadelta": "adadelta",
    "adam": "adam",
}

_LINE = re.compile(
    r"""^\s*([A-Za-z_][A-Za-z0-9_]*)\s*:\s*      # key:
        ("(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*'|[^\#]*?)   # value (quoted or bare)
        \s*(?:\#.*)?$                             # trailing comment
    """,
    re.VERBOSE,
)


def parse_solver_prototxt(text: str) -> Dict[str, Any]:
    """Parse solver.prototxt text into ``{key: value-or-list}``.

    Values are coerced: quoted strings lose their quotes, ``true/false``
    become bools, numbers become int/float. Repeated keys (``stepvalue``)
    accumulate into a list. Raises ValueError on a line that is neither
    blank, comment, nor ``key: value`` (nested messages like ``train_state
    { ... }`` are not part of SolverParameter's scalar surface we map and
    are rejected loudly rather than misread).
    """
    out: Dict[str, Any] = {}
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE.match(raw)
        if not m:
            raise ValueError(f"solver.prototxt line {ln}: cannot parse {raw!r}")
        key, val = m.group(1), m.group(2).strip()
        if val and val[0] in "\"'":
            value: Any = val[1:-1]
        elif val.lower() in ("true", "false"):
            value = val.lower() == "true"
        else:
            try:
                value = int(val)
            except ValueError:
                try:
                    value = float(val)
                except ValueError:
                    value = val  # bare enum token, e.g. solver_type: ADAM
        if key in out:
            prev = out[key]
            if isinstance(prev, list):
                prev.append(value)
            else:
                out[key] = [prev, value]
        else:
            out[key] = value
    return out


def apply_solver_prototxt(
    text: str, base: ExperimentConfig
) -> Tuple[ExperimentConfig, Dict[str, Any]]:
    """Overlay a Caffe solver file onto ``base``.

    Returns ``(config, extras)`` where ``extras`` carries loop-level
    settings that are fit() arguments rather than config fields
    (``eval_every``/``eval_steps`` from test_interval/test_iter) plus
    ``ignored``: the solver keys with no meaning in this runtime
    (solver_mode, device_id, net/snapshot paths, ...) for the caller to
    surface. Fields the file does not set keep ``base``'s values.
    """
    fields = parse_solver_prototxt(text)
    optim: Dict[str, Any] = {}
    cfg_over: Dict[str, Any] = {}
    extras: Dict[str, Any] = {}
    ignored: List[str] = []

    scalar_map = {
        "base_lr": ("learning_rate", float),
        "lr_policy": ("lr_policy", str),
        "gamma": ("lr_decay_factor", float),
        "power": ("lr_power", float),
        "stepsize": ("lr_decay_steps", int),
        "max_iter": ("total_steps", int),
        "momentum": ("beta1", float),
        "momentum2": ("beta2", float),
        "rms_decay": ("rms_decay", float),
        "delta": ("delta", float),
        "weight_decay": ("weight_decay", float),
        "clip_gradients": ("grad_clip_norm", float),
        "iter_size": ("iter_size", int),
    }
    for key, value in fields.items():
        if key in scalar_map:
            name, cast = scalar_map[key]
            optim[name] = cast(value)
        elif key == "stepvalue":
            vals = value if isinstance(value, list) else [value]
            optim["lr_step_values"] = tuple(int(v) for v in vals)
        elif key in ("type", "solver_type"):
            solver = _SOLVER_TYPES.get(str(value).lower())
            if solver is None:
                raise ValueError(
                    f"unsupported solver type {value!r} "
                    f"(expected one of {sorted(_SOLVER_TYPES)})"
                )
            optim["optimizer"] = solver
        elif key == "snapshot":
            cfg_over["checkpoint_every"] = int(value)
        elif key == "display":
            cfg_over["log_every"] = int(value)
        elif key == "test_interval":
            extras["eval_every"] = int(value)
        elif key == "test_iter":
            v = value[0] if isinstance(value, list) else value
            extras["eval_steps"] = int(v)
        else:
            ignored.append(key)

    # Caffe has no warmup: a solver file defines the WHOLE schedule, so
    # the overlay disables the rebuild's default warmup ramp (users who
    # want warmup set it in the native config, not the prototxt).
    optim.setdefault("warmup_steps", 0)

    cfg = dataclasses.replace(
        base,
        optim=dataclasses.replace(base.optim, **optim),
        **cfg_over,
    )
    extras["ignored"] = ignored
    return cfg, extras
