"""Carry JAX weights across to the port.

Turns a ``depthvo_tpu`` parameter tree (``create_state(...).params`` and
``.batch_stats``, nested dicts of arrays, e.g. after ``jax.device_get``)
into the port's state dicts. The port's modules carry flax's auto-names
(``ConvBlock_0/Conv_0``, ``ResNetStage_i/Bottleneck_j/ConvBlock_k``,
``UpConv_i``, ``Conv_i``, ``Dense_i``), so a path maps by joining with
``.`` and renaming the leaf:

* conv ``kernel`` HWIO -> ``weight`` OIHW; Dense ``kernel`` (in, out) ->
  ``weight`` (out, in); ``bias`` -> ``bias``;
* BatchNorm ``scale``/``bias`` (params) -> ``weight``/``bias``, and
  ``mean``/``var`` (batch_stats) -> ``running_mean``/``running_var``.

Nothing here imports JAX: arrays are read with ``numpy.asarray``. Every
leaf of both trees must be consumed and every parameter of the port's
networks filled, or the load raises.

:func:`quant_from_jax` carries a calibrated model's ``quant`` collection
(``.../ConvBlock_k/Conv_0/a_max``) across the same way: a conv's path
joined with ``.`` names its ``layers.QuantConv``.

:func:`train_state_from_jax` carries a whole saved train state across
(``io/orbax_reader.read_tree``: ``params``, ``batch_stats``, ``step`` and
optax's ``opt_state``) as :func:`train.state.state_dict`'s plain data, so
a run resumes with its solver moments, counts and accumulators
(:func:`opt_state_from_jax` maps the solver state).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from depthvo_tpu_torch.configs.base import ExperimentConfig
from depthvo_tpu_torch.train.state import Models, make_optimizer, param_tree

_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _convert_param(path: Tuple[str, ...], x: np.ndarray) -> Tuple[str, np.ndarray]:
    module, leaf = path[:-1], path[-1]
    is_bn = bool(module) and module[-1].startswith("BatchNorm_")
    if leaf == "kernel" and x.ndim == 4:
        name, x = "weight", x.transpose(3, 2, 0, 1)
    elif leaf == "kernel" and x.ndim == 2:
        name, x = "weight", x.T
    elif leaf == "scale" and is_bn:
        name = "weight"
    elif leaf == "bias":
        name = "bias"
    else:
        raise ValueError(f"unexpected parameter leaf {'/'.join(path)} {x.shape}")
    return ".".join(module + (name,)), x


def state_dict_from_jax(params: Mapping[str, Any],
                        batch_stats: Mapping[str, Any] | None = None
                        ) -> Dict[str, torch.Tensor]:
    """One network's flax ``params`` (and its ``batch_stats``, if it has
    BatchNorm) -> a torch state dict (float32, contiguous)."""
    out: Dict[str, torch.Tensor] = {}
    for path, x in _leaves(params):
        key, x = _convert_param(path, x)
        out[key] = torch.from_numpy(np.array(x, dtype=np.float32, order="C"))
    for path, x in _leaves(batch_stats or {}):
        if path[-1] not in _STATS:
            raise ValueError(f"unexpected batch_stats leaf {'/'.join(path)}")
        key = ".".join(path[:-1] + (_STATS[path[-1]],))
        out[key] = torch.from_numpy(np.array(x, dtype=np.float32, order="C"))
    return out


def params_from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any]
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A whole ``create_state`` tree -> ``{"depth": sd, "odom": sd, "feat": sd}``
    (only the networks present). The BatchNorm statistics belong to the
    depth network, the only one with BatchNorm."""
    unknown = set(params) - {"depth", "odom", "feat"}
    if unknown:
        raise ValueError(f"unexpected networks in params: {sorted(unknown)}")
    return {
        name: state_dict_from_jax(tree, batch_stats if name == "depth" else None)
        for name, tree in params.items()
    }


def seat_state_dict(net: torch.nn.Module, name: str,
                    sd: Mapping[str, torch.Tensor]) -> None:
    """Load a converted state dict into ``net`` (in place): every
    parameter and BatchNorm statistic filled, no key left over, shapes
    equal. The BatchNorm step counters, which flax does not have, may be
    left out (they then stay)."""
    target = net.state_dict()
    missing = sorted(k for k in set(target) - set(sd)
                     if not k.endswith("num_batches_tracked"))
    extra = sorted(set(sd) - set(target))
    if missing or extra:
        raise KeyError(f"{name}: missing {missing[:8]}, unexpected {extra[:8]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(target[k].shape):
            raise ValueError(
                f"{name}.{k}: shape {tuple(v.shape)} != {tuple(target[k].shape)}"
            )
    net.load_state_dict(sd, strict=False)


def quant_from_jax(quant: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``quant`` collection (nested dicts whose leaves are all ``a_max``
    scalars) -> ``{"<conv path>": float32 0-d tensor}``."""
    out: Dict[str, torch.Tensor] = {}
    for path, x in _leaves(quant):
        if path[-1] != "a_max" or x.size != 1:
            raise ValueError(f"unexpected quant leaf {'/'.join(path)} {x.shape}")
        out[".".join(path[:-1])] = torch.tensor(float(x.reshape(())), dtype=torch.float32)
    return out


def load_jax_params(models: Models, params: Mapping[str, Any],
                    batch_stats: Mapping[str, Any]) -> Models:
    """Load a JAX ``create_state`` tree into ``models`` (in place).

    Raises when a network of ``models`` has no parameters in the tree, a
    tree network has no module, a leaf has no parameter or buffer to go
    to, a parameter is left unfilled, or a shape differs.
    """
    converted = params_from_jax(params, batch_stats)
    for name in ("depth", "odom", "feat"):
        net = getattr(models, name)
        if (net is None) != (name not in converted):
            raise KeyError(
                f"{name}: the tree {'has' if name in converted else 'lacks'} "
                f"parameters the models {'lack' if net is None else 'need'}"
            )
        if net is not None:
            seat_state_dict(net, name, converted[name])
    return models


# --------------------------------------------------------------------------
# The solver state (optax's opt_state) and the whole train state.
# --------------------------------------------------------------------------

NETS = ("depth", "odom", "feat")

# The leaves optax's chain holds per solver (under ``make_optimizer``'s
# train label), in its order: one count per count-keeping transform and
# one per-parameter tree per moment. The port's chain
# (``train/state.py::make_optimizer``) holds the same in the same order.
SOLVER_LEAVES = {
    "adam": ("count", "mu", "nu", "count"),  # scale_by_adam, then the schedule
    "sgd": ("trace", "count"),
    "nesterov": ("trace", "count"),
    "adagrad": ("sum_of_squares", "count"),
    "rmsprop": ("nu", "count"),
    "adadelta": ("e_g", "e_x", "count"),
}
_MULTI_STEPS = ("mini_step", "gradient_step", "inner_opt_state", "acc_grads", "skip_state")


def _where(path: Sequence[str]) -> str:
    return "/".join(path)


def _is_param_tree(node: Any) -> bool:
    return isinstance(node, Mapping) and bool(node) and set(node) <= set(NETS)


def _slots(node: Any, path: Tuple[str, ...]) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """The reference's state leaves in orbax's order: each per-parameter
    tree whole, each array, and nothing for an empty state (``None``)."""
    if node is None:
        return
    if _is_param_tree(node) or not isinstance(node, Mapping):
        yield path, node
        return
    for k, v in node.items():
        yield from _slots(v, path + (str(k),))


def _count(x: Any, path: Tuple[str, ...]) -> int:
    x = np.asarray(x)
    if x.shape != () or x.dtype.kind not in "iu":
        raise ValueError(f"{_where(path)}: a count must be an integer scalar, got "
                         f"{x.dtype} {x.shape}")
    return int(x)


def _moments(tree: Any, path: Tuple[str, ...], keys: Sequence[str]) -> List[torch.Tensor]:
    """One per-parameter tree of the reference -> the port's tensors in
    ``keys`` order, each through its parameter's layout transform. A leaf
    saved without data must be a parameter the solver does not see (a
    frozen network's masked leaf); every key must be filled."""
    if not _is_param_tree(tree):
        raise ValueError(f"{_where(path)}: expected a tree over the networks "
                         f"{list(NETS)}, got {type(tree).__name__}")
    flat: Dict[str, torch.Tensor] = {}
    for net, sub in tree.items():
        stack = [((), sub)]
        while stack:
            sub_path, node = stack.pop()
            if isinstance(node, Mapping):
                stack.extend((sub_path + (str(k),), v) for k, v in node.items())
                continue
            if node is None:  # a leaf the solver does not see
                continue
            name, x = _convert_param(sub_path, np.asarray(node))
            flat[f"{net}.{name}"] = torch.from_numpy(np.array(x, order="C"))
    wanted = set(keys)
    carried = sorted(k for k in flat if k not in wanted)
    if carried:
        raise ValueError(
            f"{_where(path)}: the checkpoint holds solver state for {carried[:4]} "
            f"({len(carried)} leaves), which this config's solver does not train "
            "(another train_feat?); resuming would drop it")
    missing = sorted(wanted - set(flat))
    if missing:
        raise ValueError(
            f"{_where(path)}: no solver state for {missing[:4]} ({len(missing)} "
            "parameters): another train_feat or another network?")
    return [flat[k] for k in keys]


def _chain_state(tree: Any, path: Tuple[str, ...], config: ExperimentConfig,
                 param_keys: Sequence[str]) -> Any:
    """``optax.multi_transform``'s state of the train/freeze chain -> the
    port's ``masked(chain(...))`` state over ``param_keys``."""
    opt = config.optim.optimizer
    if not isinstance(tree, Mapping) or set(tree) != {"inner_states"}:
        raise ValueError(f"{_where(path)}: expected optax.multi_transform's state "
                         "(inner_states); another iter_size?")
    labels = tree["inner_states"]
    if set(labels) != {"train", "freeze"}:
        raise ValueError(f"{_where(path + ('inner_states',))}: labels {sorted(labels)}, "
                         "expected train and freeze")
    if any(v is not None for _, v in _slots(labels["freeze"], ())):
        raise ValueError(f"{_where(path + ('inner_states', 'freeze'))}: the frozen label "
                         "holds a state; the port's frozen leaves keep none")
    inner_path = path + ("inner_states", "train", "inner_state")
    found = list(_slots(labels["train"]["inner_state"], inner_path))
    names = tuple(p[-1] for p, _ in found)
    want = SOLVER_LEAVES[opt]
    if names != want:
        at = next((i for i in range(min(len(names), len(want))) if names[i] != want[i]),
                  min(len(names), len(want)) - 1)
        where = found[at][0] if found else inner_path
        raise ValueError(
            f"{_where(where)}: the checkpoint's solver state holds {list(names)}, where "
            f"this config's {opt!r} holds {list(want)} (another optimizer?)")
    # The parameters the solver trains: make_optimizer's mask.
    trained = [k for k in param_keys if config.train_feat or not k.startswith("feat.")]
    values = iter([_count(v, p) if n == "count" else _moments(v, p, trained)
                   for (p, v), n in zip(found, names)])
    chain = dataclasses.replace(config, optim=dataclasses.replace(config.optim, iter_size=1))
    template = make_optimizer(chain).init({k: torch.empty(0) for k in param_keys})

    def fill(t):
        if type(t) in (int, list):
            return next(values)
        return tuple(fill(x) for x in t)

    return fill(template)


def _inner_counts(state: Any) -> List[int]:
    if type(state) is int:
        return [state]
    if type(state) is tuple:
        return [c for x in state for c in _inner_counts(x)]
    return []


def opt_state_from_jax(opt_state: Mapping[str, Any], config: ExperimentConfig,
                       param_keys: Sequence[str]) -> Any:
    """The reference's optax state of ``make_optimizer(config)`` (as
    :func:`io.orbax_reader.read_tree` returns it) -> the port's solver
    state of ``train.state.make_optimizer(config)`` over ``param_keys``
    (:func:`train.state.param_tree`'s order).

    Every moment and accumulator goes through its parameter's layout
    transform (HWIO -> OIHW, transposed dense kernels, flax's BatchNorm
    ``scale`` -> ``weight``) in ``param_keys`` order; counts become Python
    ints. With ``iter_size > 1`` (``optax.MultiSteps``) ``mini_step`` and
    ``acc_grads`` carry over, and ``gradient_step`` must equal the inner
    chain's counts. A frozen network's moments are saved empty and carry
    nothing. Raises ``ValueError`` naming the path where the checkpoint's
    structure is not this config's: another optimizer, iter_size or
    train_feat."""
    keys = list(param_keys)
    k = config.optim.iter_size
    multi = isinstance(opt_state, Mapping) and "acc_grads" in opt_state
    if (k > 1) != multi:
        raise ValueError(
            f"opt_state: the checkpoint's solver {'accumulates' if multi else 'does not accumulate'}"
            f" micro-batches (optax.MultiSteps {'present' if multi else 'absent'}), this "
            f"config has iter_size {k}")
    if not multi:
        return _chain_state(opt_state, ("opt_state",), config, keys)
    if set(opt_state) != set(_MULTI_STEPS):
        raise ValueError(f"opt_state: MultiSteps fields {sorted(opt_state)}, expected "
                         f"{sorted(_MULTI_STEPS)}")
    if any(v is not None for _, v in _slots(opt_state["skip_state"], ())):
        raise ValueError("opt_state/skip_state: a skip state the port does not keep")
    mini_step = _count(opt_state["mini_step"], ("opt_state", "mini_step"))
    if not 0 <= mini_step < k:
        raise ValueError(f"opt_state/mini_step: {mini_step} micro-batches accumulated, "
                         f"which iter_size {k} does not allow (another iter_size?)")
    inner = _chain_state(opt_state["inner_opt_state"], ("opt_state", "inner_opt_state"),
                         config, keys)
    gradient_step = _count(opt_state["gradient_step"], ("opt_state", "gradient_step"))
    if any(c != gradient_step for c in _inner_counts(inner)):
        raise ValueError(f"opt_state/gradient_step: {gradient_step} updates, but the inner "
                         f"solver counts {_inner_counts(inner)}")
    acc = _moments(opt_state["acc_grads"], ("opt_state", "acc_grads"), keys)
    return (mini_step, acc, inner)


def train_state_from_jax(tree: Mapping[str, Any], config: ExperimentConfig,
                         models: Models) -> Dict[str, Any]:
    """A whole saved reference train state (:func:`io.orbax_reader.read_tree`)
    -> :func:`train.state.state_dict`'s plain data for ``models`` and
    ``make_optimizer(config)``, which :func:`train.state.load_state_dict`
    loads in place. The BatchNorm step counters, which flax does not have,
    keep ``models``' values."""
    nets = params_from_jax(tree["params"], tree["batch_stats"])
    for name, net in zip(Models._fields, models):
        if net is not None and name in nets:
            for k, v in net.state_dict().items():
                if k.endswith("num_batches_tracked"):
                    nets[name].setdefault(k, v.detach().to("cpu", copy=True))
    keys = list(param_tree(models))
    return {"step": _count(tree["step"], ("step",)), "nets": nets, "param_keys": keys,
            "opt_state": opt_state_from_jax(tree["opt_state"], config, keys)}
