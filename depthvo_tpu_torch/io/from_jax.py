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
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from depthvo_tpu_torch.train.state import Models

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
        if net is None:
            continue
        sd = converted[name]
        target = {
            k: v for k, v in net.state_dict().items()
            if not k.endswith("num_batches_tracked")
        }
        missing = sorted(set(target) - set(sd))
        extra = sorted(set(sd) - set(target))
        if missing or extra:
            raise KeyError(f"{name}: missing {missing[:8]}, unexpected {extra[:8]}")
        for k, v in sd.items():
            if tuple(v.shape) != tuple(target[k].shape):
                raise ValueError(
                    f"{name}.{k}: shape {tuple(v.shape)} != {tuple(target[k].shape)}"
                )
        net.load_state_dict(sd, strict=False)
    return models
