"""The port's networks as the reference's parameter trees (the inverse of
``io/from_jax.py``).

The Caffe weight tools (``import_weights``, ``export_weights``,
``name_map``) work on flax-layout numpy trees, as in the reference:

* ``params[net]``: nested dicts by module path, conv ``kernel`` HWIO,
  Dense ``kernel`` (in, out), ``bias``, BatchNorm ``scale``/``bias``;
* ``batch_stats``: the depth net's BatchNorm ``mean``/``var``.

:func:`to_flax_layout` builds both from the port's networks, and
``from_jax.load_jax_params`` seats them back, leaf for leaf.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from depthvo_tpu_torch.train.state import Models


def state_dict_to_flax(sd) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """One network's state dict -> (params, batch_stats) as numpy trees."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, v in sd.items():
        *mods, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        x = v.detach().cpu().numpy()
        if leaf in ("running_mean", "running_var"):
            node, leaf = stats, leaf[len("running_"):]
        else:
            node = params
            if leaf == "weight" and x.ndim == 4:
                leaf, x = "kernel", x.transpose(2, 3, 1, 0)
            elif leaf == "weight" and x.ndim == 2:
                leaf, x = "kernel", x.T
            elif leaf == "weight":
                leaf = "scale"
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.array(x, np.float32, order="C")
    return params, stats


def to_flax_layout(models: Models) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The stage's networks -> (``{"depth": ..., "odom": ..., "feat": ...}``
    params, the depth net's batch_stats), the trees of the reference's
    ``create_state`` (only the networks present)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for name, net in zip(Models._fields, models):
        if net is None:
            continue
        params[name], s = state_dict_to_flax(net.state_dict())
        if s:
            stats = s
    return params, stats
