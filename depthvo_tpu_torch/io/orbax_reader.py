"""Read a checkpoint that the JAX package wrote.

``depthvo_tpu/io/checkpoint.py`` saves a whole train state with orbax's
``StandardSave``: ``<dir>/<step>/default/`` holds ``_METADATA`` (the
tree's key paths), ``manifest.ocdbt`` and ``ocdbt.process_0/``, an OCDBT
key-value store in which each array is a zarr array under its dotted
path (``params.depth.Conv_0.kernel/.zarray``, ``.../0``). This module
reads the tree with ``tensorstore`` (imported inside the functions: it is
needed only for such directories): ``params`` and ``batch_stats`` for the
weight readers, and also ``step`` and the optax ``opt_state`` to resume a
run (:func:`depthvo_tpu_torch.io.from_jax.train_state_from_jax`). The
empty states of the solver chain (a clip, a decay, a frozen network's
masked leaves, MultiSteps' skip state) hold no array; orbax records them
without data and :func:`read_tree` as ``None``.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Any, Dict, Sequence, Tuple

import numpy as np

SUBTREES = ("params", "batch_stats")  # the weights, read as float32


def is_reference_step(step_dir: str) -> bool:
    """True for a step directory in the JAX package's orbax layout."""
    return os.path.isfile(os.path.join(step_dir, "default", "_METADATA"))


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading a checkpoint of the JAX package (orbax/OCDBT) needs the "
            "`tensorstore` package, which is not installed; checkpoints the "
            "port writes itself need nothing extra. To carry a reference run's "
            "whole state to a machine without it, resume it on a machine that "
            "has it (io.checkpoint.maybe_restore) and save it there "
            "(io.checkpoint.save): that writes the port's format"
        ) from e
    return tensorstore


def read_tree(step_dir: str, subtrees: Sequence[str] | None = None) -> Dict[str, Any]:
    """The saved tree of one step directory as nested dicts keyed as in the
    JAX state (tuple positions as ``"0"``, ``"1"``, ...; named-tuple fields
    by name), in the order orbax flattened it. ``subtrees`` picks top-level
    entries (default: all, i.e. ``params``, ``batch_stats``, ``opt_state``
    and ``step``). Arrays are numpy: float32 for ``params`` and
    ``batch_stats``, the saved dtype elsewhere (counts are int32); a leaf
    saved without data (an empty state) is ``None``."""
    ts = _tensorstore()
    root = os.path.join(os.path.abspath(step_dir), "default")
    with open(os.path.join(root, "_METADATA")) as f:
        meta = json.load(f)["tree_metadata"]
    base = {"driver": "ocdbt", "base": "file://" + root + "/"}
    out: Dict[str, Any] = {}
    for key, entry in meta.items():
        path = ast.literal_eval(key)
        if subtrees is not None and path[0] not in subtrees:
            continue
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if entry["value_metadata"].get("skip_deserialize"):  # no data: an empty state
            node[path[-1]] = None
            continue
        arr = ts.open({"driver": "zarr",
                       "kvstore": dict(base, path=".".join(path) + "/")}).result()
        x = np.asarray(arr.read().result())
        node[path[-1]] = x.astype(np.float32) if path[0] in SUBTREES else x
    return out


def read_weights(step_dir: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, batch_stats) of one step directory."""
    tree = read_tree(step_dir, SUBTREES)
    return tree.get("params", {}), tree.get("batch_stats", {})
