"""Read the weights of a checkpoint that the JAX package wrote.

``depthvo_tpu/io/checkpoint.py`` saves a whole train state with orbax's
``StandardSave``: ``<dir>/<step>/default/`` holds ``_METADATA`` (the
tree's key paths), ``manifest.ocdbt`` and ``ocdbt.process_0/``, an OCDBT
key-value store in which each array is a zarr array under its dotted
path (``params.depth.Conv_0.kernel/.zarray``, ``.../0``). This module
reads the ``params`` and ``batch_stats`` subtrees with ``tensorstore``
(imported inside the functions: it is needed only for such directories)
and hands them to :mod:`depthvo_tpu_torch.io.from_jax`. The solver state
of such a checkpoint is not read.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Any, Dict, Tuple

import numpy as np

SUBTREES = ("params", "batch_stats")


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
            "port writes itself need nothing extra"
        ) from e
    return tensorstore


def read_tree(step_dir: str) -> Dict[str, Any]:
    """``{"params": {...}, "batch_stats": {...}}`` of one step directory,
    nested dicts of float32 numpy arrays keyed as in the flax tree."""
    ts = _tensorstore()
    root = os.path.join(os.path.abspath(step_dir), "default")
    with open(os.path.join(root, "_METADATA")) as f:
        paths = [ast.literal_eval(k) for k in json.load(f)["tree_metadata"]]
    base = {"driver": "ocdbt", "base": "file://" + root + "/"}
    out: Dict[str, Any] = {name: {} for name in SUBTREES}
    for path in paths:
        if path[0] not in SUBTREES:
            continue
        arr = ts.open({"driver": "zarr",
                       "kvstore": dict(base, path=".".join(path) + "/")}).result()
        node = out[path[0]]
        for key in path[1:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.asarray(arr.read().result(), np.float32)
    return out


def read_weights(step_dir: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, batch_stats) of one step directory."""
    tree = read_tree(step_dir)
    return tree["params"], tree["batch_stats"]
