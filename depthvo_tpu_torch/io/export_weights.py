"""Export flax parameter trees to the Caffe model-zoo format.

The inverse of ``import_weights.py`` (SURVEY.md §2b(ii) ``caffe.proto``
row, PARITY.md "Docs / model zoo"): walk a model's params in the same
traversal order the importer consumes, convert each kernel back to Caffe
conventions (HWIO -> OIHW, first conv flipped to BGR, Dense transposed),
split each BatchNorm into the Caffe BatchNorm+Scale layer pair, and
serialize with ``caffemodel.write_caffemodel``.

Round-trip contract (tested): ``import_by_shape_order`` +
``import_bn_by_order`` over an exported file reproduce the original
params/batch_stats exactly. Files also parse under real Caffe tooling —
only public frozen field numbers of caffe.proto are emitted.

The port's own copy of ``depthvo_tpu/io/export_weights.py``: numpy and the standard
library only, the same functions and the same results.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np

from depthvo_tpu_torch.io import caffemodel
from depthvo_tpu_torch.io.import_weights import _flatten_with_path


def export_layers(
    params: Any,
    batch_stats: Any = None,
    prefix: str = "",
    flip_bgr_first_conv: bool = True,
) -> List[Tuple[str, str, List[np.ndarray]]]:
    """Flax params (+ optional batch_stats) -> Caffe layer list.

    Layers are emitted in pytree traversal order (the order the shape-
    ordered importer consumes): conv/dense kernels with their biases,
    then BatchNorm+Scale pairs in BatchNorm-module order.
    """
    flat = _flatten_with_path(params)
    leaves = dict(flat)
    stats = dict(_flatten_with_path(batch_stats)) if batch_stats is not None else {}
    layers: List[Tuple[str, str, List[np.ndarray]]] = []

    first_conv = flip_bgr_first_conv
    for path, leaf in flat:
        if path[-1] != "kernel":
            continue
        name = prefix + ".".join(path[:-1])
        blobs: List[np.ndarray] = []
        if leaf.ndim == 4:
            w = caffemodel.hwio_to_oihw(leaf)
            if first_conv:
                # Caffe-ecosystem files consume BGR; flip the RGB-trained
                # first conv so the export is a faithful Caffe model (the
                # importer flips it back). Triplet-wise: a 6-channel
                # two-frame input keeps its frame order.
                w = w[:, caffemodel._bgr_group_index(w.shape[1])].copy()
                first_conv = False
            blobs.append(w)
            type_str = "Convolution"
        else:  # Dense: flax (in, out) -> Caffe InnerProduct (out, in)
            blobs.append(np.transpose(leaf).copy())
            type_str = "InnerProduct"
        bias = leaves.get(path[:-1] + ("bias",))
        if bias is not None:
            blobs.append(np.asarray(bias))
        layers.append((name, type_str, blobs))

    for path, leaf in flat:
        if path[-1] != "scale" or leaf.ndim != 1:
            continue
        module = path[:-1]
        mean = stats.get(module + ("mean",), np.zeros_like(leaf))
        var = stats.get(module + ("var",), np.ones_like(leaf))
        name = prefix + ".".join(module)
        # Caffe stores stats pre-multiplied by a running count; emit
        # factor 1 so mean/var are stored verbatim.
        layers.append(
            (name + "/bn", "BatchNorm",
             [np.asarray(mean), np.asarray(var), np.ones((1,), np.float32)])
        )
        beta = leaves.get(module + ("bias",), np.zeros_like(leaf))
        layers.append((name + "/scale", "Scale", [np.asarray(leaf), np.asarray(beta)]))

    return layers


def export_caffemodel(
    params: Any,
    batch_stats: Any = None,
    path: str | None = None,
    net_name: str = "depthvo_tpu",
    flip_bgr_first_conv: bool = True,
) -> bytes:
    """One-call export: flax tree(s) -> .caffemodel bytes (and file)."""
    layers = export_layers(
        params, batch_stats, flip_bgr_first_conv=flip_bgr_first_conv
    )
    return caffemodel.write_caffemodel(layers, path=path, net_name=net_name)
