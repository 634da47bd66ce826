"""Generate the fidelity-gate ``name_map`` from a ``.caffemodel`` itself.

``import_by_name`` (the trustworthy strategy for real released weights —
SURVEY.md §7 step 2) needs a ``{caffe_layer_name -> flax module path}``
map. Hand-writing one for a ResNet-50 is ~100 error-prone entries, so
this module derives it mechanically and, crucially, makes the derivation
AUDITABLE:

- flax kernels and Caffe layers are grouped by their converted shape
  *signature* (HWIO for convs, (in, out) for dense); within a signature
  class the pairing is by relative order — stable under any file
  permutation that moves layers BETWEEN classes (the dangerous kind the
  shape-order importer mis-seats on is within-class, and those pairs are
  explicitly flagged ``order-trusted`` in the report so a human can
  check exactly the entries that rest on an ordering assumption);
- an optional companion prototxt (``io/net_prototxt.py``) cross-checks
  that every learnable layer the graph declares exists in the weights
  file with the declared ``num_output`` — catching a wrong-file pairing
  before a single weight is seated.

The output JSON ({"convs": {...}, "bns": {...}}) is exactly what
``import-caffemodel --name-map`` consumes, so the flow for released
weights is::

    depthvo make-name-map --caffemodel m.caffemodel --net depth \
        --proto train.prototxt --output map.json   # inspect the report!
    depthvo import-caffemodel --caffemodel m.caffemodel --net depth \
        --name-map map.json --proto train.prototxt --checkpoint-dir ck

The port's own copy of ``depthvo_tpu/io/name_map.py``: numpy and the standard
library only, the same functions and the same results.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from depthvo_tpu_torch.io import caffemodel
from depthvo_tpu_torch.io.import_weights import _flatten_with_path

__all__ = ["generate_name_map", "format_map_report", "MapEntry"]


@dataclasses.dataclass(frozen=True)
class MapEntry:
    caffe_layer: str
    flax_path: str
    signature: Tuple[int, ...]
    class_size: int  # >1 == pairing relies on relative order

    @property
    def order_trusted(self) -> bool:
        return self.class_size > 1


def _is_deconv(layer: Dict) -> bool:
    """Caffe Deconvolution stores (C_in, C_out/group, kh, kw) — the
    input/output axes are SWAPPED relative to Convolution's OIHW.
    Legacy V1LayerParameter encodes the type as enum 39."""
    t = layer.get("type", "")
    return (isinstance(t, str) and t.lower() == "deconvolution") or t == 39


def _caffe_kernel_shape(layer: Dict) -> Optional[Tuple[int, ...]]:
    """Converted (flax-side) shape of a learnable layer's kernel."""
    if not layer["blobs"]:
        return None
    w = layer["blobs"][0]
    if w.ndim == 4:  # OIHW (deconv: IOHW) -> HWIO
        o, i, h, ww = w.shape
        if _is_deconv(layer):
            o, i = i, o
        return (h, ww, i, o)
    if w.ndim == 2:  # (out, in) -> (in, out)
        return (w.shape[1], w.shape[0])
    return None


def _caffe_out_channels(layer: Dict) -> int:
    """Output channels of a learnable layer's first blob (the quantity
    the prototxt declares as ``num_output``)."""
    w = layer["blobs"][0]
    if w.ndim == 4 and _is_deconv(layer):
        return int(w.shape[1])
    return int(w.shape[0])


def _pair_by_signature(
    targets: List[Tuple[str, Tuple[int, ...]]],
    sources: List[Tuple[str, Tuple[int, ...]]],
    what: str,
    strict: bool,
) -> Tuple[List[MapEntry], List[str]]:
    """Pair (flax_path, sig) targets with (caffe_name, sig) sources.

    Within each signature class, pairing is by relative order. Returns
    (entries, problems); strict raises on any class-count mismatch.
    """
    by_sig_t: Dict[Tuple[int, ...], List[str]] = {}
    for path, sig in targets:
        by_sig_t.setdefault(sig, []).append(path)
    by_sig_s: Dict[Tuple[int, ...], List[str]] = {}
    for name, sig in sources:
        by_sig_s.setdefault(sig, []).append(name)

    entries: List[MapEntry] = []
    problems: List[str] = []
    for sig, paths in by_sig_t.items():
        names = by_sig_s.get(sig, [])
        n = min(len(paths), len(names))
        size = max(len(paths), len(names))
        for path, name in zip(paths[:n], names[:n]):
            entries.append(MapEntry(name, path, sig, size))
        for path in paths[n:]:
            problems.append(
                f"{what}: no imported layer of shape {sig} left for {path}"
            )
        for name in names[n:]:
            problems.append(
                f"{what}: imported layer {name!r} of shape {sig} has no "
                "model target"
            )
    for sig, names in by_sig_s.items():
        if sig not in by_sig_t:
            for name in names:
                problems.append(
                    f"{what}: imported layer {name!r} of shape {sig} has no "
                    "model target"
                )
    if strict and problems:
        raise ValueError(
            f"generate_name_map: {len(problems)} unmatched {what} entries:\n"
            + "\n".join(problems)
        )
    return entries, problems


def generate_name_map(
    layers: Dict[str, Dict],
    params: Any,
    batch_stats: Any = None,
    *,
    proto_facts: Any = None,
    strict: bool = True,
) -> Tuple[Dict[str, Dict[str, str]], List[MapEntry], List[str]]:
    """Derive ``{"convs": ..., "bns": ...}`` from parsed Caffe layers.

    Args:
      layers: ``caffemodel.parse_caffemodel`` output (file order).
      params / batch_stats: the target flax trees (traversal order).
      proto_facts: optional ``net_prototxt.NetFacts`` of the companion
        prototxt — cross-checks declared learnable layers/num_output
        against the weights file.
      strict: raise on unmatched classes or prototxt disagreement.

    Returns ``(map_json, entries, problems)`` where ``map_json`` feeds
    ``import_weights.import_net(name_map=..., bn_name_map=...)``.
    """
    # Convs/dense: flax kernels in traversal order.
    kernel_targets = [
        (".".join(path[:-1]), tuple(leaf.shape))
        for path, leaf in _flatten_with_path(params)
        if path[-1] == "kernel"
    ]
    conv_sources = []
    for name, layer in layers.items():
        sig = _caffe_kernel_shape(layer)
        if sig is not None and len(layer["blobs"][0].shape) in (2, 4):
            # BatchNorm stores a 3-blob (mean, var, factor) set whose
            # first blob is 1-d; Scale is 1-2 blobs of 1-d — neither
            # passes the ndim filter, so only learnable kernels land here.
            conv_sources.append((name, sig))
    conv_entries, problems = _pair_by_signature(
        kernel_targets, conv_sources, "conv", strict
    )

    # BN: flax modules holding a 1-d `scale`; Caffe BatchNorm layers
    # (3 blobs: mean, var, count-factor). Signature = channel count.
    bn_entries: List[MapEntry] = []
    if batch_stats is not None:
        bn_targets = [
            (".".join(path[:-1]), (int(leaf.shape[0]),))
            for path, leaf in _flatten_with_path(params)
            if path[-1] == "scale" and leaf.ndim == 1
        ]
        bn_sources = []
        for name, layer in layers.items():
            blobs = layer["blobs"]
            if len(blobs) == 3 and blobs[0].ndim == 1 and blobs[2].size == 1:
                bn_sources.append((name, (int(blobs[0].shape[0]),)))
        bn_entries, bn_problems = _pair_by_signature(
            bn_targets, bn_sources, "bn", strict
        )
        problems += bn_problems

    # Prototxt cross-check: the graph's learnable layers must exist in
    # the weights file with the declared output channels.
    if proto_facts is not None:
        problems += _check_against_proto(layers, proto_facts, strict)

    map_json = {
        "convs": {e.caffe_layer: e.flax_path for e in conv_entries},
        "bns": {e.caffe_layer: e.flax_path for e in bn_entries},
    }
    return map_json, conv_entries + bn_entries, problems


def _check_against_proto(
    layers: Dict[str, Dict], facts: Any, strict: bool
) -> List[str]:
    """Cross-check the prototxt's declared learnable layers.

    A ``num_output`` disagreement on a layer PRESENT in the weights file
    is a hard mismatch (strict raises: the files do not pair). A layer
    declared but absent is only reported: the documented companion may be
    the full siamese TRAIN graph, which declares towers (odometry, the
    second depth tower, the feature net) that live in other
    ``.caffemodel`` files."""
    problems: List[str] = []
    mismatches: List[str] = []
    declared = getattr(facts, "learnable_layers", None) or []
    for name, num_output in declared:
        layer = layers.get(name)
        if layer is None or not layer["blobs"]:
            problems.append(
                f"proto: layer {name!r} declared in the prototxt carries "
                "no blobs in this caffemodel (another net's tower, or a "
                "genuinely missing layer — check which)"
            )
            continue
        out_ch = _caffe_out_channels(layer)
        if num_output and out_ch != int(num_output):
            mismatches.append(
                f"proto: {name!r} declares num_output={num_output} but the "
                f"caffemodel blob has {out_ch} output channels"
            )
    if strict and mismatches:
        raise ValueError(
            "generate_name_map: prototxt/caffemodel disagree:\n"
            + "\n".join(mismatches)
        )
    return mismatches + problems


def format_map_report(entries: List[MapEntry], problems: List[str]) -> str:
    """Audit view: every pair, with order-trusted entries flagged."""
    lines = []
    n_order = sum(1 for e in entries if e.order_trusted)
    lines.append(
        f"{len(entries)} placements ({len(entries) - n_order} shape-unique, "
        f"{n_order} order-trusted within a shape class)"
    )
    for e in entries:
        tag = (f"  [order-trusted /{e.class_size}]" if e.order_trusted
               else "  [unique]")
        lines.append(f"  {e.caffe_layer:35s} -> {e.flax_path:45s}"
                     f" {tuple(e.signature)}{tag}")
    for p in problems:
        lines.append(f"  PROBLEM: {p}")
    return "\n".join(lines)
