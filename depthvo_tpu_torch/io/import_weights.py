"""Bridge imported Caffe layers into flax parameter trees.

Completes the fidelity-gate path (SURVEY.md §7 step 2): ``caffemodel.py``
parses the released file into {layer_name: blobs}; this module places
those blobs into a model's parameter pytree. Two strategies:

* :func:`import_by_name` — an explicit ``name_map``
  {caffe_layer_name -> dotted flax module path}; each entry is placed
  with a strict shape check and a full assignment report; model params
  not covered by the map fall back to shape-order against the layers the
  map did not consume. This is the strategy to use with real released
  weights, where a ResNet-50 is full of identically-shaped 1x1/3x3
  kernels and file order cannot be trusted to match traversal order.
* :func:`import_by_shape_order` — walk the flax params in definition
  order and consume imported conv/BN/dense layers in file order wherever
  shapes agree exactly. Fine for self-produced files (our exporter
  writes traversal order) and as the fallback above.

BN+Scale pairs go through :func:`import_bn_by_name` /
:func:`import_bn_by_order` analogously.

The port's copy of ``depthvo_tpu/io/import_weights.py``. It fills the
same flax-layout numpy trees (HWIO kernels; BatchNorm ``scale``/``bias``
params and ``mean``/``var`` batch_stats) as the reference, walked in the
reference's order (dict keys sorted, depth first) without JAX;
``io/from_jax.py`` seats such a tree into the port's networks and
``io/to_flax_layout.py`` makes one from them.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

from collections.abc import Mapping

import numpy as np

from depthvo_tpu_torch.io import caffemodel


def _flatten_with_path(tree: Any, prefix: Tuple[str, ...] = ()
                       ) -> List[Tuple[Tuple[str, ...], np.ndarray]]:
    """(path, leaf) pairs in the reference's pytree order: a dict's keys
    sorted, depth first; ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree):
            out.extend(_flatten_with_path(tree[k], prefix + (k,)))
        return out
    return [(prefix, np.asarray(tree))]


def import_by_shape_order(
    layers: Dict[str, Dict],
    params: Any,
    flip_bgr_first_conv: bool = True,
    strict: bool = False,
) -> Tuple[Any, Dict[str, str]]:
    """Fill ``params`` (a flax params pytree) from parsed Caffe layers.

    Walks the model's conv/dense kernels in traversal order and the
    imported layers in file order; a layer is consumed when its converted
    kernel shape matches the next unfilled parameter of the same kind.
    Biases ride along with their kernel's layer.

    Returns (new_params, assignment_report {param_path: caffe_layer}).
    With ``strict`` raises if any model parameter goes unmatched.
    """
    flat = _flatten_with_path(params)
    # Work on a mutable dict copy of the pytree.
    leaves = {path: leaf.copy() for path, leaf in flat}
    report: Dict[str, str] = {}

    conv_layers = [
        (name, l)
        for name, l in layers.items()
        if l["blobs"] and l["blobs"][0].ndim in (2, 4)
    ]
    used = set()
    first_conv_seen = False

    kernel_paths = [p for p, v in flat if p[-1] == "kernel"]
    for path in kernel_paths:
        target_shape = leaves[path].shape
        for name, layer in conv_layers:
            if name in used:
                continue
            w = layer["blobs"][0]
            # Only a conv consuming raw frames (3 stacked-RGB channels,
            # or 6 for two-frame inputs) can be the BGR input conv; an
            # interior kernel arriving first in file order must never be
            # channel-scrambled by the heuristic.
            is_input_conv = w.ndim == 4 and w.shape[1] in (3, 6)
            if w.ndim == 4:
                conv = caffemodel.conv_params(
                    layer,
                    flip_bgr=flip_bgr_first_conv
                    and not first_conv_seen
                    and is_input_conv,
                )
            else:
                conv = caffemodel.conv_params(layer)
            if conv["kernel"].shape != tuple(target_shape):
                continue
            leaves[path] = conv["kernel"]
            report[".".join(path)] = name
            if is_input_conv:
                first_conv_seen = True
            bias_path = path[:-1] + ("bias",)
            if "bias" in conv and bias_path in leaves:
                if conv["bias"].shape == leaves[bias_path].shape:
                    leaves[bias_path] = conv["bias"]
            used.add(name)
            break
        else:
            if strict:
                raise ValueError(
                    f"no imported layer matches {'.'.join(path)} {target_shape}"
                )

    unmatched = [".".join(p) for p in kernel_paths if ".".join(p) not in report]
    if strict and unmatched:
        raise ValueError(f"unmatched params: {unmatched}")

    return _rebuild(params, leaves), report


def _rebuild(tree: Any, leaves: Dict[Tuple[str, ...], np.ndarray],
             prefix: Tuple[str, ...] = ()) -> Any:
    """``tree``'s nesting as plain dicts (keys sorted) with the leaf at
    each path taken from ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _rebuild(tree[k], leaves, prefix + (k,)) for k in sorted(tree)}
    return leaves[prefix]


def import_by_name(
    layers: Dict[str, Dict],
    params: Any,
    name_map: Dict[str, str],
    flip_bgr_first_conv: bool = True,
    bgr_layers: Optional[Iterable[str]] = None,
    strict: bool = True,
    fallback_shape_order: bool = True,
) -> Tuple[Any, Dict[str, Dict[str, str]]]:
    """Fill ``params`` from parsed Caffe layers via an explicit name map.

    ``name_map`` maps a Caffe layer name (as it appears in the released
    prototxt/caffemodel, e.g. ``conv1``, ``res2a_branch2a``, ``fc_pose``)
    to the dotted flax module path that owns the matching ``kernel``
    (e.g. ``ConvBlock_0.Conv_0``). Every entry is placed with a strict
    shape check; the bias blob (when present) rides along. Model kernels
    NOT covered by the map are then filled by shape-order matching
    against the layers the map did not consume (disable with
    ``fallback_shape_order=False``).

    BGR→RGB handling: Caffe's first conv consumes BGR input. By default
    the first *mapped* 4-d conv in caffemodel file order gets its input
    channels triplet-flipped (matching :func:`import_by_shape_order`
    semantics); pass ``bgr_layers`` (an iterable of Caffe layer names) to
    flip an explicit set instead — e.g. both tower-input convs of a
    siamese graph — or ``flip_bgr_first_conv=False`` for none.

    Returns ``(new_params, report)`` where ``report`` maps each filled
    dotted param path to ``{"layer": caffe_name, "via": "name"|"shape"}``.
    With ``strict`` (default) raises ``ValueError`` listing every
    problem at once: name_map entries whose layer is missing from the
    file, whose path does not exist in ``params``, or whose converted
    shape disagrees — so a mismatched release fails loudly, not by
    silently mis-seating a 1x1 kernel.
    """
    flat = _flatten_with_path(params)
    leaves = {path: leaf.copy() for path, leaf in flat}
    path_index = {".".join(p): p for p, _ in flat}
    report: Dict[str, Dict[str, str]] = {}
    problems: List[str] = []

    file_order = list(layers)
    if bgr_layers is not None:
        flip_set = set(bgr_layers)
    elif flip_bgr_first_conv:
        # The first 4-d conv in file order that CONSUMES RAW FRAMES
        # (3/6 input channels) is the input conv and gets the BGR flip.
        # The channel check matters in the very situation this function
        # exists for — untrusted file order: an interior conv serialized
        # first must not be channel-scrambled. If the input conv is in
        # the map, flip it here; if not, leave the set empty so the
        # shape-order fallback flips it when consumed.
        flip_set = set()
        for name in file_order:
            blobs = layers[name]["blobs"]
            if blobs and blobs[0].ndim == 4 and blobs[0].shape[1] in (3, 6):
                if name in name_map:
                    flip_set = {name}
                break
    else:
        flip_set = set()

    used = set()
    for caffe_name, module_path in name_map.items():
        layer = layers.get(caffe_name)
        if layer is None:
            problems.append(f"name_map layer {caffe_name!r} not in caffemodel")
            continue
        if not layer["blobs"]:
            problems.append(f"name_map layer {caffe_name!r} has no blobs")
            continue
        kernel_key = path_index.get(module_path + ".kernel")
        if kernel_key is None:
            problems.append(
                f"name_map target {module_path!r} has no .kernel in params"
            )
            continue
        conv = caffemodel.conv_params(layer, flip_bgr=caffe_name in flip_set)
        want = leaves[kernel_key].shape
        if conv["kernel"].shape != tuple(want):
            problems.append(
                f"{caffe_name!r} -> {module_path!r}: shape "
                f"{conv['kernel'].shape} != model {tuple(want)}"
            )
            continue
        leaves[kernel_key] = conv["kernel"]
        report[module_path + ".kernel"] = {"layer": caffe_name, "via": "name"}
        bias_key = kernel_key[:-1] + ("bias",)
        if bias_key in leaves:
            if "bias" not in conv:
                problems.append(
                    f"{caffe_name!r}: model expects a bias, file has none"
                )
            elif conv["bias"].shape != leaves[bias_key].shape:
                problems.append(
                    f"{caffe_name!r} bias shape {conv['bias'].shape} != "
                    f"model {leaves[bias_key].shape}"
                )
            else:
                leaves[bias_key] = conv["bias"]
        used.add(caffe_name)

    if strict and problems:
        raise ValueError(
            "import_by_name: %d problem(s):\n  %s"
            % (len(problems), "\n  ".join(problems))
        )

    if fallback_shape_order:
        # Shape-order pass over ONLY the kernels the map did not fill,
        # consuming ONLY the layers the map did not use (a full-tree
        # shape-order pass would let a leftover layer steal an already
        # name-seated slot of the same shape).
        remaining = [
            (n, layers[n])
            for n in file_order
            if n not in used
            and layers[n]["blobs"]
            and layers[n]["blobs"][0].ndim in (2, 4)
        ]
        # The heuristic flip only applies when the caller did NOT pass an
        # explicit bgr_layers set; with one, membership decides for the
        # fallback too (an explicitly-listed layer left out of name_map
        # must still flip, and bgr_layers=[] means flip NOTHING).
        first_conv_pending = (
            flip_bgr_first_conv and bgr_layers is None and not flip_set
        )
        for key in [p for p, _ in flat if p[-1] == "kernel"]:
            dotted = ".".join(key)
            if dotted in report:
                continue
            want = leaves[key].shape
            for n, layer in remaining:
                if n in used:
                    continue
                w = layer["blobs"][0]
                is_input_conv = w.ndim == 4 and w.shape[1] in (3, 6)
                if bgr_layers is not None:
                    flip = n in flip_set and w.ndim == 4
                else:
                    flip = first_conv_pending and is_input_conv
                conv = caffemodel.conv_params(layer, flip_bgr=flip)
                if conv["kernel"].shape != tuple(want):
                    continue
                leaves[key] = conv["kernel"]
                report[dotted] = {"layer": n, "via": "shape"}
                if is_input_conv:
                    first_conv_pending = False
                bias_key = key[:-1] + ("bias",)
                if (
                    "bias" in conv
                    and bias_key in leaves
                    and conv["bias"].shape == leaves[bias_key].shape
                ):
                    leaves[bias_key] = conv["bias"]
                used.add(n)
                break
    new_params = _rebuild(params, leaves)

    unmatched = [
        ".".join(p)
        for p, _ in flat
        if p[-1] == "kernel" and ".".join(p) not in report
    ]
    if strict and unmatched:
        raise ValueError(f"import_by_name: unmatched params: {unmatched}")
    return new_params, report


def import_bn_by_name(
    layers: Dict[str, Dict],
    params: Any,
    batch_stats: Any,
    name_map: Dict[str, str],
    strict: bool = True,
) -> Tuple[Any, Any, Dict[str, Dict[str, str]]]:
    """Fill flax BatchNorm params/batch_stats via an explicit name map.

    ``name_map`` maps a Caffe *BatchNorm* layer name (e.g. ``bn_conv1``)
    to the dotted flax module path of the BatchNorm (the dict holding
    ``scale``/``bias`` in params and ``mean``/``var`` in batch_stats).
    The paired Scale layer (BVLC convention: ``scale_conv1`` etc.) is
    found by look-ahead in file order — the first later layer with 1-2
    blobs of the same channel count. Returns
    ``(params, batch_stats, report)``; strict raises on missing layers,
    missing paths, absent Scale pair, or channel mismatch.
    """
    p_flat = _flatten_with_path(params)
    s_flat = _flatten_with_path(batch_stats)
    p_leaves = {path: leaf.copy() for path, leaf in p_flat}
    s_leaves = {path: leaf.copy() for path, leaf in s_flat}
    p_index = {".".join(p): p for p, _ in p_flat}
    s_index = {".".join(p): p for p, _ in s_flat}
    report: Dict[str, Dict[str, str]] = {}
    problems: List[str] = []
    names = list(layers)

    for caffe_name, module_path in name_map.items():
        layer = layers.get(caffe_name)
        if layer is None:
            problems.append(f"BN layer {caffe_name!r} not in caffemodel")
            continue
        if len(layer["blobs"]) != 3 or layer["blobs"][0].ndim != 1:
            problems.append(
                f"{caffe_name!r} does not look like BatchNorm "
                f"(want 3 1-d blobs, got "
                f"{[tuple(b.shape) for b in layer['blobs']]})"
            )
            continue
        scale_key = p_index.get(module_path + ".scale")
        if scale_key is None:
            problems.append(
                f"BN target {module_path!r} has no .scale in params"
            )
            continue
        c = layer["blobs"][0].shape[0]
        if p_leaves[scale_key].shape[0] != c:
            problems.append(
                f"{caffe_name!r} channels {c} != model "
                f"{p_leaves[scale_key].shape[0]} at {module_path!r}"
            )
            continue
        i = names.index(caffe_name)
        scale_layer = None
        for j in (i + 1, i + 2):
            if j < len(names):
                cand = layers[names[j]]
                if (
                    len(cand["blobs"]) in (1, 2)
                    and cand["blobs"][0].shape == layer["blobs"][0].shape
                ):
                    scale_layer = cand
                    break
        if scale_layer is None:
            problems.append(f"{caffe_name!r}: no Scale pair found after it")
            continue
        folded = caffemodel.fold_bn_scale(layer["blobs"], scale_layer["blobs"])
        p_leaves[scale_key] = folded["params"]["scale"]
        bias_key = scale_key[:-1] + ("bias",)
        if bias_key in p_leaves:
            p_leaves[bias_key] = folded["params"]["bias"]
        for stat in ("mean", "var"):
            k = s_index.get(module_path + "." + stat)
            if k is not None:
                s_leaves[k] = folded["batch_stats"][stat]
            else:
                # A params-only hit with no running stats means the
                # caller passed the wrong batch_stats tree — gamma/beta
                # would import while mean/var silently stayed at init.
                problems.append(
                    f"BN target {module_path!r} has no .{stat} in "
                    "batch_stats"
                )
        report[module_path] = {"layer": caffe_name, "via": "name"}

    if strict and problems:
        raise ValueError(
            "import_bn_by_name: %d problem(s):\n  %s"
            % (len(problems), "\n  ".join(problems))
        )
    return _rebuild(params, p_leaves), _rebuild(batch_stats, s_leaves), report


def format_report(report: Dict[str, Dict[str, str]]) -> str:
    """Human-readable assignment report (one line per placed param)."""
    lines = []
    for path, info in report.items():
        if isinstance(info, str):  # shape-order report form
            info = {"layer": info, "via": "shape"}
        lines.append(f"{path:60s} <- {info['layer']:30s} [{info['via']}]")
    return "\n".join(lines)


def import_bn_by_order(
    layers: Dict[str, Dict],
    params: Any,
    batch_stats: Any,
) -> Tuple[Any, Any, Dict[str, str]]:
    """Fill flax BatchNorm {scale,bias} params and {mean,var} batch_stats
    from Caffe BatchNorm+Scale layer pairs, matched by channel count in
    order. Returns (params, batch_stats, report)."""
    bn_layers = []
    names = list(layers)
    for i, name in enumerate(names):
        layer = layers[name]
        if len(layer["blobs"]) == 3 and layer["blobs"][0].ndim == 1:
            # BatchNorm: look ahead for its Scale pair (2 blobs, same C).
            scale = None
            for j in (i + 1, i + 2):
                if j < len(names):
                    cand = layers[names[j]]
                    if (
                        len(cand["blobs"]) in (1, 2)
                        and cand["blobs"][0].shape == layer["blobs"][0].shape
                    ):
                        scale = cand
                        break
            if scale is not None:
                bn_layers.append((name, layer, scale))

    p_flat = _flatten_with_path(params)
    s_flat = _flatten_with_path(batch_stats)
    p_leaves = {path: leaf.copy() for path, leaf in p_flat}
    s_leaves = {path: leaf.copy() for path, leaf in s_flat}
    report: Dict[str, str] = {}

    scale_paths = [p for p, _ in p_flat if p[-1] == "scale"]
    cursor = 0
    for path in scale_paths:
        c = p_leaves[path].shape[0]
        while cursor < len(bn_layers):
            name, bn, sc = bn_layers[cursor]
            cursor += 1
            if bn["blobs"][0].shape[0] != c:
                continue
            folded = caffemodel.fold_bn_scale(bn["blobs"], sc["blobs"])
            p_leaves[path] = folded["params"]["scale"]
            bias_path = path[:-1] + ("bias",)
            if bias_path in p_leaves:
                p_leaves[bias_path] = folded["params"]["bias"]
            # flax batch_stats mirror the params module path:
            # params[...module]['scale'] <-> batch_stats[...module]['mean'].
            mean_path = path[:-1] + ("mean",)
            var_path = path[:-1] + ("var",)
            if mean_path in s_leaves:
                s_leaves[mean_path] = folded["batch_stats"]["mean"]
            if var_path in s_leaves:
                s_leaves[var_path] = folded["batch_stats"]["var"]
            report[".".join(path[:-1])] = name
            break

    return _rebuild(params, p_leaves), _rebuild(batch_stats, s_leaves), report


def fold_input_transform(
    params: Any,
    batch_stats: Any = None,
    *,
    conv_path: str,
    mean,
    scale: float = 1.0,
    bn_path: Optional[str] = None,
    bgr_flipped: bool = True,
) -> Tuple[Any, Any]:
    """Fold Caffe's data-layer preprocessing into the imported input conv.

    The reference feeds its nets ``scale * (raw_bgr_255 - mean)`` (Caffe
    ``transform_param``: per-channel ``mean_value`` subtraction, then
    ``scale``; SURVEY.md §3.2 preprocessing). This framework feeds
    ``raw_rgb_255 / 127.5 - 1``. For an already-imported first conv
    (kernel HWIO, input axis indexing raw RGB after the import-time BGR
    flip) the two are related by a per-channel affine map, which folds
    exactly into the conv:

        kernel' = kernel * (scale * 127.5)
        delta[o] = sum_{h,w,i} kernel[h,w,i,o] * scale * (127.5 - mean_rgb[i])

    ``delta`` lands in the conv bias (``bias' = bias + delta``) when the
    model has one, else in the following BatchNorm's running mean
    (``bn_path``): the rescaled conv's output is ``y_caffe - delta``, and
    flax normalizes ``(y - mean)``, so ``mean' = mean - delta`` absorbs
    the offset exactly.

    Args:
      params / batch_stats: the model trees AFTER import (kernel already
        BGR-flipped when ``bgr_flipped``).
      conv_path: dotted flax path owning the input ``.kernel``.
      mean: per-channel means in the CAFFE file's channel order (BGR,
        e.g. ``[104.0, 116.7, 122.7]``); length 3 is tiled over stacked-
        frame inputs (the odometry net's 6-channel conv).
      scale: Caffe ``transform_param.scale`` (applied after the mean).
      bn_path: dotted path of the BatchNorm consuming the conv output —
        required when the conv has no bias.
      bgr_flipped: reorder ``mean`` with the same triplet flip the import
        applied to the kernel's input axis.

    Exactness caveat: with SAME zero padding the padded taps represent
    raw=0 in *both* pipelines but different pre-activation values (Caffe's
    pad is zero AFTER mean-subtraction). Interior outputs — everything a
    7x7/pad-3 first conv computes more than 3 px from the border, i.e. the
    whole Garg-cropped eval region — are exact; a border ring of
    ``pad`` px differs. Returns ``(params, batch_stats)``.
    """
    flat = _flatten_with_path(params)
    leaves = {path: leaf.copy() for path, leaf in flat}
    index = {".".join(p): p for p, _ in flat}
    kernel_key = index.get(conv_path + ".kernel")
    if kernel_key is None:
        raise ValueError(f"fold_input_transform: no kernel at {conv_path!r}")
    kernel = leaves[kernel_key]
    if kernel.ndim != 4:
        raise ValueError(
            f"fold_input_transform: {conv_path!r} is not a conv kernel"
        )
    c_in = kernel.shape[2]
    mean = np.asarray(mean, np.float32).reshape(-1)
    if mean.size == 3 and c_in % 3 == 0:
        mean = np.tile(mean, c_in // 3)
    if mean.size != c_in:
        raise ValueError(
            f"fold_input_transform: mean has {mean.size} channels, "
            f"conv input has {c_in}"
        )
    if bgr_flipped:
        mean = mean[caffemodel._bgr_group_index(c_in)]

    # delta[o] from the ORIGINAL kernel, then rescale the kernel.
    const_in = np.float32(scale) * (np.float32(127.5) - mean)  # (C_in,)
    delta = np.einsum(
        "hwio,i->o", kernel.astype(np.float64), const_in.astype(np.float64)
    ).astype(np.float32)
    leaves[kernel_key] = (kernel * np.float32(scale * 127.5)).astype(
        kernel.dtype
    )

    bias_key = kernel_key[:-1] + ("bias",)
    new_stats = batch_stats
    if bias_key in leaves:
        leaves[bias_key] = (leaves[bias_key] + delta).astype(
            leaves[bias_key].dtype
        )
    else:
        if bn_path is None or batch_stats is None:
            raise ValueError(
                f"fold_input_transform: {conv_path!r} has no bias; pass "
                "bn_path + batch_stats to absorb the offset"
            )
        s_flat = _flatten_with_path(batch_stats)
        s_leaves = {path: leaf.copy() for path, leaf in s_flat}
        s_index = {".".join(p): p for p, _ in s_flat}
        mean_key = s_index.get(bn_path + ".mean")
        if mean_key is None:
            raise ValueError(
                f"fold_input_transform: no batch_stats mean at {bn_path!r}"
            )
        if s_leaves[mean_key].shape[0] != delta.shape[0]:
            raise ValueError(
                f"fold_input_transform: BN {bn_path!r} channels "
                f"{s_leaves[mean_key].shape[0]} != conv out {delta.shape[0]}"
            )
        s_leaves[mean_key] = (s_leaves[mean_key] - delta).astype(
            s_leaves[mean_key].dtype
        )
        new_stats = _rebuild(batch_stats, s_leaves)
    return _rebuild(params, leaves), new_stats


def _first_input_conv(params: Any) -> str:
    """Dotted path of the network's input conv: the first 4-d kernel in
    traversal order. Sanity-checked to consume raw frames (3 or 6
    channels) so a mis-ordered tree fails loudly."""
    for path, leaf in _flatten_with_path(params):
        if path[-1] == "kernel" and leaf.ndim == 4:
            dotted = ".".join(path[:-1])
            if leaf.shape[2] not in (3, 6):
                raise ValueError(
                    f"first conv {dotted!r} has {leaf.shape[2]} input "
                    "channels (expected raw frames); pass input_conv "
                    "explicitly"
                )
            return dotted
    raise ValueError("no conv kernel in params")


def _sibling_bn(batch_stats: Any, conv_path: str) -> Optional[str]:
    """BatchNorm module sharing the input conv's parent block, if any."""
    parent = conv_path.rsplit(".", 1)[0] if "." in conv_path else ""
    for path, _ in _flatten_with_path(batch_stats):
        if path[-1] != "mean":
            continue
        dotted = ".".join(path[:-1])
        mod_parent = dotted.rsplit(".", 1)[0] if "." in dotted else ""
        if mod_parent == parent:
            return dotted
    return None


def import_net(
    layers: Dict[str, Dict],
    params: Any,
    batch_stats: Any = None,
    *,
    name_map: Optional[Dict[str, str]] = None,
    bn_name_map: Optional[Dict[str, str]] = None,
    input_mean=None,
    input_scale: float = 1.0,
    input_conv: Optional[str] = None,
    input_bn: Optional[str] = None,
    strict: bool = True,
) -> Tuple[Any, Any, Dict[str, Dict[str, str]]]:
    """One-call released-weights import: kernels + BN + input transform.

    Chains the fidelity-gate pieces (SURVEY.md §7 step 2) in the order a
    real ``.caffemodel`` needs them:

    1. conv/dense kernels — :func:`import_by_name` when ``name_map`` is
       given (the strategy for real releases), else
       :func:`import_by_shape_order`;
    2. BatchNorm+Scale pairs — :func:`import_bn_by_name` /
       :func:`import_bn_by_order` (skipped when ``batch_stats`` is None,
       e.g. the BN-free odometry net);
    3. the data layer's preprocessing — :func:`fold_input_transform`
       when ``input_mean`` is given (per-channel Caffe ``mean_value``,
       BGR order). ``input_conv``/``input_bn`` default to the first 4-d
       kernel in traversal order and its sibling BatchNorm.

    Returns ``(params, batch_stats, report)`` with every placement in
    ``report`` (dotted path -> {layer, via}).
    """
    report: Dict[str, Dict[str, str]] = {}
    if name_map:
        params, rep = import_by_name(layers, params, name_map, strict=strict)
        report.update(rep)
    else:
        params, rep = import_by_shape_order(layers, params, strict=strict)
        report.update(
            {k: {"layer": v, "via": "shape"} for k, v in rep.items()}
        )
    if batch_stats is not None:
        if bn_name_map:
            params, batch_stats, rep = import_bn_by_name(
                layers, params, batch_stats, bn_name_map, strict=strict
            )
        else:
            if name_map:
                import warnings

                warnings.warn(
                    "import_net: conv kernels were placed by NAME but "
                    "BatchNorm layers fall back to FILE-ORDER matching — "
                    "identically-shaped BN layers in a permuted release "
                    "mis-seat silently. Pass bn_name_map ('bns' in the "
                    "map JSON) for a trustworthy import.",
                    stacklevel=2,
                )
            params, batch_stats, rep = import_bn_by_order(
                layers, params, batch_stats
            )
            rep = {k: {"layer": v, "via": "shape"} for k, v in rep.items()}
        report.update(rep)
    if input_mean is not None:
        conv_path = input_conv or _first_input_conv(params)
        bn_path = input_bn
        flat_paths = {".".join(p) for p, _ in _flatten_with_path(params)}
        if bn_path is None and conv_path + ".bias" not in flat_paths:
            if batch_stats is None:
                raise ValueError(
                    f"{conv_path!r} has no bias and no batch_stats were "
                    "given; cannot fold input_mean"
                )
            bn_path = _sibling_bn(batch_stats, conv_path)
            if bn_path is None:
                raise ValueError(
                    f"no BatchNorm found next to {conv_path!r}; pass "
                    "input_bn explicitly"
                )
        params, batch_stats = fold_input_transform(
            params,
            batch_stats,
            conv_path=conv_path,
            mean=input_mean,
            scale=input_scale,
            bn_path=bn_path,
        )
        report[conv_path + ".input_transform"] = {
            "layer": f"mean={list(np.asarray(input_mean).ravel())} "
                     f"scale={input_scale}",
            "via": "fold",
        }
    return params, batch_stats, report
