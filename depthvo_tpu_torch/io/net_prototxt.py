"""Caffe ``NetParameter`` prototxt reader: recognize reference net files.

The reference defines each network AND its loss graph as a ``.prototxt``
text file (SURVEY.md §2a "Network definitions" / "Training graphs"); its
solver files point at them via ``net:``. The rebuild deliberately does
NOT execute graphs from text — SURVEY.md §7's design stance forbids a
Caffe-alike layer registry, and the three networks exist as native flax
models (``models/``). What a migrating user still needs from their
prototxt files is the *facts* encoded in them:

- which of the three Depth-VO-Feat networks (or which training variant)
  the file describes,
- input geometry (batch, channels, height, width),
- the data layer's preprocessing (``mean_value``/``scale`` — exactly the
  numbers :func:`~depthvo_tpu_torch.io.import_weights.fold_input_transform`
  folds into the first conv when importing released weights),
- per-loss ``loss_weight`` values.

This module parses the protobuf TextFormat (nested messages included,
unlike the flat ``solver.prototxt`` reader), extracts those facts, and
maps them onto the native config surface. Consumers:

- ``depthvo net-info file.prototxt`` — classification report;
- ``depthvo train --solver solver.prototxt`` — honors ``net:`` by
  selecting the variant / batch / input size / loss weights;
- ``depthvo import-caffemodel --proto deploy.prototxt`` — target-net
  sanity check plus automatic mean/scale folding.

Classification is heuristic by necessity (layer-type strings in the
reference are [L]-confidence per SURVEY.md §2b) and keys on structural,
name-free signals first — input channel count, presence of
deconvolution layers, a 6-output InnerProduct head — falling back to
name substrings only for loss bucketing, and reports every inference it
makes in ``NetFacts.notes`` so nothing is silently guessed.

The port's own copy of ``depthvo_tpu/io/net_prototxt.py``: numpy and the standard
library only, the same functions and the same results.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "parse_prototxt",
    "extract_facts",
    "config_overrides",
    "NetFacts",
    "LossFact",
]


# ---------------------------------------------------------------------------
# TextFormat parser
# ---------------------------------------------------------------------------

_TOKEN = re.compile(
    r"""
      "(?:[^"\\]|\\.)*"        # double-quoted string
    | '(?:[^'\\]|\\.)*'        # single-quoted string
    | [{}<>:]                  # punctuation
    | [^\s{}<>:\#]+            # bare token (number, enum, identifier)
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> List[str]:
    toks: List[str] = []
    for raw in text.splitlines():
        # Strip comments, but not '#' inside a quoted string.
        line = []
        in_q: Optional[str] = None
        prev = ""
        for ch in raw:
            if in_q:
                line.append(ch)
                if ch == in_q and prev != "\\":
                    in_q = None
            elif ch in "\"'":
                in_q = ch
                line.append(ch)
            elif ch == "#":
                break
            else:
                line.append(ch)
            prev = ch
        toks.extend(_TOKEN.findall("".join(line)))
    return toks


def _coerce(tok: str) -> Any:
    if tok and tok[0] in "\"'":
        body = tok[1:-1]
        return re.sub(r"\\(.)", r"\1", body)
    low = tok.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok  # bare enum token (TRAIN, CONVOLUTION, ...)


def _store(msg: Dict[str, Any], key: str, value: Any) -> None:
    if key in msg:
        prev = msg[key]
        if isinstance(prev, list):
            prev.append(value)
        else:
            msg[key] = [prev, value]
    else:
        msg[key] = value


def parse_prototxt(text: str) -> Dict[str, Any]:
    """Parse protobuf TextFormat into nested dicts.

    Handles ``key: value``, ``key { ... }``, ``key: { ... }``, the
    ``< >`` message delimiters, repeated keys (accumulated into lists),
    quoted strings, bare enum tokens, and ``#`` comments. Raises
    ValueError on malformed input (unbalanced braces, missing values) —
    a net file that cannot be parsed must fail loudly, not half-apply.
    """
    toks = _tokenize(text)
    pos = 0

    def parse_message(closer: Optional[str]) -> Dict[str, Any]:
        nonlocal pos
        msg: Dict[str, Any] = {}
        while pos < len(toks):
            tok = toks[pos]
            if closer is not None and tok == closer:
                pos += 1
                return msg
            if tok in "{}<>:":
                raise ValueError(f"prototxt: unexpected {tok!r} at token {pos}")
            key = tok
            pos += 1
            if pos >= len(toks):
                raise ValueError(f"prototxt: dangling key {key!r}")
            nxt = toks[pos]
            if nxt == ":":
                pos += 1
                if pos >= len(toks):
                    raise ValueError(f"prototxt: {key!r}: missing value")
                val_tok = toks[pos]
                if val_tok in "{<":  # legacy `key: { ... }`
                    pos += 1
                    _store(msg, key, parse_message("}" if val_tok == "{" else ">"))
                else:
                    pos += 1
                    _store(msg, key, _coerce(val_tok))
            elif nxt in "{<":
                pos += 1
                _store(msg, key, parse_message("}" if nxt == "{" else ">"))
            else:
                raise ValueError(
                    f"prototxt: expected ':' or '{{' after {key!r}, got {nxt!r}"
                )
        if closer is not None:
            raise ValueError("prototxt: unbalanced message (missing closer)")
        return msg

    return parse_message(None)


def _as_list(msg: Dict[str, Any], key: str) -> List[Any]:
    if key not in msg:
        return []
    v = msg[key]
    return v if isinstance(v, list) else [v]


# ---------------------------------------------------------------------------
# Fact extraction
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LossFact:
    name: str
    type: str
    weight: float
    bottoms: Tuple[str, ...]


@dataclasses.dataclass
class NetFacts:
    """Everything the rebuild can use from a NetParameter file."""

    name: str = ""
    n_layers: int = 0
    census: Dict[str, int] = dataclasses.field(default_factory=dict)
    # primary input blob, NCHW; None where the file does not say
    batch_size: Optional[int] = None
    channels: Optional[int] = None
    height: Optional[int] = None
    width: Optional[int] = None
    mean_values: Optional[Tuple[float, ...]] = None  # BGR, Caffe order
    scale: Optional[float] = None
    losses: List[LossFact] = dataclasses.field(default_factory=list)
    # (layer_name, num_output) for every weight-carrying layer, in graph
    # order — the cross-check source for io/name_map.py
    learnable_layers: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list
    )
    geometry_types: List[str] = dataclasses.field(default_factory=list)
    has_pose_head: bool = False  # InnerProduct with num_output == 6
    has_decoder: bool = False  # Deconvolution / Upsample layers
    has_feature_branch: bool = False
    kind: str = "unknown"  # depth | odometry | feature | train_graph
    variant: Optional[str] = None  # stereo | temporal_stereo | full_feat
    notes: List[str] = dataclasses.field(default_factory=list)


_GEOMETRY_PAT = re.compile(
    r"se3|rodrigues|exp.?map|transform3d|3dtransform|geotransform"
    r"|pinhole|proj(ect)?|warp|sampl|grid",
    re.IGNORECASE,
)
_DECODER_PAT = re.compile(r"deconv|upsample|resize|interp", re.IGNORECASE)
_FEATURE_PAT = re.compile(r"feat", re.IGNORECASE)


def _layer_type(layer: Dict[str, Any]) -> str:
    t = layer.get("type", "")
    return str(t)


def _first_param(layer: Dict[str, Any], *names: str) -> Optional[Dict[str, Any]]:
    for n in names:
        v = layer.get(n)
        if isinstance(v, list):
            v = v[0]
        if isinstance(v, dict):
            return v
    return None


def extract_facts(msg: Dict[str, Any]) -> NetFacts:
    """Digest a parsed NetParameter message into :class:`NetFacts`."""
    f = NetFacts(name=str(msg.get("name", "")))
    layers = [l for l in _as_list(msg, "layer") + _as_list(msg, "layers")
              if isinstance(l, dict)]
    f.n_layers = len(layers)

    # --- primary input shape -------------------------------------------
    shape: List[int] = []
    if "input" in msg:
        if "input_shape" in msg:
            first = _as_list(msg, "input_shape")[0]
            if isinstance(first, dict):
                shape = [int(d) for d in _as_list(first, "dim")]
        elif "input_dim" in msg:
            dims = [int(d) for d in _as_list(msg, "input_dim")]
            shape = dims[:4]  # first input's NCHW (legacy repeated field)
    for layer in layers:
        t = _layer_type(layer).lower()
        if t == "input" and not shape:
            ip = _first_param(layer, "input_param")
            if ip and "shape" in ip:
                first = _as_list(ip, "shape")[0]
                if isinstance(first, dict):
                    shape = [int(d) for d in _as_list(first, "dim")]
        if t in ("data", "imagedata", "hdf5data", "memorydata", "python",
                 "image_data", "dummydata"):
            dp = _first_param(
                layer, "data_param", "image_data_param", "hdf5_data_param",
                "memory_data_param", "dummy_data_param",
            )
            if dp and "batch_size" in dp and f.batch_size is None:
                f.batch_size = int(dp["batch_size"])
            if dp and not shape:
                h = dp.get("new_height")
                w = dp.get("new_width")
                if h and w:
                    f.height, f.width = int(h), int(w)
            tp = _first_param(layer, "transform_param")
            if tp:
                if "mean_value" in tp and f.mean_values is None:
                    f.mean_values = tuple(
                        float(v) for v in _as_list(tp, "mean_value")
                    )
                if "scale" in tp and f.scale is None:
                    f.scale = float(tp["scale"])
                if "crop_size" in tp and f.height is None:
                    c = int(tp["crop_size"])
                    f.height = f.width = c
    if shape:
        if len(shape) == 4:
            f.batch_size = f.batch_size or int(shape[0])
            f.channels = int(shape[1])
            f.height, f.width = int(shape[2]), int(shape[3])
        else:
            f.notes.append(f"input shape {shape} is not NCHW; ignored")

    # --- census + structural signals ------------------------------------
    for layer in layers:
        t = _layer_type(layer)
        f.census[t] = f.census.get(t, 0) + 1
        name = str(layer.get("name", ""))
        if _GEOMETRY_PAT.search(t) or _GEOMETRY_PAT.search(name):
            # custom layers often hide behind type "Python"; the name is
            # the informative part then
            f.geometry_types.append(
                name if _GEOMETRY_PAT.search(name) else t
            )
        if _DECODER_PAT.search(t):
            f.has_decoder = True
        if t.lower() in ("innerproduct", "inner_product"):
            ipp = _first_param(layer, "inner_product_param")
            if ipp and int(ipp.get("num_output", 0)) == 6:
                f.has_pose_head = True
        lowt = t.lower()
        if lowt in ("convolution", "deconvolution", "innerproduct",
                    "inner_product"):
            p = _first_param(
                layer, "convolution_param", "inner_product_param"
            )
            f.learnable_layers.append(
                (name, int(p.get("num_output", 0)) if p else 0)
            )
        lw = layer.get("loss_weight")
        is_loss = "loss" in t.lower() or lw is not None
        if is_loss:
            weights = [float(w) for w in _as_list(layer, "loss_weight")] or [1.0]
            bottoms = tuple(str(b) for b in _as_list(layer, "bottom"))
            f.losses.append(LossFact(name, t, weights[0], bottoms))
        if _FEATURE_PAT.search(name) or any(
            _FEATURE_PAT.search(str(b)) for b in _as_list(layer, "bottom")
        ):
            f.has_feature_branch = True

    _classify(f)
    return f


def _classify(f: NetFacts) -> None:
    """Fill ``kind``/``variant``; record each inference in ``notes``."""
    active = [l for l in f.losses if l.weight != 0.0]
    if active:
        f.kind = "train_graph"
        if f.has_feature_branch and any(
            _FEATURE_PAT.search(l.name)
            or any(_FEATURE_PAT.search(b) for b in l.bottoms)
            for l in active
        ):
            f.variant = "full_feat"
            f.notes.append(
                "variant=full_feat: loss layers reference feature blobs"
            )
        elif f.has_pose_head:
            f.variant = "temporal_stereo"
            f.notes.append(
                "variant=temporal_stereo: 6-output InnerProduct pose head "
                "present, no feature-loss branch"
            )
        else:
            f.variant = "stereo"
            f.notes.append(
                "variant=stereo: losses but no pose head / feature branch"
            )
        return
    if f.channels == 6 or f.has_pose_head:
        f.kind = "odometry"
        f.notes.append(
            "kind=odometry: "
            + ("6-channel two-frame input" if f.channels == 6
               else "6-output InnerProduct head")
        )
    elif f.has_decoder:
        f.kind = "depth"
        f.notes.append("kind=depth: deconvolution/upsample decoder present")
    elif f.channels == 3 and f.census:
        f.kind = "feature"
        f.notes.append(
            "kind=feature: 3-channel input, conv-only graph (no decoder, "
            "no pose head, no losses)"
        )
    else:
        f.notes.append("kind=unknown: no losses, no recognizable deploy shape")


# ---------------------------------------------------------------------------
# Config mapping
# ---------------------------------------------------------------------------

# loss-name substring -> ExperimentConfig weight field. Buckets are only
# applied when every matching loss layer agrees on the weight (multi-scale
# graphs repeat a loss per scale; agreement means the number is meaningful).
_LOSS_BUCKETS = (
    ("smooth", "smooth_weight"),
    ("feat", "feature_weight"),
    ("temporal", "temporal_weight"),
    ("stereo", "stereo_weight"),
)


def config_overrides(facts: NetFacts) -> Tuple[Dict[str, Any], List[str]]:
    """Map :class:`NetFacts` onto ExperimentConfig-shaped overrides.

    Returns ``(overrides, notes)``. ``overrides`` may contain ``variant``
    (consumed by the CLI to pick the config factory), ``batch_size``,
    ``height``/``width``, the four loss weights, and
    ``input_mean``/``input_scale`` (importer-facing, not config fields).
    Only facts the file actually states are emitted — absent facts never
    clobber native defaults.
    """
    over: Dict[str, Any] = {}
    notes: List[str] = []
    if facts.variant:
        over["variant"] = facts.variant
    if facts.batch_size:
        over["batch_size"] = facts.batch_size
    if facts.height and facts.width:
        over["height"], over["width"] = facts.height, facts.width
    if facts.mean_values:
        over["input_mean"] = list(facts.mean_values)
    if facts.scale is not None:
        over["input_scale"] = facts.scale

    for substr, field in _LOSS_BUCKETS:
        matched = [
            l for l in facts.losses
            if substr in l.name.lower()
            or any(substr in b.lower() for b in l.bottoms)
        ]
        if not matched:
            continue
        weights = sorted({l.weight for l in matched})
        if len(weights) == 1:
            over[field] = weights[0]
        else:
            notes.append(
                f"{field}: {len(matched)} '{substr}' losses disagree "
                f"({weights}); keeping the native default"
            )
    return over, notes


def format_report(facts: NetFacts, overrides: Dict[str, Any]) -> str:
    """Human-readable classification report for `depthvo net-info`."""
    lines = [
        f"net: {facts.name or '(unnamed)'}  "
        f"[{facts.n_layers} layers, kind={facts.kind}"
        + (f", variant={facts.variant}" if facts.variant else "")
        + "]",
    ]
    dims = "x".join(
        str(v) for v in (facts.batch_size, facts.channels,
                         facts.height, facts.width) if v
    )
    if dims:
        lines.append(f"  input: {dims} (NCHW as stated)")
    if facts.mean_values or facts.scale is not None:
        lines.append(
            f"  preprocessing: mean={list(facts.mean_values or ())} "
            f"scale={facts.scale if facts.scale is not None else 1.0} "
            "(BGR; fold via import-caffemodel)"
        )
    if facts.losses:
        lines.append("  losses:")
        for l in facts.losses:
            lines.append(f"    {l.name} ({l.type}) weight={l.weight}")
    if facts.geometry_types:
        uniq = sorted(set(facts.geometry_types))
        lines.append(f"  geometry layers: {', '.join(uniq)}")
    census = ", ".join(
        f"{t}x{n}" for t, n in sorted(facts.census.items(), key=lambda kv: -kv[1])
    )
    lines.append(f"  census: {census}")
    if overrides:
        lines.append(f"  -> native overrides: {overrides}")
    for n in facts.notes:
        lines.append(f"  note: {n}")
    return "\n".join(lines)
