"""``.caffemodel`` importer AND exporter (no Caffe, no protoc).

Reference parity (SURVEY.md §2b(ii) ``caffe.proto`` row: "must be
vendored/compiled in the rebuild to parse released .caffemodel files for
the fidelity gate"). Instead of vendoring the schema through protoc, this
module implements the protobuf *wire format* directly — ~100 lines —
and extracts exactly what the fidelity gate needs: layer names, types,
and weight blobs.

Wire-format facts used (protobuf encoding spec, stable since proto2):
  tag = (field_number << 3) | wire_type
  wire types: 0 varint, 1 fixed64, 2 length-delimited, 5 fixed32.

Caffe schema field numbers (BVLC caffe.proto, public and frozen):
  NetParameter:   name=1 (string), layers=2 (V1LayerParameter, legacy),
                  layer=100 (LayerParameter).
  LayerParameter: name=1 (string), type=2 (string), blobs=7 (BlobProto).
  V1LayerParameter: name=4 (string), type=5 (enum), blobs=6 (BlobProto).
  BlobProto:      num=1, channels=2, height=3, width=4 (legacy dims),
                  data=5 (repeated float, usually packed),
                  shape=7 (BlobShape), double_data=8 (double_diff=9).
  BlobShape:      dim=1 (repeated int64, packed).

Conversion notes (SURVEY.md §7 hard parts):
  * Caffe conv weights are OIHW and consume BGR inputs; flax NHWC convs
    want HWIO — ``oihw_to_hwio`` transposes, ``bgr_flip`` reorders the
    input-channel axis of the first conv so the network accepts RGB.
  * Caffe BatchNorm stores {mean, var, scale_factor}; the paired Scale
    layer holds {gamma, beta}. ``fold_bn_scale`` emits flax BatchNorm
    params (scale, bias) + batch_stats (mean, var).

The port's own copy of ``depthvo_tpu/io/caffemodel.py``: numpy and the standard
library only, the same functions and the same results.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

# ----------------------------------------------------------------- wire ----


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def iter_fields(buf: memoryview) -> Iterator[Tuple[int, int, memoryview | int]]:
    """Yield (field_number, wire_type, value) over one message's fields.

    Length-delimited values come back as memoryviews; varints as ints;
    fixed32/64 as ints (caller reinterprets).
    """
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = int.from_bytes(buf[pos : pos + 8], "little")
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            if pos + ln > n:
                # A truncated file (partial download) must fail loudly:
                # a silent short slice would "parse" with missing
                # trailing weights, defeating the fidelity gate.
                raise ValueError(
                    f"truncated protobuf: field {field} declares {ln} "
                    f"bytes but only {n - pos} remain"
                )
            val = buf[pos : pos + ln]
            pos += ln
        elif wt == 5:
            val = int.from_bytes(buf[pos : pos + 4], "little")
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} for field {field}")
        yield field, wt, val


def _packed_floats(val: memoryview | int, wt: int) -> np.ndarray:
    """Repeated float field: packed (wt=2) or a single fixed32 (wt=5)."""
    if wt == 2:
        return np.frombuffer(val, dtype="<f4").copy()
    return np.asarray([struct.unpack("<f", struct.pack("<I", val))[0]], np.float32)


def _packed_varints(val: memoryview | int, wt: int) -> List[int]:
    if wt == 0:
        return [int(val)]
    out = []
    pos = 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(v)
    return out


# ----------------------------------------------------------- caffemodel ----


def _parse_blob(buf: memoryview) -> np.ndarray:
    shape: List[int] = []
    legacy = {}
    data = None
    for field, wt, val in iter_fields(buf):
        if field == 5:  # data (repeated float)
            chunk = _packed_floats(val, wt)
            data = chunk if data is None else np.concatenate([data, chunk])
        elif field == 7 and wt == 2:  # shape: BlobShape{dim=1}
            for f2, wt2, v2 in iter_fields(val):
                if f2 == 1:
                    shape.extend(_packed_varints(v2, wt2))
        elif field in (1, 2, 3, 4) and wt == 0:  # legacy num/chan/h/w
            legacy[field] = int(val)
        elif field == 8:  # double_data (field 9 is double_DIFF: gradients,
            # which must never be concatenated into the weights)
            chunk = np.frombuffer(val, dtype="<f8").astype(np.float32)
            data = chunk if data is None else np.concatenate([data, chunk])
    if data is None:
        data = np.zeros(0, np.float32)
    if not shape and legacy:
        shape = [legacy.get(i, 1) for i in (1, 2, 3, 4)]
    if shape and int(np.prod(shape)) == data.size:
        return data.reshape(shape)
    return data


def _parse_layer(buf: memoryview, legacy: bool) -> Dict:
    name_field = 4 if legacy else 1
    type_field = 5 if legacy else 2
    blobs_field = 6 if legacy else 7
    out = {"name": "", "type": "", "blobs": []}
    for field, wt, val in iter_fields(buf):
        if field == name_field and wt == 2:
            out["name"] = bytes(val).decode("utf-8", "replace")
        elif field == type_field:
            out["type"] = (
                bytes(val).decode("utf-8", "replace") if wt == 2 else int(val)
            )
        elif field == blobs_field and wt == 2:
            out["blobs"].append(_parse_blob(val))
    return out


def parse_caffemodel(path_or_bytes) -> Dict[str, Dict]:
    """Parse a .caffemodel (NetParameter) into {layer_name: {type, blobs}}.

    Accepts a filesystem path or raw bytes. Handles both the modern
    ``layer`` (field 100) and legacy ``layers`` (field 2) encodings.
    """
    if isinstance(path_or_bytes, (str, bytes)):
        if isinstance(path_or_bytes, str):
            with open(path_or_bytes, "rb") as f:
                raw = f.read()
        else:
            raw = path_or_bytes
    else:
        raise TypeError("expected path or bytes")
    layers: Dict[str, Dict] = {}
    for field, wt, val in iter_fields(memoryview(raw)):
        if field == 100 and wt == 2:
            layer = _parse_layer(val, legacy=False)
            layers[layer["name"]] = layer
        elif field == 2 and wt == 2:
            layer = _parse_layer(val, legacy=True)
            layers[layer["name"]] = layer
    return layers


# ---------------------------------------------------------- conversion ----


def oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    """Caffe conv kernel (O, I, kH, kW) -> flax (kH, kW, I, O)."""
    assert w.ndim == 4, w.shape
    return np.transpose(w, (2, 3, 1, 0))


def _bgr_group_index(c: int) -> np.ndarray:
    """Channel permutation flipping each RGB triplet in place. For
    multi-frame inputs (c = 3k, e.g. the 6-channel odometry pair) every
    frame's triplet flips but FRAME ORDER is preserved — a full-axis
    reverse would swap the frames. Non-multiple-of-3 falls back to a
    full reverse."""
    if c % 3:
        return np.arange(c)[::-1]
    return np.concatenate(
        [np.arange(g * 3, g * 3 + 3)[::-1] for g in range(c // 3)]
    )


def bgr_flip_input_channels(w_hwio: np.ndarray) -> np.ndarray:
    """Flip the input-channel axis of a first-layer conv between BGR
    (Caffe convention) and RGB, triplet-wise (see _bgr_group_index)."""
    return w_hwio[:, :, _bgr_group_index(w_hwio.shape[2]), :].copy()


def fold_bn_scale(
    bn_blobs: List[np.ndarray], scale_blobs: List[np.ndarray], eps: float = 1e-5
) -> Dict[str, Dict[str, np.ndarray]]:
    """Fold a Caffe BatchNorm+Scale layer pair into flax BatchNorm params.

    Caffe BatchNorm blobs: [mean*f, var*f, scale_factor f] (stats are
    stored pre-multiplied by a running count f; divide it out). Scale
    blobs: [gamma, beta].
    """
    mean_raw, var_raw, factor = bn_blobs[0], bn_blobs[1], bn_blobs[2]
    f = float(factor.reshape(-1)[0]) if factor.size else 1.0
    f = f if f != 0 else 1.0
    mean = mean_raw / f
    var = var_raw / f
    gamma = scale_blobs[0]
    beta = scale_blobs[1] if len(scale_blobs) > 1 else np.zeros_like(gamma)
    return {
        "params": {"scale": gamma.astype(np.float32), "bias": beta.astype(np.float32)},
        "batch_stats": {"mean": mean.astype(np.float32), "var": var.astype(np.float32)},
    }


def conv_params(layer: Dict, flip_bgr: bool = False) -> Dict[str, np.ndarray]:
    """Caffe Convolution/InnerProduct layer -> flax Conv/Dense params."""
    blobs = layer["blobs"]
    w = blobs[0]
    out: Dict[str, np.ndarray] = {}
    if w.ndim == 4 and w.shape[0] == 1 and w.shape[1] == 1 and w.shape[2] > 1:
        # Legacy V1 InnerProduct blobs carry num/channels/height/width
        # dims (1, 1, out, in) — a dense matrix wearing 4-D legacy
        # clothes, NOT a 1-channel conv (a real 1x1 conv is OIHW with
        # the ones TRAILING: (O, I, 1, 1)).
        w = w.reshape(w.shape[2], w.shape[3])
    if w.ndim == 4:
        kernel = oihw_to_hwio(w)
        if flip_bgr:
            kernel = bgr_flip_input_channels(kernel)
        out["kernel"] = kernel.astype(np.float32)
    else:  # InnerProduct: (out, in) -> (in, out)
        out["kernel"] = np.transpose(w.reshape(w.shape[0], -1)).astype(np.float32)
    if len(blobs) > 1:
        out["bias"] = blobs[1].reshape(-1).astype(np.float32)
    return out


# ----------------------------------------------------------------- write ----
# Encoder for the same schema subset the parser reads (modern
# ``layer`` field 100 encoding): enough to round-trip weights through
# the Caffe model-zoo format so reference-ecosystem tooling can consume
# models trained here (PARITY.md "Docs / model zoo").


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_field(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def encode_blob(arr: np.ndarray) -> bytes:
    """numpy array -> BlobProto bytes (shape field 7 + packed data field 5)."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    dims = b"".join(_varint(int(d)) for d in arr.shape)
    shape_msg = _len_field(1, dims) if arr.ndim else b""
    out = _len_field(7, shape_msg)
    out += _len_field(5, arr.tobytes())
    return out


def encode_layer(name: str, type_str: str, blobs: List[np.ndarray]) -> bytes:
    """(name, type, blobs) -> LayerParameter bytes (modern encoding)."""
    out = _len_field(1, name.encode("utf-8"))
    out += _len_field(2, type_str.encode("utf-8"))
    for b in blobs:
        out += _len_field(7, encode_blob(b))
    return out


def write_caffemodel(
    layers: List[Tuple[str, str, List[np.ndarray]]],
    path: str | None = None,
    net_name: str = "depthvo_tpu",
) -> bytes:
    """Serialize [(layer_name, type, blobs), ...] as a NetParameter.

    The output parses back with :func:`parse_caffemodel` (and with real
    Caffe/protoc tooling — only public frozen field numbers are used).
    """
    out = _len_field(1, net_name.encode("utf-8"))
    for name, type_str, blobs in layers:
        out += _len_field(100, encode_layer(name, type_str, blobs))
    if path is not None:
        with open(path, "wb") as f:
            f.write(out)
    return out


def hwio_to_oihw(w: np.ndarray) -> np.ndarray:
    """flax conv kernel (kH, kW, I, O) -> Caffe (O, I, kH, kW)."""
    assert w.ndim == 4, w.shape
    return np.transpose(w, (3, 2, 0, 1))


def summarize(layers: Dict[str, Dict]) -> str:
    """Human-readable inventory of an imported model (debug aid)."""
    lines = []
    for name, layer in layers.items():
        shapes = ", ".join(str(tuple(b.shape)) for b in layer["blobs"])
        lines.append(f"{name:40s} {str(layer['type']):20s} [{shapes}]")
    return "\n".join(lines)
