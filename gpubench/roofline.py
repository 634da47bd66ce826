"""Peaks of the device and the warp kernels' byte bound, frozen copies of
``chip_smoke.py``'s arithmetic: every input read once and every output
written once, float32 throughout.

Per train step, over the loss pyramid's scales (B rows, C channels, h x w):

* stereo forward (``stereo_fwd``, one launch over the scales): the
  source, the output, the sample columns: 4 (2 B C h w + B h w);
* stereo backward to the columns (``stereo_bwd_u``): the source, the
  cotangent, the columns, their gradient: 4 (2 B C h w + 2 B h w);
* general forward (``gen_fwd``): the source, the output, u, v:
  4 (2 B C h w + 2 B h w), over the temporal scales (C = 3) and the
  finest scale's image and features together (C = 3 + feature channels);
* general backward to (u, v) (``gen_bwd_uv``): the source, the
  cotangent, u, v and their gradients: 4 (2 B C h w + 4 B h w).
"""

from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks(device_name: str) -> dict | None:
    with open(os.path.join(HERE, "peaks.json")) as f:
        for row in json.load(f)["devices"]:
            if row["match"] in device_name:
                return row
    return None


def scales(config: dict):
    m = config["model"]
    return [(m["height"] >> k, m["width"] >> k) for k in reversed(range(m["num_scales"]))]


def warp_bytes_per_step(config: dict) -> int:
    B = config["batch_size"]
    hws = scales(config)
    total = 0
    if config["use_stereo"]:
        for h, w in hws:
            total += 4 * (2 * B * 3 * h * w + B * h * w)
            total += 4 * (2 * B * 3 * h * w + 2 * B * h * w)
    if config["use_temporal"]:
        fused = config["use_feature"]
        segments = [(3, h, w) for h, w in (hws[:-1] if fused else hws)]
        if fused:
            segments.append((3 + config["model"]["feat_channels"],) + hws[-1])
        for C, h, w in segments:
            total += 4 * (2 * B * C * h * w + 2 * B * h * w)
            total += 4 * (2 * B * C * h * w + 4 * B * h * w)
    return total
