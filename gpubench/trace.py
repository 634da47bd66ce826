"""Reduce a ``torch.profiler`` trace of the measured window to what the
per-layer readers need.

The arithmetic is a frozen copy of ``depthvo_tpu_torch/utils/profiling.py``'s
``_trace``: device events from the profiler, the busy time as the union of
their intervals, time by kernel category from the kernel's name. The
category table (``categories.json``) is frozen here too; BatchNorm's cuDNN
kernels are told apart before the convolution keys, which would otherwise
claim them by their ``cudnn`` prefix.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import torch

MARK_PREFIX = "gpubench."  # the harness's own ranges, never device work
_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "categories.json")


def categories() -> List[Tuple[str, List[str]]]:
    with open(_TABLE) as f:
        return [(c["category"], c["keys"]) for c in json.load(f)["categories"]]


def category(name: str, table=None) -> str:
    low = name.lower()
    for cat, keys in table or categories():
        if any(k in low for k in keys):
            return cat
    return "other"


def union(intervals) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def reduce(prof, window: Tuple[float, float], top: int = 10) -> Dict:
    """Device busy seconds, seconds by kernel category and by kernel name,
    the ``top`` device operations by time and the ``top`` longest idle
    gaps inside ``window`` (profiler microseconds), each named by what the
    host was doing."""
    table = categories()
    device, host = [], []
    for e in prof.events():
        tr = e.time_range
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if on_device and (e.name.startswith(MARK_PREFIX)
                          or getattr(e, "is_user_annotation", False)):
            continue  # a host range's mirror on the device's timeline: no work
        (device if on_device else host).append((tr.start, tr.end, e.name))
    lo, hi = window
    device = [(max(s, lo), min(e, hi), n) for s, e, n in device if e > lo and s < hi]
    by_cat: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for s, e, n in device:
        by_cat[category(n, table)] = by_cat.get(category(n, table), 0.0) + (e - s) * 1e-6
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    busy = union((s, e) for s, e, _ in device)
    gaps, prev = [], lo
    for s, e in busy + [(hi, hi)]:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    gaps.sort(reverse=True)

    ops = [h for h in host if not h[2].startswith(MARK_PREFIX)]

    def doing(a: float, b: float) -> str:
        """The innermost host operation spanning the gap's middle, else
        the one that ended last before it."""
        t = (a + b) / 2
        spans = [(e - s, n) for s, e, n in ops if s <= t <= e]
        if spans:
            return f"host: {min(spans)[1]}"
        before = [(e, n) for s, e, n in ops if e <= t]
        return f"host: after {max(before)[1]}" if before else "host: no traced operation"

    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": (hi - lo) * 1e-6,
        "kernels": len(device),
        "by_category_s": by_cat,
        "by_name_s": by_name,
        "device_ops": [[n[:160], s] for n, s in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[doing(a, b), g * 1e-6] for g, a, b in gaps[:top]],
    }
