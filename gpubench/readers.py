"""Arithmetic shared by the per-layer readers in ``metrics/``. Each reader
gets the run's record (window seconds, steps, the reduced
trace, spans, the FLOP count of a step, the device's name) and returns a number,
or None where the record holds nothing to read."""

from __future__ import annotations

from gpubench import roofline

NOT_TAIL = ("convolution", "matmul", "memcpy", "warp")


def idle_share(run: dict):
    t = run.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(run: dict):
    peak = roofline.peaks(run["device_name"])
    work = run.get("flops_per_step", 0) * run.get("steps", 0)
    if not peak or not run.get("trace") or work <= 0:
        return None
    return 100.0 * work / run["window_s"] / peak["bf16_flop_per_s"]


def ms_per_step(run: dict, pick):
    t = run.get("trace")
    if not t or not run.get("steps"):
        return None
    return 1e3 * sum(s for cat, s in t["by_category_s"].items() if pick(cat)) / run["steps"]


def warp_roofline(run: dict):
    t, peak = run.get("trace"), roofline.peaks(run["device_name"])
    measured = (t or {}).get("by_category_s", {}).get("warp", 0.0)
    if not peak or measured <= 0 or not run.get("steps"):
        return None
    bound = roofline.warp_bytes_per_step(run["config"]) * run["steps"] / peak["hbm_bytes_per_s"]
    return 100.0 * bound / measured


def span_ms(run: dict):
    spans = run.get("spans") or []
    if not spans:
        return None
    return 1e3 * sum(e - s for s, e in spans) / len(spans)
