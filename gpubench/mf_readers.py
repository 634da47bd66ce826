"""Arithmetic of the ManyDepth cell's per-layer readers
(``metrics/*.mf.py``), over the run's record as ``gpubench/readers.py``
reads it: the reduced trace's device seconds by kernel name pick the cost
volume's kernel (``cost_volume`` in the name), the border warps (``border``,
as ``gpubench/md2_readers.py`` picks them) and the loss tail (the
rest, less the ``border`` kernels and what the frozen category table
names convolution, matmul, memcpy or BatchNorm). Each returns None where
the record holds nothing to read, as on a program without the cost
volume kernel."""

from __future__ import annotations

from gpubench import md2_readers, mf_roofline, roofline, trace


def _cost_volume(name: str) -> bool:
    return "cost_volume" in name.lower()


def cost_volume_seconds(run: dict) -> float:
    t = run.get("trace") or {}
    return sum(s for n, s in t.get("by_name_s", {}).items() if _cost_volume(n))


def cost_volume_roofline(run: dict):
    peak = roofline.peaks(run.get("device_name", ""))
    measured = cost_volume_seconds(run)
    if not peak or measured <= 0 or not run.get("steps"):
        return None
    bound = mf_roofline.cost_volume_bytes_per_step(run["config"]) * run["steps"]
    return 100.0 * bound / peak["hbm_bytes_per_s"] / measured


def border_roofline(run: dict):
    peak = roofline.peaks(run.get("device_name", ""))
    measured = md2_readers.border_seconds(run)
    if not peak or measured <= 0 or not run.get("steps"):
        return None
    bound = mf_roofline.border_bytes_per_step(run["config"]) * run["steps"]
    return 100.0 * bound / peak["hbm_bytes_per_s"] / measured


def loss_ms_per_step(run: dict):
    t = run.get("trace")
    if not t or not run.get("steps") or cost_volume_seconds(run) <= 0:
        return None
    table = trace.categories()
    seconds = sum(s for n, s in t.get("by_name_s", {}).items()
                  if not _cost_volume(n) and "border" not in n.lower()
                  and trace.category(n, table) not in md2_readers.NOT_LOSS)
    return 1e3 * seconds / run["steps"]
