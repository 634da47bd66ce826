"""Where the train step and the held-out loss pass spend their time on
the GPU (the device-breakdown part of ``depthvo_tpu/utils/profiling.py``'s
role).

    python -m depthvo_tpu_torch.utils.profiling --mode train --variant full_feat --batches 5
    python -m depthvo_tpu_torch.utils.profiling --mode train --steps-per-call 8 --batches 3
    python -m depthvo_tpu_torch.utils.profiling --mode eval --variant full_feat --batches 5

runs ``make_train_step`` (``--mode train``), ``make_scan_train_step``
(``--mode train --steps-per-call K``, K > 1: the step as a CUDA graph,
replayed K times per call on a stack of K batches already on the device;
the reference's ``train_step_scan`` mode) or ``make_eval_step``
(``--mode eval``) on synthetic uint8 batches (random weights from
``--seed``), warms up, then traces ``--batches`` calls with
``torch.profiler`` and prints one JSON line: host wall time per step
(traced, so with the profiler's overhead), device kernel time per step
and the busy share of the wall time, kernel launches per step (all
kernels, and the warp kernels' own counters), the device time by
category (the warp kernels, convolutions, matrix products, copies, the
rest), each warp kernel's device time, and the kernels that take the
most device time, all per step; then, for one more step with the
allocator's history on, its peak of allocated bytes and the bytes live
at that peak by the line of this package that allocated them (with
K > 1 instead: the peak allocated over the first call, which captures
the graph, and the bytes the allocator still holds once its cache is
emptied, the graph's private pool included). It needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import time
from typing import Dict

import torch

from depthvo_tpu_torch import configs
from depthvo_tpu_torch.data.synthetic import SyntheticScenes
from depthvo_tpu_torch.ops import warp_kernels
from depthvo_tpu_torch.train import loop
from depthvo_tpu_torch.train.state import build_models, create_state, init_params, load_params

WARP_KERNELS = ("stereo_fwd_pyramid_kernel", "stereo_bwd_u_pyramid_kernel",
                "stereo_bwd_src_kernel", "gen_fwd_pyramid_kernel", "gen_bwd_uv_kernel")
_CATEGORIES = (
    ("warp_kernels", WARP_KERNELS),
    ("memcpy", ("memcpy",)),
    ("convolution", ("conv", "cudnn", "xmma", "implicit", "winograd", "fprop")),
    ("matmul", ("gemm", "cutlass", "cublas")),
)


def category(kernel_name: str) -> str:
    name = kernel_name.lower()
    for cat, keys in _CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other"


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _trace(run_step, data, top_kernels: int, steps_per_run: int = 1) -> Dict:
    """Warm up on two batches, then trace one ``run_step(batch)`` per batch
    of ``data`` (``steps_per_run`` steps each) and sum the device kernels,
    per step."""
    from torch.profiler import ProfilerActivity, profile

    for batch in data[:2]:
        run_step(batch)
    torch.cuda.synchronize()
    warp_kernels.reset_launches()
    n = len(data) * steps_per_run
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in data:
            run_step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    launches = {k: warp_kernels.launch_count(k) / n for k in
                ("stereo_fwd", "stereo_bwd_u", "stereo_bwd_src", "gen_fwd", "gen_fwd_aux",
                 "gen_bwd_uv")}
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_cat: Dict[str, float] = {}
    by_name: Dict[str, list] = {}
    by_warp = {k: 0.0 for k in WARP_KERNELS}
    for e in kernels:
        us = e.time_range.elapsed_us()
        cat = category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + us
        tot = by_name.setdefault(e.name[:100], [0.0, 0])
        tot[0] += us
        tot[1] += 1
        for k in WARP_KERNELS:
            if k in e.name:
                by_warp[k] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_kernels]
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    return {
        "device": torch.cuda.get_device_name(0),
        "wall_ms_per_step_traced": wall_us / n / 1e3,
        "device_busy_ms_per_step": busy / n / 1e3,
        "device_busy_share": busy / wall_us,
        "kernels_per_step": len(kernels) / n,
        "warp_launches_per_step": launches,
        "device_ms_per_step_by_category": {
            k: v / n / 1e3 for k, v in sorted(by_cat.items())
        },
        "warp_kernel_ms_per_step": {k: v / n / 1e3 for k, v in by_warp.items()},
        "top_kernels": [
            {"name": name, "category": category(name), "ms_per_step": us / n / 1e3,
             "launches_per_step": c / n}
            for name, (us, c) in top
        ],
    }


def _site(frames) -> str:
    """Where an allocation was made: the innermost frame of this package
    (this module excluded) in its Python stack."""
    for f in frames:
        name = f["filename"]
        if "depthvo_tpu_torch" in name and not name.endswith("profiling.py"):
            return f"{name[name.rindex('depthvo_tpu_torch'):]}:{f['line']} {f['name']}"
    return "(outside depthvo_tpu_torch)"


def peak_by_site(events, baseline: int, top: int) -> Dict:
    """Replay an allocator history (``alloc`` and ``free_requested`` events
    with addr, size and frames) that starts with ``baseline`` bytes
    allocated: its peak of allocated bytes and the bytes live at the
    first such peak by :func:`_site` (blocks allocated before the history
    under "(before the step)"), the ``top`` largest."""
    total, peak, at = baseline, baseline, -1
    for i, e in enumerate(events):
        if e["action"] in ("alloc", "free_requested"):
            total += e["size"] if e["action"] == "alloc" else -e["size"]
            if total > peak:
                peak, at = total, i
    live, before = {}, baseline
    for e in events[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_requested" and live.pop(e["addr"], None) is None:
            before -= e["size"]
    sites = collections.Counter({"(before the step)": before})
    for e in live.values():
        sites[_site(e["frames"])] += e["size"]
    return {"peak_bytes": peak, "live_at_peak_by_site": dict(sites.most_common(top))}


def _memory(run_step, batch, top: int) -> Dict:
    """One more ``run_step(batch)`` with the allocator's history on:
    :func:`peak_by_site` of it, beside the allocator's own peak."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    baseline = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(stacks="python")
    try:
        run_step(batch)
        torch.cuda.synchronize()
        events = torch.cuda.memory._snapshot()["device_traces"][torch.cuda.current_device()]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    out = peak_by_site(events, baseline, top)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out


def profile(mode: str, variant: str, batches: int = 5, batch_size: int = 4,
            seed: int = 0, top_kernels: int = 15, steps_per_call: int = 1) -> Dict:
    """Trace ``batches`` calls of ``steps_per_call`` train steps
    (``mode="train"``) or held-out loss passes (``mode="eval"``) on the
    GPU, then record the allocations of one more."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile measures the GPU; no CUDA device is available")
    dev = torch.device("cuda")
    cfg = getattr(configs, variant)(batch_size=batch_size, seed=seed)
    scenes = SyntheticScenes(cfg, seed=cfg.seed + 1_000_003, u8=True)
    data = [scenes.batch(batch_size) for _ in range(batches)]
    K = steps_per_call
    if mode == "train" and K > 1:
        state = create_state(cfg, dev)
        scan = loop.make_scan_train_step(cfg, device=dev)
        stacked = loop.batch_to_device(
            loop.stack_batches([data[k % batches] for k in range(K)]), dev)
        data = [stacked] * batches

        def run_step(batch):
            scan(state, batch)
    elif mode == "train":
        state = create_state(cfg, dev)
        step_fn = loop.make_train_step(cfg, device=dev)

        def run_step(batch):
            step_fn(state, batch)
    elif mode == "eval":
        models = load_params(build_models(cfg),
                             init_params(cfg, torch.Generator().manual_seed(seed)), dev)
        eval_fn = loop.make_eval_step(cfg, device=dev)

        def run_step(batch):
            eval_fn(models, batch)
    else:
        raise ValueError(f"mode must be 'train' or 'eval', got {mode!r}")
    out = {"mode": mode, "variant": variant, "batch": batch_size, "steps": batches * K,
           "steps_per_call": K, "compute_dtype": cfg.model.compute_dtype}
    if K == 1:
        out.update(_trace(run_step, data, top_kernels))
        out["memory"] = _memory(run_step, data[0], top_kernels)
        return out
    torch.cuda.reset_peak_memory_stats()
    out.update(_trace(run_step, data, top_kernels, K))
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    out["memory"] = {"max_memory_allocated": peak,
                     "reserved_after_empty_cache": torch.cuda.memory_reserved()}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="depthvo_tpu_torch.utils.profiling")
    p.add_argument("--mode", default="train", choices=["train", "eval"])
    p.add_argument("--variant", default="full_feat",
                   choices=["stereo", "temporal_stereo", "full_feat", "tiny_test"])
    p.add_argument("--batches", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="train mode: K > 1 replays a CUDA graph of the step K times per call")
    args = p.parse_args(argv)
    print(json.dumps(profile(args.mode, args.variant, args.batches, args.batch_size,
                             args.seed, steps_per_call=args.steps_per_call)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
