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
category (the warp kernels, the reprojection error's, the cost volume,
BatchNorm, convolutions, matrix products, copies, the rest), each warp
kernel's device time, and the kernels that take the most device time,
all per step. Every port kernel is named by its table (``ops.KERNELS``), so none
falls under "other". Then, for one more step with the
allocator's history on, its peak of allocated bytes and the bytes live
at that peak by the line of this package that allocated them (with
K > 1 instead: the peak allocated over the first call, which captures
the graph, and the bytes the allocator still holds once its cache is
emptied, the graph's private pool included). It needs a GPU.

The benchmark harness (the reference's ``caffe time`` rebuild, the
counterpart of ``depthvo_tpu/utils/profiling.py``) is here too:
:func:`run_benchmark` times a hot path (``cli bench --mode ...``),
:func:`depth_layer_table` gives the per-layer forward and backward table
of a network, :func:`time_fn` is their host-clock timer and
:func:`device_ms` / :func:`graph_replay_ms` the CUDA-graph replay timer,
and :func:`maybe_trace` writes a ``torch.profiler`` Chrome trace.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import statistics
import time
from typing import Any, Callable, Dict

import numpy as np
import torch

from depthvo_tpu_torch import configs, ops
from depthvo_tpu_torch.data.synthetic import SyntheticScenes
from depthvo_tpu_torch.ops import _build, cost_volume, reproj, warp_kernels
from depthvo_tpu_torch.train import loop
from depthvo_tpu_torch.train.state import build_models, create_state, init_params, load_params
from depthvo_tpu_torch.utils import spans
from depthvo_tpu_torch.utils.device import resolve_device

_CATEGORIES = (
    ("warp_kernels", tuple(ops.symbols(warp_kernels.KERNELS))),
    ("reprojection", tuple(ops.symbols(reproj.KERNELS))),
    ("cost_volume", tuple(ops.symbols(cost_volume.KERNELS))),
    ("memcpy", ("memcpy", "memset")),
    # Before the convolution keys, which would claim cuDNN's BatchNorm
    # kernels by their ``cudnn`` prefix. ``bn_`` takes cuDNN's (bn_fw_*,
    # bn_bw_*) and the mesh's (``ops.batch_norm.KERNELS``), ``batch_norm``
    # PyTorch's and Monodepth2's encoders' (``ops.md2_batch_norm.KERNELS``).
    ("batch_norm", ("bn_", "batch_norm", "batchnorm")),
    ("convolution", ("conv", "cudnn", "xmma", "implicit", "winograd", "fprop", "dgrad",
                     "wgrad")),
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


def device_kernels(prof) -> tuple:
    """The CUDA kernels of a ``torch.profiler`` trace: {kernel name:
    [device us, launches]}, and the us in which any of them ran (the
    union of their intervals)."""
    by_name: Dict[str, list] = {}
    intervals = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            tot = by_name.setdefault(e.name, [0.0, 0])
            tot[0] += e.time_range.elapsed_us()
            tot[1] += 1
            intervals.append((e.time_range.start, e.time_range.end))
    return by_name, _busy_us(intervals)


def matching(by_name: Dict[str, list], names) -> list:
    """[device us, launches] of the kernels of :func:`device_kernels` whose
    name contains one of ``names`` (a kernel table's entry)."""
    hits = [v for k, v in by_name.items() if any(n in k for n in names)]
    return [sum(us for us, _ in hits), sum(c for _, c in hits)]


def heaviest_kernels(by_name: Dict[str, list], n: int, width: int) -> list:
    """The ``n`` kernels of :func:`device_kernels` that take most device
    time, by the first ``width`` characters of their names: [name, us,
    launches], largest first."""
    tops: Dict[str, list] = {}
    for name, (us, c) in by_name.items():
        tot = tops.setdefault(name[:width], [0.0, 0])
        tot[0] += us
        tot[1] += c
    return sorted(([k, us, c] for k, (us, c) in tops.items()), key=lambda r: -r[1])[:n]


def _trace(run_step, data, top_kernels: int, steps_per_run: int = 1) -> Dict:
    """Warm up on two batches, then trace one ``run_step(batch)`` per batch
    of ``data`` (``steps_per_run`` steps each) and sum the device kernels,
    per step."""
    from torch.profiler import ProfilerActivity, profile

    for batch in data[:2]:
        run_step(batch)
    torch.cuda.synchronize()
    _build.reset_launches()
    n = len(data) * steps_per_run
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in data:
            run_step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, busy = device_kernels(prof)
    by_cat: Dict[str, float] = collections.Counter()
    for name, (us, _) in by_name.items():
        by_cat[category(name)] += us
    return {
        "device": torch.cuda.get_device_name(0),
        "wall_ms_per_step_traced": wall_us / n / 1e3,
        "device_busy_ms_per_step": busy / n / 1e3,
        "device_busy_share": busy / wall_us,
        "kernels_per_step": sum(c for _, c in by_name.values()) / n,
        "warp_launches_per_step": {k: _build.launch_count(k) / n for k in warp_kernels.KERNELS},
        "device_ms_per_step_by_category": {
            k: v / n / 1e3 for k, v in sorted(by_cat.items())
        },
        "warp_kernel_ms_per_step": {k: matching(by_name, names)[0] / n / 1e3
                                    for k, names in warp_kernels.KERNELS.items()},
        "top_kernels": [
            {"name": name, "category": category(name), "ms_per_step": us / n / 1e3,
             "launches_per_step": c / n}
            for name, us, c in heaviest_kernels(by_name, top_kernels, 100)
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


# --------------------------------------------------------------------------
# The benchmark harness (``cli bench``).
# --------------------------------------------------------------------------

# Dense bf16 peak of a card (TFLOP/s, without sparsity, NVIDIA's data
# sheet) by the prefix of ``torch.cuda.get_device_name``, for MFU. A card
# not listed reports no MFU rather than one against another card's peak.
_BF16_PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,  # H100 SXM at its 700 W limit
}
_TIME_KEYS = ("mean_s", "median_s", "min_s", "p95_s")


def _bf16_peak_tflops(device_name: str) -> float | None:
    return next((peak for prefix, peak in _BF16_PEAK_TFLOPS.items()
                 if device_name.startswith(prefix)), None)


def _fence() -> None:
    """Wait for the card's queued work (a no-op where CUDA is not in use):
    PyTorch returns before the device finishes."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _stats(per_call_s, steps: int) -> Dict[str, float]:
    arr = np.asarray(per_call_s, dtype=np.float64)
    return {
        "mean_s": float(arr.mean()),
        "median_s": float(np.median(arr)),
        # The minimum: the lowest-noise estimator for repeated identical
        # device work (timing noise only adds), which the layer table uses.
        "min_s": float(arr.min()),
        "p95_s": float(np.percentile(arr, 95)),
        "steps": steps,
    }


def time_fn(fn: Callable[[], Any], steps: int = 50, warmup: int = 5,
            chunk: int = 10) -> Dict[str, float]:
    """Steady-state wall time per call: chunks of ``chunk`` back-to-back
    calls, each chunk ending in one fence (``torch.cuda.synchronize()``;
    the reference fetches a leaf to the host), after ``warmup`` calls.
    Returns mean/median/min/p95 seconds per call over the chunks."""
    for _ in range(warmup):
        fn()
    _fence()
    chunk_times = []
    done = 0
    while done < steps:
        n = min(chunk, steps - done)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        _fence()
        chunk_times.append((time.perf_counter() - t0) / n)
        done += n
    return _stats(chunk_times, steps)


def graph_replay_ms(fn: Callable[[], Any], runs: int = 25, per_run: int = 10) -> list:
    """Device time of one ``fn()`` call in each of ``runs`` replays:
    ``per_run`` calls are captured in a CUDA graph (after three calls on a
    side stream, which set cuDNN, cuBLAS and the allocator up outside the
    capture) and each replay is timed with CUDA events, so host launch
    overhead stays out of the number. Milliseconds per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_run):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    del graph
    return times


def device_ms(fn: Callable[[], Any], runs: int = 25, per_run: int = 10) -> float:
    """Median of :func:`graph_replay_ms`: the device time of one call."""
    return statistics.median(graph_replay_ms(fn, runs, per_run))


def _inner_stats(fn: Callable[[], Any], k: int, steps: int, device: torch.device,
                 warmup: int = 5, chunk: int = 10) -> Dict[str, float]:
    """Per-call times of ``fn`` run ``k`` times per timed unit (the
    reference's ``k`` iterations inside one compiled scan): on the card,
    ``steps`` replays of a CUDA graph of ``k`` calls (:func:`graph_replay_ms`,
    device time); on the CPU, :func:`time_fn` of ``k`` calls in a row."""
    if device.type == "cuda":
        return _stats([ms / 1e3 for ms in graph_replay_ms(fn, steps, k)], steps)
    st = time_fn(lambda: [fn() for _ in range(k)], steps=steps, warmup=warmup, chunk=chunk)
    return {**{key: st[key] / k for key in _TIME_KEYS}, "steps": steps}


def depth_layer_order(num_scales: int, n_up: int = 5) -> list:
    """DepthNet's top-level module boundaries in execution order (the rows
    of the ``caffe time``-style per-layer table)."""
    order = ["ConvBlock_0"] + [f"ResNetStage_{i}" for i in range(4)]
    head = 0
    for i in range(n_up):
        order += [f"UpConv_{i}", f"ConvBlock_{i + 1}"]
        if i - (n_up - num_scales) >= 0:
            order.append(f"Conv_{head}")
            head += 1
    return order


def odom_layer_order(n_convs: int = 7, n_fc: int = 3) -> list:
    """OdomNet's top-level module boundaries in execution order."""
    return [f"ConvBlock_{i}" for i in range(n_convs)] + [f"Dense_{i}" for i in range(n_fc)]


def feat_layer_order(n_convs: int = 3) -> list:
    """FeatNet's top-level module boundaries in execution order (the
    dilated conv blocks, then the projection conv)."""
    return [f"ConvBlock_{i}" for i in range(n_convs)] + ["Conv_0"]


class _Boundary(Exception):
    """Raised by a forward hook at a prefix's last module, carrying its
    output: the rest of the network never runs."""

    def __init__(self, out):
        super().__init__()
        self.out = out


@contextlib.contextmanager
def _prefix(net: torch.nn.Module, boundary: str):
    """Yields ``run(x)``: ``net``'s forward up to and including its
    top-level module ``boundary``, returning that module's output. The
    boundary's forward hook, there for the block, raises
    :class:`_Boundary`, which ``run`` catches, so a CUDA graph can capture
    the prefix's kernels like any other call."""
    def hook(module, args, out):
        raise _Boundary(out)

    def run(x: torch.Tensor) -> torch.Tensor:
        try:
            net(x)
        except _Boundary as b:
            return b.out
        raise RuntimeError(f"the forward never reached {boundary}")

    handle = getattr(net, boundary).register_forward_hook(hook)
    try:
        yield run
    finally:
        handle.remove()


def depth_layer_table(
    batch_size: int = 128,
    height: int = 160,
    width: int = 608,
    steps: int = 20,
    variant: str = "full_feat",
    include_backward: bool = True,
    layers: "list | None" = None,
    net: str = "depth",
    device: str | torch.device | None = None,
) -> Dict[str, Any]:
    """Per-layer forward AND backward time of DepthNet (``net="depth"``),
    OdomNet (``"odom"``) or FeatNet (``"feat"``): the ``caffe time``
    table, with the reference's estimator.

    Each top-level module boundary is timed as its own prefix program (a
    forward hook ends the forward there, :func:`_prefix`), ``K_INNER``
    calls per timed unit, and a layer's time is the difference of
    consecutive cumulative times. Backward: the same prefix with the
    gradient of sum(output**2) with respect to the parameters, minus the
    forward cumulative. Each cumulative is the minimum over ``steps``
    units (CUDA-graph replays on the card, :func:`_inner_stats`), and is
    projected to be monotone (a longer prefix cannot be cheaper, so noise
    moves into the next row instead of a negative time). The networks run
    in eval mode with random weights (seed 0) on ``device`` (default
    ``cuda``; the CPU with ``device="cpu"``)."""
    dev = resolve_device(device)
    cfg = getattr(configs, variant)()
    # The table names the standard module boundaries: the s2d finest stage
    # computes the same function (the port runs the standard stage anyway).
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, height=height, width=width, s2d_finest=False))
    models = load_params(build_models(cfg), init_params(cfg, torch.Generator().manual_seed(0)),
                         dev).train(False)
    if net == "feat":
        if models.feat is None:
            raise ValueError(f"variant {variant!r} has no feature net")
        the_net, in_ch = models.feat, 3
        order = feat_layer_order(models.feat.num_convs)
    elif net == "odom":
        if models.odom is None:
            raise ValueError(f"variant {variant!r} has no odometry net")
        the_net, in_ch = models.odom, 6
        order = odom_layer_order(models.odom.num_convs, models.odom.num_fc + 1)
    elif net == "depth":
        the_net, in_ch = models.depth, 3
        order = depth_layer_order(cfg.model.num_scales)
    else:
        raise ValueError(f"unknown net {net!r} (want 'depth', 'odom', or 'feat')")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-1, 1, (batch_size, height, width, in_ch)),
                        dtype=torch.float32, device=dev)
    if layers is not None:
        order = [b for b in order if b in set(layers)]
    params = [p for p in the_net.parameters() if p.requires_grad]
    K_INNER = 4

    def forward(run):
        with torch.no_grad():
            run(x)

    def forward_backward(run):
        leaf = run(x)
        loss = torch.sum(torch.square(leaf.float()))
        torch.autograd.grad(loss, params, allow_unused=True)

    def cum_time(fn) -> float:
        return _inner_stats(fn, K_INNER, steps, dev, warmup=2, chunk=4)["min_s"]

    rows = []
    prev_f = prev_b = 0.0
    for boundary in order:
        with _prefix(the_net, boundary) as run:
            cum_f = max(cum_time(lambda: forward(run)), prev_f)
            row = {
                "layer": boundary,
                "forward_ms": round((cum_f - prev_f) * 1e3, 3),
                "fwd_cumulative_ms": round(cum_f * 1e3, 3),
            }
            if include_backward:
                cum_b = max(cum_time(lambda: forward_backward(run)) - cum_f, prev_b)
                row["backward_ms"] = round((cum_b - prev_b) * 1e3, 3)
                row["bwd_cumulative_ms"] = round(cum_b * 1e3, 3)
                prev_b = cum_b
        rows.append(row)
        prev_f = cum_f
    return {
        "mode": f"{net}_layers",
        "batch_size": batch_size,
        "height": height,
        "width": width,
        "backend": dev.type,
        "estimator": f"min over chunks, {steps} reps, K_inner={K_INNER}",
        "rows": rows,
    }


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
    """``torch.profiler`` over the block (the card's kernels too, where
    there is one), written as a Chrome trace to ``trace_dir/trace.json``,
    with ``utils.spans`` enabled in it so that the trace holds the port's
    ``depthvo.*`` ranges; a no-op when ``trace_dir`` is None."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    was_on = spans.enabled()
    spans.enable()
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        spans.enable(was_on)
        if not was_on:
            spans.reset()  # the trace holds them; nothing else reads them
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def _flops(fn: Callable[[], Any]) -> float:
    """The floating-point operations of one ``fn()`` as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them: convolutions
    and matrix products (forward and backward), not the warp kernels
    (launched outside PyTorch's dispatcher) nor elementwise ops."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def run_benchmark(
    mode: str = "depth_infer",
    batch_size: int = 4,
    height: int = 160,
    width: int = 608,
    steps: int = 50,
    trace_dir: str | None = None,
    variant: str = "full_feat",
    remat: bool = False,
    int8: bool = False,
    device: str | torch.device | None = None,
) -> Dict[str, Any]:
    """Benchmark one of the hot paths on ``device`` (default ``cuda``; the
    CPU with ``device="cpu"``); returns a JSON-able result dict with the
    reference's keys.

    Modes:
      depth_infer - the batched DepthNet forward (``int8``: the w8a8
        program, calibrated on the benchmark batch), ``K_INNER`` = 10
        forwards per timed unit: on the card a CUDA graph of them, so the
        time is the device's (the reference runs them in one scan).
      odom_infer  - the batched OdomNet forward and the exp-map.
      train_step  - ``make_train_step``, one eager step per call.
      train_step_scan - ``make_scan_train_step`` with K = 8 steps per call
        (on the card the step's CUDA graph replayed 8 times); per step.
      warp        - ``ops.fused_warp`` on (B, H, W, 3) inputs.

    The train modes run ``mesh=None``, the step ``cli train`` runs on one
    card (a mesh of one would add its collectives), and report
    ``flops_per_step`` (:func:`_flops` of one step: convolutions and
    matrix products only) and, on a card of the peak table, ``mfu``
    against its dense bf16 peak (``bf16_peak_tflops_assumed``). Timing
    runs under :func:`maybe_trace` with ``trace_dir``.
    """
    from depthvo_tpu_torch import ops
    from depthvo_tpu_torch.api import DepthVO
    from depthvo_tpu_torch.geometry import se3

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    extra: Dict[str, Any] = {}
    inner = 1  # calls folded into one timed unit

    def _cfg(**over):
        cfg = getattr(configs, variant)(**over)
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, height=height, width=width, remat=remat))

    def uniform(lo, hi, shape):
        return torch.as_tensor(rng.uniform(lo, hi, shape), dtype=torch.float32, device=dev)

    if mode == "depth_infer":
        model = DepthVO.from_random(_cfg(), device=dev)
        images = uniform(-1, 1, (batch_size, height, width, 3))
        if int8:
            model.calibrate_int8(images)
            extra["int8"] = True
        depth_net = model.models.depth
        inner = 10

        def fn():
            with torch.no_grad():
                return depth_net(images)[-1]
    elif mode == "odom_infer":
        model = DepthVO.from_random(_cfg(), device=dev)
        pairs = uniform(-1, 1, (batch_size, height, width, 6))

        def fn():
            with torch.no_grad():
                return se3.exp(model.models.odom(pairs))
    elif mode in ("train_step", "train_step_scan"):
        cfg = _cfg(batch_size=batch_size)
        state = create_state(cfg, dev)
        batch_np = SyntheticScenes(cfg, seed=0, num_scenes=2).batch(batch_size)
        batch = loop.batch_to_device(batch_np, dev)
        one_step = loop.make_train_step(cfg, device=dev)
        # Counted on one real eager step (it also warms the step up).
        extra["flops_per_step"] = _flops(lambda: one_step(state, batch))
        if mode == "train_step_scan":
            K_SCAN = 8
            stacked = loop.batch_to_device(loop.stack_batches([batch_np] * K_SCAN), dev)
            scan = loop.make_scan_train_step(cfg, device=dev)
            inner = K_SCAN
            extra["steps_per_call"] = K_SCAN

            def fn():
                return scan(state, stacked)[1]
        else:
            def fn():
                return one_step(state, batch)[1]
    elif mode == "warp":
        src = uniform(-1, 1, (batch_size, height, width, 3))
        depth = uniform(4, 40, (batch_size, height, width))
        T = torch.eye(4, device=dev).repeat(batch_size, 1, 1)
        T[:, 0, 3] = -0.54
        K = torch.tensor([[0.58 * width, 0, width / 2], [0, 1.92 * height, height / 2],
                          [0, 0, 1]], dtype=torch.float32, device=dev)

        def fn():
            with torch.no_grad():
                return ops.fused_warp(src, depth, T, K)
    else:
        raise ValueError(f"unknown bench mode {mode!r}")

    with maybe_trace(trace_dir):
        if mode == "depth_infer":
            stats = _inner_stats(fn, inner, steps, dev)
        else:
            stats = time_fn(fn, steps=steps)
            if inner != 1:
                stats.update({k: stats[k] / inner for k in _TIME_KEYS})
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if "flops_per_step" in extra and dev.type == "cuda":
        peak = _bf16_peak_tflops(name)
        if peak is not None:
            extra["mfu"] = round(extra["flops_per_step"] / stats["median_s"] / (peak * 1e12), 4)
            # The denominator, so the number is never read against another peak.
            extra["bf16_peak_tflops_assumed"] = peak
    return {
        "mode": mode,
        "variant": variant,
        "batch_size": batch_size,
        "height": height,
        "width": width,
        "backend": dev.type,
        "device": name,
        **stats,
        **extra,
        "frames_per_sec": batch_size / stats["median_s"],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="depthvo_tpu_torch.utils.profiling")
    p.add_argument("--mode", default="train", choices=["train", "eval"])
    p.add_argument("--variant", default="full_feat", choices=configs.VARIANTS)
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
