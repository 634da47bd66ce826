"""Where the held-out loss pass spends its time on the GPU (the eval-pass
part of ``depthvo_tpu/utils/profiling.py``'s role).

    python -m depthvo_tpu_torch.utils.profiling --variant full_feat --batches 5

runs ``make_eval_step`` on synthetic uint8 batches (random weights from
``--seed``), warms up, then traces ``--batches`` batches with
``torch.profiler`` and prints one JSON line: host wall time per batch
(traced, so with the profiler's overhead), device kernel time per batch
and the busy share of the wall time, kernel launches per batch, the
device time by category (the two warp kernels, convolutions, matrix
products, copies, the rest) and the kernels that take the most device
time. It needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from depthvo_tpu_torch import configs
from depthvo_tpu_torch.data.synthetic import SyntheticScenes
from depthvo_tpu_torch.train import loop
from depthvo_tpu_torch.train.state import build_models, init_params, load_params

_CATEGORIES = (
    ("warp_kernels", ("stereo_fwd_kernel", "gen_fwd_kernel")),
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


def profile_eval(variant: str, batches: int = 5, batch_size: int = 4,
                 seed: int = 0, top_kernels: int = 15) -> Dict:
    """Trace ``batches`` batches of the eval pass on the GPU."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("profile_eval measures the GPU; no CUDA device is available")
    dev = torch.device("cuda")
    cfg = getattr(configs, variant)(batch_size=batch_size)
    models = load_params(build_models(cfg),
                         init_params(cfg, torch.Generator().manual_seed(seed)), dev)
    scenes = SyntheticScenes(cfg, seed=cfg.seed + 1_000_003, u8=True)
    data = [scenes.batch(batch_size) for _ in range(batches)]
    eval_fn = loop.make_eval_step(cfg, device=dev)
    loop.run_validation(eval_fn, models, iter(data[:2]), 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.run_validation(eval_fn, models, iter(data), batches)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_cat: Dict[str, float] = {}
    by_name: Dict[str, list] = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        cat = category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + us
        tot = by_name.setdefault(e.name[:100], [0.0, 0])
        tot[0] += us
        tot[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_kernels]
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    return {
        "variant": variant, "batch": batch_size, "batches": batches,
        "compute_dtype": cfg.model.compute_dtype,
        "device": torch.cuda.get_device_name(0),
        "wall_ms_per_batch_traced": wall_us / batches / 1e3,
        "device_busy_ms_per_batch": busy / batches / 1e3,
        "device_busy_share": busy / wall_us,
        "kernels_per_batch": len(kernels) / batches,
        "device_ms_per_batch_by_category": {
            k: v / batches / 1e3 for k, v in sorted(by_cat.items())
        },
        "top_kernels": [
            {"name": n, "category": category(n), "ms_per_batch": us / batches / 1e3,
             "launches_per_batch": c / batches}
            for n, (us, c) in top
        ],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="depthvo_tpu_torch.utils.profiling")
    p.add_argument("--variant", default="full_feat",
                   choices=["stereo", "temporal_stereo", "full_feat", "tiny_test"])
    p.add_argument("--batches", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    print(json.dumps(profile_eval(args.variant, args.batches, args.batch_size,
                                  args.seed)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
