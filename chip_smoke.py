#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``depthvo_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and ends the run
with a nonzero exit code:

1. device  - the card's name, and its name and power limit from nvidia-smi.
2. build   - compile every kernel in ``depthvo_tpu_torch/ops/csrc`` with
             nvcc for sm_90a (all sources at once); seconds and ptxas usage.
3. kernels - each CUDA kernel against its plain PyTorch version on the
             card, at every shape the full_feat 608x160 batch-4 loss pass
             gives it, on coordinates from a synthetic scene's depth map
             and pose: ``valid`` identical, max abs error under ``valid``
             (stereo_fwd <= 2e-7, gen_fwd out/S/D <= 1e-6), and the device
             time of kernel, plain version and ``F.grid_sample`` (the
             library yardstick), each the median of 25 CUDA-event-timed
             replays of a CUDA graph of 10 launches (host launch overhead
             excluded, L2 warm), beside the byte bound at 3.35 TB/s.
4. slice   - the held-out loss pass (``make_eval_step`` + ``run_validation``,
             what ``cli test`` runs) on full_feat at 608x160, batch 4:
             float32 with TF32 off against the same pass on the CPU (plain
             versions, same weights, one batch, <= 1e-4 relative per
             metric); 4 batches with exactly 4 stereo_fwd + 4 gen_fwd
             launches per batch; then the main path: ``cli test`` on the
             default (bfloat16) config, launch counts reset just before and
             read just after, and its ms/batch, frames/s and peak memory.
5. serve   - ``DepthVO.from_random(full_feat())``: depth of a (4,160,608,3)
             uint8 batch and pose of its frame pairs; shapes, finiteness
             and latency.

The last three lines are the nvidia-smi line, the ``{"kernels": [...]}``
summary and ``{"ok": true, "device": {...}}``. Without a GPU the script
exits with code 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BATCH = 4
K1_TOL = 2e-7
K4_TOL = 1e-6
METRIC_RTOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_ms(fn, runs: int = 25, per_run: int = 10) -> float:
    """Median device time of one ``fn()`` call: ``per_run`` calls are
    captured in a CUDA graph and each of ``runs`` replays is timed with
    CUDA events, so host launch overhead stays out of the number."""
    import torch

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
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def masked_max_err(a, b, valid) -> float:
    import torch

    mask = valid[:, None].expand_as(a)
    return float(torch.abs(a - b)[mask].max())


def phase_device() -> tuple[str, str]:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "torch_device": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name, smi


def phase_build() -> None:
    from depthvo_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    seconds = time.perf_counter() - t0
    ptxas = []
    for path in libs.values():
        log = path.with_name(path.name + ".log")
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds, "sources": sorted(libs),
          "ptxas": ptxas})


def scale_shapes(cfg):
    """(h, w) of the loss pyramid, coarsest first, as the DepthNet emits it."""
    H, W = cfg.model.height, cfg.model.width
    n = cfg.model.num_scales
    return [(H >> (n - 1 - i), W >> (n - 1 - i)) for i in range(n)]


def phase_kernels(cfg, dev):
    """Every kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from depthvo_tpu_torch import ops
    from depthvo_tpu_torch.configs.base import stereo_dmax
    from depthvo_tpu_torch.data.synthetic import SyntheticScenes
    from depthvo_tpu_torch.geometry import se3
    from depthvo_tpu_torch.geometry.camera import scale_intrinsics
    from depthvo_tpu_torch.models.layers import resize_bilinear_chw
    from depthvo_tpu_torch.ops import warp_kernels as wk

    scenes = SyntheticScenes(cfg, seed=3, num_scenes=BATCH)
    scene = {k: torch.as_tensor(np.stack([s[k] for s in scenes._scenes])).to(dev)
             for k in ("image_r", "image_s", "depth", "T_ts")}
    K = torch.as_tensor(scenes.K).to(dev).expand(BATCH, 3, 3)
    # The scenes' poses through se3.log/exp; the last two reversed, so that
    # the camera moves forward there and samples leave the image.
    sign = torch.tensor([1.0, 1.0, -1.0, -1.0], device=dev)[:BATCH, None]
    T = se3.exp(se3.log(scene["T_ts"]) * sign)
    gen = torch.Generator(device=dev).manual_seed(0)
    H, W = cfg.model.height, cfg.model.width
    rows = []

    def chw(x, h, w):
        x = x.permute(0, 3, 1, 2).contiguous()
        return x if (h, w) == (H, W) else resize_bilinear_chw(x, h, w).contiguous()

    def grid_of(u, v, h, w):
        return torch.stack([u / (w - 1) * 2 - 1, v / (h - 1) * 2 - 1], dim=-1)

    def lib_sample(src, grid):
        return F.grid_sample(src, grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    for h, w in scale_shapes(cfg):
        depth = scene["depth"][:, None]
        depth = (depth if (h, w) == (H, W) else resize_bilinear_chw(depth, h, w))[:, 0].contiguous()
        Ks = scale_intrinsics(K, w / W, h / H)

        # K1: the stereo warp of the right view, C=3.
        src = chw(scene["image_r"], h, w)
        dmax = stereo_dmax(cfg, w)
        disp, u = wk.stereo_disparity_u(depth, Ks[..., 0, 0] * cfg.stereo_baseline, w)
        u = u.contiguous()
        warped, valid = wk.stereo_warp_chw(src, depth, Ks[..., 0, 0] * cfg.stereo_baseline, dmax)
        valid_ref = wk.stereo_valid_mask(depth, disp, u, h, w, dmax)
        if not torch.equal(valid, valid_ref):
            raise AssertionError(f"stereo valid differs at {(h, w)}")
        plain = wk.stereo_sample_plain(src, u)
        err = masked_max_err(warped, plain, valid)
        if not err <= K1_TOL:
            raise AssertionError(f"stereo_fwd at {(h, w)}: max err {err} > {K1_TOL}")
        rowsv = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None].expand_as(u)
        grid = grid_of(u.clamp(0, w - 1), rowsv, h, w)
        nbytes = 4 * (2 * src.numel() + u.numel())
        b_ms, b_by = bound_ms(nbytes, 4 * src.numel())
        rows.append({
            "kernel": "stereo_fwd", "shape": list(src.shape), "dmax": dmax,
            "valid_frac": float(valid.float().mean()), "max_abs_err": err,
            "ms": device_ms(lambda: wk.stereo_sample_cuda(src, u)),
            "plain_ms": device_ms(lambda: wk.stereo_sample_plain(src, u)),
            "library_ms": device_ms(lambda: lib_sample(src, grid)),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
        })

        # K4: the temporal warp (C=3) at the coarse scales, the fused
        # RGB + feature warp (C=3+16) at the finest.
        src = chw(scene["image_s"], h, w)
        if (h, w) == (H, W):
            feats = torch.randn(BATCH, cfg.model.feat_channels, h, w, device=dev,
                                generator=gen)
            src = torch.cat([src, feats / feats.norm(dim=1, keepdim=True)], dim=1)
        warped, valid = ops.frozen_warp_chw(src, depth, T, Ks, pad_v=cfg.warp_pad_v)
        pad_v = ops.kernel_pad_v(h, cfg.warp_pad_v)
        u, v, valid_ref = wk._gen_warp_prep(depth, T, Ks, h, w, pad_v)
        if not torch.equal(valid, valid_ref):
            raise AssertionError(f"general valid differs at {(h, w)}")
        outs = wk.gen_sample_cuda(src, u, v, emit_grad_aux=True)
        plains = wk.gen_sample_plain(src, u, v, emit_grad_aux=True)
        errs = [masked_max_err(a, b, valid) for a, b in zip(outs, plains)]
        errs.append(masked_max_err(warped, plains[0], valid))
        if not max(errs) <= K4_TOL:
            raise AssertionError(f"gen_fwd at {(h, w)}: max errs {errs} > {K4_TOL}")
        grid = grid_of(u.clamp(0, w - 1), v.clamp(0, h - 1), h, w)
        for aux in (False, True):
            nbytes = 4 * ((3 if aux else 1) * src.numel() + src.numel() + 2 * u.numel())
            b_ms, b_by = bound_ms(nbytes, (17 if aux else 9) * src.numel())
            rows.append({
                "kernel": "gen_fwd_aux" if aux else "gen_fwd",
                "shape": list(src.shape), "pad_v": pad_v,
                "valid_frac": float(valid.float().mean()),
                "max_abs_err": max(errs[:3]) if aux else max(errs[0], errs[3]),
                "ms": device_ms(lambda: wk.gen_sample_cuda(src, u, v, aux)),
                "plain_ms": device_ms(lambda: wk.gen_sample_plain(src, u, v, aux)),
                "library_ms": None if aux else device_ms(lambda: lib_sample(src, grid)),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            })
    emit({"phase": "kernels", "shapes": rows})
    return rows


def _f32_config(cfg):
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32")
    )


def _check_counts(cfg, n_batches: int) -> dict:
    """Launches since the last reset: one of each kernel per scale and batch."""
    from depthvo_tpu_torch.ops import warp_kernels as wk

    counts = {k: wk.launch_count(k) for k in ("stereo_fwd", "gen_fwd")}
    n = cfg.model.num_scales * n_batches
    want = {"stereo_fwd": n, "gen_fwd": n}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    return counts


def phase_slice(variant: str, dev):
    import torch

    from depthvo_tpu_torch import cli, configs
    from depthvo_tpu_torch.data.synthetic import SyntheticScenes
    from depthvo_tpu_torch.ops import warp_kernels as wk
    from depthvo_tpu_torch.train import loop
    from depthvo_tpu_torch.train.state import build_models, init_params, load_params

    cfg = getattr(configs, variant)(batch_size=BATCH)
    out = {"phase": "slice", "config": variant,
           "hw": [cfg.model.height, cfg.model.width], "batch": BATCH}
    scenes = SyntheticScenes(cfg, seed=cfg.seed + 1_000_003, u8=True)
    batches = [scenes.batch(BATCH) for _ in range(4)]

    # float32, TF32 off: the card's pass against the CPU's on one batch.
    cfg32 = _f32_config(cfg)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    params = init_params(cfg32, torch.Generator().manual_seed(0))
    models = load_params(build_models(cfg32), params, dev)
    eval_fn = loop.make_eval_step(cfg32, device=dev)
    gpu = loop.run_validation(eval_fn, models, iter(batches[:1]), 1)
    cpu_models = load_params(build_models(cfg32), params, torch.device("cpu"))
    cpu = loop.run_validation(loop.make_eval_step(cfg32, device="cpu"), cpu_models,
                              iter(batches[:1]), 1)
    rel = {k: abs(gpu[k] - cpu[k]) / max(abs(cpu[k]), 1e-30) for k in cpu}
    if set(gpu) != set(cpu) or not max(rel.values()) <= METRIC_RTOL:
        raise AssertionError(f"card vs CPU metrics: {gpu} vs {cpu}")
    out["f32_vs_cpu_max_rel"] = max(rel.values())
    wk.reset_launches()
    f32 = loop.run_validation(eval_fn, models, iter(batches), len(batches))
    out["f32_launches"] = _check_counts(cfg, len(batches))
    out["f32_metrics"] = f32
    del models, cpu_models
    torch.backends.cudnn.allow_tf32 = True

    # The main path: `cli test` on the default (bfloat16) config.
    argv = ["test", "--variant", variant, "--iterations", "4",
            "--batch-size", str(BATCH), "--device", "cuda"]
    printed = io.StringIO()
    wk.reset_launches()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(argv)
    launches = _check_counts(cfg, 4)
    by_shape = {f"{k} {list(shape)}": n for (k, shape), n in sorted(wk.LAUNCHES.items())}
    text = printed.getvalue()
    metrics = json.loads(text[text.index("{"):])
    if rc != 0 or not all(map(math.isfinite, metrics.values())):
        raise AssertionError(f"cli test failed: rc {rc}, {metrics}")
    out["main_path"] = {"argv": argv, "launches": launches,
                        "launches_by_shape": by_shape, "metrics": metrics}

    # Its speed on pre-made batches (host data generation excluded).
    params = init_params(cfg, torch.Generator().manual_seed(0))
    models = load_params(build_models(cfg), params, dev)
    eval_fn = loop.make_eval_step(cfg, device=dev)
    loop.run_validation(eval_fn, models, iter(batches[:2]), 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 10
    t0 = time.perf_counter()
    loop.run_validation(eval_fn, models, (batches[i % 4] for i in range(n)), n)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    out["bf16"] = {"ms_per_batch": ms, "frames_per_s": BATCH * 1e3 / ms,
                   "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    return launches


def phase_serve(dev):
    import numpy as np
    import torch

    from depthvo_tpu_torch import DepthVO
    from depthvo_tpu_torch.configs.base import full_feat
    from depthvo_tpu_torch.data.synthetic import SyntheticScenes

    cfg = full_feat(batch_size=BATCH)
    model = DepthVO.from_random(cfg, seed=0)
    batch = SyntheticScenes(cfg, seed=5, num_scenes=BATCH, u8=True).fixed_batch(BATCH)
    images = batch["image_t"]
    pairs = np.concatenate([batch["image_t"], batch["image_s"]], axis=-1)
    out = {"phase": "serve", "config": cfg.name}
    for name, fn, arg, shape in (
        ("depth", model.depth, images, (BATCH, cfg.model.height, cfg.model.width)),
        ("pose", model.pose, pairs, (BATCH, 4, 4)),
    ):
        res = fn(arg)
        if res.shape != shape or not np.isfinite(res).all():
            raise AssertionError(f"{name}: shape {res.shape}, finite {np.isfinite(res).all()}")
        lat = []
        for _ in range(10):
            t0 = time.perf_counter()
            fn(arg)
            lat.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"shape": list(res.shape), "latency_ms_median": statistics.median(lat),
                     "min": float(res.min()), "max": float(res.max())}
    if not np.allclose(model.pose(pairs)[:, 3], [0, 0, 0, 1]):
        raise AssertionError("pose is not a rigid transform")
    out["device"] = str(dev)
    emit(out)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available; it needs a GPU",
              file=sys.stderr)
        return 1
    from depthvo_tpu_torch.configs.base import full_feat

    dev = torch.device("cuda")
    name, smi = phase_device()
    phase_build()
    cfg = full_feat(batch_size=BATCH)
    rows = phase_kernels(_f32_config(cfg), dev)
    launches = phase_slice("full_feat", dev)
    phase_serve(dev)

    summary = []
    for kernel, replaces in (("stereo_fwd", "depthvo_tpu/ops/warp_pallas.py:102"),
                             ("gen_fwd", "depthvo_tpu/ops/warp_pallas.py:523")):
        mine = [r for r in rows if r["kernel"] == kernel]
        summary.append({
            "name": kernel, "route": "cuda",
            "source": "depthvo_tpu_torch/ops/csrc/warp.cu", "replaces": replaces,
            "launches": launches[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            # Per batch of the main path: one launch at each shape.
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in mine) else "operations",
            "library_ms": sum(r["library_ms"] for r in mine),
        })
    print(smi, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
