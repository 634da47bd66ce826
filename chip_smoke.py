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
             and train step give it, on coordinates from a synthetic
             scene's depth map and pose: ``valid`` identical, max abs
             error under ``valid`` (stereo_fwd <= 2e-7, gen_fwd out/S/D
             <= 1e-6), stereo_bwd_u (d_u under ``valid``) and
             stereo_bwd_src (d_src everywhere, driven through the stereo
             autograd.Function with a source that requires grad) <= 1e-6
             on a cotangent that is zero outside ``valid``, as the loss
             makes it; stereo_bwd_src also on the sample columns of
             ``adversarial_stereo_u`` with a cotangent that is nonzero
             everywhere (<= 1e-6, and two launches identical bit for
             bit); gen_bwd_uv (d_u, d_v everywhere, also through the
             general autograd.Function) <= 1e-6; and the device time of
             kernel, plain version and the library yardstick
             (``F.grid_sample``; its backward for the grid or the input
             for K2/K3/gen_bwd_uv; forward plus grid backward for K4 with
             its factors and for the train step's pair gen_fwd +
             gen_bwd_uv), each the median of 25 CUDA-event-timed replays
             of a CUDA graph of 10 launches (host launch overhead
             excluded, L2 warm), beside the byte bound at 3.35 TB/s.
             Then the main path's grouped forwards: one stereo_fwd launch
             over the four stereo segments and one gen_fwd launch over the
             three temporal segments and the fused finest one, each
             segment bit for bit equal to its plain version under
             ``valid``, and one launch of each over ragged segments (H*W
             not a multiple of 4, a one-pixel-wide segment, mixed C) equal
             everywhere; the grouped launch's time beside the four
             one-segment launches and the four library calls timed
             together, and the summed byte bound. Then the main path's
             stereo_bwd_u: the finest segment in a launch of its own and
             the three coarse ones in one launch, all four in one launch,
             the stereo autograd.Function's d_u over the four scales, and
             one launch over ragged segments (C = 1 and 19, H*W not a
             multiple of 4, one pixel wide), each segment bit for bit
             equal to its plain version everywhere; the path's two
             launches timed together and each alone, beside the four
             one-segment launches, the four library grid backwards timed
             together and the summed byte bound.
4. slice   - the held-out loss pass (``make_eval_step`` + ``run_validation``,
             what ``cli test`` runs) on full_feat at 608x160, batch 4:
             float32 with TF32 off against the same pass on the CPU (plain
             versions, same weights, one batch, <= 1e-4 relative per
             metric); 4 batches with exactly 1 stereo_fwd + 1 gen_fwd
             launch per batch; then the main path: ``cli test`` on the
             default (bfloat16) config, launch counts reset just before and
             read just after, and its ms/batch, frames/s and peak memory.
5. train   - the full_feat 608x160 train step: on the card the warps'
             outputs carry a grad_fn and the stereo + temporal terms alone
             send gradient to the finest disparity head and the odometry
             net; one float32 step (TF32 off, batch 2) on the card against
             the CPU's from the same weights and batch: loss terms <= 1e-4
             relative, BatchNorm statistics <= 2e-4 of their largest
             magnitude, gradients <= 1e-3 relative L2 where the CPU's own
             gradient is stable (moves <= 1e-5 under 1e-6 image noise),
             elsewhere, as one vector, <= 4x that spread; then the main
             path: ``cli train`` on the default (bfloat16) config, launch
             counts reset just before and read just after (exactly 1
             stereo_fwd, 2 stereo_bwd_u, 1 gen_fwd, 4 gen_bwd_uv and no
             gen_fwd_aux or stereo_bwd_src per step), finite losses, and
             ms/step, frames/s and peak memory over 12 steady steps on
             pre-made batches.
6. scan    - several train steps per call, the step captured as a CUDA
             graph and replayed (``make_scan_train_step``): (1) float32,
             TF32 off, cuDNN deterministic, batch 2, the train phase's
             weights: 4 steps in one call (1 eager step, its capture, 3
             replays) against 4 eager steps from the same state, with
             iter_size 1 and 2 (both of its graphs), every parameter,
             BatchNorm statistic, solver tensor and the last metrics
             compared (measured bit for bit; held to METRIC_RTOL,
             STATS_RTOL and GRAD_RTOL on the parameters' change and the
             solver's tensors), and the launches of the call (replays
             counted); (2) the default (bfloat16) config at batch 4 on
             pre-made batches already on the card: eager steps and graph
             K=8, five calls of 8 steps each, ms/step untraced (median of
             the calls after the first), the peak allocated bytes of the
             first call and of the rest, the bytes of the graph's private
             pool, and one traced call each: every warp kernel K x the
             train phase's launches per step in the profiler's trace and
             in the counters, kernels per step, device busy ms per step
             and share of the traced wall; (3) ``cli train --kitti-root
             ... --native-ring 1 --steps-per-call 8`` on phase
             kitti_ckpt's tree (written anew): 17 steps (1 eager step and
             7 replays, 8 replays, an exact tail of 1) with the train
             phase's launches per step and logs at steps 7 and 16; the
             ms/step after the first call, also over 65 steps, beside the
             host ring's ms per batch.
7. kitti_ckpt - the training path users run, in a temporary directory: a
             KITTI raw drive (9 frames per camera at 1242x375, PNGs written
             with zlib, calib with P_rect_02/03 and S_rect_02); ``cli train
             --kitti-root ... --native-ring 1 --checkpoint-dir C`` for 2
             steps through the native decode ring and the pinned-buffer
             prefetch (the main path: counts reset just before and read
             just after, the train phase's launches per step; one step
             directory and config.json); the same command with 4 steps
             resumes at step 2 and logs steps 2 and 3 only, and the batches
             its step receives equal the host's; a checkpoint saved on the
             card and restored into a fresh state is equal bit for bit
             (every parameter, BatchNorm buffer and solver tensor, and the
             step); ``temporal_stereo --init-from C`` starts from C's depth
             and odometry weights; ``cli test --checkpoint-dir C`` prints
             finite terms; ``DepthVO.from_checkpoint(C)`` depth card vs CPU
             (float32, TF32 off) <= 1e-4 relative. Recorded, not claimed:
             ms/step from disk beside the train phase's pre-made batches,
             the same over 13 steady steps of a 14-step run, the host
             ring's ms per batch, the checkpoint's bytes and its
             save and restore ms, beside the card's name and power limit.
8. eval    - the eval runner and the rest of DepthNet, in a temporary
             directory: a KITTI raw drive of 70 frames at 1242x375 with
             velodyne scans (4000 points each, 5-75 m) and both
             calibration files; ``cli prep-eigen`` writes the ground truth
             and the list; ``cli eval-depth`` (batch 16: 4 batches
             and a padded tail of 6) on a float32 checkpoint of
             ``DepthVO.from_random(seed=0)``'s weights, TF32 off, on the
             card (the eval path's own main path: counts reset just
             before and read just after, no warp kernel launched) against
             the CPU: abs_rel/sq_rel/rmse/rmse_log <= 1e-4 relative,
             a1..a3 within one pixel per frame (1/n_valid averaged); the
             ``split`` provenance block; ``--pred-path`` on its
             ``--save-preds`` output gives the same table with no model.
             Recorded on the default (bfloat16) config:
             ``run_depth_eval``'s frames/s, the sweep's frames/s, peak
             allocated bytes and traced device busy share, and the host's
             decode, resize and metrics seconds. ``cli eval-odom`` on a
             24-frame odometry sequence at 1241x376: float32
             translations card vs CPU <= 1e-4 relative, the pose file
             scored alone (``--pose-file``) gives the same scores;
             frames/s of the bfloat16 trajectory. ``cli infer`` on 20
             PNGs: the ``*_depth.npy`` files equal ``DepthVO.depth`` of
             the same padded batches; its frames/s. The subpixel and
             fast-final heads: float32 depth card vs CPU <= 1e-4 relative;
             ``cli train --config`` of 2 steps with each head: finite
             losses and the train phase's launches per step. ``remat``
             against the standard step (float32, TF32 off, cuDNN
             deterministic, batch 2), one eager step and one
             ``make_scan_train_step`` call of K=2: every parameter,
             BatchNorm statistic, solver tensor and metric bit for bit;
             the bfloat16 batch-4 train step's peak allocated bytes with
             and without ``remat``.
9. int8_serving - w8a8 serving and the serving export (A.6) at 608x160:
             (1) the int8 convolution (``ops/int8_conv.py``: an int8
             im2col and ``torch._int_mm``, cuBLASLt's int8 GEMM; a library
             call, not a TPU kernel) at every distinct quantized conv shape
             of the depth net at batch 16 against its float64 plain version
             bit for bit in int32, with the device time of both beside
             cuDNN's bfloat16 convolution of the shape and the bound (int8
             operands and the int32 output once at 3.35 TB/s, 2*M*N*K at
             1979 int8 TOP/s); (2) the int8 and the bfloat16 depth sweep
             (``predict_depths``, 128 frames, batch 16) in turns: frames/s,
             the int8 sweep's ``_int_mm`` calls, peak allocated bytes and
             traced device busy share, ``uncalibrate`` / ``set_quant`` giving
             back the same depth bit for bit; (3) float32 (TF32 off)
             calibration card vs CPU: every ``a_max`` <= 2e-5 relative, the
             int8 depth with the CPU's scales on the card <= 1e-5 relative
             (the int8 path is the same bits on both devices; the float
             disparity heads are not) and within the reference's int8 bar
             (rtol 2e-3 / atol 2e-3), with each device's own scales
             recorded; (4) ``export_depth`` of a float32 and an int8 model on
             the card, each loaded on the card and checked on the CPU and
             the card at export: batches 1, 4 and 16 through one symbolic
             artifact against ``DepthVO.depth`` (<= 1e-5 relative float32,
             the int8 bar int8), bytes, export and load seconds, batch-16
             latency; an artifact exported on the CPU served on the card
             (<= 1e-5); (5) ``cli eval-depth --int8`` (quant and split.int8
             declared, ``_int_mm`` called) and ``cli infer --int8`` (its
             files equal the API calibrated on the same frames) on phase
             eval's tree, which this phase then deletes.
10. caffe  - the Caffe weight tools (A.7) at 608x160: ``export-caffemodel``
             of each net of a checkpoint, ``import-caffemodel`` of the depth
             file into a fresh checkpoint (every depth tensor equal, and
             ``DepthVO.depth`` on the card bit for bit, float32, TF32 off);
             ``net-info`` of a train graph and ``convert`` (solver + graph +
             the three files) exit 0, with finite depth from the converted
             checkpoint.
11. serve  - ``DepthVO.from_random(full_feat())``: depth of a (4,160,608,3)
             uint8 batch and pose of its frame pairs; shapes, finiteness
             and latency.

The last three lines are the nvidia-smi line, the ``{"kernels": [...]}``
summary (launches per step of the main path, ``cli train``; for
stereo_fwd and gen_fwd the grouped launch's times, for stereo_bwd_u the
path's two launches) and
``{"ok": true, "device": {...}}``. Without a GPU the script
exits with code 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BATCH = 4
K1_TOL = 2e-7
K2_TOL = 1e-6
K3_TOL = 1e-6
K4_TOL = 1e-6
K5_TOL = 1e-6
METRIC_RTOL = 1e-4
GRAD_RTOL = 1e-3
STATS_RTOL = 2e-4


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


def adversarial_stereo_u(rng, B: int, h: int, w: int, dmax: int):
    """Sample columns (B, h, w) float32 that stress stereo_bwd_src, from a
    numpy Generator: per-pixel disparities in [-4, dmax + 8] (not
    monotone; some negative, some beyond the bound, whose taps drop),
    columns sampled left of 0 and right of w - 1, integer u on every 7th
    column, and in every row a run of 16 to 24 outputs sharing one u0."""
    import numpy as np

    cols = np.arange(w, dtype=np.float64)
    u = cols - rng.uniform(-4.0, dmax + 8.0, (B, h, w))
    u[:, 0::3, 1::11] = -rng.uniform(0.5, 20.0, u[:, 0::3, 1::11].shape)
    u[:, 1::3, 2::11] = (w - 1) + rng.uniform(0.5, 20.0, u[:, 1::3, 2::11].shape)
    u[:, :, ::7] = np.round(u[:, :, ::7])
    for b, i in np.ndindex(B, h):
        n = min(w, int(rng.integers(16, 25)))
        j0 = int(rng.integers(0, w - n + 1))
        frac = rng.uniform(0.0, 0.99, n)
        frac[np.arange(j0, j0 + n) % 7 == 0] = 0.0
        u[b, i, j0:j0 + n] = np.clip(np.floor(u[b, i, j0]), 0, w - 2) + frac
    return u.astype(np.float32)


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
    ptxas = {}
    for path in libs.values():
        log = path.with_name(path.name + ".log")
        name = None
        for ln in log.read_text().splitlines() if log.exists() else ():
            entry = re.search(r"Compiling entry function '(\w+)'", ln)
            if entry:
                mangled = entry.group(1)
                name = re.search(r"\d+([a-z_]+_kernel)", mangled).group(1)
                name += {"ILb1E": "<true>", "ILb0E": "<false>"}.get(
                    next((t for t in ("ILb1E", "ILb0E") if t in mangled), ""), "")
            elif name and ("registers" in ln or "spill" in ln):
                ptxas[name] = (ptxas.get(name, "") + " " + ln.split(":", 1)[-1].strip()).strip()
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
    pyramid = {"stereo_fwd": [], "gen_fwd": []}  # per scale: (src, u[, v], valid, grid)

    def chw(x, h, w):
        x = x.permute(0, 3, 1, 2).contiguous()
        return x if (h, w) == (H, W) else resize_bilinear_chw(x, h, w).contiguous()

    def grid_of(u, v, h, w):
        return torch.stack([u / (w - 1) * 2 - 1, v / (h - 1) * 2 - 1], dim=-1)

    def lib_sample(src, grid):
        return F.grid_sample(src, grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    def lib_sample_bwd(g, src, grid, mask):
        """grid_sample's backward (bilinear, border, align_corners) for the
        input (mask (True, False)) or the grid ((False, True))."""
        return torch.ops.aten.grid_sampler_2d_backward(g, src, grid, 0, 1, True, list(mask))

    for h, w in scale_shapes(cfg):
        depth = scene["depth"][:, None]
        depth = (depth if (h, w) == (H, W) else resize_bilinear_chw(depth, h, w))[:, 0].contiguous()
        Ks = scale_intrinsics(K, w / W, h / H)

        # K1: the stereo warp of the right view, C=3.
        src = chw(scene["image_r"], h, w)
        dmax = stereo_dmax(cfg, w)
        disp, u = wk.stereo_disparity_u(depth, Ks[..., 0, 0] * cfg.stereo_baseline, w)
        u = u.contiguous()
        warped, valid = ops.stereo_warp_chw(src, depth, Ks[..., 0, 0] * cfg.stereo_baseline, dmax)
        valid_ref = wk.stereo_valid_mask(depth, disp, u, h, w, dmax)
        if not torch.equal(valid, valid_ref):
            raise AssertionError(f"stereo valid differs at {(h, w)}")
        plain = wk.stereo_sample_plain(src, u)
        err = masked_max_err(warped, plain, valid)
        if not err <= K1_TOL:
            raise AssertionError(f"stereo_fwd at {(h, w)}: max err {err} > {K1_TOL}")
        rowsv = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None].expand_as(u)
        grid = grid_of(u.clamp(0, w - 1), rowsv, h, w)
        pyramid["stereo_fwd"].append((src, u, valid, grid))
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

        # K2 and K3 on a cotangent that is zero outside `valid`, as the
        # loss makes it. K3 is driven through the stereo autograd.Function
        # with a source that requires grad (u does not, so K2 stays out).
        g = torch.randn(src.shape, device=dev, generator=gen) * valid[:, None]
        d_u = wk.stereo_bwd_u_cuda(src, g, u)
        err_u = float(torch.abs(d_u - wk.stereo_bwd_u_plain(src, g, u))[valid].max())
        src_req = src.clone().requires_grad_(True)
        wk.stereo_sample_grouped([src_req], [u], [dmax])[0]().backward(g)
        err_src = float(torch.abs(src_req.grad - wk.stereo_bwd_src_plain(g, u, dmax)).max())
        if not (err_u <= K2_TOL and err_src <= K3_TOL):
            raise AssertionError(f"stereo backward at {(h, w)}: d_u err {err_u} > {K2_TOL} "
                                 f"or d_src err {err_src} > {K3_TOL}")
        if not float(src_req.grad.abs().max()) > 0:
            raise AssertionError(f"stereo_bwd_src at {(h, w)} produced no gradient")
        # K3 on adversarial sample columns with a cotangent that is nonzero
        # everywhere: dropped taps, large buckets, integer and clipped u.
        u_adv = torch.as_tensor(adversarial_stereo_u(np.random.default_rng(h), BATCH, h, w,
                                                     dmax), device=dev)
        g_adv = torch.randn(src.shape, device=dev, generator=gen)
        d_adv = wk.stereo_bwd_src_cuda(g_adv, u_adv, dmax)
        err_adv = float(torch.abs(d_adv - wk.stereo_bwd_src_plain(g_adv, u_adv, dmax)).max())
        if not (err_adv <= K3_TOL and torch.equal(d_adv, wk.stereo_bwd_src_cuda(g_adv, u_adv, dmax))):
            raise AssertionError(f"stereo_bwd_src at {(h, w)} on adversarial u: max err "
                                 f"{err_adv} > {K3_TOL}, or two launches differ")
        nbytes = 4 * (2 * src.numel() + 2 * u.numel())
        b_ms, b_by = bound_ms(nbytes, 3 * src.numel())
        rows.append({
            "kernel": "stereo_bwd_u", "shape": list(src.shape), "dmax": dmax,
            "max_abs_err": err_u,
            "ms": device_ms(lambda: wk.stereo_bwd_u_cuda(src, g, u)),
            "plain_ms": device_ms(lambda: wk.stereo_bwd_u_plain(src, g, u)),
            "library_ms": device_ms(lambda: lib_sample_bwd(g, src, grid, (False, True))),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
        })
        nbytes = 4 * (2 * g.numel() + u.numel())
        b_ms, b_by = bound_ms(nbytes, 4 * g.numel())
        rows.append({
            "kernel": "stereo_bwd_src", "shape": list(src.shape), "dmax": dmax,
            "max_abs_err": max(err_src, err_adv), "adversarial_max_abs_err": err_adv,
            "adversarial_ms": device_ms(lambda: wk.stereo_bwd_src_cuda(g_adv, u_adv, dmax)),
            "ms": device_ms(lambda: wk.stereo_bwd_src_cuda(g, u, dmax)),
            "plain_ms": device_ms(lambda: wk.stereo_bwd_src_plain(g, u, dmax)),
            "library_ms": device_ms(lambda: lib_sample_bwd(g, src, grid, (True, False))),
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
        pyramid["gen_fwd"].append((src, u, v, valid, grid))
        # gen_bwd_uv: d_u and d_v are defined on every pixel (u and v are
        # clipped), so it is held everywhere on a dense cotangent, and
        # through the general autograd.Function.
        g_all = torch.randn(src.shape, device=dev, generator=gen)
        plain_uv = wk.gen_bwd_uv_plain(src, g_all, u, v)
        u_req, v_req = u.clone().requires_grad_(True), v.clone().requires_grad_(True)
        wk.frozen_gen_sample_grouped([src], [u_req], [v_req])[0]().backward(g_all)
        err_bwd = max(float(torch.abs(a - b).max()) for a, b in
                      zip((*wk.gen_bwd_uv_cuda(src, g_all, u, v), u_req.grad, v_req.grad),
                          plain_uv * 2))
        if not err_bwd <= K5_TOL:
            raise AssertionError(f"gen_bwd_uv at {(h, w)}: max err {err_bwd} > {K5_TOL}")
        g = torch.randn(src.shape, device=dev, generator=gen) * valid[:, None]
        for aux in (False, True):
            nbytes = 4 * ((3 if aux else 1) * src.numel() + src.numel() + 2 * u.numel())
            b_ms, b_by = bound_ms(nbytes, (17 if aux else 9) * src.numel())
            row = {
                "kernel": "gen_fwd_aux" if aux else "gen_fwd",
                "shape": list(src.shape), "pad_v": pad_v,
                "valid_frac": float(valid.float().mean()),
                "max_abs_err": max(errs[:3]) if aux else max(errs[0], errs[3]),
                "ms": device_ms(lambda: wk.gen_sample_cuda(src, u, v, aux)),
                "plain_ms": device_ms(lambda: wk.gen_sample_plain(src, u, v, aux)),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            }
            if aux:
                row["library_ms"] = device_ms(
                    lambda: (lib_sample(src, grid), lib_sample_bwd(g, src, grid, (False, True))))
            else:
                row["library_ms"] = device_ms(lambda: lib_sample(src, grid))
            rows.append(row)
        nbytes = 4 * (2 * src.numel() + 4 * u.numel())
        b_ms, b_by = bound_ms(nbytes, 19 * src.numel())
        pair_bytes = nbytes + 4 * (2 * src.numel() + 2 * u.numel())
        rows.append({
            "kernel": "gen_bwd_uv", "shape": list(src.shape), "pad_v": pad_v,
            "max_abs_err": err_bwd,
            "ms": device_ms(lambda: wk.gen_bwd_uv_cuda(src, g, u, v)),
            "plain_ms": device_ms(lambda: wk.gen_bwd_uv_plain(src, g, u, v)),
            "library_ms": device_ms(lambda: lib_sample_bwd(g, src, grid, (False, True))),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            # The train step's general warp: gen_fwd + gen_bwd_uv against
            # grid_sample forward plus its grid backward.
            "pair_ms": device_ms(lambda: (wk.gen_sample_cuda(src, u, v),
                                          wk.gen_bwd_uv_cuda(src, g, u, v))),
            "pair_library_ms": device_ms(
                lambda: (lib_sample(src, grid), lib_sample_bwd(g, src, grid, (False, True)))),
            "pair_bound_ms": bound_ms(pair_bytes, 28 * src.numel())[0],
        })

    # The main path's grouped forwards: one launch over the pyramid, each
    # segment bit for bit equal to its plain version under `valid`; then
    # one launch over ragged segments (H*W % 4 = 2, 1 and 1, one pixel
    # wide, mixed C), equal everywhere.
    ragged = [(3, 37, 150), (19, 19, 75), (3, 9, 1)]
    r_srcs = [torch.randn(BATCH, c, h, w, device=dev, generator=gen) for c, h, w in ragged]
    r_cols = [torch.arange(w, device=dev, dtype=torch.float32) for _, _, w in ragged]
    r_us = [(cols - 12 * torch.rand(BATCH, h, w, device=dev, generator=gen) + 2).contiguous()
            for cols, (_, h, w) in zip(r_cols, ragged)]
    r_vs = [((h - 1) * (1.2 * torch.rand(BATCH, h, w, device=dev, generator=gen) - 0.1))
            .contiguous() for _, h, w in ragged]
    for kernel, segs in pyramid.items():
        stereo = kernel == "stereo_fwd"
        srcs = [s[0] for s in segs]
        maps = [[s[1] for s in segs]] + ([] if stereo else [[s[2] for s in segs]])
        r_maps = [r_us] + ([] if stereo else [r_vs])
        launch = wk.stereo_sample_pyramid_cuda if stereo else wk.gen_sample_pyramid_cuda
        one = wk.stereo_sample_cuda if stereo else wk.gen_sample_cuda
        plain = wk.stereo_sample_plain if stereo else wk.gen_sample_plain
        outs = launch(srcs, *maps)
        err = max(masked_max_err(o, plain(s, *m), seg[-2])
                  for o, s, seg, *m in zip(outs, srcs, segs, *maps))
        r_outs = launch(r_srcs, *r_maps)
        err_r = max(float(torch.abs(o - plain(s, *m)).max())
                    for o, s, *m in zip(r_outs, r_srcs, *r_maps))
        if not (err == 0.0 and err_r == 0.0):
            raise AssertionError(f"grouped {kernel}: max err {err} on the pyramid, {err_r} "
                                 "on the ragged segments; the kernel is bit-exact")
        per_value = 4 if stereo else 9
        nbytes = sum(4 * (2 * s.numel() + len(maps) * s[:, 0].numel()) for s in srcs)
        b_ms, b_by = bound_ms(nbytes, sum(per_value * s.numel() for s in srcs))
        # What this card's memory reaches in practice: one copy that reads
        # and writes as many bytes as the kernel must move.
        copy_src = torch.empty(nbytes // 8, device=dev)
        copy_dst = torch.empty_like(copy_src)
        rows.append({
            "kernel": kernel, "pyramid": True, "shapes": [list(s.shape) for s in srcs],
            "ragged_shapes": [list(s.shape) for s in r_srcs],
            "max_abs_err": err, "ragged_max_abs_err": err_r,
            "ms": device_ms(lambda: launch(srcs, *maps)),
            "per_scale_ms": device_ms(lambda: [one(s, *m) for s, *m in zip(srcs, *maps)]),
            "plain_ms": device_ms(lambda: [plain(s, *m) for s, *m in zip(srcs, *maps)]),
            "library_ms": device_ms(
                lambda: [lib_sample(s, seg[-1]) for s, seg in zip(srcs, segs)]),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "copy_ms": device_ms(lambda: copy_dst.copy_(copy_src)),
        })

    # The main path's stereo_bwd_u: the finest segment alone and the coarse
    # ones in one launch, as the stereo autograd.Function runs them, on a
    # cotangent that is zero outside `valid`; each segment bit for bit
    # equal to its plain version everywhere, also all four in one launch,
    # through the Function, and over ragged segments (C = 1 and 19).
    segs = pyramid["stereo_fwd"]
    srcs, us, grids = [s[0] for s in segs], [s[1] for s in segs], [s[3] for s in segs]
    gs = [torch.randn(s.shape, device=dev, generator=gen) * seg[2][:, None]
          for s, seg in zip(srcs, segs)]

    def bwd_u_path():
        return (wk.stereo_bwd_u_grouped_cuda(srcs[:-1], gs[:-1], us[:-1])
                + wk.stereo_bwd_u_grouped_cuda(srcs[-1:], gs[-1:], us[-1:]))

    def max_err(got, ref):
        return max(float(torch.abs(a - b).max()) for a, b in zip(got, ref))

    plain_us = [wk.stereo_bwd_u_plain(s, g, u) for s, g, u in zip(srcs, gs, us)]
    u_reqs = [u.clone().requires_grad_(True) for u in us]
    outs = [make() for make in wk.stereo_sample_grouped(
        srcs, u_reqs, [stereo_dmax(cfg, s.shape[-1]) for s in srcs])]
    torch.autograd.backward(outs, gs)
    errs = {"path": max_err(bwd_u_path(), plain_us),
            "all_in_one": max_err(wk.stereo_bwd_u_grouped_cuda(srcs, gs, us), plain_us),
            "function": max_err([u.grad for u in u_reqs], plain_us)}
    r_srcs = [torch.randn(BATCH, c, h, w, device=dev, generator=gen)
              for c, (_, h, w) in zip((1, 19, 3), ragged)]
    r_gs = [torch.randn(s.shape, device=dev, generator=gen) for s in r_srcs]
    errs["ragged"] = max_err(wk.stereo_bwd_u_grouped_cuda(r_srcs, r_gs, r_us),
                             [wk.stereo_bwd_u_plain(*a) for a in zip(r_srcs, r_gs, r_us)])
    if any(errs.values()):
        raise AssertionError(f"grouped stereo_bwd_u: max errs {errs}; the kernel is bit-exact")

    def bound_of(ss):
        return bound_ms(sum(4 * (2 * s.numel() + 2 * s[:, 0].numel()) for s in ss),
                        sum(3 * s.numel() for s in ss))

    b_ms, b_by = bound_of(srcs)
    rows.append({
        "kernel": "stereo_bwd_u", "pyramid": True, "shapes": [list(s.shape) for s in srcs],
        "ragged_shapes": [list(s.shape) for s in r_srcs],
        "max_abs_err": max(errs.values()), "errs": errs,
        "ms": device_ms(bwd_u_path),
        "finest_ms": device_ms(lambda: wk.stereo_bwd_u_grouped_cuda(srcs[-1:], gs[-1:], us[-1:])),
        "coarse_ms": device_ms(lambda: wk.stereo_bwd_u_grouped_cuda(srcs[:-1], gs[:-1], us[:-1])),
        "all_in_one_ms": device_ms(lambda: wk.stereo_bwd_u_grouped_cuda(srcs, gs, us)),
        "per_scale_ms": device_ms(lambda: [wk.stereo_bwd_u_cuda(*a) for a in zip(srcs, gs, us)]),
        "plain_ms": device_ms(lambda: [wk.stereo_bwd_u_plain(*a) for a in zip(srcs, gs, us)]),
        "library_ms": device_ms(lambda: [lib_sample_bwd(g, s, grid, (False, True))
                                         for g, s, grid in zip(gs, srcs, grids)]),
        "bound_ms": b_ms, "bound_by": b_by,
        "finest_bound_ms": bound_of(srcs[-1:])[0], "coarse_bound_ms": bound_of(srcs[:-1])[0],
    })
    emit({"phase": "kernels", "shapes": rows})
    return rows


def _f32_config(cfg):
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32")
    )


KERNELS = ("stereo_fwd", "stereo_bwd_u", "stereo_bwd_src", "gen_fwd", "gen_fwd_aux",
           "gen_bwd_uv")


def _check_counts(per_call: dict, n_calls: int) -> dict:
    """Launches since the last reset: ``per_call[k]`` of kernel k per
    batch or step, none of the others."""
    from depthvo_tpu_torch.ops import warp_kernels as wk

    counts = {k: wk.launch_count(k) for k in KERNELS}
    want = {k: per_call.get(k, 0) * n_calls for k in KERNELS}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    return counts


def _eval_launches(cfg) -> dict:
    """One grouped forward per kernel over the whole pyramid."""
    return {"stereo_fwd": 1, "gen_fwd": 1}


def _train_launches(cfg) -> dict:
    """The grouped forwards; then one gen_bwd_uv launch per scale, and one
    stereo_bwd_u launch for the finest scale and one for the coarse ones."""
    n = cfg.model.num_scales
    return {"stereo_fwd": 1, "stereo_bwd_u": min(n, 2), "gen_fwd": 1, "gen_bwd_uv": n}


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
    out["f32_launches"] = _check_counts(_eval_launches(cfg), len(batches))
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
    launches = _check_counts(_eval_launches(cfg), 4)
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


def _float_batch(batch, noise_seed=None):
    """uint8 images -> float32 [-1, 1] (the loaders' formula), optionally
    plus N(0, 1e-6) noise (to measure a step's own float32 spread)."""
    import numpy as np

    rng = None if noise_seed is None else np.random.default_rng(noise_seed)
    out = {}
    for k, v in batch.items():
        if v.dtype == np.uint8:
            v = v.astype(np.float32) / 127.5 - 1.0
            if rng is not None:
                v = (v + 1e-6 * rng.normal(size=v.shape)).astype(np.float32)
        out[k] = v
    return out


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def phase_train(variant: str, dev):
    """The train step: its gradients reach the nets through the warps on
    the card; one float32 step on the card against the same step on the
    CPU; then the main path, ``cli train`` on the default (bfloat16)
    config, and its speed."""
    import torch

    from depthvo_tpu_torch import cli, configs, ops
    from depthvo_tpu_torch.configs.base import stereo_dmax
    from depthvo_tpu_torch.data.synthetic import SyntheticScenes
    from depthvo_tpu_torch.geometry import se3
    from depthvo_tpu_torch.ops import warp_kernels as wk
    from depthvo_tpu_torch.train import loop
    from depthvo_tpu_torch.train.state import (
        TrainState, build_models, create_state, init_params, load_params,
        make_optimizer, param_tree,
    )

    cfg = getattr(configs, variant)(batch_size=BATCH)
    out = {"phase": "train", "config": variant, "hw": [cfg.model.height, cfg.model.width]}

    # float32, TF32 off, batch 2. The odometry net's last bias gives the
    # random net a real motion (0.3 m forward): with the near-zero twist of
    # random weights every temporal sample sits within ~1e-4 px of a pixel
    # centre, where the bilinear gradient jumps between one-sided slopes.
    cfg32 = _f32_config(getattr(configs, variant)(batch_size=2))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    params = init_params(cfg32, torch.Generator().manual_seed(0))
    params["odom"]["Dense_2.bias"] = torch.tensor([2.0, -1.0, -30.0, 0.2, -0.3, 0.1])
    host = SyntheticScenes(cfg32, seed=cfg32.seed, u8=True, num_scenes=2).fixed_batch(2)

    # (1) The warps' outputs carry a grad_fn on the card, and the stereo
    # and temporal terms alone send gradient to the finest disparity head
    # and to the odometry net.
    models = load_params(build_models(cfg32), params, dev).train()
    batch = loop.batch_to_device(_float_batch(host), dev)
    _, metrics = loop.compute_losses(cfg32, models, batch, train=True)
    (metrics["loss/stereo"] + metrics["loss/temporal"]).backward()
    head = getattr(models.depth, f"Conv_{cfg32.model.num_scales - 1}").weight.grad
    odom = [p.grad for p in models.odom.parameters()]
    if head is None or not float(head.abs().max()) > 0 or not all(
            g is not None and float(g.abs().max()) > 0 for g in odom):
        raise AssertionError("no gradient from the stereo/temporal terms to the nets")
    depth = torch.full((2, 40, 152), 10.0, device=dev, requires_grad=True)
    img = torch.rand(2, 3, 40, 152, device=dev)
    K = torch.as_tensor(host["K"], device=dev)
    fxb = K[:, 0, 0] * cfg32.stereo_baseline / 4
    dmax = stereo_dmax(cfg32, 152)
    T = se3.exp(torch.tensor([[0.02, 0.0, -0.3, 0.0, 0.01, 0.0]] * 2, device=dev,
                             requires_grad=True))
    warped = [ops.stereo_warp_chw(img, depth, fxb, dmax=dmax)[0],
              ops.frozen_warp_chw(img, depth, T, K, pad_v=cfg32.warp_pad_v)[0]]
    if any(w.grad_fn is None for w in warped):
        raise AssertionError("a warp's output on the card carries no grad_fn")
    out["grad_fn"] = {name: type(w.grad_fn).__name__ for name, w in
                      zip(("stereo", "general"), warped)}
    out["grad_fn"] |= {"finest_head_grad_max": float(head.abs().max()),
                       "odom_grad_min_max": min(float(g.abs().max()) for g in odom)}
    del models, metrics, head, odom

    # (2) One step on the card against the same step on the CPU.
    def one_step(device, b):
        models = load_params(build_models(cfg32), params, device)
        state = TrainState(0, models, make_optimizer(cfg32).init(param_tree(models)))
        state, metrics = loop.make_train_step(cfg32, device)(state, b)
        grads = {k: p.grad.detach().cpu() for k, p in param_tree(models).items()
                 if p.grad is not None}
        stats = {k: v.detach().cpu() for k, v in models.depth.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        return {k: float(v) for k, v in metrics.items()}, grads, stats

    t0 = time.perf_counter()
    gpu_m, gpu_g, gpu_s = one_step(dev, _float_batch(host))
    cpu_m, cpu_g, cpu_s = one_step(torch.device("cpu"), _float_batch(host))
    _, own_g, _ = one_step(torch.device("cpu"), _float_batch(host, noise_seed=1))
    out["card_vs_cpu_seconds"] = time.perf_counter() - t0
    rel_m = {k: abs(gpu_m[k] - cpu_m[k]) / max(abs(cpu_m[k]), 1e-30) for k in cpu_m
             if k != "grad/global_norm"}
    if set(gpu_m) != set(cpu_m) or not max(rel_m.values()) <= METRIC_RTOL:
        raise AssertionError(f"train step card vs CPU metrics: {gpu_m} vs {cpu_m}")
    if set(gpu_g) != set(cpu_g) or any(k.startswith("feat.") for k in gpu_g):
        raise AssertionError("card and CPU differ in which parameters got a gradient")
    stable, unstable = {}, []
    for k in cpu_g:
        if _rel(own_g[k], cpu_g[k]) <= 1e-5:
            stable[k] = _rel(gpu_g[k], cpu_g[k])
        else:
            unstable.append(k)
    if not stable or not max(stable.values()) <= GRAD_RTOL:
        raise AssertionError(f"stable gradients card vs CPU: max {max(stable.values())}")
    flat = lambda g, keys: torch.cat([g[k].flatten() for k in keys])  # noqa: E731
    spread = _rel(flat(own_g, unstable), flat(cpu_g, unstable)) if unstable else 0.0
    err_u = _rel(flat(gpu_g, unstable), flat(cpu_g, unstable)) if unstable else 0.0
    if not err_u <= max(GRAD_RTOL, 4 * spread):
        raise AssertionError(f"unstable gradients card vs CPU: {err_u} > 4 x {spread}")
    norm_rel = abs(gpu_m["grad/global_norm"] - cpu_m["grad/global_norm"]) / cpu_m["grad/global_norm"]
    if not norm_rel <= max(GRAD_RTOL, 4 * spread):
        raise AssertionError(f"grad/global_norm card vs CPU: {norm_rel}")
    stat_err = max(float((gpu_s[k] - cpu_s[k]).abs().max() / cpu_s[k].abs().max())
                   for k in cpu_s)
    if not stat_err <= STATS_RTOL:
        raise AssertionError(f"BatchNorm statistics card vs CPU: {stat_err}")
    worst = max(stable, key=stable.get)
    out["f32_card_vs_cpu"] = {
        "batch": 2, "metrics_max_rel": max(rel_m.values()), "global_norm_rel": norm_rel,
        "stable_leaves": len(stable), "stable_max_rel": stable[worst], "stable_worst": worst,
        "unstable_leaves": len(unstable), "unstable_rel": err_u, "cpu_own_spread": spread,
        "bn_stats_max_rel": stat_err, "metrics": gpu_m,
    }
    torch.backends.cudnn.allow_tf32 = True

    # (3) The main path: `cli train` on the default (bfloat16) config.
    steps = 3
    argv = ["train", "--variant", variant, "--steps", str(steps), "--batch-size", str(BATCH),
            "--device", "cuda", "--log-every", "1"]
    printed = io.StringIO()
    wk.reset_launches()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(argv)
    launches = _check_counts(_train_launches(cfg), steps)
    lines = [ln for ln in printed.getvalue().splitlines() if ln.startswith("step ")]
    logged = [dict(kv.split("=") for kv in ln.split(": ", 1)[1].split()) for ln in lines]
    if rc != 0 or len(logged) != steps or not all(
            math.isfinite(float(v)) for m in logged for v in m.values()):
        raise AssertionError(f"cli train failed: rc {rc}, {lines}")
    out["main_path"] = {
        "argv": argv, "launches": launches,
        "launches_by_shape": {f"{k} {list(shape)}": n
                              for (k, shape), n in sorted(wk.LAUNCHES.items())},
        "losses": [{k: float(m[k]) for k in m if k.startswith(("loss/", "grad/"))}
                   for m in logged],
    }

    # (4) Its speed on pre-made batches (host data generation excluded).
    scenes = SyntheticScenes(cfg, seed=cfg.seed, u8=True)
    batches = [scenes.batch(BATCH) for _ in range(4)]
    state = create_state(cfg, dev)
    step_fn = loop.make_train_step(cfg, dev)
    for i in range(3):
        step_fn(state, batches[i % 4])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 12
    t0 = time.perf_counter()
    for i in range(n):
        _, metrics = step_fn(state, batches[i % 4])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    if not math.isfinite(float(metrics["loss/total"])):
        raise AssertionError("non-finite loss in the timed steps")
    out["bf16"] = {"ms_per_step": ms, "frames_per_s": BATCH * 1e3 / ms, "steps": n,
                   "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    return launches, ms


WARP_KERNEL_NAMES = {  # the kernels' names in a profiler trace
    "stereo_fwd": "stereo_fwd_pyramid_kernel",
    "stereo_bwd_u": "stereo_bwd_u_pyramid_kernel",
    "stereo_bwd_src": "stereo_bwd_src_kernel",
    "gen_fwd": "gen_fwd_pyramid_kernel<false>",
    "gen_fwd_aux": "gen_fwd_pyramid_kernel<true>",
    "gen_bwd_uv": "gen_bwd_uv_kernel",
}
SCAN_K = 8


def _state_leaves(state) -> dict:
    """Every tensor of a train state by name: parameters, BatchNorm
    statistics and the solver's tensors."""
    from depthvo_tpu_torch.train.state import Models

    out = {f"{n}.{k}": v for n, net in zip(Models._fields, state.models) if net is not None
           for k, v in net.state_dict().items() if v.is_floating_point()}

    def walk(tree, path):
        if hasattr(tree, "shape"):
            out[path] = tree
        elif isinstance(tree, (tuple, list)):
            for i, t in enumerate(tree):
                walk(t, f"{path}[{i}]")

    walk(state.opt_state, "opt_state")
    return out


def _traced_call(run, steps: int) -> dict:
    """One ``run()`` of ``steps`` train steps under torch.profiler: the
    warp kernels by name, all kernels, and the device's busy share of the
    traced wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from depthvo_tpu_torch.utils.profiling import _busy_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    return {
        "warp_kernels": {k: sum(name in e.name for e in kernels)
                         for k, name in WARP_KERNEL_NAMES.items()},
        "kernels_per_step": len(kernels) / steps,
        "device_busy_ms_per_step": busy / steps / 1e3,
        "traced_wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_share": busy / wall_us,
    }


def _private_pool_bytes() -> int:
    """Bytes the caching allocator holds in private pools (a CUDA graph's):
    reserved for the graph's whole life, whether its tensors are live."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def _graph_vs_eager(cfg32, params, host, dev) -> dict:
    """len(host) steps in one ``make_scan_train_step`` call (1 eager step,
    its capture, replays) against as many eager steps from the same
    weights: every tensor of the two states, the last metrics and the
    call's launches (its state is freed on return)."""
    import torch

    from depthvo_tpu_torch.ops import warp_kernels as wk
    from depthvo_tpu_torch.train import loop
    from depthvo_tpu_torch.train.state import TrainState, build_models, load_params, \
        make_optimizer, param_tree

    def fresh():
        models = load_params(build_models(cfg32), params, dev).train()
        return TrainState(0, models, make_optimizer(cfg32).init(param_tree(models)))

    wk.reset_launches()
    graphed, g_metrics = loop.make_scan_train_step(cfg32, device=dev)(
        fresh(), loop.stack_batches(host))
    g_launches = {k: wk.launch_count(k) for k in KERNELS}
    eager, step = fresh(), loop.make_train_step(cfg32, dev)
    for b in host:
        eager, e_metrics = step(eager, b)
    torch.cuda.synchronize()
    want = {k: n * len(host) for k, n in _train_launches(cfg32).items()}
    if {k: v for k, v in g_launches.items() if v} != want or graphed.step != len(host):
        raise AssertionError(f"graph path launches {g_launches}, expected {want}")
    g, e = _state_leaves(graphed), _state_leaves(eager)
    metric_err = max(abs(float(g_metrics[k]) - float(e_metrics[k]))
                     / max(abs(float(e_metrics[k])), 1e-30) for k in e_metrics)
    trainable = [k for k in param_tree(eager.models) if not k.startswith("feat.")]
    groups = {"params": trainable,
              "bn_stats": [k for k in e if k.endswith(("running_mean", "running_var"))],
              "solver": [k for k in e if k.startswith("opt_state")]}
    errs = {f"{name}_max_abs": max(float((g[k] - e[k]).abs().max()) for k in keys)
            for name, keys in groups.items()}
    n_diff = sum(not torch.equal(g[k], e[k]) for k in e)
    stat_err = max(float((g[k] - e[k]).abs().max() / e[k].abs().max().clamp_min(1e-30))
                   for k in groups["bn_stats"])
    flat = lambda s, keys: torch.cat([s[k].flatten().cpu() for k in keys])  # noqa: E731
    start = {k: params[k.split(".", 1)[0]][k.split(".", 1)[1]] for k in trainable}
    # the parameters' change over the steps, graph against eager
    par_err = float((flat(g, trainable) - flat(e, trainable)).norm()
                    / (flat(e, trainable) - flat(start, trainable)).norm())
    sol_err = _rel(flat(g, groups["solver"]), flat(e, groups["solver"]))
    if not (metric_err <= METRIC_RTOL and stat_err <= STATS_RTOL
            and par_err <= GRAD_RTOL and sol_err <= GRAD_RTOL):
        raise AssertionError(f"graph vs eager, iter_size {cfg32.optim.iter_size}: metrics "
                             f"{metric_err}, BN {stat_err}, params {par_err}, solver {sol_err}")
    return {"steps": len(host), "tensors": len(e), "tensors_not_bitwise_equal": n_diff,
            "metrics_max_rel": metric_err, "bn_stats_max_rel": stat_err,
            "params_rel_l2": par_err, "solver_rel_l2": sol_err, **errs,
            "graph_launches": g_launches}


def phase_scan(variant: str, dev, smi: str):
    """Several train steps per call: the step captured as a CUDA graph and
    replayed (``make_scan_train_step``, ``fit(steps_per_call=K)``,
    ``cli train --steps-per-call``) against the eager step."""
    import os
    import tempfile

    import torch

    from depthvo_tpu_torch import cli, configs
    from depthvo_tpu_torch.data import kitti
    from depthvo_tpu_torch.data.synthetic import SyntheticScenes
    from depthvo_tpu_torch.ops import warp_kernels as wk
    from depthvo_tpu_torch.train import loop
    from depthvo_tpu_torch.train.state import create_state, init_params

    cfg = getattr(configs, variant)(batch_size=BATCH)
    out = {"phase": "scan", "config": variant, "nvidia_smi": smi}

    # (1) f32, TF32 off, cuDNN deterministic, batch 2, the train phase's
    # weights: K=4 steps through the graph against 4 eager steps from the
    # same state, with iter_size 1 (one graph) and 2 (both of its graphs).
    base32 = _f32_config(getattr(configs, variant)(batch_size=2))
    params = init_params(base32, torch.Generator().manual_seed(0))
    params["odom"]["Dense_2.bias"] = torch.tensor([2.0, -1.0, -30.0, 0.2, -0.3, 0.1])
    scenes = SyntheticScenes(base32, seed=base32.seed, u8=True, num_scenes=2)
    host = [scenes.fixed_batch(2)] + [scenes.batch(2) for _ in range(3)]
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    out["graph_vs_eager"] = {}
    for iter_size in (1, 2):
        cfg32 = dataclasses.replace(base32, optim=dataclasses.replace(
            base32.optim, iter_size=iter_size))
        out["graph_vs_eager"][f"iter_size_{iter_size}"] = _graph_vs_eager(cfg32, params, host, dev)
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = flags

    # (2) bf16 default, batch 4, pre-made batches: eager K=1 against the
    # graph K=8, calls of 8 steps each, ms/step untraced (median of the
    # calls after the first), one traced call each (kernel counts, busy
    # share), peak memory.
    scenes = SyntheticScenes(cfg, seed=cfg.seed, u8=True)
    batches = [scenes.batch(BATCH) for _ in range(SCAN_K)]
    stacked = loop.batch_to_device(loop.stack_batches(batches), dev)
    on_dev = [loop.batch_to_device(b, dev) for b in batches]
    timing = {}
    for mode in ("eager", "graph"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = create_state(cfg, dev)
        if mode == "eager":
            step = loop.make_train_step(cfg, dev)

            def call():
                for b in on_dev:
                    step(state, b)
        else:
            scan = loop.make_scan_train_step(cfg, device=dev)

            def call():
                scan(state, stacked)
        ms = []
        for i in range(5):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / SCAN_K)
            if i == 0:
                first_peak = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
        memory = {"first_call_peak_allocated_bytes": first_peak,
                  "steady_peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                  "graph_pool_bytes": _private_pool_bytes()}
        wk.reset_launches()
        traced = _traced_call(call, SCAN_K)
        counts = {k: wk.launch_count(k) for k in KERNELS}
        want = {k: _train_launches(cfg).get(k, 0) * SCAN_K for k in KERNELS}
        if traced["warp_kernels"] != want or counts != want:
            raise AssertionError(f"{mode}: one call of {SCAN_K} steps ran "
                                 f"{traced['warp_kernels']} (counters {counts}), expected {want}")
        timing[mode] = {"ms_per_step_calls": ms, "ms_per_step": statistics.median(ms[1:]),
                        "memory": memory, "traced_call": traced}
        del state
    out["bf16_premade"] = timing

    # (3) From disk: `cli train --steps-per-call 8` on a KITTI raw tree
    # (phase kitti_ckpt's, written anew), 17 steps: 1 eager step and 7
    # replays, 8 replays, then the exact tail of 1; every step launches
    # the train phase's kernels. Beside it, the host ring's ms per batch.
    tmp = tempfile.TemporaryDirectory(prefix="scan-")
    root = os.path.join(tmp.name, "kitti")
    drive = write_kitti_raw(root, cfg)
    steps = 2 * SCAN_K + 1

    def train_argv(n):
        return ["train", "--variant", variant, "--kitti-root", root, "--drives", drive,
                "--steps", str(n), "--batch-size", str(BATCH), "--device", "cuda",
                "--native-ring", "1", "--steps-per-call", str(SCAN_K), "--log-every", "100"]

    argv = train_argv(steps)
    printed = io.StringIO()
    wk.reset_launches()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(argv)
    launches = _check_counts(_train_launches(cfg), steps)
    lines = [ln for ln in printed.getvalue().splitlines() if ln.startswith("step ")]
    logged = [dict(kv.split("=") for kv in ln.split(": ", 1)[1].split()) for ln in lines]
    seen = [int(ln.split(":")[0].split()[1]) for ln in lines]
    if rc != 0 or seen != [SCAN_K - 1, steps - 1] or not all(
            math.isfinite(float(v)) for m in logged for v in m.values()):
        raise AssertionError(f"cli train --steps-per-call failed: rc {rc}, {lines}")
    # Longer, so that the batches queued during the first call (the
    # prefetch's stacks and the ring's queue) no longer carry the rate.
    long_steps = 8 * SCAN_K + 1
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(train_argv(long_steps))
    last = [ln for ln in printed.getvalue().splitlines() if ln.startswith("step ")][-1]
    if rc != 0 or not last.startswith(f"step {long_steps - 1}:"):
        raise AssertionError(f"cli train --steps {long_steps} failed: rc {rc}, {last}")
    long_ms = 1e3 / float(dict(kv.split("=") for kv in last.split(": ", 1)[1].split())[
        "steps_per_sec"])
    ring = kitti.KittiRawStereo(root, [drive], cfg.model.height, cfg.model.width,
                                u8=True).iterator(BATCH, native_ring=True)
    next(ring)
    n = 16
    t0 = time.perf_counter()
    for _ in range(n):
        next(ring)
    ring_ms = (time.perf_counter() - t0) * 1e3 / n
    ring.close()
    tmp.cleanup()
    out["from_disk"] = {
        "argv": argv, "launches": launches, "logged_steps": seen,
        "ms_per_step_after_first_call": 1e3 / float(logged[-1]["steps_per_sec"]),
        f"ms_per_step_after_first_call_of_{long_steps}": long_ms,
        "host_ring_ms_per_batch": ring_ms,
        "losses": [{k: float(m[k]) for k in m if k.startswith("loss/")} for m in logged]}
    emit(out)
    return out


KITTI_HW = (375, 1242)  # the rectified size of KITTI raw's 2011_09_26 drives
KITTI_FRAMES = 9


def write_png(path, rgb) -> None:
    """A (H, W, 3) uint8 array as an 8-bit RGB PNG, filter 0 on every
    row (zlib and struct only: the card's machine may have no PIL)."""
    import struct
    import zlib

    import numpy as np

    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def write_kitti_raw(root: str, cfg) -> str:
    """One KITTI raw drive: ``KITTI_FRAMES`` frames per camera at
    375x1242, rendered from the port's synthetic scenes (frame i is scene
    i's target view on the left camera and its stereo view on the right),
    and a ``calib_cam_to_cam.txt`` with KITTI's 2011_09_26 rectified
    projections (a 0.537 m baseline) and size. Returns the drive's name."""
    import os

    from depthvo_tpu_torch.data.synthetic import SyntheticScenes

    date, drive = "2011_09_26", "2011_09_26_drive_0001_sync"
    big = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, height=KITTI_HW[0], width=KITTI_HW[1]))
    frames = SyntheticScenes(big, seed=21, num_scenes=KITTI_FRAMES, u8=True
                             ).fixed_batch(KITTI_FRAMES)
    for cam, key in (("image_02", "image_t"), ("image_03", "image_r")):
        d = os.path.join(root, date, drive, cam, "data")
        os.makedirs(d)
        for i in range(KITTI_FRAMES):
            write_png(os.path.join(d, f"{i:010d}.png"), frames[key][i])
    fx, cx, cy = 7.215377e02, 6.095593e02, 1.728540e02
    with open(os.path.join(root, date, "calib_cam_to_cam.txt"), "w") as f:
        f.write(f"S_rect_02: {KITTI_HW[1]:.6e} {KITTI_HW[0]:.6e}\n")
        for cam, tx in (("02", 4.485728e01), ("03", -3.395242e02)):
            f.write(f"P_rect_{cam}: {fx:e} 0 {cx:e} {tx:e} 0 {fx:e} {cy:e} 2.163791e-01 "
                    "0 0 1 2.745884e-03\n")
    return drive


def phase_kitti_ckpt(variant: str, dev, smi: str, premade_ms: float):
    """The training path users run: ``cli train`` on a KITTI raw tree
    (native decode ring, prefetch through pinned buffers and a side
    stream) with a checkpoint directory; the same command resumes; a
    checkpoint round trip on the card; stage 2 initialised from it; then
    ``cli test`` and ``DepthVO.from_checkpoint`` from it."""
    import os
    import tempfile

    import numpy as np
    import torch

    from depthvo_tpu_torch import DepthVO, cli, configs
    from depthvo_tpu_torch.configs import base as config_base
    from depthvo_tpu_torch.data import kitti
    from depthvo_tpu_torch.io import checkpoint as ckpt
    from depthvo_tpu_torch.ops import warp_kernels as wk
    from depthvo_tpu_torch.train import loop, state as tstate

    cfg = getattr(configs, variant)(batch_size=BATCH)
    out = {"phase": "kitti_ckpt", "config": variant, "nvidia_smi": smi,
           "kitti_hw": list(KITTI_HW), "frames": KITTI_FRAMES}
    tmp = tempfile.TemporaryDirectory(prefix="kitti_ckpt-")
    root, ck = os.path.join(tmp.name, "kitti"), os.path.join(tmp.name, "ck")
    drive = write_kitti_raw(root, cfg)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False

    def train(steps, *extra):
        argv = ["train", "--variant", variant, "--kitti-root", root, "--drives", drive,
                "--steps", str(steps), "--batch-size", str(BATCH), "--device", "cuda",
                "--native-ring", "1", "--log-every", "1", *extra]
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(argv)
        seconds = time.perf_counter() - t0
        lines = [ln for ln in printed.getvalue().splitlines() if ln.startswith("step ")]
        logged = [dict(kv.split("=") for kv in ln.split(": ", 1)[1].split()) for ln in lines]
        steps_seen = [int(ln.split(":")[0].split()[1]) for ln in lines]
        if rc != 0 or not all(math.isfinite(float(v)) for m in logged for v in m.values()):
            raise AssertionError(f"cli train failed: rc {rc}, {lines}")
        return argv, steps_seen, logged, seconds

    # (2) Train 2 steps from disk and snapshot: the main path.
    wk.reset_launches()
    argv, seen, logged, seconds = train(2, "--checkpoint-dir", ck)
    launches = _check_counts(_train_launches(cfg), 2)
    mgr = ckpt.make_manager(ck)
    if seen != [0, 1] or mgr.all_steps() != [2] or not os.path.isfile(
            os.path.join(ck, "config.json")):
        raise AssertionError(f"train: steps {seen}, checkpoints {mgr.all_steps()}")
    out["main_path"] = {"argv": argv, "launches": launches,
                        "losses": [{k: float(m[k]) for k in m if k.startswith("loss/")}
                                   for m in logged]}
    out["from_disk"] = {"cli_seconds": seconds,
                        "ms_per_step_second_step": 1e3 / float(logged[-1]["steps_per_sec"]),
                        "premade_ms_per_step": premade_ms}

    # (3) Resume with the same command and 4 steps; the batches the step
    # receives (prefetched on the side stream) equal the host's.
    host_it = kitti.KittiRawStereo(root, [drive], cfg.model.height, cfg.model.width,
                                   u8=True).iterator(BATCH, seed=cfg.seed, native_ring=True)
    host = [next(host_it) for _ in range(2)]
    host_it.close()
    seen_batches = []
    real_to_device = loop.batch_to_device

    def spy(batch, device):
        b = real_to_device(batch, device)
        seen_batches.append({k: v.cpu() for k, v in b.items()})
        return b

    loop.batch_to_device = spy
    try:
        wk.reset_launches()
        _, seen, _, _ = train(4, "--checkpoint-dir", ck)
        _check_counts(_train_launches(cfg), 2)
    finally:
        loop.batch_to_device = real_to_device
    if seen != [2, 3] or mgr.all_steps() != [2, 4]:
        raise AssertionError(f"resume: steps {seen}, checkpoints {mgr.all_steps()}")
    for got, want in zip(seen_batches, host):
        for k, v in want.items():
            if not torch.equal(got[k], torch.as_tensor(v)):
                raise AssertionError(f"prefetched batch differs from the host's in {k}")
    if len(seen_batches) != 2:
        raise AssertionError(f"{len(seen_batches)} batches reached the step")
    out["resume"] = {"steps": seen, "checkpoints": mgr.all_steps(),
                     "prefetched_batches_equal_host": len(seen_batches)}

    # (4) Round trip on the card, bit for bit.
    state = ckpt.maybe_restore(mgr, tstate.create_state(cfg, dev))
    mgr2 = ckpt.make_manager(os.path.join(tmp.name, "ck2"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ckpt.save(mgr2, state)
    save_ms = (time.perf_counter() - t0) * 1e3
    fresh = tstate.create_state(cfg, dev, torch.Generator().manual_seed(99))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh = ckpt.maybe_restore(mgr2, fresh)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    a, b = tstate.state_dict(state), tstate.state_dict(fresh)
    pairs = [(a["nets"][n][k], b["nets"][n][k]) for n in a["nets"] for k in a["nets"][n]]

    def leaves(t):
        return [t] if not isinstance(t, (tuple, list)) else [x for y in t for x in leaves(y)]

    pairs += list(zip(leaves(a["opt_state"]), leaves(b["opt_state"])))
    if a["step"] != b["step"] or not all(
            torch.equal(x, y) if torch.is_tensor(x) else x == y for x, y in pairs):
        raise AssertionError("the checkpoint round trip on the card is not exact")
    out["checkpoint"] = {"step": b["step"], "tensors_equal": len(pairs),
                         "bytes": os.path.getsize(os.path.join(path, ckpt.STATE_FILE)),
                         "save_ms": save_ms, "restore_ms": restore_ms}
    del state, fresh, a, b, pairs

    # (5) Stage 2 from the checkpoint: its networks' weights before its
    # first step are the checkpoint's.
    saved = torch.load(os.path.join(ck, "4", ckpt.STATE_FILE), weights_only=True)["nets"]
    before = {}
    real_step = loop.make_train_step

    def first_weights(config, device=None):
        step_fn = real_step(config, device)

        def wrapped(st, batch):
            if not before:
                before.update({n: {k: v.detach().to("cpu", copy=True) for k, v in
                                   getattr(st.models, n).state_dict().items()}
                               for n in ("depth", "odom")})
            return step_fn(st, batch)

        return wrapped

    loop.make_train_step = first_weights
    try:
        # (stage 2 of full_feat's recipe; a smaller variant rehearses with itself)
        stage2 = "temporal_stereo" if variant == "full_feat" else variant
        argv2 = ["train", "--variant", stage2, "--kitti-root", root, "--drives",
                 drive, "--steps", "1", "--batch-size", str(BATCH), "--device", "cuda",
                 "--native-ring", "1", "--init-from", ck]
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(argv2)
    finally:
        loop.make_train_step = real_step
    if rc != 0 or not all(torch.equal(before[n][k], saved[n][k])
                          for n in before for k in before[n]):
        raise AssertionError("stage 2 did not start from the checkpoint's weights")
    out["staged_init"] = {"argv": argv2, "nets_equal": sorted(before)}

    # (6) `cli test` and DepthVO from the checkpoint.
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(["test", "--checkpoint-dir", ck, "--iterations", "2", "--device", "cuda"])
    text = printed.getvalue()
    metrics = json.loads(text[text.index("{"):])
    if rc != 0 or not metrics or not all(map(math.isfinite, metrics.values())):
        raise AssertionError(f"cli test from the checkpoint failed: rc {rc}, {metrics}")
    out["test"] = metrics
    cfg32 = _f32_config(config_base.load_json(os.path.join(ck, "config.json")))
    torch.backends.cudnn.allow_tf32 = False
    images = host[0]["image_t"][:2]
    depth = {d: DepthVO.from_checkpoint(ck, cfg32, device=d).depth(images)
             for d in ("cuda", "cpu")}
    torch.backends.cudnn.allow_tf32 = True
    rel = float(np.abs(depth["cuda"] - depth["cpu"]).max() / np.abs(depth["cpu"]).max())
    if not rel <= METRIC_RTOL:
        raise AssertionError(f"depth from the checkpoint, card vs CPU: {rel}")
    out["from_checkpoint_depth_card_vs_cpu_rel"] = rel

    # (7) Steady steps from disk (no checkpoint, no per-step host read):
    # whether the ring and the upload keep up with the step.
    _, seen, logged, _ = train(14, "--log-every", "100")
    out["from_disk"]["ms_per_step_13_steady"] = 1e3 / float(logged[-1]["steps_per_sec"])

    # The host ring alone: ms per batch (decode + resize of 3 x 4
    # PNGs at 375x1242 -> 160x608 on 4 C++ threads, then the batch join).
    ring = kitti.KittiRawStereo(root, [drive], cfg.model.height, cfg.model.width,
                                u8=True).iterator(BATCH, native_ring=True)
    next(ring)
    n = 8
    t0 = time.perf_counter()
    for _ in range(n):
        next(ring)
    out["host_ring_ms_per_batch"] = (time.perf_counter() - t0) * 1e3 / n
    ring.close()
    tmp.cleanup()
    emit(out)


EVAL_FRAMES = 70  # 4 batches of 16 and a padded tail of 6
EVAL_BATCH = 16
ODOM_FRAMES = 24
ODOM_HW = (376, 1241)  # KITTI odometry's size for sequences 04-12
INFER_FRAMES = 20
VELO_POINTS = 4000
# KITTI raw 2011_09_26's velodyne-to-camera extrinsics (the axis swap and
# the lever arm) and its left camera's rectified projection.
VELO_R = ((7.533745e-03, -9.999714e-01, -6.166020e-04),
          (1.480249e-02, 7.280733e-04, -9.998902e-01),
          (9.998621e-01, 7.523790e-03, 1.480755e-02))
VELO_T = (-4.069766e-03, -7.631618e-02, -2.717806e-01)
P_RECT_02 = ((7.215377e02, 0.0, 6.095593e02, 4.485728e01),
             (0.0, 7.215377e02, 1.728540e02, 2.163791e-01),
             (0.0, 0.0, 1.0, 2.745884e-03))


def write_velodyne_drive(root: str, cfg):
    """One KITTI raw drive for the Eigen protocol: ``EVAL_FRAMES`` left
    frames at 1242x375 (9 rendered synthetic scenes, shifted sideways by
    37 px per pass), a velodyne scan per frame (``VELO_POINTS`` float32
    x, y, z, reflectance points from 5 to 75 m in front of the camera, over
    the lower 60% of the image) and both calibration files. Returns the
    drive's name and its frames."""
    import os

    import numpy as np

    from depthvo_tpu_torch.data.synthetic import SyntheticScenes

    date, drive = "2011_09_26", "2011_09_26_drive_0002_sync"
    H, W = KITTI_HW
    big = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, height=H, width=W))
    scenes = SyntheticScenes(big, seed=31, num_scenes=9, u8=True).fixed_batch(9)["image_t"]
    ddir = os.path.join(root, date, drive)
    for sub in ("image_02", "velodyne_points"):
        os.makedirs(os.path.join(ddir, sub, "data"))
    P = np.array(P_RECT_02)
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = VELO_R, VELO_T
    cam_to_velo = np.linalg.inv(T)
    rng = np.random.default_rng(0)
    frames = [np.roll(scenes[i % 9], 37 * (i // 9), axis=1) for i in range(EVAL_FRAMES)]
    for i, img in enumerate(frames):
        write_png(os.path.join(ddir, "image_02", "data", f"{i:010d}.png"), img)
        u = rng.uniform(0, W, VELO_POINTS)
        v = rng.uniform(0.4 * H, H, VELO_POINTS)
        z = rng.uniform(5.0, 75.0, VELO_POINTS)
        cam = np.stack([(u - P[0, 2]) * z / P[0, 0], (v - P[1, 2]) * z / P[1, 1], z,
                        np.ones(VELO_POINTS)])
        velo = (cam_to_velo @ cam)[:3].T
        scan = np.concatenate([velo, rng.uniform(0, 1, (VELO_POINTS, 1))], axis=1)
        scan.astype(np.float32).tofile(
            os.path.join(ddir, "velodyne_points", "data", f"{i:010d}.bin"))
    flat = lambda m: " ".join(f"{x:e}" for x in np.ravel(m))  # noqa: E731
    with open(os.path.join(root, date, "calib_cam_to_cam.txt"), "w") as f:
        f.write(f"S_rect_02: {W:.6e} {H:.6e}\nR_rect_00: {flat(np.eye(3))}\n"
                f"P_rect_02: {flat(P)}\n")
    with open(os.path.join(root, date, "calib_velo_to_cam.txt"), "w") as f:
        f.write(f"R: {flat(VELO_R)}\nT: {flat(VELO_T)}\n")
    return drive, frames


def write_odometry_sequence(root: str, frames) -> None:
    """KITTI odometry sequence 09: ``ODOM_FRAMES`` left frames at
    1241x376 (the eval drive's frames, one column cut and the last row
    repeated), calib.txt, and ground-truth poses along a curve at 5 m per
    frame (115 m: the devkit's 100 m segments fit)."""
    import os

    import numpy as np

    from depthvo_tpu_torch.eval.odometry import write_kitti_poses

    d = os.path.join(root, "sequences", "09", "image_2")
    os.makedirs(d)
    h, w = ODOM_HW
    for i, img in enumerate(frames[:ODOM_FRAMES]):
        img = np.concatenate([img, img[-1:]], axis=0)[:h, :w]
        write_png(os.path.join(d, f"{i:06d}.png"), np.ascontiguousarray(img))
    P = " ".join(f"{x:e}" for x in np.ravel(P_RECT_02))
    with open(os.path.join(root, "sequences", "09", "calib.txt"), "w") as f:
        for cam in range(4):
            f.write(f"P{cam}: {P}\n")
    poses, T = [np.eye(4)], np.eye(4)
    for k in range(ODOM_FRAMES - 1):
        a = 0.02 * np.sin(k / 3.0)
        step = np.eye(4)
        step[0, 0] = step[2, 2] = np.cos(a)
        step[0, 2], step[2, 0] = np.sin(a), -np.sin(a)
        step[2, 3] = 5.0
        T = T @ step
        poses.append(T.copy())
    os.makedirs(os.path.join(root, "poses"))
    write_kitti_poses(np.asarray(poses), os.path.join(root, "poses", "09.txt"))


@contextlib.contextmanager
def _quiet():
    """No warnings: the eval's non-canonical split warns on every run."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _cli_json(argv) -> tuple[dict, float]:
    """``cli.main(argv)``'s printed JSON and the call's seconds."""
    from depthvo_tpu_torch import cli

    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed), _quiet():
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    text = printed.getvalue()
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} returned {rc}: {text[-2000:]}")
    return json.loads(text[text.index("{"):text.rindex("}") + 1]), seconds


def _same_depth_table(got: dict, ref: dict, tol_a: float) -> dict:
    """Continuous metrics <= METRIC_RTOL relative, a1..a3 within ``tol_a``
    (one pixel per frame: 1 / n_valid averaged over the frames)."""
    cont = {k: abs(got[k] - ref[k]) / abs(ref[k])
            for k in ("abs_rel", "sq_rel", "rmse", "rmse_log")}
    thr = {k: abs(got[k] - ref[k]) for k in ("a1", "a2", "a3")}
    if not (max(cont.values()) <= METRIC_RTOL and max(thr.values()) <= tol_a):
        raise AssertionError(f"depth tables differ: {got} vs {ref} (a tolerance {tol_a})")
    return {"continuous_max_rel": max(cont.values()), "thresholds_max_abs": max(thr.values()),
            "thresholds_tolerance": tol_a}


def phase_eval(variant: str, dev, smi: str):
    """The eval runner users run (A.4) and the rest of DepthNet (A.5), in a
    temporary directory, at the variant's width."""
    import hashlib
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from depthvo_tpu_torch import DepthVO, cli, configs
    from depthvo_tpu_torch.configs import base as config_base
    from depthvo_tpu_torch.data.kitti import KittiOdometrySequence, load_images_u8
    from depthvo_tpu_torch.data.synthetic import SyntheticScenes
    from depthvo_tpu_torch.eval import runner
    from depthvo_tpu_torch.eval.depth_metrics import compute_depth_metrics, eigen_crop_mask
    from depthvo_tpu_torch.eval.odometry import read_kitti_poses
    from depthvo_tpu_torch.eval.resize import resize_bilinear_f32
    from depthvo_tpu_torch.io import checkpoint as ckpt
    from depthvo_tpu_torch.ops import warp_kernels as wk
    from depthvo_tpu_torch.train import loop, state as tstate

    cfg = getattr(configs, variant)(batch_size=BATCH)
    cfg32 = _f32_config(cfg)
    h, w = cfg.model.height, cfg.model.width
    out = {"phase": "eval", "config": variant, "nvidia_smi": smi, "hw": [h, w],
           "eval_frames": EVAL_FRAMES, "batch": EVAL_BATCH}
    tmp = tempfile.TemporaryDirectory(prefix="eval-")
    path = lambda *p: os.path.join(tmp.name, *p)  # noqa: E731
    root = path("kitti")
    t0 = time.perf_counter()
    drive, drive_frames = write_velodyne_drive(root, cfg)
    out["write_tree_seconds"] = time.perf_counter() - t0

    # (1) prep-eigen: ground truth from the scans, and the list.
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(["prep-eigen", "--kitti-root", root, "--output-dir", path("eigen"),
                       "--scenes", drive])
    split = path("eigen", "eigen_list.txt")
    lines = open(split).read().splitlines()
    if rc != 0 or lines[0] != "# split-source: derived-scene-list" or len(lines) != 1 + EVAL_FRAMES:
        raise AssertionError(f"prep-eigen: rc {rc}, {lines[:2]}, {len(lines)} lines")
    gts = [np.load(ln.split()[1]) for ln in lines[1:]]
    n_valid = [int(((g > 1e-3) & (g < 80.0) & eigen_crop_mask(*g.shape)).sum()) for g in gts]
    if min(n_valid) < 100 or gts[0].shape != KITTI_HW:
        raise AssertionError(f"prep-eigen gt: shape {gts[0].shape}, valid pixels {min(n_valid)}")
    tol_a = float(np.mean([1.0 / n for n in n_valid]))
    out["prep_eigen"] = {"seconds": time.perf_counter() - t0, "frames": len(gts),
                         "valid_px_per_frame_min": min(n_valid)}

    # (2) eval-depth, float32 with TF32 off: the card against the CPU, on
    # a checkpoint of DepthVO.from_random(seed=0)'s weights with its
    # float32 config.
    c32 = path("ck32")
    ckpt.save(ckpt.make_manager(c32), tstate.create_state(cfg32, torch.device("cpu"),
                                                         torch.Generator().manual_seed(0)))
    config_base.save_json(cfg32, os.path.join(c32, "config.json"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    common = ["eval-depth", "--kitti-root", root, "--split-file", split,
              "--checkpoint-dir", c32]
    wk.reset_launches()
    card, card_s = _cli_json(common + ["--device", "cuda", "--save-preds", path("preds")])
    launches = _check_counts({}, 1)  # the eval path launches no warp kernel
    cpu, cpu_s = _cli_json(common + ["--device", "cpu"])
    check = _same_depth_table(card, cpu, tol_a)
    want_split = {"split_file": os.path.abspath(split), "n_frames": EVAL_FRAMES,
                  "canonical": False, "source": "derived-scene-list", "median_scale": True,
                  "sha256": hashlib.sha256(open(split, "rb").read()).hexdigest(),
                  "pinned": False}
    if card["split"] != want_split or card["quant"] != "off":
        raise AssertionError(f"split provenance {card['split']}, quant {card['quant']}")
    saved, saved_s = _cli_json(["eval-depth", "--kitti-root", root, "--split-file", split,
                                "--pred-path", path("preds")])
    names = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
    if any(saved[k] != card[k] for k in names) or saved["quant"] != "external":
        raise AssertionError(f"--pred-path table {saved} differs from the run's {card}")
    out["eval_depth_f32"] = {"card": {k: card[k] for k in names}, "card_vs_cpu": check,
                             "launches": launches, "split": card["split"],
                             "card_cli_seconds": card_s, "cpu_cli_seconds": cpu_s,
                             "pred_path_equal": True, "pred_path_cli_seconds": saved_s}

    # (3) run_depth_eval on the default (bfloat16) config: recorded.
    torch.backends.cudnn.allow_tf32 = True
    model = DepthVO.from_random(cfg, seed=0, device=dev)
    runs = []
    for _ in range(2):  # the first pays cuDNN's and the allocator's set-up
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), _quiet():
            table = runner.run_depth_eval(None, root, split, height=h, width=w,
                                          batch_size=EVAL_BATCH, model=model)
        runs.append(time.perf_counter() - t0)
    if not all(math.isfinite(table[k]) for k in names):
        raise AssertionError(f"bf16 depth table {table}")
    # Its parts as run_depth_eval runs them: the decode on 8 host threads,
    # the sweep, the sweep with the resize to the ground truth on 4
    # threads as its batches drain, the metrics.
    t0 = time.perf_counter()
    frames = load_images_u8([os.path.join(root, ln.split()[0]) for ln in lines[1:]], h, w)
    decode_s = time.perf_counter() - t0
    runner.predict_depths(model, frames, EVAL_BATCH)
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()  # the weights, and what earlier phases hold
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    preds = runner.predict_depths(model, frames, EVAL_BATCH)
    sweep_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    resized = runner.predict_depths(model, frames, EVAL_BATCH, postprocess=lambda i, p: (
        resize_bilinear_f32(p, *gts[i].shape)))
    resize_sweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for p, g in zip(preds, gts):
        resize_bilinear_f32(p, *g.shape)
    resize_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    compute_depth_metrics(resized, gts)
    metrics_s = time.perf_counter() - t0
    batches = -(-EVAL_FRAMES // EVAL_BATCH)
    traced = _traced_call(lambda: runner.predict_depths(model, frames, EVAL_BATCH), batches)
    out["eval_depth_bf16"] = {
        "table": {k: table[k] for k in names},
        "run_depth_eval_seconds": runs, "frames_per_s_run_depth_eval": EVAL_FRAMES / runs[-1],
        "sweep_seconds": sweep_s, "frames_per_s_sweep": EVAL_FRAMES / sweep_s,
        "sweep_peak_allocated_bytes": peak, "live_before_sweep_bytes": live,
        "sweep_peak_above_live_bytes": peak - live,
        "sweep_with_resize_seconds": resize_sweep_s, "host_decode_seconds": decode_s,
        "host_resize_seconds_one_thread": resize_s, "host_metrics_seconds": metrics_s,
        # the host's share: decode, the resize beyond the sweep, metrics
        "host_share": (decode_s + resize_sweep_s - sweep_s + metrics_s) / runs[-1],
        "traced_sweep": {k: traced[k] for k in ("kernels_per_step", "device_busy_ms_per_step",
                                                "traced_wall_ms_per_step",
                                                "device_busy_share", "warp_kernels")},
    }
    del model

    # (4) eval-odom: float32 card against CPU, the pose file scored alone,
    # frames/s of the bfloat16 sweep.
    odom = path("odom")
    write_odometry_sequence(odom, drive_frames)
    del drive_frames
    torch.backends.cudnn.allow_tf32 = False
    common = ["eval-odom", "--kitti-root", odom, "--checkpoint-dir", c32]
    o_card, o_card_s = _cli_json(common + ["--device", "cuda", "--output-dir", path("o_card")])
    o_cpu, _ = _cli_json(common + ["--device", "cpu", "--output-dir", path("o_cpu")])
    tc = read_kitti_poses(path("o_card", "09.txt"))[:, :3, 3]
    tp = read_kitti_poses(path("o_cpu", "09.txt"))[:, :3, 3]
    t_rel = float(np.abs(tc - tp).max() / np.abs(tp).max())
    if not t_rel <= METRIC_RTOL or o_card["frames"] != ODOM_FRAMES:
        raise AssertionError(f"eval-odom trajectory card vs CPU: {t_rel}, {o_card}")
    scored, _ = _cli_json(["eval-odom", "--kitti-root", odom, "--output-dir", "",
                           "--pose-file", path("o_card", "09.txt")])
    score_keys = ("t_err_pct", "r_err_deg_per_100m", "ate_m", "snippet_ate_mean")
    pose_rel = max(abs(scored[k] - o_card[k]) / max(abs(o_card[k]), 1e-12) for k in score_keys)
    if not pose_rel <= 1e-5:  # the pose file holds 10 significant digits
        raise AssertionError(f"--pose-file scores {scored} vs the run's {o_card}")
    torch.backends.cudnn.allow_tf32 = True
    model = DepthVO.from_random(cfg, seed=0, device=dev)
    seq = KittiOdometrySequence(odom, "09", h, w)
    runner.predict_trajectory(model, seq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.predict_trajectory(model, seq)
    traj_s = time.perf_counter() - t0
    seq_frames = seq.frames_u8()
    t0 = time.perf_counter()
    model.pose_sequence(seq_frames)
    pose_s = time.perf_counter() - t0
    out["eval_odom"] = {"f32_card": {k: o_card[k] for k in score_keys},
                        "f32_translation_card_vs_cpu_rel": t_rel,
                        "pose_file_scores_max_rel": pose_rel, "f32_card_cli_seconds": o_card_s,
                        "bf16_frames_per_s_with_decode": ODOM_FRAMES / traj_s,
                        "bf16_frames_per_s_pose_sequence": ODOM_FRAMES / pose_s}

    # (5) infer over a directory of PNGs: the files equal DepthVO.depth of
    # the same frames in the same padded batches; frames/s of the sweep.
    images = path("infer_in")
    os.makedirs(images)
    names_in = sorted(os.listdir(os.path.join(root, "2011_09_26", drive, "image_02", "data")))
    for name in names_in[:INFER_FRAMES]:
        shutil.copy(os.path.join(root, "2011_09_26", drive, "image_02", "data", name), images)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(["infer", "--variant", variant, "--images", images, "--output-dir",
                       path("infer_out"), "--device", "cuda"])
    text = printed.getvalue()
    fps = re.search(r"\(([\d.]+) frames/s steady", text)
    if rc != 0 or not fps:
        raise AssertionError(f"cli infer: rc {rc}, {text}")
    icfg = getattr(configs, variant)(batch_size=EVAL_BATCH)
    model = DepthVO.from_random(icfg, seed=0, device=dev)
    fr = load_images_u8([os.path.join(images, n) for n in names_in[:INFER_FRAMES]], h, w)
    padded = np.concatenate([fr, np.repeat(fr[-1:], (-len(fr)) % EVAL_BATCH, 0)])
    want = np.concatenate([model.depth(padded[i:i + EVAL_BATCH])
                           for i in range(0, len(padded), EVAL_BATCH)])[:INFER_FRAMES]
    got = np.stack([np.load(path("infer_out", os.path.splitext(n)[0] + "_depth.npy"))
                    for n in names_in[:INFER_FRAMES]])
    infer_rel = float(np.abs(got - want).max() / np.abs(want).max())
    if not infer_rel <= 1e-6:
        raise AssertionError(f"infer outputs vs DepthVO.depth: {infer_rel}")
    out["infer"] = {"frames": INFER_FRAMES, "frames_per_s_steady": float(fps.group(1)),
                    "vs_depth_vo_max_rel": infer_rel}
    del model
    out["a5"] = _a5_checks(cfg, dev, frames[:2])
    emit(out)
    # The tree stays for phase int8_serving, which deletes it.
    return {"tmp": tmp, "root": root, "split": split, "ck32": c32, "images": images,
            "infer_names": names_in[:INFER_FRAMES], "frames": frames,
            "sweep_frames_per_s": out["eval_depth_bf16"]["frames_per_s_sweep"]}


def _with_model(cfg, **kw):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **kw))


def _a5_checks(cfg, dev, images) -> dict:
    """The rest of DepthNet on the card: each head's depth in float32 (TF32
    off, cuDNN deterministic) against the CPU's; ``cli train --config`` of
    2 steps with each head (bfloat16, batch 4): finite losses and the train
    phase's launches per step; ``remat`` against the standard step from the
    same state, float32 batch 2, one eager step and one
    ``make_scan_train_step`` call of K=2 (captured): every parameter,
    BatchNorm statistic and solver tensor and the metrics bit for bit; and
    the bfloat16 batch-4 train step's peak allocated bytes with and without
    ``remat``."""
    import os
    import tempfile

    import numpy as np
    import torch

    from depthvo_tpu_torch import DepthVO, cli
    from depthvo_tpu_torch.configs import base as config_base
    from depthvo_tpu_torch.data.synthetic import SyntheticScenes
    from depthvo_tpu_torch.ops import warp_kernels as wk
    from depthvo_tpu_torch.train import loop, state as tstate

    backends = torch.backends

    def exact(on: bool):
        backends.cudnn.allow_tf32 = not on
        backends.cuda.matmul.allow_tf32 = False
        backends.cudnn.deterministic = on

    out = {}
    for head in ("subpixel_head", "fast_final_upsample"):
        hcfg = _with_model(cfg, s2d_finest=False, **{head: True})
        exact(True)
        depth = {d: DepthVO.from_random(_f32_config(hcfg), seed=0, device=d).depth(images)
                 for d in ("cuda", "cpu")}
        rel = float(np.abs(depth["cuda"] - depth["cpu"]).max() / np.abs(depth["cpu"]).max())
        if not rel <= METRIC_RTOL:
            raise AssertionError(f"{head}: depth card vs CPU {rel}")
        exact(False)
        with tempfile.TemporaryDirectory(prefix="head-") as d:
            cfg_path = os.path.join(d, "config.json")
            config_base.save_json(hcfg, cfg_path)
            argv = ["train", "--config", cfg_path, "--steps", "2", "--device", "cuda",
                    "--log-every", "1"]
            printed = io.StringIO()
            wk.reset_launches()
            with contextlib.redirect_stdout(printed):
                rc = cli.main(argv)
            launches = _check_counts(_train_launches(hcfg), 2)
        logged = [dict(kv.split("=") for kv in ln.split(": ", 1)[1].split())
                  for ln in printed.getvalue().splitlines() if ln.startswith("step ")]
        losses = [{k: float(m[k]) for k in m if k.startswith("loss/")} for m in logged]
        if rc != 0 or len(losses) != 2 or not all(
                math.isfinite(v) for m in losses for v in m.values()):
            raise AssertionError(f"cli train with {head}: rc {rc}, {losses}")
        out[head] = {"f32_depth_card_vs_cpu_rel": rel, "cli_train": {
            "argv": argv[:1] + ["--config", f"<{head} config>"] + argv[3:],
            "launches": launches, "losses": losses}}

    # remat against the standard step, bit for bit.
    exact(True)
    cfg32 = _f32_config(dataclasses.replace(cfg, batch_size=2))
    params = tstate.init_params(cfg32, torch.Generator().manual_seed(0))
    scenes = SyntheticScenes(cfg32, seed=41, u8=True)
    host = [scenes.batch(2) for _ in range(2)]

    def fresh(remat):
        c = _with_model(cfg32, remat=remat)
        models = tstate.load_params(tstate.build_models(c), params, dev).train()
        return c, tstate.TrainState(0, models, tstate.make_optimizer(c).init(
            tstate.param_tree(models)))

    def steps(remat):
        """(leaves, metrics) after one eager step, and after one call of
        K=2 steps (an eager step, its capture, one replay)."""
        c, st = fresh(remat)
        st, m = loop.make_train_step(c, dev)(st, host[0])
        eager = ({k: v.clone() for k, v in _state_leaves(st).items()}, m)
        c, st = fresh(remat)
        st, m = loop.make_scan_train_step(c, device=dev)(st, loop.stack_batches(host))
        return eager, (_state_leaves(st), m)

    def compare(standard, rematted, how) -> dict:
        (a, ma), (b, mb) = standard, rematted
        unequal = [k for k in a if not torch.equal(a[k], b[k])]
        m_unequal = [k for k in ma if not torch.equal(ma[k], mb[k])]
        if unequal or m_unequal or set(a) != set(b):
            raise AssertionError(f"remat vs standard, {how}: {len(unequal)} tensors differ "
                                 f"({unequal[:4]}), metrics {m_unequal}")
        return {"tensors_bitwise_equal": len(a), "metrics_bitwise_equal": len(ma)}

    runs = [steps(False), steps(True)]
    remat_out = {how: compare(runs[0][i], runs[1][i], how)
                 for i, how in enumerate(("eager_step", "scan_k2_captured"))}
    del runs
    exact(False)

    # The bfloat16 batch-4 train step's peak, with and without remat.
    for remat in (False, True):
        c = _with_model(cfg, remat=remat)
        st = tstate.create_state(c, dev, torch.Generator().manual_seed(0))
        step = loop.make_train_step(c, dev)
        b = SyntheticScenes(c, seed=43, num_scenes=BATCH, u8=True).fixed_batch(BATCH)
        step(st, b)
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            step(st, b)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        remat_out["remat" if remat else "standard"] = {
            "peak_allocated_bytes": peak, "live_before_step_bytes": live,
            "step_peak_above_live_bytes": peak - live,
            "ms_per_step_eager": (time.perf_counter() - t0) * 1e3 / 3}
        del st, step
    out["remat"] = remat_out
    return out


INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate, NVIDIA data sheet
INT8_RTOL = INT8_ATOL = 2e-3  # the reference's own int8 bar (tests/test_serving.py)
A_MAX_RTOL = 2e-5
INT8_SAME_SCALES_RTOL = 1e-5
ARTIFACT_RTOL = 1e-5
INT8_BATCH = 16
INT8_SWEEP_FRAMES = 128


def _quant_conv_shapes(model, images) -> dict:
    """The distinct quantized conv shapes of one int8 depth forward:
    (C, H, W, O, kernel, stride) -> the layers that have it."""
    from depthvo_tpu_torch.models.layers import QuantConv

    shapes: dict = {}
    hooks = [m.register_forward_pre_hook(
        lambda m, a, name=name: shapes.setdefault(
            (a[0].shape[1], a[0].shape[2], a[0].shape[3], m.out_channels,
             m.kernel_size[0], m.stride[0]), []).append(name))
        for name, m in model.models.depth.named_modules() if isinstance(m, QuantConv)]
    try:
        model.depth(images)
    finally:
        for h in hooks:
            h.remove()
    return shapes


def _int8_conv_rows(shapes: dict, dev) -> list:
    """Each shape at batch 16 on random int8 codes: the ``_int_mm`` path
    against its float64 plain version bit for bit in int32, and the device
    time of both beside cuDNN's bfloat16 convolution of the same shape and
    the bound (int8 operands and the int32 output once; 2*M*N*K int8
    operations)."""
    import torch
    import torch.nn.functional as F

    from depthvo_tpu_torch.models.layers import same_pads
    from depthvo_tpu_torch.ops import int8_conv

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for (c, h, w, o, k, st), layers in sorted(shapes.items()):
        x = torch.randint(-127, 128, (INT8_BATCH, c, h, w), dtype=torch.int8, device=dev,
                          generator=gen)
        wq = torch.randint(-127, 128, (o, c, k, k), dtype=torch.int8, device=dev, generator=gen)
        ph, pw = same_pads(h, k, st), same_pads(w, k, st)
        pads = (pw[0], pw[1], ph[0], ph[1])
        w_mat = int8_conv.weight_matrix(wq)
        got = int8_conv.int8_conv2d(x, w_mat, k, st, 1, pads)
        want = int8_conv.int8_conv2d_plain(x, wq, st, 1, pads)
        torch.cuda.synchronize()
        if got.dtype != torch.int32 or not torch.equal(got, want):
            raise AssertionError(f"int8 conv {(c, h, w, o, k, st)}: the _int_mm path differs "
                                 f"from its plain version by {int((got - want).abs().max())}")
        xb, wb = x.to(torch.bfloat16), wq.to(torch.bfloat16)
        ms = device_ms(lambda: int8_conv.int8_conv2d(x, w_mat, k, st, 1, pads))
        plain = device_ms(lambda: int8_conv.int8_conv2d_plain(x, wq, st, 1, pads), runs=5,
                          per_run=2)
        cudnn = device_ms(lambda: F.conv2d(F.pad(xb, pads), wb, None, st))
        m_rows, kk = got[:, 0].numel(), c * k * k
        nbytes = x.numel() + wq.numel() + 4 * got.numel()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * m_rows * o * kk / INT8_OPS_PER_S * 1e3
        rows.append({"shape": {"C": c, "H": h, "W": w, "O": o, "kernel": k, "stride": st},
                     "layers": len(layers), "bit_equal": True, "gemm_mnk": [m_rows, o, kk],
                     "int8_us": ms * 1e3, "plain_f64_us": plain * 1e3,
                     "cudnn_bf16_us": cudnn * 1e3, "bound_us": max(t_bytes, t_ops) * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        del x, wq, w_mat, got, want, xb, wb
    return rows


def phase_int8_serving(variant: str, dev, smi: str, fixtures: dict):
    """w8a8 serving and the serving export at the variant's width (A.6)."""
    import os

    import numpy as np
    import torch

    from depthvo_tpu_torch import DepthVO, cli, configs
    from depthvo_tpu_torch.data.kitti import load_images_u8
    from depthvo_tpu_torch.data.synthetic import SyntheticScenes
    from depthvo_tpu_torch.eval import runner
    from depthvo_tpu_torch.io import serving
    from depthvo_tpu_torch.ops import int8_conv

    cfg = getattr(configs, variant)(batch_size=INT8_BATCH)
    cfg32 = _f32_config(cfg)
    h, w = cfg.model.height, cfg.model.width
    out = {"phase": "int8_serving", "config": variant, "nvidia_smi": smi, "hw": [h, w],
           "batch": INT8_BATCH}
    half = INT8_SWEEP_FRAMES // 2
    scenes = SyntheticScenes(cfg, seed=61, num_scenes=half, u8=True).fixed_batch(half)
    frames = np.concatenate([scenes["image_t"], scenes["image_s"]])

    # (1) the int8 conv at every quantized shape of the depth net, batch 16.
    model = DepthVO.from_random(cfg, seed=0, device=dev).calibrate_int8(frames[:32])
    shapes = _quant_conv_shapes(model, frames[:INT8_BATCH])
    rows = _int8_conv_rows(shapes, dev)
    out["int8_conv"] = {
        "route": "library (cuBLASLt int8 GEMM over an im2col), not a TPU kernel",
        "source": "depthvo_tpu_torch/ops/int8_conv.py", "distinct_shapes": len(rows),
        "layers": sum(r["layers"] for r in rows), "all_bit_equal": True,
        "int8_us_sum": sum(r["int8_us"] * r["layers"] for r in rows),
        "cudnn_bf16_us_sum": sum(r["cudnn_bf16_us"] * r["layers"] for r in rows),
        "bound_us_sum": sum(r["bound_us"] * r["layers"] for r in rows),
        "rows": rows}

    # (2) throughput: the int8 and the bfloat16 sweep of the same frames,
    # in turns, batch 16; busy share and peak of the int8 sweep.
    def sweep():
        t0 = time.perf_counter()
        d = runner.predict_depths(model, frames, INT8_BATCH)
        return d, time.perf_counter() - t0

    runner.predict_depths(model, frames[:INT8_BATCH], INT8_BATCH)
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    int8_conv.reset_calls()
    q_depth, q_s = sweep()
    peak = torch.cuda.max_memory_allocated()
    calls = int8_conv.CALLS
    if calls < len(model.models.depth.quant_convs()) * INT8_SWEEP_FRAMES // INT8_BATCH:
        raise AssertionError(f"the int8 sweep made {calls} _int_mm calls")
    if not (np.isfinite(q_depth).all() and q_depth.shape == (INT8_SWEEP_FRAMES, h, w)):
        raise AssertionError(f"int8 sweep: shape {q_depth.shape}, finite "
                             f"{np.isfinite(q_depth).all()}")
    traced = _traced_call(lambda: runner.predict_depths(model, frames, INT8_BATCH),
                          INT8_SWEEP_FRAMES // INT8_BATCH)
    # In turns: bfloat16, int8 again (the same scales seated), bfloat16.
    quant = model.quant
    model.uncalibrate()
    runner.predict_depths(model, frames[:INT8_BATCH], INT8_BATCH)
    f_depth, f_s = sweep()
    model.set_quant(quant)
    q_depth2, q_s2 = sweep()
    model.uncalibrate()
    f_depth2, f_s2 = sweep()
    if not np.array_equal(f_depth2, f_depth) or not np.array_equal(q_depth2, q_depth):
        raise AssertionError("uncalibrate / set_quant do not give back the same depth")
    rel = np.abs(q_depth - f_depth) / f_depth
    out["sweep"] = {
        "frames": INT8_SWEEP_FRAMES, "int8_frames_per_s": [INT8_SWEEP_FRAMES / q_s,
                                                           INT8_SWEEP_FRAMES / q_s2],
        "bf16_frames_per_s": [INT8_SWEEP_FRAMES / f_s, INT8_SWEEP_FRAMES / f_s2],
        "bf16_frames_per_s_phase_eval": fixtures["sweep_frames_per_s"],
        "int8_peak_allocated_bytes": peak, "live_before_bytes": live,
        "int8_peak_above_live_bytes": peak - live, "int_mm_calls": calls,
        "int8_traced": {k: traced[k] for k in ("kernels_per_step", "device_busy_ms_per_step",
                                               "traced_wall_ms_per_step", "device_busy_share")},
        "uncalibrate_bit_for_bit": True,
        "int8_vs_bf16_depth_rel_median": float(np.median(rel)),
        "int8_vs_bf16_depth_rel_p99": float(np.quantile(rel, 0.99))}
    del model

    # (3) calibration and the int8 depth, card against CPU (float32, TF32
    # off): the a_max trees (<= 2e-5 relative: float convolutions in
    # another order), then the int8 depth with the CPU's scales seated on
    # the card. The int8 path gives the same bits on both devices (the
    # scales are made on the CPU, BatchNorm and the normalisation divide
    # as the CPU does), so only the float disparity heads differ:
    # <= 1e-5 relative, and within the reference's int8 bar. With each
    # device's own scales a code flips where an activation sits on a
    # rounding edge and the flips compound: recorded.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    calib = frames[:8]
    probe = frames[8:12]
    card = DepthVO.from_random(cfg32, seed=0, device=dev).calibrate_int8(calib)
    cpu = DepthVO.from_random(cfg32, seed=0, device="cpu").calibrate_int8(calib)
    qa, qc = _flat_quant(card.quant), _flat_quant(cpu.quant)
    a_rel = max(abs(qa[k] - qc[k]) / qc[k] for k in qc)
    if set(qa) != set(qc) or not a_rel <= A_MAX_RTOL:
        raise AssertionError(f"a_max card vs CPU: {a_rel}")
    d_cpu = cpu.depth(probe)
    d_own = card.depth(probe)
    card.set_quant(cpu.quant)
    d_card = card.depth(probe)
    same_rel = float(np.max(np.abs(d_card - d_cpu) / d_cpu))
    if not (same_rel <= INT8_SAME_SCALES_RTOL
            and np.allclose(d_card, d_cpu, rtol=INT8_RTOL, atol=INT8_ATOL)):
        raise AssertionError(f"int8 depth card vs CPU, the same scales: {same_rel}")
    own = np.abs(d_own - d_cpu) / d_cpu
    out["card_vs_cpu"] = {
        "a_max_max_rel": a_rel, "convs": len(qa),
        "int8_depth_same_scales_max_rel": same_rel,
        "int8_depth_same_scales_bit_equal_share": float(np.mean(d_card == d_cpu)),
        "int8_depth_own_scales_max_rel": float(own.max()),
        "int8_depth_own_scales_median_rel": float(np.median(own)),
        "tolerance": {"a_max_rel": A_MAX_RTOL, "same_scales_rel": INT8_SAME_SCALES_RTOL,
                      "rtol": INT8_RTOL, "atol": INT8_ATOL}}
    del cpu

    # (4) export-serving: the float32 and the int8 artifact written and
    # loaded on the card; batches 1, 4 and 16 through one symbolic
    # artifact against DepthVO.depth; an artifact exported on the CPU
    # served on the card.
    tmp = fixtures["tmp"].name
    f32 = DepthVO.from_random(cfg32, seed=0, device=dev)
    exports = {}
    for name, mdl in (("f32", f32), ("int8", card)):
        path = os.path.join(tmp, f"{name}.depthvo.pt2")
        t0 = time.perf_counter()
        side = serving.export_depth(mdl, path)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = serving.load(path)
        load_s = time.perf_counter() - t0
        errs = {}
        for b in (1, 4, 16):
            x = frames[:b]
            got, want = served(x), mdl.depth(x)
            errs[b] = float(np.max(np.abs(got - want) / want))
            ok = (np.allclose(got, want, rtol=INT8_RTOL, atol=INT8_ATOL) if name == "int8"
                  else errs[b] <= ARTIFACT_RTOL)
            if got.shape != (b, h, w) or not ok:
                raise AssertionError(f"{name} artifact at batch {b}: {got.shape}, {errs[b]}")
        lat = []
        for _ in range(5):
            t0 = time.perf_counter()
            served(frames[:INT8_BATCH])
            lat.append((time.perf_counter() - t0) * 1e3)
        if side["int8"] != (name == "int8") or side["checked_on"] != ["cpu", "cuda"]:
            raise AssertionError(f"{name} sidecar {side}")
        exports[name] = {"artifact_bytes": side["artifact_bytes"], "export_seconds": export_s,
                         "load_seconds": load_s, "max_rel_by_batch": errs,
                         "latency_ms_batch16_median": statistics.median(lat)}
    path = os.path.join(tmp, "cpu.depthvo.pt2")
    t0 = time.perf_counter()
    side = serving.export_depth(DepthVO.from_random(cfg32, seed=0, device="cpu"), path,
                                platforms=("cpu",))
    export_s = time.perf_counter() - t0
    got, want = serving.load(path, device="cuda")(frames[:4]), f32.depth(frames[:4])
    cpu_rel = float(np.max(np.abs(got - want) / want))
    if not cpu_rel <= ARTIFACT_RTOL:
        raise AssertionError(f"CPU-exported artifact on the card: {cpu_rel}")
    exports["exported_on_cpu_served_on_card"] = {"max_rel": cpu_rel,
                                                 "export_seconds": export_s,
                                                 "artifact_bytes": side["artifact_bytes"]}
    out["export_serving"] = exports
    del f32, card

    # (5) cli eval-depth --int8 (float32, TF32 off) and infer --int8 on
    # phase eval's tree.
    common = ["eval-depth", "--kitti-root", fixtures["root"], "--split-file",
              fixtures["split"], "--checkpoint-dir", fixtures["ck32"], "--device", "cuda"]
    int8_conv.reset_calls()
    table, table_s = _cli_json(common + ["--int8"])
    if (table["quant"] != "int8" or table["split"].get("int8") is not True
            or int8_conv.CALLS == 0
            or not all(math.isfinite(table[k]) for k in ("abs_rel", "rmse", "a1"))):
        raise AssertionError(f"eval-depth --int8: {table}")
    torch.backends.cudnn.allow_tf32 = True
    names = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
    images = fixtures["images"]
    infer_out = os.path.join(tmp, "infer_int8")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(["infer", "--variant", variant, "--images", images, "--output-dir",
                       infer_out, "--device", "cuda", "--int8"])
    text = printed.getvalue()
    if rc != 0 or "int8: calibrated" not in text:
        raise AssertionError(f"cli infer --int8: rc {rc}, {text}")
    fr = load_images_u8([os.path.join(images, n) for n in fixtures["infer_names"]], h, w)
    model = DepthVO.from_random(cfg, seed=0, device=dev).calibrate_int8(fr)
    padded = np.concatenate([fr, np.repeat(fr[-1:], (-len(fr)) % INT8_BATCH, 0)])
    want = np.concatenate([model.depth(padded[i:i + INT8_BATCH])
                           for i in range(0, len(padded), INT8_BATCH)])[:len(fr)]
    got = np.stack([np.load(os.path.join(infer_out, os.path.splitext(n)[0] + "_depth.npy"))
                    for n in fixtures["infer_names"]])
    if not np.allclose(got, want, rtol=INT8_RTOL, atol=INT8_ATOL):
        raise AssertionError(f"infer --int8 vs DepthVO.depth: {np.abs(got - want).max()}")
    fps = re.search(r"\(([\d.]+) frames/s steady", text)
    out["cli"] = {"eval_depth_int8": {k: table[k] for k in names}, "eval_depth_seconds": table_s,
                  "infer_int8_frames_per_s_steady": float(fps.group(1)),
                  "infer_int8_vs_depth_vo_max_rel": float(np.max(np.abs(got - want) / want))}
    del model
    fixtures["tmp"].cleanup()
    emit(out)


def _flat_quant(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_quant(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = float(v)
    return out


CAFFE_TRAIN_NET = """
name: "depth_odometry_feat_train"
layer {
  name: "data" type: "ImageData" top: "img_L" top: "img_R"
  transform_param { scale: 1.0 mean_value: 104.0 mean_value: 117.0 mean_value: 123.0 }
  image_data_param { source: "train_list.txt" batch_size: 4 new_height: 160 new_width: 608 }
}
layer { name: "conv1" type: "Convolution" bottom: "img_L" top: "conv1"
        convolution_param { num_output: 32 kernel_size: 7 stride: 2 } }
layer { name: "fc_pose" type: "InnerProduct" bottom: "conv1" top: "se3"
        inner_product_param { num_output: 6 } }
layer { name: "inverse_warp" type: "Python" bottom: "img_R" bottom: "se3" top: "warped_L" }
layer { name: "stereo_photo_loss" type: "L1Loss" bottom: "warped_L" bottom: "img_L"
        loss_weight: 1.0 }
layer { name: "temporal_photo_loss" type: "L1Loss" bottom: "warped_L" bottom: "img_L"
        loss_weight: 1.0 }
layer { name: "feat_recon_loss" type: "L1Loss" bottom: "warped_feat" bottom: "feat_L"
        loss_weight: 0.1 }
layer { name: "smooth_loss" type: "SmoothnessLoss" bottom: "disp" loss_weight: 0.05 }
"""
CAFFE_SOLVER = """net: "train.prototxt"
base_lr: 0.001
lr_policy: "step"
gamma: 0.5
stepsize: 80000
max_iter: 200000
momentum: 0.9
momentum2: 0.999
type: "Adam"
"""


def phase_caffe(variant: str, dev, smi: str):
    """The Caffe weight tools (A.7) at the variant's width, in a temporary
    directory: ``export-caffemodel`` of each net of a checkpoint, then
    ``import-caffemodel`` of the depth net's file into a fresh checkpoint:
    its depth net equal to the source's tensor for tensor, and
    ``DepthVO.depth`` of both on the card bit for bit (float32, TF32
    off); ``net-info`` and ``convert`` (solver + train graph + the three
    files) exit 0."""
    import os
    import tempfile

    import numpy as np
    import torch

    from depthvo_tpu_torch import DepthVO, cli, configs
    from depthvo_tpu_torch.configs import base as config_base
    from depthvo_tpu_torch.data.synthetic import SyntheticScenes
    from depthvo_tpu_torch.io import checkpoint as ckpt
    from depthvo_tpu_torch.train import state as tstate

    cfg32 = _f32_config(getattr(configs, variant)(batch_size=BATCH))
    out = {"phase": "caffe", "config": variant, "nvidia_smi": smi}
    tmp = tempfile.TemporaryDirectory(prefix="caffe-")
    path = lambda *p: os.path.join(tmp.name, *p)  # noqa: E731
    src = path("src")
    ckpt.save(ckpt.make_manager(src), tstate.create_state(cfg32, torch.device("cpu"),
                                                          torch.Generator().manual_seed(3)))
    config_base.save_json(cfg32, os.path.join(src, "config.json"))

    def run(argv) -> tuple[int, float, str]:
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(argv)
        return rc, time.perf_counter() - t0, printed.getvalue()

    files = {}
    for net in ("depth", "odom", "feat"):
        f = path(f"{net}.caffemodel")
        rc, secs, text = run(["export-caffemodel", "--checkpoint-dir", src, "--net", net,
                              "--output", f])
        if rc != 0:
            raise AssertionError(f"export-caffemodel --net {net}: rc {rc}, {text[-500:]}")
        files[net] = {"bytes": os.path.getsize(f), "seconds": secs}
    dst = path("dst")
    rc, secs, text = run(["import-caffemodel", "--variant", variant, "--caffemodel",
                          path("depth.caffemodel"), "--checkpoint-dir", dst])
    if rc != 0:
        raise AssertionError(f"import-caffemodel: rc {rc}, {text[-500:]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    a = DepthVO.from_checkpoint(src, device=dev)
    b = DepthVO.from_checkpoint(dst, cfg32, device=dev)
    sa, sb = a.models.depth.state_dict(), b.models.depth.state_dict()
    unequal = [k for k in sa if not torch.equal(sa[k], sb[k])]
    images = SyntheticScenes(cfg32, seed=71, num_scenes=BATCH, u8=True).fixed_batch(
        BATCH)["image_t"]
    da, db = a.depth(images), b.depth(images)
    if unequal or set(sa) != set(sb) or not np.array_equal(da, db):
        raise AssertionError(f"caffemodel round trip: {len(unequal)} tensors differ "
                             f"({unequal[:4]}), depth max diff {np.abs(da - db).max()}")
    torch.backends.cudnn.allow_tf32 = True
    out["round_trip"] = {"files": files, "import_seconds": secs,
                         "depth_tensors_equal": len(sa), "depth_bit_equal": True,
                         "depth_shape": list(da.shape)}
    with open(path("train.prototxt"), "w") as f:
        f.write(CAFFE_TRAIN_NET)
    with open(path("solver.prototxt"), "w") as f:
        f.write(CAFFE_SOLVER)
    rc_info, _, info = run(["net-info", path("train.prototxt")])
    rc_conv, conv_s, conv = run(
        ["convert", "--solver", path("solver.prototxt"), "--variant", variant,
         "--output-dir", path("converted")]
        + [a for net in ("depth", "odom", "feat")
           for a in ("--weights", f"{net}={path(net + '.caffemodel')}")])
    if rc_info != 0 or "kind=train_graph" not in info or rc_conv != 0:
        raise AssertionError(f"net-info rc {rc_info}, convert rc {rc_conv}: {conv[-800:]}")
    conv_model = DepthVO.from_checkpoint(path("converted", "checkpoint"), device=dev)
    d = conv_model.depth(images)
    if not np.isfinite(d).all():
        raise AssertionError("convert's checkpoint gives non-finite depth")
    out["net_info_rc"] = rc_info
    out["convert"] = {"rc": rc_conv, "seconds": conv_s,
                      "optimizer": conv_model.config.optim.optimizer,
                      "mean_folded": "(mean/scale folded)" in conv}
    tmp.cleanup()
    emit(out)


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
    phase_slice("full_feat", dev)
    train_launches, premade_ms = phase_train("full_feat", dev)
    phase_scan("full_feat", dev, smi)
    phase_kitti_ckpt("full_feat", dev, smi, premade_ms)
    fixtures = phase_eval("full_feat", dev, smi)
    phase_int8_serving("full_feat", dev, smi, fixtures)
    phase_caffe("full_feat", dev, smi)
    phase_serve(dev)

    summary = []
    pallas = "depthvo_tpu/ops/warp_pallas.py"
    for kernel, replaces in (
        ("stereo_fwd", f"{pallas}:102"),
        ("stereo_bwd_u", f"{pallas}:126"),
        ("stereo_bwd_src", f"{pallas}:148"),
        ("gen_fwd", f"{pallas}:523"),
        ("gen_fwd_aux", f"{pallas}:523"),
        ("gen_bwd_uv", f"{pallas}:651"),
    ):
        mine = [r for r in rows if r["kernel"] == kernel]
        grouped = [r for r in mine if r.get("pyramid")]
        # Per step or batch of the main path: the grouped launches where
        # the path makes them (beside its segments' one-segment launches
        # timed together), else one launch at each shape, summed.
        timed = grouped or mine
        summary.append({
            "name": kernel, "route": "cuda",
            "source": "depthvo_tpu_torch/ops/csrc/warp.cu", "replaces": replaces,
            # Launches per step of the main path, `cli train`. On its
            # custom VJPs, stereo_bwd_src runs only for a stereo source
            # that needs a gradient and gen_fwd_aux not at all (the
            # backward recomputes the factors in gen_bwd_uv); the main
            # path launches neither.
            "path": "cli train", "launches": train_launches[kernel],
            "max_abs_err": max(max(r["max_abs_err"], r.get("ragged_max_abs_err", 0.0))
                               for r in mine),
            "ms": sum(r["ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed),
            "bound_ms": sum(r["bound_ms"] for r in timed),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in timed) else "operations",
            "library_ms": sum(r["library_ms"] for r in timed),
        } | ({"per_scale_ms": grouped[0]["per_scale_ms"]} if grouped else {}))
    print(smi, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
