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
             together and the summed byte bound. Then the global
             BatchNorm's four kernels (``ops/csrc/batch_norm.cu``: bn_stats,
             bn_normalize, bn_bwd_reduce, bn_bwd_elemt) at the 53 layer
             shapes of the step (forward hooks on the DepthNet), float32
             and bf16 from the same random data with channel 0 constant,
             each downstream kernel fed the kernel's own upstream buffer:
             the sums within BN_SUM_TOL of sum |x| (sum x^2, sum |g|, sum
             |g xhat|) per channel and the counts equal, the running
             averages within BN_RUNNING_TOL of their max, y and dx within
             BN_F32_TOL of their max (float32) or BN_BF16_ULPS bf16 units
             in the last place (bit for bit), also with channel 0's sum of
             squares cut so that its variance is clamped; the device time of each per step (all 53
             layers) beside its plain version, SyncBatchNorm's library
             calls for the same function (``batch_norm_stats`` +
             ``batch_norm_gather_stats_with_counts``, ``batch_norm_elemt``,
             ``batch_norm_backward_reduce``, ``batch_norm_backward_elemt``;
             timed only, never called by the port) and the byte bound.
   border  - Monodepth2's border warp (``gen_fwd_border``,
             ``gen_bwd_uv_border``) against ``F.grid_sample`` and its
             backward at 12x3x320x1024; kernel, library, K4/K5 and bound ms.
   reproj  - Monodepth2's reprojection error (``reproj_fwd``,
             ``reproj_bwd``) against its plain versions on
             the card at 12x3x320x1024, 12x3x192x640, 2x3x5x17 and four
             small shapes whose bands and tiles end one row or column
             past a multiple (and on the CPU at the small ones), on smooth images with flat patches, an
             edge and pixels equal to the target, and on uniform noise: the
             forward <= REPROJ_TOL absolute, the gradient <= REPROJ_GRAD_RTOL
             of its largest magnitude, two launches equal bit for bit; at
             the first two shapes the kernels' device us beside their byte
             bound and the plain composition's forward and forward with
             backward.
   md2_bn  - Monodepth2's encoder BatchNorm (``ops/md2_batch_norm.py``:
             md2_bn_stats, md2_bn_normalize, md2_bn_bwd_reduce,
             md2_bn_bwd_elemt) at the step's five BatchNorm shapes (batch
             12) and two ragged ones, bf16 and float32, with and without the
             ReLU, on random data whose channel 0 has a mean 10^3 times its
             standard deviation: mean and rstd against the plain version
             within MD2_BN_STAT_TOL (mean in standard deviations, rstd
             relative), the running averages within MD2_BN_RUNNING_RTOL,
             [dweight | dbias] within MD2_BN_SUM_TOL of sum |g' xhat| and
             sum |g'|, y and dx equal to the plain versions bit for bit on
             the kernels' own statistics and sums; the backward's ReLU mask
             equal to the forward's (sum g' with integer g, exact, against
             the forward's y > 0); two replays of a CUDA graph of the four
             launches equal bit for bit. Then each kernel's device us beside
             its byte bound and its plain version's, and the library's
             ``native_batch_norm`` + ReLU forward and ReLU +
             ``native_batch_norm_backward`` (timed only, never called by the
             port), per shape and over the step's 60 layers.
   md2     - ``cli train --variant monodepth2_ms`` (8 steps a call): 12
             border warps and 15 reprojection errors forward, 12 of each
             backward, and 60 launches of each md2_bn kernel, a step; no
             PyTorch BatchNorm kernel in a traced call; the graphed step's
             ms, peak bytes and the kernels that take most of its device
             time.
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
             counted); then ``unroll`` 2 and 4 (``lax.scan``'s argument,
             which replays the one-step graph) against ``unroll`` 1, bit
             for bit in every state tensor and the last metrics, at K=8,
             K=7 and K=8 with iter_size 2, K x the step's launches each;
             (2) the default (bfloat16) config at batch 4 on pre-made
             batches already on the card: eager steps and graph K=8,
             five calls of 8 steps each, ms/step untraced (median of the
             calls after the first), the peak allocated bytes of the
             first call and of the rest, the bytes of the graph's private
             pool, what each mode leaves allocated once freed (before and
             after clearing cuBLAS's workspaces), and one traced call each:
             every warp kernel K x the
             train phase's launches per step in the profiler's trace and
             in the counters, kernels per step, device busy ms per step
             and share of the traced wall; (3) ``cli train --kitti-root
             ... --native-ring 1 --steps-per-call 8`` on phase
             kitti_ckpt's tree (written anew): 17 steps (1 eager step and
             7 replays, 8 replays, an exact tail of 1) with the train
             phase's launches per step and logs at steps 7 and 16; the
             ms/step after the first call, also over 65 steps, beside the
             host ring's ms per batch.
7. learn   - the port learns (tests/test_metric_learning.py at full width):
             400 steps of the default (bfloat16) full_feat step at 608x160,
             batch 4, as 50 calls of K=8 through the CUDA graph, adam at
             1e-3 with a 10-step warmup, on the fixed batch of
             ``SyntheticScenes(seed=3, num_scenes=4)`` held on the card;
             every loss term after 0, 200 and 400 steps; before and after,
             depth abs_rel (median scaled) and the log-depth correlation
             against the scenes' true depth and the odometry's translation
             and rotation errors (``eval.synthetic``, the protocol of
             benchmarks/feat_ab.py); the median ms/step, the graph's pool
             and the peak after call 1 and call 50, the warp launches per
             step, beside the reference's TPU record (a record, not a
             target). Gates: finite losses, abs_rel falls and ends <= 0.15,
             log-corr >= 0.90, every scene's translation error <= 20% of
             its true translation, exactly 1/2/1/4 K1/K2/K4/K5 launches per
             step, the pool after call 50 equal to the pool after call 1.
             Then the same run in float32 with TF32 off, recorded beside it.
8. kitti_ckpt - the training path users run, in a temporary directory: a
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
9. orbax   - a run of the JAX package moves to the card: whether
             ``tensorstore`` can be imported here (the reader needs none);
             ``io.orbax_reader.read_tree`` of the committed reference
             checkpoint (``tests/data/reference_orbax_full_feat``, a
             full_feat train state at step 1234, Adam) with every leaf
             equal bit for bit to its numpy regeneration
             (``tests/data/reference_orbax.py``), and the read's seconds
             and decoded MB/s;
             ``maybe_restore`` of it into a full_feat state on the card:
             the step, Adam's count and every parameter, BatchNorm
             statistic and moment seated exactly; 8 bfloat16 steps from it
             under the CUDA graph (K=8): finite, 1/2/1/4 launches per
             step; ``cli train --init-from`` it (2 steps, exit 0, finite,
             the train phase's launches) and ``cli test --checkpoint-dir``
             it (exit 0, finite terms).
10. eval    - the eval runner and the rest of DepthNet, in a temporary
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
11. int8_serving - w8a8 serving and the serving export (A.6) at 608x160:
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
12. caffe  - the Caffe weight tools (A.7) at 608x160: ``export-caffemodel``
             of each net of a checkpoint, ``import-caffemodel`` of the depth
             file into a fresh checkpoint (every depth tensor equal, and
             ``DepthVO.depth`` on the card bit for bit, float32, TF32 off);
             ``net-info`` of a train graph and ``convert`` (solver + graph +
             the three files) exit 0, with finite depth from the converted
             checkpoint.
13. dp     - data parallelism (A.8), full_feat 608x160, global batch 4. The
             machine has one H100, so (1) an NCCL group of one: the mesh
             step against ``mesh=None`` (float32, TF32 off, cuDNN
             deterministic) to the train phase's bars (no full_feat
             gradient is stable under 1e-6 noise at batch 4, so all are
             held as one vector within 4x that spread); on the default
             bfloat16 config (cuDNN deterministic) 4 steps through the graph
             (collectives captured) against 4 eager steps bit for bit; the
             warp launches (1/2/1/4), the BatchNorm kernels' launches
             (each once per layer, in the counters and in a profiler
             trace) and the all-reduces per eager step (3 + 2 per
             BatchNorm); ms/step under the graph (K=8) with the mesh and
             without, in turns, with kernels, device busy ms and the
             graph's pool per step and what the mesh adds to each, and
             the BatchNorm kernels K x per call under replay (none
             without the mesh); ``fit`` over the mesh with checkpoints
             and K=2 (stopped at 3, resumed to 5); the main path, what
             each rank of ``cli train --num-devices N`` runs
             (``cli._rank_main``), counts reset just before and read just
             after: 1/2/1/4 warp launches and each BatchNorm kernel once
             per layer per step;
             (2) two gloo ranks sharing the card, each on half of the
             global batch for 2 eager float32 steps, held against one rank
             on the global batch and equal to each other bit for bit; then
             three gloo ranks, every one making ``make_mesh(2)``: the mesh
             over ranks [0, 1] (a subgroup) takes the same steps to the
             two-rank run's state bit for bit, and rank 2, outside it, is
             refused by ``make_train_step``, ``make_scan_train_step`` and
             ``fit`` and keeps its state; (3)
             ``cli train --num-devices 2 --device cpu`` (tiny_test) exits 0
             with the coordinator's 2 log lines, and ``cli train`` on the
             card without ``--num-devices`` takes one device and the plain
             path (no process group, 1/2/1/4 launches per step, no
             BatchNorm kernel); (4)
             ``predict_depths`` over a mesh of one replica equals
             ``mesh=None`` bit for bit.
14. pretrain_feat - feature pretraining (A.9) at 608x160, batch 4: the
             InfoNCE loss on the card against the CPU on the same weights
             and views (float32, TF32 off, <= 1e-4 relative); ``cli
             pretrain-feat --steps 5`` then ``cli train --init-feat-from``
             for 2 steps: exit 0 and the trained checkpoint's feature net
             is the pretrained one; ms per bfloat16 pretrain step.
15. bench  - the reference's tooling and surface (A.10-A.13) at 608x160,
             batch 4: ``cli device-query`` (rc 0; name, capability, SM
             count and memory equal ``torch.cuda.get_device_properties``);
             ``cli bench --mode train_step`` and ``train_step_scan`` with
             exactly 1 stereo_fwd, 2 stereo_bwd_u, 1 gen_fwd and 4
             gen_bwd_uv launches per step run (K per call under replay),
             their ms/step, frames/s, ``flops_per_step`` and ``mfu``, the
             scan mode within 15% of phase scan's graph ms/step and the
             eager mode beside phase train's; ``--trace-dir`` on
             ``train_step``: the four kernels' names in the Chrome trace;
             ``depth_infer`` (bf16, ``--int8``), ``odom_infer`` and
             ``warp`` frames/s; ``depth_layer_table`` on four boundaries
             and ``cli bench --mode odom_layers`` / ``feat_layers``: the
             reference's row names, no negative time, monotone
             cumulatives; the NHWC ``ops.stereo_warp`` with a
             differentiated source (1 stereo_fwd + 1 stereo_bwd_src) and
             ``ops.frozen_warp`` with a differentiated depth (1 gen_fwd +
             1 gen_bwd_uv), f32, against the CHW path everywhere and the
             plain versions on the same coordinates and cotangent under
             ``valid``, forward and gradient: 0.0; ``cli train --iter-size
             2 --remat --debug-nans --steps 4 --steps-per-call 2`` exits 0
             under the graph; ``--debug-nans`` on a ``--config`` whose
             learning rate turns infinite at update 2 raises
             ``FloatingPointError`` after step 3 with only checkpoint 2
             written; ``--tensorboard`` writes events, or raises the
             reference's ``ModuleNotFoundError`` without the package.
16. serve  - ``DepthVO.from_random(full_feat())``: depth of a (4,160,608,3)
             uint8 batch and pose of its frame pairs; shapes, finiteness
             and latency.

The last three lines are the nvidia-smi line, the ``{"kernels": [...]}``
summary (launches in the main path's run, ``cli train``; for
stereo_fwd and gen_fwd the grouped launch's times, for stereo_bwd_u the
path's two launches; for the four BatchNorm kernels the launches in the
2-step run of ``cli train --num-devices N``'s rank body, and per step,
and the bf16 times over the 53 layers) and
``{"ok": true, "device": {...}}``. Without a GPU the script
exits with code 1 and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time

# The package's kernel tables and launch ledger, its CUDA-graph replay
# timer (every kernel time below) and its profiler-trace reduction.
from depthvo_tpu_torch import ops
from depthvo_tpu_torch.ops import _build, batch_norm as bn, md2_batch_norm as mbn, reproj as rp
from depthvo_tpu_torch.ops import warp_kernels as wk
from depthvo_tpu_torch.utils import profiling
from depthvo_tpu_torch.utils.profiling import device_ms

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
# The global BatchNorm's kernels against their plain versions: the sums
# relative to sum |x| (sum x^2, sum |g|, sum |g xhat|) per channel (another
# order of float32 sums; measured <= 2.4e-7 on an H100, PERF.md), the
# running averages relative to their max, y and dx relative to their max
# in float32 and in bf16 units in the last place: bit for bit, since both
# take the same statistics through the same correctly rounded ops.
BN_SUM_TOL = 1e-6
BN_RUNNING_TOL = 0.0
BN_F32_TOL = 0.0
BN_BF16_ULPS = 0.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
                name = re.search(r"\d+([a-z_][a-z0-9_]*_kernel)", mangled).group(1)
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

    from depthvo_tpu_torch.configs.base import stereo_dmax
    from depthvo_tpu_torch.data.synthetic import SyntheticScenes
    from depthvo_tpu_torch.geometry import se3
    from depthvo_tpu_torch.geometry.camera import scale_intrinsics
    from depthvo_tpu_torch.models.layers import resize_bilinear_chw

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
    rows += _bn_rows(cfg, dev)
    emit({"phase": "kernels", "shapes": rows})
    return rows


# The border warp against the library's grid_sample on the card: absolute on
# images in [0, 1] (the same float32 formula in another order of the taps'
# products is ~1e-7); the gradients relative to their largest magnitude.
BORDER_TOL = 1e-6
BORDER_GRAD_RTOL = 1e-5


def phase_border(dev):
    """The border-padded general warp (Monodepth2's; ``gen_fwd_border`` and
    ``gen_bwd_uv_border``) against its plain version (``F.grid_sample``
    with border padding and its backward, on the card and, for two rows,
    on the CPU) at the monodepth2_ms step's shape, one source and scale:
    12 x 3 x 320 x 1024, a third of the samples outside the image, some far
    outside and some exactly on its edges. Timed with K4 and K5 at the same
    shape and coordinates in pixels (the other design: a mode of those
    kernels) and the library."""
    import torch

    B, C, H, W = 12, 3, 320, 1024
    g = torch.Generator(device=dev).manual_seed(19)
    src = torch.rand(B, C, H, W, generator=g, device=dev)
    gx = torch.rand(B, H, W, generator=g, device=dev) * 3.0 - 1.5
    gy = torch.rand(B, H, W, generator=g, device=dev) * 3.0 - 1.5
    gx[:, 0, :6] = torch.tensor([-1.0, 1.0, -1e4, 1e4, 0.0, -1.0], device=dev)
    gy[:, 0, :6] = torch.tensor([1.0, -1.0, 5e3, -5e3, -1.0, 0.0], device=dev)
    cot = torch.rand(B, C, H, W, generator=g, device=dev) - 0.5
    out = wk.border_sample_cuda(src, gx, gy)
    again = wk.border_sample_cuda(src, gx, gy)
    d_gx, d_gy = wk.border_bwd_uv_cuda(src, cot, gx, gy)
    w_gx, w_gy = wk.border_bwd_uv_plain(src, cot, gx, gy)
    cpu = [t[:2].cpu() for t in (src, cot, gx, gy)]
    c_gx, c_gy = wk.border_bwd_uv_plain(*cpu)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    clipped = ((gx <= -1) | (gx >= 1))
    row = {
        "phase": "border", "shape": [B, C, H, W],
        "fwd_max_abs_err": float((out - wk.border_sample_plain(src, gx, gy)).abs().max()),
        "fwd_cpu_max_abs_err": float((out[:2].cpu() - wk.border_sample_plain(
            cpu[0], cpu[2], cpu[3])).abs().max()),
        "fwd_bitwise_repeat": bool(torch.equal(out, again)),
        "bwd_rel_err": max(rel(d_gx, w_gx), rel(d_gy, w_gy)),
        "bwd_cpu_rel_err": max(rel(d_gx[:2].cpu(), c_gx), rel(d_gy[:2].cpu(), c_gy)),
        "clipped_grad_zero": bool((d_gx[clipped] == 0).all()),
    }
    assert row["fwd_max_abs_err"] <= BORDER_TOL and row["fwd_cpu_max_abs_err"] <= BORDER_TOL, row
    assert row["bwd_rel_err"] <= BORDER_GRAD_RTOL, row
    assert row["bwd_cpu_rel_err"] <= BORDER_GRAD_RTOL, row
    assert row["fwd_bitwise_repeat"] and row["clipped_grad_zero"], row
    u = ((gx.clamp(-1, 1) + 1) * 0.5 * (W - 1)).contiguous()
    v = ((gy.clamp(-1, 1) + 1) * 0.5 * (H - 1)).contiguous()
    pix, maps = B * H * W, B * C * H * W
    fwd_bound, by = bound_ms(4 * (2 * maps + pix), 0)
    bwd_bound, _ = bound_ms(4 * (2 * maps + 2 * pix), 0)
    row.update({
        "fwd_ms": device_ms(lambda: wk.border_sample_cuda(src, gx, gy)),
        "fwd_library_ms": device_ms(lambda: wk.border_sample_plain(src, gx, gy)),
        "fwd_k4_ms": device_ms(lambda: wk.gen_sample_cuda(src, u, v)),
        "fwd_bound_ms": fwd_bound,
        "bwd_ms": device_ms(lambda: wk.border_bwd_uv_cuda(src, cot, gx, gy)),
        "bwd_library_ms": device_ms(lambda: wk.border_bwd_uv_plain(src, cot, gx, gy)),
        "bwd_k5_ms": device_ms(lambda: wk.gen_bwd_uv_cuda(src, cot, u, v)),
        "bwd_bound_ms": bwd_bound, "bound_by": by,
    })
    emit(row)
    return row


# Monodepth2's reprojection error against its plain versions on the card:
# the forward absolute on images in [0, 1] (the kernel takes the
# composition's float32 operations in their order), the gradient relative to
# its largest magnitude (autograd's chain in its order; the plain version's
# reflection fold adds with atomics, so corner sums of four may round apart).
REPROJ_TOL = 1e-6
REPROJ_GRAD_RTOL = 1e-5


def _reproj_images(B: int, H: int, W: int, kind: str, dev):
    """(pred, target, g) on the card: ``smooth`` images (a coarse random
    field upsampled, a flat grey patch, a vertical edge; pred the target
    shifted by (1, 2) pixels and dimmed, with a band copied from the target
    exactly) or ``uniform`` noise; g standard normal (B, 1, H, W)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(20 + H + W)
    if kind == "uniform":
        pred = torch.rand(B, 3, H, W, generator=gen, device=dev)
        target = torch.rand(B, 3, H, W, generator=gen, device=dev)
    else:
        coarse = torch.rand(B, 3, max(2, H // 16), max(2, W // 16), generator=gen, device=dev)
        target = F.interpolate(coarse, size=(H, W), mode="bilinear", align_corners=False)
        target[..., : H // 3, : W // 3] = 0.5
        target[..., W // 2:] = (target[..., W // 2:] * 0.5 + 0.5)
        pred = (torch.roll(target, shifts=(1, 2), dims=(2, 3)) * 0.97 + 0.01).contiguous()
        pred[..., H // 2: H // 2 + max(1, H // 8), :] = target[..., H // 2: H // 2 + max(1, H // 8), :]
        target = target.contiguous()
    g = torch.randn(B, 1, H, W, generator=gen, device=dev)
    return pred, target, g


def phase_reproj(dev):
    """Monodepth2's reprojection error (``ops/reproj.py``): the two kernels
    against their plain versions, then their device time beside the byte
    bound (forward: pred and target read, one float written a pixel;
    backward: pred, target and g read, d pred written) and the plain
    composition's, forward alone and forward with autograd's backward."""
    import torch

    w = 0.85
    rows = []
    for (B, C, H, W) in ((12, 3, 320, 1024), (12, 3, 192, 640), (2, 3, 5, 17), (1, 3, 2, 2),
                         (1, 3, 3, 3), (2, 3, 17, 31), (1, 3, 33, 57)):
        row = {"phase": "reproj", "shape": [B, C, H, W]}
        for kind in ("smooth", "uniform"):
            pred, target, g = _reproj_images(B, H, W, kind, dev)
            out = rp.reproj_fwd_cuda(pred, target, w)
            again = rp.reproj_fwd_cuda(pred, target, w)
            d = rp.reproj_bwd_cuda(pred, target, g, w)
            d_again = rp.reproj_bwd_cuda(pred, target, g, w)
            want = rp.reproj_fwd_plain(pred, target, w)
            d_want = rp.reproj_bwd_plain(pred, target, g, w)
            torch.cuda.synchronize(dev)
            row[kind] = {
                "fwd_max_abs_err": float((out - want).abs().max()),
                "fwd_equal_share": float((out == want).float().mean()),
                "bwd_rel_err": float((d - d_want).abs().max() / d_want.abs().max()),
                "bwd_equal_share": float((d == d_want).float().mean()),
                "bitwise_repeat": bool(torch.equal(out, again) and torch.equal(d, d_again)),
            }
            if H * W < 1000:  # the CPU's plain versions too
                cpu = [t.cpu() for t in (pred, target, g)]
                row[kind]["fwd_cpu_max_abs_err"] = float(
                    (out.cpu() - rp.reproj_fwd_plain(cpu[0], cpu[1], w)).abs().max())
                d_cpu = rp.reproj_bwd_plain(*cpu, w)
                row[kind]["bwd_cpu_rel_err"] = float((d.cpu() - d_cpu).abs().max()
                                                     / d_cpu.abs().max())
            r = row[kind]
            assert r["fwd_max_abs_err"] <= REPROJ_TOL, row
            assert r["bwd_rel_err"] <= REPROJ_GRAD_RTOL, row
            assert r.get("fwd_cpu_max_abs_err", 0.0) <= REPROJ_TOL, row
            assert r.get("bwd_cpu_rel_err", 0.0) <= REPROJ_GRAD_RTOL, row
            assert r["bitwise_repeat"], row
        if H * W >= 1000:
            pred, target, g = _reproj_images(B, H, W, "smooth", dev)
            pix = B * H * W
            fwd_bound, by = bound_ms(4 * (2 * C * pix + pix), 0)
            bwd_bound, _ = bound_ms(4 * (3 * C * pix + pix), 0)
            leaf = pred.clone().requires_grad_(True)

            def plain_both():
                return torch.autograd.grad(rp.reproj_fwd_plain(leaf, target, w), leaf, g)

            row.update({
                "fwd_us": 1e3 * device_ms(lambda: rp.reproj_fwd_cuda(pred, target, w)),
                "bwd_us": 1e3 * device_ms(lambda: rp.reproj_bwd_cuda(pred, target, g, w)),
                "fwd_bound_us": 1e3 * fwd_bound, "bwd_bound_us": 1e3 * bwd_bound,
                "bound_by": by,
                "fwd_plain_us": 1e3 * device_ms(lambda: rp.reproj_fwd_plain(pred, target, w)),
                "fwd_bwd_plain_us": 1e3 * device_ms(plain_both),
                "bwd_plain_us": 1e3 * device_ms(lambda: rp.reproj_bwd_plain(pred, target, g, w)),
            })
            row["fwd_roofline"] = 100 * row["fwd_bound_us"] / row["fwd_us"]
            row["bwd_roofline"] = 100 * row["bwd_bound_us"] / row["bwd_us"]
        emit(row)
        rows.append(row)
    return rows


# Monodepth2's encoder BatchNorm against its plain versions on the card: the
# statistics in another order of float32 sums and merges (the mean in the
# channel's standard deviations, rstd relative), the running averages
# relative to their largest value, [dweight | dbias] relative to sum |g' xhat|
# and sum |g'| per channel (float32 sums in another order); y and dx bit for
# bit, since on the kernels' own statistics and sums both take the same
# correctly rounded operations.
MD2_BN_STAT_TOL = 1e-5
MD2_BN_RUNNING_RTOL = 1e-5
MD2_BN_SUM_TOL = 1e-5
# Cell A's BatchNorm inputs (batch 12 at 1024x320) and how many of the step's
# 60 layers take each (with the ReLU, without): the depth encoder once and
# the pose encoder twice, the ReLU after the stem's and every block's bn1.
MD2_BN_LAYERS = {(12, 64, 160, 512): (3, 0), (12, 64, 80, 256): (6, 6),
                 (12, 128, 40, 128): (6, 9), (12, 256, 20, 64): (6, 9),
                 (12, 512, 10, 32): (6, 9)}
# Ragged shapes: H * W not a multiple of the vector width; more channels
# than the grid's target, so one block a channel.
MD2_BN_RAGGED = ((3, 5, 7, 9), (2, 700, 3, 5))


def _md2_bn_data(shape, dtype, dev, seed: int) -> dict:
    """Random x (channel 0 at a mean 10^3 times its standard deviation), g,
    integer g in [1, 7], weight, bias and running averages on the card."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    N, C, H, W = shape
    x = (torch.randn(shape, device=dev, generator=gen)
         * (0.5 + 2 * torch.rand(1, C, 1, 1, device=dev, generator=gen))
         + 2 * torch.randn(1, C, 1, 1, device=dev, generator=gen))
    x[:, 0] = 1e3 + torch.randn(N, H, W, device=dev, generator=gen)
    return {"x": x.to(dtype), "g": torch.randn(shape, device=dev, generator=gen).to(dtype),
            "gi": torch.randint(1, 8, shape, device=dev, generator=gen).to(dtype),
            "w": 0.5 + torch.rand(C, device=dev, generator=gen),
            "b": 0.5 * torch.randn(C, device=dev, generator=gen),
            "rm": torch.randn(C, device=dev, generator=gen),
            "rv": 0.5 + torch.rand(C, device=dev, generator=gen)}


def _md2_bn_check(d: dict, relu: bool, m: float, eps: float) -> dict:
    """The four kernels on ``d`` against their plain versions; raises past
    a bar."""
    import torch

    x, g, w, b = d["x"], d["g"], d["w"], d["b"]
    C = x.shape[1]
    rk = (d["rm"].clone(), d["rv"].clone())
    y, save = mbn.normalize_cuda(x, mbn.stats_cuda(x), w, b, *rk, m, eps, relu)
    dx, dwb = mbn.bwd_elemt_cuda(g, x, save, w, b, mbn.bwd_reduce_cuda(g, x, save, w, b, relu),
                                 relu)
    mean, var, rstd = mbn.stats_plain(x, eps)
    want_run = (d["rm"] * (1 - m) + mean * m, d["rv"] * (1 - m) + var * m)
    gp, xhat = mbn._grad_in(g, x, save, w, b, relu)
    sum_scale = torch.cat([(gp * xhat).abs().sum((0, 2, 3)), gp.abs().sum((0, 2, 3))])
    # The backward's mask against the forward's: sum g' for integer g is
    # exact in float32 (under 2^24 a channel), so it equals the sum of g
    # where the forward's y > 0 unless one value's mask differs.
    gi = d["gi"]
    _, dwb_i = mbn.bwd_elemt_cuda(gi, x, save, w, b, mbn.bwd_reduce_cuda(gi, x, save, w, b, relu),
                                  relu)
    passed = y > 0 if relu else torch.ones_like(y, dtype=torch.bool)
    want_i = torch.where(passed, gi.double(), 0.0).sum((0, 2, 3))
    # The mean past four float32 roundings of its magnitude, in standard
    # deviations: a mean 10^3 times its deviation is held to what float32
    # can hold.
    slack = 4 * torch.finfo(torch.float32).eps * mean.abs()
    row = {
        "mean_err_std": float((((save[:C] - mean).abs() - slack).clamp_min(0)
                               / var.sqrt().clamp_min(1e-30)).max()),
        "rstd_rel_err": float(((save[C:] - rstd).abs() / rstd).max()),
        "channel0_mean_over_std": float(mean[0] / var[0].sqrt()),
        "running_rel_err": max(float((a - w_).abs().max() / w_.abs().max())
                               for a, w_ in zip(rk, want_run)),
        "sum_rel_err": float(((dwb - mbn.bwd_reduce_plain(g, x, save, w, b, relu)).abs()
                              / sum_scale.clamp_min(1e-30)).max()),
        "y_bitwise": bool(torch.equal(y, mbn.normalize_plain(x, save, w, b, relu))),
        "dx_bitwise": bool(torch.equal(dx, mbn.bwd_elemt_plain(g, x, save, w, b, dwb, relu))),
        "mask_equal": bool(torch.equal(dwb_i[C:].double(), want_i)),
        "masked_share": float(1 - passed.float().mean()),
    }
    # Two replays of a CUDA graph of the four launches: the same bits, and
    # the eager launches' bits.
    rg = (d["rm"].clone(), d["rv"].clone())

    def four():
        yy, ss = mbn.normalize_cuda(x, mbn.stats_cuda(x), w, b, *rg, m, eps, relu)
        return (yy, ss, *mbn.bwd_elemt_cuda(g, x, ss, w, b,
                                            mbn.bwd_reduce_cuda(g, x, ss, w, b, relu), relu))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        four()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = four()
    graph.replay()
    first = [o.clone() for o in outs]
    graph.replay()
    torch.cuda.synchronize()
    row["graph_bitwise"] = all(torch.equal(a, o) for a, o in zip(first, outs)) and all(
        torch.equal(a, e) for a, e in zip(first, (y, save, dx, dwb)))
    ok = (row["mean_err_std"] <= MD2_BN_STAT_TOL and row["rstd_rel_err"] <= MD2_BN_STAT_TOL
          and row["running_rel_err"] <= MD2_BN_RUNNING_RTOL
          and row["sum_rel_err"] <= MD2_BN_SUM_TOL and row["y_bitwise"] and row["dx_bitwise"]
          and row["mask_equal"] and row["graph_bitwise"])
    if not ok:
        raise AssertionError(f"md2 BatchNorm kernels at {tuple(x.shape)} {x.dtype} relu={relu}: "
                             f"{row}")
    return row


def _md2_bn_timing(d: dict, relu: bool, m: float, eps: float) -> dict:
    """Device us of each kernel, its plain version and its byte bound, and
    the library's forward (``native_batch_norm``, then the ReLU) and
    backward (the ReLU's, then ``native_batch_norm_backward``)."""
    import torch

    x, g, w, b = d["x"], d["g"], d["w"], d["b"]
    rk = (d["rm"].clone(), d["rv"].clone())
    partial = mbn.stats_cuda(x)
    save = mbn.normalize_cuda(x, partial, w, b, *rk, m, eps, relu)[1]
    pb = mbn.bwd_reduce_cuda(g, x, save, w, b, relu)
    dwb = mbn.bwd_elemt_cuda(g, x, save, w, b, pb, relu)[1]
    nat = torch.ops.aten.native_batch_norm
    y_lib, mean_lib, invstd_lib = nat(x, w, b, rk[0], rk[1], True, m, eps)
    if relu:
        y_lib = torch.relu(y_lib)

    def lib_fwd():
        out = nat(x, w, b, rk[0], rk[1], True, m, eps)[0]
        return torch.relu(out) if relu else out

    def lib_bwd():
        gg = torch.ops.aten.threshold_backward(g, y_lib, 0) if relu else g
        return torch.ops.aten.native_batch_norm_backward(gg, x, w, rk[0], rk[1], mean_lib,
                                                         invstd_lib, True, eps,
                                                         [True, True, True])

    nbytes = x.numel() * x.element_size()
    us = {
        "stats": 1e3 * device_ms(lambda: mbn.stats_cuda(x)),
        "normalize": 1e3 * device_ms(
            lambda: mbn.normalize_cuda(x, partial, w, b, *rk, m, eps, relu)),
        "bwd_reduce": 1e3 * device_ms(lambda: mbn.bwd_reduce_cuda(g, x, save, w, b, relu)),
        "bwd_elemt": 1e3 * device_ms(lambda: mbn.bwd_elemt_cuda(g, x, save, w, b, pb, relu)),
    }
    plain = {
        "stats": 1e3 * device_ms(lambda: mbn.stats_plain(x, eps)),
        "normalize": 1e3 * device_ms(lambda: mbn.normalize_plain(x, save, w, b, relu)),
        "bwd_reduce": 1e3 * device_ms(lambda: mbn.bwd_reduce_plain(g, x, save, w, b, relu)),
        "bwd_elemt": 1e3 * device_ms(lambda: mbn.bwd_elemt_plain(g, x, save, w, b, dwb, relu)),
    }
    bound = {k: n * nbytes / HBM_BYTES_PER_S * 1e6
             for k, n in (("stats", 1), ("normalize", 2), ("bwd_reduce", 2), ("bwd_elemt", 3))}
    return {"us": us, "plain_us": plain, "bound_us": bound,
            "library_fwd_us": 1e3 * device_ms(lib_fwd),
            "library_bwd_us": 1e3 * device_ms(lib_bwd)}


def phase_md2_bn(dev) -> dict:
    """Monodepth2's encoder BatchNorm (``ops/md2_batch_norm.py``): the four
    kernels against their plain versions at cell A's five shapes and two
    ragged ones, bf16 and float32, with and without the ReLU; then the
    device times per shape and over the step's 60 layers."""
    import torch

    m, eps = 0.1, 1e-5
    keys = ("stats", "normalize", "bwd_reduce", "bwd_elemt")
    out = {"phase": "md2_bn", "checks": [], "timing": [], "step_us": {}}
    for dtype in (torch.bfloat16, torch.float32):
        step = {k: 0.0 for k in (*keys, "bound", "plain", "library")}
        for i, shape in enumerate((*MD2_BN_LAYERS, *MD2_BN_RAGGED)):
            d = _md2_bn_data(shape, dtype, dev, 23 + i)
            for relu in (True, False):
                row = _md2_bn_check(d, relu, m, eps)
                out["checks"].append({"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                                      "relu": relu, **row})
                if shape not in MD2_BN_LAYERS:
                    continue
                t = _md2_bn_timing(d, relu, m, eps)
                out["timing"].append({"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                                      "relu": relu, **t})
                n = MD2_BN_LAYERS[shape][0 if relu else 1]
                for k in keys:
                    step[k] += n * t["us"][k]
                step["bound"] += n * sum(t["bound_us"].values())
                step["plain"] += n * sum(t["plain_us"].values())
                step["library"] += n * (t["library_fwd_us"] + t["library_bwd_us"])
            del d
            torch.cuda.empty_cache()
        step["kernels"] = sum(step[k] for k in keys)
        out["step_us"][str(dtype).split(".")[-1]] = step
    emit(out)
    return out


def phase_md2(dev, smi: str, steps: int = 24):
    """Monodepth2 (``monodepth2_ms``, 1024x320, batch 12) on the main path:
    ``cli train`` with 8 steps a call (the CUDA graph) counts 12 border
    forwards and 12 backwards, 15 reprojection errors forward and 12
    backward, and 60 launches of each encoder BatchNorm kernel, a step;
    then the graphed step's ms, the allocator's peak, the encoder BatchNorm
    kernels' traced ms a step (and that no other BatchNorm kernel ran) and
    the kernels that take most of a traced call's device time: [name (its
    first 90 characters), ms a step, launches a step], largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from depthvo_tpu_torch import cli
    from depthvo_tpu_torch.configs.base import monodepth2_ms
    from depthvo_tpu_torch.data.synthetic import SyntheticScenes
    from depthvo_tpu_torch.train import loop
    from depthvo_tpu_torch.train.state import create_state

    _build.reset_launches()
    argv = ["train", "--variant", "monodepth2_ms", "--steps", "16", "--steps-per-call", "8",
            "--device", "cuda", "--log-every", "8"]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(argv)
    assert rc == 0, printed.getvalue()[-2000:]
    launches = {k: _build.launch_count(k) for k in ("gen_fwd_border", "gen_bwd_uv_border",
                                                     "reproj_fwd", "reproj_bwd", *mbn.KERNELS)}
    assert launches == {"gen_fwd_border": 12 * 16, "gen_bwd_uv_border": 12 * 16,
                        "reproj_fwd": 15 * 16, "reproj_bwd": 12 * 16,
                        **dict.fromkeys(mbn.KERNELS, 60 * 16)}, launches
    cfg = monodepth2_ms()
    torch.cuda.reset_peak_memory_stats(dev)
    state = create_state(cfg, dev)
    scenes = SyntheticScenes(cfg, seed=3, num_scenes=cfg.batch_size, u8=True)
    batch = loop.stack_batches([scenes.fixed_batch(cfg.batch_size)] * 8)
    step = loop.make_scan_train_step(cfg, device=dev)
    state, m = step(state, batch)  # the eager step and the capture
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(steps // 8):
        state, m = step(state, batch)
    torch.cuda.synchronize(dev)
    ms = 1e3 * (time.perf_counter() - t0) / (steps // 8 * 8)
    peak = torch.cuda.max_memory_allocated(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    by_name = profiling.device_kernels(prof)[0]
    top = [[name, us / 1e3 / 8, c / 8] for name, us, c in
           profiling.heaviest_kernels(by_name, 25, 90)]
    # No PyTorch (or cuDNN) BatchNorm kernel: every one is the port's.
    library_bn = [n for n in by_name
                  if any(k in n.lower() for k in ("batch_norm", "batchnorm", "bn_fw", "bn_bw"))
                  and not any(k in n for k in ops.symbols(mbn.KERNELS))]
    assert not library_bn, library_bn
    mine = {k: profiling.matching(by_name, names) for k, names in mbn.KERNELS.items()}
    row = {"phase": "md2", "argv": argv, "launches": launches, "top_kernels": top,
           "md2_bn_traced_ms_per_step": {k: us / 1e3 / 8 for k, (us, _) in mine.items()},
           "md2_bn_traced_launches_per_step": {k: c / 8 for k, (_, c) in mine.items()},
           "log": [ln for ln in printed.getvalue().splitlines() if ln.startswith("step ")],
           "graph_ms_per_step": ms, "frames_per_s": cfg.batch_size * 1e3 / ms,
           "peak_bytes": peak,
           "loss_total": float(m["loss/total"]), "automask_share": float(
               m["md2/automask_share"]), "smi": smi}
    emit(row)
    return row


def bn_shapes(cfg, dev) -> list:
    """(N, C, H, W) of every BatchNorm layer's input in the train step,
    in order: the DepthNet's, from forward hooks on one batch."""
    import torch

    from depthvo_tpu_torch.models.layers import BatchNorm
    from depthvo_tpu_torch.train.state import build_models

    models = build_models(cfg)
    shapes = []
    hooks = [m.register_forward_hook(lambda m, args, out: shapes.append(tuple(args[0].shape)))
             for net in models if net is not None for m in net.modules()
             if isinstance(m, BatchNorm)]
    depth = models.depth.to(dev)
    with torch.no_grad():
        depth(torch.zeros(BATCH, cfg.model.height, cfg.model.width, 3, device=dev))
    for h in hooks:
        h.remove()
    return shapes


def _bf16_ulps(got, want) -> float:
    """max |got - want| in units of bf16's last place at ``want``."""
    import torch

    w = want.float()
    _, e = torch.frexp(w)
    return float(((got.float() - w).abs() / torch.exp2((e - 8).float())).max())


def _bn_rows(cfg, dev) -> list:
    """The global BatchNorm's four kernels against their plain versions at
    the 53 layer shapes of the full_feat step, float32 and bf16 from the
    same random data (channel 0 of every layer constant, near the
    variance's clamp); each downstream kernel is compared on the kernel's
    own upstream buffer (stats, save, sums), so the plain version sees the
    same statistics, and again with channel 0's sum of squares cut below
    n mean^2, so that the clamp is on there. Then the device time per step, all 53 layers: kernel,
    plain version, SyncBatchNorm's library calls (timed only) and the byte
    bound."""
    import torch

    shapes = bn_shapes(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    m, eps = 0.05, 1e-5
    data = []
    for shape in shapes:
        C = shape[1]
        x = (torch.randn(shape, device=dev, generator=gen)
             * (0.5 + 2 * torch.rand(1, C, 1, 1, device=dev, generator=gen))
             + 2 * torch.randn(1, C, 1, 1, device=dev, generator=gen))
        x[:, 0] = 0.37
        data.append({"x": x, "g": torch.randn(shape, device=dev, generator=gen),
                     "w": 0.5 + torch.rand(C, device=dev, generator=gen),
                     "b": torch.randn(C, device=dev, generator=gen),
                     "rm": torch.randn(C, device=dev, generator=gen),
                     "rv": 0.5 + torch.rand(C, device=dev, generator=gen)})
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        errs = {k: [] for k in ("stats", "running", "normalize", "bwd_reduce", "bwd_elemt")}
        abs_errs = {k: 0.0 for k in bn.KERNELS}
        layers, clamped = [], 0
        for d in data:
            x, g = d["x"].to(dtype).contiguous(), d["g"].to(dtype).contiguous()
            C = x.shape[1]
            stats = bn.bn_stats_cuda(x)
            p_stats = bn.bn_stats_plain(x)
            xf = x.float()
            scale = torch.cat([xf.abs().sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))])
            errs["stats"].append(float(((stats[:2 * C] - p_stats[:2 * C]).abs()
                                        / scale.clamp_min(1e-30)).max()))
            if stats[2 * C] != p_stats[2 * C]:
                raise AssertionError(f"bn_stats count {stats[2 * C]} != {p_stats[2 * C]}")
            abs_errs["bn_stats"] = max(abs_errs["bn_stats"],
                                       float((stats - p_stats).abs().max()))
            rk, rp = [(d["rm"].clone(), d["rv"].clone()) for _ in range(2)]
            y, save = bn.bn_normalize_cuda(x, stats, d["w"], d["b"], *rk, m, eps)
            y_p, save_p = bn.bn_normalize_plain(x, stats, d["w"], d["b"], *rp, m, eps)
            clamped += int(save[2 * C:3 * C].eq(0).sum())
            run = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(rk, rp))
            errs["running"].append(run)
            sums = bn.bn_bwd_reduce_cuda(g, x, save)
            sums_p = bn.bn_bwd_reduce_plain(g, x, save)
            gf = g.float()
            xhat = (xf - save[:C].view(1, C, 1, 1)) * save[C:2 * C].view(1, C, 1, 1)
            g_scale = torch.cat([gf.abs().sum((0, 2, 3)), (gf * xhat).abs().sum((0, 2, 3))])
            errs["bwd_reduce"].append(float(((sums - sums_p).abs()
                                             / g_scale.repeat(2).clamp_min(1e-30)).max()))
            dx = bn.bn_bwd_elemt_cuda(g, x, d["w"], save, sums)
            dx_p = bn.bn_bwd_elemt_plain(g, x, d["w"], save, sums)
            # The clamp: the same with channel 0's sum of squares cut so
            # that Q/n - mean^2 < 0 (rstd from eps alone, no xhat term).
            cut = stats.clone()
            cut[C] = cut[0] * cut[0] / cut[2 * C] * (1 - 2**-10)
            y_c, save_c = bn.bn_normalize_cuda(x, cut, d["w"], d["b"], *rk, m, eps, False)
            y_cp = bn.bn_normalize_plain(x, cut, d["w"], d["b"], *rp, m, eps, False)[0]
            dx_c = bn.bn_bwd_elemt_cuda(g, x, d["w"], save_c, sums)
            dx_cp = bn.bn_bwd_elemt_plain(g, x, d["w"], save_c, sums)
            clamped += int(save_c[2 * C:3 * C].eq(0).sum())
            for key, a, b in (("normalize", y, y_p), ("bwd_elemt", dx, dx_p),
                              ("normalize", y_c, y_cp), ("bwd_elemt", dx_c, dx_cp)):
                errs[key].append(_bf16_ulps(a, b) if dtype == torch.bfloat16 else
                                 float((a - b).abs().max() / b.abs().max()))
            abs_errs["bn_normalize"] = max(abs_errs["bn_normalize"],
                                           *(float((a - b).abs().max()) for a, b in zip(rk, rp)),
                                           float((y.float() - y_p.float()).abs().max()),
                                           float((save - save_p).abs().max()))
            abs_errs["bn_bwd_reduce"] = max(abs_errs["bn_bwd_reduce"],
                                            float((sums - sums_p).abs().max()))
            abs_errs["bn_bwd_elemt"] = max(abs_errs["bn_bwd_elemt"],
                                           float((dx.float() - dx_p.float()).abs().max()))
            layers.append({"x": x, "g": g, "w": d["w"], "b": d["b"], "stats": stats,
                           "save": save, "sums": sums, "rk": rk, "C": C})
        worst = {k: max(v) for k, v in errs.items()}
        tol = BN_BF16_ULPS if dtype == torch.bfloat16 else BN_F32_TOL
        bars = {"stats": BN_SUM_TOL, "bwd_reduce": BN_SUM_TOL, "running": BN_RUNNING_TOL,
                "normalize": tol, "bwd_elemt": tol}
        if any(not worst[k] <= bars[k] for k in bars) or clamped < len(data):
            raise AssertionError(f"BatchNorm kernels, {dtype}: worst {worst}, bars {bars}, "
                                 f"clamped channels {clamped} of {len(data)} cut")
        rows += _bn_timing(layers, dtype, worst, abs_errs, clamped, m, eps)
    return rows


def _bn_timing(layers, dtype, worst, abs_errs, clamped, m, eps) -> list:
    """Device ms per step (all layers) of each BatchNorm kernel, its plain
    version and SyncBatchNorm's library call(s) for the same function,
    beside the byte bound."""
    import torch

    size = torch.empty((), dtype=dtype).element_size()
    elems = sum(d["x"].numel() for d in layers)
    chans = sum(d["C"] for d in layers)

    def lib_inputs(d):
        mean, invstd = torch.batch_norm_stats(d["x"], eps)
        n = d["x"].numel() // d["C"]
        return {"mean": mean, "invstd": invstd,
                "counts": torch.full((1,), n, device=mean.device, dtype=torch.float32),
                "count": torch.full((1,), n, device=mean.device, dtype=torch.int32),
                "red": torch.batch_norm_backward_reduce(d["g"], d["x"], mean, invstd, d["w"],
                                                        True, True, True)}

    def lib_stats(d, L):
        mean, invstd = torch.batch_norm_stats(d["x"], eps)
        return torch.batch_norm_gather_stats_with_counts(
            d["x"], mean[None], invstd[None], d["rk"][0], d["rk"][1], m, eps, L["counts"])

    try:
        lib_in, lib_err = [lib_inputs(d) for d in layers], None
    except Exception as e:  # a yardstick only: recorded, never required
        torch.cuda.synchronize()
        lib_in, lib_err = None, f"{type(e).__name__}: {e}"[:300]
    calls = {
        "bn_stats": (lambda d: bn.bn_stats_cuda(d["x"]), lambda d: bn.bn_stats_plain(d["x"]),
                     lib_stats, elems * size + chans * 8),
        "bn_normalize": (
            lambda d: bn.bn_normalize_cuda(d["x"], d["stats"], d["w"], d["b"], *d["rk"], m, eps),
            lambda d: bn.bn_normalize_plain(d["x"], d["stats"], d["w"], d["b"], *d["rk"], m,
                                            eps),
            lambda d, L: torch.batch_norm_elemt(d["x"], d["w"], d["b"], L["mean"], L["invstd"],
                                                eps),
            2 * elems * size + chans * 44),
        "bn_bwd_reduce": (
            lambda d: bn.bn_bwd_reduce_cuda(d["g"], d["x"], d["save"]),
            lambda d: bn.bn_bwd_reduce_plain(d["g"], d["x"], d["save"]),
            lambda d, L: torch.batch_norm_backward_reduce(d["g"], d["x"], L["mean"], L["invstd"],
                                                          d["w"], True, True, True),
            2 * elems * size + chans * 28),
        "bn_bwd_elemt": (
            lambda d: bn.bn_bwd_elemt_cuda(d["g"], d["x"], d["w"], d["save"], d["sums"]),
            lambda d: bn.bn_bwd_elemt_plain(d["g"], d["x"], d["w"], d["save"], d["sums"]),
            lambda d, L: torch.batch_norm_backward_elemt(
                d["g"], d["x"], L["mean"], L["invstd"], d["w"], L["red"][0], L["red"][1],
                L["count"]),
            3 * elems * size + chans * 24),
    }
    check = {"bn_stats": ("stats",), "bn_normalize": ("normalize", "running"),
             "bn_bwd_reduce": ("bwd_reduce",), "bn_bwd_elemt": ("bwd_elemt",)}
    rows = []
    for name, (kernel, plain, lib, nbytes) in calls.items():
        b_ms, b_by = bound_ms(nbytes, 4 * elems)
        lib_ms, row_err = None, lib_err
        if lib_in is not None:
            try:
                lib_ms = device_ms(lambda: [lib(d, L) for d, L in zip(layers, lib_in)])
            except Exception as e:  # a yardstick only: recorded, never required
                torch.cuda.synchronize()
                row_err = f"{type(e).__name__}: {e}"[:300]
        rows.append({
            "kernel": name, "dtype": str(dtype).split(".")[-1], "layers": len(layers),
            "elements": elems, "clamped_channels": clamped,
            "max_abs_err": abs_errs[name], **{f"worst_{k}": worst[k] for k in check[name]},
            "ms": device_ms(lambda: [kernel(d) for d in layers]),
            "plain_ms": device_ms(lambda: [plain(d) for d in layers]),
            "library_ms": lib_ms, "library_error": row_err,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
        })
    return rows


def _f32_config(cfg):
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32")
    )


def _check_counts(per_call: dict, n_calls: int) -> dict:
    """Launches since the last reset: ``per_call[k]`` of kernel k per
    batch or step, none of the others."""
    counts = {k: _build.launch_count(k) for k in wk.KERNELS}
    want = {k: per_call.get(k, 0) * n_calls for k in wk.KERNELS}
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
    _build.reset_launches()
    f32 = loop.run_validation(eval_fn, models, iter(batches), len(batches))
    out["f32_launches"] = _check_counts(_eval_launches(cfg), len(batches))
    out["f32_metrics"] = f32
    del models, cpu_models
    torch.backends.cudnn.allow_tf32 = True

    # The main path: `cli test` on the default (bfloat16) config.
    argv = ["test", "--variant", variant, "--iterations", "4",
            "--batch-size", str(BATCH), "--device", "cuda"]
    printed = io.StringIO()
    _build.reset_launches()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(argv)
    launches = _check_counts(_eval_launches(cfg), 4)
    by_shape = {f"{k} {list(shape)}": n for (k, shape), n in sorted(_build.LAUNCHES.items())}
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
        return _step_record(*loop.make_train_step(cfg32, device=device)(state, b))

    t0 = time.perf_counter()
    gpu = one_step(dev, _float_batch(host))
    cpu = one_step(torch.device("cpu"), _float_batch(host))
    own = one_step(torch.device("cpu"), _float_batch(host, noise_seed=1))
    out["card_vs_cpu_seconds"] = time.perf_counter() - t0
    out["f32_card_vs_cpu"] = {"batch": 2, **_hold_step(gpu, cpu, own[1], "card vs CPU")}
    torch.backends.cudnn.allow_tf32 = True

    # (3) The main path: `cli train` on the default (bfloat16) config.
    steps = 3
    argv = ["train", "--variant", variant, "--steps", str(steps), "--batch-size", str(BATCH),
            "--device", "cuda", "--log-every", "1"]
    printed = io.StringIO()
    _build.reset_launches()
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
                              for (k, shape), n in sorted(_build.LAUNCHES.items())},
        "losses": [{k: float(m[k]) for k in m if k.startswith(("loss/", "grad/"))}
                   for m in logged],
    }

    # (4) Its speed on pre-made batches (host data generation excluded).
    scenes = SyntheticScenes(cfg, seed=cfg.seed, u8=True)
    batches = [scenes.batch(BATCH) for _ in range(4)]
    state = create_state(cfg, dev)
    step_fn = loop.make_train_step(cfg, device=dev)
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


def _step_record(state, metrics) -> tuple:
    """A train step's (metrics, gradients, BatchNorm statistics) on the host."""
    from depthvo_tpu_torch.train.state import param_tree

    grads = {k: p.grad.detach().cpu() for k, p in param_tree(state.models).items()
             if p.grad is not None}
    stats = {k: v.detach().cpu() for k, v in state.models.depth.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return {k: float(v) for k, v in metrics.items()}, grads, stats


def _hold_step(got, want, own_g, what: str, need_stable: bool = True) -> dict:
    """One train step ``got`` = (metrics, gradients, BatchNorm statistics)
    against ``want`` to the train phase's bars: loss terms METRIC_RTOL;
    gradients GRAD_RTOL where ``want``'s own gradient is stable (``own_g``,
    the same step under 1e-6 image noise, moves it by <= 1e-5), elsewhere,
    as one vector, within 4x that spread; BatchNorm statistics STATS_RTOL
    of their largest magnitude. ``need_stable``: fail when no leaf is
    stable (at batch 4 on the card none of full_feat's is)."""
    import torch

    (got_m, got_g, got_s), (ref_m, ref_g, ref_s) = got, want
    rel_m = {k: abs(got_m[k] - ref_m[k]) / max(abs(ref_m[k]), 1e-30) for k in ref_m
             if k != "grad/global_norm"}
    if set(got_m) != set(ref_m) or not max(rel_m.values()) <= METRIC_RTOL:
        raise AssertionError(f"train step {what} metrics: {got_m} vs {ref_m}")
    if set(got_g) != set(ref_g) or any(k.startswith("feat.") for k in got_g):
        raise AssertionError(f"{what}: the parameters that got a gradient differ")
    stable, unstable = {}, []
    for k in ref_g:
        if _rel(own_g[k], ref_g[k]) <= 1e-5:
            stable[k] = _rel(got_g[k], ref_g[k])
        else:
            unstable.append(k)
    if (need_stable and not stable) or not max(stable.values(), default=0.0) <= GRAD_RTOL:
        raise AssertionError(f"stable gradients {what}: {len(stable)} leaves, "
                             f"max {max(stable.values(), default=None)}")
    flat = lambda g, keys: torch.cat([g[k].flatten() for k in keys])  # noqa: E731
    spread = _rel(flat(own_g, unstable), flat(ref_g, unstable)) if unstable else 0.0
    err_u = _rel(flat(got_g, unstable), flat(ref_g, unstable)) if unstable else 0.0
    if not err_u <= max(GRAD_RTOL, 4 * spread):
        raise AssertionError(f"unstable gradients {what}: {err_u} > 4 x {spread}")
    norm_rel = abs(got_m["grad/global_norm"] - ref_m["grad/global_norm"]) / ref_m["grad/global_norm"]
    if not norm_rel <= max(GRAD_RTOL, 4 * spread):
        raise AssertionError(f"grad/global_norm {what}: {norm_rel}")
    stat_err = max(float((got_s[k] - ref_s[k]).abs().max() / ref_s[k].abs().max())
                   for k in ref_s)
    if not stat_err <= STATS_RTOL:
        raise AssertionError(f"BatchNorm statistics {what}: {stat_err}")
    worst = max(stable, key=stable.get, default=None)
    return {"metrics_max_rel": max(rel_m.values()), "global_norm_rel": norm_rel,
            "stable_leaves": len(stable), "stable_max_rel": stable.get(worst),
            "stable_worst": worst,
            "unstable_leaves": len(unstable), "unstable_rel": err_u, "own_spread": spread,
            "bn_stats_max_rel": stat_err, "metrics": got_m}


SCAN_K = 8
# The global BatchNorm's device kernels in a profiler trace, per layer and
# train step over a mesh: each launch runs its kernels of bn.KERNELS once,
# so the fixed-order sum of the partials, which bn_stats and bn_bwd_reduce
# both run, twice and the others once.
BN_TRACE_PER_LAYER = dict(collections.Counter(
    name for names in bn.KERNELS.values() for name in names))


def _check_bn_counts(n: int) -> dict:
    """Launches since the last reset: each BatchNorm kernel ``n`` times."""
    counts = {k: _build.launch_count(k) for k in bn.KERNELS}
    if counts != {k: n for k in bn.KERNELS}:
        raise AssertionError(f"BatchNorm kernel launches {counts}, expected {n} each")
    return counts


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

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, busy = profiling.device_kernels(prof)
    return {
        "warp_kernels": {k: profiling.matching(by_name, names)[1]
                         for k, names in wk.KERNELS.items()},
        "kernels_per_step": sum(c for _, c in by_name.values()) / steps,
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


def _graph_vs_eager(cfg32, params, host, dev, mesh=None) -> dict:
    """len(host) steps in one ``make_scan_train_step`` call (1 eager step,
    its capture, replays) against as many eager steps from the same
    weights, over ``mesh`` if given: every tensor of the two states, the
    last metrics and the call's launches (its state is freed on return)."""
    import torch

    from depthvo_tpu_torch.train import loop
    from depthvo_tpu_torch.train.state import TrainState, build_models, load_params, \
        make_optimizer, param_tree

    def fresh():
        models = load_params(build_models(cfg32), params, dev).train()
        return TrainState(0, models, make_optimizer(cfg32).init(param_tree(models)))

    _build.reset_launches()
    graphed, g_metrics = loop.make_scan_train_step(cfg32, mesh, device=dev)(
        fresh(), loop.stack_batches(host))
    g_launches = {k: _build.launch_count(k) for k in wk.KERNELS}
    eager, step = fresh(), loop.make_train_step(cfg32, mesh, device=dev)
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


def _unroll_vs_1(cfg32, params, host, dev) -> dict:
    """len(host) steps in one ``make_scan_train_step`` call with unroll 1,
    2 and 4 from the same weights (``lax.scan``'s argument; a CUDA graph
    has no loop to unroll, so each replays the one-step graph): every
    tensor of the states and the last metrics bit for bit against unroll
    1, and K x the step's launches."""
    import torch

    from depthvo_tpu_torch.train import loop

    runs, K = {}, len(host)
    stacked = loop.stack_batches(host)
    for unroll in (1, 2, 4):
        gc.collect()
        torch.cuda.empty_cache()
        _build.reset_launches()
        state, metrics = loop.make_scan_train_step(cfg32, unroll=unroll, device=dev)(
            _fresh_state(cfg32, params, dev), stacked)
        torch.cuda.synchronize()
        launches = _check_counts(_train_launches(cfg32), K)
        runs[unroll] = ({k: v.cpu() for k, v in _state_leaves(state).items()},
                        {k: float(v) for k, v in metrics.items()}, state.step)
        del state
    out = {"steps": K, "launches_per_call": launches}
    (ref, ref_m, ref_step) = runs[1]
    for unroll in (2, 4):
        leaves, m, step = runs[unroll]
        differ = [k for k, v in ref.items() if not torch.equal(leaves[k], v)]
        if differ or m != ref_m or not step == ref_step == K:
            raise AssertionError(f"unroll {unroll} vs 1 at K={K}, iter_size "
                                 f"{cfg32.optim.iter_size}: {len(differ)} tensors differ "
                                 f"({differ[:3]}), metrics {m} vs {ref_m}, step {step}")
        out[f"unroll_{unroll}"] = {"tensors_bit_for_bit": len(ref), "metrics_equal": True}
    return out


def _left_allocated(before: int) -> dict:
    """What is still allocated above ``before`` once every object is freed
    and the cache emptied, and then after clearing cuBLAS's workspaces
    (PyTorch keeps one per handle and stream, from its caching allocator;
    a graph's warm-up runs on a side stream)."""
    import torch

    def left():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated() - before

    freed = left()
    torch._C._cuda_clearCublasWorkspaces()
    return {"after_free": freed, "after_clearing_cublas_workspaces": left()}


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
    # unroll 2 and 4 against unroll 1, bit for bit: K = 8, K = 7 and
    # iter_size 2 (both solver branches).
    more = [scenes.batch(2) for _ in range(4)]
    out["unroll_vs_1"] = {}
    for K, iter_size in ((8, 1), (7, 1), (8, 2)):
        cfg32 = dataclasses.replace(base32, optim=dataclasses.replace(
            base32.optim, iter_size=iter_size))
        out["unroll_vs_1"][f"K{K}_iter_size_{iter_size}"] = _unroll_vs_1(
            cfg32, params, (host + more)[:K], dev)
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = flags

    # (2) bf16 default, batch 4, pre-made batches: eager K=1 against the
    # graph K=8, calls of 8 steps each, ms/step untraced (median of the
    # calls after the first), one traced call each (kernel counts, busy
    # share), peak memory, and what each mode leaves allocated once freed.
    scenes = SyntheticScenes(cfg, seed=cfg.seed, u8=True)
    batches = [scenes.batch(BATCH) for _ in range(SCAN_K)]
    stacked = loop.batch_to_device(loop.stack_batches(batches), dev)
    on_dev = [loop.batch_to_device(b, dev) for b in batches]
    timing = {}
    before = _left_allocated(0)["after_clearing_cublas_workspaces"]
    for mode in ("eager", "graph"):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = create_state(cfg, dev)
        if mode == "eager":
            step = loop.make_train_step(cfg, device=dev)

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
        _build.reset_launches()
        traced = _traced_call(call, SCAN_K)
        counts = {k: _build.launch_count(k) for k in wk.KERNELS}
        want = {k: _train_launches(cfg).get(k, 0) * SCAN_K for k in wk.KERNELS}
        if traced["warp_kernels"] != want or counts != want:
            raise AssertionError(f"{mode}: one call of {SCAN_K} steps ran "
                                 f"{traced['warp_kernels']} (counters {counts}), expected {want}")
        timing[mode] = {"ms_per_step_calls": ms, "ms_per_step": statistics.median(ms[1:]),
                        "memory": memory, "traced_call": traced}
        del state, call
        if mode == "eager":
            del step
        else:
            del scan
        timing[mode]["left_allocated_bytes"] = _left_allocated(before)
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
    _build.reset_launches()
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


LEARN_STEPS = 400
LEARN_MARKS = (0, 200, 400)  # steps after which every loss term is printed
# The reference's record of the same check on its chip (a TPU, the JAX
# package, the full model, 400 steps; tests/test_metric_learning.py:10-11).
TPU_RECORD = {"abs_rel": 0.088, "log_corr": 0.966, "t_err_rel_max": 0.05}
LEARN_GATES = {"abs_rel_max": 0.15, "log_corr_min": 0.90, "t_err_rel_max": 0.20}


def _train_losses(cfg, models, batch) -> dict:
    """The train-mode loss terms of a copy of ``models`` on ``batch`` (the
    loss the next train step would take), without touching ``models``."""
    import copy

    import torch

    from depthvo_tpu_torch.train import loop

    with torch.no_grad():
        _, metrics = loop.compute_losses(cfg, copy.deepcopy(models).train(), batch, train=True)
    return {k: float(v) for k, v in metrics.items() if k.startswith("loss/")}


def _learn_run(cfg, dev) -> dict:
    """400 steps of ``cfg`` as calls of K through ``make_scan_train_step``
    on the fixed batch of ``SyntheticScenes(seed=3, num_scenes=4)`` held
    on the card, with the launch counts reset just before the calls and
    read just after. Scored before and after (``eval.synthetic``)."""
    import copy

    import torch

    from depthvo_tpu_torch.data.synthetic import SyntheticScenes
    from depthvo_tpu_torch.eval import synthetic
    from depthvo_tpu_torch.train import loop
    from depthvo_tpu_torch.train.state import create_state

    scenes = SyntheticScenes(cfg, seed=3, num_scenes=4)
    fixed = scenes.fixed_batch(BATCH)
    batch = loop.batch_to_device(fixed, dev)
    stacked = loop.batch_to_device(loop.stack_batches([fixed] * SCAN_K), dev)
    state = create_state(cfg, dev)

    def scores():
        return {**synthetic.depth_metrics(state.models, scenes, BATCH),
                **synthetic.pose_metrics(state.models, scenes, BATCH)}

    before = scores()
    losses = {0: _train_losses(cfg, state.models, batch)}
    scan = loop.make_scan_train_step(cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    ms, memory, held = [], {}, {}
    calls = LEARN_STEPS // SCAN_K
    for call in range(1, calls + 1):
        t0 = time.perf_counter()
        state, _ = scan(state, stacked)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / SCAN_K)
        if call in (1, calls):
            memory[f"after_call_{call}"] = {
                "graph_pool_bytes": _private_pool_bytes(),
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "memory_allocated": torch.cuda.memory_allocated()}
            torch.cuda.reset_peak_memory_stats()
        if state.step in LEARN_MARKS[1:-1]:
            held[state.step] = copy.deepcopy(state.models)  # scored after the run
    counts = {k: _build.launch_count(k) for k in wk.KERNELS}
    for step, models in held.items():
        losses[step] = _train_losses(cfg, models, batch)
    losses[LEARN_STEPS] = _train_losses(cfg, state.models, batch)
    return {"losses_after_steps": {str(k): v for k, v in sorted(losses.items())},
            "step_0": before, f"step_{LEARN_STEPS}": scores(),
            "ms_per_step_median": statistics.median(ms[1:]), "ms_per_step_first_call": ms[0],
            "memory": memory, "launches": counts,
            "launches_per_step": {k: n / LEARN_STEPS for k, n in counts.items()}}


def phase_learn(variant: str, dev, smi: str):
    """The port learns (the reference's tests/test_metric_learning.py at
    full width on the card): 400 steps of the staged full_feat step at
    608x160, batch 4, as 50 calls of K=8 through ``make_scan_train_step``
    (the CUDA graph), adam at 1e-3 with a 10-step warmup, on a fixed batch
    held on the card (:func:`_learn_run`); the main path on the default
    (bfloat16) config, gated, then the same run in float32 with TF32 off
    beside it, recorded (does the precision change what is learned?)."""
    import torch

    from depthvo_tpu_torch import configs

    cfg = getattr(configs, variant)(batch_size=BATCH)
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, learning_rate=1e-3, warmup_steps=10, total_steps=LEARN_STEPS))
    out = {"phase": "learn", "config": variant, "hw": [cfg.model.height, cfg.model.width],
           "batch": BATCH, "steps": LEARN_STEPS, "steps_per_call": SCAN_K,
           "optim": dataclasses.asdict(cfg.optim), "nvidia_smi": smi,
           "tpu_record": dict(TPU_RECORD, what="the JAX package on a TPU, full model, 400 "
                              "steps (tests/test_metric_learning.py:10-11): a record, not "
                              "a target")}
    main = _learn_run(cfg, dev)
    after = main[f"step_{LEARN_STEPS}"]
    want = {k: float(_train_launches(cfg).get(k, 0)) for k in wk.KERNELS}
    pools = [m["graph_pool_bytes"] for m in main["memory"].values()]
    gates = {
        "losses_finite": all(math.isfinite(v) for m in main["losses_after_steps"].values()
                             for v in m.values()),
        "abs_rel_falls": after["abs_rel"] < main["step_0"]["abs_rel"],
        "abs_rel_max": after["abs_rel"] <= LEARN_GATES["abs_rel_max"],
        "log_corr_min": after["log_corr"] >= LEARN_GATES["log_corr_min"],
        "t_err_rel_max": after["t_err_rel_max"] <= LEARN_GATES["t_err_rel_max"],
        "launches_per_step": main["launches_per_step"] == want,
        "pool_steady": len(set(pools)) == 1,
    }
    out.update({"bfloat16": main, "gates": LEARN_GATES, "gate_results": gates})
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out["float32_tf32_off"] = _learn_run(_f32_config(cfg), dev)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    emit(out)
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"phase learn: gates {failed} failed")
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
    _build.reset_launches()
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
        _build.reset_launches()
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

    def first_weights(config, mesh=None, device=None):
        step_fn = real_step(config, mesh, device=device)

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


def _reference_orbax():
    """``tests/data/reference_orbax.py``: the committed reference checkpoint
    (a full_feat train state of the JAX package, Adam, iter_size 1) and the
    numpy generator of its leaves."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "data", "reference_orbax.py")
    spec = importlib.util.spec_from_file_location("reference_orbax", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tree_leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def phase_orbax(variant: str, dev, smi: str):
    """A run of the JAX package moves to the card: the committed reference
    checkpoint read without tensorstore, resumed whole into a full_feat
    state, trained under the graph; ``cli train --init-from`` and ``cli
    test`` on it."""
    import importlib.util
    import os

    import numpy as np
    import torch

    from depthvo_tpu_torch import configs
    from depthvo_tpu_torch.data.synthetic import SyntheticScenes
    from depthvo_tpu_torch.io import checkpoint as ckpt, orbax_reader
    from depthvo_tpu_torch.io.from_jax import params_from_jax
    from depthvo_tpu_torch.train import loop
    from depthvo_tpu_torch.train.state import create_state, param_tree

    ref = _reference_orbax()
    cfg = getattr(configs, variant)(batch_size=BATCH)
    step_dir = os.path.join(ref.DIR, str(ref.STEP))
    out = {"phase": "orbax", "config": variant, "checkpoint": ref.DIR,
           "tensorstore_importable": importlib.util.find_spec("tensorstore") is not None,
           "nvidia_smi": smi}

    # (1) The read, every leaf against numpy's regeneration, bit for bit.
    t0 = time.perf_counter()
    tree = orbax_reader.read_tree(step_dir)
    seconds = time.perf_counter() - t0
    leaves = list(_tree_leaves(tree))
    arrays = [(p, x) for p, x in leaves if x is not None]
    decoded = sum(x.nbytes for _, x in arrays)
    for path, x in arrays:
        want = ref.leaf(path, x.shape, x.dtype)
        if x.dtype != want.dtype or not np.array_equal(x, want):
            raise AssertionError(f"orbax read: {'/'.join(path)} differs from its tile")
    on_disk = sum(os.path.getsize(os.path.join(d, f))
                  for d, _, fs in os.walk(ref.DIR) for f in fs)
    out["read"] = {"arrays": len(arrays), "entries_without_data": len(leaves) - len(arrays),
                   "decoded_bytes": decoded, "bytes_on_disk": on_disk, "seconds": seconds,
                   "decoded_mb_per_s": decoded / seconds / 1e6, "bit_for_bit": True}

    # (2) Resume a full_feat state: the step, Adam's count, every leaf.
    t0 = time.perf_counter()
    state = ckpt.maybe_restore(ckpt.CheckpointManager(ref.DIR),
                               create_state(cfg, dev), cfg)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    adam = tree["opt_state"]["inner_states"]["train"]["inner_state"]["1"]["0"]
    count, mu, nu = state.opt_state[1]
    if not state.step == count == int(adam["count"]) == ref.STEP:
        raise AssertionError(f"resumed at step {state.step}, Adam count {count}")

    def flat(t):
        return {f"{n}.{k}": v for n, sd in t.items() for k, v in sd.items()}

    want = flat(params_from_jax(tree["params"], tree["batch_stats"]))
    got = {f"{n}.{k}": v for n, net in zip(state.models._fields, state.models)
           if net is not None for k, v in net.state_dict().items()}
    trained = [k for k in param_tree(state.models) if not k.startswith("feat.")]
    moments = [flat(params_from_jax({n: t for n, t in adam[m].items() if n != "feat"}, {}))
               for m in ("mu", "nu")]
    seated = [(got[k], w) for k, w in want.items()]
    seated += [(t, moments[i][k]) for i, ts in enumerate((mu, nu)) for k, t in zip(trained, ts)]
    if len(trained) != len(moments[0]) or not all(torch.equal(t.cpu(), w) for t, w in seated):
        raise AssertionError("the resumed state differs from the checkpoint")
    out["resume"] = {"step": state.step, "adam_count": count, "seconds": resume_s,
                     "tensors_bit_for_bit": len(seated)}

    # (3) 8 bf16 steps under the graph from it: finite, 1/2/1/4 per step.
    scenes = SyntheticScenes(cfg, seed=cfg.seed, u8=True)
    stacked = loop.batch_to_device(loop.stack_batches(
        [scenes.batch(BATCH) for _ in range(SCAN_K)]), dev)
    _build.reset_launches()
    state, metrics = loop.make_scan_train_step(cfg, device=dev)(state, stacked)
    torch.cuda.synchronize()
    launches = _check_counts(_train_launches(cfg), SCAN_K)
    losses = {k: float(v) for k, v in metrics.items()}
    finite = all(bool(torch.isfinite(p).all()) for p in param_tree(state.models).values())
    if state.step != ref.STEP + SCAN_K or not finite or not all(
            math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"training from the resumed state: step {state.step}, {losses}")
    out["train_under_graph"] = {"steps": SCAN_K, "launches": launches, "last_metrics": losses}
    del state, stacked

    # (4) The CLI on the reference directory: a stage started from its
    # weights, and the held-out pass on them.
    argv = ["train", "--variant", variant, "--init-from", ref.DIR, "--steps", "2",
            "--batch-size", str(BATCH), "--device", "cuda", "--log-every", "1"]
    from depthvo_tpu_torch import cli

    printed = io.StringIO()
    _build.reset_launches()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(argv)
    lines = [ln for ln in printed.getvalue().splitlines() if ln.startswith("step ")]
    values = [float(kv.split("=")[1]) for ln in lines for kv in ln.split(": ", 1)[1].split()]
    if rc != 0 or len(lines) != 2 or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"cli train --init-from the reference checkpoint: rc {rc}, {lines}")
    out["cli_train_init_from"] = {"argv": argv, "rc": rc,
                                  "launches": _check_counts(_train_launches(cfg), 2)}
    test_argv = ["test", "--variant", variant, "--checkpoint-dir", ref.DIR,
                 "--iterations", "2", "--batch-size", str(BATCH), "--device", "cuda"]
    metrics, _ = _cli_json(test_argv)
    if not metrics or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"cli test on the reference checkpoint: {metrics}")
    out["cli_test"] = {"argv": test_argv, "rc": 0, "metrics": metrics}
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
    _build.reset_launches()
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
            _build.reset_launches()
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
        st, m = loop.make_train_step(c, device=dev)(st, host[0])
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
        step = loop.make_train_step(c, device=dev)
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


DP_PROFILED_STEPS = 2


def _fresh_state(cfg, params, dev):
    from depthvo_tpu_torch.train.state import (
        TrainState, build_models, load_params, make_optimizer, param_tree,
    )

    models = load_params(build_models(cfg), params, dev).train()
    return TrainState(0, models, make_optimizer(cfg).init(param_tree(models)))


def _dp_rank(rank: int, port: int, outdir: str, world: int = 2) -> None:
    """One of ``world`` gloo ranks sharing the card, every one making the
    mesh of the first two: the mesh's ranks take the f32 (TF32 off) eager
    steps of phase dp on their halves of each global batch and save the
    first step's record and the whole state after the last; a rank outside
    the mesh (world 3) saves what each entry point raised and whether its
    state stayed as it was."""
    import os

    import torch

    from depthvo_tpu_torch import configs
    from depthvo_tpu_torch.parallel import distributed as pdist, mesh as pmesh
    from depthvo_tpu_torch.train import loop

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", 0)
    pdist.init_rank(rank, world, f"tcp://127.0.0.1:{port}", dev, timeout=300, backend="gloo")
    try:
        inputs = torch.load(os.path.join(outdir, "inputs.pt"), weights_only=False)
        cfg32 = _f32_config(configs.full_feat(batch_size=BATCH))
        mesh = pmesh.make_mesh(2, device=dev)
        state = _fresh_state(cfg32, inputs["params"], dev)
        if mesh.rank is None:
            before = {k: v.cpu() for k, v in _state_leaves(state).items()}
            refused = {}
            for name, call in (
                    ("make_train_step", lambda: loop.make_train_step(cfg32, mesh, device=dev)),
                    ("make_scan_train_step",
                     lambda: loop.make_scan_train_step(cfg32, mesh, device=dev)),
                    ("fit", lambda: loop.fit(cfg32, iter(inputs["batches"]), 1, mesh,
                                             state=state, device=dev))):
                try:
                    call()
                    refused[name] = None
                except ValueError as e:
                    refused[name] = str(e)
            kept = all(torch.equal(v.cpu(), before[k]) for k, v in _state_leaves(state).items())
            torch.save({"refused": refused, "state_kept": kept, "step": state.step},
                       os.path.join(outdir, f"rank{rank}.pt"))
            return
        step = loop.make_train_step(cfg32, mesh, device=dev)
        rec = {}
        for i, b in enumerate(inputs["batches"]):
            state, metrics = step(state, pdist.local_slice(b, rank, 2, 2))
            if i == 0:
                rec["first"] = _step_record(state, metrics)
        rec["state"] = {k: v.cpu() for k, v in _state_leaves(state).items()}
        torch.save(rec, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def phase_dp(variant: str, dev, smi: str):
    """Data parallelism (A.8) on full_feat at 608x160, global batch 4. The
    card's machine has one H100, so the mesh path runs as an NCCL group of
    one (its collectives captured in the step's graph) and as two gloo
    ranks sharing the card; NCCL across cards is not exercised."""
    import os
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from depthvo_tpu_torch import cli, configs
    from depthvo_tpu_torch.api import DepthVO
    from depthvo_tpu_torch.data.synthetic import SyntheticScenes
    from depthvo_tpu_torch.eval.runner import predict_depths
    from depthvo_tpu_torch.models import layers
    from depthvo_tpu_torch.parallel import distributed as pdist, mesh as pmesh
    from depthvo_tpu_torch.train import loop
    from depthvo_tpu_torch.train.state import create_state, init_params

    cfg = getattr(configs, variant)(batch_size=BATCH)
    cfg32 = _f32_config(cfg)
    out = {"phase": "dp", "config": variant, "hw": [cfg.model.height, cfg.model.width],
           "global_batch": BATCH, "nvidia_smi": smi}
    params = init_params(cfg32, torch.Generator().manual_seed(0))
    params["odom"]["Dense_2.bias"] = torch.tensor([2.0, -1.0, -30.0, 0.2, -0.3, 0.1])
    scenes = SyntheticScenes(cfg, seed=cfg.seed, u8=True, num_scenes=2)
    host = [scenes.fixed_batch(BATCH)] + [scenes.batch(BATCH) for _ in range(3)]
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)

    # (1) An NCCL group of one: the data-parallel path at its full width.
    pdist.init_rank(0, 1, f"tcp://127.0.0.1:{pdist.free_port()}", dev)
    try:
        mesh = pmesh.make_mesh(device=dev)
        # (a) f32, TF32 off, cuDNN deterministic (so that the step's own
        # spread is that of its inputs): the mesh step against mesh=None.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True

        def one(m, batch):
            step = loop.make_train_step(cfg32, m, device=dev)
            return _step_record(*step(_fresh_state(cfg32, params, dev), batch))

        plain = one(None, _float_batch(host[0]))
        own = one(None, _float_batch(host[0], noise_seed=1))
        out["f32_mesh_vs_plain"] = _hold_step(one(mesh, _float_batch(host[0])), plain,
                                              own[1], "mesh vs mesh=None", need_stable=False)
        torch.backends.cudnn.allow_tf32 = True
        # (b) bf16 default, cuDNN deterministic: 4 steps through the graph
        # (collectives captured) against 4 eager steps, both over the mesh.
        bf16 = _graph_vs_eager(cfg, init_params(cfg, torch.Generator().manual_seed(0)),
                               host, dev, mesh)
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = flags
        if bf16["tensors_not_bitwise_equal"]:
            raise AssertionError(f"mesh graph vs eager: {bf16}")
        out["bf16_graph_vs_eager"] = bf16
        # (c) the warp launches and (d) the collectives per eager step, from
        # a profiler trace: the valid counts, two per BatchNorm (its
        # statistics forward, their cotangent backward), the gradients, the
        # metrics.
        state = create_state(cfg, dev)
        step = loop.make_train_step(cfg, mesh, device=dev)
        step(state, host[0])
        torch.cuda.synchronize()
        _build.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for b in host[:DP_PROFILED_STEPS]:
                step(state, b)
            torch.cuda.synchronize()
        launches = _check_counts(_train_launches(cfg), DP_PROFILED_STEPS)
        norms = sum(isinstance(m, layers.BatchNorm) for net in state.models if net is not None
                    for m in net.modules())
        # each BatchNorm kernel once per layer per step, in the counters
        # and in the trace
        bn_launches = _check_bn_counts(norms * DP_PROFILED_STEPS)
        by_name = profiling.device_kernels(prof)[0]
        bn_traced = {k: profiling.matching(by_name, [k])[1] / DP_PROFILED_STEPS
                     for k in BN_TRACE_PER_LAYER}
        if bn_traced != {k: n * norms for k, n in BN_TRACE_PER_LAYER.items()}:
            raise AssertionError(f"BatchNorm kernels per step in the trace {bn_traced}, "
                                 f"expected {BN_TRACE_PER_LAYER} x {norms}")
        names = collections.Counter(e.name for e in prof.events()
                                    if "all_reduce" in e.name or "allreduce" in e.name)
        want = 3 + 2 * norms
        got = names.get("nccl:all_reduce", 0) / DP_PROFILED_STEPS
        if got != want:
            raise AssertionError(f"all-reduces per step {got} ({dict(names)}), expected {want}")
        out["per_step"] = {"warp_launches": {k: v // DP_PROFILED_STEPS for k, v in launches.items()},
                           "bn_launches": {k: v // DP_PROFILED_STEPS
                                           for k, v in bn_launches.items()},
                           "bn_traced_kernels": bn_traced,
                           "all_reduces": got, "batch_norms": norms,
                           "trace_names": {k: v / DP_PROFILED_STEPS for k, v in names.items()}}
        # (e) ms/step under the graph, K=8 per call, with the mesh and
        # without, in turns; one traced call each: device busy ms, kernels
        # and the NCCL kernels' ms per step; the BatchNorm kernels K x per
        # call under replay (none without the mesh); the graph's pool.
        stacked = loop.batch_to_device(loop.stack_batches(
            [host[i % len(host)] for i in range(SCAN_K)]), dev)
        timing = {}
        for name, m in (("mesh", mesh), ("plain", None), ("mesh_again", mesh)):
            gc.collect()
            torch.cuda.empty_cache()
            _build.reset_launches()
            state = create_state(cfg, dev)
            scan = loop.make_scan_train_step(cfg, m, device=dev)
            ms = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                scan(state, stacked)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3 / SCAN_K)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                scan(state, stacked)
                torch.cuda.synchronize()
            by_name, busy = profiling.device_kernels(prof)
            nccl = [v for k, v in by_name.items() if "nccl" in k.lower()]
            timing[name] = {
                "ms_per_step_calls": ms, "ms_per_step": statistics.median(ms[1:]),
                "traced_device_busy_ms_per_step": busy / SCAN_K / 1e3,
                "traced_kernels_per_step": sum(c for _, c in by_name.values()) / SCAN_K,
                "traced_nccl_per_step": sum(c for _, c in nccl) / SCAN_K,
                "traced_nccl_ms_per_step": sum(us for us, _ in nccl) / SCAN_K / 1e3,
                "traced_bn_kernels_per_step": {
                    k: profiling.matching(by_name, [k])[1] / SCAN_K for k in BN_TRACE_PER_LAYER},
                "bn_launches": _check_bn_counts(norms * 5 * SCAN_K if m is not None else 0),
                "graph_pool_bytes": _private_pool_bytes()}
            del state, scan
        out["bf16_graph_ms_per_step"] = timing
        # what the mesh adds per step at one rank: the collectives and the
        # global BatchNorm
        out["mesh_extra_per_step"] = {
            name: {k: timing[name][key] - timing["plain"][key] for k, key in (
                ("ms", "ms_per_step"), ("device_busy_ms", "traced_device_busy_ms_per_step"),
                ("kernels", "traced_kernels_per_step"), ("pool_bytes", "graph_pool_bytes"))}
            for name in ("mesh", "mesh_again")}
        # (f) fit over the mesh: rank 0's state broadcast, K=2 per call
        # with the collectives captured, the signal agreement over a gloo
        # side group, snapshots with a barrier; resumes at the saved step.
        with tempfile.TemporaryDirectory(prefix="dp-fit-") as ck:
            logged = []
            for steps in (3, 5):
                loop.fit(cfg, iter(host * 2), steps, mesh=mesh, checkpoint_dir=ck,
                         log_fn=lambda i, m: logged.append(i), steps_per_call=2,
                         sigint_effect="stop", sighup_effect="snapshot", device=dev)
            saved = sorted(os.listdir(ck))
        if saved != ["3", "5", "config.json"] or logged != [1, 2, 4]:
            raise AssertionError(f"fit over the mesh: saved {saved}, logged {logged}")
        out["fit_over_mesh"] = {"saved": saved, "logged_steps": logged}
        # (g) The main path: what each rank of `cli train --num-devices N`
        # runs (cli._rank_main: the mesh over the group, then the command),
        # counts reset just before and read just after: 1/2/1/4 warp
        # launches and each BatchNorm kernel once per layer per step.
        argv = ["train", "--variant", variant, "--steps", "2", "--batch-size", str(BATCH),
                "--device", "cuda", "--log-every", "1"]
        _build.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()) as log:
            cli._rank_main(dev, cli.build_parser().parse_args(argv), "train")
        torch.cuda.synchronize()
        logged = [ln for ln in log.getvalue().splitlines() if ln.startswith("step ")]
        out["cli_rank"] = {
            "argv": argv, "logged": logged,
            "warp_launches": _check_counts(_train_launches(cfg), 2),
            "bn_launches": _check_bn_counts(2 * norms), "steps": 2}
        if len(logged) != 2:
            raise AssertionError(f"cli train rank body over the mesh logged {logged}")
    finally:
        torch.distributed.destroy_process_group()
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = flags
        torch.backends.cuda.matmul.allow_tf32 = False

    # (2) Two gloo ranks sharing the card, f32, TF32 off, 2 eager steps on
    # halves of the global batches, against one rank on the global batch.
    tmp = tempfile.TemporaryDirectory(prefix="dp-")
    try:
        batches = [_float_batch(b) for b in host[:2]]
        torch.save({"params": params, "batches": batches}, os.path.join(tmp.name, "inputs.pt"))
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(_dp_rank, args=(pdist.free_port(), tmp.name), nprocs=2)
        ranks = [torch.load(os.path.join(tmp.name, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        seconds = time.perf_counter() - t0
    finally:
        tmp.cleanup()
    differ = [k for k, v in ranks[0]["state"].items() if not torch.equal(v, ranks[1]["state"][k])]
    if differ:
        raise AssertionError(f"the two ranks' states differ in {len(differ)} tensors: {differ[:5]}")
    out["gloo_two_ranks"] = {"seconds": seconds, "state_tensors_equal": len(ranks[0]["state"]),
                             **_hold_step(ranks[0]["first"], plain, own[1], "2 gloo ranks vs 1",
                                          need_stable=False)}

    # (2b) Three gloo ranks, a mesh over ranks [0, 1] (the reference's
    # make_mesh(2)): the same steps give the two-rank run's state bit for
    # bit; rank 2 is refused and keeps its state.
    tmp = tempfile.TemporaryDirectory(prefix="dp3-")
    try:
        torch.save({"params": params, "batches": batches}, os.path.join(tmp.name, "inputs.pt"))
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(_dp_rank, args=(pdist.free_port(), tmp.name, 3), nprocs=3)
        three = [torch.load(os.path.join(tmp.name, f"rank{r}.pt"), weights_only=False)
                 for r in range(3)]
        seconds = time.perf_counter() - t0
    finally:
        tmp.cleanup()
    differ = [k for k, v in ranks[0]["state"].items()
              if not all(torch.equal(v, r["state"][k]) for r in three[:2])]
    refused = three[2]["refused"]
    if differ or not three[2]["state_kept"] or three[2]["step"] != 0 or not all(
            msg and "rank 2 is not in this mesh" in msg for msg in refused.values()):
        raise AssertionError(f"mesh over ranks [0, 1] of 3: {len(differ)} tensors differ from "
                             f"the two-rank run ({differ[:3]}); rank 2: {three[2]}")
    out["gloo_mesh_of_two_in_three"] = {
        "seconds": seconds, "state_tensors_equal_to_two_rank_run": len(ranks[0]["state"]),
        "rank_2_refused": refused, "rank_2_state_kept": True}

    # (3) The CLI: 2 gloo ranks on the CPU; on the card without
    # --num-devices, one device and the plain path (no process group).
    r = subprocess.run([sys.executable, "-m", "depthvo_tpu_torch.cli", "train", "--variant",
                        "tiny_test", "--device", "cpu", "--num-devices", "2", "--steps", "2",
                        "--log-every", "1"], capture_output=True, text=True, timeout=300)
    logged = [ln for ln in r.stdout.splitlines() if ln.startswith("step ")]
    if r.returncode != 0 or len(logged) != 2:
        raise AssertionError(f"cli train --num-devices 2 --device cpu: rc {r.returncode}\n"
                             f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
    argv = ["train", "--variant", variant, "--steps", "2", "--batch-size", str(BATCH),
            "--device", "cuda", "--log-every", "1"]
    _build.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv)
    if rc != 0 or torch.distributed.is_initialized() or torch.cuda.device_count() != 1:
        raise AssertionError(f"cli train on the card: rc {rc}")
    out["cli"] = {"cpu_two_ranks": logged, "card_default": {
        "argv": argv, "launches": _check_counts(_train_launches(cfg), 2),
        "bn_launches": _check_bn_counts(0)}}

    # (4) Eval: predict_depths over a mesh of one replica = mesh=None.
    model = DepthVO.from_random(cfg, device=dev)
    frames = np.random.default_rng(0).integers(0, 256, (10,) + tuple(host[0]["image_t"].shape[1:]),
                                               dtype=np.uint8)
    one_mesh = pmesh.make_mesh(1, device=dev)
    got = predict_depths(model.to_mesh(one_mesh), frames, batch_size=BATCH, mesh=one_mesh)
    want_d = predict_depths(model, frames, batch_size=BATCH)
    if not np.array_equal(got, want_d):
        raise AssertionError("predict_depths over a mesh of one differs from mesh=None")
    out["eval_mesh_of_one"] = {"frames": len(frames), "bit_for_bit": True}
    emit(out)
    return out


def phase_pretrain_feat(variant: str, dev, smi: str):
    """Feature pretraining (A.9) at 608x160, batch 4: card against CPU on
    the same views, ``cli pretrain-feat`` into ``train --init-feat-from``,
    and the pretrain step's time."""
    import os
    import tempfile

    import torch

    from depthvo_tpu_torch import cli, configs
    from depthvo_tpu_torch.data.synthetic import SyntheticScenes
    from depthvo_tpu_torch.io import checkpoint as ckpt_io
    from depthvo_tpu_torch.models import FeatNet
    from depthvo_tpu_torch.train import feat_pretrain as fp
    from depthvo_tpu_torch.train.state import _init_module_, compute_dtype
    from depthvo_tpu_torch.utils.images import to_unit

    cfg = getattr(configs, variant)(batch_size=BATCH)
    out = {"phase": "pretrain_feat", "config": variant,
           "hw": [cfg.model.height, cfg.model.width], "batch": BATCH, "nvidia_smi": smi}
    images = to_unit(torch.from_numpy(SyntheticScenes(cfg, seed=3, u8=True).batch(BATCH)["image_t"]))

    # (1) float32, TF32 off: the loss on the card and on the CPU, the same
    # weights and views (draws made on the CPU).
    torch.backends.cudnn.allow_tf32 = False
    net = FeatNet(out_features=cfg.model.feat_channels)
    _init_module_(net, torch.Generator().manual_seed(0))
    draws = [fp.augment_draws(torch.Generator().manual_seed(s), images.shape, "cpu")
             for s in (1, 2)]
    losses = {}
    for d in (dev, torch.device("cpu")):
        n = FeatNet(out_features=cfg.model.feat_channels).to(d)
        n.load_state_dict(net.state_dict())
        views = [fp.augment_with(images.to(d), *[x.to(d) for x in dr]) for dr in draws]
        with torch.no_grad():
            losses[d.type] = float(fp.dense_infonce_loss(n(views[0]), n(views[1])))
    torch.backends.cudnn.allow_tf32 = True
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    if not rel <= METRIC_RTOL:
        raise AssertionError(f"pretrain loss card vs CPU: {losses}")
    out["f32_card_vs_cpu"] = {"losses": losses, "rel": rel}

    # (2) cli pretrain-feat, then train --init-feat-from: the feature net
    # of the trained checkpoint is the pretrained one (frozen).
    tmp = tempfile.TemporaryDirectory(prefix="pretrain-")
    try:
        feat_dir, run_dir = os.path.join(tmp.name, "feat"), os.path.join(tmp.name, "run")
        with contextlib.redirect_stdout(io.StringIO()):
            rc_pre = cli.main(["pretrain-feat", "--variant", variant, "--batch-size", str(BATCH),
                               "--steps", "5", "--device", "cuda", "--checkpoint-dir", feat_dir])
            rc_train = cli.main(["train", "--variant", variant, "--batch-size", str(BATCH),
                                 "--steps", "2", "--device", "cuda", "--init-feat-from", feat_dir,
                                 "--checkpoint-dir", run_dir])
        pre, trained = ckpt_io.read_weights(feat_dir), ckpt_io.read_weights(run_dir)
        seated = all(torch.equal(v, trained["feat"][k]) for k, v in pre["feat"].items())
        if rc_pre != 0 or rc_train != 0 or not seated:
            raise AssertionError(f"pretrain-feat rc {rc_pre}, train rc {rc_train}, "
                                 f"feature net seated {seated}")
        out["cli"] = {"pretrain_rc": rc_pre, "train_rc": rc_train, "feat_seated": seated}
    finally:
        tmp.cleanup()

    # (3) ms per pretrain step on the default config.
    model = FeatNet(out_features=cfg.model.feat_channels, compute_dtype=compute_dtype(cfg)).to(dev)
    tx = fp.adam(1e-4)
    opt_state = tx.init(dict(model.named_parameters()))
    gen = torch.Generator(device=dev).manual_seed(0)
    step = fp.make_pretrain_step(model, tx)
    x = images.to(dev)
    for _ in range(3):
        opt_state, loss = step(opt_state, gen, x)
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        opt_state, loss = step(opt_state, gen, x)
    torch.cuda.synchronize()
    out["bf16_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / n
    if not math.isfinite(float(loss)):
        raise AssertionError("non-finite pretrain loss")
    emit(out)


BENCH_STEPS = 10
BENCH_WARMUP = 5  # utils.profiling.time_fn's default warm-up calls
DEPTH_LAYER_SUBSET = ("ConvBlock_0", "ResNetStage_3", "ConvBlock_5", "Conv_3")


def _bench(argv) -> dict:
    """``cli bench`` with ``argv``: exit 0, its JSON line."""
    from depthvo_tpu_torch import cli

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(["bench", *argv])
    lines = printed.getvalue().splitlines()
    if rc != 0 or not lines or not lines[-1].startswith("{"):
        raise AssertionError(f"cli bench {argv}: rc {rc}, {lines[-3:]}")
    return json.loads(lines[-1])


def _layer_rows(result: dict, names) -> list:
    """The table's rows, held to the reference's names in order, each
    time non-negative and each cumulative monotone."""
    rows = result["rows"]
    got = [r["layer"] for r in rows]
    times = [r[k] for r in rows for k in ("forward_ms", "backward_ms")]
    cums = [[r[k] for r in rows] for k in ("fwd_cumulative_ms", "bwd_cumulative_ms")]
    if got != list(names) or min(times) < 0 or any(c != sorted(c) for c in cums):
        raise AssertionError(f"layer table {result['mode']}: {rows}")
    return rows


def _nhwc_warps(cfg, dev) -> dict:
    """The NHWC ``ops.stereo_warp`` with a differentiated source (K1, K3)
    and ``ops.frozen_warp`` with a differentiated depth (K4, K5) at the
    finest scale, against the CHW path everywhere and against the plain
    versions (run on the card on the same coordinates and cotangent)
    under ``valid``, forward and gradient: bit for bit."""
    import numpy as np
    import torch

    from depthvo_tpu_torch.configs.base import stereo_dmax
    from depthvo_tpu_torch.data.synthetic import SyntheticScenes
    from depthvo_tpu_torch.geometry import se3

    H, W = cfg.model.height, cfg.model.width
    host = SyntheticScenes(cfg, seed=11, num_scenes=BATCH).fixed_batch(BATCH)
    rng = np.random.default_rng(11)
    K = torch.as_tensor(host["K"], device=dev)
    depth = torch.as_tensor(rng.uniform(4.0, 40.0, (BATCH, H, W)), dtype=torch.float32,
                            device=dev)
    G = torch.as_tensor(rng.normal(size=(BATCH, H, W, 3)), dtype=torch.float32, device=dev)
    out = {}

    # Stereo: the source differentiated, the depth not (K1 forward, K3 backward).
    fxb = K[:, 0, 0] * cfg.stereo_baseline
    dmax = stereo_dmax(cfg, W)
    src = torch.as_tensor(host["image_r"], device=dev)
    u, valid = wk.stereo_warp_prep((H, W), depth, fxb, dmax)
    g = G * valid[..., None]
    src_nhwc = src.clone().requires_grad_(True)
    _build.reset_launches()
    warped, valid_n = ops.stereo_warp(src_nhwc, depth, fxb, dmax=dmax)
    (warped * g).sum().backward()
    torch.cuda.synchronize()
    launches = {k: _build.launch_count(k) for k in wk.KERNELS}
    if launches != {**dict.fromkeys(wk.KERNELS, 0), "stereo_fwd": 1, "stereo_bwd_src": 1}:
        raise AssertionError(f"NHWC stereo_warp launched {launches}")
    src_chw = src.permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    warped_c, valid_c = ops.stereo_warp_chw(src_chw, depth, fxb, dmax=dmax)
    (warped_c * g.permute(0, 3, 1, 2)).sum().backward()
    g_chw = g.permute(0, 3, 1, 2).contiguous()
    plain = wk.stereo_sample_plain(src.permute(0, 3, 1, 2).contiguous(), u)
    plain_dsrc = wk.stereo_bwd_src_plain(g_chw, u, dmax)
    d_src = src_nhwc.grad.permute(0, 3, 1, 2)
    errs = {
        "vs_chw": max(float((warped.permute(0, 3, 1, 2) - warped_c).detach().abs().max()),
                      float((d_src - src_chw.grad).abs().max())),
        "vs_plain": max(masked_max_err(warped.permute(0, 3, 1, 2).detach(), plain, valid),
                        float((d_src - plain_dsrc).abs().max())),
    }
    if not (torch.equal(valid_n, valid) and torch.equal(valid_c, valid)) or max(errs.values()):
        raise AssertionError(f"NHWC stereo_warp: {errs}")
    out["stereo_warp"] = {"launches": launches, "max_abs_err": errs,
                          "valid_share": float(valid.float().mean()), "dmax": dmax}

    # General: the source frozen, the depth differentiated (K4, K5).
    pad_v = cfg.warp_pad_v
    twist = torch.tensor([[0.02, -0.01, -0.3, 0.002, -0.003, 0.001]] * BATCH, device=dev)
    T = se3.exp(twist)
    src = torch.as_tensor(host["image_s"], device=dev)
    grads = {}
    d = depth.clone().requires_grad_(True)
    u, v, valid = ops._frozen_warp_prep((H, W), d, T, K, pad_v)
    g = G * valid[..., None]
    g_chw = g.permute(0, 3, 1, 2).contiguous()
    d_u, d_v = wk.gen_bwd_uv_plain(src.permute(0, 3, 1, 2).contiguous(), g_chw, u.detach(),
                                   v.detach())
    (grads["plain"],) = torch.autograd.grad([u, v], d, [d_u, d_v])
    plain = wk.gen_sample_plain(src.permute(0, 3, 1, 2).contiguous(), u.detach(), v.detach())
    d = depth.clone().requires_grad_(True)
    _build.reset_launches()
    warped, valid_n = ops.frozen_warp(src, d, T, K, pad_v=pad_v)
    (warped * g).sum().backward()
    torch.cuda.synchronize()
    launches = {k: _build.launch_count(k) for k in wk.KERNELS}
    if launches != {**dict.fromkeys(wk.KERNELS, 0), "gen_fwd": 1, "gen_bwd_uv": 1}:
        raise AssertionError(f"NHWC frozen_warp launched {launches}")
    grads["nhwc"] = d.grad
    d = depth.clone().requires_grad_(True)
    warped_c, valid_c = ops.frozen_warp_chw(src.permute(0, 3, 1, 2), d, T, K, pad_v=pad_v)
    (warped_c * g_chw).sum().backward()
    grads["chw"] = d.grad
    errs = {
        "vs_chw": max(float((warped.permute(0, 3, 1, 2) - warped_c).detach().abs().max()),
                      float((grads["nhwc"] - grads["chw"]).abs().max())),
        "vs_plain": max(masked_max_err(warped.permute(0, 3, 1, 2).detach(), plain, valid),
                        float((grads["nhwc"] - grads["plain"]).abs().max())),
    }
    if not (torch.equal(valid_n, valid) and torch.equal(valid_c, valid)) or max(errs.values()):
        raise AssertionError(f"NHWC frozen_warp: {errs}")
    if not float(grads["nhwc"].abs().max()) > 0:
        raise AssertionError("NHWC frozen_warp: no gradient reached the depth")
    out["frozen_warp"] = {"launches": launches, "max_abs_err": errs,
                          "valid_share": float(valid.float().mean()), "pad_v": pad_v}
    return out


def _train_flags(variant: str, cfg) -> dict:
    """``cli train --iter-size 2 --remat --debug-nans --steps-per-call 2``
    under the graph; ``--debug-nans`` on a run whose learning rate turns
    infinite at update 2 (``--config``); ``--tensorboard``."""
    import os
    import tempfile

    from depthvo_tpu_torch import cli
    from depthvo_tpu_torch.configs import base as config_base

    out = {}
    base = ["train", "--batch-size", str(BATCH), "--device", "cuda", "--log-every", "1"]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(base + ["--variant", variant, "--iter-size", "2", "--remat",
                              "--debug-nans", "--steps", "4", "--steps-per-call", "2"])
    lines = [ln for ln in printed.getvalue().splitlines() if ln.startswith("step ")]
    if rc != 0 or [ln.split(":")[0] for ln in lines] != ["step 1", "step 3"]:
        raise AssertionError(f"cli train --iter-size 2 --remat --debug-nans: rc {rc}, {lines}")
    out["iter_size_remat_debug_nans"] = {"rc": rc, "logged": lines}

    tmp = tempfile.TemporaryDirectory(prefix="flags-")
    try:
        bad = dataclasses.replace(cfg, checkpoint_every=1, optim=dataclasses.replace(
            cfg.optim, lr_policy="multistep", lr_step_values=(2,),
            lr_decay_factor=float("inf"), warmup_steps=0))
        cfg_path, ckpt = os.path.join(tmp.name, "inf_lr.json"), os.path.join(tmp.name, "ckpt")
        config_base.save_json(bad, cfg_path)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["train", "--config", cfg_path, "--device", "cuda", "--steps", "4",
                          "--steps-per-call", "2", "--debug-nans", "--checkpoint-dir", ckpt])
        except FloatingPointError as e:
            message = str(e)
        else:
            raise AssertionError("--debug-nans did not raise on an infinite learning rate")
        saved = sorted(int(n) for n in os.listdir(ckpt) if n.isdigit())
        if "after step 3" not in message or saved != [2]:
            raise AssertionError(f"--debug-nans: {message!r}, checkpoints {saved}")
        out["debug_nans_injected"] = {"message": message, "checkpoints": saved}

        tb = os.path.join(tmp.name, "tb")
        argv = base + ["--variant", variant, "--steps", "2", "--tensorboard", tb]
        try:
            import torch.utils.tensorboard  # noqa: F401
        except ModuleNotFoundError:
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    cli.main(argv)
            except ModuleNotFoundError as e:
                if "--tensorboard needs torch + tensorboard" not in str(e):
                    raise
                out["tensorboard"] = {"installed": False, "error": str(e)}
            else:
                raise AssertionError("--tensorboard ran without the tensorboard package")
        else:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(argv)
            events = [n for n in os.listdir(tb) if n.startswith("events.")]
            if rc != 0 or not events:
                raise AssertionError(f"--tensorboard: rc {rc}, {os.listdir(tb)}")
            out["tensorboard"] = {"installed": True, "event_files": events}
    finally:
        tmp.cleanup()
    return out


def phase_bench(variant: str, dev, smi: str, scan_graph_ms: float, train_eager_ms: float):
    """``cli device-query``, ``cli bench`` in every mode, the NHWC warps and
    the ``cli train`` flags of A.10-A.13 on the card."""
    import os
    import tempfile

    import torch

    from depthvo_tpu_torch import cli, configs

    cfg = getattr(configs, variant)(batch_size=BATCH)
    H, W = cfg.model.height, cfg.model.width
    out = {"phase": "bench", "config": variant, "hw": [H, W], "batch": BATCH,
           "nvidia_smi": smi}

    # (1) device-query against the device's own properties.
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(["device-query"])
    query = json.loads(printed.getvalue().splitlines()[-1])
    prop = torch.cuda.get_device_properties(0)
    want = {"name": prop.name, "capability": [prop.major, prop.minor],
            "sm_count": prop.multi_processor_count, "total_memory": prop.total_memory}
    got = {k: query["devices"][0][k] for k in want}
    if rc != 0 or got != want or len(query["devices"]) != torch.cuda.device_count():
        raise AssertionError(f"device-query: rc {rc}, {query} vs {want}")
    out["device_query"] = query

    # (2) The train modes: every step launches the train phase's kernels
    # (counted in the counters, K per call under replay); ms/step beside
    # the train and scan phases' numbers for the same steps.
    common = ["--variant", variant, "--batch-size", str(BATCH), "--height", str(H),
              "--width", str(W), "--device", "cuda"]
    per_step = _train_launches(cfg)
    for mode, steps_run in (("train_step", 1 + BENCH_WARMUP + BENCH_STEPS),
                            ("train_step_scan", 1 + (BENCH_WARMUP + BENCH_STEPS) * SCAN_K)):
        _build.reset_launches()
        res = _bench(common + ["--mode", mode, "--steps", str(BENCH_STEPS)])
        launches = _check_counts(per_step, steps_run)
        out[mode] = {"ms_per_step": res["median_s"] * 1e3, "frames_per_s": res["frames_per_sec"],
                     "flops_per_step": res["flops_per_step"], "mfu": res.get("mfu"),
                     "bf16_peak_tflops_assumed": res.get("bf16_peak_tflops_assumed"),
                     "steps_run": steps_run, "launches": launches, "result": res}
    out["train_step"]["train_phase_eager_ms"] = train_eager_ms
    scan_ms = out["train_step_scan"]["ms_per_step"]
    out["train_step_scan"]["scan_phase_graph_ms"] = scan_graph_ms
    if not abs(scan_ms - scan_graph_ms) <= 0.15 * scan_graph_ms:
        raise AssertionError(f"bench train_step_scan {scan_ms} ms/step, scan phase "
                             f"{scan_graph_ms} ms/step")

    # (3) --trace-dir: the four kernels of the step in the Chrome trace.
    tmp = tempfile.TemporaryDirectory(prefix="trace-")
    try:
        _bench(common + ["--mode", "train_step", "--steps", "1", "--trace-dir", tmp.name])
        path = os.path.join(tmp.name, "trace.json")
        with open(path) as f:
            text = f.read()
        names = [name for k in per_step for name in wk.KERNELS[k]]
        found = {n: text.count(n) for n in names}
        if not all(found.values()):
            raise AssertionError(f"trace {path}: {found}")
        out["trace"] = {"bytes": len(text), "kernel_mentions": found}
    finally:
        tmp.cleanup()

    # (4) Inference and the warp: frames/s.
    for name, argv in (("depth_infer_bf16", ["--mode", "depth_infer"]),
                       ("depth_infer_int8", ["--mode", "depth_infer", "--int8"]),
                       ("odom_infer", ["--mode", "odom_infer"]),
                       ("warp", ["--mode", "warp"])):
        res = _bench(common + argv + ["--steps", str(2 * BENCH_STEPS)])
        out[name] = {"ms_per_batch": res["median_s"] * 1e3, "frames_per_s": res["frames_per_sec"]}

    # (5) The layer tables: a subset of DepthNet's, OdomNet's and FeatNet's whole.
    t0 = time.perf_counter()
    depth = profiling.depth_layer_table(BATCH, H, W, BENCH_STEPS, variant,
                                        layers=DEPTH_LAYER_SUBSET, device=dev)
    names = [b for b in profiling.depth_layer_order(cfg.model.num_scales)
             if b in DEPTH_LAYER_SUBSET]
    out["depth_layers"] = _layer_rows(depth, names)
    for net, order in (("odom", profiling.odom_layer_order()),
                       ("feat", profiling.feat_layer_order())):
        res = _bench(common + ["--mode", f"{net}_layers", "--steps", str(BENCH_STEPS)])
        out[f"{net}_layers"] = _layer_rows(res, order)
    out["layer_tables_seconds"] = time.perf_counter() - t0

    # (6) The NHWC warps; (7) the train flags.
    out["nhwc_warps"] = _nhwc_warps(_f32_config(cfg), dev)
    out["train_flags"] = _train_flags(variant, cfg)
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
    border = phase_border(dev)
    reproj = phase_reproj(dev)[0]
    md2_bn = phase_md2_bn(dev)
    md2 = phase_md2(dev, smi)
    phase_slice("full_feat", dev)
    train_launches, premade_ms = phase_train("full_feat", dev)
    scan = phase_scan("full_feat", dev, smi)
    phase_learn("full_feat", dev, smi)
    phase_kitti_ckpt("full_feat", dev, smi, premade_ms)
    phase_orbax("full_feat", dev, smi)
    fixtures = phase_eval("full_feat", dev, smi)
    phase_int8_serving("full_feat", dev, smi, fixtures)
    phase_caffe("full_feat", dev, smi)
    dp = phase_dp("full_feat", dev, smi)
    phase_pretrain_feat("full_feat", dev, smi)
    phase_bench("full_feat", dev, smi, scan["bf16_premade"]["graph"]["ms_per_step"], premade_ms)
    phase_serve(dev)

    pallas = "depthvo_tpu/ops/warp_pallas.py"
    replaces = {"stereo_fwd": f"{pallas}:102", "stereo_bwd_u": f"{pallas}:126",
                "stereo_bwd_src": f"{pallas}:148", "gen_fwd": f"{pallas}:523",
                "gen_fwd_aux": f"{pallas}:523", "gen_bwd_uv": f"{pallas}:651"}
    sources = {**dict.fromkeys(wk.KERNELS, "warp.cu"), **dict.fromkeys(rp.KERNELS, "reproj.cu"),
               **dict.fromkeys(bn.KERNELS, "batch_norm.cu"),
               **dict.fromkeys(mbn.KERNELS, "md2_batch_norm.cu")}
    summary = []
    for kernel in ops.KERNELS:
        row = {"name": kernel, "route": "cuda",
               "source": f"depthvo_tpu_torch/ops/csrc/{sources[kernel]}"}
        summary.append(row)
        if kernel in replaces:
            mine = [r for r in rows if r["kernel"] == kernel]
            grouped = [r for r in mine if r.get("pyramid")]
            # Per step or batch of the main path: the grouped launches where
            # the path makes them (beside its segments' one-segment launches
            # timed together), else one launch at each shape, summed.
            timed = grouped or mine
            row.update({
                "replaces": replaces[kernel],
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
                "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in timed)
                else "operations",
                "library_ms": sum(r["library_ms"] for r in timed),
            } | ({"per_scale_ms": grouped[0]["per_scale_ms"]} if grouped else {}))
        elif kernel in bn.KERNELS:
            # The global BatchNorm under a mesh (not a TPU kernel): the bf16
            # step's times over its 53 layers, float32's beside them.
            by = {r["dtype"]: r for r in rows if r["kernel"] == kernel}
            launches = dp["cli_rank"]["bn_launches"][kernel]
            row.update({
                "replaces": "depthvo_tpu/models/layers.py:156",
                "replaces_what": "flax nn.BatchNorm under a jit sharded over a mesh; not a "
                                 "TPU kernel",
                "path": "cli train --num-devices N", "launches": launches,
                "launches_per_step": launches // dp["cli_rank"]["steps"],
                "max_abs_err": max(r["max_abs_err"] for r in by.values()),
                "ms": by["bfloat16"]["ms"], "plain_ms": by["bfloat16"]["plain_ms"],
                "bound_ms": by["bfloat16"]["bound_ms"], "bound_by": by["bfloat16"]["bound_by"],
                "library_ms": by["bfloat16"]["library_ms"], "dtype": "bfloat16",
                "float32_ms": by["float32"]["ms"]})
        elif kernel in mbn.KERNELS:
            # Monodepth2's encoder BatchNorm (not a TPU kernel): the bf16
            # step's times over its 60 layers, float32's beside them.
            way = kernel.removeprefix("md2_bn_")
            step = md2_bn["step_us"]
            row.update({
                "replaces": "none: F.batch_norm (train mode) and the F.relu after the stem's "
                            "and every BasicBlock's bn1, in Monodepth2's ResNet18 encoders",
                "path": "cli train --variant monodepth2_ms",
                "launches_per_step": md2["launches"][kernel] // 16,
                "ms": step["bfloat16"][way] / 1e3, "float32_ms": step["float32"][way] / 1e3,
                "dtype": "bfloat16", "layers_ms": step["bfloat16"]["kernels"] / 1e3,
                "layers_bound_ms": step["bfloat16"]["bound"] / 1e3,
                "layers_plain_ms": step["bfloat16"]["plain"] / 1e3,
                "layers_library_ms": step["bfloat16"]["library"] / 1e3})
        elif kernel in rp.KERNELS:
            way = kernel.removeprefix("reproj_")
            row.update({
                "replaces": "none: Monodepth2's compute_reprojection_loss (SSIM and L1)"
                            + ("" if way == "fwd" else ", autograd's backward to pred"),
                "path": "cli train --variant monodepth2_ms",
                "launches_per_step": md2["launches"][kernel] // 16,
                "ms": reproj[f"{way}_us"] / 1e3, "bound_ms": reproj[f"{way}_bound_us"] / 1e3,
                "bound_by": reproj["bound_by"],
                "plain_ms": reproj["fwd_plain_us" if way == "fwd" else "fwd_bwd_plain_us"] / 1e3})
        else:  # Monodepth2's border warp
            way = "fwd" if kernel == "gen_fwd_border" else "bwd"
            row.update({
                "replaces": "none: Monodepth2's F.grid_sample(padding_mode='border', "
                            "align_corners=True)" + ("" if way == "fwd" else " backward"),
                "path": "cli train --variant monodepth2_ms",
                "launches_per_step": md2["launches"][kernel] // 16,
                "ms": border[f"{way}_ms"], "bound_ms": border[f"{way}_bound_ms"],
                "bound_by": border["bound_by"], "library_ms": border[f"{way}_library_ms"],
                "k4_k5_ms": border[f"{way}_k4_ms" if way == "fwd" else "bwd_k5_ms"]})
    print(smi, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
