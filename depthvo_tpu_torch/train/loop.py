"""The staged loss graph, the train step, the host training loop and the
held-out loss pass (counterpart of ``depthvo_tpu/train/loop.py``:
``compute_losses``, ``make_train_step``, ``fit``, ``SolverSignals``,
``make_eval_step``, ``run_validation``).

Loss graph (full variant; the config's switches select the stage):

  disp_pyramid = DepthNet(I_t)                         # multi-scale
  twist        = OdomNet([I_t, I_s]);  T_ts = se3.exp(twist)
  per scale s:
    stereo:   warp(I_r -> I_t view, depth_s, fx*b)     -> masked L1  (K1; K2)
    temporal: warp(I_s -> I_t view, depth_s, T_ts)     -> masked L1  (K4, C=3)
    smoothness(disp_s, I_t)
  finest scale only:
    temporal + feature: one warp of [I_s, F(I_s)]      -> masked L1  (K4, C=3+16)

The warps of all scales run as one grouped launch per forward kernel (one
K1 over the stereo scales, one K4 over the temporal scales and the fused
payload); the losses then add up per scale in the reference's order.
Images are NHWC in [-1, 1] (or raw uint8) at the entry, as in the
reference; the photometric region runs in the kernels' (B, C, H, W)
layout. In train mode the depth net's BatchNorm uses and updates batch
statistics, and autograd differentiates the warps through the kernels'
``autograd.Function``s (``ops/warp_kernels.py``); the backward kernels
run per scale, and the sources are data, so the stereo backward launches
K2 and not K3. ``make_train_step`` is eager: one forward, one backward and
one solver update per call. ``make_scan_train_step`` runs K steps per
call; on a GPU it captures the whole step once as a CUDA graph and
replays it per step.
"""

from __future__ import annotations

import collections
import contextlib
import os
import signal
import time
from typing import Callable, Dict, Iterator, NamedTuple

import numpy as np
import torch

from depthvo_tpu_torch import ops
from depthvo_tpu_torch.configs import base as config_base
from depthvo_tpu_torch.configs.base import ExperimentConfig
from depthvo_tpu_torch.data.pipeline import prefetch_to_device, stack_batches, stacked_batches
from depthvo_tpu_torch.geometry import se3, warp as geo_warp
from depthvo_tpu_torch.geometry.camera import scale_intrinsics
from depthvo_tpu_torch.io import checkpoint as ckpt_io
from depthvo_tpu_torch.losses.photometric import (
    masked_l1_chw,
    photometric_loss_chw,
    valid_counts,
)
from depthvo_tpu_torch.losses.smoothness import smoothness_loss
from depthvo_tpu_torch.models import layers
from depthvo_tpu_torch.models.layers import resize_bilinear_chw
from depthvo_tpu_torch.ops import warp_kernels
from depthvo_tpu_torch.parallel import distributed as pdist, mesh as pmesh
from depthvo_tpu_torch.train import optim
from depthvo_tpu_torch.train.state import (
    DTYPES,
    Models,
    TrainState,
    create_state,
    make_optimizer,
    param_tree,
)
from depthvo_tpu_torch.utils.device import resolve_device
from depthvo_tpu_torch.utils.images import to_unit


def compute_losses(config: ExperimentConfig, models: Models,
                   batch: Dict[str, torch.Tensor], train: bool = False, mesh=None):
    """Evaluate the staged loss graph.

    Args:
      models: the stage's networks (``train.state.Models``), on the
        batch's device. ``train`` puts them in train mode (BatchNorm batch
        statistics, running averages updated in place) or eval mode.
      batch: tensors on one device: 'image_t', 'image_r' (if use_stereo),
        'image_s' (if use_temporal) as (B,H,W,3) float in [-1,1] or raw
        uint8; 'K' (B,3,3) at full resolution; optional 'baseline' (B,).
      mesh: a data-parallel mesh of ranks (``parallel.mesh``), ``batch``
        being this rank's rows of the global batch. The photometric and
        feature terms then divide by the global batch's valid counts (one
        all-reduce of every scale's counts) and the means by the number of
        ranks (equal shards), so the ranks' totals sum to the reference's
        loss on the global batch. BatchNorm's global statistics are the
        caller's (``models.layers.global_statistics``).

    Returns: (total_loss, metrics dict of scalar tensors). Both carry the
    autograd graph where grad mode is on. With a mesh ``total`` is this
    rank's share and the metrics are the global batch's, reduced in one
    all-reduce and detached.
    """
    if config.use_feature and not config.use_temporal:
        raise ValueError(
            "use_feature requires use_temporal (the feature loss warps "
            "with the predicted pose)"
        )
    depth_net, odom_net, feat_net = models.train(train)
    batch = {
        k: to_unit(v) if v.dtype == torch.uint8 else v for k, v in batch.items()
    }
    image_t = batch["image_t"]
    K = batch["K"]
    B, H, W, _ = image_t.shape
    baseline = batch.get("baseline")
    if baseline is None:
        baseline = config.stereo_baseline

    disps = depth_net(image_t)
    metrics: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=image_t.device)

    T_ts = None
    if config.use_temporal:
        twist = odom_net(torch.cat([image_t, batch["image_s"]], dim=-1))
        T_ts = se3.exp(twist)
        metrics["twist_norm"] = torch.mean(torch.linalg.norm(twist, dim=-1))
        if mesh is not None:
            metrics["twist_norm"] = metrics["twist_norm"] / mesh.size

    loss_dtype = DTYPES[config.loss_dtype]

    def to_chw(x):
        return x.to(loss_dtype).permute(0, 3, 1, 2)

    image_t_chw = to_chw(image_t)
    image_r_chw = to_chw(batch["image_r"]) if config.use_stereo else None
    image_s_chw = to_chw(batch["image_s"]) if config.use_temporal else None

    def at_scale(img_chw, h, w):
        return img_chw if (h, w) == (H, W) else resize_bilinear_chw(img_chw, h, w)

    # Every scale's inputs first (coarsest -> finest): the warps of all
    # scales then run as one launch per kernel.
    n_scales = len(disps)
    hws = [tuple(disp.shape[1:3]) for disp in disps]
    Kss = [scale_intrinsics(K, w / W, h / H) for h, w in hws]
    img_ts = [at_scale(image_t_chw, h, w) for h, w in hws]
    depths = [1.0 / disp[..., 0] for disp in disps]

    # Finest scale: temporal and feature losses sample the source at the
    # same coordinates, so RGB and features share one 19-channel warp.
    fused = config.use_temporal and config.use_feature
    if fused:
        # The frozen feature net gets no gradient (the reference's
        # stop_gradient on its parameters): run it without a graph.
        with contextlib.nullcontext() if config.train_feat else torch.no_grad():
            feat_t_chw = feat_net.forward_chw(image_t.permute(0, 3, 1, 2)).to(loss_dtype)
            feat_s_chw = feat_net.forward_chw(
                batch["image_s"].permute(0, 3, 1, 2)
            ).to(loss_dtype)
        depth_full = depths[-1]
        if config.train_feat:
            # NHWC in memory, as the plain warp below reads it.
            payload = torch.cat([image_s_chw, feat_s_chw], dim=1)
        else:
            payload = fused_payload(image_s_chw, feat_s_chw)
        del feat_s_chw

    # One grouped stereo warp over every scale, one grouped general warp
    # over the temporal scales and (unless the feature net trains) the
    # fused finest payload. The gradient nodes are made below, where the
    # losses are, so autograd runs each right after its loss's backward,
    # as with one warp launch per scale; the stereo warp's coarse scales
    # share one node, made at the coarsest loss, which runs one K2 launch
    # after all their losses' backwards.
    if config.use_stereo:
        stereo = ops.stereo_warp_pyramid_chw(
            [at_scale(image_r_chw, h, w) for h, w in hws], depths,
            [Ks[..., 0, 0] * baseline for Ks in Kss],
            [config_base.stereo_dmax(config, w) for _, w in hws],
        )
    temporal_scales = [i for i, hw in enumerate(hws)
                       if config.use_temporal and not (hw == (H, W) and fused)]
    gen_srcs = [at_scale(image_s_chw, *hws[i]) for i in temporal_scales]
    gen_depths = [depths[i] for i in temporal_scales]
    gen_Ks = [Kss[i] for i in temporal_scales]
    if fused and not config.train_feat:
        gen_srcs.append(payload)
        gen_depths.append(depth_full)
        gen_Ks.append(K)
    general = (ops.frozen_warp_pyramid_chw(gen_srcs, gen_depths, T_ts, gen_Ks,
                                           pad_v=config.warp_pad_v)
               if gen_srcs else [])
    temporal = dict(zip(temporal_scales, general))

    # With a mesh: every denominator's count of the global batch, one
    # all-reduce (counts need no gradient).
    stereo_n, temporal_n, fused_n = [None] * n_scales, [None] * n_scales, None
    if mesh is not None:
        valids = (stereo.valids if config.use_stereo else []) + (
            general.valids if gen_srcs else [])
        counts = _global_counts(valids, config.ssim_weight, mesh)
        if config.use_stereo:
            stereo_n, counts = counts[:n_scales], counts[n_scales:]
        for i, c in zip(temporal_scales, counts):
            temporal_n[i] = c
        if fused and not config.train_feat:
            fused_n = counts[-1]

    # The loss terms in the reference's order: coarsest to finest, then
    # the fused finest warp's temporal term.
    stereo_total = torch.zeros((), device=image_t.device)
    temporal_total = torch.zeros((), device=image_t.device)
    smooth_total = torch.zeros((), device=image_t.device)
    for i, (disp, img_t) in enumerate(zip(disps, img_ts)):
        if config.use_stereo:
            warped, valid = stereo[i]()
            stereo_total = stereo_total + photometric_loss_chw(
                warped, img_t, valid, config.ssim_weight, stereo_n[i]
            )
        if i in temporal:
            warped, valid = temporal[i]()
            temporal_total = temporal_total + photometric_loss_chw(
                warped, img_t, valid, config.ssim_weight, temporal_n[i]
            )
        smooth = smoothness_loss(
            disp, img_t, edge_aware=config.edge_aware_smoothness,
            image_layout="chw",
        )
        if mesh is not None:
            smooth = smooth / mesh.size
        smooth_total = smooth_total + smooth / (2.0 ** (n_scales - 1 - i))

    feat_loss = None
    if fused:
        if config.train_feat:
            # feat_s carries gradients: the differentiable plain warp
            # (the reference's XLA gather/scatter path, no window term).
            warped_hwc, valid = geo_warp.inverse_warp(
                payload.permute(0, 2, 3, 1), depth_full, T_ts, K
            )
            warped = warped_hwc.permute(0, 3, 1, 2)
            if mesh is not None:
                fused_n = _global_counts([valid], config.ssim_weight, mesh)[0]
        else:
            warped, valid = general[-1]()
        temporal_total = temporal_total + photometric_loss_chw(
            warped[:, :3], image_t_chw, valid, config.ssim_weight, fused_n
        )
        feat_loss = config.feature_weight * masked_l1_chw(
            warped[:, 3:], feat_t_chw, valid, None if fused_n is None else fused_n[0]
        )

    if config.use_stereo:
        metrics["loss/stereo"] = config.stereo_weight * stereo_total / n_scales
        total = total + metrics["loss/stereo"]
    if config.use_temporal:
        metrics["loss/temporal"] = config.temporal_weight * temporal_total / n_scales
        total = total + metrics["loss/temporal"]
    metrics["loss/smooth"] = config.smooth_weight * smooth_total / n_scales
    total = total + metrics["loss/smooth"]
    if feat_loss is not None:
        metrics["loss/feature"] = feat_loss
        total = total + feat_loss
    metrics["loss/total"] = total
    metrics["disp/mean"] = torch.mean(disps[-1])
    if mesh is not None:
        metrics["disp/mean"] = metrics["disp/mean"] / mesh.size
        metrics = _global_metrics(metrics, mesh)
    return total, metrics


def _global_counts(valids, ssim_weight: float, mesh) -> list:
    """Per mask, its :func:`losses.photometric.valid_counts` summed over
    the mesh's ranks, all in one all-reduce."""
    parts = [valid_counts(v, ssim_weight) for v in valids]
    flat = torch.cat(parts)
    torch.distributed.all_reduce(flat, group=mesh.group)
    return list(flat.split([p.numel() for p in parts]))


def _global_metrics(metrics: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The ranks' shares of each metric summed (one all-reduce), detached."""
    flat = torch.stack([v.detach().float() for v in metrics.values()])
    torch.distributed.all_reduce(flat, group=mesh.group)
    return dict(zip(metrics, flat.unbind()))


def fused_payload(image_chw: torch.Tensor, feat_chw: torch.Tensor) -> torch.Tensor:
    """``torch.cat([image_chw, feat_chw], dim=1)``, written once into a
    contiguous (B, 3+C, H, W) tensor, the layout the general warp's kernel
    reads. The inputs are NHWC in memory, so ``torch.cat`` would give NHWC
    strides and the warp a second, contiguous copy, both live at the train
    step's peak (and, for a CUDA graph, in its pool for the whole run)."""
    n = image_chw.shape[1]
    out = image_chw.new_empty((image_chw.shape[0], n + feat_chw.shape[1])
                              + tuple(image_chw.shape[2:]))
    out[:, :n] = image_chw
    out[:, n:] = feat_chw
    return out


def batch_to_device(batch: Dict[str, np.ndarray | torch.Tensor],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """Host batch (numpy) -> tensors on ``device``; uint8 stays uint8.
    Arrays arrive C-contiguous whatever their strides on the host, as
    the prefetch's pinned slots and a CUDA graph's static batch hold them
    (a layout changes the convolutions' rounding). Tensors already on
    ``device`` (a prefetched batch, ``data.pipeline.prefetch_to_device``)
    pass straight through."""
    return {
        k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v)).contiguous()).to(
            device, non_blocking=True)
        for k, v in batch.items()
    }


def make_eval_step(config: ExperimentConfig, device: str | torch.device | None = None,
                   *, mesh=None
                   ) -> Callable[[Models, Dict[str, np.ndarray]], Dict[str, torch.Tensor]]:
    """Eval-mode loss evaluation (no update, BN running statistics).

    Returns ``eval_fn(models, host_batch) -> metrics`` running on
    ``device`` (default ``cuda``; raises when there is no GPU unless
    ``device="cpu"``). With ``mesh`` (a mesh of ranks) ``host_batch`` is
    this rank's rows and the metrics are the global batch's
    (:func:`compute_losses`). The reference needs no such parameter: its
    batch's sharding carries the mesh.
    """
    dev = resolve_device(device)
    mesh = pmesh.training_mesh(mesh, "make_eval_step")

    def eval_fn(models: Models, batch: Dict[str, np.ndarray]):
        with torch.inference_mode():
            _, metrics = compute_losses(
                config, models, batch_to_device(batch, dev), train=False, mesh=mesh
            )
        return metrics

    return eval_fn


def run_validation(eval_fn, models: Models, eval_iter: Iterator[Dict[str, np.ndarray]],
                   eval_steps: int, mesh=None) -> Dict[str, float]:
    """Average the loss terms over ``eval_steps`` held-out batches (the
    Caffe solver test phase). Returns metrics under a ``val/`` prefix.
    With ``mesh`` every rank reads the same global batches and keeps its
    rows (``parallel.distributed.local_slice``); ``eval_fn`` is
    :func:`make_eval_step`'s over the same mesh."""
    mesh = pmesh.training_mesh(mesh, "run_validation")
    totals: Dict[str, float] = {}
    for _ in range(eval_steps):
        batch = next(eval_iter)
        if mesh is not None:
            batch = pdist.local_slice(batch, divisor=mesh.size)
        metrics = eval_fn(models, batch)
        for k, v in metrics.items():
            totals[k] = totals.get(k, 0.0) + float(v)
    return {f"val/{k}": v / max(eval_steps, 1) for k, v in totals.items()}


class _GradSum:
    """The data-parallel gradient reduction: the trainable parameters'
    gradients copied into one preallocated flat float32 buffer, one SUM
    all-reduce over the mesh's group, copied back. The frozen feature
    net's parameters are not in it."""

    def __init__(self, config: ExperimentConfig, mesh):
        self.config, self.mesh = config, mesh
        self.buf = None

    def __call__(self, grads: Dict[str, torch.Tensor]) -> None:
        gs = [g for k, g in grads.items()
              if self.config.train_feat or not k.startswith("feat.")]
        n = sum(g.numel() for g in gs)
        if self.buf is None or self.buf.numel() != n or self.buf.device != gs[0].device:
            self.buf = torch.empty(n, dtype=torch.float32, device=gs[0].device)
        torch.cat([g.reshape(-1) for g in gs], out=self.buf)
        torch.distributed.all_reduce(self.buf, group=self.mesh.group)
        torch._foreach_copy_(gs, [v.view_as(g) for v, g in
                                  zip(self.buf.split([g.numel() for g in gs]), gs)])


def _train_body(config: ExperimentConfig, tx: optim.Transform, state: TrainState,
                batch: Dict[str, torch.Tensor], hyper,
                reduce: _GradSum | None = None) -> Dict[str, torch.Tensor]:
    """One train step's device work, shared by the eager step and the
    captured graph: the forward in train mode on ``batch`` (tensors on the
    step's device), the backward into the parameters' ``.grad`` (which the
    caller has cleared), then the solver's ``apply`` with the plan's numbers
    ``hyper`` (0-dim tensors), parameters, BatchNorm statistics and solver
    state all updated in place. Returns the metrics (detached).

    With ``reduce`` (a mesh) the forward and backward run with BatchNorm's
    statistics over the mesh's global batch, the loss is this rank's share
    (:func:`compute_losses`), and the gradients are summed over the ranks
    before the norm and the solver, so every rank applies the reference's
    update of the global batch."""
    params = param_tree(state.models)
    mesh = None if reduce is None else reduce.mesh
    with layers.global_statistics(state.models, None if mesh is None else mesh.group):
        total, metrics = compute_losses(config, state.models, batch, train=True, mesh=mesh)
        total.backward()
    with torch.no_grad():
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in params.items()}
        if reduce is not None:
            reduce(grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad/global_norm"] = optim.global_norm(grads)
        optim.apply_updates(params, tx.apply(grads, state.opt_state, params, hyper))
    return metrics


def _hyper_table(plans, device: torch.device) -> torch.Tensor:
    """The numbers of one plan per step as a (steps, n) float32 table on
    ``device``, rows padded with zeros, in one copy."""
    rows = [optim.hyper_leaves(h) for h in plans]
    table = np.zeros((len(rows), max(map(len, rows))), np.float32)
    for k, row in enumerate(rows):
        table[k, :len(row)] = row
    return torch.from_numpy(table).to(device, non_blocking=True)


def make_train_step(config: ExperimentConfig, mesh=None,
                    device: str | torch.device | None = None
                    ) -> Callable[[TrainState, Dict[str, np.ndarray]], tuple]:
    """The train step: ``step_fn(state, host_batch) -> (state, metrics)``;
    the reference's parameters, then ``device``.

    One eager forward in train mode, one backward, then the solver update
    of :func:`train.state.make_optimizer` applied in place; ``state`` is
    updated in place and returned. ``metrics`` are the loss terms of
    :func:`compute_losses` (detached, on the device) plus
    ``grad/global_norm``, the norm of every parameter's gradient (frozen
    ones count as zero) before clipping. Runs on ``device`` (default
    ``cuda``; raises when there is no GPU unless ``device="cpu"``).

    ``mesh`` (a mesh of ranks, ``parallel.mesh.make_mesh`` in a process
    group): every rank calls the step with its rows of the global batch
    (``parallel.distributed.local_slice``) and the same state
    (``parallel.mesh.replicate``); the step computes the reference's step
    on the global batch: BatchNorm's statistics, the loss normalizers, the
    gradients (one SUM all-reduce after the backward) and the metrics are
    the global batch's, and the ranks' states stay equal.
    """
    mesh = pmesh.training_mesh(mesh, "make_train_step")
    dev = resolve_device(device)
    tx = make_optimizer(config)
    reduce = None if mesh is None else _GradSum(config, mesh)

    def step_fn(state: TrainState, batch: Dict[str, np.ndarray]):
        for p in param_tree(state.models).values():
            p.grad = None
        hyper, opt_state = tx.plan(state.opt_state)
        metrics = _train_body(config, tx, state, batch_to_device(batch, dev),
                              optim.hyper_fill(hyper, _hyper_table([hyper], dev)[0]), reduce)
        state.opt_state = opt_state
        state.step += 1
        return state, metrics

    return step_fn


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    scalars: torch.Tensor  # the plan's numbers the graph reads
    metrics: Dict[str, torch.Tensor]  # what each replay writes
    launches: collections.Counter  # the warp kernels' launches per replay


def _state_tensors(state: TrainState) -> list:
    """Every tensor a graph of the step updates in place."""
    def leaves(tree):
        if torch.is_tensor(tree):
            return [tree]
        if isinstance(tree, (tuple, list)):
            return [x for t in tree for x in leaves(t)]
        return []

    buffers = [b for net in state.models if net is not None for b in net.buffers()]
    return list(param_tree(state.models).values()) + buffers + leaves(state.opt_state)


class _GraphedSteps:
    """The train step as CUDA graphs on one GPU, replayed once per step.

    A graph is captured per branch of the solver's plan (one; two with
    ``iter_size > 1``: accumulate only, accumulate and update), all in one
    memory pool, bound to the storage of the state's tensors, to one
    layout of the batch (keys, per-step shapes, dtypes) and to the TF32
    and cuDNN settings. Before capturing a branch, its step runs eagerly
    once on a side stream: cuDNN, cuBLAS and the allocator set themselves
    up there, outside the capture, and that step is a real, counted step
    of the run. The capture executes nothing; the next steps of that
    branch replay it. Before each replay the host copies the step's batch
    into the static batch and the plan's numbers into the graph's own
    scalars. When the binding changes (a state whose tensors were
    rebound, another batch layout, another TF32 setting) every graph is
    dropped and captured anew; nothing is copied into buffers of another
    layout. A failed capture or replay raises.

    Over a mesh (NCCL) the step's collectives (the counts, BatchNorm's
    statistics, the gradient buffer, the metrics) are captured with it;
    the eager warm-up step makes the first collective, so NCCL's
    communicator is set up outside the capture. gloo cannot be captured.
    """

    def __init__(self, config: ExperimentConfig, tx: optim.Transform, device: torch.device,
                 mesh=None):
        self.config, self.tx, self.device = config, tx, device
        self.reduce = None if mesh is None else _GradSum(config, mesh)
        self.stream = torch.cuda.Stream(device)
        self.binding = None
        self.graphs: Dict = {}
        self.pool = None
        self.batch: Dict[str, torch.Tensor] = {}

    def _bind(self, state: TrainState, stacked: Dict[str, torch.Tensor]) -> None:
        backends = torch.backends
        binding = (
            tuple(t.data_ptr() for t in _state_tensors(state)),
            tuple((k, tuple(v.shape[1:]), v.dtype) for k, v in stacked.items()),
            (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32,
             backends.cudnn.benchmark, backends.cudnn.deterministic,
             torch.get_float32_matmul_precision()),
        )
        if binding == self.binding:
            return
        self.graphs.clear()
        self.pool = None
        self.batch = {k: torch.empty(v.shape[1:], dtype=v.dtype, device=self.device)
                      for k, v in stacked.items()}
        self.binding = binding

    def _warm_up_and_capture(self, state: TrainState, hyper, row: torch.Tensor):
        scalars = row[:len(optim.hyper_leaves(hyper))].clone()
        filled = optim.hyper_fill(hyper, scalars)
        params = list(param_tree(state.models).values())
        current = torch.cuda.current_stream(self.device)
        for p in params:
            p.grad = None
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            metrics = _train_body(self.config, self.tx, state, self.batch, filled, self.reduce)
        current.wait_stream(self.stream)
        # The capture's backward makes fresh gradients, which each replay
        # then overwrites (it would add to gradients that were there).
        grads = [p.grad for p in params]
        for p in params:
            p.grad = None
        graph = torch.cuda.CUDAGraph()
        warp_kernels.CAPTURED.clear()
        # On the warm-up's stream; thread_local: the prefetch thread may
        # upload while this captures.
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            static = _train_body(self.config, self.tx, state, self.batch, filled, self.reduce)
        if self.pool is None:
            self.pool = graph.pool()
        # .grad: the warm-up step's values, not the capture's unwritten ones.
        for p, g in zip(params, grads):
            if g is not None:
                p.grad.copy_(g)
        self.graphs[optim.hyper_key(hyper)] = _Captured(
            graph, scalars, static, collections.Counter(warp_kernels.CAPTURED))
        return metrics

    def __call__(self, state: TrainState, stacked: Dict[str, torch.Tensor]):
        plans, opt_states = [], []
        opt_state = state.opt_state
        for _ in range(_steps_in(stacked)):
            hyper, opt_state = self.tx.plan(opt_state)
            plans.append(hyper)
            opt_states.append(opt_state)
        table = _hyper_table(plans, self.device)
        self._bind(state, stacked)
        for k, hyper in enumerate(plans):
            for name, t in self.batch.items():
                t.copy_(stacked[name][k])
            captured = self.graphs.get(optim.hyper_key(hyper))
            if captured is None:
                metrics = self._warm_up_and_capture(state, hyper, table[k])
            else:
                captured.scalars.copy_(table[k, :captured.scalars.numel()])
                captured.graph.replay()
                warp_kernels.LAUNCHES.update(captured.launches)
                metrics = captured.metrics
            state.opt_state = opt_states[k]
            state.step += 1
        # The replays' outputs are overwritten by the next call.
        return state, {k: v.clone() for k, v in metrics.items()}


def _steps_in(stacked: Dict) -> int:
    """K, the leading dimension every entry of a stacked batch shares."""
    ks = {int(v.shape[0]) for v in stacked.values()}
    if len(ks) != 1 or min(ks) < 1:
        raise ValueError(f"a stacked batch needs one leading dimension K >= 1, got {sorted(ks)}")
    return ks.pop()


def make_scan_train_step(config: ExperimentConfig, mesh=None, unroll: int = 1,
                         device: str | torch.device | None = None
                         ) -> Callable[[TrainState, Dict[str, np.ndarray]], tuple]:
    """Several train steps per call (the reference's ``lax.scan`` of
    ``make_train_step``'s body); the reference's parameters, then
    ``device``.

    Returns ``fn(state, stacked_batch) -> (state, metrics of the last
    step)``. K, the number of steps, is the stacked batch's leading
    dimension (:func:`stack_batches`; numpy arrays, or tensors on the
    device such as ``data.pipeline.prefetch_to_device`` hands out). The K
    steps are :func:`make_train_step`'s, in order, on the K batches.

    On a GPU (the default, ``cuda``) the whole step (forward, backward,
    gradient norm and clip, solver update, BatchNorm statistics) is
    captured once as a CUDA graph and replayed per step, so the host
    launches one graph instead of the step's ~3000 kernels. The first call
    runs its first step eagerly, the real first step of the run, and
    captures after it; with ``iter_size > 1`` each of the solver's two
    branches does so once (``_GraphedSteps``). On the CPU (``device="cpu"``)
    the same step body runs K times eagerly.

    ``mesh``: :func:`make_train_step`'s, each rank's stacked batch holding
    its rows of each step (cut on axis 1). On a GPU the collectives are
    captured in the graph, which needs NCCL: a gloo mesh with CUDA
    tensors raises (gloo's collectives run on the host and cannot be
    captured).
    ``unroll != 1`` raises: it unrolls the reference's compiled scan loop,
    and a CUDA graph replays every step as captured, with no loop to unroll.
    """
    mesh = pmesh.training_mesh(mesh, "make_scan_train_step")
    if unroll != 1:
        raise NotImplementedError(
            f"unroll={unroll}: the port replays a CUDA graph of one step per step, "
            "so there is no scan loop to unroll; use unroll=1")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if mesh is not None and torch.distributed.get_backend(mesh.group) != "nccl":
            raise ValueError(
                "make_scan_train_step on a GPU captures the step, collectives "
                "included, as a CUDA graph; this mesh's group uses "
                f"{torch.distributed.get_backend(mesh.group)!r}, whose collectives run on "
                "the host and cannot be captured. Use NCCL, or steps_per_call=1.")
        graphs = _GraphedSteps(config, make_optimizer(config), dev, mesh)

        def multi_step(state: TrainState, stacked: Dict[str, np.ndarray]):
            _steps_in(stacked)
            return graphs(state, batch_to_device(stacked, dev))

        return multi_step

    step_fn = make_train_step(config, mesh, device=dev)

    def multi_step(state: TrainState, stacked: Dict[str, np.ndarray]):
        for k in range(_steps_in(stacked)):
            state, metrics = step_fn(state, {name: v[k] for name, v in stacked.items()})
        return state, metrics

    return multi_step


class SolverSignals:
    """Caffe ``SignalHandler`` analog (``caffe train --sigint_effect`` /
    ``--sighup_effect``; the port's copy of the reference's class).

    Maps SIGINT/SIGHUP to a solver action checked once per step:
    ``"stop"`` finishes the current step and returns from :func:`fit`
    cleanly; ``"snapshot"`` asks for a checkpoint and keeps training;
    ``"none"`` leaves the OS default (SIGINT raises KeyboardInterrupt,
    SIGHUP kills). Stop outranks a pending snapshot. Use as a context
    manager: previous handlers are restored on exit. Installation is
    skipped off the main thread, where CPython forbids ``signal.signal``.
    """

    _EFFECTS = ("stop", "snapshot", "none")

    def __init__(self, sigint: str = "none", sighup: str = "none"):
        for name, eff in (("sigint", sigint), ("sighup", sighup)):
            if eff not in self._EFFECTS:
                raise ValueError(f"{name}_effect {eff!r} not in {self._EFFECTS}")
        self._effects = {}
        if sigint != "none":
            self._effects[signal.SIGINT] = sigint
        if sighup != "none" and hasattr(signal, "SIGHUP"):
            self._effects[signal.SIGHUP] = sighup
        self._prev = {}
        self._pending: str | None = None

    def _handle(self, signum, frame):
        if self._pending != "stop":  # stop outranks snapshot
            self._pending = self._effects[signum]

    def __enter__(self):
        for signum in self._effects:
            try:
                self._prev[signum] = signal.signal(signum, self._handle)
            except ValueError:  # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        for signum, prev in self._prev.items():
            signal.signal(signum, prev)
        self._prev.clear()
        return False

    def pending(self) -> str | None:
        """Return and clear the requested action ('stop'/'snapshot'/None)."""
        action, self._pending = self._pending, None
        return action


def fit(
    config: ExperimentConfig,
    data_iter: Iterator[Dict[str, np.ndarray]],
    num_steps: int,
    mesh=None,
    checkpoint_dir: str | None = None,
    log_fn: Callable[[int, Dict[str, float]], None] | None = None,
    state: TrainState | None = None,
    steps_per_call: int = 1,
    prefetch: int = 2,
    eval_iter: Iterator[Dict[str, np.ndarray]] | None = None,
    eval_every: int = 0,
    eval_steps: int = 10,
    sigint_effect: str = "none",
    sighup_effect: str = "none",
    device: str | torch.device | None = None,
    debug_nans: bool = False,
) -> TrainState:
    """Host training loop, the rebuild of ``Solver::Solve``; the
    reference's parameters in its order, then ``device``.

    Runs :func:`make_train_step` on batches from ``data_iter`` until
    ``state.step == num_steps``. A fresh state (``state`` None) comes from
    ``config.seed``, then takes the previous stage's weights from
    ``config.init_from`` and the feature net from ``config.init_feat_from``
    (the staged recipe, ``io.checkpoint.restore_weights`` /
    ``restore_param_subtree``). With ``checkpoint_dir`` the loop resumes
    from the newest checkpoint there, the port's or the JAX package's (a
    no-op on an empty directory), writes ``config.json`` beside it and
    snapshots every
    ``config.checkpoint_every`` steps, after the last step and on the
    signal actions; a step already saved is not saved again.

    ``prefetch`` > 0 uploads the next batches on a producer thread
    (``data.pipeline.prefetch_to_device``, pinned buffers and a side
    stream on a GPU) while the current step runs; 0 uploads in the step.
    ``log_fn(step, metrics)`` gets the separate loss terms and
    ``steps_per_sec`` (from the second step on, so the first step's
    start-up stays out) every ``config.log_every`` steps and after the
    last. ``eval_iter`` + ``eval_every`` run the Caffe solver test phase:
    every ``eval_every`` steps and after the last, the eval-mode loss
    terms averaged over ``eval_steps`` batches, logged under ``val/``.
    ``sigint_effect`` / ``sighup_effect`` are :class:`SolverSignals`'
    actions.

    ``debug_nans`` checks, after each call of ``steps_per_call`` steps and
    before that state is logged, validated or snapshotted, that the call's
    metrics and every parameter and BatchNorm statistic are finite: one
    device reduction and one host read per call (the reference's
    ``jax_debug_nans`` stops at the first non-finite operation; a CUDA
    graph cannot host anomaly mode, so the port checks per call, not per
    operation). On failure it raises ``FloatingPointError`` naming the
    call's last step and the first non-finite metric or state tensor; no
    checkpoint of that state is written. Under a mesh the metrics are the
    global batch's and the state is replicated, so every rank raises at
    the same step.

    ``steps_per_call`` = K > 1 runs :func:`make_scan_train_step` (on a
    GPU, a CUDA graph of the step replayed per step) on stacks of K
    batches (``data.pipeline.stacked_batches``, from the resumed step on;
    the last stack holds exactly the steps left), and the rules above
    become the reference's: the loss terms are logged after a call whose
    last step ``last`` has ``last % log_every < K``, validation runs when
    ``(last + 1) % eval_every < K`` and a snapshot is written when
    ``(last + 1) % checkpoint_every < K``, each also after the last step;
    signals are checked between calls. K = 1 is :func:`make_train_step`,
    one eager step per batch.

    ``mesh`` (a mesh of ranks, one process per device; ``cli train
    --num-devices N`` starts them): every rank runs ``fit`` with the same
    arguments and the same global ``data_iter`` / ``eval_iter``, keeps its
    rows of each batch (``parallel.distributed.local_slice``) and runs
    :func:`make_train_step` over the mesh. At the start rank 0's state
    (parameters, BatchNorm statistics, solver state) is broadcast, so the
    ranks hold one replica. The checkpoint files and ``config.json`` are
    written by the coordinator, and every rank waits for each save; a
    signal's action is agreed over the ranks, so all stop at one step.
    """
    mesh = pmesh.training_mesh(mesh, "fit")
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    dev = resolve_device(device)
    if state is None:
        state = create_state(config, dev)
        if config.init_from:
            state = ckpt_io.restore_weights(config.init_from, state)
        if config.init_feat_from:
            state = ckpt_io.restore_param_subtree(config.init_feat_from, state, "feat")
    K = steps_per_call
    step_fn = (make_train_step(config, mesh, device=dev) if K == 1
               else make_scan_train_step(config, mesh, device=dev))
    eval_fn = None
    if eval_iter is not None and eval_every > 0:
        eval_fn = make_eval_step(config, dev, mesh=mesh)
    coordinator = mesh is None or mesh.rank == 0

    mgr = None
    if checkpoint_dir is not None:
        mgr = ckpt_io.make_manager(checkpoint_dir)
        state = ckpt_io.maybe_restore(mgr, state, config)
        # The architecture travels with the weights: `cli test`,
        # DepthVO.from_checkpoint and the reference read it back.
        if coordinator:
            config_base.save_json(config, os.path.join(checkpoint_dir, "config.json"))
    if mesh is not None:
        pmesh.replicate(state, mesh)
        data_iter = pdist.local_batches(data_iter, divisor=mesh.size)

    def snapshot():
        if mgr.latest_step() != state.step:
            ckpt_io.save(mgr, state, mesh)

    source = data_iter if K == 1 else stacked_batches(data_iter, K, state.step, num_steps)
    batches = source
    if prefetch > 0:
        batches = prefetch_to_device(source, dev, buffer_size=prefetch)

    check_finite = _finite_check(state) if debug_nans else None
    steady_t0 = None
    steady_base = state.step
    signals = SolverSignals(sigint=sigint_effect, sighup=sighup_effect)
    agree = _agreed_action(mesh) if mesh is not None and signals._effects else None
    try:
        with signals:
            while state.step < num_steps:
                action = signals.pending()
                if agree is not None:
                    action = agree(action)
                if action is not None:
                    # Both actions ask for a snapshot.
                    if mgr is None:
                        print(f"signal {action}: no checkpoint_dir, nothing "
                              "snapshotted (the training state is not saved)", flush=True)
                    else:
                        snapshot()
                    if log_fn is not None:
                        log_fn(state.step - 1, {f"signal/{action}": 1.0})
                    if action == "stop":
                        break
                state, metrics = step_fn(state, next(batches))
                i = state.step
                if check_finite is not None:
                    check_finite(metrics, i - 1)
                if steady_t0 is None:
                    float(metrics["loss/total"])  # waits for the first step
                    steady_t0 = time.perf_counter()
                    steady_base = i
                last = i - 1
                if log_fn is not None and (last % config.log_every < K or i >= num_steps):
                    logged = {k: float(v) for k, v in metrics.items()}
                    logged["steps_per_sec"] = (i - steady_base) / max(
                        time.perf_counter() - steady_t0, 1e-9
                    )
                    log_fn(last, logged)
                if eval_fn is not None and ((last + 1) % eval_every < K or i >= num_steps):
                    val = run_validation(eval_fn, state.models, eval_iter, eval_steps, mesh)
                    if log_fn is not None:
                        log_fn(last, val)
                if mgr is not None and ((last + 1) % config.checkpoint_every < K
                                        or i >= num_steps):
                    snapshot()
    finally:
        if batches is not source:
            batches.close()  # stops the producer thread
    return state


def _finite_check(state: TrainState) -> Callable[[Dict[str, torch.Tensor], int], None]:
    """``check(metrics, last)`` for ``fit(debug_nans=True)``: raises
    ``FloatingPointError`` unless the metrics and every parameter and
    floating buffer (the BatchNorm statistics) of ``state``'s networks are
    finite, naming step ``last`` and the first tensor that is not. One flag
    per tensor on the device, stacked, then one host read."""
    named = list(param_tree(state.models).items())
    named += [(f"{net_name}.{k}", b) for net_name, net in zip(Models._fields, state.models)
              if net is not None for k, b in net.named_buffers() if b.is_floating_point()]

    def check(metrics: Dict[str, torch.Tensor], last: int) -> None:
        leaves = list(metrics.items()) + named
        flags = torch.stack([torch.isfinite(t.detach()).all() for _, t in leaves]).cpu()
        if not bool(flags.all()):
            bad = next(name for (name, _), ok in zip(leaves, flags.tolist()) if not ok)
            kind = "metric" if bad in metrics else "state tensor"
            raise FloatingPointError(
                f"--debug-nans: non-finite {kind} {bad!r} after step {last} (checked the "
                "call's metrics and every parameter and BatchNorm statistic; this state "
                "is not checkpointed)")

    return check


_ACTIONS = (None, "snapshot", "stop")  # stop outranks snapshot


def _agreed_action(mesh) -> Callable[[str | None], str | None]:
    """The signal action every rank takes: the strongest one any rank
    got, agreed over a host-side (gloo) group, so the ranks snapshot and
    stop at the same step and no collective waits for a rank that left."""
    group = (mesh.group if torch.distributed.get_backend(mesh.group) == "gloo"
             else torch.distributed.new_group(mesh.ranks, backend="gloo"))

    def agree(action: str | None) -> str | None:
        code = torch.tensor([_ACTIONS.index(action)], dtype=torch.int32)
        torch.distributed.all_reduce(code, op=torch.distributed.ReduceOp.MAX, group=group)
        return _ACTIONS[int(code)]

    return agree
