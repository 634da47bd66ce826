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
K2 and not K3. The train step is eager: one forward, one backward and one
solver update per call.
"""

from __future__ import annotations

import contextlib
import os
import signal
import time
from typing import Callable, Dict, Iterator

import numpy as np
import torch

from depthvo_tpu_torch import ops
from depthvo_tpu_torch.configs import base as config_base
from depthvo_tpu_torch.configs.base import ExperimentConfig
from depthvo_tpu_torch.data.pipeline import prefetch_to_device
from depthvo_tpu_torch.geometry import se3, warp as geo_warp
from depthvo_tpu_torch.geometry.camera import scale_intrinsics
from depthvo_tpu_torch.io import checkpoint as ckpt_io
from depthvo_tpu_torch.losses.photometric import masked_l1_chw, photometric_loss_chw
from depthvo_tpu_torch.losses.smoothness import smoothness_loss
from depthvo_tpu_torch.models.layers import resize_bilinear_chw
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
                   batch: Dict[str, torch.Tensor], train: bool = False):
    """Evaluate the staged loss graph.

    Args:
      models: the stage's networks (``train.state.Models``), on the
        batch's device. ``train`` puts them in train mode (BatchNorm batch
        statistics, running averages updated in place) or eval mode.
      batch: tensors on one device: 'image_t', 'image_r' (if use_stereo),
        'image_s' (if use_temporal) as (B,H,W,3) float in [-1,1] or raw
        uint8; 'K' (B,3,3) at full resolution; optional 'baseline' (B,).

    Returns: (total_loss, metrics dict of scalar tensors). Both carry the
    autograd graph where grad mode is on.
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
        payload = torch.cat([image_s_chw, feat_s_chw], dim=1)

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

    # The loss terms in the reference's order: coarsest to finest, then
    # the fused finest warp's temporal term.
    stereo_total = torch.zeros((), device=image_t.device)
    temporal_total = torch.zeros((), device=image_t.device)
    smooth_total = torch.zeros((), device=image_t.device)
    for i, (disp, img_t) in enumerate(zip(disps, img_ts)):
        if config.use_stereo:
            warped, valid = stereo[i]()
            stereo_total = stereo_total + photometric_loss_chw(
                warped, img_t, valid, config.ssim_weight
            )
        if i in temporal:
            warped, valid = temporal[i]()
            temporal_total = temporal_total + photometric_loss_chw(
                warped, img_t, valid, config.ssim_weight
            )
        smooth_total = smooth_total + smoothness_loss(
            disp, img_t, edge_aware=config.edge_aware_smoothness,
            image_layout="chw",
        ) / (2.0 ** (n_scales - 1 - i))

    feat_loss = None
    if fused:
        if config.train_feat:
            # feat_s carries gradients: the differentiable plain warp
            # (the reference's XLA gather/scatter path, no window term).
            warped_hwc, valid = geo_warp.inverse_warp(
                payload.permute(0, 2, 3, 1), depth_full, T_ts, K
            )
            warped = warped_hwc.permute(0, 3, 1, 2)
        else:
            warped, valid = general[-1]()
        temporal_total = temporal_total + photometric_loss_chw(
            warped[:, :3], image_t_chw, valid, config.ssim_weight
        )
        feat_loss = config.feature_weight * masked_l1_chw(
            warped[:, 3:], feat_t_chw, valid
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
    return total, metrics


def batch_to_device(batch: Dict[str, np.ndarray | torch.Tensor],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """Host batch (numpy) -> tensors on ``device``; uint8 stays uint8.
    Tensors already on ``device`` (a prefetched batch,
    ``data.pipeline.prefetch_to_device``) pass straight through."""
    return {
        k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))).to(
            device, non_blocking=True)
        for k, v in batch.items()
    }


def make_eval_step(config: ExperimentConfig, device: str | torch.device | None = None
                   ) -> Callable[[Models, Dict[str, np.ndarray]], Dict[str, torch.Tensor]]:
    """Eval-mode loss evaluation (no update, BN running statistics).

    Returns ``eval_fn(models, host_batch) -> metrics`` running on
    ``device`` (default ``cuda``; raises when there is no GPU unless
    ``device="cpu"``).
    """
    dev = resolve_device(device)

    def eval_fn(models: Models, batch: Dict[str, np.ndarray]):
        with torch.inference_mode():
            _, metrics = compute_losses(
                config, models, batch_to_device(batch, dev), train=False
            )
        return metrics

    return eval_fn


def run_validation(eval_fn, models: Models, eval_iter: Iterator[Dict[str, np.ndarray]],
                   eval_steps: int) -> Dict[str, float]:
    """Average the loss terms over ``eval_steps`` held-out batches (the
    Caffe solver test phase). Returns metrics under a ``val/`` prefix."""
    totals: Dict[str, float] = {}
    for _ in range(eval_steps):
        metrics = eval_fn(models, next(eval_iter))
        for k, v in metrics.items():
            totals[k] = totals.get(k, 0.0) + float(v)
    return {f"val/{k}": v / max(eval_steps, 1) for k, v in totals.items()}


def make_train_step(config: ExperimentConfig, device: str | torch.device | None = None
                    ) -> Callable[[TrainState, Dict[str, np.ndarray]], tuple]:
    """The train step: ``step_fn(state, host_batch) -> (state, metrics)``.

    One eager forward in train mode, one backward, then the solver update
    of :func:`train.state.make_optimizer` applied in place; ``state`` is
    updated in place and returned. ``metrics`` are the loss terms of
    :func:`compute_losses` (detached, on the device) plus
    ``grad/global_norm``, the norm of every parameter's gradient (frozen
    ones count as zero) before clipping. Runs on ``device`` (default
    ``cuda``; raises when there is no GPU unless ``device="cpu"``).
    """
    dev = resolve_device(device)
    tx = make_optimizer(config)

    def step_fn(state: TrainState, batch: Dict[str, np.ndarray]):
        params = param_tree(state.models)
        for p in params.values():
            p.grad = None
        total, metrics = compute_losses(
            config, state.models, batch_to_device(batch, dev), train=True
        )
        total.backward()
        with torch.no_grad():
            grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                     for k, p in params.items()}
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["grad/global_norm"] = optim.global_norm(grads)
            updates, state.opt_state = tx.update(grads, state.opt_state, params)
            optim.apply_updates(params, updates)
        state.step += 1
        return state, metrics

    return step_fn


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
) -> TrainState:
    """Host training loop, the rebuild of ``Solver::Solve``; the
    reference's parameters in its order, then ``device``.

    Runs :func:`make_train_step` on batches from ``data_iter`` until
    ``state.step == num_steps``. A fresh state (``state`` None) comes from
    ``config.seed``, then takes the previous stage's weights from
    ``config.init_from`` and the feature net from ``config.init_feat_from``
    (the staged recipe, ``io.checkpoint.restore_weights`` /
    ``restore_param_subtree``). With ``checkpoint_dir`` the loop resumes
    from the newest checkpoint there (a no-op on an empty directory),
    writes ``config.json`` beside it and snapshots every
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

    Not ported yet: a ``mesh`` (data parallel over several cards, ROADMAP
    A.8) and several steps per call (``steps_per_call > 1``, A.3); they
    raise ``NotImplementedError``.
    """
    if mesh is not None:
        raise NotImplementedError("fit over a device mesh is not ported yet")
    if steps_per_call != 1:
        raise NotImplementedError("steps_per_call > 1 is not ported yet")
    dev = resolve_device(device)
    if state is None:
        state = create_state(config, dev)
        if config.init_from:
            state = ckpt_io.restore_weights(config.init_from, state)
        if config.init_feat_from:
            state = ckpt_io.restore_param_subtree(config.init_feat_from, state, "feat")
    step_fn = make_train_step(config, dev)
    eval_fn = None
    if eval_iter is not None and eval_every > 0:
        eval_fn = make_eval_step(config, dev)

    mgr = None
    if checkpoint_dir is not None:
        mgr = ckpt_io.make_manager(checkpoint_dir)
        state = ckpt_io.maybe_restore(mgr, state)
        # The architecture travels with the weights: `cli test`,
        # DepthVO.from_checkpoint and the reference read it back.
        config_base.save_json(config, os.path.join(checkpoint_dir, "config.json"))

    def snapshot():
        if mgr.latest_step() != state.step:
            ckpt_io.save(mgr, state)

    batches = data_iter
    if prefetch > 0:
        batches = prefetch_to_device(data_iter, dev, buffer_size=prefetch)

    steady_t0 = None
    steady_base = state.step
    signals = SolverSignals(sigint=sigint_effect, sighup=sighup_effect)
    try:
        with signals:
            while state.step < num_steps:
                action = signals.pending()
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
                if steady_t0 is None:
                    float(metrics["loss/total"])  # waits for the first step
                    steady_t0 = time.perf_counter()
                    steady_base = i
                last = i - 1
                if log_fn is not None and (last % config.log_every == 0 or i >= num_steps):
                    logged = {k: float(v) for k, v in metrics.items()}
                    logged["steps_per_sec"] = (i - steady_base) / max(
                        time.perf_counter() - steady_t0, 1e-9
                    )
                    log_fn(last, logged)
                if eval_fn is not None and (i % eval_every == 0 or i >= num_steps):
                    val = run_validation(eval_fn, state.models, eval_iter, eval_steps)
                    if log_fn is not None:
                        log_fn(last, val)
                if mgr is not None and (i % config.checkpoint_every == 0 or i >= num_steps):
                    snapshot()
    finally:
        if batches is not data_iter:
            batches.close()  # stops the producer thread
    return state
