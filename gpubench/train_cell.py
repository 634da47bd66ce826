"""The training cells: ``depthvo_tpu_torch.train.loop.fit`` as ``cli train``
runs it, timed over a window, then its first steps held against the
reference.

Set-up builds one train state from the seed's weights and drives it
through ``fit`` to each step of ``checked_steps`` (one ``fit`` call each,
on the window's data source, ``steps_per_call`` and ``prefetch``; the
last checked call is two steps, one run eagerly and one replayed from the
captured graph), reading each call's logged losses, the first gradient
from Adam's first moment and, after the last, the parameters and
BatchNorm statistics. The same state then goes into the window's ``fit``,
whose first logged call ends the warm-up: the window opens there, a
timer asks ``fit`` to stop (its SIGHUP ``stop`` action, which ends the
call in flight), and it closes at a ``synchronize`` after ``fit``
returns. Rows trained in the window over the window's seconds is the
throughput. Then the state is freed and the reference follows the checked
steps on the same rows in float32 (TF32 off).

Data sources (the traffic file's ``source``):

* ``pool``: ``pool_batches`` batches of ``batch_size`` distinct synthetic
  scenes rendered from the seed, cycled from host memory;
* ``kitti_ring``: one KITTI raw drive of ``frames`` PNG frames per
  camera at 375x1242 (rendered from ``scene_seed`` once per checkout and
  kept in ``gpubench/.cache``), read through the system's
  ``KittiRawStereo(...).iterator(native_ring=True)`` in the order the seed
  shuffles; the reference decodes and resizes the PNG files itself and
  matches each row the ring produced to its frames.
"""

from __future__ import annotations

import math
import os
import signal
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from gpubench import compare, flops, scenes, weights
from gpubench.reference import nets, png
from gpubench.reference.train import Trainer

HERE = os.path.dirname(os.path.abspath(__file__))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Pool:
    """``pool_batches`` batches of distinct scenes, cycled."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        m, b = config["model"], config["batch_size"]
        n = traffic["pool_batches"] * b
        scene_set = scenes.SyntheticScenes(m["height"], m["width"], config["stereo_baseline"],
                                           seed, n)
        self.batches = [scene_set.batch(range(i * b, (i + 1) * b))
                        for i in range(traffic["pool_batches"])]
        self.count = 0
        self.spans: List[tuple] = []

    def __iter__(self):
        return self

    def __next__(self):
        batch = self.batches[self.count % len(self.batches)]
        self.count += 1
        return batch

    def reference_batch(self, j: int) -> Dict[str, np.ndarray]:
        return self.batches[j % len(self.batches)]


def kitti_drive(config: dict, traffic: dict) -> str:
    """The traffic's KITTI raw tree, written once per checkout."""
    root = os.path.join(HERE, ".cache", f"kitti-{traffic['scene_seed']}-{traffic['frames']}")
    done = os.path.join(root, "complete")
    if not os.path.exists(done):
        scenes.write_kitti_raw(root, traffic["frames"], traffic["scene_seed"],
                               config["stereo_baseline"])
        open(done, "w").close()
    return root


def kitti_frames(root: str, h: int, w: int) -> Dict[str, np.ndarray]:
    """Every frame of the drive, by camera, decoded and resized by the
    reference."""
    drive = os.path.join(root, scenes.KITTI_DATE, scenes.KITTI_DRIVE)
    out = {}
    for cam in ("image_02", "image_03"):
        d = os.path.join(drive, cam, "data")
        out[cam] = np.stack([png.resize_u8(png.decode(os.path.join(d, f)), h, w)
                             for f in sorted(os.listdir(d))])
    return out


def kitti_camera(h: int, w: int):
    """The drive's intrinsics at (h, w) and its stereo baseline."""
    fx, cx, cy = scenes.KITTI_CALIB
    H, W = scenes.KITTI_HW
    sx, sy = w / W, h / H
    K = np.array([[fx * sx, 0, cx * sx + (sx - 1) / 2], [0, fx * sy, cy * sy + (sy - 1) / 2],
                  [0, 0, 1]], np.float64).astype(np.float32)
    tx = dict(scenes.KITTI_TX)
    return K, np.float32((tx["02"] - tx["03"]) / fx)


class KittiRing:
    """The system's native ring over a KITTI raw drive, each ``next()``
    timed (a span of the data pipeline) and the first batches kept."""

    def __init__(self, config: dict, traffic: dict, seed: int, keep: int):
        from depthvo_tpu_torch.data import kitti

        root = kitti_drive(config, traffic)
        m = config["model"]
        self.root, self.h, self.w = root, m["height"], m["width"]
        ds = kitti.KittiRawStereo(root, [scenes.KITTI_DRIVE], m["height"], m["width"], u8=True)
        self.it = ds.iterator(config["batch_size"], seed=seed, native_ring=True)
        self.keep, self.kept = keep, []
        self.spans: List[tuple] = []
        self.lock = threading.Lock()  # fit's producer thread against close()
        self.closed = False

    def __iter__(self):
        return self

    def __next__(self):
        with self.lock:
            if self.closed:
                raise StopIteration
            t0 = time.perf_counter()
            batch = next(self.it)
            self.spans.append((t0, time.perf_counter()))
        if len(self.kept) < self.keep:
            self.kept.append({k: np.array(v) for k, v in batch.items()})
        return batch

    def close(self) -> None:
        """Stop the ring once ``fit``'s producer thread has left it."""
        self.closed = True
        with self.lock:
            self.it.close()

    def match(self) -> float:
        """Decode and resize every frame, match each kept row to the
        target frame it is closest to, and return the largest code gap
        between the ring's (target, right, next) images and the frames'
        (inf where K or the baseline differ). Sets the reference's
        batches."""
        frames = kitti_frames(self.root, self.h, self.w)
        left, right = frames["image_02"].astype(np.int16), frames["image_03"].astype(np.int16)
        K, baseline = kitti_camera(self.h, self.w)
        worst, self.reference = 0.0, []
        for batch in self.kept:
            rows = []
            for t in batch["image_t"].astype(np.int16):
                i = int(np.argmin(np.abs(left[:-1] - t).max(axis=(1, 2, 3))))
                rows.append(i)
            ref = {"image_t": left[rows], "image_r": right[rows],
                   "image_s": left[[i + 1 for i in rows]]}
            for k, v in ref.items():
                worst = max(worst, float(np.abs(batch[k].astype(np.int16) - v).max()))
            if not (np.allclose(batch["K"], K[None], rtol=1e-6, atol=1e-4)
                    and np.allclose(batch["baseline"], baseline, rtol=1e-6)):
                worst = float("inf")
            ref = {k: v.astype(np.uint8) for k, v in ref.items()}
            ref["K"] = np.stack([K] * len(rows))
            ref["baseline"] = np.full(len(rows), baseline, np.float32)
            self.reference.append(ref)
        return worst

    def reference_batch(self, j: int) -> Dict[str, np.ndarray]:
        return self.reference[j]


def _adam_first_moment(opt_state, shapes: List[tuple]):
    """Adam's first moments in the solver state: the (count, mu, nu)
    entry whose moments have the trainable parameters' shapes."""
    if isinstance(opt_state, tuple):
        if (len(opt_state) == 3 and isinstance(opt_state[0], int)
                and isinstance(opt_state[1], (list, tuple))
                and [tuple(t.shape) for t in opt_state[1] if torch.is_tensor(t)] == shapes):
            return opt_state[1]
        for part in opt_state:
            found = _adam_first_moment(part, shapes)
            if found is not None:
                return found
    return None


def run(cell, seed: int, seconds: float, trace: bool, dev: torch.device,
        t_start: float) -> dict:
    from depthvo_tpu_torch.configs import base as config_base
    from depthvo_tpu_torch.train import loop
    from depthvo_tpu_torch.train.state import (
        TrainState, build_models, load_params, make_optimizer, param_tree)

    from gpubench import spec

    config = spec.experiment(cell.config)
    traffic = cell.traffic
    cfg = config_base.from_dict(config)
    checked = traffic["checked_steps"]
    K = traffic["steps_per_call"]
    if traffic["source"] == "pool":
        source = Pool(config, traffic, seed)
    elif traffic["source"] == "kitti_ring":
        source = KittiRing(config, traffic, seed, keep=checked[-1])
    else:
        raise ValueError(f"unknown training source {traffic['source']!r}")

    params = weights.make(config, seed, dev)
    models = load_params(build_models(cfg), weights.state_dicts(params), dev).train()
    state = TrainState(0, models, make_optimizer(cfg).init(param_tree(models)))
    names = nets.trainable(config)
    fit_kw = dict(steps_per_call=K, prefetch=traffic["prefetch"], device=dev)

    losses, first_grads = {}, None
    for end in checked:
        logged: Dict[str, float] = {}
        loop.fit(cfg, source, end, state=state, log_fn=lambda s, m: logged.update(m), **fit_kw)
        losses[end] = {k: v for k, v in logged.items() if k.startswith("loss/")}
        if first_grads is None:
            pt = param_tree(state.models)
            mu = _adam_first_moment(state.opt_state, [tuple(pt[k].shape) for k in names])
            first_grads = {k: (m / (1.0 - config["optim"]["beta1"])).detach().cpu()
                           for k, m in zip(names, mu)}
    pt = param_tree(state.models)
    change = {k: (pt[k].detach() - params[k]).cpu() for k in names}
    buffers = dict(state.models.depth.named_buffers())
    bn_change = {k: (buffers[k.split(".", 1)[1]] - params[k]).cpu()
                 for k, _, kind in nets.specs(config) if kind in ("bn_mean", "bn_var")}

    # The window: from the first logged call of the window's fit.
    window: Dict[str, float] = {}
    prof = None

    def on_log(step: int, metrics: Dict[str, float]) -> None:
        nonlocal prof
        if "t0" in window or "signal/stop" in metrics:
            return
        _sync(dev)
        window["step0"] = step + 1
        window["setup_s"] = time.perf_counter() - t_start
        if trace:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            window["mark"] = torch.profiler.record_function("gpubench.window")
            window["mark"].__enter__()
        window["t0"] = time.perf_counter()
        length = min(seconds, traffic["trace_seconds"]) if trace else seconds
        timer = threading.Timer(length, os.kill, (os.getpid(), signal.SIGHUP))
        timer.daemon = True
        window["timer"] = timer
        timer.start()

    loop.fit(cfg, source, 10 ** 12, state=state, log_fn=on_log, sighup_effect="stop", **fit_kw)
    _sync(dev)
    t1 = time.perf_counter()
    window["timer"].cancel()
    traced = None
    if trace:
        window["mark"].__exit__(None, None, None)
        prof.stop()
    steps = state.step - window["step0"]
    window_s = t1 - window["t0"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if hasattr(source, "close"):
        source.close()
    if trace:
        from gpubench import trace as tr

        mark = [e for e in prof.events() if e.name == "gpubench.window"][0]
        traced = tr.reduce(prof, (mark.time_range.start, mark.time_range.end))
        prof = None
    finite = all(bool(torch.isfinite(p).all()) for p in param_tree(state.models).values())
    del state, models, pt, buffers
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    detail: Dict[str, object] = {}
    numbers = reference_numbers(config, params, source, checked, losses, first_grads, change,
                                bn_change, dev, detail)
    rows = config["batch_size"] * steps
    return {
        "attempted": steps, "failed": 0 if finite else steps,
        "numbers": numbers, "detail": detail, "window_s": window_s, "setup_s": window["setup_s"],
        "memory_peak_bytes": peak, "traced": traced,
        "run": {"window_s": traced["window_s"] if traced else window_s, "steps": steps,
                "rows": rows, "config": config, "trace": traced,
                "flops_per_step": flops.train_step(config) if trace else 0,
                "spans": [(a, b) for a, b in source.spans if window["t0"] <= a and b <= t1]},
        "rate": rows / window_s,
    }


def reference_numbers(config, params, source, checked, losses, first_grads, change, bn_change,
                      dev, detail: dict | None = None) -> Dict[str, float]:
    """The reference follows the checked steps on the same rows; the
    numbers of :mod:`compare`. ``detail``, where given, gets the readings
    that chose them (:func:`compare.spread`)."""
    numbers = {}
    if hasattr(source, "match"):
        numbers["frames"] = source.match()
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = Trainer(config, params)
        ref_losses = {}
        for j in range(checked[-1]):
            batch = {k: torch.as_tensor(np.ascontiguousarray(v)).to(dev)
                     for k, v in source.reference_batch(j).items()}
            ref_losses[j + 1] = ref.step(batch)
        ref_first = {k: g.cpu() for k, g in ref.first_grads.items()}
        ref_change = {k: (ref.p[k] - params[k]).cpu() for k in ref.names}
        ref_bn = {k: (v - params[k]).cpu() for k, v in ref.stats.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    numbers["loss"] = max(compare.rel(losses[s].get(k, math.inf), v)
                          for s in checked for k, v in ref_losses[s].items())
    numbers["grad"] = compare.median_leaf(first_grads, ref_first)
    numbers["change"] = compare.worst_leaf(change, ref_change, compare.moved(ref_first))
    numbers["bn"] = compare.median_leaf(bn_change, ref_bn)
    if detail is not None:
        detail["loss_total"] = max(compare.rel(losses[s].get("loss/total", math.inf),
                                               ref_losses[s]["loss/total"]) for s in checked)
        detail["grad"] = compare.spread(first_grads, ref_first)
        detail["change"] = compare.spread(change, ref_change, compare.moved(ref_first))
        detail["bn"] = compare.spread(bn_change, ref_bn)
    return numbers
