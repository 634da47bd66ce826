"""The ManyDepth training cells (traffic kind ``train_mf``): the system's
``fit`` on a ManyDepth configuration, timed over a window, then its first
steps held against the benchmark's plain ManyDepth
(``gpubench/reference/manydepth.py``).

The run is :mod:`gpubench.train_md2_cell`'s: one train state from the
seed's weights (``gpubench/mf_weights.py``) goes through ``fit`` to each
step of ``checked_steps`` (the first gradient from Adam's first moment,
the weights, statistics and trackers reached at the first, then the
parameters and the three networks' BatchNorm statistics), then into the
window's ``fit``, whose first logged call opens the window; a timer asks
``fit`` to stop and a ``synchronize`` after it closes the window. Rows
trained over the window's seconds is the throughput. Then the state is
freed and the reference follows the checked steps on the same rows in
float32 (TF32 off).

The data source is ``pool``: ``pool_batches`` batches of ``batch_size``
distinct synthetic scenes with frames t-1, t and t+1
(``gpubench/md2_scenes.py``, rendered on the card; the right view is
dropped), each batch with one draw a row in [0, 1) from the seed
(``aug_u``: below 0.25 the static-camera augmentation, below 0.5 the
zero cost volume), cycled from host memory.

The numbers of :mod:`compare`, as this configuration's arithmetic lets
them tell a sound run from a broken one (PERF.md, the readings):

* ``loss``: the largest relative gap of the terms in
  :data:`JUDGED_TERMS`, each scale's teacher reprojection term (the
  auto-masked mean of the minimum over both sources' warped errors, over
  every row), where both forwards run on the same weights, statistics
  and trackers: at the first checked step, and at the next, where the
  reference runs from the state the system reached (the trajectories part
  from step 2 on, as cell A's do);
* ``consistency``: the same for the multi-frame net's consistency terms
  (:data:`CONSISTENCY_TERMS`, the mean gap of its depth to the teacher's
  outside the matching mask), which read its forward through the cost
  volume, ``reduce_conv``, the encoder's last stages and the decoder;
* ``match``: the matching layer on the pool's first batch, on the timed
  state (after the window) and on the state of the first checked step:
  the system's cost volume, confidence and lowest cost from one eager
  forward of its loss graph, read at its modules, against the
  reference's ``match_features`` and ``lowest_cost_and_volume`` on
  features that the reference computes in float32 from the system's
  weights and statistics, with the system's trackers and matching pose
  and the reference's choice of each row's lookup frame and zero pose
  (:func:`matching_gaps`, :func:`row_gaps`); the largest of those gaps.
  Both states are read because the confidence (every bin observed)
  shrinks as the seed's forward-biased poses train: on the timed state
  of a 20 s window it is zero on every pixel, the volume times it too,
  and only the lowest cost, the confidence and the rows are compared;
* ``grad``: the first gradient, by the median leaf (:mod:`compare`);
* ``change``: the parameters' change over the checked steps by the leaf
  at the 90th percentile of the moved leaves' gaps;
* ``bn``: the three networks' running statistics, by the median buffer.

The multi-frame net's reprojection terms are means over the few pixels of
its matching mask at the start of training, which flip with the rounding
of the cost volume's argmin; the totals and the smoothness terms move
with bfloat16 as much as with a half batch (PERF.md): they are in
``detail``, beside each part of ``match``.

The teacher's tie-breaking noise (1e-5 N(0, 1) on its identity errors) is
drawn by the system from its device's generator inside the captured step,
which the reference cannot replay: it draws its own from the seed.

A program without the ManyDepth architecture (an ``ExperimentConfig``
with no ``architecture`` field, or one that does not list
``"manydepth"``) fails at once, before anything is rendered: exit 1, no
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import time
from typing import Dict

import numpy as np
import torch

from gpubench import compare, md2_scenes, mf_flops, mf_weights, weights
from gpubench.reference import manydepth as mf
from gpubench.reference import monodepth2 as md2
from gpubench.train_md2_cell import sign_flips
from gpubench.window import checked_fits, timed_window

NETS = ("depth", "odom", "teacher")
# The loss terms ``loss`` compares: each scale's teacher reprojection term
# (the others are in ``detail``).
JUDGED_TERMS = tuple(f"loss/teacher_reproj/{s}" for s in range(8))
# The multi-frame net's terms ``consistency`` compares, as ``loss`` does.
CONSISTENCY_TERMS = tuple(f"loss/consistency/{s}" for s in range(8))
AUG_SEED = 0x6D66  # the stream of the rows' draws: the seed xor this


def require_manydepth() -> None:
    """Exit 1 unless the system under test can build ManyDepth."""
    from depthvo_tpu_torch.configs import base as config_base

    fields = {f.name for f in dataclasses.fields(config_base.ExperimentConfig)}
    if "architecture" not in fields or "manydepth" not in getattr(config_base,
                                                                  "ARCHITECTURES", ()):
        print("gpubench: the system under test has no ManyDepth architecture "
              "(ExperimentConfig.architecture)", file=sys.stderr, flush=True)
        raise SystemExit(1)


class Pool(md2_scenes.Pool):
    """:class:`gpubench.md2_scenes.Pool`'s batches without the right view,
    each with ``aug_u`` (batch_size,) float32 drawn from the seed."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device | str = "cpu"):
        super().__init__(config, traffic, seed, device)
        draws = np.random.default_rng(seed ^ AUG_SEED)
        self.batches = [dict({k: v for k, v in b.items() if k != "image_r"},
                             aug_u=draws.random(config["batch_size"], dtype=np.float32))
                        for b in self.batches]


def state_buffers(models, config: dict) -> Dict[str, torch.Tensor]:
    """The system's running statistics and trackers, keyed as the
    reference's."""
    buffers = {f"{net}.{k}": v for net in NETS for k, v in getattr(models, net).named_buffers()}
    return {k: buffers[k] for k, _, kind in mf_weights.specs(config)
            if kind in ("bn_mean", "bn_var", "tracker")}


def run(cell, seed: int, seconds: float, trace: bool, dev: torch.device,
        t_start: float) -> dict:
    require_manydepth()
    from depthvo_tpu_torch.configs import base as config_base
    from depthvo_tpu_torch.train import loop
    from depthvo_tpu_torch.train.state import (
        TrainState, build_models, load_params, make_optimizer, param_tree)

    from gpubench import spec

    config = spec.experiment(cell.config)
    traffic = cell.traffic
    if traffic["source"] != "pool":
        raise ValueError(f"unknown training source {traffic['source']!r}")
    cfg = config_base.from_dict(config)
    checked = traffic["checked_steps"]
    marks = [("start", time.perf_counter())]
    source = Pool(config, traffic, seed, dev)
    marks.append(("render", time.perf_counter()))
    params = mf_weights.make(config, seed, dev)
    models = load_params(build_models(cfg), weights.state_dicts(params), dev).train()
    state = TrainState(0, models, make_optimizer(cfg).init(param_tree(models)))
    names = mf.trainable(config)
    fit_kw = dict(steps_per_call=traffic["steps_per_call"], prefetch=traffic["prefetch"],
                  device=dev)
    marks.append(("weights", time.perf_counter()))
    after_first: Dict[str, torch.Tensor] = {}

    def keep_first(end, state):
        if not after_first:
            pt = param_tree(state.models)
            after_first.update({k: pt[k].detach().clone() for k in names})
            after_first.update({k: v.clone()
                                for k, v in state_buffers(state.models, config).items()})

    losses, first_grads = checked_fits(loop, cfg, source, state, checked, names,
                                       config["optim"]["beta1"], fit_kw, keep_first)
    pt = param_tree(state.models)
    change = {k: (pt[k].detach() - params[k]).cpu() for k in names}
    bn_change = {k: (v - params[k]).cpu() for k, v in state_buffers(state.models, config).items()
                 if not k.endswith("_depth_bin")}
    trackers = {k: float(v) for k, v in state_buffers(state.models, config).items()
                if k.endswith("_depth_bin")}
    marks.append(("checked_steps", time.perf_counter()))

    window = timed_window(
        lambda on_log: loop.fit(cfg, source, 10 ** 12, state=state, log_fn=on_log,
                                sighup_effect="stop", **fit_kw),
        seconds, trace, traffic["trace_seconds"], dev, t_start)
    marks.append(("window_first_call", t_start + window["setup_s"]))
    steps = state.step - window["step0"]
    window_s = window["t1"] - window["t0"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    traced = window["traced"]
    finite = all(bool(torch.isfinite(p).all()) for p in param_tree(state.models).values())
    # the matching layer on the timed state, then on the state of the
    # first checked step in networks of its own
    batch = loop.batch_to_device(source.reference_batch(0), dev)
    match = {"timed": matching_number(loop, cfg, state.models, config, batch)}
    del state, models, pt
    first_models = load_params(build_models(cfg), weights.state_dicts({**params, **after_first}),
                               dev).train()
    match[f"step_{checked[0]}"] = matching_number(loop, cfg, first_models, config, batch)
    del first_models, batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    detail: Dict[str, object] = {"setup_parts": {
        name: b - a for (_, a), (name, b) in zip([("", t_start)] + marks[:-1], marks)},
        "trackers": trackers}
    numbers = reference_numbers(config, params, source, checked, losses, first_grads, change,
                                bn_change, dev, seed, detail, after_first=after_first)
    numbers["match"] = max(v for parts in match.values() for v in parts.values())
    detail["match"] = match
    rows = config["batch_size"] * steps
    return {
        "attempted": steps, "failed": 0 if finite else steps,
        "numbers": numbers, "detail": detail, "window_s": window_s,
        "setup_s": window["setup_s"], "memory_peak_bytes": peak, "traced": traced,
        "run": {"window_s": traced["window_s"] if traced else window_s, "steps": steps,
                "rows": rows, "config": config, "trace": traced,
                "flops_per_step": mf_flops.train_step(config) if trace else 0, "spans": []},
        "rate": rows / window_s,
    }


def reference_numbers(config, params, source, checked, losses, first_grads, change, bn_change,
                      dev, seed: int, detail: dict | None = None,
                      precision: str = "float32",
                      after_first: Dict[str, torch.Tensor] | None = None) -> Dict[str, float]:
    """The reference follows the checked steps on the same rows in
    ``precision`` (TF32 off); with ``after_first``, the parameters,
    statistics and trackers the system reached at the first checked step,
    it also runs the next step's forward from them. The numbers of
    :mod:`compare` but ``match``, and in ``detail`` the readings that
    chose them."""
    first = checked[0]
    same_weights = {}  # step -> the reference's loss terms on the system's weights
    with float32_only():
        ref = mf.Trainer(config, params, precision, noise_seed=seed)
        ref_losses = {}
        for j in range(checked[-1]):
            batch = {k: torch.as_tensor(np.ascontiguousarray(v)).to(dev)
                     for k, v in source.reference_batch(j).items()}
            ref_losses[j + 1] = ref.step(batch)
            if after_first and j == first and j + 1 in checked:
                same_weights[j + 1] = forward_terms(config, after_first, batch, seed)
        ref_first = {k: g.cpu() for k, g in ref.first_grads.items()}
        ref_change = {k: (ref.p[k] - params[k]).cpu() for k in ref.names}
        ref_bn = {k: (v - params[k]).cpu() for k, v in ref.stats.items()}
        ref_trackers = dict(ref.trackers)
    change_gaps = compare.leaf_gaps(change, ref_change, compare.moved(ref_first))
    same_weights[first] = ref_losses[first]

    def gap(s, k, v):
        return compare.rel(losses[s].get(k, math.inf), v)

    numbers = {
        "loss": max(gap(s, k, v) for s, terms in same_weights.items()
                    for k, v in terms.items() if k in JUDGED_TERMS),
        "consistency": max(gap(s, k, v) for s, terms in same_weights.items()
                           for k, v in terms.items() if k in CONSISTENCY_TERMS),
        "grad": compare.median_leaf(first_grads, ref_first),
        "change": change_gaps[int(0.9 * (len(change_gaps) - 1))],
        "bn": compare.median_leaf(bn_change, ref_bn),
    }
    if detail is not None:
        detail["loss_by_term_same_weights"] = {
            s: {k: gap(s, k, v) for k, v in terms.items() if k.startswith("loss/")}
            for s, terms in same_weights.items()}
        detail["loss_by_term"] = {k: max(gap(s, k, ref_losses[s][k]) for s in checked)
                                  for k in ref_losses[checked[0]] if k.startswith("loss/")}
        detail["reference_shares"] = {s: {k: v for k, v in ref_losses[s].items()
                                          if not k.startswith("loss/")} for s in checked}
        detail["reference_trackers"] = ref_trackers
        keys = compare.moved(ref_first)
        norm = {k: float(torch.linalg.vector_norm(ref_change[k].double())) for k in keys}
        median = sorted(norm.values())[len(norm) // 2]
        detail["change_worst_leaf"] = max(keys, key=lambda k: abs(float(
            torch.linalg.vector_norm(change[k].double())) - norm[k]) / max(norm[k], median))
        detail["sign_flips"] = sign_flips(first_grads, ref_first, keys,
                                          detail["change_worst_leaf"])
        detail["grad"] = compare.spread(first_grads, ref_first)
        detail["change"] = compare.spread(change, ref_change, compare.moved(ref_first))
        detail["bn"] = compare.spread(bn_change, ref_bn)
    return numbers


def forward_terms(config, weights: Dict[str, torch.Tensor], batch, seed: int) -> Dict[str, float]:
    """The reference's loss terms in float32 on ``weights`` (parameters,
    BatchNorm statistics and trackers, keyed as the reference's), without
    a step."""
    names = set(mf.trainable(config))
    p = {k: v.float() for k, v in weights.items() if k in names}
    stats = {k: v.clone() for k, v in weights.items() if "running" in k}
    trackers = {"min": float(weights["depth.encoder.min_depth_bin"]),
                "max": float(weights["depth.encoder.max_depth_bin"])}
    gen = torch.Generator(device=batch["image_t"].device).manual_seed(seed)
    with torch.no_grad():
        _, terms, _ = mf.forward(p, stats, trackers, batch, mf.options(config),
                                 lambda shape: torch.randn(shape, generator=gen,
                                                           device=gen.device), True)
    return {k: float(v) for k, v in terms.items()}


@contextlib.contextmanager
def float32_only():
    """TF32 off for the reference's convolutions and matmuls."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def system_matching(loop, cfg, models, batch) -> dict:
    """One eager forward of the system's loss graph in train mode on
    ``batch``, without gradients, reading the matching layer at its
    modules: the multi-frame net's arguments (image, lookup image, K at
    the matching scale, matching pose) and its lowest cost and confidence,
    the encoder's ``layer1`` outputs (the current features, then the
    lookup's), ``reduce_conv``'s input (the current features and the
    volume times the confidence), and the trackers before the step moves
    them. Float32 tensors."""
    enc = models.depth.encoder
    seen: Dict[str, object] = {"feats": []}
    hooks = [
        models.depth.register_forward_pre_hook(lambda m, a: seen.setdefault("args", a)),
        models.depth.register_forward_hook(lambda m, a, out: seen.setdefault("out", out)),
        enc.layer1.register_forward_hook(lambda m, a, out: seen["feats"].append(out)),
        enc.reduce_conv.register_forward_pre_hook(lambda m, a: seen.setdefault("x", a[0])),
    ]
    trackers = {"min": float(enc.min_depth_bin), "max": float(enc.max_depth_bin)}
    try:
        with torch.no_grad():
            loop.compute_losses(cfg, models, batch, train=True)
    finally:
        for h in hooks:
            h.remove()
    image, lookup, _, T = seen["args"]
    _, lowest, conf, _ = seen["out"]
    cur = seen["feats"][0]
    return {"image": image.float(), "lookup": lookup.float(), "T": T.float(),
            "trackers": trackers, "volume": seen["x"][:, cur.shape[1]:].float(),
            "conf": conf.float(), "lowest": lowest.float()}


def augmentation_rows(batch) -> tuple:
    """The reference trainer's choice for each row: (static camera, zero
    matching pose), bool (B,) each."""
    u = batch["aug_u"].float()
    static = u < mf.STATIC_SHARE
    zero_cv = ~static & (u < mf.STATIC_SHARE + mf.ZERO_CV_SHARE)
    zero_pose = zero_cv | (md2.to_color(batch["image_p"]).flatten(1).sum(1) == 0)
    return static, zero_pose


def reference_matching(p, stats, trackers, batch, T, precision: str = "float32") -> dict:
    """The reference's matching layer in ``precision`` (the features'
    precision; the volume is float32 arithmetic, as ``match_features``
    has it): the multi-frame encoder's stem from ``p`` and ``stats``
    (keyed as the reference's; the statistics are not moved) in train mode
    on ``batch``'s current frame and on each row's lookup frame (frame 0 on
    a static-camera row, else frame -1), the bins from ``trackers``
    ({"min", "max"}), the matching pose ``T`` (B, 4, 4) zeroed on the rows
    the reference zeroes, and ``K`` from the batch at the matching scale.
    The volume times the confidence, the confidence and the lowest cost."""
    static, zero_pose = augmentation_rows(batch)
    cur = md2.to_color(batch["image_t"])
    lookup = torch.where(static.view(-1, 1, 1, 1), cur, md2.to_color(batch["image_p"]))
    T = T * (~zero_pose).float().view(-1, 1, 1)
    stats = {k: v.clone() for k, v in stats.items()}
    md2._PRECISION[0] = precision
    try:
        f0 = mf.feature_extraction(p, stats, "depth.encoder.", cur, True)
        f1 = mf.feature_extraction(p, stats, "depth.encoder.", lookup, True)
    finally:
        md2._PRECISION[0] = "float32"
    B, _, h, w = f0.shape
    K3 = batch["K"].float()
    K = torch.zeros(B, 4, 4, device=K3.device)
    K[:, :2, :3] = K3[:, :2] * (1.0 / 2 ** mf.MATCHING_SCALE)
    K[:, 2, :3] = K3[:, 2]
    K[:, 3, 3] = 1
    bins, warp_depths = mf.compute_depth_bins(trackers["min"], trackers["max"],
                                              mf.NUM_DEPTH_BINS, h, w, f0.device)
    volume, missing = mf.match_features(f0, f1.unsqueeze(1), T.unsqueeze(1), K,
                                        torch.linalg.inv(K.double()).float(), warp_depths)
    conf, lowest, volume = mf.lowest_cost_and_volume(volume, missing, bins)
    return {"volume": volume, "conf": conf, "lowest": lowest}


def matching_gaps(program: dict, reference: dict) -> Dict[str, float]:
    """``volume``: on the pixels confident on both sides, the norm of the
    volumes' difference over the reference's (0 where there are none);
    ``confidence``: the share of pixels whose confidence differs (a pixel
    whose confidence flips, with few confident pixels, would otherwise
    weigh its whole column in ``volume``); ``lowest``: the median over
    pixels of the lowest costs' relative gap."""
    both = ((program["conf"] > 0) & (reference["conf"] > 0)).unsqueeze(1)
    diff = float(torch.linalg.vector_norm(
        ((program["volume"] - reference["volume"]) * both).double()))
    norm = float(torch.linalg.vector_norm((reference["volume"] * both).double()))
    lowest = ((program["lowest"] - reference["lowest"]).abs() / reference["lowest"].abs())
    return {"volume": 0.0 if diff == 0 else diff / norm if norm > 0 else math.inf,
            "confidence": float((program["conf"] != reference["conf"]).float().mean()),
            "lowest": float(lowest.flatten().median())}


def row_gaps(seen: dict, batch) -> Dict[str, float]:
    """The share of rows whose lookup image, or whose zero matching pose,
    is not the reference trainer's choice."""
    static, zero_pose = augmentation_rows(batch)
    cur = seen["image"]
    prev = md2.to_color(batch["image_p"])
    want = torch.where(static.view(-1, 1, 1, 1), cur, prev)
    wrong_lookup = (seen["lookup"] - want).flatten(1).abs().amax(1) > 1e-6
    wrong_pose = (seen["T"].flatten(1) == 0).all(1) != zero_pose
    return {"lookup_rows": float(wrong_lookup.float().mean()),
            "zero_pose_rows": float(wrong_pose.float().mean())}


def matching_number(loop, cfg, models, config: dict, batch) -> Dict[str, float]:
    """The parts of ``match`` on ``models`` (:func:`system_matching` against
    :func:`reference_matching` in float32 on the same rows; the rows that
    reach the system's matching layer, should fewer)."""
    seen = system_matching(loop, cfg, models, batch)
    rows = seen["image"].shape[0]
    batch = {k: v[:rows] for k, v in batch.items()}
    pt = {f"{net}.{k}": v for net in NETS for k, v in getattr(models, net).named_parameters()}
    names = set(mf.trainable(config))
    p = {k: v.detach().float() for k, v in pt.items() if k in names}
    stats = {k: v for k, v in state_buffers(models, config).items() if "running" in k}
    with float32_only(), torch.no_grad():
        ref = reference_matching(p, stats, seen["trackers"], batch, seen["T"])
    return {**matching_gaps(seen, ref), **row_gaps(seen, batch)}
