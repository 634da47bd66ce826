"""Command line of the port (counterpart of ``depthvo_tpu/cli.py``).

Seven subcommands are ported so far::

    python -m depthvo_tpu_torch.cli train --variant full_feat --steps 1000 \\
        [--kitti-root R --drives D1,D2 | --kitti-odom-root R --sequences 00,01
         | --train-list L [--kitti-root R]] [--native-ring 1|0] [--config F] \\
        [--checkpoint-dir C] [--init-from C1] [--init-feat-from C2] \\
        [--batch-size 4] [--height H --width W] [--seed 0] [--device cuda|cpu] \\
        [--log-every N] [--log-jsonl F] [--eval-every N --eval-steps 10 --val-list L]
    python -m depthvo_tpu_torch.cli test [--checkpoint-dir C] [--val-list L] \\
        [--variant full_feat] --iterations 10 [--device cuda|cpu]
    python -m depthvo_tpu_torch.cli prep --kitti-root R [--drives ...] [--eigen-train] \\
        | --odom-root R --sequences 00,01  [--height 160 --width 608] --output L
    python -m depthvo_tpu_torch.cli prep-eigen --kitti-root R [--scenes D | --split-file S] \\
        --output-dir G
    python -m depthvo_tpu_torch.cli eval-depth --kitti-root R --split-file G/eigen_list.txt \\
        [--checkpoint-dir C] [--save-preds P | --pred-path P \\
        [--pred-inverse]] [--no-median-scale] [--max-depth 80] [--split-sha SHA] \\
        [--device cuda|cpu]
    python -m depthvo_tpu_torch.cli eval-odom --kitti-root R --sequence 09 \\
        [--checkpoint-dir C | --pose-file F] [--output-dir O] [--device cuda|cpu]
    python -m depthvo_tpu_torch.cli infer --images DIR --output-dir O [--checkpoint-dir C] \\
        [--batch-size 16] [--save-png] [--device cuda|cpu]

``train`` (the ``caffe train`` analog) runs ``fit`` on a KITTI raw tree,
a KITTI odometry tree, a prepared sample list or, with none of them,
synthetic scenes, and prints the loss terms as ``step N: k=v ...`` lines
every ``--log-every`` steps (the config's ``log_every`` by default) and
after the last, with the held-out ``val/...`` terms every
``--eval-every`` steps. With ``--checkpoint-dir`` it snapshots there and
resumes when the same command runs again; ``--init-from`` starts from a
previous stage's weights and ``--init-feat-from`` takes the feature net
from another directory; ``--config`` takes a whole experiment config
from JSON. ``test`` averages the eval-mode loss graph over held-out
batches (the ``caffe test`` analog) of the checkpoint in
``--checkpoint-dir`` (its ``config.json`` gives the architecture), or of
random weights, and prints the same ``val/...`` JSON as the reference's
``test``. ``prep`` writes a sample list. ``prep-eigen`` writes the Eigen
ground truth from the velodyne scans and its list; ``eval-depth`` and
``eval-odom`` print the reference's JSON tables (from saved predictions
or a pose file alone with ``--pred-path`` / ``--pose-file``); ``infer``
writes ``<stem>_depth.npy`` per frame and prints the steady frames/s.
The commands that run a network run on the GPU and refuse to run
without one unless ``--device cpu`` is given. Not ported: ``--int8``
(ROADMAP A.6) and ``--num-devices`` > 1 (A.8) raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from depthvo_tpu_torch import configs
from depthvo_tpu_torch.api import DepthVO
from depthvo_tpu_torch.configs import base as config_base
from depthvo_tpu_torch.data import kitti
from depthvo_tpu_torch.data.eigen import EIGEN_TEST_SCENES
from depthvo_tpu_torch.data.synthetic import SyntheticScenes
from depthvo_tpu_torch.io import checkpoint as ckpt_io
from depthvo_tpu_torch.train import loop as train_loop
from depthvo_tpu_torch.train.state import create_state
from depthvo_tpu_torch.utils.device import resolve_device
from depthvo_tpu_torch.utils.logging import MetricLogger

VARIANTS = ["stereo", "temporal_stereo", "full_feat", "tiny_test"]
HELD_OUT_SEED = 1_000_003  # synthetic validation scenes: disjoint from training's


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--variant", default="full_feat", choices=VARIANTS)
    # None = keep the variant's own resolution (tiny_test is 32x96).
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--checkpoint-dir", default=None)


def _make_config(args):
    if getattr(args, "config", None):
        # A whole ExperimentConfig from JSON (the reference's `train
        # --config`): the variant, size and batch flags are superseded.
        return config_base.load_json(args.config)
    cfg = getattr(configs, args.variant)(batch_size=args.batch_size,
                                         seed=getattr(args, "seed", 0))
    height = args.height if args.height is not None else cfg.model.height
    width = args.width if args.width is not None else cfg.model.width
    if (height, width) != (cfg.model.height, cfg.model.width):
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, height=height, width=width))
    return cfg


def _restore_or_make_config(args):
    """The checkpoint's saved config.json wins over the flags (it records
    the trained architecture); else the config from the flags."""
    if args.checkpoint_dir:
        path = os.path.join(args.checkpoint_dir, "config.json")
        if os.path.isfile(path):
            return config_base.load_json(path)
    return _make_config(args)


def _split(csv: str):
    return [s.strip() for s in csv.split(",") if s.strip()]


def _held_out(args, cfg):
    """Held-out batches: a sample list, else synthetic scenes."""
    if args.val_list:
        ds = kitti.load_train_list(args.kitti_root or ".", args.val_list,
                                   cfg.model.height, cfg.model.width, u8=True)
        return ds.iterator(cfg.batch_size, shuffle=False), (
            f"{len(ds)} samples from {args.val_list}")
    it = SyntheticScenes(cfg, seed=cfg.seed + HELD_OUT_SEED, u8=True).iterator(cfg.batch_size)
    return it, "held-out synthetic scenes (pass --val-list for real data)"


def cmd_test(args) -> int:
    """`caffe test` analog: average the eval-mode loss over N held-out
    batches of the checkpoint's weights (random weights without one)."""
    device = resolve_device(args.device)
    cfg = _restore_or_make_config(args)
    state = create_state(cfg, device, torch.Generator().manual_seed(args.seed))
    if args.checkpoint_dir:
        state = ckpt_io.restore_weights(args.checkpoint_dir, state)
    it, what = _held_out(args, cfg)
    print(f"test phase: {what}")
    eval_fn = train_loop.make_eval_step(cfg, device=device)
    metrics = train_loop.run_validation(eval_fn, state.models, it, args.iterations)
    print(json.dumps(metrics, indent=2))
    return 0


def _load_model(args):
    """The model for eval and inference: the checkpoint's weights under its
    saved config.json (else the flags' config), or random weights."""
    device = resolve_device(args.device)
    if not args.checkpoint_dir:
        return DepthVO.from_random(_make_config(args), device=device)
    return DepthVO.from_checkpoint(args.checkpoint_dir, _restore_or_make_config(args),
                                   device=device)


def _model_resolution(args, model) -> tuple:
    """Eval/infer resolution: explicit flags win, else the (restored)
    model config's training resolution."""
    h = args.height if args.height is not None else model.config.model.height
    w = args.width if args.width is not None else model.config.model.width
    return h, w


def _not_ported(args) -> None:
    """The reference's flags whose paths are not ported raise, never
    silently run something else."""
    if getattr(args, "int8", False):
        raise NotImplementedError("--int8: int8 serving is not ported yet (ROADMAP A.6)")
    if (getattr(args, "num_devices", None) or 1) > 1:
        raise NotImplementedError(
            f"--num-devices {args.num_devices}: data-parallel eval is not ported yet "
            "(ROADMAP A.8)")


def cmd_eval_depth(args) -> int:
    """Eigen-split depth metrics of a model, or of saved predictions
    (``--pred-path``: the metric pass alone, no model and no device)."""
    from depthvo_tpu_torch.eval.runner import run_depth_eval

    _not_ported(args)
    if args.pred_path:
        metrics = run_depth_eval(
            checkpoint_dir=None, kitti_root=args.kitti_root, split_file=args.split_file,
            max_depth=args.max_depth, median_scale=not args.no_median_scale,
            pred_path=args.pred_path, pred_inverse=args.pred_inverse,
            split_sha=args.split_sha,
        )
        print(json.dumps(metrics, indent=2))
        return 0
    model = _load_model(args)
    h, w = _model_resolution(args, model)
    metrics = run_depth_eval(
        checkpoint_dir=args.checkpoint_dir, kitti_root=args.kitti_root,
        split_file=args.split_file, max_depth=args.max_depth, height=h, width=w,
        save_preds_dir=args.save_preds, model=model,
        median_scale=not args.no_median_scale, split_sha=args.split_sha,
    )
    print(json.dumps(metrics, indent=2))
    return 0


def cmd_eval_odom(args) -> int:
    """KITTI odometry errors of a model over one sequence, or of a pose
    file (``--pose-file``: the devkit phase alone, no model)."""
    from depthvo_tpu_torch.eval.runner import run_odometry_eval

    if args.pose_file:
        metrics = run_odometry_eval(
            checkpoint_dir=None, kitti_odom_root=args.kitti_root, sequence=args.sequence,
            output_dir=args.output_dir, pose_file=args.pose_file,
        )
        print(json.dumps(metrics, indent=2))
        return 0
    model = _load_model(args)
    h, w = _model_resolution(args, model)
    metrics = run_odometry_eval(
        checkpoint_dir=args.checkpoint_dir, kitti_odom_root=args.kitti_root,
        sequence=args.sequence, output_dir=args.output_dir, height=h, width=w, model=model,
    )
    print(json.dumps(metrics, indent=2))
    return 0


def _png_writer():
    """``fn(path, depth)`` writing a colour-mapped inverse-depth PNG (near
    is bright; magma, normalised per image at the 2nd/98th percentiles).
    It needs matplotlib and Pillow, and raises at once without them."""
    try:
        from matplotlib import cm
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"--save-png needs matplotlib and Pillow: {e}") from None

    def write(path: str, depth: np.ndarray) -> None:
        inv = 1.0 / np.maximum(depth.astype(np.float64), 1e-6)
        lo, hi = np.percentile(inv, [2.0, 98.0])
        norm = np.clip((inv - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
        Image.fromarray((cm.magma(norm)[..., :3] * 255).astype(np.uint8)).save(path)

    return write


def cmd_infer(args) -> int:
    """Batched depth inference over a directory of frames: decoded on a
    host thread pool, swept by ``eval.runner.predict_depths``, one
    ``<stem>_depth.npy`` per frame."""
    import time

    from depthvo_tpu_torch.eval.runner import predict_depths

    _not_ported(args)
    write_png = _png_writer() if args.save_png else None
    model = _load_model(args)
    os.makedirs(args.output_dir, exist_ok=True)
    paths = sorted(os.path.join(args.images, f) for f in os.listdir(args.images)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if not paths:
        print(f"no images found under {args.images}")
        return 2
    h, w = _model_resolution(args, model)
    frames = kitti.load_images_u8(paths, h, w)
    bs = min(args.batch_size, len(paths))
    # One warm-up batch, so that the printed rate is the steady sweep's
    # (cuDNN's and the allocator's first-call set-up excluded).
    t0 = time.perf_counter()
    predict_depths(model, frames[:bs], batch_size=bs)
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    depths = predict_depths(model, frames, batch_size=bs)
    dt = time.perf_counter() - t0
    for path, depth in zip(paths, depths):
        stem = os.path.join(args.output_dir, os.path.splitext(os.path.basename(path))[0])
        np.save(stem + "_depth.npy", depth)
        if write_png is not None:
            write_png(stem + "_depth.png", depth)
    print(f"{len(paths)} frames -> {args.output_dir} "
          f"({len(paths) / max(dt, 1e-9):.1f} frames/s steady; "
          f"warm-up batch {t_warm:.1f} s; depth range "
          f"{depths.min():.2f}..{depths.max():.2f} m)")
    return 0


def cmd_prep_eigen(args) -> int:
    """Eigen-split ground-truth depth from the raw velodyne scans, and the
    eval list that ``eval-depth --split-file`` reads."""
    from depthvo_tpu_torch.data.eigen import prep_eigen

    n, list_path = prep_eigen(kitti_root=args.kitti_root, out_dir=args.output_dir,
                              split_file=args.split_file, scenes=_split(args.scenes) or None)
    print(f"wrote {n} gt depth maps; eval list: {list_path}")
    return 0


def cmd_train(args) -> int:
    """`caffe train` analog: ``fit`` on KITTI-format data or synthetic
    scenes, with checkpoints and the staged recipe's init."""
    device = resolve_device(args.device)
    cfg = _make_config(args)
    if args.log_every is not None:
        cfg = dataclasses.replace(cfg, log_every=args.log_every)
    if args.init_from:
        cfg = dataclasses.replace(cfg, init_from=args.init_from)
    if args.init_feat_from:
        cfg = dataclasses.replace(cfg, init_feat_from=args.init_feat_from)
    h, w = cfg.model.height, cfg.model.width
    # Batches stay uint8 until they are on the device (the train step
    # normalises there); the C++ ring emits uint8 too.
    if args.train_list:
        ds = kitti.load_train_list(args.kitti_root or ".", args.train_list, h, w, u8=True)
        print(f"train list: {len(ds)} samples from {args.train_list}")
    elif args.kitti_odom_root:
        seqs = _split(args.sequences)
        ds = kitti.KittiOdomStereo(args.kitti_odom_root, seqs, h, w, u8=True)
        print(f"KITTI odometry: {len(ds)} training samples from seqs {seqs}")
    elif args.kitti_root:
        drives = _split(args.drives)
        ds = kitti.KittiRawStereo(args.kitti_root, drives, h, w, u8=True)
        print(f"KITTI raw: {len(ds)} training samples from {len(drives)} drives")
    else:
        ds = None
        print("no --kitti-root given: training on synthetic scenes")
    if ds is None:
        it = SyntheticScenes(cfg, seed=cfg.seed, u8=True).iterator(cfg.batch_size)
    else:
        it = ds.iterator(cfg.batch_size, seed=cfg.seed, native_ring=args.native_ring)
    eval_it = None
    if args.eval_every > 0:
        eval_it, what = _held_out(args, cfg)
        print(f"validation: {what} every {args.eval_every} steps")
    log = MetricLogger(jsonl_path=args.log_jsonl)
    try:
        train_loop.fit(
            cfg, it, args.steps, checkpoint_dir=args.checkpoint_dir, log_fn=log,
            steps_per_call=args.steps_per_call,
            eval_iter=eval_it, eval_every=args.eval_every, eval_steps=args.eval_steps,
            sigint_effect=args.sigint_effect, sighup_effect=args.sighup_effect,
            device=device,
        )
    finally:
        log.close()
    return 0


def cmd_prep(args) -> int:
    """Write a training sample list from a KITTI raw or odometry tree (the
    reference's offline data-prep scripts)."""
    h, w = args.height or 160, args.width or 608
    if args.odom_root:
        seqs = _split(args.sequences)
        ds = kitti.KittiOdomStereo(args.odom_root, seqs, h, w)
        n = kitti.write_train_list(ds, args.output, args.odom_root)
        print(f"wrote {n} samples from odometry seqs {seqs} to {args.output}")
        return 0
    if not args.kitti_root:
        print("prep: need --kitti-root (raw) or --odom-root (odometry)")
        return 2
    drives = _split(args.drives)
    if not drives:  # every *_sync drive under the root
        root = args.kitti_root
        drives = sorted(d for date in os.listdir(root) if os.path.isdir(os.path.join(root, date))
                        for d in os.listdir(os.path.join(root, date)) if d.endswith("_sync"))
        print(f"discovered {len(drives)} drives")
    if args.eigen_train:
        # Training must never see the Eigen test scenes.
        before = len(drives)
        drives = [d for d in drives if d not in EIGEN_TEST_SCENES]
        print(f"--eigen-train: excluded {before - len(drives)} Eigen "
              f"test-scene drives ({len(drives)} remain)")
    ds = kitti.KittiRawStereo(args.kitti_root, drives, h, w)
    n = kitti.write_train_list(ds, args.output, args.kitti_root)
    print(f"wrote {n} samples to {args.output}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="depthvo_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("train", help="staged training (reference: caffe train)")
    _add_common(p)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--config", default=None,
                   help="experiment-config JSON (as train saves beside its checkpoints); "
                        "supersedes --variant/--height/--width/--batch-size")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights and of the data order")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--kitti-root", default=None)
    p.add_argument("--drives", default="")
    p.add_argument("--kitti-odom-root", default=None,
                   help="KITTI odometry tree: train on sequences (ref: 00-08)")
    p.add_argument("--sequences", default="00,01,02,03,04,05,06,07,08",
                   help="odometry sequences for --kitti-odom-root")
    p.add_argument("--train-list", default=None,
                   help="prepared sample list (see the `prep` subcommand)")
    p.add_argument("--init-from", default=None,
                   help="previous stage checkpoint (staged finetune)")
    p.add_argument("--init-feat-from", default=None,
                   help="pretrain-feat checkpoint: overrides 'feat' params")
    p.add_argument("--native-ring", default=None,
                   type=lambda s: s.lower() in ("1", "true", "yes"),
                   help="force the C++ prefetch ring on/off (default: auto)")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="train steps per call: K > 1 captures the step as a CUDA "
                        "graph and replays it K times per call (the reference's "
                        "lax.scan); on the CPU, K eager steps")
    p.add_argument("--log-every", type=int, default=None,
                   help="print the loss terms every N steps (default: the config's)")
    p.add_argument("--log-jsonl", default=None,
                   help="also append per-step metrics as JSONL here")
    p.add_argument("--eval-every", type=int, default=0,
                   help="validate every N steps (caffe test_interval; 0 = never)")
    p.add_argument("--eval-steps", type=int, default=10,
                   help="held-out batches per validation (caffe test_iter)")
    p.add_argument("--val-list", default=None,
                   help="held-out sample list for validation (see `prep`); "
                        "default: held-out synthetic scenes")
    # Caffe's defaults: SIGINT stops after the step, SIGHUP asks for a
    # snapshot; both snapshot when there is a --checkpoint-dir.
    p.add_argument("--sigint-effect", default="stop", choices=["stop", "snapshot", "none"])
    p.add_argument("--sighup-effect", default="snapshot", choices=["stop", "snapshot", "none"])
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser(
        "test",
        help="average the loss over held-out batches (reference: caffe test)",
    )
    _add_common(p)
    p.add_argument("--iterations", type=int, default=10,
                   help="held-out batches to average (caffe test -iterations)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights (without --checkpoint-dir)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--kitti-root", default=None)
    p.add_argument("--val-list", default=None, help="held-out sample list (see `prep`)")
    p.set_defaults(fn=cmd_test)

    p = sub.add_parser("eval-depth", help="Eigen-split depth metrics")
    _add_common(p)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--num-devices", type=int, default=None,
                   help="data-parallel eval over N GPUs (not ported: N > 1 raises)")
    p.add_argument("--kitti-root", required=True)
    p.add_argument("--split-file", required=True)
    p.add_argument("--max-depth", type=float, default=80.0)
    p.add_argument("--save-preds", default=None,
                   help="also write the raw depth predictions (.npy) here")
    p.add_argument("--no-median-scale", action="store_true",
                   help="report unscaled metrics (stereo-trained models are metric)")
    p.add_argument("--pred-path", default=None,
                   help="evaluate SAVED predictions instead of a model: a (N,H,W) "
                        ".npy/.npz stack or a directory (--save-preds output, or "
                        "per-frame *.npy)")
    p.add_argument("--split-sha", default=None, metavar="SHA256",
                   help="pin the split file's SHA-256: refuse to run if it differs")
    p.add_argument("--pred-inverse", action="store_true",
                   help="stored maps are inverse depth; invert before the metric pass")
    p.add_argument("--int8", action="store_true",
                   help="the int8 serving path (not ported: raises)")
    p.set_defaults(fn=cmd_eval_depth)

    p = sub.add_parser("eval-odom", help="KITTI odometry seq eval (t_err/r_err/ATE)")
    _add_common(p)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--kitti-root", required=True)
    p.add_argument("--sequence", default="09")
    p.add_argument("--output-dir", default="./odom_out")
    p.add_argument("--pose-file", default=None,
                   help="score an existing KITTI-format pose file against the "
                        "sequence's ground truth instead of running the model")
    p.set_defaults(fn=cmd_eval_odom)

    p = sub.add_parser("infer", help="depth maps for a directory of frames")
    _add_common(p)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--images", required=True)
    p.add_argument("--output-dir", default="./depth_out")
    p.add_argument("--save-png", action="store_true",
                   help="also write colour-mapped inverse-depth PNGs (needs "
                        "matplotlib and Pillow)")
    p.add_argument("--int8", action="store_true",
                   help="the int8 serving path (not ported: raises)")
    # Inference amortizes over bigger batches than training's default.
    p.set_defaults(fn=cmd_infer, batch_size=16)

    p = sub.add_parser("prep", help="build a train-list file from KITTI raw/odometry")
    _add_common(p)
    p.add_argument("--kitti-root", default=None)
    p.add_argument("--drives", default="", help="comma-separated; empty = discover all")
    p.add_argument("--odom-root", default=None,
                   help="KITTI odometry tree (overrides --kitti-root)")
    p.add_argument("--sequences", default="00,01,02,03,04,05,06,07,08")
    p.add_argument("--output", default="train_list.txt")
    p.add_argument("--eigen-train", action="store_true",
                   help="exclude the Eigen TEST scenes from discovered drives")
    p.set_defaults(fn=cmd_prep)

    p = sub.add_parser(
        "prep-eigen",
        help="velodyne -> Eigen-split gt depth + eval list (reference gt protocol)",
    )
    p.add_argument("--kitti-root", required=True)
    p.add_argument("--output-dir", default="./eigen_gt")
    p.add_argument("--split-file", default=None,
                   help="canonical eigen_test_files list (either format); "
                        "default: enumerate the shipped test-scene drives")
    p.add_argument("--scenes", default="",
                   help="comma-separated drive names overriding the shipped list")
    p.set_defaults(fn=cmd_prep_eigen)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
