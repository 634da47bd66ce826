"""Command line of the port (counterpart of ``depthvo_tpu/cli.py``).

Every subcommand of the reference is ported::

    python -m depthvo_tpu_torch.cli train --variant full_feat --steps 1000 \\
        [--kitti-root R --drives D1,D2 | --kitti-odom-root R --sequences 00,01
         | --train-list L [--kitti-root R]] [--native-ring 1|0] [--config F] \\
        [--checkpoint-dir C] [--init-from C1] [--init-feat-from C2] \\
        [--batch-size 4] [--height H --width W] [--seed 0] [--device cuda|cpu] \\
        [--log-every N] [--log-jsonl F] [--tensorboard D] [--eval-every N --eval-steps 10 \\
        --val-list L] [--solver solver.prototxt] [--weights [net=]F.caffemodel ...] \\
        [--iter-size K] [--remat] [--debug-nans] [--steps-per-call K]
    python -m depthvo_tpu_torch.cli test [--checkpoint-dir C] [--val-list L] \\
        [--variant full_feat] --iterations 10 [--device cuda|cpu]
    python -m depthvo_tpu_torch.cli pretrain-feat [--kitti-root R --drives D | --train-list L] \\
        [--steps 2000] [--checkpoint-dir ./feat_ckpt] [--device cuda|cpu]
    python -m depthvo_tpu_torch.cli prep --kitti-root R [--drives ...] [--eigen-train] \\
        | --odom-root R --sequences 00,01  [--height 160 --width 608] --output L
    python -m depthvo_tpu_torch.cli prep-eigen --kitti-root R [--scenes D | --split-file S] \\
        --output-dir G
    python -m depthvo_tpu_torch.cli eval-depth --kitti-root R --split-file G/eigen_list.txt \\
        [--checkpoint-dir C] [--save-preds P | --pred-path P \\
        [--pred-inverse]] [--no-median-scale] [--max-depth 80] [--split-sha SHA] \\
        [--int8] [--device cuda|cpu]
    python -m depthvo_tpu_torch.cli eval-odom --kitti-root R --sequence 09 \\
        [--checkpoint-dir C | --pose-file F] [--output-dir O] [--device cuda|cpu]
    python -m depthvo_tpu_torch.cli infer --images DIR --output-dir O [--checkpoint-dir C] \\
        [--batch-size 16] [--save-png] [--int8] [--device cuda|cpu]
    python -m depthvo_tpu_torch.cli export-serving --output F [--checkpoint-dir C] \\
        [--input-dtype uint8|float32] [--batch N] [--head depth|disparity] \\
        [--int8-calib DIR] [--device cuda|cpu]
    python -m depthvo_tpu_torch.cli import-caffemodel --caffemodel F [--net depth|odom|feat] \\
        [--name-map M] [--proto P] [--input-mean B,G,R --input-scale S] [--checkpoint-dir C]
    python -m depthvo_tpu_torch.cli export-caffemodel --checkpoint-dir C --net depth --output F
    python -m depthvo_tpu_torch.cli convert [--solver S] [--proto P] \\
        --weights [net=]F ... --output-dir D [--lenient]
    python -m depthvo_tpu_torch.cli make-name-map --caffemodel F [--net N] [--proto P] \\
        --output M
    python -m depthvo_tpu_torch.cli net-info P [--json J]
    python -m depthvo_tpu_torch.cli zoo [--check EVAL_JSON [--int8] [--trust-split]]
    python -m depthvo_tpu_torch.cli bench --mode depth_infer|train_step|train_step_scan|\\
        odom_infer|warp|depth_layers|odom_layers|feat_layers [--steps 50] [--int8] \\
        [--remat] [--trace-dir D] [--device cuda|cpu]
    python -m depthvo_tpu_torch.cli device-query

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
writes ``<stem>_depth.npy`` per frame and prints the steady frames/s;
with ``--int8`` both calibrate on their frames and run the w8a8 program.
``export-serving`` writes the depth forward as one ``torch.export``
artifact and its JSON sidecar. ``train --solver`` overlays a Caffe
solver.prototxt (its net prototxt is recognised, not executed) and
``--weights`` seats ``.caffemodel`` files before training; the Caffe
weight tools (``import-caffemodel``, ``export-caffemodel``, ``convert``,
``make-name-map``, ``net-info``, ``zoo``) work on the host. ``bench``
times a hot path or prints a network's per-layer table
(``utils/profiling.py``), and ``device-query`` lists the CUDA devices.
The commands that run a network run on the GPU and refuse to run
without one unless ``--device cpu`` is given.

Data parallelism: ``train`` and ``test`` with ``--num-devices N`` (default:
every visible card; one on the CPU) start N ranks, one process per device
(NCCL between cards, gloo for ``--device cpu``), each on its rows of the
global batch (rounded up to a multiple of N); the step reduces over them
and computes the reference's step on the global batch. Logs, checkpoint
files and ``config.json`` come from the coordinator (rank 0). Across
hosts, run the same command on every host with ``--coordinator
HOST:PORT --num-processes P --process-id I`` (or ``DEPTHVO_COORDINATOR``
/ ``DEPTHVO_NUM_PROCESSES`` / ``DEPTHVO_PROCESS_ID``): each process starts
its N/P local ranks. ``--num-slices S`` shapes the mesh as (dcn=S,
data=N/S). ``eval-depth --num-devices N`` splits each batch over N
replicas in one process. ``pretrain-feat`` trains the feature net
contrastively and writes a checkpoint for ``train --init-feat-from``.
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
from depthvo_tpu_torch.parallel import distributed as pdist, mesh as pmesh
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
    # train and convert default the variant and batch to None ("not given")
    # so that a solver's net prototxt can fill them; the documented
    # defaults apply here.
    cfg = getattr(configs, args.variant or "full_feat")(
        batch_size=args.batch_size if args.batch_size is not None else 4,
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


def _solver_net_path(solver_path, solver_text):
    """The solver's ``net:``/``train_net:`` pointer, resolved relative to
    the solver file; None when the solver names no net."""
    from depthvo_tpu_torch.io.solver_prototxt import parse_solver_prototxt

    fields = parse_solver_prototxt(solver_text)
    net_path = fields.get("net") or fields.get("train_net")
    if not isinstance(net_path, str):
        return None
    if not os.path.isabs(net_path):
        net_path = os.path.join(os.path.dirname(os.path.abspath(solver_path)), net_path)
    return net_path


def _recognize_net_file(net_path):
    """Parse and classify a net prototxt; returns (facts, overrides),
    printing the report and the mapping notes."""
    from depthvo_tpu_torch.io.net_prototxt import (
        config_overrides, extract_facts, format_report, parse_prototxt,
    )

    with open(net_path) as f:
        facts = extract_facts(parse_prototxt(f.read()))
    over, notes = config_overrides(facts)
    print(format_report(facts, over))
    for n in notes:
        print(f"net: {n}")
    return facts, over


def _apply_solver_net(args, solver_text):
    """Resolve and recognize the solver's ``net:`` prototxt.

    Returns the net's config overrides (loss weights, the importer's
    ``input_mean``/``input_scale``) and seats variant, batch and size onto
    ``args`` where the user did not pass the flag. A missing net file
    warns and falls back to the flags: reference solver files point at
    paths that need not exist here."""
    net_path = _solver_net_path(args.solver, solver_text)
    if net_path is None:
        return {}
    if not os.path.isfile(net_path):
        print(f"solver: net file {net_path} not found; "
              f"using --variant {args.variant or 'full_feat'}")
        return {}
    facts, over = _recognize_net_file(net_path)
    if facts.kind != "train_graph":
        print(f"net: {net_path} is a {facts.kind} deploy graph, not a "
              f"training graph; keeping --variant {args.variant or 'full_feat'} "
              "(pair deploy files with import-caffemodel)")
        return {}
    if "variant" in over and args.variant is None:
        args.variant = over["variant"]
    if "batch_size" in over and args.batch_size is None:
        args.batch_size = over["batch_size"]
    if args.height is None and "height" in over:
        args.height = over["height"]
    if args.width is None and "width" in over:
        args.width = over["width"]
    print(f"net: -> variant={args.variant or 'full_feat'} "
          f"batch={args.batch_size if args.batch_size is not None else 4} "
          f"size={args.height or 'default'}x{args.width or 'default'}")
    return over


def _weights_spec(spec: str):
    """``[net=]path`` -> (net, path); the net defaults to ``depth``."""
    net, sep, path = spec.partition("=")
    return (net, path) if sep else ("depth", spec)


def _state_with_caffe_weights(cfg, specs, device, input_mean=None, input_scale=1.0):
    """``caffe train --weights=x.caffemodel``: a fresh train state with
    released blobs seated. ``specs`` are ``[net=]path`` strings; the
    solver net's ``transform_param`` mean/scale fold into each imported
    net's input conv, as ``caffe train`` applies it. Placement goes
    through the audited name map of ``convert``/``make-name-map``."""
    from depthvo_tpu_torch.io import caffemodel, import_weights
    from depthvo_tpu_torch.io import name_map as nm
    from depthvo_tpu_torch.io.from_jax import load_jax_params
    from depthvo_tpu_torch.io.to_flax_layout import to_flax_layout

    state = create_state(cfg, device)
    params, stats = to_flax_layout(state.models)
    for spec in specs:
        net, path = _weights_spec(spec)
        if net not in params:
            raise SystemExit(f"--weights net {net!r} not in variant {cfg.name!r} "
                             f"(has: {sorted(params)})")
        layers = caffemodel.parse_caffemodel(path)
        net_stats = stats if net == "depth" else None
        m, entries, problems = nm.generate_name_map(layers, params[net], net_stats,
                                                    strict=False)
        print(f"--weights: {path} -> net {net!r} (audited name map)")
        print(nm.format_map_report(entries, problems))
        kw = {}
        if m["convs"] and not problems:
            kw = dict(name_map=m["convs"], bn_name_map=m["bns"] or None)
        else:
            print(f"--weights: name-map derivation incomplete for {path} — falling back "
                  "to shape-order import (inspect the report above; `convert` refuses "
                  "this case)")
        params[net], net_stats, report = import_weights.import_net(
            layers, params[net], net_stats, input_mean=input_mean,
            input_scale=input_scale, **kw)
        if net == "depth":
            stats = net_stats
        print(f"--weights: placed {len(report)} entries from {path} into net {net!r}")
    load_jax_params(state.models, params, stats)
    return state


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
    batches of the checkpoint's weights (random weights without one);
    over ``--num-devices`` ranks, the global batch's loss."""
    return _launch(args, "test")


def _round_batch(cfg, mesh):
    """The reference's rule: a global batch not divisible by the mesh is
    rounded up."""
    if mesh is None or cfg.batch_size % mesh.size == 0:
        return cfg
    new_bs = -(-cfg.batch_size // mesh.size) * mesh.size
    print(f"global batch {cfg.batch_size} not divisible by mesh {mesh.size}; "
          f"rounding up to {new_bs}")
    return dataclasses.replace(cfg, batch_size=new_bs)


def _test(args, device, mesh) -> int:
    cfg = _round_batch(_restore_or_make_config(args), mesh)
    state = create_state(cfg, device, torch.Generator().manual_seed(args.seed))
    if args.checkpoint_dir:
        state = ckpt_io.restore_weights(args.checkpoint_dir, state)
    if mesh is not None:
        pmesh.replicate(state, mesh)
    it, what = _held_out(args, cfg)
    print(f"test phase: {what}")
    eval_fn = train_loop.make_eval_step(cfg, device=device, mesh=mesh)
    metrics = train_loop.run_validation(eval_fn, state.models, it, args.iterations, mesh)
    print(json.dumps(metrics, indent=2))
    return 0


def _launch(args, command: str) -> int:
    """Run ``command`` on one device (``mesh`` None, the plain path) or
    over the data-parallel ranks ``args`` asks for: ``--num-devices`` N
    (default: every visible card, one on the CPU), started here
    (``parallel.distributed.spawn``) or, with a cluster named by
    ``--coordinator`` / ``--num-processes`` / ``--process-id`` (or their
    environment), N / P of them on this host. A rank that fails ends the
    run with a nonzero exit."""
    device = resolve_device(args.device)
    n = args.num_devices
    if n is None:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n < 1:
        raise ValueError(f"--num-devices must be >= 1, got {n}")
    spec = pdist.cluster_spec(getattr(args, "coordinator", None),
                              getattr(args, "num_processes", None),
                              getattr(args, "process_id", None))
    if spec is None and n == 1:
        return _COMMANDS[command](args, device, None)
    if spec is None:
        init, local, first = f"tcp://127.0.0.1:{pdist.free_port()}", n, 0
    else:
        coordinator, nproc, pid = spec
        if n % nproc:
            raise ValueError(f"--num-devices {n} not divisible by {nproc} processes")
        init, local, first = f"tcp://{coordinator}", n // nproc, pid * (n // nproc)
        print(f"distributed: process {pid}/{nproc}, ranks {first}..{first + local - 1} "
              f"of {n}")
    if device.type == "cuda" and local > torch.cuda.device_count():
        raise ValueError(f"{local} ranks on this host, {torch.cuda.device_count()} cards")
    pdist.spawn(_rank_main, local, n, init, device.type, first, args=(args, command))
    return 0


def _rank_main(device, args, command: str) -> None:
    """One rank of :func:`_launch`: the command over the mesh of every
    rank; only the coordinator prints."""
    mesh = pmesh.make_mesh(num_slices=getattr(args, "num_slices", 1), device=device)
    if mesh.rank != 0:
        sys.stdout = open(os.devnull, "w")
    rc = _COMMANDS[command](args, device, mesh)
    sys.stdout.flush()
    if rc:
        raise SystemExit(rc)


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


def cmd_eval_depth(args) -> int:
    """Eigen-split depth metrics of a model, or of saved predictions
    (``--pred-path``: the metric pass alone, no model and no device)."""
    from depthvo_tpu_torch.eval.runner import run_depth_eval

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
        save_preds_dir=args.save_preds, model=model, num_devices=args.num_devices,
        median_scale=not args.no_median_scale, int8=args.int8, split_sha=args.split_sha,
    )
    if args.int8:
        metrics["split"]["int8"] = True
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
    if args.int8:
        # w8a8 serving: the inputs are the representative frames of a
        # directory sweep.
        model.calibrate_int8(frames[:max(bs, 32)])
        print("int8: calibrated; running the quantized program")
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


def cmd_export_serving(args) -> int:
    """Freeze the depth forward into one ``torch.export`` artifact, weights
    included (the deploy.prototxt + caffemodel analog), with a JSON
    sidecar; ``--int8-calib`` calibrates on a directory of frames first
    and exports the w8a8 program."""
    from depthvo_tpu_torch.io import serving

    model = _load_model(args)
    if args.int8_calib:
        mc = model.config.model
        paths = sorted(os.path.join(args.int8_calib, f) for f in os.listdir(args.int8_calib)
                       if f.lower().endswith((".png", ".jpg", ".jpeg")))
        if not paths:
            print(f"--int8-calib {args.int8_calib}: no images found")
            return 2
        # Every frame, 32 at a time (repeated calls keep the running max):
        # a prefix of the directory could be unrepresentative.
        for i in range(0, len(paths), 32):
            model.calibrate_int8(kitti.load_images_u8(paths[i:i + 32], mc.height, mc.width))
        print(f"int8: calibrated on {len(paths)} frames from {args.int8_calib}")
    sidecar = serving.export_depth(model, args.output, input_dtype=args.input_dtype,
                                   batch=args.batch, output=args.head)
    print(json.dumps(sidecar, indent=2))
    print(f"wrote {args.output} (+ .json sidecar)")
    return 0


def _host_state(cfg):
    """A fresh train state on the CPU, drawn from seed 0, and its
    flax-layout trees: the weight tools seat numpy arrays and need no GPU."""
    from depthvo_tpu_torch.io.to_flax_layout import to_flax_layout

    state = create_state(cfg, torch.device("cpu"), torch.Generator().manual_seed(0))
    return state, *to_flax_layout(state.models)


def _write_checkpoint(state, cfg, directory: str) -> None:
    ckpt_io.save(ckpt_io.make_manager(directory), state)
    config_base.save_json(cfg, os.path.join(directory, "config.json"))


def cmd_export_caffemodel(args) -> int:
    """A net's weights in the Caffe model-zoo format (the inverse of
    ``import-caffemodel``), so the reference's Caffe tooling can read
    models trained here. Runs on the host."""
    from depthvo_tpu_torch.io.export_weights import export_caffemodel
    from depthvo_tpu_torch.io.to_flax_layout import to_flax_layout

    args.device = "cpu"
    model = _load_model(args)
    params, stats = to_flax_layout(model.models)
    if args.net not in params:
        print(f"net '{args.net}' not in checkpoint (has: {sorted(params)})")
        return 2
    raw = export_caffemodel(params[args.net], batch_stats=stats if args.net == "depth" else None,
                            path=args.output, net_name=f"depthvo_tpu_{args.net}")
    print(f"wrote {args.output} ({len(raw)} bytes, net={args.net})")
    return 0


def cmd_import_caffemodel(args) -> int:
    """Seat a released ``.caffemodel`` into a fresh model of the variant and
    write a checkpoint that eval-depth, eval-odom and infer read. Nets of
    the variant other than ``--net`` keep their random weights (import
    each from its own file). Runs on the host."""
    from depthvo_tpu_torch.io import caffemodel, import_weights
    from depthvo_tpu_torch.io.from_jax import load_jax_params

    cfg = _make_config(args)
    state, params, stats = _host_state(cfg)
    if args.net not in params:
        print(f"net '{args.net}' not in variant '{cfg.name}' (has: {sorted(params)})")
        return 2
    layers = caffemodel.parse_caffemodel(args.caffemodel)
    name_map = bn_map = None
    if args.name_map:
        with open(args.name_map) as f:
            m = json.load(f)
        name_map = m.get("convs", m if "bns" not in m else None)
        bn_map = m.get("bns")
    mean = [float(x) for x in args.input_mean.split(",")] if args.input_mean else None
    if args.proto:
        # The companion prototxt: it must describe --net, and it gives the
        # data layer's preprocessing where the flags do not.
        from depthvo_tpu_torch.io import net_prototxt

        with open(args.proto) as f:
            facts = net_prototxt.extract_facts(net_prototxt.parse_prototxt(f.read()))
        want = {"depth": "depth", "odom": "odometry", "feat": "feature"}[args.net]
        if facts.kind not in (want, "train_graph"):
            print(f"--proto {args.proto} describes a {facts.kind} net, but --net "
                  f"{args.net} expects {want}; refusing (pass the matching prototxt "
                  "or drop --proto)")
            return 2
        if mean is None and facts.mean_values:
            mean = [float(v) for v in facts.mean_values]
            print(f"proto: transform_param mean_value -> {mean}")
        if args.input_scale == 1.0 and facts.scale is not None:
            args.input_scale = facts.scale
            print(f"proto: transform_param scale -> {args.input_scale}")
    net_params, net_stats, report = import_weights.import_net(
        layers, params[args.net], stats if args.net == "depth" else None,
        name_map=name_map, bn_name_map=bn_map, input_mean=mean,
        input_scale=args.input_scale, input_conv=args.input_conv, input_bn=args.input_bn,
        strict=not args.lenient,
    )
    params[args.net] = net_params
    load_jax_params(state.models, params, net_stats if args.net == "depth" else stats)
    print(import_weights.format_report(report))
    print(f"placed {len(report)} entries from {args.caffemodel} into net '{args.net}'")
    if args.checkpoint_dir:
        _write_checkpoint(state, cfg, args.checkpoint_dir)
        print(f"wrote checkpoint -> {args.checkpoint_dir}")
    return 0


def cmd_convert(args) -> int:
    """One-shot migration: a solver.prototxt (and its net graph) and
    ``.caffemodel`` files become an experiment directory: config.json,
    an audited name map per net, and a checkpoint with the weights seated
    (transform_param mean/scale folded into the input convs)."""
    from depthvo_tpu_torch.io import caffemodel, import_weights
    from depthvo_tpu_torch.io import name_map as nm
    from depthvo_tpu_torch.io.from_jax import load_jax_params
    from depthvo_tpu_torch.io.solver_prototxt import apply_solver_prototxt

    os.makedirs(args.output_dir, exist_ok=True)
    # 1. The net prototxt: an explicit --proto wins over the solver's net:.
    solver_text = None
    net_path = args.proto
    if args.proto and not os.path.isfile(args.proto):
        print(f"convert: --proto {args.proto} not found")
        return 2
    if args.solver:
        with open(args.solver) as f:
            solver_text = f.read()
        if net_path is None:
            net_path = _solver_net_path(args.solver, solver_text)
    over = {}
    if net_path and os.path.isfile(net_path):
        _, over = _recognize_net_file(net_path)
    elif net_path:
        print(f"convert: solver net file {net_path} not found; using flags")

    # 2. The config: the net's facts fill what the flags did not set.
    args.variant = args.variant or over.get("variant", "full_feat")
    if args.batch_size is None:
        args.batch_size = over.get("batch_size", 4)
    args.height = args.height or over.get("height")
    args.width = args.width or over.get("width")
    cfg = _make_config(args)
    loss_fields = {k: v for k, v in over.items() if k.endswith("_weight")}
    if loss_fields:
        cfg = dataclasses.replace(cfg, **loss_fields)
    eval_hint = ""
    if solver_text is not None:
        cfg, extras = apply_solver_prototxt(solver_text, cfg)
        print(f"solver: -> {cfg.optim.optimizer}, lr={cfg.optim.learning_rate}, "
              f"policy={cfg.optim.lr_policy}")
        ignored = [k for k in extras["ignored"] if k not in ("net", "train_net")]
        if ignored:
            print(f"solver: ignoring deploy-only fields {ignored}")
        if "eval_every" in extras:
            # test_interval/test_iter are fit() arguments: carried into the
            # suggested train command.
            eval_hint = f" --eval-every {extras['eval_every']}"
            if "eval_steps" in extras:
                eval_hint += f" --eval-steps {extras['eval_steps']}"
    config_path = os.path.join(args.output_dir, "config.json")
    config_base.save_json(cfg, config_path)
    print(f"wrote {config_path} (variant={cfg.name}, batch={cfg.batch_size}, "
          f"{cfg.model.height}x{cfg.model.width})")

    # 3. The weights, through generated (audited) name maps.
    state = create_state(cfg, torch.device("cpu"))
    from depthvo_tpu_torch.io.to_flax_layout import to_flax_layout

    params, stats = to_flax_layout(state.models)
    mean = over.get("input_mean")
    scale = over.get("input_scale", 1.0)
    if mean is None and scale != 1.0:
        mean = [0.0, 0.0, 0.0]
    had_problems = False
    for spec in args.weights or []:
        net, path = _weights_spec(spec)
        if net not in params:
            print(f"--weights net {net!r} not in variant {cfg.name!r} "
                  f"(has: {sorted(params)})")
            return 2
        layers = caffemodel.parse_caffemodel(path)
        net_stats = stats if net == "depth" else None
        m, entries, problems = nm.generate_name_map(layers, params[net], net_stats,
                                                    strict=False)
        map_path = os.path.join(args.output_dir, f"name_map_{net}.json")
        with open(map_path, "w") as f:
            json.dump(m, f, indent=2, sort_keys=True)
        print(f"\n{net}: {path}")
        print(nm.format_map_report(entries, problems))
        print(f"wrote {map_path}")
        if not m["convs"]:
            print(f"convert: NOTHING in {path} matches net {net!r} — wrong file? "
                  "(no checkpoint written)")
            return 2
        if problems:
            had_problems = True
            if not args.lenient:
                print(f"convert: {len(problems)} unmatched entries — refusing to write "
                      "a partially-random checkpoint (rerun with --lenient to seat "
                      "what matched; the map JSON above is written for review)")
                return 2
            print(f"convert: {len(problems)} unmatched entries — --lenient: seating "
                  "what matched; unmatched model params stay RANDOM")
        params[net], net_stats, report = import_weights.import_net(
            layers, params[net], net_stats, name_map=m["convs"],
            bn_name_map=m["bns"] or None, input_mean=mean, input_scale=scale,
            strict=not problems,
        )
        if net == "depth":
            stats = net_stats
        print(f"seated {len(report)} entries into net {net!r}"
              + (" (mean/scale folded)" if mean is not None else ""))
    load_jax_params(state.models, params, stats)
    ckpt_dir = os.path.join(args.output_dir, "checkpoint")
    _write_checkpoint(state, cfg, ckpt_dir)
    cli = "python -m depthvo_tpu_torch.cli"
    print(f"\nwrote {ckpt_dir}")
    print("next steps:")
    print(f"  train:      {cli} train --config {config_path} --init-from {ckpt_dir} "
          f"--checkpoint-dir <run_dir>{eval_hint}")
    print(f"  eval depth: {cli} eval-depth --checkpoint-dir {ckpt_dir} "
          "--kitti-root <raw> --split-file <eigen.txt>")
    print(f"  infer:      {cli} infer --checkpoint-dir {ckpt_dir} "
          "--images <dir> --output-dir <out>")
    # A lenient run with unmatched entries exits 1: `convert && train`
    # must not take a partial seat for a clean one.
    return 1 if had_problems else 0


def cmd_make_name_map(args) -> int:
    """The ``{caffe_layer -> flax path}`` map a released ``.caffemodel``
    needs for name-based import, with an audit report that flags every
    placement resting on the order within a shape class. The output feeds
    ``import-caffemodel --name-map``."""
    from depthvo_tpu_torch.io import caffemodel, name_map

    cfg = _make_config(args)
    _, params, stats = _host_state(cfg)
    if args.net not in params:
        print(f"net '{args.net}' not in variant '{cfg.name}' (has: {sorted(params)})")
        return 2
    layers = caffemodel.parse_caffemodel(args.caffemodel)
    facts = None
    if args.proto:
        from depthvo_tpu_torch.io import net_prototxt

        with open(args.proto) as f:
            facts = net_prototxt.extract_facts(net_prototxt.parse_prototxt(f.read()))
    try:
        map_json, entries, problems = name_map.generate_name_map(
            layers, params[args.net], stats if args.net == "depth" else None,
            proto_facts=facts, strict=not args.lenient,
        )
    except ValueError as e:
        print(e)
        return 2
    print(name_map.format_map_report(entries, problems))
    with open(args.output, "w") as f:
        json.dump(map_json, f, indent=2, sort_keys=True)
    print(f"wrote {args.output} ({len(map_json['convs'])} convs, "
          f"{len(map_json['bns'])} bns) — review the order-trusted rows, "
          "then: import-caffemodel --name-map " + args.output)
    return 0 if not problems else 1


def cmd_net_info(args) -> int:
    """Recognise a Caffe NetParameter prototxt: which of the three networks
    it is, its input geometry, preprocessing and loss weights, and the
    config overrides they map to (recognised, never executed)."""
    from depthvo_tpu_torch.io.net_prototxt import (
        config_overrides, extract_facts, format_report, parse_prototxt,
    )

    with open(args.prototxt) as f:
        facts = extract_facts(parse_prototxt(f.read()))
    over, notes = config_overrides(facts)
    print(format_report(facts, over))
    for n in notes:
        print(f"note: {n}")
    if args.json:
        blob = dataclasses.asdict(facts)
        blob["overrides"] = over
        with open(args.json, "w") as f:
            json.dump(blob, f, indent=2, default=str)
        print(f"wrote {args.json}")
    return 0 if facts.kind != "unknown" else 1


def cmd_zoo(args) -> int:
    """The released-model table, or the fidelity gate: an eval-depth or
    eval-odom JSON against a zoo row."""
    from depthvo_tpu_torch import zoo

    if args.check:
        with open(args.check) as f:
            measured = json.load(f)
        if "t_err_pct" in measured:  # eval-odom output
            report = zoo.check_odom_parity(
                measured, variant=args.variant_name,
                **({"rtol": args.rtol} if args.rtol is not None else {}))
        else:
            report = zoo.check_parity(measured, variant=args.variant_name, rtol=args.rtol,
                                      int8=args.int8, trust_split=args.trust_split)
        for row in report["rows"]:
            if row["status"] == "missing":
                print(f"{row['metric']:10s} MISSING from {args.check}")
            else:
                print(f"{row['metric']:10s} published={row['published']:<8g}"
                      f" measured={row['measured']:<8g}"
                      f" rel_err={row['rel_err']:.2%}  {row['status']}")
        if "warning" in report:
            print(f"WARNING: {report['warning']}")
        print(json.dumps(report))
        return 0 if report["parity"] else 1
    for name, entry in zoo.ZOO.items():
        mark = "~" if entry["approximate"] else " "
        print(f"{name:14s}{mark} {entry['title']}")
        print(f"{'':15s}nets: {', '.join(entry['nets'])}  (training stage "
              f"{entry['stage']}, variant {entry['train_variant']})")
        if entry["depth_metrics"]:
            print(f"{'':15s}depth: " + "  ".join(
                f"{k}={v:g}" for k, v in entry["depth_metrics"].items()))
        for seq, m in (entry["odom_metrics"] or {}).items():
            print(f"{'':15s}odom seq {seq}: t_err={m['t_err_pct']}%  "
                  f"r_err={m['r_err_deg_per_100m']}°/100m")
        for cmd in zoo.import_commands(name):
            print(f"{'':15s}$ {cmd}")
    print("\n~ = approximate reference row ([M]/[L] in BASELINE.md; check uses a "
          "widened tolerance)")
    print("weights ship from the reference README's links (the files are not in "
          "this repository)")
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
    scenes, with checkpoints and the staged recipe's init; over
    ``--num-devices`` ranks, data parallel."""
    return _launch(args, "train")


def _train(args, device, mesh) -> int:
    solver_text = None
    net_overrides = {}
    if args.solver:
        with open(args.solver) as f:
            solver_text = f.read()
        # The solver's net prototxt is recognised, not executed: it picks
        # the variant and gives batch, input size and loss weights, which
        # explicit flags still override.
        net_overrides = _apply_solver_net(args, solver_text)
    cfg = _make_config(args)
    if solver_text is not None:
        from depthvo_tpu_torch.io.solver_prototxt import apply_solver_prototxt

        cfg, extras = apply_solver_prototxt(solver_text, cfg)
        ignored = [k for k in extras["ignored"]
                   if k not in ("net", "train_net") or not net_overrides]
        if ignored:
            print(f"solver: ignoring deploy-only fields {ignored} from {args.solver}")
        if args.eval_every == 0 and "eval_every" in extras:
            args.eval_every = extras["eval_every"]
            args.eval_steps = extras.get("eval_steps", args.eval_steps)
        print(f"solver: {args.solver} -> {cfg.optim.optimizer}, "
              f"lr={cfg.optim.learning_rate}, policy={cfg.optim.lr_policy}")
        loss_fields = {k: v for k, v in net_overrides.items() if k.endswith("_weight")}
        if loss_fields:
            cfg = dataclasses.replace(cfg, **loss_fields)
            print(f"net: loss weights from the net prototxt: {loss_fields}")
    # Explicit flags win over the solver overlay, as in the reference;
    # before --weights makes its state, whose solver state iter_size shapes.
    if args.iter_size > 1:
        cfg = dataclasses.replace(
            cfg, optim=dataclasses.replace(cfg.optim, iter_size=args.iter_size))
    if args.remat:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=True))
    if args.log_every is not None:
        cfg = dataclasses.replace(cfg, log_every=args.log_every)
    if args.init_from:
        cfg = dataclasses.replace(cfg, init_from=args.init_from)
    if args.init_feat_from:
        cfg = dataclasses.replace(cfg, init_feat_from=args.init_feat_from)
    init_state = None
    if args.weights:
        if args.init_from:
            print("--weights and --init-from are exclusive: --weights seats a "
                  ".caffemodel, --init-from a checkpoint (run import-caffemodel "
                  "first to convert)")
            return 2
        mean = net_overrides.get("input_mean")
        scale = net_overrides.get("input_scale", 1.0)
        if mean is None and scale != 1.0:
            mean = [0.0, 0.0, 0.0]  # a scale-only transform_param
        if mean is not None:
            print(f"net: folding transform_param mean={mean} scale={scale} "
                  "into the imported input conv(s)")
        init_state = _state_with_caffe_weights(cfg, args.weights, device,
                                               input_mean=mean, input_scale=scale)
    if mesh is not None:
        print(f"mesh: {mesh.size} device(s) as {mesh.shape}; "
              f"backend={torch.distributed.get_backend(mesh.group)}")
    cfg = _round_batch(cfg, mesh)
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
    # The coordinator alone logs: the metrics are the global batch's on
    # every rank.
    log = (MetricLogger(jsonl_path=args.log_jsonl, tensorboard_dir=args.tensorboard)
           if mesh is None or mesh.rank == 0 else None)
    try:
        train_loop.fit(
            cfg, it, args.steps, mesh=mesh, checkpoint_dir=args.checkpoint_dir, log_fn=log,
            state=init_state, steps_per_call=args.steps_per_call,
            eval_iter=eval_it, eval_every=args.eval_every, eval_steps=args.eval_steps,
            sigint_effect=args.sigint_effect, sighup_effect=args.sighup_effect,
            device=device, debug_nans=args.debug_nans,
        )
    finally:
        if log is not None:
            log.close()
    return 0


def cmd_pretrain_feat(args) -> int:
    """Contrastive pretraining of the feature net (``train/feat_pretrain.py``),
    packaged as a whole train state whose ``feat`` network is the result:
    ``train --init-feat-from <dir>`` seats it."""
    from depthvo_tpu_torch.train.feat_pretrain import pretrain_features

    device = resolve_device(args.device)
    cfg = _make_config(args)
    if not cfg.use_feature:
        print(f"pretrain-feat: variant {args.variant!r} has no feature net; use full_feat")
        return 2
    h, w = cfg.model.height, cfg.model.width
    if args.train_list:
        ds = kitti.load_train_list(args.kitti_root or ".", args.train_list, h, w, u8=True)
        it = ds.iterator(cfg.batch_size, seed=cfg.seed)
        print(f"pretraining features on {len(ds)} frames from {args.train_list}")
    elif args.kitti_root:
        ds = kitti.KittiRawStereo(args.kitti_root, _split(args.drives), h, w, u8=True)
        it = ds.iterator(cfg.batch_size, seed=cfg.seed)
        print(f"pretraining features on {len(ds)} KITTI frames")
    else:
        print("no --kitti-root given: pretraining on synthetic scenes")
        it = SyntheticScenes(cfg, seed=cfg.seed, u8=True).iterator(cfg.batch_size)

    def log(step, loss):
        if step % max(1, args.steps // 20) == 0 or step == args.steps - 1:
            print(f"pretrain step {step}: infonce={loss:.5f}", flush=True)

    feat = pretrain_features(cfg, it, args.steps, log_fn=log, device=device)
    state = create_state(cfg, device)
    state.models.feat.load_state_dict(feat)
    directory = args.checkpoint_dir or "./feat_ckpt"
    ckpt_io.save(ckpt_io.make_manager(directory), state)
    print(f"saved pretrained features to {directory}")
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


def _add_parallel(p: argparse.ArgumentParser) -> None:
    p.add_argument("--num-devices", type=int, default=None,
                   help="data-parallel ranks, one process per device (default: every "
                        "visible card; 1 on the CPU, where N > 1 runs N gloo ranks)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="depthvo_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("train", help="staged training (reference: caffe train)")
    _add_common(p)
    # None = not given: a solver's net prototxt may then supply them; the
    # defaults --help shows are full_feat / 4.
    p.set_defaults(variant=None, batch_size=None)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--solver", default=None,
                   help="Caffe solver.prototxt overlaid on the config (the `caffe "
                        "train --solver=` migration path; its net: prototxt is "
                        "recognised, not executed)")
    p.add_argument("--weights", action="append", default=None,
                   metavar="[NET=]file.caffemodel",
                   help="seat released Caffe weights before training (caffe train "
                        "--weights; repeatable, NET in depth/odom/feat, default depth)")
    p.add_argument("--config", default=None,
                   help="experiment-config JSON (as train saves beside its checkpoints); "
                        "supersedes --variant/--height/--width/--batch-size")
    p.add_argument("--iter-size", type=int, default=1,
                   help="Caffe solver iter_size: accumulate gradients over "
                        "k micro-batches per optimizer update")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize DepthNet stages (memory-for-FLOPs; "
                        "raises the per-chip batch ceiling)")
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
    p.add_argument("--tensorboard", default=None,
                   help="also write TensorBoard scalar events here")
    p.add_argument("--debug-nans", action="store_true",
                   help="after each call of --steps-per-call steps (not per operation: "
                        "the step may be a CUDA graph), check that the call's loss "
                        "terms and every parameter and BatchNorm statistic are finite, "
                        "and raise FloatingPointError naming the step and the first "
                        "non-finite one before that state is logged or checkpointed")
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
    _add_parallel(p)
    p.add_argument("--num-slices", type=int, default=1,
                   help="mesh shape (dcn=S, data=N/S); the reduction spans every rank")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host launch: the rendezvous address (run the same command "
                        "on every host with its own --process-id; env DEPTHVO_COORDINATOR/"
                        "_NUM_PROCESSES/_PROCESS_ID work too)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host launch: the number of processes (hosts)")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-host launch: this process's index")
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
    _add_parallel(p)
    p.set_defaults(fn=cmd_test)

    p = sub.add_parser(
        "pretrain-feat",
        help="contrastive feature pretraining (replaces external NYUv2 weights)",
    )
    _add_common(p)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--kitti-root", default=None)
    p.add_argument("--drives", default="")
    p.add_argument("--train-list", default=None)
    p.set_defaults(fn=cmd_pretrain_feat)

    p = sub.add_parser("eval-depth", help="Eigen-split depth metrics")
    _add_common(p)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--num-devices", type=int, default=None,
                   help="split each batch over N replicas of the depth net in this "
                        "process (N cards; with --device cpu, N CPU replicas)")
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
                   help="w8a8 int8 serving: calibrate on the split's first frames, "
                        "then sweep the quantized program")
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
                   help="w8a8 int8 serving: calibrate on the inputs, then run the "
                        "quantized program")
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

    p = sub.add_parser("export-caffemodel",
                       help="write a net's weights as a Caffe .caffemodel (model zoo)")
    _add_common(p)
    p.add_argument("--net", default="depth", choices=["depth", "odom", "feat"])
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_export_caffemodel)

    p = sub.add_parser("import-caffemodel",
                       help="seat released Caffe weights into a checkpoint (fidelity gate)")
    _add_common(p)
    p.add_argument("--caffemodel", required=True)
    p.add_argument("--net", default="depth", choices=["depth", "odom", "feat"])
    p.add_argument("--name-map", default=None,
                   help="JSON {caffe_layer: flax.path} or {'convs': {...}, 'bns': {...}}")
    p.add_argument("--input-mean", default=None,
                   help="Caffe transform_param mean_value per channel, BGR order (e.g. "
                        "'104,116.7,122.7'); folds the data layer's preprocessing into "
                        "the input conv")
    p.add_argument("--input-scale", type=float, default=1.0,
                   help="Caffe transform_param scale (applied after mean)")
    p.add_argument("--input-conv", default=None,
                   help="dotted flax path of the input conv (default: auto)")
    p.add_argument("--input-bn", default=None,
                   help="dotted path of the BN absorbing the fold offset")
    p.add_argument("--lenient", action="store_true", help="don't fail on unmatched params")
    p.add_argument("--proto", default=None,
                   help="the weights' companion prototxt: checks it describes the --net "
                        "target and supplies transform_param mean/scale automatically")
    p.set_defaults(fn=cmd_import_caffemodel)

    p = sub.add_parser("convert",
                       help="one-shot migration: solver/net prototxts + .caffemodels -> "
                            "experiment dir (config.json, name maps, checkpoint)")
    _add_common(p)
    p.add_argument("--solver", default=None,
                   help="Caffe solver.prototxt (its net:/train_net: is followed)")
    p.add_argument("--proto", default=None,
                   help="net prototxt (overrides the solver's net: pointer)")
    p.add_argument("--weights", action="append", default=None,
                   metavar="[net=]file.caffemodel",
                   help="weights to seat (repeatable; default net 'depth')")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--lenient", action="store_true",
                   help="seat what matched when some entries are unmatched (exit 1) "
                        "instead of refusing (exit 2)")
    # None = not given: the net's facts may fill them (see train).
    p.set_defaults(fn=cmd_convert, variant=None, batch_size=None)

    p = sub.add_parser("make-name-map",
                       help="derive the name map a released .caffemodel needs for "
                            "name-based import (audit report + JSON for --name-map)")
    _add_common(p)
    p.add_argument("--caffemodel", required=True)
    p.add_argument("--net", default="depth", choices=["depth", "odom", "feat"])
    p.add_argument("--proto", default=None,
                   help="companion prototxt: cross-checks declared layers/num_output "
                        "against the weights file")
    p.add_argument("--output", default="name_map.json")
    p.add_argument("--lenient", action="store_true",
                   help="report unmatched entries instead of failing")
    p.set_defaults(fn=cmd_make_name_map)

    p = sub.add_parser("net-info",
                       help="recognize a Caffe net prototxt (kind, input dims, "
                            "preprocessing, loss weights -> config)")
    p.add_argument("prototxt")
    p.add_argument("--json", default=None, help="also write the facts + overrides as JSON")
    p.set_defaults(fn=cmd_net_info)

    p = sub.add_parser("zoo",
                       help="released-model table + fidelity-gate check (README model zoo)")
    p.add_argument("--check", default=None,
                   help="eval-depth JSON to compare against the zoo row")
    p.add_argument("--variant-name", default="full_nyuv2",
                   help="zoo row to list/check against")
    p.add_argument("--rtol", type=float, default=None,
                   help="override the gate tolerance (default: 1%% exact rows, 5%% "
                        "approximate rows)")
    p.add_argument("--int8", action="store_true",
                   help="gate an int8 (w8a8) serving run: requires the eval JSON to "
                        "declare quant=int8 (eval-depth --int8) and widens the tolerance "
                        "by the reference's declared serving budget (+3%% rel)")
    p.add_argument("--trust-split", action="store_true",
                   help="accept an unpinned canonical-split claim on operator trust: "
                        "the gate proceeds but the report records "
                        "split_trusted_unpinned and the split's sha256")
    p.set_defaults(fn=cmd_zoo)

    p = sub.add_parser(
        "export-serving",
        help="freeze the depth net into one torch.export artifact (weights "
             "included, cpu or cuda, any batch size)",
    )
    _add_common(p)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the device the program is traced on (it loads on either)")
    p.add_argument("--output", required=True,
                   help="artifact path (a .json input-spec sidecar lands next to it)")
    p.add_argument("--input-dtype", default="uint8", choices=["uint8", "float32"])
    p.add_argument("--batch", type=int, default=None,
                   help="concrete batch size (default: symbolic, one artifact "
                        "serves every batch size)")
    p.add_argument("--head", default="depth", choices=["depth", "disparity"])
    p.add_argument("--int8-calib", default=None,
                   help="directory of representative frames: calibrate and export "
                        "the w8a8 int8 program instead of bf16/f32")
    p.set_defaults(fn=cmd_export_serving)

    p = sub.add_parser("device-query",
                       help="the CUDA devices and their memory (reference: caffe device_query)")
    p.set_defaults(fn=cmd_device_query)

    p = sub.add_parser("bench", help="throughput benchmark (reference: caffe time)")
    _add_common(p)
    p.add_argument("--mode", default="depth_infer",
                   choices=["depth_infer", "train_step", "train_step_scan", "odom_infer",
                            "warp", *_LAYER_MODES])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler Chrome trace (trace.json) here")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize DepthNet stages (memory-for-FLOPs; "
                        "raises the per-chip batch ceiling)")
    p.add_argument("--int8", action="store_true",
                   help="depth_infer only: the w8a8 int8 serving path (calibrates on "
                        "the benchmark batch)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.set_defaults(fn=cmd_bench)
    return parser


def cmd_device_query(args) -> int:
    """`caffe device_query` analog: each CUDA device's name, capability,
    SM count and memory, the caching allocator's allocated, reserved and
    peak bytes on it, and this process's rank and world size; the same as
    one JSON line. Without a CUDA device it says so and returns 1."""
    if not torch.cuda.is_available():
        print("device-query: no CUDA device is available")
        return 1
    n = torch.cuda.device_count()
    rank, world = pdist.process_index(), pdist.process_count()
    print(f"backend: cuda  devices: {n}  process: {rank}/{world}  "
          f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    devices = []
    for i in range(n):
        prop = torch.cuda.get_device_properties(i)
        d = {"index": i, "name": prop.name, "capability": [prop.major, prop.minor],
             "sm_count": prop.multi_processor_count, "total_memory": prop.total_memory,
             "allocated": torch.cuda.memory_allocated(i),
             "reserved": torch.cuda.memory_reserved(i),
             "peak_allocated": torch.cuda.max_memory_allocated(i)}
        devices.append(d)
        print(f"[{i}] {d['name']} (capability {prop.major}.{prop.minor}, "
              f"{d['sm_count']} SMs, {d['total_memory'] / 2**30:.2f} GiB)")
        print(f"     allocated {d['allocated'] / 2**30:.3f} GiB, reserved "
              f"{d['reserved'] / 2**30:.3f} GiB, peak {d['peak_allocated'] / 2**30:.3f} GiB")
    print(json.dumps({"devices": devices, "rank": rank, "world_size": world}))
    return 0


_LAYER_MODES = ("depth_layers", "odom_layers", "feat_layers")


def cmd_bench(args) -> int:
    """`caffe time` analog: the throughput of a hot path
    (``utils.profiling.run_benchmark``) or a network's per-layer forward
    and backward table (``--mode *_layers``), as one JSON line."""
    from depthvo_tpu_torch.utils.profiling import depth_layer_table, maybe_trace, run_benchmark

    if args.mode in _LAYER_MODES:
        with maybe_trace(args.trace_dir):
            result = depth_layer_table(
                batch_size=args.batch_size, height=args.height or 160,
                width=args.width or 608, steps=args.steps, variant=args.variant,
                net=args.mode.split("_")[0], device=args.device)
        print(f"{'layer':16s} {'forward':>10s} {'backward':>10s}"
              f" {'fwd cum':>10s} {'bwd cum':>10s}")
        for row in result["rows"]:
            bwd = row.get("backward_ms")
            bwd_c = row.get("bwd_cumulative_ms")
            print(f"{row['layer']:16s} {row['forward_ms']:8.3f} ms"
                  f" {bwd if bwd is not None else float('nan'):8.3f} ms"
                  f" {row['fwd_cumulative_ms']:10.3f}"
                  f" {bwd_c if bwd_c is not None else float('nan'):10.3f}")
        print(json.dumps(result))
        return 0
    if args.int8 and args.mode != "depth_infer":
        print(f"--int8 applies to --mode depth_infer only (got {args.mode}); refusing "
              "to print an f32 number under an int8 flag")
        return 2
    result = run_benchmark(
        mode=args.mode, batch_size=args.batch_size, height=args.height or 160,
        width=args.width or 608, steps=args.steps, trace_dir=args.trace_dir,
        variant=args.variant, remat=args.remat, int8=args.int8, device=args.device)
    print(json.dumps(result))
    return 0


_COMMANDS = {"train": _train, "test": _test}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
