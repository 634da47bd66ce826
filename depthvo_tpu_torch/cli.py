"""Command line of the port (counterpart of ``depthvo_tpu/cli.py``).

Two subcommands are ported so far, both on synthetic scenes::

    python -m depthvo_tpu_torch.cli train --variant full_feat --steps 1000 \\
        [--batch-size 4] [--seed 0] [--device cuda|cpu] [--log-every N] \\
        [--eval-every N --eval-steps 10]
    python -m depthvo_tpu_torch.cli test --variant full_feat --iterations 10 \\
        [--batch-size 4] [--device cuda|cpu]

``train`` (the ``caffe train`` analog, the reference's synthetic branch)
runs ``fit`` from random weights drawn from ``--seed`` and prints the
loss terms as ``step N: k=v ...`` lines, every ``--log-every`` steps
(the config's ``log_every`` by default) and after the last, with the
held-out ``val/...`` terms every ``--eval-every`` steps. ``test`` averages
the eval-mode loss graph over held-out synthetic batches (the ``caffe
test`` analog) and prints the same ``val/...`` JSON as the reference's
``test``. Checkpoints come with a later slice. Both run on the GPU and
refuse to run without one unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from depthvo_tpu_torch import configs
from depthvo_tpu_torch.data.synthetic import SyntheticScenes
from depthvo_tpu_torch.train import loop as train_loop
from depthvo_tpu_torch.train.state import build_models, init_params, load_params
from depthvo_tpu_torch.utils.device import resolve_device
from depthvo_tpu_torch.utils.logging import MetricLogger

VARIANTS = ["stereo", "temporal_stereo", "full_feat", "tiny_test"]


def cmd_test(args) -> int:
    """`caffe test` analog: average the eval-mode loss over N held-out
    batches."""
    device = resolve_device(args.device)
    cfg = getattr(configs, args.variant)(batch_size=args.batch_size)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed))
    models = load_params(build_models(cfg), params, device)
    it = SyntheticScenes(cfg, seed=cfg.seed + 1_000_003, u8=True).iterator(
        cfg.batch_size
    )
    print("test phase: held-out synthetic scenes")
    eval_fn = train_loop.make_eval_step(cfg, device=device)
    metrics = train_loop.run_validation(eval_fn, models, it, args.iterations)
    print(json.dumps(metrics, indent=2))
    return 0


def cmd_train(args) -> int:
    """`caffe train` analog on synthetic scenes (the reference's branch
    without --kitti-root): random weights from --seed, then ``fit``."""
    device = resolve_device(args.device)
    cfg = getattr(configs, args.variant)(batch_size=args.batch_size, seed=args.seed)
    if args.log_every is not None:
        cfg = dataclasses.replace(cfg, log_every=args.log_every)
    print("no --kitti-root given: training on synthetic scenes")
    it = SyntheticScenes(cfg, seed=cfg.seed, u8=True).iterator(cfg.batch_size)
    eval_it = None
    if args.eval_every > 0:
        # Held-out synthetic scenes (disjoint seed from training).
        eval_it = SyntheticScenes(cfg, seed=cfg.seed + 1_000_003, u8=True).iterator(
            cfg.batch_size
        )
        print(f"validation: held-out synthetic scenes every {args.eval_every} steps")
    train_loop.fit(
        cfg, it, args.steps, device=device, log_fn=MetricLogger(),
        eval_iter=eval_it, eval_every=args.eval_every, eval_steps=args.eval_steps,
        # Caffe's defaults: SIGINT stops after the step, SIGHUP asks for a
        # snapshot.
        sigint_effect="stop", sighup_effect="snapshot",
    )
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="depthvo_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser(
        "train",
        help="train on synthetic scenes from random weights (reference: caffe train)",
    )
    p.add_argument("--variant", default="full_feat", choices=VARIANTS)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights and of the scenes")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--log-every", type=int, default=None,
                   help="print the loss terms every N steps (default: the config's)")
    p.add_argument("--eval-every", type=int, default=0,
                   help="validate every N steps (caffe test_interval; 0 = never)")
    p.add_argument("--eval-steps", type=int, default=10,
                   help="held-out batches per validation (caffe test_iter)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser(
        "test",
        help="average the loss over held-out batches (reference: caffe test)",
    )
    p.add_argument("--variant", default="full_feat", choices=VARIANTS)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--iterations", type=int, default=10,
                   help="held-out batches to average (caffe test -iterations)")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.set_defaults(fn=cmd_test)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
