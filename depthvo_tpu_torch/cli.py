"""Command line of the port (counterpart of ``depthvo_tpu/cli.py``).

Only the ``test`` subcommand is ported so far::

    python -m depthvo_tpu_torch.cli test --variant full_feat --iterations 10 \\
        [--batch-size 4] [--device cuda|cpu]

It averages the eval-mode loss graph over held-out synthetic batches
(the ``caffe test`` analog) and prints the same ``val/...`` JSON as the
reference's ``test``. Weights are random from ``--seed``; checkpoint
loading comes with a later slice. It runs on the GPU and refuses to run
without one unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from depthvo_tpu_torch import configs
from depthvo_tpu_torch.data.synthetic import SyntheticScenes
from depthvo_tpu_torch.train import loop as train_loop
from depthvo_tpu_torch.train.state import build_models, init_params, load_params
from depthvo_tpu_torch.utils.device import resolve_device

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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="depthvo_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
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
