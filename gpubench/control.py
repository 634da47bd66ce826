"""The readings that the limits of ``correct`` are set from: the control,
sound runs of the system, and a run with its timed path broken.

    python3 gpubench/control.py --workload full_feat.train_graph --side control --seeds 11 12 13

``--side control`` puts the reference in the system's place, computed in
the precision below the configuration's bfloat16 (float8 e4m3,
``reference/precision.py``), on the cell's own inputs and sizes: it has to
come out not correct. ``--side program`` reads a sound run of the system
(the cell's own set-up and checked steps, a one-second window); a side
named in ``FAULTS`` reads the same run with that fault planted under the
timed path, which some number has to catch. Each prints one JSON line per
seed: the cell's numbers beside its limits, ``correct``, and ``detail``:
the total loss's gap alone and each leaf-norm number by its median,
90th-percentile and worst leaf, which chose the leaf that is compared.
The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpubench import compare, run, spec, train_cell, weights  # noqa: E402
from gpubench.reference import train as reference  # noqa: E402


class _Frames:
    """The rows of a KITTI drive in the seed's shuffled sample order,
    decoded and resized by the reference."""

    def __init__(self, config, traffic, seed):
        h, w = config["model"]["height"], config["model"]["width"]
        frames = train_cell.kitti_frames(train_cell.kitti_drive(config, traffic), h, w)
        K, baseline = train_cell.kitti_camera(h, w)
        order = np.random.default_rng(seed).permutation(traffic["frames"] - 1)
        b = config["batch_size"]
        self.batches = []
        for j in range(len(order) // b):
            rows = order[j * b:(j + 1) * b]
            self.batches.append({
                "image_t": frames["image_02"][rows], "image_r": frames["image_03"][rows],
                "image_s": frames["image_02"][rows + 1], "K": np.stack([K] * b),
                "baseline": np.full(b, baseline, np.float32)})

    def reference_batch(self, j):
        return self.batches[j % len(self.batches)]


def numbers(cell, seed: int, dev: torch.device, detail: dict | None = None) -> dict:
    """The control's numbers on ``seed`` in ``cell``."""
    config = spec.experiment(cell.config)
    traffic = cell.traffic
    source = (train_cell.Pool(config, traffic, seed) if traffic["source"] == "pool"
              else _Frames(config, traffic, seed))
    params = weights.make(config, seed, dev)
    checked = traffic["checked_steps"]
    ctl = reference.Trainer(config, params, "fp8")
    losses = {}
    for j in range(checked[-1]):
        batch = {k: torch.as_tensor(np.ascontiguousarray(v)).to(dev)
                 for k, v in source.reference_batch(j).items()}
        losses[j + 1] = ctl.step(batch)
    change = {k: (ctl.p[k] - params[k]).cpu() for k in ctl.names}
    bn = {k: (v - params[k]).cpu() for k, v in ctl.stats.items()}
    first = {k: g.cpu() for k, g in ctl.first_grads.items()}
    del ctl
    return train_cell.reference_numbers(config, params, source, checked, losses, first, change,
                                        bn, dev, detail)


def state_unchanged():
    """Each train step returns the state it was given."""
    from depthvo_tpu_torch.train import loop

    body = loop._train_body

    def frozen(config, tx, state, batch, hyper, reduce=None):
        saved = [t.detach().clone() for t in loop._state_tensors(state)]
        metrics = body(config, tx, state, batch, hyper, reduce)
        with torch.no_grad():
            for t, s in zip(loop._state_tensors(state), saved):
                t.copy_(s)
        return metrics

    return loop, "_train_body", frozen


def half_batch():
    """Half of each batch's rows left out of the loss (the mean taken over
    the rest)."""
    from depthvo_tpu_torch.train import loop

    compute_losses = loop.compute_losses

    def half(config, models, batch, train=False, mesh=None):
        rows = next(iter(batch.values())).shape[0] // 2
        return compute_losses(config, models, {k: v[:rows] for k, v in batch.items()}, train,
                              mesh)

    return loop, "compute_losses", half


def frames_flipped():
    """Every frame the native ring decodes comes out upside down."""
    from depthvo_tpu_torch.data import native_loader

    nxt = native_loader.NativeBatchLoader.next

    def flipped(self):
        imgs, idx = nxt(self)
        return np.ascontiguousarray(imgs[:, ::-1]), idx

    return native_loader.NativeBatchLoader, "next", flipped


# Faults planted under the timed path: (owner, attribute, replacement).
FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "frames_flipped": frames_flipped}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("control", "program", *FAULTS), default="control")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if args.side in FAULTS:
        setattr(*FAULTS[args.side]())
    for seed in args.seeds:
        detail: dict = {}
        if args.side == "control":
            got, failed = numbers(cell, seed, dev, detail), 0
        else:  # the system's own run, with a one-second window
            out = run.run_cell(cell, seed, 1.0, False, dev, time.perf_counter())
            got, failed = out["numbers"], out["failed"]
            detail.update(out["detail"])
        correct = failed == 0 and compare.judge(
            got, {k: v for k, v in cell.limits.items() if k in got})
        print(json.dumps({"workload": cell.name, "side": args.side, "seed": seed,
                          "correct": correct, "numbers": got, "limits": cell.limits,
                          "detail": detail}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
