"""The readings that the ManyDepth cell's limits are set from, as
``gpubench/md2_control.py`` takes them for cell A: the control, sound
runs of the system, and runs with its timed path broken.

    python3 gpubench/mf_control.py --workload manydepth_1024x320.train_graph_mf \\
        --side control --seeds 11 12 13

``--side control`` puts the plain ManyDepth (``reference/manydepth.py``)
in the system's place, computed in the precision below the
configuration's bfloat16 (float8 e4m3, ``reference/precision.py``), on the
cell's own rows, weights and checked steps, and its matching layer on the
state it reached (``match``: its features in float8 against the same
layer from float32 features): it has to come out not correct. ``--side
noise`` puts the plain ManyDepth in float32 there, with the teacher's
tie-breaking noise drawn from another seed. ``--side program`` reads a
sound run of the system (the cell's set-up and checked steps, a
one-second window), in ``--compute-dtype`` if given instead of the
configuration's; a side named in ``control.FAULTS`` (``half_batch``,
``state_unchanged``) or in :data:`FAULTS` (``no_cost_volume``,
``bins_shifted``) reads the same run with that fault planted under the
timed path. Each prints one JSON line per seed: the numbers beside the
limits, ``correct`` and ``detail`` (every loss term's gap on the same
weights at the first two checked steps and along the trajectories, each
part of ``match``, the reference's shares and trackers, each leaf-norm
number's median, 90th-percentile and worst leaf, the first gradient's
sign flips, and set-up's parts). The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpubench import compare, control, mf_weights, spec  # noqa: E402
from gpubench import train_mf_cell  # noqa: E402
from gpubench.reference import manydepth as mf  # noqa: E402
from gpubench.reference import monodepth2 as md2  # noqa: E402


def no_cost_volume():
    """The cost volume's launch writes nothing: the volume, the confidence
    and the lowest cost stay zero."""
    from depthvo_tpu_torch.ops import cost_volume as cv

    def nothing(cur, look, rays, P, bins, valid):
        B, _, h, w = cur.shape
        zeros = [torch.zeros(shape, dtype=torch.float32, device=cur.device)
                 for shape in ((B, bins.numel(), h, w), (B, h, w), (B, h, w))]
        return tuple(zeros)

    return cv, "cost_volume", nothing


def bins_shifted():
    """The depth bins one bin deeper than the trackers place them."""
    from depthvo_tpu_torch.models import manydepth

    bins = manydepth.ResnetEncoderMatching.depth_bins

    def shifted(self):
        b = bins(self)
        return b + (b[1] - b[0])

    return manydepth.ResnetEncoderMatching, "depth_bins", shifted


# Faults of the matching layer planted under the timed path: (owner,
# attribute, replacement), as ``control.FAULTS``.
FAULTS = {"no_cost_volume": no_cost_volume, "bins_shifted": bins_shifted}


def matching_pose(p, stats, batch, precision: str) -> torch.Tensor:
    """The reference's matching pose (B, 4, 4) in ``precision``, before the
    rows' augmentations (the statistics are not moved)."""
    inputs = {("color", f, 0): md2.to_color(batch[mf.FRAME_KEYS[f]]) for f in mf.FRAME_IDS}
    stats = {k: v.clone() for k, v in stats.items()}
    md2._PRECISION[0] = precision
    try:
        mf.predict_poses(p, stats, inputs, {}, True)
    finally:
        md2._PRECISION[0] = "float32"
    return inputs[("relative_pose", -1)]


def control_numbers(cell, seed: int, dev: torch.device, detail: dict,
                    precision: str = "fp8") -> dict:
    """The numbers on ``seed`` of the reference in ``precision`` (the
    float8 control, or float32 with other noise) against the reference in
    float32, on the same rows and weights; ``match`` on the state the
    control reached, its pose given to both sides."""
    config = spec.experiment(cell.config)
    traffic = cell.traffic
    source = train_mf_cell.Pool(config, traffic, seed, dev)
    params = mf_weights.make(config, seed, dev)
    checked = traffic["checked_steps"]
    ctl = mf.Trainer(config, params, precision, noise_seed=seed + 1)
    losses, after_first = {}, {}
    for j in range(checked[-1]):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in source.reference_batch(j).items()}
        losses[j + 1] = {k: v for k, v in ctl.step(batch).items() if k.startswith("loss/")}
        if j + 1 == checked[0]:
            after_first = {k: v.detach().clone() for k, v in {**ctl.p, **ctl.stats}.items()}
            after_first.update({f"depth.encoder.{k}_depth_bin": torch.tensor(
                v, dtype=torch.float64) for k, v in ctl.trackers.items()})
    change = {k: (ctl.p[k] - params[k]).cpu() for k in ctl.names}
    bn = {k: (v - params[k]).cpu() for k, v in ctl.stats.items()}
    first = {k: g.cpu() for k, g in ctl.first_grads.items()}
    batch = {k: torch.as_tensor(v).to(dev) for k, v in source.reference_batch(0).items()}
    with train_mf_cell.float32_only(), torch.no_grad():
        T = matching_pose(ctl.p, ctl.stats, batch, precision)
        match = train_mf_cell.matching_gaps(
            train_mf_cell.reference_matching(ctl.p, ctl.stats, ctl.trackers, batch, T, precision),
            train_mf_cell.reference_matching(ctl.p, ctl.stats, ctl.trackers, batch, T))
    del ctl
    numbers = train_mf_cell.reference_numbers(config, params, source, checked, losses, first,
                                              change, bn, dev, seed, detail,
                                              after_first=after_first)
    detail["match"] = match
    return dict(numbers, match=max(match.values()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("control", "noise", "program", *control.FAULTS, *FAULTS),
                    default="control")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--compute-dtype", choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if args.compute_dtype:
        cell = cell._replace(config=dict(cell.config, model=dict(
            cell.config["model"], compute_dtype=args.compute_dtype)))
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    faults = {**control.FAULTS, **FAULTS}
    if args.side in faults:
        setattr(*faults[args.side]())
    for seed in args.seeds:
        detail: dict = {}
        if args.side in ("control", "noise"):
            precision = "fp8" if args.side == "control" else "float32"
            got, failed = control_numbers(cell, seed, dev, detail, precision), 0
        else:  # the system's own run, with a one-second window
            out = train_mf_cell.run(cell, seed, 1.0, False, dev, time.perf_counter())
            got, failed = out["numbers"], out["failed"]
            detail.update(out["detail"])
        correct = failed == 0 and compare.judge(got, cell.limits)
        print(json.dumps({"workload": cell.name, "side": args.side, "seed": seed,
                          "compute_dtype": cell.config["model"]["compute_dtype"],
                          "correct": correct, "numbers": got, "limits": cell.limits,
                          "detail": detail}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
