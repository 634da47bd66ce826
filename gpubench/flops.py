"""Operations of one train step, counted from the reference networks'
shapes.

``torch.utils.flop_counter.FlopCounterMode`` runs the reference's nets on
meta tensors (no data, no device) and counts the convolutions and matrix
products, forward and backward (each convolution's input and weight
gradients where autograd needs them). The count is the
algorithm's, whatever implements a layer in the system, and it leaves out
the warps, losses, BatchNorm and solver, whose work is not multiply-adds.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench.reference import nets


def _meta_params(config: dict, trainable: bool):
    names = set(nets.trainable(config))
    return {name: torch.zeros(shape, device="meta",
                              requires_grad=trainable and name in names)
            for name, shape, _ in nets.specs(config)}


def train_step(config: dict) -> int:
    """FLOPs of one train step at the configuration's batch and size."""
    m = config["model"]
    p = _meta_params(config, True)
    x = torch.zeros((config["batch_size"], m["height"], m["width"], 3), device="meta")
    with FlopCounterMode(display=False) as counter:
        disps = nets.depth_net(p, x, m, True, dict(p))
        out = sum(d.sum() for d in disps)
        if config["use_temporal"]:
            out = out + nets.odom_net(p, torch.cat([x, x], dim=-1)).sum()
        if config["use_feature"]:
            with torch.no_grad():
                for _ in range(2):  # target and source frames
                    nets.feat_net(p, x.permute(0, 3, 1, 2))
        out.backward()
    return int(counter.get_total_flops())

