"""Operations of one ManyDepth train step, counted from the reference
networks' shapes (``gpubench/reference/manydepth.py``).

``torch.utils.flop_counter.FlopCounterMode`` runs, on meta tensors (no
data, no device): the multi-frame net (its stem on frame 0, the lookup
stem without gradients, ``reduce_conv`` on the stem's features and the
cost volume's shape, ``layer2``-``layer4`` and the decoder), the teacher,
and the pose net on its two frame pairs with gradients and on the
matching pair without; then the backward of every output with gradients
(each convolution's input and weight gradients where autograd needs
them). The count is the algorithm's, whatever implements a layer in the
system; it leaves out the cost volume (no multiply-adds), the warps,
losses, BatchNorm and solver.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench import mf_weights
from gpubench.reference import manydepth as mf
from gpubench.reference import monodepth2 as md2


def train_step(config: dict) -> int:
    """FLOPs of one train step at the configuration's batch and size."""
    m = config["model"]
    scales = range(m["num_scales"])
    p = {name: torch.zeros(shape, device="meta", requires_grad=kind in mf.TRAINABLE_KINDS)
         for name, shape, kind in mf_weights.specs(config) if kind != "tracker"}
    stats = {k: v.detach() for k, v in p.items() if k.endswith(("running_mean", "running_var"))}
    B, H, W = config["batch_size"], m["height"], m["width"]
    x = torch.zeros((B, 3, H, W), device="meta")
    with FlopCounterMode(display=False) as counter:
        feats = mf.feature_extraction(p, dict(stats), "depth.encoder.", x, True, True)
        with torch.no_grad():
            mf.feature_extraction(p, dict(stats), "depth.encoder.", x, True)
        h, w = feats[-1].shape[-2:]
        volume = torch.zeros((B, mf.NUM_DEPTH_BINS, h, w), device="meta")
        y = torch.relu(md2.conv(torch.cat([feats[-1], volume], 1), p,
                                "depth.encoder.reduce_conv.0", 1, 1))
        for layer in (2, 3, 4):
            for j in range(2):
                y = md2.basic_block(y, p, dict(stats), f"depth.encoder.layer{layer}.{j}",
                                    2 if j == 0 else 1, True)
            feats.append(y)
        out = sum(d.sum() for d in md2.depth_decoder(p, "depth.decoder.", feats,
                                                     scales).values())
        t = md2.resnet_encoder(p, dict(stats), "teacher.encoder.encoder.", x, True)
        out = out + sum(d.sum() for d in md2.depth_decoder(p, "teacher.decoder.", t,
                                                           scales).values())
        pair = torch.cat([x, x], 1)
        for grad in (True, True, False):  # pairs (-1, 0), (0, +1); the matching (-1, 0)
            with torch.set_grad_enabled(grad):
                f = md2.resnet_encoder(p, dict(stats), "odom.encoder.encoder.", pair, True)
                axisangle, translation = md2.pose_decoder(p, "odom.decoder.", [f])
            if grad:
                out = out + axisangle.sum() + translation.sum()
        out.backward()
    return int(counter.get_total_flops())
