"""The byte bounds of the ManyDepth step's own kernels.

The cost volume (``cost_volume``):
the current and the lookup feature maps (B, 64, H/4, W/4) read once in
the configuration's compute dtype, and the volume (B, D, H/4, W/4), the
confidence and the lowest cost (B, H/4, W/4) written once in float32:

    B (H/4) (W/4) (2 * 64 * e + 4 D + 8),  e = 2 (bfloat16) or 4 (float32)

one launch a step. The count is the bound's, whatever the kernel reads
again (the rays, the poses, the bins, a corner shared by two samples).

The border warps (``gen_fwd_border``, ``gen_bwd_uv_border``): each warp
as ``gpubench/md2_roofline.py`` counts it, for both depth nets (the
multi-frame net and the teacher), each warping frames -1 and +1 at every
scale: 2 x 2 x ``num_scales`` warps each way, 16 at 4 scales.
"""

from __future__ import annotations

from gpubench import md2_roofline

CHANNELS = 64  # ResNet18's layer1 width
DEPTH_BINS = 96
MATCHING_SCALE = 2


def cost_volume_bytes_per_step(config: dict) -> int:
    m = config["model"]
    pixels = (config["batch_size"] * (m["height"] >> MATCHING_SCALE)
              * (m["width"] >> MATCHING_SCALE))
    e = 2 if m["compute_dtype"] == "bfloat16" else 4
    return pixels * (2 * CHANNELS * e + 4 * DEPTH_BINS + 8)


DEPTH_NETS = 2  # the multi-frame net and the teacher


def warps_per_step(config: dict) -> int:
    return DEPTH_NETS * md2_roofline.warps_per_step(config)


def border_bytes_per_step(config: dict) -> int:
    return DEPTH_NETS * md2_roofline.border_bytes_per_step(config)
