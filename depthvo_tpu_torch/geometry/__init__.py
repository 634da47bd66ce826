"""Geometry core of the port: SE(3), pinhole camera, inverse warp
(counterpart of ``depthvo_tpu.geometry``; float32 throughout)."""

from depthvo_tpu_torch.geometry import camera, se3, warp  # noqa: F401
from depthvo_tpu_torch.geometry.se3 import (  # noqa: F401
    exp,
    log,
    compose,
    inverse,
    hat,
    vee,
)
from depthvo_tpu_torch.geometry.camera import (  # noqa: F401
    pixel_grid,
    backproject,
    project,
    scale_intrinsics,
    intrinsics_matrix,
)
from depthvo_tpu_torch.geometry.warp import (  # noqa: F401
    bilinear_sample,
    inverse_warp,
    warp_coords,
)
