"""Geometry core of the port: SE(3), pinhole camera, inverse warp."""

from depthvo_tpu_torch.geometry import camera, se3, warp  # noqa: F401
