"""The warp kernels' byte bound per step (gpubench/roofline.py) at the HBM
peak, over their measured device time, in percent."""

from gpubench.readers import warp_roofline as read  # noqa: F401
