"""The ManyDepth step's border warps' byte bound per step
(gpubench/mf_roofline.py: both depth nets) at the HBM peak, over the traced
device time of the kernels whose names contain ``border``, in percent."""

from gpubench.mf_readers import border_roofline as read  # noqa: F401
