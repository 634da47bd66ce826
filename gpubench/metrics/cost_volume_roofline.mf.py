"""The cost volume's byte bound per step (gpubench/mf_roofline.py) at the
HBM peak, over the traced device time of the kernels whose names contain
``cost_volume``, in percent."""

from gpubench.mf_readers import cost_volume_roofline as read  # noqa: F401
