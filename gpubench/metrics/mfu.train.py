"""The window's convolution and matmul FLOPs (counted once from the
reference networks' shapes) per second, over the device's bf16 dense peak."""

from gpubench.readers import mfu as read  # noqa: F401
