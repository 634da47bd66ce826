"""The single uint8 <-> [-1, 1] formula (counterpart of
``depthvo_tpu/utils/images.py``).

Raw uint8 frames cross the host->device link at 4x fewer bytes and are
normalized on the device with exactly the host loaders' formula
``x / 127.5 - 1``.
"""

from __future__ import annotations

import torch


def to_unit(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float32 from either pre-normalized floats or raw uint8.

    The divisor is a tensor: CUDA divides by a Python number as a product
    with its reciprocal, which is off by one bit for about half of the
    256 codes, and the devices would then disagree in the last bit."""
    if images.dtype == torch.uint8:
        x = images.float()
        return x / torch.full_like(x, 127.5) - 1.0
    return images.float()
