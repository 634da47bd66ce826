"""Losses of the port (counterpart of ``depthvo_tpu.losses``)."""

from depthvo_tpu_torch.losses.photometric import (  # noqa: F401
    masked_l1_chw,
    photometric_loss_chw,
    ssim_chw,
)
from depthvo_tpu_torch.losses.smoothness import smoothness_loss  # noqa: F401
