"""Losses of the port (counterpart of ``depthvo_tpu.losses``)."""

from depthvo_tpu_torch.losses.photometric import (  # noqa: F401
    masked_l1,
    masked_l1_chw,
    photometric_loss,
    photometric_loss_chw,
    ssim,
    ssim_chw,
)
from depthvo_tpu_torch.losses.smoothness import smoothness_loss  # noqa: F401
