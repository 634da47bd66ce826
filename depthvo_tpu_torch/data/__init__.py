"""Data subsystem of the port (counterpart of ``depthvo_tpu.data``):
synthetic scenes, the KITTI readers (``kitti``, ``eigen``), the native
decode ring (``native_loader``) and the host->device pipeline
(``pipeline``)."""

from depthvo_tpu_torch.data.pipeline import prefetch_to_device, batch_iterator  # noqa: F401
from depthvo_tpu_torch.data.synthetic import SyntheticScenes  # noqa: F401
