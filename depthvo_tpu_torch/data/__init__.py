"""Data subsystem of the port (counterpart of ``depthvo_tpu.data``).

Only the synthetic scenes are ported so far; the KITTI readers and the
host->device pipeline come with later slices.
"""

from depthvo_tpu_torch.data.synthetic import SyntheticScenes  # noqa: F401
