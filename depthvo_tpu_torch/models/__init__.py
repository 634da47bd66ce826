"""The three networks of the port (counterpart of ``depthvo_tpu.models``)."""

from depthvo_tpu_torch.models.depth_net import DepthNet  # noqa: F401
from depthvo_tpu_torch.models.feat_net import FeatNet  # noqa: F401
from depthvo_tpu_torch.models.odom_net import OdomNet  # noqa: F401
