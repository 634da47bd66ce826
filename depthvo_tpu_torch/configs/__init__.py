"""Experiment configs (own copy of ``depthvo_tpu.configs``)."""

from depthvo_tpu_torch.configs.base import (  # noqa: F401
    ExperimentConfig,
    ModelConfig,
    OptimConfig,
    stereo,
    temporal_stereo,
    full_feat,
    tiny_test,
)
