"""depthvo_tpu_torch: the PyTorch/CUDA port of ``depthvo_tpu``.

A second package beside the JAX one, which stays the reference. It
imports ``torch`` and ``numpy`` and nothing of JAX or of ``depthvo_tpu``:
where it needs a jax-free module of the reference (configs, synthetic
scenes) it keeps its own copy.

The warp kernels that the JAX package wrote in Pallas for the TPU are
hand-written CUDA kernels here (``ops/csrc``), built with ``nvcc`` at
first use. Entry points run on ``cuda`` and raise when there is no GPU,
unless the caller passes ``device="cpu"``; on the CPU every kernel is
replaced by its plain PyTorch version.
"""

from depthvo_tpu_torch.api import DepthVO  # noqa: F401

__all__ = ["DepthVO"]
