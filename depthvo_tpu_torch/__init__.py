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

_API_NAMES = ("predict_depth", "predict_pose", "load_model", "DepthVO")
__all__ = list(_API_NAMES) + ["zoo"]


def __getattr__(name):
    # Lazy, as in the reference: `import depthvo_tpu_torch.geometry` stays
    # cheap (no network is built).
    if name in _API_NAMES:
        from depthvo_tpu_torch import api

        return getattr(api, name)
    if name == "zoo":
        # importlib, not `from depthvo_tpu_torch import zoo`: the
        # from-import re-enters this __getattr__ mid-import.
        import importlib

        return importlib.import_module("depthvo_tpu_torch.zoo")
    raise AttributeError(f"module 'depthvo_tpu_torch' has no attribute {name!r}")
