"""Weight interchange of the port (counterpart of ``depthvo_tpu.io``).
Only the JAX -> PyTorch bridge is ported so far (``from_jax``)."""
