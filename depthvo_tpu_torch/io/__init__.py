"""Weight interchange and checkpoints of the port (counterpart of
``depthvo_tpu.io``): the JAX -> PyTorch bridge (``from_jax``), the port's
checkpoints (``checkpoint``) and the reader of the JAX package's orbax
directories (``orbax_reader``)."""
