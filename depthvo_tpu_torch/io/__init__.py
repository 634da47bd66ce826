"""Weight interchange, checkpoints and serving of the port (counterpart of
``depthvo_tpu.io``): the JAX -> PyTorch bridge (``from_jax``) and its
inverse (``to_flax_layout``), the port's checkpoints (``checkpoint``),
the reader of the JAX package's orbax directories (``orbax_reader``),
the serving export (``serving``) and the Caffe weight tools
(``caffemodel``, ``net_prototxt``, ``solver_prototxt``,
``import_weights``, ``export_weights``, ``name_map``)."""
