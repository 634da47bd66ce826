"""Loss graph and held-out evaluation of the port (counterpart of
``depthvo_tpu.train``)."""
