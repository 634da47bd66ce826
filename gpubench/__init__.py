"""The benchmark of the PyTorch and CUDA port (``depthvo_tpu_torch``): see
``run.py`` for how a cell runs and ``spec.py`` for how cells are found."""
