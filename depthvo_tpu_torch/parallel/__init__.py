"""Data parallelism (counterpart of ``depthvo_tpu.parallel``): one rank
per device in a ``torch.distributed`` group, the train step reducing
explicitly over it (``mesh.py``, ``distributed.py``). The reference's
``batch_sharding`` and ``replicated`` return JAX ``NamedSharding``s and
have no torch counterpart: a rank holds its rows (:func:`shard_batch`)
and a replica of the state (``mesh.replicate``)."""

from depthvo_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch  # noqa: F401
