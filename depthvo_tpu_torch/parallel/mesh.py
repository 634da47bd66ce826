"""The data-parallel mesh (counterpart of ``depthvo_tpu/parallel/mesh.py``).

The reference's mesh is a grid of devices with axis ``data`` (or ``dcn``
x ``data`` across slices); one SPMD program runs over it, the batch
sharded and the state replicated, and XLA inserts the collectives.

Here a mesh is one of two things:

- a grid of the RANKS of a ``torch.distributed`` group, one device per
  rank (``make_mesh`` after ``parallel.distributed.initialize`` or inside
  ``parallel.distributed.spawn``): every rank of the group, or the first
  ``num_devices`` (or the named ones) in a subgroup of their own, as the
  reference's mesh takes the first devices. Training runs over it: each
  of its ranks gets its rows of the global batch, and the train step
  reduces the loss normalizers, BatchNorm's statistics, the gradients and
  the metrics over the mesh's group, so it computes the reference's
  function of the global batch; a rank outside the mesh runs none of it;
- a grid of this process's DEVICES (no group): replicas for
  data-parallel inference (``DepthVO.to_mesh``, ``eval.runner.predict_depths``).

``(dcn, data)`` keeps the reference's shape and divisibility errors; the
reduction runs over every rank either way (NCCL picks its own hierarchy
across nodes), the same function as the flat mesh.

:func:`shard_batch` / :func:`shard_stacked_batch` place a global host
batch as the reference's do, by its shard-or-replicate predicate: each
rank keeps its rows (``distributed.local_slice``) on its device. The
reference's ``batch_sharding`` and ``replicated`` return JAX
``NamedSharding``s; they have no torch counterpart here.
:func:`global_counts` and :func:`global_metrics` sum a train step's loss
normalizers and metrics over the mesh's ranks, one all-reduce each.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist

from depthvo_tpu_torch.parallel.distributed import local_slice
from depthvo_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
DCN_AXIS = "dcn"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: the grid (global ranks, or this process's torch
    devices); ``group``: the ranks' process group (None for replicas in
    one process); ``local_devices``: the devices of this process."""

    devices: np.ndarray
    axis_names: tuple
    group: Any = None
    local_devices: tuple = ()

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def ranks(self) -> list:
        """The group's global ranks in mesh order (empty without a group)."""
        return [int(r) for r in self.devices.flat] if self.group is not None else []

    @property
    def rank(self) -> int | None:
        """This process's index in the mesh (0 without a group); None on a
        rank of the process group that the mesh does not hold."""
        if self.group is None:
            return 0
        me = dist.get_rank()
        return self.ranks.index(me) if me in self.ranks else None


def member_rank(mesh: Mesh, what: str) -> int:
    """``mesh.rank``, raising on a rank the mesh does not hold: in the
    reference's single program a device outside the mesh runs nothing."""
    if mesh.rank is None:
        raise ValueError(
            f"{what}: rank {dist.get_rank()} is not in this mesh (ranks {mesh.ranks} of a "
            f"group of {dist.get_world_size()}); only the mesh's ranks run its steps, as a "
            "device outside the reference's mesh runs nothing")
    return mesh.rank


def _is_rank_list(devices) -> bool:
    return all(isinstance(d, (int, np.integer)) for d in devices)


def make_mesh(num_devices: int | None = None, devices: Sequence[Any] | None = None,
              num_slices: int = 1, device: str | torch.device | None = None) -> Mesh:
    """The mesh over the first ``num_devices`` devices; the reference's
    parameters, then ``device``.

    In a process group (``torch.distributed`` initialised) the devices are
    the group's ranks: the mesh holds the first ``num_devices`` of them (all
    by default), or the ranks ``devices`` names; ``device`` is this rank's
    device (default ``cuda``, the current card). Every rank of the group
    calls ``make_mesh`` with the same arguments: a mesh over part of the
    group makes its own subgroup (``torch.distributed.new_group``), over
    which its steps reduce, and a rank outside it gets a mesh whose
    ``rank`` is None, on which the train and held-out steps, ``fit``,
    ``shard_batch``, ``replicate`` and a checkpoint's ``save`` raise.
    Without a group the devices are this process's: every visible card, or
    for ``device="cpu"`` ``num_devices`` CPU replicas (one by default).
    ``devices`` may name the grid's entries explicitly (ranks, or torch
    devices).

    ``num_slices=1``: a 1-D mesh with axis ``data``; ``num_slices>1``: a
    ``(dcn, data)`` grid, rows are slices."""
    if devices is None:
        if dist.is_initialized():
            devices = list(range(dist.get_world_size()))
        else:
            dev = resolve_device(device)
            devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                       if dev.type == "cuda" else [dev] * (num_devices or 1))
    devices = list(devices)
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(f"requested {num_devices} devices, have {len(devices)}")
        devices = devices[:num_devices]
    if num_slices <= 1:
        grid, axes = np.asarray(devices, dtype=object), (DATA_AXIS,)
    else:
        if len(devices) % num_slices:
            raise ValueError(
                f"{len(devices)} devices not divisible into {num_slices} slices")
        grid = np.empty(len(devices), dtype=object)
        grid[:] = devices
        grid, axes = grid.reshape(num_slices, len(devices) // num_slices), (DCN_AXIS, DATA_AXIS)
    if not _is_rank_list(devices):
        return Mesh(grid, axes, None, tuple(torch.device(d) for d in devices))
    if not dist.is_initialized():
        raise ValueError("a mesh of ranks needs a process group "
                         "(parallel.distributed.initialize or spawn)")
    world = dist.get_world_size()
    ranks = sorted(int(r) for r in devices)
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world for r in ranks):
        raise ValueError(f"mesh ranks {devices}: each must be a distinct rank of the "
                         f"group's {world}")
    # Every rank takes part in making the subgroup, members or not.
    group = dist.group.WORLD if ranks == list(range(world)) else dist.new_group(ranks)
    return Mesh(grid, axes, group, (resolve_device(device),))


def as_mesh(mesh, what: str) -> Mesh | None:
    """``mesh`` checked for the entry point ``what``: None, or a Mesh. A
    device passed where the reference's signature has ``mesh`` is a
    ``TypeError`` that names ``device=``."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    if isinstance(mesh, (str, torch.device)):
        raise TypeError(
            f"{what}: got {mesh!r} as mesh; the device is the keyword "
            f"argument device= (the reference's parameters come first: "
            f"{what}(config, mesh=None, ..., device=None))")
    raise TypeError(f"{what}: mesh must be a parallel.mesh.Mesh or None, "
                    f"got {type(mesh).__name__}")


def training_mesh(mesh, what: str) -> Mesh | None:
    """``mesh`` for a train or held-out step: a mesh of ranks (a group)
    that holds this rank."""
    mesh = as_mesh(mesh, what)
    if mesh is not None and mesh.group is None:
        raise ValueError(
            f"{what}: training runs one process per device; this mesh holds "
            f"{mesh.size} device(s) of one process. Join a process group first "
            "(parallel.distributed.initialize / spawn, or cli --num-devices N)")
    if mesh is not None:
        member_rank(mesh, what)
    return mesh


def _tensors(tree) -> list:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _tensors(t)]
    return []


def replicate(state, mesh: Mesh):
    """One replica of a train state over a mesh of ranks (the reference's
    ``jax.device_put(state, replicated(mesh))``): the mesh's first rank's
    parameters, BatchNorm statistics and solver tensors are broadcast to
    every rank, in place. Returns ``state``."""
    member_rank(mesh, "replicate")
    nets = [net for net in state.models if net is not None]
    tensors = [t.detach() for net in nets for t in list(net.parameters()) + list(net.buffers())]
    tensors += _tensors(state.opt_state)
    for t in tensors:
        dist.broadcast(t, src=mesh.ranks[0], group=mesh.group)
    return state


def global_counts(counts: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """Per tensor of ``counts``, its sum over the mesh's ranks, all in one
    all-reduce (the loss normalizers of the global batch)."""
    flat = torch.cat(list(counts))
    dist.all_reduce(flat, group=mesh.group)
    return list(flat.split([c.numel() for c in counts]))


def global_metrics(metrics: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The ranks' shares of each metric summed (one all-reduce), detached."""
    flat = torch.stack([v.detach().float() for v in metrics.values()])
    dist.all_reduce(flat, group=mesh.group)
    return dict(zip(metrics, flat.unbind()))


def num_processes(mesh: Mesh) -> int:
    """How many OS processes own this mesh's devices: one per rank in a
    group, 1 for the replicas of one process."""
    return mesh.size if mesh.group is not None else 1


def _rows(batch: Any, mesh: Mesh, axis: int) -> dict:
    """This rank's rows of a global host batch along ``axis``, on its
    device: leaves with at least ``axis + 1`` dimensions go through
    ``local_slice`` along ``axis`` (its predicate and its errors), the
    others pass whole (replicated)."""
    rank, n = (member_rank(mesh, "shard_batch"), mesh.size) if mesh.group is not None else (0, 1)
    cut = {k: np.moveaxis(np.asarray(v), axis, 0) for k, v in batch.items()
           if np.ndim(v) > axis}
    cut = local_slice(cut, rank, n, mesh.size)
    device = mesh.local_devices[0]
    return {k: torch.as_tensor(np.ascontiguousarray(
                np.moveaxis(cut[k], 0, axis) if k in cut else np.asarray(v))).to(device)
            for k, v in batch.items()}


def shard_batch(batch: Any, mesh: Mesh) -> dict:
    """A global host batch (dict of numpy arrays) placed on the mesh, batch
    axis sharded: this rank's rows of each leaf whose leading axis
    divides the mesh, scalars whole, as tensors on this rank's device. A
    batched leaf whose leading axis does not divide a mesh of ranks
    raises, as the reference's one-device-per-process layout does
    (``distributed.local_slice``). A mesh of one process's replicas holds
    the whole batch on its first device."""
    return _rows(batch, mesh, 0)


def shard_stacked_batch(batch: Any, mesh: Mesh) -> dict:
    """:func:`shard_batch` of a [K, batch, ...] stacked batch (several
    steps per call): the per-step batch axis (axis 1) is the one cut, the
    step axis stays whole; leaves without an axis 1 are replicated."""
    return _rows(batch, mesh, 1)
