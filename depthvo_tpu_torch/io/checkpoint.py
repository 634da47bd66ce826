"""Checkpoints: save, resume, and the staged recipe's weight init
(counterpart of ``depthvo_tpu/io/checkpoint.py``, with its verbs).

* ``Solver::Snapshot`` every N iterations -> :func:`make_manager` + :func:`save`.
* ``caffe train --snapshot=x.solverstate`` -> :func:`maybe_restore` (the
  whole state: parameters, BatchNorm statistics, solver state, step).
* ``caffe train --weights=x.caffemodel`` -> :func:`restore_weights` (the
  weights of a previous stage; the state's own solver and step) and
  :func:`restore_param_subtree` (one network).

The port's format is ``<dir>/<step>/state.pt``: the plain data of
:func:`train.state.state_dict`, read back with ``torch.load(...,
weights_only=True)``. A save goes to a temporary directory that is
renamed into place, so a crash mid-save leaves no half checkpoint, and
the newest ``max_to_keep`` are kept. Restarting is "rerun the same
command": :func:`maybe_restore` is a no-op on an empty directory.

The weight readers also take a directory that the JAX package wrote
(orbax; :mod:`io.orbax_reader`, which needs ``tensorstore``), told apart
by the files in the step directory. Its solver state is not read, so
:func:`maybe_restore` refuses such a directory.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict, List

import torch

from depthvo_tpu_torch.io import orbax_reader
from depthvo_tpu_torch.io.from_jax import params_from_jax, seat_state_dict
from depthvo_tpu_torch.train.state import (
    Models, TrainState, load_state_dict, param_tree, state_dict,
)

STATE_FILE = "state.pt"


class CheckpointManager:
    """The step directories under one checkpoint directory."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        """Steps with a complete checkpoint of either format, ascending."""
        if not os.path.isdir(self.directory):
            return []
        steps = []
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.isdigit() and (os.path.isfile(os.path.join(path, STATE_FILE))
                                   or orbax_reader.is_reference_step(path)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None


def make_manager(directory: str, max_to_keep: int = 3) -> CheckpointManager:
    os.makedirs(directory, exist_ok=True)
    return CheckpointManager(directory, max_to_keep)


def save(mgr: CheckpointManager, state: TrainState) -> str:
    """Write ``state`` as ``<dir>/<step>/state.pt`` and drop the oldest
    port checkpoints beyond ``max_to_keep``. Returns the step directory;
    raises if that step is already saved (as orbax does)."""
    final = mgr.step_dir(int(state.step))
    if os.path.exists(final):
        raise FileExistsError(f"checkpoint {final} already exists")
    tmp = tempfile.mkdtemp(prefix=f".{int(state.step)}.tmp-", dir=mgr.directory)
    try:
        torch.save(state_dict(state), os.path.join(tmp, STATE_FILE))
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    ours = [s for s in mgr.all_steps()
            if os.path.isfile(os.path.join(mgr.step_dir(s), STATE_FILE))]
    for s in ours[:-mgr.max_to_keep]:
        shutil.rmtree(mgr.step_dir(s))
    return final


def _device(state: TrainState) -> torch.device:
    return next(iter(param_tree(state.models).values())).device


def maybe_restore(mgr: CheckpointManager, state: TrainState) -> TrainState:
    """Resume from the newest checkpoint if there is one, else return
    ``state`` unchanged."""
    step = mgr.latest_step()
    if step is None:
        return state
    step_dir = mgr.step_dir(step)
    if orbax_reader.is_reference_step(step_dir):
        raise ValueError(
            f"{step_dir} is a checkpoint of the JAX package; its solver state "
            "is not read, so training cannot resume from it. Start from its "
            "weights with --init-from (train.loop.fit's config.init_from)."
        )
    d = torch.load(os.path.join(step_dir, STATE_FILE), map_location=_device(state),
                   weights_only=True)
    return load_state_dict(state, d)


def read_weights(directory: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """The newest checkpoint's weights, ``{net: state dict}`` (parameters
    and BatchNorm statistics), from either format."""
    mgr = CheckpointManager(directory)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {directory}")
    step_dir = mgr.step_dir(step)
    if orbax_reader.is_reference_step(step_dir):
        return params_from_jax(*orbax_reader.read_weights(step_dir))
    d = torch.load(os.path.join(step_dir, STATE_FILE), map_location="cpu",
                   weights_only=True)
    return d["nets"]


def load_weights(directory: str, models: Models) -> Models:
    """The newest checkpoint's parameters and BatchNorm statistics, in
    place, for every network that both have (``depth`` / ``odom`` /
    ``feat``); a network the checkpoint lacks keeps its initialisation."""
    for name, sd in read_weights(directory).items():
        if getattr(models, name) is not None:
            seat_state_dict(getattr(models, name), name, sd)
    return models


def restore_weights(directory: str, state: TrainState) -> TrainState:
    """Weights-only init from a previous stage's checkpoint directory
    (:func:`load_weights`). The state's solver and step stay (a fresh
    state's: a new solver, step 0)."""
    load_weights(directory, state.models)
    return state


def restore_param_subtree(directory: str, state: TrainState, key: str) -> TrainState:
    """Replace ONE network (``depth``/``odom``/``feat``) from a checkpoint
    directory, keeping everything else: the staged recipe's combinator
    (e.g. depth and odom from stage 2, feat from a pretrain directory)."""
    nets = read_weights(directory)
    if key not in nets:
        raise KeyError(f"checkpoint in {directory} has no '{key}' params")
    if getattr(state.models, key) is None:
        raise KeyError(f"the state has no '{key}' network")
    seat_state_dict(getattr(state.models, key), key, nets[key])
    return state
