"""``correct`` on the CPU at the tiny size: a sound run passes the cell's
limits; the control (the reference in float8 in the system's place) and
a run with the timed path broken underneath do not. Each fault is one a
cell can have: a train step that leaves its state unchanged, half of the
batch left out (the mean over the rest), a frame decoded wrong."""

from __future__ import annotations

import time

import pytest
import torch

from gpubench import compare, control, run, spec
from gpubench.tests.conftest import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


def _correct(cell) -> bool:
    out = run.run_cell(cell, SEED, 0.5, False, CPU, time.perf_counter())
    return out["failed"] == 0 and compare.judge(out["numbers"], cell.limits)


@pytest.mark.parametrize("name", ["full_feat.train_graph", "stereo.train_graph",
                                  "full_feat.train_kitti"])
def test_a_sound_run_is_correct(name):
    assert _correct(tiny(name))


@pytest.mark.parametrize("name", ["full_feat.train_graph", "stereo.train_graph"])
def test_the_control_is_not_correct(name):
    cell = tiny(name)
    got = control.numbers(cell, SEED, CPU)
    assert not compare.judge(got, {k: v for k, v in cell.limits.items() if k in got})


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("name", ["full_feat.train_graph", "stereo.train_graph"])
def test_a_broken_train_step_is_not_correct(monkeypatch, name, fault):
    monkeypatch.setattr(*control.FAULTS[fault]())
    assert not _correct(tiny(name))


def test_a_frame_decoded_wrong_is_not_correct(monkeypatch):
    monkeypatch.setattr(*control.FAULTS["frames_flipped"]())
    assert not _correct(tiny("full_feat.train_kitti"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["full_feat.train_graph", "stereo.train_graph",
                                  "full_feat.train_kitti"])
def test_the_control_is_not_correct_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("the control at the cell's own size runs on a CUDA device")
    full = spec.cell(name)
    got = control.numbers(full, 41, torch.device("cuda"))
    assert not compare.judge(got, {k: v for k, v in full.limits.items() if k in got})
