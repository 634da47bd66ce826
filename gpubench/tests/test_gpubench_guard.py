"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the system under test. Module names are
compared by their top-level part, whole: ``depthvo_tpu_torch`` is the
system, ``depthvo_tpu`` the JAX package."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from gpubench import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def _sources(sub: str = ""):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_the_reference_imports_nothing_of_the_system(path):
    assert not _imports(path) & {"depthvo_tpu_torch", "depthvo_tpu", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("loaded,found", [
    (["depthvo_tpu_torch", "depthvo_tpu_torch.train.loop"], []),
    (["depthvo_tpu.ops"], ["depthvo_tpu"]),
    (["jax.numpy"], ["jax"]),
    (["jaxlib"], ["jaxlib"]),
    (["flax.linen", "jaxtyping"], ["flax"]),
])
def test_the_exit_check_compares_top_level_names_whole(monkeypatch, loaded, found):
    for name in list(sys.modules):
        if name.split(".", 1)[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    for name in loaded:
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == found


def test_a_reader_that_loads_jax_stops_the_result(monkeypatch, capsys):
    from gpubench import spec

    for name in list(sys.modules):
        if name.split(".", 1)[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)

    def reader(metric):
        def read(record):
            monkeypatch.setitem(sys.modules, "jax", object())
            return 1.0
        return read

    monkeypatch.setattr(spec, "reader", reader)
    cell = spec.cell("full_feat.train_graph")
    out = {"run": {}, "attempted": 1, "failed": 0, "memory_peak_bytes": 1,
           "numbers": {k: 0.0 for k in cell.limits},
           "traced": {"busy_s": 1.0, "window_s": 1.0, "device_ops": [], "idle_gaps": []}}
    assert run.finish(cell, out, True, "NVIDIA H100 80GB HBM3", 1) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "jax" in captured.err


def test_a_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload",
                           "full_feat.train_graph", "--seed", "3", "--seconds", "1"],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr
