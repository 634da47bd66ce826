"""What a cell is, read from data: ``BENCHMARK.json`` at the checkout's
root names the cell's configuration, traffic and metrics; the files of
each are found by name under ``gpubench/``:

* ``configs/<config>.json``: the configuration as it runs (the system's
  ``ExperimentConfig`` as a dict, plus ``source`` and ``assumed``);
* ``traffic/<traffic>.json``: the parameters the generator reads; its
  ``kind`` picks the runner, ``<kind>_cell.py`` (``train``);
* ``workloads/<cell>.json``: the limits of the numbers that decide
  ``correct`` in that cell;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``,
  which returns a number or None where it finds nothing to read.

A new cell, configuration, traffic mix or per-layer metric is new files
and entries; no file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with its files."""
    bench = bench or benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(entries)}")
    w = entries[name]
    here = os.path.join(root, "gpubench")
    end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in e2e_names else [])]
    return Cell(
        name=name,
        config_name=w["config"],
        config=_load(os.path.join(here, "configs", f"{w['config']}.json")),
        traffic_name=w["traffic"],
        traffic=_load(os.path.join(here, "traffic", f"{w['traffic']}.json")),
        limits=_load(os.path.join(here, "workloads", f"{name}.json"))["limits"],
        end_to_end=end_to_end,
        per_layer=per_layer,
    )


def reader(metric: str, root: str = ROOT) -> Callable[[dict], float | None]:
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(root, "gpubench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def experiment(config: dict) -> dict:
    """The configuration without the benchmark's own keys: the system's
    ``ExperimentConfig`` as a dict."""
    return {k: v for k, v in config.items() if k not in ("source", "stage", "assumed", "reduced")}
