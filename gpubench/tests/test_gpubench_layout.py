"""The benchmark is data: ``BENCHMARK.json`` keeps to its contract, and a
cell, a traffic mix, a configuration or a per-layer metric is added by
adding files, which the harness finds by name."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from gpubench import readers, spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_benchmark_keeps_to_its_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["gpubench"] and bench["command"][1] == "gpubench/run.py"
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(ROOT, c["file"])) and c["reduced"] == []
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells and w in e2e[m["moves"]].get("workloads", [w])
        assert os.path.isfile(os.path.join(ROOT, "gpubench", "metrics", f"{m['name']}.py"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert [m["name"] for m in cell.end_to_end if m["name"] != "setup_s"], w["name"]
        assert cell.per_layer, w["name"]
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_new_cell_is_new_files(tmp_path, bench):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "gpubench"), os.path.join(root, "gpubench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "stereo.train_graph_b8", "config": "stereo",
                               "traffic": "train_graph_b8", "chips": 1, "why": "a throwaway"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "stereo.train_graph" in m.get("workloads", []):
            m["workloads"].append("stereo.train_graph_b8")
    bench["per_layer"].append({"name": "kernels_per_step.train", "unit": "count",
                               "better": "lower", "source": "device_trace", "layer": "device",
                               "moves": "train_frames_per_s",
                               "workloads": ["stereo.train_graph_b8"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    here = os.path.join(root, "gpubench")
    traffic = json.load(open(os.path.join(here, "traffic", "train_graph.json")))
    json.dump(dict(traffic, pool_batches=16), open(os.path.join(here, "traffic",
                                                                "train_graph_b8.json"), "w"))
    shutil.copy(os.path.join(here, "workloads", "stereo.train_graph.json"),
                os.path.join(here, "workloads", "stereo.train_graph_b8.json"))
    with open(os.path.join(here, "metrics", "kernels_per_step.train.py"), "w") as f:
        f.write("def read(run):\n    t = run.get('trace')\n"
                "    return t['kernels'] / run['steps'] if t and run.get('steps') else None\n")

    cell = spec.cell("stereo.train_graph_b8", root=root)
    assert cell.config["name"] == "stereo" and cell.traffic["pool_batches"] == 16
    assert [m["name"] for m in cell.end_to_end] == ["train_frames_per_s", "setup_s"]
    names = [m["name"] for m in cell.per_layer]
    assert "kernels_per_step.train" in names and "mfu.train" in names
    read = spec.reader("kernels_per_step.train", root=root)
    assert read({"trace": {"kernels": 300}, "steps": 3}) == 100
    assert read({}) is None
    assert [m["name"] for m in spec.cell("stereo.train_graph", root=root).per_layer] == [
        m["name"] for m in spec.cell("stereo.train_graph").per_layer]


def test_readers_return_nothing_where_nothing_was_read(bench):
    empty = {"device_name": "NVIDIA H100 80GB HBM3", "config": spec.cell(
        "full_feat.train_graph").config, "steps": 0, "window_s": 1.0}
    for m in bench["per_layer"]:
        assert spec.reader(m["name"])(empty) is None, m["name"]


def test_readers_on_a_record():
    config = spec.experiment(spec.cell("full_feat.train_graph").config)
    run = {"device_name": "NVIDIA H100 80GB HBM3", "config": config, "steps": 100,
           "window_s": 2.0, "flops_per_step": 2.0e11, "spans": [(0.0, 0.05), (1.0, 1.03)],
           "trace": {"busy_s": 1.5, "window_s": 2.0, "by_category_s": {
               "convolution": 0.3, "matmul": 0.01, "memcpy": 0.01, "warp": 0.01,
               "batch_norm": 0.2, "other": 0.7}}}
    assert readers.idle_share(run) == pytest.approx(25.0)
    assert readers.mfu(run) == pytest.approx(100 * 2e13 / 2.0 / 989e12)
    assert spec.reader("conv_ms_per_step.train")(run) == pytest.approx(3.0)
    assert spec.reader("tail_ms_per_step.train")(run) == pytest.approx(9.0)
    assert readers.span_ms(run) == pytest.approx(40.0)
    assert 0 < readers.warp_roofline(run) < 100
    assert readers.warp_roofline(dict(run, device_name="CPU")) is None


def test_trace_reduction_of_a_window():
    import types

    import torch

    from gpubench import trace

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, start, end, device):
        return types.SimpleNamespace(name=name, device_type=device,
                                     time_range=types.SimpleNamespace(start=start, end=end))

    events = [ev("gpubench.window", 0, 100, cpu), ev("gpubench.window", 0, 100, cuda),
              ev("sm90_xmma_fprop_implicit_gemm", 10, 30, cuda),
              ev("cudnn::bn_fw_tr_1C11_kernel", 25, 40, cuda),
              ev("gen_bwd_uv_kernel", 60, 70, cuda), ev("aten::copy_", 41, 55, cpu),
              ev("cudaGraphLaunch", 72, 74, cpu)]
    t = trace.reduce(types.SimpleNamespace(events=lambda: events), (0, 100))
    assert t["busy_s"] == pytest.approx(40e-6) and t["window_s"] == pytest.approx(100e-6)
    assert t["by_category_s"] == pytest.approx({"convolution": 20e-6, "batch_norm": 15e-6,
                                                "warp": 10e-6})
    assert [g[0] for g in t["idle_gaps"]] == ["host: after cudaGraphLaunch", "host: aten::copy_",
                                              "host: no traced operation"]
    assert [g[1] for g in t["idle_gaps"]] == pytest.approx([30e-6, 20e-6, 10e-6])
