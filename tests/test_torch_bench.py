"""The benchmark harness of the port (``utils/profiling.py``, ``cli bench``,
``cli device-query``, the ``depthvo-torch`` console script) against the
reference's contracts, on the CPU at tiny_test's size.

Times measured here are the CPU's and are checked only for their form
(keys, signs, monotone cumulatives); the card's numbers come from
``chip_smoke.py`` phase ``bench``.
"""

import contextlib
import io
import json
import os
import tomllib

import pytest
import torch

from depthvo_tpu.utils import profiling as jprof
from depthvo_tpu_torch import cli
from depthvo_tpu_torch.models import DepthNet, FeatNet, OdomNet
from depthvo_tpu_torch.utils import profiling

torch.set_num_threads(2)
torch.exp(torch.zeros(1))  # MKL's first call on one thread (test_torch_models.py)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(batch_size=1, height=32, width=96, variant="tiny_test")
# The keys of depthvo_tpu/utils/profiling.py's results: run_benchmark's
# return dict (its `extra` per mode; `mfu` only against a known peak) and
# depth_layer_table's result and rows.
BENCH_KEYS = {"mode", "variant", "batch_size", "height", "width", "backend", "device",
              "mean_s", "median_s", "min_s", "p95_s", "steps", "frames_per_sec"}
MODE_EXTRAS = {"depth_infer": set(), "depth_infer_int8": {"int8"}, "odom_infer": set(),
               "warp": set(), "train_step": {"flops_per_step"},
               "train_step_scan": {"flops_per_step", "steps_per_call"}}
TABLE_KEYS = {"mode", "batch_size", "height", "width", "backend", "estimator", "rows"}
ROW_KEYS = {"layer", "forward_ms", "fwd_cumulative_ms", "backward_ms", "bwd_cumulative_ms"}


@pytest.fixture
def one_call_per_timing(monkeypatch):
    """``time_fn`` without warm-up, one call per chunk: the CPU cost of
    the train modes stays a few steps."""
    real = profiling.time_fn
    monkeypatch.setattr(profiling, "time_fn",
                        lambda fn, steps=50, warmup=5, chunk=10: real(fn, steps, 0, 1))


@pytest.mark.parametrize("num_scales", [1, 2, 3, 4])
def test_layer_orders_are_the_references_and_name_the_ports_modules(num_scales):
    order = profiling.depth_layer_order(num_scales)
    assert order == jprof.depth_layer_order(num_scales)
    net = DepthNet(stem_features=8, stage_planes=(4, 4, 4, 4), stage_blocks=(1, 1, 1, 1),
                   decoder_features=(8, 8, 8, 8, 8), num_scales=num_scales)
    top = dict(net.named_children())
    assert all(name in top for name in order)
    assert sum(name.startswith("Conv_") for name in order) == num_scales
    assert profiling.odom_layer_order() == jprof.odom_layer_order()
    assert profiling.feat_layer_order() == jprof.feat_layer_order()
    assert set(profiling.odom_layer_order()) <= dict(OdomNet().named_children()).keys()
    assert set(profiling.feat_layer_order()) <= dict(FeatNet().named_children()).keys()


def test_depth_layer_table_on_a_subset_has_the_references_rows():
    subset = ["ConvBlock_0", "ResNetStage_1", "UpConv_3", "Conv_1"]
    res = profiling.depth_layer_table(**TINY, steps=2, layers=subset, device="cpu")
    assert set(res) == TABLE_KEYS and res["mode"] == "depth_layers" and res["backend"] == "cpu"
    want = [b for b in jprof.depth_layer_order(2) if b in subset]
    assert [r["layer"] for r in res["rows"]] == want == subset
    for r in res["rows"]:
        assert set(r) == ROW_KEYS
        assert r["forward_ms"] >= 0 and r["backward_ms"] >= 0
    for key in ("fwd_cumulative_ms", "bwd_cumulative_ms"):
        cum = [r[key] for r in res["rows"]]
        assert cum == sorted(cum) and cum[-1] > 0


@pytest.mark.parametrize("mode", sorted(MODE_EXTRAS))
def test_run_benchmark_modes_on_the_cpu_return_the_references_keys(one_call_per_timing, mode):
    int8 = mode.endswith("_int8")
    res = profiling.run_benchmark(mode.removesuffix("_int8"), steps=1, int8=int8, device="cpu",
                                  **TINY)
    assert set(res) == BENCH_KEYS | MODE_EXTRAS[mode]
    assert res["backend"] == res["device"] == "cpu"  # no MFU off a card of the peak table
    assert res["median_s"] > 0 and res["frames_per_sec"] == 1 / res["median_s"]
    if "flops_per_step" in res:
        assert res["flops_per_step"] > 1e8
    if mode == "train_step_scan":
        assert res["steps_per_call"] == 8


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def test_cli_bench_layer_mode_prints_the_table_then_its_json(one_call_per_timing):
    rc, out = _cli(["bench", "--mode", "feat_layers", "--variant", "tiny_test", "--height", "32",
                    "--width", "96", "--batch-size", "1", "--steps", "1", "--device", "cpu"])
    lines = out.splitlines()
    assert rc == 0 and lines[0].split()[:3] == ["layer", "forward", "backward"]
    res = json.loads(lines[-1])
    assert [r["layer"] for r in res["rows"]] == jprof.feat_layer_order()
    assert [ln.split()[0] for ln in lines[1:-1]] == jprof.feat_layer_order()


def test_cli_bench_refuses_int8_outside_depth_infer_and_needs_a_card():
    rc, out = _cli(["bench", "--mode", "warp", "--int8", "--device", "cpu"])
    assert rc == 2 and "--int8 applies to --mode depth_infer only" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _cli(["bench", "--mode", "warp"])


def test_device_query_without_a_card_returns_1(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out = _cli(["device-query"])
    assert rc == 1 and "no CUDA device" in out and "cpu" not in out.lower()


def test_maybe_trace_writes_a_chrome_trace(tmp_path):
    with profiling.maybe_trace(str(tmp_path / "t")):
        torch.ones(8).add_(1)
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::add_" for e in events)
    with profiling.maybe_trace(None):
        pass


def test_console_script_resolves_to_the_cli():
    with open(os.path.join(_REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["depthvo-torch"] == "depthvo_tpu_torch.cli:main"
    assert scripts["depthvo"] == "depthvo_tpu.cli:main"
    module, attr = scripts["depthvo-torch"].split(":")
    assert getattr(__import__(module, fromlist=[attr]), attr) is cli.main
