"""Run one cell of the benchmark and print its result as the last line.

    python3 gpubench/run.py --workload full_feat.train_graph --seed 7 --seconds 20 --trace 0

Reads the cell from ``BENCHMARK.json`` and its files under ``gpubench/``
(``gpubench/spec.py``), runs it on the card (``<kind>_cell.py`` by the
traffic's ``kind``: ``train_cell``), checks what the timed path
produced against the plain reference, and prints one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` a ``breakdown`` of the traced window, and
last ``checks``: each compared number beside its limit, also printed as
the last lines of standard error. Exits 1 without a result when no CUDA
device is there, or when the process holds JAX or the JAX package once
the result is built, just before it would be printed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
# Every build and kernel cache stays at a fixed path inside the checkout.
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "depthvo_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def smi() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def run_cell(cell, seed: int, seconds: float, trace: bool, dev, t_start: float) -> dict:
    """The ``run`` of ``gpubench/<kind>_cell.py``, by the traffic's kind."""
    import importlib

    runner = importlib.import_module(f"gpubench.{cell.traffic['kind']}_cell")
    return runner.run(cell, seed, seconds, trace, dev, t_start)


def result(cell, out: dict, trace: bool, device_name: str, count: int) -> dict:
    """The result line's object from a runner's output."""
    from gpubench import compare, spec

    metrics = {}
    if trace:
        out["run"]["device_name"] = device_name
        for m in cell.per_layer:
            value = spec.reader(m["name"])(out["run"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        rates = [m for m in cell.end_to_end if m["name"] != "setup_s"]
        if len(rates) != 1:
            raise ValueError(f"{cell.name}: one end-to-end rate expected, got {rates}")
        metrics[rates[0]["name"]] = {"value": out["rate"], "unit": rates[0]["unit"]}
        metrics["setup_s"] = {"value": out["setup_s"], "unit": "s"}
    device = {"platform": "gpu", "kind": device_name, "count": count,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": None, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if trace:
        t = out["traced"]
        device["busy_s"], device["window_s"] = t["busy_s"], t["window_s"]
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["correct"] = out["failed"] == 0 and compare.judge(out["numbers"], cell.limits)
    line["checks"] = compare.report(out["numbers"], cell.limits)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gpubench import spec

    cell = spec.cell(args.workload)
    chips = next(w["chips"] for w in spec.benchmark()["workloads"] if w["name"] == cell.name)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: {cell.name} needs {chips} CUDA device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(dev)
    print(f"gpubench: {cell.name} seed {args.seed} on {smi()}", file=sys.stderr, flush=True)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev, T_START)
    return finish(cell, out, bool(args.trace), name, chips)


def finish(cell, out: dict, trace: bool, device_name: str, count: int) -> int:
    """Build the result line (the metrics' readers run here), then print it
    unless the process holds JAX or the JAX package by now."""
    line = result(cell, out, trace, device_name, count)
    found = forbidden_modules()
    if found:
        print(f"gpubench: the process holds {found} (JAX or the JAX package)", file=sys.stderr)
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
