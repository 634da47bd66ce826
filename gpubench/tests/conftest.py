"""Helpers of the benchmark's CPU tests: a cell of ``BENCHMARK.json`` cut
to the tiny size the CPU can run (the system's ``tiny_test`` shapes,
float32, two rows, a short warm-up), and the ``gpu`` marker for tests that
need the card (they skip here, deciding inside the test)."""

from __future__ import annotations

import pytest

from gpubench import spec


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


def tiny(cell_name: str):
    """``cell_name`` of BENCHMARK.json at the tiny size: its stage's
    switches, its traffic's kind and source, the real limits."""
    from depthvo_tpu_torch.configs import base as config_base

    c = spec.cell(cell_name)
    conf = config_base.to_dict(config_base.tiny_test(
        batch_size=2, use_temporal=c.config["use_temporal"],
        use_feature=c.config["use_feature"], log_every=8))
    conf["optim"] = dict(c.config["optim"])
    traffic = dict(c.traffic, pool_batches=4, steps_per_call=2, trace_seconds=0.5)
    if traffic.get("source") == "kitti_ring":
        traffic.update(frames=6)
    return c._replace(config=dict(c.config, **conf), traffic=traffic)

