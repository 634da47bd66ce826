"""The port's spans and counters (``depthvo_tpu_torch/utils/spans.py``):
off by default, what they record when on, and the spans ``fit`` records
per call on the CPU."""

import dataclasses
import json
import threading
import time

import pytest
import torch

from depthvo_tpu_torch import configs as tconfigs
from depthvo_tpu_torch.data.synthetic import SyntheticScenes
from depthvo_tpu_torch.train import loop as tloop
from depthvo_tpu_torch.utils import profiling, spans


@pytest.fixture(autouse=True)
def _spans_off():
    spans.enable(False)
    spans.reset()
    yield
    spans.enable(False)
    spans.reset()


def test_off_records_nothing_and_shares_one_context():
    assert not spans.enabled()
    assert spans.span("a") is spans.span("b")
    with spans.span("a"):
        spans.count("n", 3)
    assert spans.take() == {"spans": {}, "counters": {}}


def test_nested_spans_give_name_parent_and_durations():
    spans.enable()
    with spans.span("outer"):
        time.sleep(0.02)
        with spans.span("inner"):
            time.sleep(0.01)
    with spans.span("inner"):
        pass
    # In the order they closed; the first inner lies inside its parent.
    (inner, i0, i1), (outer, o0, o1), (last, l0, _) = spans.RECORDS
    assert (inner, outer, last) == ("inner", "outer", "inner")
    assert o0 <= i0 <= i1 <= o1 <= l0
    took = spans.take()["spans"]
    assert took["outer"]["count"] == 1 and took["inner"]["count"] == 2
    assert took["outer"]["seconds"] >= 0.03 > took["inner"]["seconds"] >= 0.01
    assert spans.take() == {"spans": {}, "counters": {}}  # take() clears


def test_take_keeps_the_window_and_spans_of_other_threads():
    spans.enable()
    with spans.span("before"):
        pass
    t0 = time.perf_counter()

    def work():
        with spans.span("worker"):
            spans.count("n")

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    took = spans.take(window=(t0, time.perf_counter()))
    assert took["spans"] == {"worker": {"count": 4, "seconds": took["spans"]["worker"]["seconds"]}}
    assert took["counters"] == {"n": 4}


def test_counters_add_up_and_reset_discards():
    spans.enable()
    for n in (1, 2, 3):
        spans.count("ring.images", n)
    spans.count("ring.batches")
    assert dict(spans.COUNTS) == {"ring.images": 6, "ring.batches": 1}
    spans.reset()
    assert spans.take() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("k", [1, 2])
def test_fit_records_one_wait_and_one_call_per_call(k):
    cfg = dataclasses.replace(tconfigs.tiny_test(), log_every=100)
    scenes = SyntheticScenes(cfg, seed=2, num_scenes=2)
    calls = 2
    tloop.fit(cfg, scenes.iterator(cfg.batch_size), calls * k, device="cpu",
              steps_per_call=k, log_fn=lambda s, m: None)
    assert spans.take() == {"spans": {}, "counters": {}}  # off: nothing
    spans.enable()
    tloop.fit(cfg, scenes.iterator(cfg.batch_size), calls * k, device="cpu",
              steps_per_call=k, log_fn=lambda s, m: None)
    # One after another: none of fit's spans lies inside another.
    intervals = sorted((t0, t1) for _, t0, t1 in spans.RECORDS)
    assert all(a1 <= b0 for (_, a1), (b0, _) in zip(intervals, intervals[1:]))
    took = spans.take()["spans"]
    assert {n: s["count"] for n, s in took.items()} == {
        "fit.data_wait": calls, "fit.call": calls, "fit.log": 2}  # step 0 and the last


def test_maybe_trace_puts_the_spans_in_its_trace(tmp_path):
    with profiling.maybe_trace(str(tmp_path / "t")):
        assert spans.enabled()
        with spans.span("fit.call"):
            torch.ones(8).add_(1)
    assert not spans.enabled() and spans.take() == {"spans": {}, "counters": {}}
    with open(tmp_path / "t" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert spans.PREFIX + "fit.call" in names
