"""Spans and counters of the port: where the host spends a run's time,
recorded at the layer boundaries and off unless :func:`enable` turns
them on.

    from depthvo_tpu_torch.utils import spans

    spans.enable()
    with spans.span("fit.call"):
        ...
    spans.count("ring.images", 12)
    spans.take()  # {"spans": {"fit.call": {"count": 1, "seconds": ...}},
                  #  "counters": {"ring.images": 12}}

Off (the default), :func:`span` returns one shared no-op context and
:func:`count` returns at once: one read of a module global each. On,
a span records ``(name, t0, t1)`` on ``time.perf_counter``'s clock, from
any thread; on the main thread it also enters
``torch.profiler.record_function("depthvo." + name)``, so that an active
profiler's trace holds the range on the device trace's own clock (the
profiler records no ranges of other threads, so their spans are kept
here only). Counters add up in :data:`COUNTS`.

The spans the port records, and what each covers:

* ``fit.data_wait``: ``train.loop.fit`` waiting for its next batch (the
  prefetch queue, or the data iterator itself with ``prefetch=0``);
* ``fit.call``: one call of the step function (K steps);
* ``fit.log``: the logged metrics' host read and ``log_fn``;
* ``graph.plan``: the solver's plans of a graphed call and their table's
  upload (``train.loop._GraphedSteps``);
* ``graph.bind``: checking the graphs' binding to the state's storage;
* ``graph.replay``: the call's batch copies and replays (or its eager
  warm-up and capture), once a call;
* ``mf.loss``: ManyDepth's loss graph (``train.manydepth``), when eager;
* ``mf.match``: inside it, the lookup frames' stem, the depth bins and the
  cost volume (``models.manydepth.ResnetEncoderMatching``).

Counters: ``ring.*``, the native ring's own counts
(``data.native_loader.STATS_FIELDS``), added per batch by
``data.kitti.KittiRawStereo``'s ring iterator.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List, Tuple

import torch

PREFIX = "depthvo."  # the profiler ranges' names: PREFIX + span name

_ON = False
RECORDS: List[Tuple[str, float, float]] = []  # (name, t0, t1)
COUNTS: collections.Counter = collections.Counter()
_LOCK = threading.Lock()  # COUNTS' read-modify-write from several threads
_OFF = contextlib.nullcontext()


def enable(on: bool = True) -> None:
    """Turn spans and counters on (or off); what was recorded stays."""
    global _ON
    _ON = bool(on)


def enabled() -> bool:
    return _ON


class _Span:
    __slots__ = ("name", "mark", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.mark = None
        if threading.current_thread() is threading.main_thread():
            self.mark = torch.profiler.record_function(PREFIX + self.name)
            self.mark.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.mark is not None:
            self.mark.__exit__(*exc)
        RECORDS.append((self.name, self.t0, t1))
        return False


def span(name: str):
    """A context that records the time spent inside it under ``name``."""
    if not _ON:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if not _ON:
        return
    with _LOCK:
        COUNTS[name] += n


def reset() -> None:
    """Discard every span and counter recorded so far."""
    with _LOCK:
        RECORDS.clear()
        COUNTS.clear()


def take(window: Tuple[float, float] | None = None) -> Dict[str, dict]:
    """Everything recorded since the last :func:`take` or :func:`reset`,
    then cleared: the spans by name as their count and total seconds, and
    the counters. ``window`` (t0, t1 on ``time.perf_counter``'s clock)
    keeps only the spans that start and end inside it."""
    with _LOCK:
        records, counters = RECORDS[:], dict(COUNTS)
        del RECORDS[:len(records)]  # one step: a span ending meanwhile stays
        COUNTS.clear()
    lo, hi = window if window is not None else (float("-inf"), float("inf"))
    by_name: Dict[str, dict] = {}
    for name, t0, t1 in records:
        if lo <= t0 and t1 <= hi:
            agg = by_name.setdefault(name, {"count": 0, "seconds": 0.0})
            agg["count"] += 1
            agg["seconds"] += t1 - t0
    return {"spans": by_name, "counters": counters}
