"""Host-side data pipeline: batches prefetched into device memory on a
thread (counterpart of ``depthvo_tpu/data/pipeline.py``).

Caffe's ``base_data_layer`` + ``InternalThread`` prefetch the next batch
on a host thread while the GPU computes; so does :func:`prefetch_to_device`.
On a GPU a producer thread copies each host batch into a ring of pinned
host buffers and uploads it on a side CUDA stream, so the copy overlaps
the step that runs on the consumer's stream. Images stay uint8 until
they are on the device (the loss graph normalises them there).

With several train steps per call, :func:`stacked_batches` stacks K
host batches into one [K, ...] batch, which goes through the same pinned
slots in one upload per call.

Ordering is kept with events, never with a device-wide synchronize:

* the upload records an event on the side stream; the consumer's stream
  waits on it before the batch is handed out, and each tensor is
  ``record_stream``-ed on the consumer's stream, so the caching allocator
  does not give its memory to the side stream while the step still uses
  it;
* a pinned slot is refilled only after the event of its previous upload
  has completed, so a copy still in flight is never overwritten.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from depthvo_tpu_torch.utils.device import resolve_device

Batch = Dict[str, Any]


def batch_iterator(sample_fn: Callable[[], Dict[str, np.ndarray]]
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Wrap a zero-argument batch factory into an infinite iterator."""
    while True:
        yield sample_fn()


def stack_batches(batches: list) -> Dict[str, np.ndarray]:
    """Stack K host batches (a list of dicts) into one dict of [K, ...]
    arrays (the port's copy of the reference's ``train/loop.py``
    function)."""
    return {k: np.stack([b[k] for b in batches], axis=0) for k in batches[0]}


def stacked_batches(it: Iterator[Batch], steps_per_call: int, start: int,
                    total: int) -> Iterator[Dict[str, np.ndarray]]:
    """The stacked batches of a run of steps ``start`` to ``total`` with
    ``steps_per_call`` steps per call: K = min(steps_per_call, steps
    left) batches of ``it`` per stack, so the last stack holds exactly the
    steps left and no batch is read twice or beyond ``total`` (the
    reference's ``fit._stacked``)."""
    step = start
    while step < total:
        k = min(steps_per_call, total - step)
        yield stack_batches([next(it) for _ in range(k)])
        step += k


class _PinnedUploader:
    """Host batch -> device tensors through ``slots`` pinned buffers and a
    side stream; returns the batch and the event that marks its upload."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pinned: list = [dict() for _ in range(slots)]
        self.done: list = [None] * slots
        self.count = 0

    def __call__(self, batch: Batch) -> Tuple[Batch, torch.cuda.Event]:
        slot = self.count % len(self.pinned)
        self.count += 1
        if self.done[slot] is not None:
            self.done[slot].synchronize()  # its last upload has landed
        bufs = self.pinned[slot]
        out = {}
        with torch.cuda.stream(self.stream):
            for k, v in batch.items():
                if torch.is_tensor(v) and v.is_cuda:
                    out[k] = v
                    continue
                host = v if torch.is_tensor(v) else torch.as_tensor(np.ascontiguousarray(v))
                buf = bufs.get(k)
                if buf is None or buf.shape != host.shape or buf.dtype != host.dtype:
                    buf = bufs[k] = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                buf.copy_(host)
                out[k] = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.done[slot] = event
        return out, event


def _to_cpu_tensors(batch: Batch) -> Tuple[Batch, None]:
    return {k: v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
            for k, v in batch.items()}, None


def prefetch_to_device(it: Iterator[Batch], device: str | torch.device | None = None,
                       buffer_size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Prefetch host batches (dicts of numpy arrays) onto ``device``
    (default ``cuda``) on a background thread, ``buffer_size`` ahead.

    The consumer gets dicts of tensors on the device, ready for its
    current stream. On the CPU there is no pinned memory and no stream:
    the thread only turns the arrays into tensors.

    It records no span of its own (``utils.spans``): the consumer's wait
    on its queue is ``fit``'s ``fit.data_wait``, and of the producer's
    work only the native ring's counters (``ring.*``, added by
    ``data.kitti``'s ring iterator on this thread) are seen; the
    stacking and the pinned upload are not.

    Failure semantics (as the reference's): an exception in the producer
    (a corrupt PNG, say) re-raises in the consumer instead of passing for
    the end of the data; a consumer that abandons the generator stops the
    producer.
    """
    dev = resolve_device(device)
    upload = _PinnedUploader(dev, buffer_size + 1) if dev.type == "cuda" else _to_cpu_tensors
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        # Bounded put, so an abandoned consumer cannot strand the thread.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            if dev.type == "cuda" and dev.index is not None:
                torch.cuda.set_device(dev)
            for batch in it:
                if stop.is_set() or not put(upload(batch)):
                    return
        except BaseException as e:  # propagate, do not fake the end of data
            put(e)
            return
        put(end)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise RuntimeError("prefetch producer thread failed; see cause") from item
            batch, event = item
            if event is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(event)
                for t in batch.values():
                    t.record_stream(stream)
            yield batch
    finally:
        stop.set()
        try:  # free a slot so a producer blocked on a full queue sees `stop`
            q.get_nowait()
        except queue.Empty:
            pass
