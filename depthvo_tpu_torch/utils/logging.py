"""Per-step metric lines (the port's copy of ``depthvo_tpu/utils/logging.py``).

Caffe's solver prints every loss output each ``display`` interval; the
training loop keeps the loss terms separate under the names the loss
graph produces (loss/stereo, loss/temporal, loss/feature, loss/smooth,
loss/total) and this writes them as ``step N: k=v ...`` lines and,
optionally, as JSON records appended to a file (the machine-readable
analog of parsing the solver's log) and as TensorBoard scalar events.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Dict


class MetricLogger:
    """``log(step, metrics)`` prints ``step N: k=v ...`` (sorted keys);
    with ``jsonl_path`` it appends ``{"step": N, "t": seconds, k: v, ...}``
    and with ``tensorboard_dir`` it writes one scalar event per metric
    (torch's ``SummaryWriter``, imported here: the ``tensorboard`` package
    is optional)."""

    def __init__(self, stream: IO | None = None, jsonl_path: str | None = None,
                 tensorboard_dir: str | None = None):
        self.stream = stream or sys.stdout
        self.tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ModuleNotFoundError as e:
                raise ModuleNotFoundError(
                    "--tensorboard needs torch + tensorboard: "
                    "pip install 'depthvo-tpu[tensorboard]'"
                ) from e
            self.tb = SummaryWriter(tensorboard_dir)
        self.jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._t0 = time.time()

    def __call__(self, step: int, metrics: Dict[str, float]) -> None:
        parts = " ".join(f"{k}={v:.6g}" for k, v in sorted(metrics.items()))
        self.stream.write(f"step {step}: {parts}\n")
        self.stream.flush()
        if self.jsonl is not None:
            rec = {"step": step, "t": time.time() - self._t0, **metrics}
            self.jsonl.write(json.dumps(rec) + "\n")
            self.jsonl.flush()
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(k, float(v), global_step=step)

    def close(self) -> None:
        if self.jsonl is not None:
            self.jsonl.close()
            self.jsonl = None
        if self.tb is not None:
            self.tb.close()
            self.tb = None
