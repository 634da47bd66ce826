"""Per-step metric lines (the port's copy of the stream half of
``depthvo_tpu/utils/logging.py``).

Caffe's solver prints every loss output each ``display`` interval; the
training loop keeps the loss terms separate under the names the loss
graph produces (loss/stereo, loss/temporal, loss/feature, loss/smooth,
loss/total) and this writes them as ``step N: k=v ...`` lines.
"""

from __future__ import annotations

import sys
from typing import IO, Dict


class MetricLogger:
    """``log(step, metrics)`` prints ``step N: k=v ...`` (sorted keys)."""

    def __init__(self, stream: IO | None = None):
        self.stream = stream or sys.stdout

    def __call__(self, step: int, metrics: Dict[str, float]) -> None:
        parts = " ".join(f"{k}={v:.6g}" for k, v in sorted(metrics.items()))
        self.stream.write(f"step {step}: {parts}\n")
        self.stream.flush()
