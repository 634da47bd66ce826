"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. Nothing
falls back to the CPU silently: asking for ``cuda`` on a machine without
a GPU raises.
"""

from __future__ import annotations

import torch

_cpu_warmed = False


def _warm_cpu() -> None:
    """Make the process's first MKL vector-math call on one element.

    The first such call (sqrt, exp, log, tanh on the CPU) can race when
    torch splits it across threads: a worker's half came out at 12-bit
    accuracy in the port's parity tests. One element runs on one thread.
    """
    global _cpu_warmed
    if not _cpu_warmed:
        torch.exp(torch.zeros(1))
        _cpu_warmed = True


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cpu":
        _warm_cpu()
    return dev
