"""Build, load and launch the port's CUDA kernels.

Each ``ops/csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, which ``ctypes`` loads (no
PyTorch headers, so a build takes seconds). The build runs at first use,
into ``ops/build/`` (listed in ``.gitignore``), and each library is named
by a hash of its source and flags, so an edited source is rebuilt and an
unchanged one is not. Sources that need building are compiled in
parallel, one ``nvcc`` each. Nothing here runs at import time.

Every wrapper of a kernel module (``warp_kernels``, ``batch_norm``,
``reproj``) calls its library's C entry through :func:`launch`, which
passes the current stream and counts the launch in the one ledger of the
ops package, :data:`LAUNCHES`, under the wrapper's launch key (the keys of
the modules' ``KERNELS`` tables). Under CUDA-graph capture it counts in
:data:`CAPTURED` instead: whoever replays the graph adds those to
:data:`LAUNCHES` at each replay (``train.loop``), so that a replayed step
counts as an eager one.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

_build_lock = threading.Lock()

# Launches per (launch key, shape key); only the CUDA wrappers count, where
# they launch.
LAUNCHES: collections.Counter = collections.Counter()
# What the wrappers were called for while their stream was capturing a
# CUDA graph: the capture runs no kernel.
CAPTURED: collections.Counter = collections.Counter()


def launch_count(name: str) -> int:
    """Launches of kernel ``name`` since the last :func:`reset_launches`."""
    return sum(n for (k, _), n in LAUNCHES.items() if k == name)


def reset_launches() -> None:
    LAUNCHES.clear()


def launch(name: str, fn, *args, device: torch.device, key: tuple) -> None:
    """``fn(*args, stream)`` with ``device``'s current stream, one launch
    of kernel ``name``: raises if ``fn`` returns a CUDA error, else counts
    ``(name, key)`` (in :data:`CAPTURED` under capture)."""
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    (CAPTURED if torch.cuda.is_current_stream_capturing() else LAUNCHES)[(name, key)] += 1


def find_nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled at first use and "
        "need the CUDA toolkit"
    )


def library_path(source: Path) -> Path:
    """Where the library of ``source`` goes: keyed by source and flags."""
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build(sources: Iterable[Path] | None = None) -> Dict[str, Path]:
    """Compile every source whose library is missing, all at once.

    Returns ``{source stem: library path}``. The compiler's output
    (``-Xptxas=-v``: registers, shared memory, spills per kernel) is kept
    beside each library as ``<library>.log``. Raises with that output if
    a compile fails.
    """
    sources = sorted(CSRC_DIR.glob("*.cu")) if sources is None else list(sources)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((src, out, tmp, proc))
    failures = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        Path(f"{out}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return {src.stem: library_path(src) for src in sources}


def load(stem: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<stem>.cu``, built first if needed."""
    with _build_lock:
        return ctypes.CDLL(str(build([CSRC_DIR / f"{stem}.cu"])[stem]))
