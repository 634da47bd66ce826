"""ctypes binding of the port's native data-loading runtime
(``csrc/dataloader.cpp``, the port's copy of the reference's
``native/dataloader.cpp`` with the ring's counters added; counterpart of
``depthvo_tpu/data/native_loader.py``).

The C++ source decodes PNGs (its own inflate and a per-row unfilter),
resizes them with PIL's triangle filter and runs a multi-threaded
prefetch ring of ready batches; Python only copies finished buffers.
Batches come out as [-1, 1] float32 or raw uint8 (the small host->device
copy; the loss graph normalises on the device).

The ring counts its work, always (atomics, a few clock reads an image):
``NativeBatchLoader.stats()`` returns :data:`STATS_FIELDS` since the
ring started: ``batches`` served, ``consumer_wait_ns`` (``next()``
blocked until its batch was ready), ``images`` decoded, ``decode_ns``
and ``resize_ns`` (the workers' wall time in PNG decode and in the
resize, summed over workers), ``work_cpu_ns`` (their thread CPU time
over the same intervals: under ``decode_ns + resize_ns`` where the
workers waited for a core) and ``inflate_ns`` (their wall time in the
decode's inflate, a part of ``decode_ns``; the rest is the file read, the
IDAT gather and the unfilter). ``data.kitti``'s ring iterator adds them
to ``utils.spans`` as ``ring.<field>``.

The port builds its library from that source in the checkout, with
``g++`` and ``-march=native`` as the repo's Makefile does, into
``depthvo_tpu_torch/data/build/``. The file is named after the host
(machine, a hash of the CPU's feature flags, the source and the flags),
so a library built on one machine is never loaded on another whose CPU
lacks its instructions. A build failure (no compiler, no ``zlib.h``)
raises with the compiler's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterator, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
LDFLAGS = ["-lz", "-lpthread"]

# dvf_loader_stats' fields, in csrc/dataloader.cpp's Stat order.
STATS_FIELDS = ("batches", "consumer_wait_ns", "images", "decode_ns", "resize_ns",
                "work_cpu_ns", "inflate_ns")

_lib = None


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def library_path() -> Path:
    """Where this host's build of the library lives."""
    key = hashlib.sha256()
    for part in (_cpu_flags(), " ".join(CXXFLAGS + LDFLAGS)):
        key.update(part.encode())
    key.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdvfdata-{platform.machine()}-{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library for this host unless it is there; returns its
    path. Raises ``RuntimeError`` with the compiler's output on failure."""
    path = library_path()
    if path.is_file():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, str(SOURCE), "-o", tmp, *LDFLAGS]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"building {SOURCE.name} failed ({' '.join(cmd)}):\n{r.stderr.strip()}"
            )
        os.replace(tmp, path)  # atomic: concurrent builds each write their own file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises on failure."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    c_int, c_i64, c_u8p = ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
    c_fp, c_ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    lib.dvf_decode_png.restype = c_int
    lib.dvf_decode_png.argtypes = [ctypes.c_char_p, c_ip, c_ip, c_ip, c_u8p, c_i64]
    lib.dvf_load_resized.restype = c_int
    lib.dvf_load_resized.argtypes = [ctypes.c_char_p, c_int, c_int, c_fp]
    lib.dvf_load_resized_u8.restype = c_int
    lib.dvf_load_resized_u8.argtypes = [ctypes.c_char_p, c_int, c_int, c_u8p]
    lib.dvf_loader_create.restype = ctypes.c_void_p
    lib.dvf_loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), c_i64, c_int, c_int,
                                      c_int, c_int, c_i64, c_int, c_int, c_int]
    lib.dvf_loader_next.restype = c_int
    lib.dvf_loader_next.argtypes = [ctypes.c_void_p, c_fp, ctypes.POINTER(c_i64)]
    lib.dvf_loader_next_u8.restype = c_int
    lib.dvf_loader_next_u8.argtypes = [ctypes.c_void_p, c_u8p, ctypes.POINTER(c_i64)]
    lib.dvf_loader_destroy.restype = None
    lib.dvf_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.dvf_loader_stats.restype = c_int
    lib.dvf_loader_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(c_i64), c_int]
    n = lib.dvf_loader_stats(None, None, 0)
    if n != len(STATS_FIELDS):
        raise RuntimeError(f"{SOURCE.name} counts {n} ring statistics; STATS_FIELDS "
                           f"names {len(STATS_FIELDS)}: {STATS_FIELDS}")
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads here (for the callers that
    choose a pipeline on their own; an explicit choice calls
    :func:`load_library` and sees the error)."""
    try:
        load_library()
        return True
    except (OSError, RuntimeError):
        return False


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def decode_png(path: str) -> np.ndarray:
    """Decode a PNG to a uint8 (H, W, C) array."""
    lib = load_library()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.dvf_decode_png(path.encode(), w, h, c, None, 0)
    if rc != 0:
        raise ValueError(f"native PNG decode failed ({rc}) for {path}")
    buf = np.empty(h.value * w.value * c.value, np.uint8)
    rc = lib.dvf_decode_png(path.encode(), w, h, c, _ptr(buf, ctypes.c_uint8), buf.size)
    if rc != 0:
        raise ValueError(f"native PNG decode failed ({rc}) for {path}")
    return buf.reshape(h.value, w.value, c.value)


def load_resized(path: str, height: int, width: int) -> np.ndarray:
    """Decode, resize and normalise one image -> (H, W, 3) float32 in [-1, 1]."""
    out = np.empty((height, width, 3), np.float32)
    rc = load_library().dvf_load_resized(path.encode(), height, width,
                                         _ptr(out, ctypes.c_float))
    if rc != 0:
        raise ValueError(f"native load failed ({rc}) for {path}")
    return out


def load_resized_u8(path: str, height: int, width: int) -> np.ndarray:
    """Decode and resize one image -> (H, W, 3) uint8 (no normalisation)."""
    out = np.empty((height, width, 3), np.uint8)
    rc = load_library().dvf_load_resized_u8(path.encode(), height, width,
                                            _ptr(out, ctypes.c_uint8))
    if rc != 0:
        raise ValueError(f"native load failed ({rc}) for {path}")
    return out


class NativeBatchLoader:
    """The C++ prefetch ring over a list of image paths.

    ``next()`` returns (images, indices): images (B, H, W, 3), float32 in
    [-1, 1], or raw uint8 with ``u8=True``; indices say which path each
    row came from (callers join stereo and temporal companions, and each
    sample's intrinsics and baseline, by them).
    """

    def __init__(self, paths: Sequence[str], batch_size: int, height: int, width: int,
                 num_threads: int = 4, seed: int = 0, shuffle: bool = True,
                 queue_cap: int = 4, u8: bool = False):
        self._lib = load_library()
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = self._lib.dvf_loader_create(
            arr, len(self._paths), batch_size, height, width,
            num_threads, seed, int(shuffle), queue_cap, int(u8),
        )
        if not self._handle:
            raise RuntimeError("dvf_loader_create failed")
        self.batch_size, self.height, self.width, self.u8 = batch_size, height, width, u8

    def next(self):
        idx = np.empty((self.batch_size,), np.int64)
        shape = (self.batch_size, self.height, self.width, 3)
        if self.u8:
            out = np.empty(shape, np.uint8)
            rc = self._lib.dvf_loader_next_u8(self._handle, _ptr(out, ctypes.c_uint8),
                                              _ptr(idx, ctypes.c_int64))
        else:
            out = np.empty(shape, np.float32)
            rc = self._lib.dvf_loader_next(self._handle, _ptr(out, ctypes.c_float),
                                           _ptr(idx, ctypes.c_int64))
        if rc != 0:
            raise ValueError(f"native loader batch had decode error {rc}")
        return out, idx

    def stats(self) -> Dict[str, int]:
        """The ring's counters since it started (:data:`STATS_FIELDS`)."""
        if not self._handle:
            raise ValueError("the loader is closed")
        out = np.zeros(len(STATS_FIELDS), np.int64)
        self._lib.dvf_loader_stats(self._handle, _ptr(out, ctypes.c_int64), out.size)
        return dict(zip(STATS_FIELDS, out.tolist()))

    def __iter__(self) -> Iterator:
        while True:
            yield self.next()

    def close(self) -> None:
        if self._handle:
            self._lib.dvf_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
