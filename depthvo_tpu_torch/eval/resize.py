"""The Eigen protocol's resize of a prediction to its ground truth's size,
without Pillow.

The reference resizes each float32 prediction with
``PIL.Image.fromarray(p, mode="F").resize((W, H), Image.BILINEAR)``. The
card's machine has no Pillow, so this is that function in numpy, step
for step (Pillow's ``Resample.c``, the filter that
``native/dataloader.cpp`` also copies for uint8 frames):

* separable: the horizontal pass first, then the vertical one, with a
  float32 image between them;
* a triangle filter whose support grows with the downscale factor
  (``support = max(in / out, 1)``), taps from
  ``int(center -/+ support + 0.5)`` clipped to the image, weights in
  float64 normalised over the taps inside the image;
* each output pixel the float64 sum of its taps in tap order, rounded to
  float32.

The same operations in the same order give Pillow's values bit for bit
(``tests/test_torch_eval.py`` holds it against Pillow at KITTI's sizes).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def _triangle(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per output pixel its first tap (out,) and its weights (out, ksize),
    zero past the taps inside the image."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero; clipped to the image after.
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    w = _triangle(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for t in range(ksize):  # Pillow's order of summation
        ww += w[:, t]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    return xmin, w


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One separable pass along ``axis`` (1: columns, 0: rows), float32 out."""
    in_size = img.shape[axis]
    xmin, w = _coeffs(in_size, out_size)
    acc = np.zeros((img.shape[0], out_size) if axis == 1 else (out_size, img.shape[1]))
    for t in range(w.shape[1]):
        idx = np.minimum(xmin + t, in_size - 1)  # zero weight past the edge
        if axis == 1:
            acc += img[:, idx].astype(np.float64) * w[None, :, t]
        else:
            acc += img[idx, :].astype(np.float64) * w[:, t, None]
    return acc.astype(np.float32)


def resize_bilinear_f32(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``Image.fromarray(img, "F").resize((width, height), Image.BILINEAR)``
    as a (height, width) float32 array."""
    out = np.asarray(img, np.float32)
    if out.ndim != 2:
        raise ValueError(f"expected a 2-D map, got shape {out.shape}")
    if width != out.shape[1]:
        out = _pass(out, width, axis=1)
    if height != out.shape[0]:
        out = _pass(out, height, axis=0)
    return out
