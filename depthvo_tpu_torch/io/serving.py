"""Serving export: the depth forward frozen into one ``torch.export``
artifact (counterpart of ``depthvo_tpu/io/serving.py``).

The reference writes a ``jax.export`` StableHLO program with its weights
as constants; here it is an ``ExportedProgram`` saved with
``torch.export.save``, weights included, that any PyTorch can load and
call without this package, a checkpoint or a config:

* **symbolic batch** (``torch.export.Dim``, 1 to ``MAX_BATCH``) unless
  ``batch`` is given: one artifact serves every batch size; height,
  width and channels stay static. The batch is traced at 2 (a dimension
  traced at 1 would be specialised);
* **uint8 or float32 input**: uint8 is normalised inside the program with
  the loaders' ``x / 127.5 - 1``, float32 is taken in [-1, 1];
* **"depth" or "disparity" output**;
* **int8**: a ``calibrate_int8``'d model exports its w8a8 program: the
  int8 weights, their scales and the activation scales are buffers of
  the program, and the convolutions are ``aten._int_mm`` over an im2col;
* **devices**: the graph holds no device constant, so :func:`load` moves
  the program to the device asked for. ``platforms`` (the reference's
  ``("cpu", "tpu")``) names the devices the artifact is meant for,
  ``("cpu", "cuda")``; the export loads and runs it on each of them this
  machine has, and the sidecar records those under ``checked_on``.

A JSON sidecar (``path + ".json"``) records the input contract.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from depthvo_tpu_torch.utils.images import to_unit

PLATFORMS = ("cpu", "cuda")
TRACE_BATCH = 2
MAX_BATCH = 65535  # the CUDA grid dimension the card's kernels guard the batch on


class _DepthProgram(torch.nn.Module):
    """images (B, H, W, 3) -> depth or disparity (B, H, W), float32."""

    def __init__(self, net: torch.nn.Module, output: str):
        super().__init__()
        self.net = net
        self.output = output

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        disp = self.net(to_unit(images))[-1][..., 0]
        return 1.0 / disp if self.output == "depth" else disp


def export_depth(
    model,
    path: str,
    *,
    input_dtype: str = "uint8",
    platforms: tuple = PLATFORMS,
    batch: int | None = None,
    output: str = "depth",
) -> Dict[str, Any]:
    """Write ``model``'s depth forward (weights included) to ``path``.

    Args:
      model: an ``api.DepthVO`` (its current depth forward: float, or int8
        after ``calibrate_int8``), traced on its device.
      path: the artifact (conventionally ``.depthvo.pt2``); the sidecar
        lands at ``path + ".json"``.
      input_dtype: "uint8" (normalised in the program) or "float32".
      platforms: the devices the artifact is for, a subset of
        ``("cpu", "cuda")``.
      batch: a concrete batch size, or None for a symbolic batch.
      output: "depth" (1/disparity, what ``model.depth`` returns) or
        "disparity" (the net's finest output).

    Returns the sidecar dict (also written to ``path + ".json"``).
    """
    if input_dtype not in ("uint8", "float32"):
        raise ValueError(f"input_dtype must be uint8|float32, got {input_dtype!r}")
    if output not in ("depth", "disparity"):
        raise ValueError(f"output must be depth|disparity, got {output!r}")
    bad = set(platforms) - set(PLATFORMS)
    if bad:
        raise ValueError(f"platforms must be within {PLATFORMS}, got {sorted(bad)}")
    mc = model.config.model
    dtype = torch.uint8 if input_dtype == "uint8" else torch.float32
    b = TRACE_BATCH if batch is None else int(batch)
    example = torch.zeros((b, mc.height, mc.width, 3), dtype=dtype, device=model.device)
    dynamic = None
    if batch is None:
        dynamic = {"images": {0: torch.export.Dim("b", min=1, max=MAX_BATCH)}}
    program = _DepthProgram(model.models.depth, output).eval()
    with torch.no_grad():
        exported = torch.export.export(program, (example,), dynamic_shapes=dynamic)
    torch.export.save(exported, path)
    checked = []
    for dev in platforms:
        if dev == "cuda" and not torch.cuda.is_available():
            continue
        probe = ServingModel(_load_module(path, torch.device(dev)), None, torch.device(dev))
        if not np.isfinite(probe(np.zeros((1 if batch is None else b, mc.height, mc.width, 3),
                                          input_dtype))).all():
            raise RuntimeError(f"export_depth: the artifact gives non-finite values on {dev}")
        checked.append(dev)
    sidecar = {
        "format": "torch.export ExportedProgram (torch.export.save)",
        "function": f"images -> {output}",
        "input": {
            "shape": ["b" if batch is None else b, mc.height, mc.width, 3],
            "dtype": input_dtype,
            "layout": "NHWC, RGB",
            "range": "[0, 255]" if input_dtype == "uint8" else "[-1, 1]",
        },
        "output": output,
        "platforms": list(platforms),
        "checked_on": checked,
        "variant": model.config.name,
        "int8": model.quant is not None,
        "torch": torch.__version__,
        "artifact_bytes": os.path.getsize(path),
    }
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f, indent=2)
    return sidecar


class ServingModel:
    """A loaded artifact: images (numpy or tensor) -> numpy."""

    def __init__(self, module: torch.nn.Module, sidecar: Dict[str, Any] | None,
                 device: torch.device):
        self._module = module
        self.sidecar = sidecar or {}
        self.device = device

    def __call__(self, images) -> np.ndarray:
        x = images if torch.is_tensor(images) else torch.as_tensor(np.asarray(images))
        want = self.sidecar.get("input", {}).get("dtype")
        got = str(x.dtype).replace("torch.", "")
        if want and got != want:
            raise TypeError(
                f"artifact expects {want} input, got {got} (see the .json sidecar)")
        with torch.inference_mode():
            return self._module(x.to(self.device)).cpu().numpy()


def load(path: str, device: str | torch.device | None = None) -> ServingModel:
    """Read an artifact written by :func:`export_depth` onto ``device``
    (default ``cuda``; it raises without a GPU unless ``device="cpu"``).
    Needs only torch: no checkpoint, no model code, no config."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu'")
    sidecar = None
    if os.path.isfile(path + ".json"):
        with open(path + ".json") as f:
            sidecar = json.load(f)
    return ServingModel(_load_module(path, dev), sidecar, dev)


def _load_module(path: str, dev: torch.device) -> torch.nn.Module:
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(torch.export.load(path), dev).module()
