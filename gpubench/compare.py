"""The numbers that decide ``correct``, and the judgement against limits.

Training (the system's first steps against the reference's, from the
same weights on the same rows):

* ``loss``: the largest relative gap of a loss term (the total and each
  term) over the steps whose losses the system reports;
* ``grad``: the first gradient as the solver received it (the system's
  from Adam's first moment after one step), by the median leaf of the
  gaps between the two norms of a leaf over the larger of the reference's
  norm of that leaf and of the median leaf (the worst leaf is a
  BatchNorm parameter of the first stage, an ill-conditioned sum that
  bfloat16 moves by 20-65% on every seed: PERF.md);
* ``change``: the parameters' change over the checked steps, by the
  worst leaf as above, leaving out leaves whose reference gradient is
  under a thousandth of the median leaf's (Adam moves those by round-off);
* ``bn``: BatchNorm's running statistics' change over the checked steps,
  by the median buffer as above.

Norms and not differences: training-mode gradients of these nets are
chaotic in float32 (a 1e-7 change of an input moves a leaf's gradient by
~1e-2 elementwise), while a leaf's norm is steady.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Iterable

import torch


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              keys: Iterable[str] | None = None) -> list:
    """Per leaf, the gap of the two norms over the larger of the
    reference's norm of that leaf and of the median leaf; sorted."""
    keys = list(reference) if keys is None else list(keys)
    pn = {k: float(torch.linalg.vector_norm(program[k].double())) for k in keys}
    rn = {k: float(torch.linalg.vector_norm(reference[k].double())) for k in keys}
    median = sorted(rn.values())[len(rn) // 2]
    gaps = [abs(pn[k] - rn[k]) / max(rn[k], median, 1e-30) for k in keys]
    return sorted(g if math.isfinite(g) else math.inf for g in gaps)


def worst_leaf(program, reference, keys=None) -> float:
    return leaf_gaps(program, reference, keys)[-1]


def median_leaf(program, reference, keys=None) -> float:
    gaps = leaf_gaps(program, reference, keys)
    return gaps[len(gaps) // 2]


def spread(program, reference, keys=None) -> Dict[str, float]:
    """The leaf gaps' median, 90th percentile and worst."""
    gaps = leaf_gaps(program, reference, keys)
    return {"median": gaps[len(gaps) // 2], "p90": gaps[int(0.9 * (len(gaps) - 1))],
            "worst": gaps[-1]}


def moved(grads: Dict[str, torch.Tensor]) -> list:
    """Leaves whose gradient norm is at least a thousandth of the median
    leaf's."""
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return [k for k, n in norms.items() if n >= 1e-3 * median]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number finite and within its limit."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no reading for {sorted(missing)}")
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)


def report(numbers: Dict[str, float], limits: Dict[str, float]) -> list:
    """``[[name, number, limit], ...]`` and the same as the last lines of
    standard error."""
    for k in limits:
        v = numbers[k]
        print(f"check {k}: {v!r} limit {limits[k]!r} {'ok' if v <= limits[k] else 'OVER'}",
              file=sys.stderr, flush=True)
    return [[k, numbers[k] if math.isfinite(numbers[k]) else repr(numbers[k]), limits[k]]
            for k in limits]
