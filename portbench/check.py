"""The numbers that decide ``correct``, each held to its limit.

Training (the program's first steps against the reference's, from the same
weights and batches):

- ``loss1_gap``: the gap of the first step's loss, over the reference's
  loss (the later steps' losses part by round-off: the backward kernels add
  with atomics, and a feature-space neighbour then flips);
- ``grad_gap``: over the leaves, the largest gap between the program's and
  the reference's norm of the gradient the optimizer took in the first step
  (L2 term included), over the larger of the reference's norm of that leaf
  and of the median leaf;
- ``change_gap``: the same for the norm of each leaf's change over all the
  checked steps, leaving out the leaves whose gradient in the reference is
  nought to rounding (under a thousandth of the median leaf's): the
  optimizer moves those by round-off alone (a bias ahead of a BatchNorm, a
  key's bias or a query under a softmax over neighbours);
  ``change_median_gap`` the median of those leaves' gaps, which the later
  steps' noise moves less.

Serving: the configuration's ``compare_answers`` on each checked request,
the largest over the requests.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Tuple

NOUGHT = 1e-3


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names: Iterable[str]) -> float:
    names = list(names)
    median = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], median) for n in names)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses`` (a list), ``grad`` and ``change``
    (leaf -> norm); ``ref`` also ``raw_grad`` (leaf -> norm of the gradient
    without the L2 term)."""
    median_raw = statistics.median(ref["raw_grad"].values())
    moved = [n for n in ref["change"] if ref["raw_grad"][n] >= NOUGHT * median_raw]
    median_change = statistics.median(ref["change"][n] for n in moved)
    leaf_gaps = [abs(prog["change"][n] - ref["change"][n]) / max(ref["change"][n], median_change)
                 for n in moved]
    loss1 = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    return {"loss1_gap": loss1,
            "grad_gap": _leaf_gap(prog["grad"], ref["grad"], ref["grad"]),
            "change_gap": max(leaf_gaps), "change_median_gap": statistics.median(leaf_gaps)}


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over several requests."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """``(correct, {name: {"value", "limit"}})``: correct when every number
    is finite and within its limit, and every limit has its number."""
    table = {k: {"value": numbers.get(k, math.nan), "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return ok, table
