"""The share of the program's neighbour searches that ran inside their Morton
windows, in percent: its ``knn.windowed`` counter over ``knn.windowed`` and
``knn.exact``, read once the run has ended. None where both are 0, as in a
program without those counters."""

from __future__ import annotations

from typing import Dict, Optional

from portbench.program_trace import counts


def read(record: dict, found: Optional[Dict[str, int]] = None) -> Optional[float]:
    found = counts() if found is None else found
    windowed = (found or {}).get("knn.windowed", 0)
    total = windowed + (found or {}).get("knn.exact", 0)
    return 100.0 * windowed / total if total else None
