"""Mean/stddev over benchmark repetitions (main.cpp:93-111)."""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Stats:
    mean: float
    stddev: float


def compute_stats(values: Sequence[float]) -> Stats:
    if not values:
        return Stats(0.0, 0.0)
    mean = sum(values) / len(values)
    if len(values) < 2:
        return Stats(mean, 0.0)
    var = sum((v - mean) ** 2 for v in values) / len(values)
    return Stats(mean, math.sqrt(var))
