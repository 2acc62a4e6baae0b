"""Phase metrics and their CSV (counterpart of qadc_tpu/eval/metrics.py).

Reference: query_metrics (query_common.hpp:21-56): microseconds of the
index / rotate / table / scan phases, averaged over queries and printed as
one CSV row (db_query_4.cpp:387-390). The strings are the JAX package's,
character for character.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class QueryMetrics:
    """Accumulated per-phase microseconds (averaged like the reference)."""

    index_us: float = 0.0
    rotate_us: float = 0.0
    table_us: float = 0.0
    scan_us: float = 0.0
    count: int = 0

    HEADER = "index_us,rotate_us,table_us,scan_us"

    def add(self, index_us=0.0, rotate_us=0.0, table_us=0.0, scan_us=0.0):
        self.index_us += index_us
        self.rotate_us += rotate_us
        self.table_us += table_us
        self.scan_us += scan_us
        self.count += 1

    def averaged(self) -> "QueryMetrics":
        c = max(self.count, 1)
        return QueryMetrics(
            self.index_us / c, self.rotate_us / c, self.table_us / c, self.scan_us / c, 1
        )

    def csv_row(self) -> str:
        a = self.averaged()
        return f"{a.index_us:.0f},{a.rotate_us:.0f},{a.table_us:.0f},{a.scan_us:.0f}"


class PhaseTimer:
    """Lap timer in microseconds on the host clock (reference ustime(),
    common.hpp:17-21)."""

    def __init__(self):
        self.start = time.perf_counter()

    def lap_us(self) -> float:
        now = time.perf_counter()
        us = (now - self.start) * 1e6
        self.start = now
        return us
