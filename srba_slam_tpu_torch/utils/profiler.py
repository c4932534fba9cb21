"""Wall-clock section profiler (≙ MRPT CTimeLogger + SRBA's profiler).

The reference times named pipeline sections (queryDB, get_similar_kfs,
performDA, confirmLC, define_kf — src/CSRBAStereoSLAMEstimator.cpp:425-456)
and dumps them to ``profiler.csv`` (:1022) plus per-KF insertion stats to
``time_new_kf.txt`` (:940-943). Same surface here. The sections time the
host's calls; under the pipelined schedule a call may return before its
device work ends. Inside ``cuda_graphs.record_spans`` each section is also
a host span of the trace, on its clock beside the card's events.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

from srba_slam_tpu_torch.utils import trace


@dataclass
class SectionStats:
    count: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total += dt
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


@dataclass
class Profiler:
    enabled: bool = True
    sections: dict = field(default_factory=lambda: defaultdict(SectionStats))

    @contextmanager
    def section(self, name: str):
        if not self.enabled:
            yield
            return
        t0, sp = time.perf_counter(), None
        try:
            # while a trace records (utils/trace.py), the section is its host
            # span of the same name, timed by the span's own stamps
            with trace.span(name) as sp:
                yield
        finally:
            self.sections[name].add(time.perf_counter() - t0 if sp is None else sp.t1 - sp.t0)

    def save_csv(self, path: str):
        """≙ profiler.csv (reference .cpp:1022)."""
        with open(path, "w") as f:
            f.write("name,count,mean_ms,total_ms,min_ms,max_ms\n")
            for name in sorted(self.sections):
                s = self.sections[name]
                f.write(
                    f"{name},{s.count},{s.mean*1e3:.3f},{s.total*1e3:.3f},"
                    f"{s.min*1e3:.3f},{s.max*1e3:.3f}\n"
                )

    def summary(self) -> str:
        lines = [f"{'section':30s} {'count':>6s} {'mean ms':>10s} {'total ms':>10s}"]
        for name in sorted(self.sections):
            s = self.sections[name]
            lines.append(f"{name:30s} {s.count:6d} {s.mean*1e3:10.2f} {s.total*1e3:10.1f}")
        return "\n".join(lines)
