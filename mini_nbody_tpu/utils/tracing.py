"""Profiling / tracing utilities.

The reference's entire observability system is one hardware kilocycle counter
published in control-word bits 63:32 at completion
(``src/top_level.vhd:95-96,121-146,255-263``). The replacement here:

* ``profile_trace``: capture a jax.profiler trace (TensorBoard-viewable,
  includes per-kernel device timelines) around any callable.
* ``StepMetrics``: structured per-interval metrics (interactions/s, wall
  time, optional conservation diagnostics) for long runs — the analog of
  reading the counter between passes, without the host round-trip per step.
* ``annotate``: named trace spans (jax.profiler.TraceAnnotation).
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import List, Optional

import jax


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a device trace into `logdir` (view with TensorBoard)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span appearing in profiler traces."""
    return jax.profiler.TraceAnnotation(name)


@dataclass
class StepMetrics:
    """Accumulates per-interval throughput rows for a long run."""

    n: int
    n_devices: int = 1
    rows: List[dict] = field(default_factory=list)
    _t0: Optional[float] = None
    _steps_done: int = 0

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def tick(self, steps: int, **extra):
        """Record an interval of `steps` integration steps just completed.
        Call after a device sync. Extra kwargs (energy, drift...) are stored."""
        now = time.perf_counter()
        dt = now - (self._t0 if self._t0 is not None else now)
        self._t0 = now
        self._steps_done += steps
        row = {
            "step": self._steps_done,
            "wall_s": round(dt, 6),
            "ginteractions_per_s": round(
                float(self.n) ** 2 * steps / max(dt, 1e-12) / 1e9, 3
            ),
            **extra,
        }
        self.rows.append(row)
        return row

    def jsonl(self) -> str:
        return "\n".join(json.dumps(r) for r in self.rows)
