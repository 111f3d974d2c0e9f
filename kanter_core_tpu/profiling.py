"""Tracing, metrics, and profiling.

The reference has no tracing at all (SURVEY §5 — only `println!` on errors);
this is greenfield observability for the JAX rebuild:

- `NodeTimeline`: a bounded ring of per-node scheduling events (dispatch →
  commit, with wall durations and outcome), recorded by the engine.
- `device_trace(path)`: context manager around `jax.profiler.trace` so a
  graph evaluation can be captured for TensorBoard/XProf.
- `annotate(name)`: `jax.profiler.TraceAnnotation` passthrough for marking
  host-side phases inside a device trace.

Metrics surfaced on `TextureProcessor.metrics()`: buffer-tier byte counts
(reference: `bytes_memory`/`bytes_storage`, `transient_buffer.rs:413-429`),
in-flight dispatch count (`processing_node_count`), per-node event history,
and fused-program cache size.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class NodeEvent:
    node_id: int
    kind: str  # node type name, or "fused[N]" for partition dispatches
    dispatched_at: float
    committed_at: Optional[float] = None
    outcome: str = "in-flight"  # clean | discarded | canceled | error | in-flight
    extra: dict = field(default_factory=dict)

    @property
    def duration_ms(self) -> Optional[float]:
        if self.committed_at is None:
            return None
        return (self.committed_at - self.dispatched_at) * 1000.0


class NodeTimeline:
    """Thread-safe bounded event log."""

    def __init__(self, capacity: int = 4096):
        self._events: deque[NodeEvent] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}

    def begin(self, node_id, kind: str, **extra) -> NodeEvent:
        event = NodeEvent(int(node_id), kind, time.perf_counter(), extra=dict(extra))
        with self._lock:
            self._events.append(event)
            self._counters["dispatched"] = self._counters.get("dispatched", 0) + 1
        return event

    def end(self, event: NodeEvent, outcome: str) -> None:
        # mutate under the lock so a concurrent summary() can never see a
        # torn event (committed_at set, outcome still "in-flight") or
        # counters lagging the event fields
        with self._lock:
            event.committed_at = time.perf_counter()
            event.outcome = outcome
            self._counters[outcome] = self._counters.get(outcome, 0) + 1

    def events(self) -> list[NodeEvent]:
        from dataclasses import replace

        with self._lock:
            # snapshot COPIES: the engine keeps mutating live events via
            # end(); handing out the originals would let readers observe
            # (and accidentally mutate) in-flight state
            return [replace(e, extra=dict(e.extra)) for e in self._events]

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def summary(self) -> dict:
        events = self.events()
        done = [e for e in events if e.duration_ms is not None]
        by_kind: dict[str, list[float]] = {}
        for e in done:
            by_kind.setdefault(e.kind, []).append(e.duration_ms)
        return {
            "counters": self.counters(),
            "per_kind_ms": {
                kind: {
                    "count": len(ds),
                    "mean": sum(ds) / len(ds),
                    "max": max(ds),
                }
                for kind, ds in sorted(by_kind.items())
            },
        }


def device_trace(log_dir: str):
    """Capture an XLA device trace (TensorBoard/XProf format) for the
    enclosed block."""
    import jax

    return jax.profiler.trace(log_dir)


def annotate(name: str):
    """Named host annotation visible inside a device trace."""
    import jax

    return jax.profiler.TraceAnnotation(name)
