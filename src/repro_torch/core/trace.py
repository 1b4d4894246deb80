"""Lightweight timing spans for solver observability: the port's own copy
of the ``Tracer`` of ``repro/core/trace.py``.

The host lexmm router (``core.flowrouter``) records per-stage wall times
next to its LP iteration counts (``RouterStats.stage_ms``), on one clock
discipline (``time.perf_counter``, milliseconds).

``Tracer`` is an append-only list of named spans. ``with
tracer.span("stage1")`` records one span; ``tracer.ms("stage1")`` totals by
name; ``tracer.stage_ms()`` returns the span durations in record order. A
``Tracer`` is cheap enough to create per solve and is NOT thread-safe: give
each solver its own. The reference's benchmark timer ``timed_us`` belongs
to its benchmark harness and is not copied.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Iterator, List, Optional


@dataclass
class Span:
    """One completed timing span: a name and its wall duration in ms."""

    name: str
    ms: float


class Tracer:
    """Collects named wall-time spans (see module docstring)."""

    def __init__(self) -> None:
        self.spans: List[Span] = []

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        """Context manager recording one span; exceptions still record."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append(Span(name, (time.perf_counter() - t0) * 1e3))

    def ms(self, name: Optional[str] = None) -> float:
        """Total milliseconds across spans, optionally filtered by name."""
        return sum(s.ms for s in self.spans
                   if name is None or s.name == name)

    def stage_ms(self) -> tuple:
        """Span durations (ms) in record order, as an immutable tuple."""
        return tuple(s.ms for s in self.spans)
