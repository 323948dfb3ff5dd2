"""Span-based tracer with Chrome-trace-event export.

One `Tracer` per process holds a flat buffer of *complete* ("X") trace
events.  Spans are context managers::

    with tracer.span("search_app", app="resnet"):
        ...

Both ends of a span are read from ``time.time_ns()`` and stored as
**epoch microseconds**, not `perf_counter`, so buffers exported from
spawned worker processes land on the same timeline as the parent's events
— a worker's ``search_app`` span renders inside the parent's ``study``
span in Perfetto without any clock rebasing.  It is the clock
`torch.profiler` (Kineto) stamps its events with.

`export()` returns the raw event list (picklable — this is what
the parallel Study's workers ship back alongside their Evaluator cache
shards); `merge()` folds such a list into the parent buffer;
`chrome_trace()` / `write()` produce the ``{"traceEvents": [...]}``
JSON that chrome://tracing and https://ui.perfetto.dev load directly.

Everything is allocation-free when disabled: `span` returns one shared
`contextlib.nullcontext()` (`OFF`) without reading a clock or creating an
event, so tracing can stay threaded through hot code.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, ContextManager, Dict, Iterator, List

__all__ = ["Tracer", "OFF"]

#: the span of a disabled tracer: one shared null context
OFF = contextlib.nullcontext()

_SCALARS = (str, int, float, bool, type(None))


def _clean_args(args: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only JSON-scalar span attributes (drop live handles)."""
    return {k: (v if isinstance(v, _SCALARS) else repr(v))
            for k, v in args.items()}


def _tid() -> int:
    get_native = getattr(threading, "get_native_id", None)
    return int(get_native() if get_native is not None
               else threading.get_ident())


class Tracer:
    """Per-process span buffer -> Chrome trace events."""

    def __init__(self) -> None:
        self.enabled = False
        self.process_label = "repro_torch-main"
        self._events: List[Dict[str, Any]] = []

    # ----------------------------------------------------------- recording
    def span(self, name: str, /, **args: Any) -> ContextManager[None]:
        """Record one complete ("X") event covering the with-block.  While
        disabled, the shared `OFF` (no allocation, no clock read)."""
        if not self.enabled:
            return OFF
        return self._span(name, args)

    @contextlib.contextmanager
    def _span(self, name: str, args: Dict[str, Any]) -> Iterator[None]:
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            self._events.append({
                "name": name, "cat": "repro_torch", "ph": "X",
                "ts": t0 // 1000, "dur": max(0, t1 - t0) // 1000,
                "pid": os.getpid(), "tid": _tid(),
                "args": _clean_args(args),
            })

    def instant(self, name: str, **args: Any) -> None:
        """Record one instant ("i") event (e.g. a pool task failure)."""
        if not self.enabled:
            return
        self._events.append({
            "name": name, "cat": "repro_torch", "ph": "i", "s": "p",
            "ts": int(time.time_ns() // 1000),
            "pid": os.getpid(), "tid": _tid(),
            "args": _clean_args(args),
        })

    # ------------------------------------------------------- export / merge
    def export(self) -> List[Dict[str, Any]]:
        """Picklable snapshot of this process's buffer, prefixed with the
        "M" process-name metadata event Perfetto uses for labeling."""
        if not self._events:
            return []
        meta = {"name": "process_name", "ph": "M", "pid": os.getpid(),
                "tid": 0, "ts": 0,
                "args": {"name": f"{self.process_label} "
                                 f"(pid {os.getpid()})"}}
        return [meta] + list(self._events)

    def merge(self, events: List[Dict[str, Any]]) -> int:
        """Fold a worker's `export()` buffer into this tracer (the events
        already carry their own pid/tid/epoch timestamps)."""
        self._events.extend(events)
        return len(events)

    def reset(self) -> None:
        self._events.clear()

    def __len__(self) -> int:
        return len(self._events)

    # ---------------------------------------------------------- chrome JSON
    def chrome_trace(self) -> Dict[str, Any]:
        """The full buffer as a Chrome trace-event JSON object."""
        events: List[Dict[str, Any]] = []
        seen_meta = set()
        own_meta = {"name": "process_name", "ph": "M",
                    "pid": os.getpid(), "tid": 0, "ts": 0,
                    "args": {"name": f"{self.process_label} "
                                     f"(pid {os.getpid()})"}}
        for ev in [own_meta] + self._events:
            if ev.get("ph") == "M":
                key = (ev["pid"], ev.get("args", {}).get("name"))
                if key in seen_meta:
                    continue
                seen_meta.add(key)
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.chrome_trace(), indent=1))
        return path
