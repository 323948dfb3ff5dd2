"""`repro_torch.obs` — zero-dependency observability for the DSE stack
and the model path.

Three pillars, one module-level switchboard:

  * **tracing** (`trace.Tracer`) — span-based, per-process buffers,
    merged into one Chrome-trace-event JSON (Perfetto-loadable) covering
    Study phases, engine ask/tell rounds, evaluator batch scoring and
    the cross-evaluation; on the model path, the prefill forward by
    layer (`span`).  A span also opens a range in any running
    `torch.profiler` session, so the device's operations can be put down
    to the span that launched them.
  * **metrics** (`metrics.Metrics`) — counters / gauges / histograms
    (cache hits and misses, per-engine round latency),
    snapshotted into ``StudyResult.meta["telemetry"]`` and the CLI's
    ``--metrics`` summary table.
  * **attribution** (`attribution.explain_config`, surfaced as
    `Evaluator.explain`) — the per-op Table-1 breakdown — plus the JSONL
    search journal (`journal.Journal`): one record per ask/tell round.

Process model
=============

State is per-process and disabled by default (every recording call is a
cheap no-op).  The parent enables what it needs (`enable(...)`).  The
worker plumbing is here for the parallel Study (a later slice): the parent
ships `wire_state()` inside task payloads; a spawned worker starts
disabled, so
`begin_task(wire)` claims ownership, records locally, and `end_task`
returns the picklable export that rides back on the task record for
`merge_worker` on the parent.  When the same task runs *in process*
(serial path, degraded mode), the state is already enabled, `begin_task`
declines ownership, and events land directly in the live buffers — no
double counting either way.

Hard contract: telemetry is **result-inert**.  Nothing here may change a
`StudyResult`'s persisted JSON — `StudyResult.to_json` excludes the
runtime-only ``telemetry`` meta key, and every observation reads values
the run already computed (journal hypervolumes re-read pool scores
through the evaluator cache).
"""

from __future__ import annotations

import contextlib
from typing import Any, ContextManager, Dict, Iterator, Optional

from repro_torch.obs.journal import Journal
from repro_torch.obs.metrics import Metrics
from repro_torch.obs.oblog import configure as configure_logging
from repro_torch.obs.oblog import get_logger, log_event
from repro_torch.obs.trace import OFF, Tracer

__all__ = [
    "enable", "disable", "active", "tracer", "metrics", "journal",
    "span", "instant", "counter", "gauge", "observe",
    "set_context", "get_context", "replace_context", "journal_record",
    "wire_state", "begin_task", "end_task", "merge_worker",
    "get_logger", "log_event", "configure_logging",
    "Tracer", "Metrics", "Journal",
]

_TRACER = Tracer()
_METRICS = Metrics()
_JOURNAL = Journal()
_CONTEXT: Dict[str, Any] = {}


# ------------------------------------------------------------- switchboard
def enable(trace: bool = True, metrics: bool = True,
           journal: bool = True) -> None:
    """Turn pillars on (idempotent; only flips the named ones on)."""
    if trace:
        _TRACER.enabled = True
    if metrics:
        _METRICS.enabled = True
    if journal:
        _JOURNAL.enabled = True


def disable(reset: bool = False) -> None:
    _TRACER.enabled = _METRICS.enabled = _JOURNAL.enabled = False
    if reset:
        _TRACER.reset()
        _METRICS.reset()
        _JOURNAL.reset()
        _CONTEXT.clear()
        _TRACER.process_label = "repro_torch-main"


def active() -> bool:
    return _TRACER.enabled or _METRICS.enabled or _JOURNAL.enabled


def tracer() -> Tracer:
    return _TRACER


def metrics() -> Metrics:
    return _METRICS


def journal() -> Journal:
    return _JOURNAL


# ------------------------------------------------------------ conveniences
def span(name: str, /, **args: Any) -> ContextManager[None]:
    """A span over the with-block.  While tracing is on: the tracer's event
    and a range named `name` in any running `torch.profiler` session, on
    the profiler's own clock.  While off: the shared `trace.OFF`, which
    records nothing and calls no torch op."""
    if not _TRACER.enabled:
        return OFF
    return _profiled_span(name, args)


@contextlib.contextmanager
def _profiled_span(name: str, args: Dict[str, Any]) -> Iterator[None]:
    # a function-scope range, not `torch.profiler.record_function`'s user
    # annotation: Kineto copies a user annotation onto the device's
    # timeline, where a reader of the device's operations counts it as
    # one, and `record_function` is an op that dispatch modes (the
    # frontend's tracer, the dry-run's counter) see; this range is neither
    from torch._C._profiler import _RecordFunctionFast
    with _TRACER.span(name, **args), _RecordFunctionFast(name):
        yield


def instant(name: str, **args: Any) -> None:
    _TRACER.instant(name, **args)


def counter(name: str, n: Any = 1) -> None:
    """Add `n` to counter `name`: a host number, or a 0-d tensor added on
    its device without a sync (`Metrics.inc`)."""
    _METRICS.inc(name, n)


def gauge(name: str, value: float) -> None:
    _METRICS.gauge(name, value)


def observe(name: str, value: float) -> None:
    _METRICS.observe(name, value)


def set_context(**kw: Any) -> None:
    """Ambient labels (e.g. ``app="resnet"``) merged into every journal
    record written afterwards in this process."""
    _CONTEXT.update(kw)


def get_context() -> Dict[str, Any]:
    return dict(_CONTEXT)


def replace_context(ctx: Dict[str, Any]) -> None:
    """Restore a context snapshot taken with `get_context` (used by task
    wrappers that run in-process and must not leak labels to the parent)."""
    _CONTEXT.clear()
    _CONTEXT.update(ctx)


def journal_record(**fields: Any) -> None:
    if not _JOURNAL.enabled:
        return
    rec = dict(_CONTEXT)
    rec.update(fields)
    _JOURNAL.record(**rec)


# -------------------------------------------------------- worker plumbing
def wire_state() -> Optional[Dict[str, bool]]:
    """Picklable enable-flags for task payloads (None when all off — the
    payload content is identical whether obs was never touched or
    explicitly disabled, keeping task payloads deterministic)."""
    if not active():
        return None
    return {"trace": _TRACER.enabled, "metrics": _METRICS.enabled,
            "journal": _JOURNAL.enabled}


def begin_task(wire: Optional[Dict[str, bool]]) -> bool:
    """Worker-side: claim obs ownership for one task.  Returns True only
    in a fresh process (obs disabled here, wire says enabled) — the
    in-process serial path records straight into the live buffers and
    must not export a second copy."""
    if not wire or active():
        return False
    enable(trace=wire.get("trace", False),
           metrics=wire.get("metrics", False),
           journal=wire.get("journal", False))
    _TRACER.process_label = "repro_torch-worker"
    return True


def end_task(owned: bool) -> Optional[Dict[str, Any]]:
    """Worker-side: export the buffers claimed by `begin_task` and reset
    (the pooled process may serve further tasks)."""
    if not owned:
        return None
    exported = {"trace": _TRACER.export(), "journal": _JOURNAL.export(),
                "metrics": _METRICS.export()}
    disable(reset=True)
    return exported


def merge_worker(exported: Optional[Dict[str, Any]]) -> None:
    """Parent-side: fold one worker task's `end_task` export in."""
    if not exported:
        return
    _TRACER.merge(exported.get("trace") or [])
    _JOURNAL.merge(exported.get("journal") or [])
    _METRICS.merge(exported.get("metrics") or {})
