"""The traced stretch of a window: what ran on the device, and what the
host did while the device idled.

A `torch.profiler` session (host and device activity) covers a steady
stretch of forwards inside the window, marked by the host range
`bench:stretch`.  Its raw events are read after the window has closed
(no per-event tree is built).  The span arithmetic is that of
`chip_smoke.device_breakdown`, with the device's busy time taken as the
union of the intervals in which an operation ran on it (kernels, copies
and sets), clipped to the stretch.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import torch

__all__ = ["STRETCH", "Stretch", "profiled", "summarize", "top"]

STRETCH = "bench:stretch"
# host events that are no operation of the program
_MARKS = ("bench:", "Activity Buffer")
# the longest a name is kept in a breakdown
_NAME_CHARS = 160


@dataclasses.dataclass
class Stretch:
    """What one traced stretch of `forwards` forwards holds: its length
    (s), the device's busy seconds, the device time by operation name and
    the idle seconds by the host operation running in each gap."""

    forwards: int
    window_s: float
    busy_s: float
    device_ops: Dict[str, float]
    idle_gaps: Dict[str, float]


@contextlib.contextmanager
def profiled(device: torch.device) -> Iterator[torch.profiler.profile]:
    """A profiler session over the block, with device activity on a card."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def _host_op_at(t: int, starts: List[int], ops: List[Tuple[int, int, str]]
                ) -> str:
    """The innermost host operation running at time t: of the ops started
    by t, the latest one still running (walking back a bounded way)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 256, -1), -1):
        a, b, name = ops[j]
        if b >= t:
            return name
    return "(no host op)"


def summarize(prof, forwards: int) -> Optional[Stretch]:
    """The stretch marked `STRETCH` in the session `prof`, or None where the
    session holds no such range."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    mark = [e for e in events if e.name() == STRETCH
            and e.device_type() == DeviceType.CPU]
    if not mark:
        return None
    s0 = mark[0].start_ns()
    s1 = s0 + mark[0].duration_ns()
    device, host = [], []
    for e in events:
        name = e.name()
        if name.startswith(_MARKS):
            continue
        a = max(e.start_ns(), s0)
        b = min(e.start_ns() + e.duration_ns(), s1)
        if b <= a:
            continue
        if e.device_type() == DeviceType.CUDA:
            device.append((a, b, name))
        elif e.device_type() == DeviceType.CPU and name.startswith("aten::"):
            host.append((a, b, name))
    busy = _union([(a, b) for a, b, _ in device])
    ops: Dict[str, float] = collections.defaultdict(float)
    for a, b, name in device:
        ops[name[:_NAME_CHARS]] += (b - a) * 1e-9
    host.sort()
    starts = [a for a, _, _ in host]
    gaps: Dict[str, float] = collections.defaultdict(float)
    edges = [s0] + [t for iv in busy for t in iv] + [s1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps[_host_op_at((a + b) // 2, starts, host)] += (b - a) * 1e-9
    return Stretch(forwards=forwards, window_s=(s1 - s0) * 1e-9,
                   busy_s=sum(b - a for a, b in busy) * 1e-9,
                   device_ops=dict(ops), idle_gaps=dict(gaps))


def top(table: Dict[str, float], n: int = 10) -> List[List]:
    """The `n` largest entries of a name -> seconds table, largest first."""
    return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])
            [:n]]
