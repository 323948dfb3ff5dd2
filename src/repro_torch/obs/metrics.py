"""Counters / gauges / histograms for the DSE stack and the model path.

A `Metrics` registry is a plain dict triple — no background threads, no
dependencies.  Counters are always cheap enough to leave on (worker
faults, retry rounds, checkpoint writes fire rarely); histogram
observations (per-engine round latency) are gated on `enabled` so hot
loops pay nothing when metrics are off.

Histograms keep exact count/sum/min/max plus a bounded raw-sample buffer
(`_SAMPLE_CAP`) from which `summary()` derives mean/p50/p95 —
good enough for a CLI summary table without a streaming-quantile sketch.

`export()` / `merge()` round-trip the whole registry through the same
picklable wire format worker processes use for trace buffers, so a
parallel Study's telemetry aggregates counters from every worker.

A counter may also take a 0-d tensor (the model path counts on the device:
`models.layers._moe_dispatch`'s dropped pairs).  The sum then stays a
tensor on its device, added without a sync, and becomes a float only in
`export` and `summary`.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List

__all__ = ["Metrics"]

_SAMPLE_CAP = 4096


class Metrics:
    def __init__(self) -> None:
        self.enabled = False
        self.counters: Dict[str, Any] = {}
        self.gauges: Dict[str, float] = {}
        self._hists: Dict[str, Dict[str, Any]] = {}

    # ----------------------------------------------------------- recording
    def inc(self, name: str, n: Any = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        """Histogram observation; no-op unless the registry is enabled."""
        if not self.enabled:
            return
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = {"count": 0, "sum": 0.0,
                                     "min": float("inf"),
                                     "max": float("-inf"), "samples": []}
        v = float(value)
        h["count"] += 1
        h["sum"] += v
        h["min"] = min(h["min"], v)
        h["max"] = max(h["max"], v)
        if len(h["samples"]) < _SAMPLE_CAP:
            h["samples"].append(v)

    # ------------------------------------------------------- export / merge
    def _host_counters(self) -> Dict[str, Any]:
        """The counters as host numbers: a tensor (a device sum) read back
        as a float, any other value as it is."""
        torch = sys.modules.get("torch")
        if torch is None:
            return dict(self.counters)
        return {k: float(v) if isinstance(v, torch.Tensor) else v
                for k, v in self.counters.items()}

    def export(self) -> Dict[str, Any]:
        return {"counters": self._host_counters(),
                "gauges": dict(self.gauges),
                "histograms": {k: dict(v, samples=list(v["samples"]))
                               for k, v in self._hists.items()}}

    def merge(self, exported: Dict[str, Any]) -> None:
        for k, v in (exported.get("counters") or {}).items():
            self.inc(k, v)
        self.gauges.update(exported.get("gauges") or {})
        for k, h in (exported.get("histograms") or {}).items():
            mine = self._hists.get(k)
            if mine is None:
                self._hists[k] = {"count": int(h["count"]),
                                  "sum": float(h["sum"]),
                                  "min": float(h["min"]),
                                  "max": float(h["max"]),
                                  "samples": list(h.get("samples", []))}
                continue
            mine["count"] += int(h["count"])
            mine["sum"] += float(h["sum"])
            mine["min"] = min(mine["min"], float(h["min"]))
            mine["max"] = max(mine["max"], float(h["max"]))
            room = _SAMPLE_CAP - len(mine["samples"])
            if room > 0:
                mine["samples"].extend(h.get("samples", [])[:room])

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self._hists.clear()

    # --------------------------------------------------------------- report
    def summary(self) -> Dict[str, Any]:
        """JSON-able snapshot with derived histogram stats (no raw
        samples) — what `StudyResult.meta["telemetry"]` carries."""
        hists = {}
        for k, h in self._hists.items():
            s = sorted(h["samples"])
            hists[k] = {
                "count": h["count"],
                "mean": h["sum"] / h["count"] if h["count"] else 0.0,
                "min": h["min"] if h["count"] else 0.0,
                "max": h["max"] if h["count"] else 0.0,
                "p50": _quantile(s, 0.50),
                "p95": _quantile(s, 0.95),
            }
        return {"counters": self._host_counters(),
                "gauges": dict(self.gauges), "histograms": hists}


def _quantile(sorted_samples: List[float], q: float) -> float:
    if not sorted_samples:
        return 0.0
    i = min(len(sorted_samples) - 1,
            max(0, int(round(q * (len(sorted_samples) - 1)))))
    return sorted_samples[i]
