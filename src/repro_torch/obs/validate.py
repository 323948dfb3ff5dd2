"""Schema validators for obs artifacts (CI gate + test helpers).

    python -m repro_torch.obs.validate --trace trace.json \
        --journal out.jsonl --expect-processes 1

checks that a trace file is well-formed Chrome trace-event JSON (every
event carries name/ph/pid/tid/ts; "X" events a non-negative dur) and
that every journal line is a well-formed round record
(`repro_torch.obs.journal.validate_record`).  Exit code 0 on success, 2
with a diagnostic on the first violation.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List

from repro_torch.obs.journal import validate_record

__all__ = ["validate_chrome_trace", "validate_journal"]

_PHASES = {"X", "i", "M", "B", "E", "C"}


def validate_chrome_trace(path, expect_processes: int = 0
                          ) -> List[Dict[str, Any]]:
    """Validate a Chrome trace-event JSON file; returns the event list.

    `expect_processes`: minimum number of distinct pids that must appear
    on non-metadata events (2 = parent + at least one pool worker)."""
    rec = json.loads(Path(path).read_text())
    if not isinstance(rec, dict) or not isinstance(
            rec.get("traceEvents"), list):
        raise ValueError(f"{path}: not a Chrome trace "
                         "({'traceEvents': [...]} object expected)")
    events = rec["traceEvents"]
    if not events:
        raise ValueError(f"{path}: empty traceEvents")
    pids = set()
    for i, ev in enumerate(events):
        for field in ("name", "ph", "pid", "tid", "ts"):
            if field not in ev:
                raise ValueError(f"{path}: event {i} missing {field!r}: "
                                 f"{ev}")
        if ev["ph"] not in _PHASES:
            raise ValueError(f"{path}: event {i} has unknown phase "
                             f"{ev['ph']!r}")
        if ev["ph"] == "X":
            if not isinstance(ev.get("dur"), int) or ev["dur"] < 0:
                raise ValueError(f"{path}: 'X' event {i} needs a "
                                 f"non-negative integer dur: {ev}")
            pids.add(ev["pid"])
    if expect_processes and len(pids) < expect_processes:
        raise ValueError(
            f"{path}: spans from {len(pids)} process(es), expected >= "
            f"{expect_processes} (worker buffers not merged?)")
    return events


def validate_journal(path, expect_min_records: int = 1
                     ) -> List[Dict[str, Any]]:
    """Validate a JSONL journal file; returns the parsed records."""
    records = []
    for n, line in enumerate(Path(path).read_text().splitlines(), 1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}:{n}: not JSON: {e}") from None
        validate_record(rec)
        records.append(rec)
    if len(records) < expect_min_records:
        raise ValueError(f"{path}: {len(records)} record(s), expected >= "
                         f"{expect_min_records}")
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.validate",
                                 description=__doc__)
    ap.add_argument("--trace", type=Path, default=None)
    ap.add_argument("--journal", type=Path, default=None)
    ap.add_argument("--expect-processes", type=int, default=0,
                    help="minimum distinct pids on trace spans")
    ap.add_argument("--expect-journal-records", type=int, default=1)
    args = ap.parse_args(argv)
    if args.trace is None and args.journal is None:
        ap.error("nothing to validate: pass --trace and/or --journal")
    try:
        if args.trace is not None:
            events = validate_chrome_trace(
                args.trace, expect_processes=args.expect_processes)
            spans = sum(1 for e in events if e["ph"] == "X")
            pids = len({e["pid"] for e in events if e["ph"] == "X"})
            print(f"[obs] {args.trace}: OK — {spans} span(s) from "
                  f"{pids} process(es)")
        if args.journal is not None:
            records = validate_journal(
                args.journal,
                expect_min_records=args.expect_journal_records)
            print(f"[obs] {args.journal}: OK — {len(records)} round "
                  f"record(s)")
    except ValueError as e:
        print(f"[obs] INVALID: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
