"""The traced stretch's arithmetic: busy time as the union of device
intervals, idle gaps named by the host operation running in them; and,
on a card, a profiled stretch read back."""

import json
import subprocess
import sys

import pytest

from _tiny import ROOT

from bench import trace


def test_union_merges_overlaps():
    assert trace._union([(5, 7), (0, 2), (1, 3), (3, 4), (8, 9)]) == [
        (0, 4), (5, 7), (8, 9)]


def test_host_op_at_takes_the_innermost_running():
    ops = [(0, 100, "aten::outer"), (10, 20, "aten::inner"),
           (30, 40, "aten::later")]
    starts = [a for a, _, _ in ops]
    assert trace._host_op_at(15, starts, ops) == "aten::inner"
    assert trace._host_op_at(25, starts, ops) == "aten::outer"
    assert trace._host_op_at(200, starts, ops) == "(no host op)"


def test_top_orders_by_seconds():
    assert trace.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0],
                                                            ["c", 2.0]]


# one profiler session in a fresh process, as a run has: run inside the
# test process, after the harness tests' CPU sessions, it once recorded no
# device operation on the card (one CPU-only session before it in a fresh
# process does not do that; the cause is not settled)
_ON_CARD = """
import json, sys, torch
sys.path[:0] = sys.argv[1:]
from bench import trace
dev = torch.device("cuda", 0)
a = torch.randn(4096, 4096, device=dev)
torch.cuda.synchronize()
with trace.profiled(dev) as prof:
    with torch.profiler.record_function(trace.STRETCH):
        for _ in range(3):
            a = torch.tanh(a @ a)
            torch.cuda.synchronize()
s = trace.summarize(prof, 3)
print(json.dumps(None if s is None else s.__dict__))
"""


@pytest.mark.cuda
def test_stretch_on_the_card(card):
    p = subprocess.run([sys.executable, "-c", _ON_CARD, str(ROOT)],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    s = json.loads(p.stdout.strip().splitlines()[-1])
    assert s is not None and 0 < s["busy_s"] <= s["window_s"]
    assert sum(s["device_ops"].values()) >= s["busy_s"] * 0.99
    assert sum(s["idle_gaps"].values()) == pytest.approx(
        s["window_s"] - s["busy_s"], rel=1e-6, abs=1e-9)
