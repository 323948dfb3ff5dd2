"""Multi-application configuration selection (paper §5.1, Tables 4-5):
the application record `AppSpec` and the selection result
`MultiAppResult`.

The pipeline — per-app DSE, top-10 % candidates per app, cross-evaluation
of every candidate on every app, geometric-mean selection, Table 4/5
report — lives in `repro_torch.dse.Study._synthesize_geomean`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.costmodel import AccelConfig, OpStream
from repro_torch.core.graph import ComputationGraph
from repro_torch.core.search.base import SearchResult

__all__ = ["AppSpec", "MultiAppResult"]


@dataclasses.dataclass
class AppSpec:
    name: str
    stream: OpStream
    peak_weight_bits: int = 0
    peak_input_bits: int = 0

    @staticmethod
    def from_graph(name: str, graph: ComputationGraph,
                   weight_peak_mode: str = "streaming") -> "AppSpec":
        """`weight_peak_mode`:
        "strict"    — Eq. (11) verbatim: the weight buffer must hold the
                      largest layer's full weights.
        "streaming" — weights stream from DRAM tile-by-tile, so the hard
                      floor is the tile bound Eq. (10) (the activation peak
                      Eq. (13) stays strict: intermediates must reside).
        The strict reading makes per-app-optimal configs invalid on every
        other app whenever one app has a giant FC layer (fasterRCNN's fc6),
        which degenerates the paper's Table 4 cross-evaluation."""
        if weight_peak_mode not in ("strict", "streaming"):
            raise ValueError(f"weight_peak_mode must be 'strict' or "
                             f"'streaming', got {weight_peak_mode!r}")
        prof = graph.memory_profile()
        pw = prof.peak_weight_bits if weight_peak_mode == "strict" else 0
        return AppSpec(name=name, stream=graph.op_stream(),
                       peak_weight_bits=pw,
                       peak_input_bits=prof.peak_activation_bits)

    @staticmethod
    def from_app(name: str,
                 weight_peak_mode: str = "streaming") -> "AppSpec":
        """Resolve a `build_app` name (one of the seven hand-built §5.1
        graphs or a traced `<arch>:<variant>` zoo workload) under either
        Eq. 10/11 weight-peak reading."""
        from repro_torch.core.apps import build_app
        return AppSpec.from_graph(name, build_app(name),
                                  weight_peak_mode=weight_peak_mode)


@dataclasses.dataclass
class MultiAppResult:
    apps: List[str]
    best_per_app: Dict[str, AccelConfig]          # per-DNN-best config
    best_perf_per_app: Dict[str, float]           # its GOPS on its own app
    selected: AccelConfig                          # geomean winner
    # perf_matrix[i, j] = GOPS of column config j on app i; columns are
    # [best_on_app_0, ..., best_on_app_{n-1}, selected]  (Table 4 layout)
    perf_matrix: np.ndarray
    normalized_matrix: np.ndarray                  # rows normalized to best
    geomeans: np.ndarray                           # per column
    improvements: np.ndarray                       # Table 5 (over each best)
    improvements_valid: np.ndarray                 # Table 5b (vs valid best)
    candidates_per_app: Dict[str, List[AccelConfig]]
    greedy_results: Dict[str, SearchResult]   # per-app DSE result (any engine)

    def table4(self) -> str:
        hdr = ["app"] + [f"best_on_{a}" for a in self.apps] + ["selected"]
        lines = ["\t".join(hdr)]
        for i, app in enumerate(self.apps):
            row = [app] + [f"{v:.2f}" for v in self.normalized_matrix[i]]
            lines.append("\t".join(row))
        lines.append("\t".join(["geomean"] +
                               [f"{v:.2f}" for v in self.geomeans]))
        return "\n".join(lines)

    def table5(self) -> str:
        hdr = [f"over_best_{a}" for a in self.apps]
        vals = [f"{100.0 * v:.1f}%" for v in self.improvements]
        return "\t".join(hdr) + "\n" + "\t".join(vals)

