"""Multi-application configuration selection (paper §5.1, Tables 4-5).

Pipeline:
  1. per application: run the multi-step greedy DSE (with restarts), keep
     every evaluated configuration and its performance;
  2. select the configurations with top-10 % performance per application as
     candidates ("We select the obtained architectural configurations with
     top 10% performance for each DNN application");
  3. cross-evaluate every candidate on every application (vectorized);
  4. pick the candidate with the highest **geometric mean** performance
     across applications (Table 4's "Selected optimized result");
  5. report per-application normalized performance (Table 4) and the
     geomean improvement of the selection over each per-app best (Table 5).

The pipeline lives in `repro_torch.dse.Study._synthesize_geomean`;
`run_multiapp_study` is its historical signature.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.costmodel import AccelConfig, OpStream
from repro_torch.core.graph import ComputationGraph
from repro_torch.core.search.base import SearchResult
from repro_torch.core.space import DesignSpace

__all__ = ["AppSpec", "MultiAppResult", "run_multiapp_study"]


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


def run_multiapp_study(
    specs: Sequence[AppSpec],
    space: DesignSpace,
    k: int = 3,
    restarts: int = 4,
    seed: int = 0,
    top_frac: float = 0.10,
    max_candidates_per_app: int = 200,
    max_rounds: int = 40,
    engine="greedy",
    engine_kwargs: Optional[Dict] = None,
    device="cuda",
) -> MultiAppResult:
    """Thin composition over the declarative `repro_torch.dse.Study`
    facade: per-app DSE (steps 1-2), cross-evaluation (step 3), and the
    `GeomeanAcrossApps` selection + Table 4/5 synthesis (steps 4-5), all
    on `device`.

    `engine` selects the per-app DSE strategy by name or factory
    ("greedy" | "anneal" | "genetic" | "random" | "tpe" | "nsga2", see
    `repro_torch.core.search`); the default reproduces the paper's
    multi-step greedy pipeline."""
    from repro_torch.dse import GeomeanAcrossApps, SearchBudget, Study

    study = Study(apps=list(specs), space=space,
                  objective=GeomeanAcrossApps(), engine=engine,
                  budget=SearchBudget(k=k, restarts=restarts,
                                      max_rounds=max_rounds,
                                      engine_kwargs=dict(engine_kwargs
                                                         or {})),
                  seed=seed, top_frac=top_frac,
                  max_candidates_per_app=max_candidates_per_app,
                  name="multiapp", device=device)
    result = study.run()
    assert result.multiapp is not None
    return result.multiapp
