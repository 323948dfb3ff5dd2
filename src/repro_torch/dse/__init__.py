"""Declarative design-space-exploration facade of the PyTorch port.

  * `Objective`  — what "better" means: `MaxPerf` (per-app GOPS),
    `PerfPerArea`, `GeomeanAcrossApps` (§5.1 joint selection), or the
    vector-valued `ParetoObjective(["perf", "-area"])` whose scalarization
    (weighted-Chebyshev or 2-D hypervolume contribution) plugs into the
    engines' ask/tell loop while the full front is retained.
  * `Constraint` — what "feasible" means: `AreaBudget`, `PeakBuffers`
    (Eq. 11/13 floors, with batched `repair`), `UserConstraint`.
  * `Study`      — apps x space x objective x constraints x engine x
    `SearchBudget`, with `.run() -> StudyResult` and JSON persistence;
    Pareto studies add the joint front (`FrontPoint`s) and one selection
    per area budget.

CLI: ``python -m repro_torch.dse --apps resnet --apps ptb`` (see
`repro_torch.dse.cli`).  `run_multiapp_study` and the sensitivity radar
(`repro_torch.core.sensitivity`) are thin compositions over `Study`.
"""

from repro_torch.dse.constraints import (AreaBudget, Constraint, PeakBuffers,
                                         UserConstraint, feasible_mask_all)
from repro_torch.dse.objectives import (OBJECTIVES, GeomeanAcrossApps,
                                        MaxPerf, Objective, ParetoObjective,
                                        PerfPerArea, geomean, make_objective)
from repro_torch.dse.parallel import (canonical_front_indices,
                                      merge_pareto_fronts)
from repro_torch.dse.study import FrontPoint, SearchBudget, Study, StudyResult

__all__ = [
    "Objective", "MaxPerf", "PerfPerArea", "GeomeanAcrossApps",
    "ParetoObjective", "OBJECTIVES", "make_objective", "geomean",
    "Constraint", "AreaBudget", "PeakBuffers", "UserConstraint",
    "feasible_mask_all", "Study", "StudyResult", "SearchBudget",
    "FrontPoint", "canonical_front_indices", "merge_pareto_fronts",
    "study_from_cli", "main",
]


def study_from_cli(argv=None):
    """Build a `Study` from command-line flags (lazy import: argparse-only
    consumers shouldn't pay for it)."""
    from repro_torch.dse.cli import study_from_cli as _impl
    return _impl(argv)


def main(argv=None) -> int:
    from repro_torch.dse.cli import main as _impl
    return _impl(argv)
