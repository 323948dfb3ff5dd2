"""Declarative design-space-exploration facade of the PyTorch port.

  * `Objective`  — what "better" means: `MaxPerf` (per-app GOPS),
    `PerfPerArea`, `GeomeanAcrossApps` (§5.1 joint selection).
  * `Constraint` — what "feasible" means: `AreaBudget`, `PeakBuffers`
    (Eq. 11/13 floors, with batched `repair`), `UserConstraint`.
  * `Study`      — apps x space x objective x constraints x engine x
    `SearchBudget`, with `.run() -> StudyResult` and JSON persistence.

CLI: ``python -m repro_torch.dse --apps resnet --apps ptb`` (see
`repro_torch.dse.cli`).
"""

from repro_torch.dse.constraints import (AreaBudget, Constraint, PeakBuffers,
                                         UserConstraint, feasible_mask_all)
from repro_torch.dse.objectives import (OBJECTIVES, GeomeanAcrossApps,
                                        MaxPerf, Objective, PerfPerArea,
                                        geomean, make_objective)
from repro_torch.dse.study import SearchBudget, Study, StudyResult

__all__ = [
    "Objective", "MaxPerf", "PerfPerArea", "GeomeanAcrossApps",
    "OBJECTIVES", "make_objective", "geomean",
    "Constraint", "AreaBudget", "PeakBuffers", "UserConstraint",
    "feasible_mask_all", "Study", "StudyResult", "SearchBudget",
]
