"""Architecture registry: ``--arch <id>`` resolution for the launcher.

Every assigned architecture has its own module exporting:
  ARCH   — the exact assigned configuration
  SMOKE  — a reduced same-family configuration for CPU smoke tests
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from repro_torch.models.config import ArchConfig
from repro_torch.configs.shapes import SHAPES, ShapeSpec, shape_by_name

_MODULES: Dict[str, str] = {
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
}

ARCH_NAMES: Tuple[str, ...] = tuple(_MODULES.keys())


def get_arch(name: str) -> ArchConfig:
    return importlib.import_module(_MODULES[name]).ARCH


def get_smoke(name: str) -> ArchConfig:
    return importlib.import_module(_MODULES[name]).SMOKE


def cells() -> List[Tuple[str, ShapeSpec]]:
    """All 40 (architecture x shape) cells, with applicability flags."""
    return [(a, s) for a in ARCH_NAMES for s in SHAPES]


def cell_applicable(arch_name: str, shape: ShapeSpec) -> Tuple[bool, str]:
    arch = get_arch(arch_name)
    if shape.needs_sub_quadratic and not arch.sub_quadratic:
        return False, ("full-attention architecture: 500k dense KV decode "
                       "is quadratic-cost with no sub-quadratic path "
                       "(see DESIGN.md §Arch-applicability)")
    return True, ""


__all__ = ["ARCH_NAMES", "get_arch", "get_smoke", "cells", "cell_applicable",
           "SHAPES", "shape_by_name"]
