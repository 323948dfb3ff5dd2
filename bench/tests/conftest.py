"""Tests of the benchmark harness: `python -m pytest bench/tests` from the
repository root (the card's tests, marked `cuda`, skip without a card)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT), str(Path(__file__).parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from _tiny import tiny_root  # noqa: E402


@pytest.fixture
def card():
    """The first CUDA device; the test skips where there is none (decided
    here, when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny(tmp_path):
    """A tiny checkout whose limits pass the port at test widths."""
    return tiny_root(tmp_path, {"limits": {"served_gap": 0.5,
                                           "logit_err": 0.05}})
