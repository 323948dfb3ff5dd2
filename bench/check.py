"""The comparison that decides `correct`: served logits against the plain
reference's.

For each prompt compared, with `ref` the reference's last-position
logits over the published vocabulary and `got` the program's:

  served_gap   how far below the reference's best logit lies the logit
               the reference gives the token the program serves (its
               argmax), in units of the standard deviation of `ref`
               over the vocabulary: 0 where both pick the same token
  logit_err    the root mean square of got - ref over the vocabulary, in
               the same units
  logit_maxerr the largest |got - ref| over the vocabulary, in the same
               units: one logit altered shows here

A cell's numbers are the widest of each over the prompts compared and
the median of `logit_err` over them; its limits file
(`bench/checks/<cell>.json`) names which are compared and each one's
limit, and keeps the readings it was set from.  Normalising by the
spread of `ref` makes the numbers independent of the logits' scale, which
the random weights set.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

__all__ = ["prompt_numbers", "cell_numbers", "judge"]


def prompt_numbers(got: torch.Tensor, ref: torch.Tensor) -> List[Dict]:
    """served_gap and logit_err of each row of got, ref [B, V] (fp32)."""
    got, ref = got.double(), ref.double()
    sd = ref.std(dim=-1)
    served = got.argmax(dim=-1)
    gap = (ref.max(dim=-1).values
           - ref.gather(-1, served[:, None])[:, 0]) / sd
    diff = got - ref
    err = diff.square().mean(dim=-1).sqrt() / sd
    worst = diff.abs().amax(dim=-1) / sd
    return [{"served_gap": g, "logit_err": e, "logit_maxerr": w}
            for g, e, w in zip(gap.tolist(), err.tolist(), worst.tolist())]


def cell_numbers(rows: List[Dict]) -> Dict[str, float]:
    """The cell's numbers over the compared prompts' `prompt_numbers`."""
    return {"served_gap": max(r["served_gap"] for r in rows),
            "logit_err": max(r["logit_err"] for r in rows),
            "logit_err_median": statistics.median(r["logit_err"]
                                                  for r in rows),
            "logit_maxerr": max(r["logit_maxerr"] for r in rows)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit, and whether it holds."""
    return {k: {"value": numbers[k], "limit": float(lim),
                "ok": bool(numbers[k] <= lim)}
            for k, lim in limits.items()}
