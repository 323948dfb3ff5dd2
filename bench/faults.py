"""Faults planted under the timed step, each one that a one-card prefill
cell can have: the check has to come out not correct under every one.

Each is a function from the step to a broken step of the same signature.
The tests plant them at test widths (`bench/tests`), and
`bench/control.py --fault-seeds` reads them at a cell's own size.  A
one-card cell has no exchange between cards to leave out.
"""

from __future__ import annotations

import torch

__all__ = ["FAULTS"]


def stale(step):
    """The step returns its first answer again, whatever it is sent."""
    first = []

    def broken(params, batch):
        out = step(params, batch)
        if not first:
            first.append(out)
        return first[0].clone()
    return broken


def half_batch(step):
    """Half of the batch left out: the other half's rows are the mean of
    those computed."""
    def broken(params, batch):
        tok = batch["tokens"]
        half = step(params, {"tokens": tok[:max(1, tok.shape[0] // 2)]})
        rest = half.float().mean(0, keepdim=True).to(half.dtype)
        return torch.cat([half, rest.expand(tok.shape[0] - half.shape[0],
                                            -1)])
    return broken


def altered_answer(step):
    """One prompt's answer altered where it is produced: in the last row
    of each batch, another token's logit raised past the best."""
    def broken(params, batch):
        out = step(params, batch).clone()
        row = out[-1]
        j = (int(row.argmax()) + 1 + int(batch["tokens"][-1, 0])) % 97
        row[j] = row.max() + 1
        return out
    return broken


FAULTS = {"stale": stale, "half_batch": half_batch,
          "altered_answer": altered_answer}
