"""AdamW with global-norm clipping, as pure functions over tensor trees:
the twin of `repro.optim.adamw`.

A tree is nested dicts, lists and tuples of tensors (`torch.utils._pytree`),
the same structure for parameters, gradients and both moments.  Where the
reference donates its buffers to the jitted step, `adamw_update` writes
the parameters and moments in place (under `torch.no_grad`) and returns
the same trees.  Every number is computed as jnp computes it: the bias
corrections `1 - b ** t` with t a float32 tensor, the Python constants
rounded to float32 where they meet a float32 tensor.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

Params = Any

__all__ = ["AdamWState", "adamw_init", "adamw_init_specs", "adamw_update",
           "clip_by_global_norm"]


class AdamWState(NamedTuple):
    step: torch.Tensor         # int32, 0-d
    mu: Params                 # first moment (fp32)
    nu: Params                 # second moment (fp32)


def adamw_init(params: Params) -> AdamWState:
    """Zero moments in fp32 on each parameter's device, step 0."""
    leaves = pytree.tree_leaves(params)
    dev = leaves[0].device if leaves else "cpu"

    def zeros(tree):
        return pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), tree)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros(params), nu=zeros(params))


def adamw_init_specs(param_specs: Params) -> AdamWState:
    """The optimizer state's `(shape, dtype)` leaves from a tree of
    `(shape, dtype)` pairs or `Spec`s (anything with `.shape`)."""
    def spec(p):
        return (tuple(p.shape), torch.float32)

    is_leaf = lambda t: hasattr(t, "shape")   # noqa: E731
    return AdamWState(step=((), torch.int32),
                      mu=pytree.tree_map(spec, param_specs, is_leaf=is_leaf),
                      nu=pytree.tree_map(spec, param_specs, is_leaf=is_leaf))


def _leaves_along(tree: Params, other: Params) -> list:
    """The leaves of `other` in the order of `tree`'s leaves, matched by
    key and index (the two dicts' key orders may differ)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves_along(tree[k], other[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t, o in zip(tree, other)
                for x in _leaves_along(t, o)]
    return [other]


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    """The gradients scaled by `min(1, max_norm / max(norm, 1e-9))` and
    their global L2 norm (fp32, 0-d)."""
    leaves = pytree.tree_leaves(grads)
    sq = sum(torch.sum(torch.square(g.float())) for g in leaves)
    norm = torch.sqrt(sq)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return pytree.tree_map(lambda g: (g.float() * scale).to(g.dtype),
                           grads), norm


def adamw_update(grads: Params, state: AdamWState, params: Params,
                 lr: torch.Tensor, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 max_grad_norm: float = 1.0, decay: Optional[Params] = None
                 ) -> Tuple[Params, AdamWState, torch.Tensor]:
    """One AdamW step after global-norm clipping; returns `(params, state,
    grad_norm)`, the parameters and moments written in place.

    `decay` is a tree of bools beside the parameters: whether a leaf takes
    the decoupled weight decay.  By default a leaf of two dimensions or
    more does (the reference's rule); a model whose layout differs from
    the reference's passes the reference's answer
    (`DecoderLM.decay_mask`)."""
    flat_p = pytree.tree_leaves(params)
    if decay is None:
        flat_d = [p.dim() >= 2 for p in flat_p]
    else:
        flat_d = _leaves_along(params, decay)
    with torch.no_grad():
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        t = step.float()
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        for g, m, v, p, d in zip(pytree.tree_leaves(grads),
                                 pytree.tree_leaves(state.mu),
                                 pytree.tree_leaves(state.nu), flat_p,
                                 flat_d):
            g32 = g.float()
            m_new = b1 * m + (1.0 - b1) * g32
            v_new = b2 * v + (1.0 - b2) * torch.square(g32)
            m_hat = m_new / bc1
            v_hat = v_new / bc2
            delta = m_hat / (torch.sqrt(v_hat) + eps)
            wd = weight_decay if d else 0.0
            p32 = p.float()
            p_new = p32 - lr * (delta + wd * p32)
            p.copy_(p_new)
            m.copy_(m_new)
            v.copy_(v_new)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm
