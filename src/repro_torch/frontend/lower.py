"""Lowering rules: aten calls -> Table-1 operation embeddings.

The twin of `repro.frontend.lower`, keyed by aten overload-packet names
instead of jaxpr primitives:

  * ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` -> the ``dot_general`` rule:
    `Op.matmul` (a row block > 1) or `Op.matvec` (a single activation
    row); the ``bmm`` batch (attention heads) becomes `repeat`.
  * ``convolution``  -> the ``conv_general_dilated`` rule: CONV2D /
    CHANNEL_MIXING (1x1) / DEPTHWISE_CONV, grouped convs as `repeat`ed
    per-group convs; NCHW input and OIHW weight, as aten lays them out.
  * everything else  -> no rule: the tracer records a data-only node (or
    aliases a size-preserving op onto its producer).

A rule receives the call's arguments, one `OperandInfo` per argument
(None where the argument is not a tensor), the output shape and a
fresh-name factory; it returns a `Lowered` record or None.  The
parameter bits of the graph vertex are attached by the tracer's claim
mechanism, not by the rule.

Row orientation.  When the weight is the left operand the activation
still gives the rows, as in the reference.  When both operands are
activations the reference takes the rows from ``dot_general``'s lhs, and
for a two-operand ``jnp.einsum`` that lhs is the operand that spares a
transpose of the output — for attention's scores and values the *second*
one, where ``torch.einsum`` puts the first on the left.  The tracer
therefore runs a two-operand ``torch.einsum`` as ``jnp.einsum`` lowers it
(`trace._dot_general_einsum`), and the rule here reads the rows from the
left operand, as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.costmodel import Op, OpKind

__all__ = ["Lowered", "OperandInfo", "LOWERING_RULES", "register_lowering",
           "lower_call"]


@dataclasses.dataclass(frozen=True)
class OperandInfo:
    """What a lowering rule may know about one call operand."""

    shape: Tuple[int, ...]
    elems: int
    is_weight: bool        # parameter / captured constant
    is_activation: bool    # tracked activation node exists for it


@dataclasses.dataclass(frozen=True)
class Lowered:
    """One costable operation produced by a lowering rule."""

    op: Op


LoweringRule = Callable[..., Optional[Lowered]]

LOWERING_RULES: Dict[str, LoweringRule] = {}


def register_lowering(*names: str):
    """Decorator: install a rule for the aten overload packets `names`
    (last registration wins)."""

    def deco(fn: LoweringRule) -> LoweringRule:
        for name in names:
            LOWERING_RULES[name] = fn
        return fn

    return deco


def lower_call(name: str, args: Sequence, operands: Sequence[
        Optional[OperandInfo]], out_shape: Tuple[int, ...], fresh_name,
        bit_width: int) -> Optional[Lowered]:
    """Dispatch an aten call through the registry; None when no rule
    applies."""
    rule = LOWERING_RULES.get(name)
    if rule is None:
        return None
    return rule(name, args, operands, out_shape, fresh_name, bit_width)


# ------------------------------------------------------- the matmul family

@register_lowering("mm", "bmm", "addmm", "baddbmm")
def _lower_matmul(name, args, operands, out_shape, fresh_name, bit_width):
    """`[inst,] M x K` times `[inst,] K x N` -> Table 1 rows 4/5, by the
    reference's ``dot_general`` rule: the activation's free dimension is
    the row block, the weight's the column block, the contraction `nif`,
    the batch `repeat`; a single row is the matrix-vector case."""
    lhs, rhs = (operands[1], operands[2]) if name in ("addmm", "baddbmm") \
        else (operands[0], operands[1])
    inst = lhs.shape[0] if len(lhs.shape) == 3 else 1
    k = lhs.shape[-1]
    lhs_free, rhs_free = lhs.shape[-2], rhs.shape[-1]
    if lhs.is_weight and not rhs.is_weight:
        m, n = rhs_free, lhs_free           # W @ x: the activation's rows
    else:
        m, n = lhs_free, rhs_free
    if min(m, n) == 1:
        op = Op.batched_matvec(col=k, row=max(m, n), instances=inst,
                               name=fresh_name("matvec"))
    else:
        op = Op.batched_matmul(col1=k, row1=m, col2=n, instances=inst,
                               name=fresh_name("matmul"))
    return Lowered(op=op)


# ------------------------------------------------------------- convolution

@register_lowering("convolution")
def _lower_conv(name, args, operands, out_shape, fresh_name, bit_width):
    """2-D (or 1-D) convolution -> Table 1 rows 1-3, by the reference's
    ``conv_general_dilated`` rule: `groups == Nif` with one filter per
    channel is depthwise (Nof = 1, repeat = channels), other grouped
    convs cost one per-group conv repeated `groups` times, 1x1 kernels
    are channel mixing."""
    lhs, rhs = operands[0], operands[1]
    stride, groups = args[3], int(args[8])
    batch, cin = int(lhs.shape[0]), int(lhs.shape[1])
    cout = int(rhs.shape[0])

    def dim2(xs: List[int]) -> Tuple[int, int]:
        xs = [int(x) for x in xs]
        return (xs[0], xs[1]) if len(xs) >= 2 else (xs[0], 1)

    nix, niy = dim2(lhs.shape[2:])
    nkx, nky = dim2(rhs.shape[2:])
    nox, noy = dim2(out_shape[2:])
    s = int(stride[0]) if stride else 1

    if groups == cin and cout == cin:
        op = Op(OpKind.DEPTHWISE_CONV, 1, nix, niy, nkx, nky, 1, nox, noy,
                s, batch, fresh_name("dwconv"), repeat=cin)
    elif groups > 1:
        op = Op(OpKind.CONV2D, cin // groups, nix, niy, nkx, nky,
                cout // groups, nox, noy, s, batch,
                fresh_name("groupconv"), repeat=groups)
    elif nkx == 1 and nky == 1:
        op = Op(OpKind.CHANNEL_MIXING, cin, nix, niy, 1, 1, cout, nox, noy,
                s, batch, fresh_name("chmix"))
    else:
        op = Op(OpKind.CONV2D, cin, nix, niy, nkx, nky, cout, nox, noy,
                s, batch, fresh_name("conv"))
    return Lowered(op=op)
