"""Graph capture: a PyTorch callable -> `ComputationGraph`, through a
`TorchDispatchMode` over meta tensors.

The twin of `repro.frontend.trace`.  `trace_to_graph` runs the callable on
meta-device inputs (shapes and dtypes only: nothing is allocated, so a
32B-parameter model traces in seconds; `FakeTensor` CPU inputs give the
same graph in twice the time), sees every aten call below autograd, and
rebuilds the data-dependency DAG by the reference's three rules:

  * compute calls (see `frontend.lower`) become `Op` vertices carrying the
    Table-1 loop bounds plus the parameter bits they claim;
  * parameters (the `weight_argnums` pytrees) and captured constants never
    become activation vertices: each parameter's bits are claimed once, at
    its first consumer; a call on parameters alone stays in weight-land
    and passes the unclaimed bits on to its result;
  * a single-parent call that keeps the element count (casts, views,
    activation functions) is aliased onto its producer; anything else
    becomes a data-only vertex, so liveness (Fig. 5) sees it.

Where aten is not a jaxpr, the tracer does what the reference's jaxpr
does:

  * *in-place writes* (``copy_`` into a slice of a KV cache,
    ``index_copy_``, ...) give the written tensor's base a new version: a
    data vertex of the base's full size with the old base, the written
    value and the indices as parents, as ``dynamic_update_slice`` makes one.
    A slice vertex made only to be written through is dropped;
  * *factory calls* (``zeros``, ``full``, ``arange``, ``empty``) make
    parentless data vertices, as the reference's ``iota`` and broadcast
    literals do; a 0-d one (a wrapped Python scalar) is a literal;
  * *captured constants* count as weight bits, as a jaxpr's constvars do:
    ``torch.tensor`` data (``lift_fresh``, a literal when 0-d) and
    ``arange`` with a step (``jnp.arange`` with a step is computed in
    numpy and captured);
  * *unbind* (iterating over a stacked tensor) gives each piece its share
    of the unclaimed bits, as a scan over stacked weights does;
  * in a Python loop that plays a scan (`scan_repeats`), a captured
    constant made after the first repeat claims no bits: a scan's body
    closes over one copy of it;
  * ``masked_fill(x, mask, v)`` takes its parents in the order of the
    reference's ``where(mask, v, x)``: the mask first;
  * a two-operand ``torch.einsum`` runs as ``jnp.einsum`` lowers it (one
    product, its operands in ``dot_general``'s order), so a product of two
    activations has the reference's rows;
  * ``_softmax`` is ``jax.nn.softmax``'s four vertices: the row max,
    ``x - max`` (its ``exp`` aliased), the row sum and the quotient;
  * ``F.one_hot`` and ``torch.take_along_dim`` are one vertex each over
    their arguments, as the nested ``jit`` of ``jax.nn.one_hot`` and
    ``jnp.take_along_axis`` is in the reference's tracer, and so is a
    function passed to `nested_jit` (``jnp.var``'s twin);
  * ``index_put_`` with several index tensors is jnp's ``x.at[i, j].set``:
    the indices broadcast (a vertex where that grows one) and
    concatenated, then the scatter over the old base, the stacked index
    and the value;
  * in a Python loop that plays a scan over stacked xs (`scan_slices`),
    each step's slice of an activation is a data vertex, whatever its
    size, as the reference's scan makes one; the steps' outputs stacked
    (`scan_stack`) are one data vertex over them, even of one step;
  * an integer index from the end (`index_from_end`) is jnp's: the index
    normalised on literals (``lt``, ``add``, ``select_n``: three
    one-element vertices) and a ``dynamic_slice`` over the tensor and it;
  * a slice at a traced position (`dynamic_slice_in_dim`) is one
    ``dynamic_slice`` vertex over the tensor and the position;
  * a scan step's slice of its xs is a copy: a write into it (a stacked
    KV cache's layer) is a new version of the slice, not of the stack;
  * calls with no tensor result (``prim.device`` and the like) are skipped.

The traced tensors are kept alive for the whole trace: bindings are keyed
by `id`, which must not be reused.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import _pytree as pytree

from repro_torch.core.graph import ComputationGraph
from repro_torch.frontend.lower import OperandInfo, lower_call

__all__ = ["trace_to_graph", "scan_repeats", "scan_slices", "scan_stack",
           "index_from_end", "dynamic_slice_in_dim", "nested_jit", "node_of",
           "tracing", "GraphTracer", "DEFAULT_BIT_WIDTH"]

# The DSE datapath is quantized (§5: 8-bit dynamic-precision); traced
# tensors are costed at this width regardless of their torch dtype.
DEFAULT_BIT_WIDTH = 8

# factory calls whose result is a captured constant, not an iota-like
# data vertex (see the module note)
_CONSTANT_FACTORIES = ("lift_fresh", "lift_fresh_copy")

# calls whose first two tensor operands the reference's jaxpr takes the
# other way round: masked_fill(x, mask, v) is its where(mask, v, x)
_MASK_FIRST = ("masked_fill",)

# the tracers of the `trace_to_graph` calls running, innermost last
_ACTIVE: List["GraphTracer"] = []


@dataclasses.dataclass
class _Binding:
    """What the tracer knows about one tensor.

    node         — activation vertex in the graph (None if untracked)
    is_weight    — parameter / captured constant (never an activation)
    elems        — element count (alias decisions)
    pending_bits — unclaimed parameter bits (claimed by the first consumer)
    """

    node: Optional[str] = None
    is_weight: bool = False
    elems: int = 0
    pending_bits: int = 0


def _packet(func) -> str:
    return func.overloadpacket.__name__


def _dot_general_einsum(eq: str, a: torch.Tensor, b: torch.Tensor
                        ) -> Optional[torch.Tensor]:
    """`torch.einsum(eq, a, b)` as `jnp.einsum` lowers it: one
    ``dot_general`` whose lhs is `a` when its output (batch, `a`'s free,
    `b`'s free) is already in `eq`'s output order, and `b` otherwise (then
    transposed), each operand permuted to [batch, free, contracted] (lhs)
    or [batch, contracted, free] (rhs).  `torch.einsum` picks its own
    operand order, which for attention's scores and values is the other
    one.  None for an equation outside that form (a repeated or summed-out
    index, an ellipsis)."""
    if "->" not in eq or "." in eq:
        return None
    ins, out = eq.replace(" ", "").split("->")
    sa, sb = ins.split(",")
    if len(set(sa)) < len(sa) or len(set(sb)) < len(sb) or \
            any(c not in sb and c not in out for c in sa) or \
            any(c not in sa and c not in out for c in sb):
        return None
    batch = [c for c in out if c in sa and c in sb]
    contr = [c for c in sa if c in sb and c not in out]
    free_a = [c for c in sa if c not in sb]
    free_b = [c for c in sb if c not in sa]
    if batch + free_a + free_b != list(out):
        a, b, sa, sb, free_a, free_b = b, a, sb, sa, free_b, free_a
    dims = {**dict(zip(sa, a.shape)), **dict(zip(sb, b.shape))}

    def size(cs):
        n = 1
        for c in cs:
            n *= dims[c]
        return n

    lhs = a.permute([sa.index(c) for c in batch + free_a + contr]).reshape(
        size(batch), size(free_a), size(contr))
    rhs = b.permute([sb.index(c) for c in batch + contr + free_b]).reshape(
        size(batch), size(contr), size(free_b))
    order = batch + free_a + free_b
    res = torch.bmm(lhs, rhs).reshape([dims[c] for c in order])
    return res.permute([order.index(c) for c in out])


# torch functions whose jnp twins run as one nested `jit`, which the
# reference's tracer makes one data vertex over the call's arguments (its
# call primitives do not include jax 0.9's "jit")
_ONE_CALL = {torch.take_along_dim: "takealong",
             torch.nn.functional.one_hot: "onehot"}


class _FunctionForms(TorchFunctionMode):
    """Run each two-operand `torch.einsum` as `_dot_general_einsum`, so a
    product of two activations reaches aten with the reference's rows
    (see `frontend.lower`); record each `_ONE_CALL` function as one
    vertex (`GraphTracer.one_call`)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.einsum and len(args) == 3 and not kwargs and \
                isinstance(args[0], str):
            out = _dot_general_einsum(*args)
            if out is not None:
                return out
        if func in _ONE_CALL and _ACTIVE:
            return _ACTIVE[-1].one_call(_ONE_CALL[func], func, args,
                                        kwargs or {})
        return func(*args, **(kwargs or {}))


class GraphTracer(TorchDispatchMode):
    """Stateful aten-call -> ComputationGraph recorder."""

    def __init__(self, name: str = "traced",
                 bit_width: int = DEFAULT_BIT_WIDTH):
        super().__init__()
        self.graph = ComputationGraph()
        self.prefix = name
        self.bw = bit_width
        self._n = 0
        self._inputs = 0
        self._env: Dict[int, _Binding] = {}
        self._keep: List[torch.Tensor] = []     # ids must not be reused
        self._view_nodes: Set[str] = set()      # vertices of sliced views
        self._repeat = 0                        # see `scan_repeats`
        self._paused = False                    # see `xslice`

    # ----------------------------------------------------------- bookkeeping
    def _fresh(self, tag: str) -> str:
        self._n += 1
        return f"{self.prefix}/{tag}_{self._n}"

    def bind(self, t: torch.Tensor, b: _Binding) -> None:
        self._env[id(t)] = b
        self._keep.append(t)

    def read(self, t: torch.Tensor) -> _Binding:
        b = self._env.get(id(t))
        return b if b is not None else _Binding(elems=t.numel())

    def _data_node(self, tag: str, elems: int, parents: Sequence[str],
                   weight_bits: int = 0) -> str:
        return self.graph.add(self._fresh(tag), None, elems * self.bw,
                              weight_bits, list(parents))

    def weight_binding(self, elems: int) -> _Binding:
        return _Binding(None, True, elems, pending_bits=elems * self.bw)

    def input_node(self, elems: int) -> _Binding:
        self._inputs += 1
        node = self.graph.add(f"{self.prefix}/input_{self._inputs}", None,
                              elems * self.bw)
        return _Binding(node, False, elems)

    @staticmethod
    def _claim(bindings: Sequence[_Binding]) -> int:
        total = 0
        for b in bindings:
            if b.is_weight and b.pending_bits:
                total += b.pending_bits
                b.pending_bits = 0
        return total

    @staticmethod
    def _act_parents(bindings: Sequence[_Binding]) -> List[str]:
        out: List[str] = []
        for b in bindings:
            if b.node is not None and b.node not in out:
                out.append(b.node)
        return out

    # ------------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if not outs or self._paused:    # queries: prim.device, item, ...
            return out
        name = _packet(func)
        flat = pytree.tree_leaves((args, kwargs))
        ins = [a for a in flat if isinstance(a, torch.Tensor)]
        written = self._written(func, args, kwargs)
        if written:
            self._eval_write(name, written, ins, args)
        elif name == "_softmax" and self.read(ins[0]).node is not None:
            self._eval_softmax(ins[0], args[1], outs[0])
        elif not ins or name in _CONSTANT_FACTORIES:
            self._eval_factory(func, name, outs)
        else:
            if name in _MASK_FIRST:
                ins = ins[1:2] + ins[:1] + ins[2:]
            view = any(r.alias_info is not None
                       for r in func._schema.returns)
            self._eval(name, args, ins, outs, view)
        return out

    @staticmethod
    def _written(func, args, kwargs) -> List[torch.Tensor]:
        """The tensors an in-place call writes."""
        out = []
        for i, a in enumerate(func._schema.arguments):
            info = a.alias_info
            if info is None or not info.is_write:
                continue
            v = args[i] if i < len(args) else kwargs.get(a.name)
            if isinstance(v, torch.Tensor):
                out.append(v)
        return out

    def _eval_factory(self, func, name: str, outs) -> None:
        for t in outs:
            if t.dim() == 0:
                continue                # a wrapped Python scalar: literal
            if name in _CONSTANT_FACTORIES or (
                    name == "arange" and func._overloadname == "start_step"):
                b = self.weight_binding(t.numel())
                if self._repeat:
                    b.pending_bits = 0  # the first repeat's copy claimed
                self.bind(t, b)
            else:
                tag = name.replace("_", "")[:12] or "data"
                self.bind(t, _Binding(self._data_node(tag, t.numel(), []),
                                      False, t.numel()))

    def _eval_write(self, name: str, written, ins, args) -> None:
        """A new version of each written tensor's base: a data vertex of
        the base's size over the old base, the value and the indices.  An
        `index_put_` with several index tensors is the reference's
        ``x.at[i, j].set(v)``: a scatter over the old base, the indices
        stacked into one (`_stacked_index`) and the value."""
        for t in written:
            base = t._base if t._base is not None else t
            old, view = self.read(base), self.read(t)
            if view.node in self._view_nodes and not any(
                    view.node in n.parents for n in self.graph.nodes.values()):
                self._drop(view.node)   # a slice made to be written through
            if name.rstrip("_") == "index_put" and sum(
                    isinstance(i, torch.Tensor) for i in args[1]) > 1:
                others = [self._stacked_index(args[1]), self.read(args[2])]
            else:
                others = [self.read(a) for a in reversed(ins) if a is not t]
            parents = self._act_parents([old] + others)
            node = self._data_node(name.replace("_", "")[:12], base.numel(),
                                   parents, self._claim(others))
            self.bind(base, _Binding(node, False, base.numel()))
            if t is not base and t.numel() == base.numel():
                self.bind(t, _Binding(node, False, t.numel()))

    def _eval_softmax(self, x: torch.Tensor, dim: int,
                      out: torch.Tensor) -> None:
        """`jax.nn.softmax`'s vertices: the row max, `x - max` (its `exp`
        aliased), the row sum and the quotient."""
        src = self.read(x).node
        rows = x.numel() // max(x.shape[dim] if x.dim() else 1, 1)
        mx = self._data_node("reducemax", rows, [src])
        sub = self._data_node("sub", x.numel(), [src, mx])
        total = self._data_node("reducesum", rows, [sub])
        div = self._data_node("div", x.numel(), [sub, total])
        self.bind(out, _Binding(div, False, out.numel()))

    def _stacked_index(self, indices) -> _Binding:
        """jnp's advanced-indexing scatter index: each index array
        broadcast to the common shape (a vertex where that grows it), the
        arrays concatenated into one."""
        idx = [i for i in indices if isinstance(i, torch.Tensor)]
        n = math.prod(torch.broadcast_shapes(*(i.shape for i in idx)))
        parts: List[str] = []
        for i in idx:
            b = self.read(i)
            if i.numel() != n:
                parts.append(self._data_node("broadcastind", n,
                                             self._act_parents([b])))
            elif b.node is not None:
                parts.append(b.node)
        node = self._data_node("concatenate", n * len(idx), parts)
        return _Binding(node, False, n * len(idx))

    def one_call(self, tag: str, func, args, kwargs) -> torch.Tensor:
        """`func(*args, **kwargs)` recorded as one call over its tensor
        arguments (the reference's nested `jit`), by the data rule."""
        self._paused = True
        try:
            out = func(*args, **kwargs)
        finally:
            self._paused = False
        ins = [a for a in pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        self._eval_data(tag, [self.read(a) for a in ins], [out], False)
        return out

    def xslice(self, xs: torch.Tensor, i: int) -> torch.Tensor:
        """`xs[i]` as a scan's step sees its slice of the stacked `xs`: an
        activation's slice is a data vertex over it, whatever its size; a
        weight's slice takes its share of the unclaimed bits."""
        self._paused = True
        try:
            # a copy, not a view: a write into it is a new version of the
            # slice, as the reference's step writes its own slice
            piece = xs[i].clone()
        finally:
            self._paused = False
        b = self.read(xs)
        if b.node is None:
            share = _Binding(None, b.is_weight, piece.numel(),
                             pending_bits=b.pending_bits // xs.shape[0])
            self.bind(piece, share)
        else:
            node = self._data_node("xslice", piece.numel(), [b.node])
            self.bind(piece, _Binding(node, False, piece.numel()))
        return piece

    def stacked(self, ys: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """`torch.stack(ys, dim)` as a scan stacks its steps' outputs: one
        data vertex over the steps' vertices, whatever their number."""
        self._paused = True
        try:
            out = torch.stack(list(ys), dim)
        finally:
            self._paused = False
        parents = self._act_parents([self.read(y) for y in ys])
        node = self._data_node("stack", out.numel(), parents)
        self.bind(out, _Binding(node, False, out.numel()))
        return out

    def from_end(self, x: torch.Tensor, dim: int, i: int) -> torch.Tensor:
        """`x.select(dim, i)`, i < 0, as jnp traces ``x[..., i]``: the
        index normalised on literals (`i < 0`, `i + n`, the select: one-
        element vertices, the third over the first two), then a
        ``dynamic_slice`` over x and the index (its squeeze aliased)."""
        self._paused = True
        try:
            piece = x.select(dim, i)
        finally:
            self._paused = False
        lt = self._data_node("lt", 1, [])
        add = self._data_node("add", 1, [])
        sel = self._data_node("selectn", 1, [lt, add])
        node = self._data_node("dynamicslice", piece.numel(),
                               self._act_parents([self.read(x)]) + [sel])
        self.bind(piece, _Binding(node, False, piece.numel()))
        return piece

    def dynamic_slice(self, x: torch.Tensor, start: torch.Tensor,
                      size: int, dim: int) -> torch.Tensor:
        """`size` rows of x along `dim` from the 0-d tensor `start`, as
        jax traces ``lax.dynamic_slice_in_dim``: its index normalisation
        on `start` alone aliases onto it, so one ``dynamic_slice`` vertex
        over x (or x's bits, a weight's) and `start`."""
        self._paused = True
        try:
            piece = x.narrow(dim, 0, size).clone()
        finally:
            self._paused = False
        bx = self.read(x)
        node = self._data_node("dynamicslice", piece.numel(),
                               self._act_parents([bx, self.read(start)]),
                               self._claim([bx]))
        self.bind(piece, _Binding(node, False, piece.numel()))
        return piece

    def _drop(self, node: str) -> None:
        del self.graph.nodes[node]
        self.graph._order.remove(node)

    def _eval(self, name: str, args, ins, outs, view: bool) -> None:
        bindings = [self.read(a) for a in ins]
        any_act = any(b.node is not None for b in bindings)
        any_weight = any(b.is_weight for b in bindings)
        lowered = None
        if len(outs) == 1 and (any_act or not any_weight):
            info = {id(a): OperandInfo(tuple(a.shape), a.numel(), b.is_weight,
                                       b.node is not None)
                    for a, b in zip(ins, bindings)}
            operands = [info.get(id(a)) if isinstance(a, torch.Tensor)
                        else None for a in args]
            lowered = lower_call(name, args, operands,
                                 tuple(outs[0].shape), self._fresh, self.bw)
        if lowered is not None:
            node = self.graph.add(lowered.op.name, lowered.op,
                                  outs[0].numel() * self.bw,
                                  self._claim(bindings),
                                  self._act_parents(bindings))
            self.bind(outs[0], _Binding(node, False, outs[0].numel()))
            return
        self._eval_data(name, bindings, outs, view)

    def _eval_data(self, name: str, bindings: List[_Binding],
                   outs: List[torch.Tensor], view: bool) -> None:
        parents = self._act_parents(bindings)
        if not parents and any(b.is_weight for b in bindings):
            # parameter-only computation stays in weight-land; `unbind`
            # shares the unclaimed bits out, anything else passes them on
            pending = self._claim(bindings)
            share = name == "unbind"
            for i, t in enumerate(outs):
                b = _Binding(None, True, t.numel())
                if share:
                    b.pending_bits = pending // len(outs)
                elif i == 0:
                    b.pending_bits = pending
                self.bind(t, b)
            return
        if len(outs) == 1 and len(parents) == 1:
            src = next(b for b in bindings if b.node == parents[0])
            if outs[0].numel() == src.elems:
                claimed = self._claim(bindings)
                if claimed:
                    self.graph.nodes[parents[0]].weight_bits += claimed
                self.bind(outs[0], _Binding(parents[0], False,
                                            outs[0].numel()))
                return
        tag = name.replace("_", "")[:12] or "data"
        w_bits = self._claim(bindings)
        for t in outs:
            node = self._data_node(tag, t.numel(), parents, w_bits)
            w_bits = 0                  # attach once (first output vertex)
            if view and len(outs) == 1:
                self._view_nodes.add(node)
            self.bind(t, _Binding(node, False, t.numel()))


# ---------------------------------------------------------------- front door

def scan_repeats(n: int) -> Iterator[int]:
    """`range(n)` for a Python loop that plays a scan over `n` repeats of
    one body (the reference scans a layer group's repeats).  Under
    `trace_to_graph`, the captured constants made in the repeats after the
    first claim no bits, as the one copy a scan's body closes over is
    claimed once; elsewhere it is `range(n)`."""
    tracer = _ACTIVE[-1] if _ACTIVE else None
    saved = tracer._repeat if tracer else 0
    try:
        for r in range(n):
            if tracer:
                tracer._repeat = saved + r     # nonzero: not the first
            yield r
    finally:
        if tracer:
            tracer._repeat = saved


def scan_slices(*xs: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """`zip(*xs)` for a Python loop that plays a scan over the leading
    dimension of `xs` (the reference scans its stacked xs).  Under
    `trace_to_graph` each step's slice of an activation is one data vertex
    over the stacked tensor (`GraphTracer.xslice`), as the reference's scan
    makes one per step and operand even where the slice is the whole;
    elsewhere it is `zip(*xs)`."""
    tracer = _ACTIVE[-1] if _ACTIVE else None
    for i in range(xs[0].shape[0]):
        if tracer is None:
            yield tuple(x[i] for x in xs)
        else:
            yield tuple(tracer.xslice(x, i) for x in xs)


def scan_stack(ys: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """`torch.stack(ys, dim)` for the outputs of a Python loop that plays a
    scan (the reference's scan stacks its ys).  Under `trace_to_graph` the
    stack is one data vertex over the steps' vertices
    (`GraphTracer.stacked`), as the reference's scan makes one even for a
    single step; elsewhere it is `torch.stack`."""
    if _ACTIVE:
        return _ACTIVE[-1].stacked(ys, dim)
    return torch.stack(list(ys), dim)


def index_from_end(x: torch.Tensor, dim: int, i: int) -> torch.Tensor:
    """`x.select(dim, i)` for an index from the end (`i < 0`), which jnp
    traces as a `dynamic_slice` at an index normalised on literals.  Under
    `trace_to_graph` it makes those vertices (`GraphTracer.from_end`);
    elsewhere it is `x.select(dim, i)`."""
    assert i < 0, i
    if _ACTIVE:
        return _ACTIVE[-1].from_end(x, dim, i)
    return x.select(dim, i)


def dynamic_slice_in_dim(x: torch.Tensor, start: torch.Tensor, size: int,
                         dim: int = 0) -> torch.Tensor:
    """`jax.lax.dynamic_slice_in_dim(x, start, size, dim)` at a 0-d device
    tensor `start`, with no host sync (`narrow` at a tensor reads it on
    the host, which a meta or fake tensor cannot): the rows from `start`
    clamped to [0, n - size], as lax clamps it.  Under `trace_to_graph`
    one ``dynamic_slice`` vertex (`GraphTracer.dynamic_slice`)."""
    if _ACTIVE:
        return _ACTIVE[-1].dynamic_slice(x, start, size, dim)
    idx = start.clamp(0, x.shape[dim] - size).reshape(1)
    if size > 1:
        idx = idx + torch.arange(size, device=x.device)
    return x.index_select(dim, idx)


def nested_jit(tag: str, fn, *args):
    """`fn(*args)` for a function the reference runs as a nested `jit`
    (`jnp.var`): under `trace_to_graph` one data vertex over the
    arguments (`GraphTracer.one_call`), as the reference's tracer makes
    one; elsewhere the call."""
    if _ACTIVE:
        return _ACTIVE[-1].one_call(tag, fn, args, {})
    return fn(*args)


def node_of(t: torch.Tensor) -> Optional[str]:
    """The graph vertex the running trace binds `t` to (None outside a
    trace, and for a weight)."""
    return _ACTIVE[-1].read(t).node if _ACTIVE else None


def tracing() -> bool:
    """Whether a `trace_to_graph` call is running."""
    return bool(_ACTIVE)


def trace_to_graph(fn, *args, name: str = "traced",
                   weight_argnums: Tuple[int, ...] = (0,),
                   bit_width: int = DEFAULT_BIT_WIDTH) -> ComputationGraph:
    """Run `fn(*args)` on meta tensors and lower it to the canonical graph
    IR.

    `args` are pytrees (dicts, lists, tuples) of tensors — only their
    shapes and dtypes are read — and Python values.  The pytrees at
    `weight_argnums` are the model's parameters: their leaves attach to
    consuming compute ops as weight bits.  Every tensor leaf of the other
    arguments is an input vertex."""
    tracer = GraphTracer(name, bit_width)
    meta = [pytree.tree_map_only(
        torch.Tensor, lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"), a)
        for a in args]
    for i, a in enumerate(meta):
        for t in pytree.tree_leaves(a):
            if isinstance(t, torch.Tensor):
                tracer.bind(t, tracer.weight_binding(t.numel())
                            if i in weight_argnums
                            else tracer.input_node(t.numel()))
    _ACTIVE.append(tracer)
    try:
        with torch.no_grad(), _FunctionForms(), tracer:
            fn(*meta)
    finally:
        _ACTIVE.remove(tracer)
    return tracer.graph
