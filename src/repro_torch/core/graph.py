"""Computation-graph analyzer (paper §4.2, Fig. 5).

The DNN is a DAG where a vertex is a DNN operation and an edge is a data
dependency.  The analyzer produces:

  * the **operation stream** — a topological order obtained by traversing
    backward from the end node with depth-first search (an op joins the
    stream only when it has no parent or all parents are already streamed);
  * the **dynamic memory allocation profile** — the white -> blue -> grey
    node lifecycle of Fig. 5: an op's output is allocated on-chip when the
    op is processed (blue) and deallocated once no unprocessed node depends
    on it (grey).  The peak of the allocation curve lower-bounds the on-chip
    activation buffer (Eq. 13); the largest weight working set lower-bounds
    the weight buffer (Eq. 11).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.costmodel import Op, OpStream

__all__ = ["GraphNode", "ComputationGraph", "MemoryProfile"]


@dataclasses.dataclass
class GraphNode:
    """One vertex of the DNN computation DAG."""

    name: str
    op: Optional[Op]                 # None for pure data nodes (inputs)
    output_bits: int                 # size of the node's output tensor
    weight_bits: int = 0             # parameters attached to the node
    parents: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MemoryProfile:
    """Result of the dynamic-memory-allocation analysis."""

    peak_activation_bits: int
    peak_weight_bits: int
    timeline_bits: List[int]         # allocated activation bits per step
    stream_names: List[str]

    @property
    def peak_activation_bytes(self) -> int:
        return self.peak_activation_bits // 8

    @property
    def peak_weight_bytes(self) -> int:
        return self.peak_weight_bits // 8


class ComputationGraph:
    """DAG of DNN operations with the paper's stream + memory analysis."""

    def __init__(self) -> None:
        self.nodes: Dict[str, GraphNode] = {}
        self._order: List[str] = []          # insertion order (determinism)

    # ------------------------------------------------------------- building
    def add(self, name: str, op: Optional[Op], output_bits: int,
            weight_bits: int = 0,
            parents: Sequence[str] = ()) -> str:
        if name in self.nodes:
            raise ValueError(f"duplicate node {name!r}")
        for p in parents:
            if p not in self.nodes:
                raise ValueError(f"unknown parent {p!r} of {name!r}")
        self.nodes[name] = GraphNode(name, op, output_bits, weight_bits,
                                     list(parents))
        self._order.append(name)
        return name

    def add_op(self, op: Op, parents: Sequence[str] = (),
               bit_width: int = 8) -> str:
        """Convenience: add an `Op` node; output size derived from the op."""
        name = op.name or f"op{len(self.nodes)}"
        return self.add(name, op, op.output_elems * bit_width,
                        op.weight_elems * bit_width, parents)

    # ------------------------------------------------------------ analysis
    def end_nodes(self) -> List[str]:
        has_child: Set[str] = set()
        for n in self.nodes.values():
            has_child.update(n.parents)
        return [n for n in self._order if n not in has_child]

    def operation_stream(self) -> List[str]:
        """Backward DFS from the end node(s), emitted in forward order.

        Matches §4.2: "an operation can only be appended to the stream if it
        has no parent node or all of its parent nodes are already processed
        and are in the stream."  Implemented as DFS post-order from the end
        nodes, which yields exactly such an order and is deterministic.
        """
        visited: Set[str] = set()
        stream: List[str] = []

        def visit(name: str) -> None:
            # iterative DFS to cope with very deep graphs
            stack: List[Tuple[str, int]] = [(name, 0)]
            while stack:
                node, idx = stack.pop()
                if node in visited and idx == 0:
                    continue
                parents = self.nodes[node].parents
                if idx < len(parents):
                    stack.append((node, idx + 1))
                    p = parents[idx]
                    if p not in visited:
                        stack.append((p, 0))
                else:
                    if node not in visited:
                        visited.add(node)
                        stream.append(node)

        for end in self.end_nodes():
            visit(end)
        return stream

    def memory_profile(self) -> MemoryProfile:
        """Dynamic memory allocation analysis (Fig. 5).

        White node  = unprocessed;
        blue node   = processed, output resident on-chip;
        grey node   = all consumers processed, output deallocated.
        """
        stream = self.operation_stream()
        remaining_children: Dict[str, int] = {n: 0 for n in self.nodes}
        for node in self.nodes.values():
            for p in node.parents:
                remaining_children[p] += 1

        alive: Dict[str, int] = {}
        peak_act = 0
        peak_w = 0
        timeline: List[int] = []
        for name in stream:
            node = self.nodes[name]
            # processing `name`: its output becomes resident (blue) while
            # its parents are still resident by construction.
            alive[name] = node.output_bits
            peak_w = max(peak_w, node.weight_bits)
            cur = sum(alive.values())
            peak_act = max(peak_act, cur)
            timeline.append(cur)
            # parents with no unprocessed consumers turn grey.
            for p in node.parents:
                remaining_children[p] -= 1
                if remaining_children[p] == 0:
                    alive.pop(p, None)
            if remaining_children[name] == 0:     # end node, nothing reads it
                alive.pop(name, None)
        return MemoryProfile(peak_act, peak_w, timeline, stream)

    def op_stream(self) -> OpStream:
        """The costable operation stream (data nodes dropped)."""
        names = self.operation_stream()
        ops = [self.nodes[n].op for n in names if self.nodes[n].op is not None]
        return OpStream(ops)

    @property
    def total_weight_bits(self) -> int:
        """Sum of all parameters attached to the graph (model size)."""
        return sum(n.weight_bits for n in self.nodes.values())

    # ------------------------------------------------------------- summary
    def summary(self) -> Dict[str, object]:
        """Table 3 row for this graph (bytes derive from the bit widths
        fixed at graph-build time)."""
        prof = self.memory_profile()
        kinds: Dict[str, int] = {}
        n_data = 0
        for n in self.operation_stream():
            op = self.nodes[n].op
            if op is not None:
                kinds[op.kind.value] = kinds.get(op.kind.value, 0) + 1
            else:
                n_data += 1
        return {
            "peak_input_memory_bytes": prof.peak_activation_bytes,
            "peak_weight_memory_bytes": prof.peak_weight_bytes,
            "total_weight_bytes": self.total_weight_bits // 8,
            "op_counts": kinds,
            "n_ops": sum(kinds.values()),
            "n_data_nodes": n_data,
            "total_macs": self.op_stream().total_macs,
        }
