"""Graph capture for the port: a PyTorch callable traced on fake tensors
and lowered to the canonical `ComputationGraph` (the twin of
`repro.frontend`), and the model zoo's traced DSE apps."""

from repro_torch.frontend.lower import (LOWERING_RULES, Lowered, OperandInfo,
                                        lower_call, register_lowering)
from repro_torch.frontend.trace import (DEFAULT_BIT_WIDTH, GraphTracer,
                                        trace_to_graph)

__all__ = ["trace_to_graph", "GraphTracer", "DEFAULT_BIT_WIDTH",
           "LOWERING_RULES", "Lowered", "OperandInfo", "lower_call",
           "register_lowering"]
