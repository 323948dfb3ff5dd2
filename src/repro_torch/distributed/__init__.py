from repro_torch.distributed.sharding import (AxisRules, Layout, fsdp_rules,
                                              logical_placements,
                                              placements_of, shard_constraint,
                                              shard_shape, tp_rules,
                                              tree_placements)

__all__ = ["AxisRules", "Layout", "fsdp_rules", "logical_placements",
           "placements_of", "shard_constraint", "shard_shape", "tp_rules",
           "tree_placements"]
