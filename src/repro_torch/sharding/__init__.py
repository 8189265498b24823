from repro_torch.sharding.rules import (  # noqa: F401
    LogicalRules,
    default_rules,
    spec_for,
    tree_specs,
    shard_tree,
)
from repro_torch.sharding.policy import attention_tp_mode  # noqa: F401
