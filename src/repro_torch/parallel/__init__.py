from repro_torch.parallel.sharding import (  # noqa: F401
    P,
    ShardingRules,
    is_dtensor,
    logical,
    logical_placements,
    set_sharding_ctx,
    sharding_ctx,
    split_last,
    use_sharding_ctx,
)
