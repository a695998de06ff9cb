from .columnar import (
    FLAG,
    VariantIndexShard,
    build_index,
    fnv1a32,
    load_index,
    merge_shards,
    save_index,
    shard_from_reference,
    stack_shard_columns,
)

__all__ = [
    "FLAG",
    "VariantIndexShard",
    "build_index",
    "fnv1a32",
    "load_index",
    "merge_shards",
    "save_index",
    "shard_from_reference",
    "stack_shard_columns",
]
