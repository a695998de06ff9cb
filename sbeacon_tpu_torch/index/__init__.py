from .columnar import (
    FLAG,
    VariantIndexShard,
    build_index,
    fnv1a32,
    shard_from_reference,
)

__all__ = [
    "FLAG",
    "VariantIndexShard",
    "build_index",
    "fnv1a32",
    "shard_from_reference",
]
