"""Cross-shard computations of the port (so far the distinct count)."""
