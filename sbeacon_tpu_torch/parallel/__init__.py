"""Cross-shard computations of the port: the distinct count and the
dataset-sharded mesh stack."""
