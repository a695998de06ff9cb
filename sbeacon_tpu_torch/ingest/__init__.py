"""Ingest-side computations of the port (trimmed to the distinct count)."""
