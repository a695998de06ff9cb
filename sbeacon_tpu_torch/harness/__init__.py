"""Chaos hooks of the port (trimmed to ``faults``)."""
