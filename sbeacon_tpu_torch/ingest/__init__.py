"""Ingest of the port: VCF summarisation into index shards, the job
ledger and the delta compactor (``sbeacon_tpu/ingest/``)."""

from .service import IngestService

__all__ = ["IngestService"]
