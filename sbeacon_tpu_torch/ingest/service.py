"""Ingest service of the port, trimmed to what the server entry runs.

Counterpart of ``sbeacon_tpu/ingest/service.py:43-45, 660-775``:
``VcfLocationError`` (a missing or unindexed VCF, the 400 of the API
layer) and an ``IngestService`` that re-pins every persisted shard of a
data root into an engine (``load_all``) and has nothing to stop
(``close``). Submission, summarisation, the job ledger and the delta
compactor come with the ingest slice.
"""

from __future__ import annotations

from ..config import BeaconConfig
from ..index.columnar import load_index


class VcfLocationError(ValueError):
    """A submitted VCF is missing or unindexed (400 at the API boundary)."""


class IngestService:
    def __init__(self, config: BeaconConfig | None = None, *, engine=None):
        self.config = config or BeaconConfig()
        self.engine = engine

    def close(self) -> None:
        """Nothing runs in the background here (no compactor yet)."""

    def load_all(self) -> int:
        """Re-pin every persisted shard (startup / crash-resume); returns
        the number of shards loaded. ``*.tmp.npz`` files are saves a
        crash interrupted, and the ``portable/`` export sits one level
        deeper than the ``<dataset>/<shard>.npz`` glob."""
        n = 0
        idx_dir = self.config.storage.index_dir
        if not idx_dir.exists() or self.engine is None:
            return 0
        for path in sorted(idx_dir.glob("*/*.npz")):
            if path.name.endswith(".tmp.npz"):
                continue
            self.engine.add_index(load_index(path))
            n += 1
        return n
