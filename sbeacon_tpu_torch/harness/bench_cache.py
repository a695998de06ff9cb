"""Disk cache for benchmark corpora.

Counterpart of ``sbeacon_tpu/harness/bench_cache.py``, copied whole but
for the default cache directory. A benchmark that re-synthesises its
corpora on every run pays minutes per 2e7-row shard, in the main process
and again in each subprocess. This module builds a synthetic shard ONCE
and persists its arrays as raw ``.npy`` files so every later run (and
every subprocess) mmaps them back in milliseconds; pages stream in
lazily as the device upload or host matcher touches them.

Invalidation is by content key: the kwargs of the request plus a hash
of ``synthetic_shard``'s source and the shard dataclass field list
(the corpus *schema*). Any change to the generator or the shard layout
produces a different directory name, and stale sibling directories are
pruned so the cache never accumulates dead corpora.

The reference's analogous lesson is simulations/simulate.py: its
USER_GUIDE seeds the deployed stack once and reuses it across test.py
runs rather than re-uploading per measurement.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np

CACHE_VERSION = 1

# VariantIndexShard array attributes persisted beside the cols dict
_ATTRS = (
    "chrom_offsets",
    "ref_blob",
    "ref_off",
    "alt_blob",
    "alt_off",
    "vt_codes",
    "gt_bits",
    "gt_bits2",
    "tok_bits1",
    "tok_bits2",
    "gt_overflow",
    "tok_overflow",
)


def default_cache_root() -> Path:
    """``BENCH_CACHE`` env override, else ``build/bench_cache`` under
    the checkout (git-ignored, beside the kernels' build)."""
    env = os.environ.get("BENCH_CACHE")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "bench_cache"


def _schema_hash() -> str:
    from ..index import columnar
    from ..utils import chrom
    from .. import testing

    # hash the WHOLE generator dependency closure, not just
    # synthetic_shard's own body: row contents flow through columnar's
    # flag/hash/prefix helpers and the chromosome-length table, so an
    # edit to any of them must invalidate cached corpora (the cost is a
    # coarse false-positive rebuild, ~90 s total — stale corpora would
    # silently misreport every subsequent bench run)
    src = (
        inspect.getsource(testing.synthetic_shard)
        + inspect.getsource(columnar)
        + repr(sorted(chrom.CHROMOSOME_LENGTHS.items()))
    )
    fields = ",".join(
        f.name for f in dataclasses.fields(columnar.VariantIndexShard)
    )
    h = hashlib.sha1(
        f"v{CACHE_VERSION}|{fields}|{src}".encode()
    ).hexdigest()
    return h[:12]


def _key(kwargs: dict) -> str:
    return hashlib.sha1(
        json.dumps(kwargs, sort_keys=True, default=str).encode()
    ).hexdigest()[:12]


def _save(d: Path, shard) -> None:
    """Atomic publish: write into a tmp sibling, then rename."""
    d.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(
        tempfile.mkdtemp(prefix=d.name + ".tmp-", dir=d.parent)
    )
    try:
        for name, arr in shard.cols.items():
            np.save(tmp / f"col__{name}.npy", arr)
        for name in _ATTRS:
            arr = getattr(shard, name)
            if arr is not None:
                np.save(tmp / f"attr__{name}.npy", arr)
        (tmp / "META.json").write_text(json.dumps(shard.meta))
        try:
            os.replace(tmp, d)
        except OSError:
            # publish race: another process renamed its tmp into place
            # first (ENOTEMPTY). Their copy is valid — keep it.
            if (d / "META.json").exists():
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                raise
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _load(d: Path):
    from ..index.columnar import VariantIndexShard

    meta = json.loads((d / "META.json").read_text())
    cols = {}
    attrs: dict = {}
    for f in sorted(d.iterdir()):
        if f.suffix != ".npy":
            continue
        arr = np.load(f, mmap_mode="r")
        kind, _, name = f.stem.partition("__")
        if kind == "col":
            cols[name] = arr
        else:
            attrs[name] = arr
    return VariantIndexShard(
        meta=meta,
        cols=cols,
        **{n: attrs.get(n) for n in _ATTRS},
    )


def _prune_stale(root: Path, schema: str) -> None:
    if not root.is_dir():
        return
    for child in root.iterdir():
        if (
            child.is_dir()
            and child.name.startswith("shard-")
            and not child.name.startswith(f"shard-{schema}-")
        ):
            shutil.rmtree(child, ignore_errors=True)


def cached_synthetic_shard(n_rows: int, *, cache_root=None, **kwargs):
    """``testing.synthetic_shard`` with a persistent mmap-backed cache.

    Returns (shard, build_seconds) — build_seconds is 0.0 on a cache
    hit (the honest build cost lives with whichever run actually paid
    it; callers report hit/miss explicitly).
    """
    import time

    from .. import testing

    root = Path(cache_root) if cache_root else default_cache_root()
    req = {"n_rows": n_rows, **kwargs}
    schema = _schema_hash()
    d = root / f"shard-{schema}-{_key(req)}"
    if (d / "META.json").exists():
        return _load(d), 0.0
    _prune_stale(root, schema)
    t0 = time.perf_counter()
    shard = testing.synthetic_shard(n_rows, **kwargs)
    build_s = time.perf_counter() - t0
    try:
        _save(d, shard)
    except OSError:
        # disk pressure: serve the in-memory shard; next run rebuilds.
        # (_save cleans its own tmp dir; ``d`` is either absent or a
        # concurrent process's valid publish — never delete it here.)
        pass
    return shard, build_s
