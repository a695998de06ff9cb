"""The port's fleet ingest (slice scans on remote workers) against the
JAX package's local ingest, at tolerance 0.

Twin of ``tests/test_distributed_ingest.py``'s 14 cases, plus the
hedged-scan case of ``tests/test_perf_smoke.py``. The centre: a port
pipeline whose slices scan on two port workers persists and publishes a
base equal to the JAX pipeline's local summarisation of the same VCF,
shard for shard (every column, blob, plane and meta key), with the same
stats, ledger rows and portable region files byte for byte. A worker
that fails degrades to a local scan on the coordinator, never to wrong
or missing rows; the one-strike breaker, hedging, the token gate and
the workers' reload behave as JAX's.
"""

from __future__ import annotations

import dataclasses
import json
import random
import time

import pytest

from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.config import IngestConfig as JIngestConfig
from sbeacon_tpu.config import StorageConfig as JStorageConfig
from sbeacon_tpu.genomics.tabix import ensure_index as j_ensure_index
from sbeacon_tpu.genomics.vcf import write_vcf as j_write_vcf
from sbeacon_tpu.index import columnar as jc
from sbeacon_tpu.ingest import pipeline as jpl
from sbeacon_tpu.parallel import dispatch as jdispatch
from sbeacon_tpu.payloads import SliceScanPayload as JSliceScanPayload
from sbeacon_tpu.testing import random_records
from sbeacon_tpu_torch.config import (
    AuthConfig,
    BeaconConfig,
    EngineConfig,
    IngestConfig,
    StorageConfig,
)
from sbeacon_tpu_torch.engine import VariantEngine
from sbeacon_tpu_torch.index import columnar as tc
from sbeacon_tpu_torch.ingest import IngestService
from sbeacon_tpu_torch.ingest import pipeline as tpl
from sbeacon_tpu_torch.parallel.dispatch import (
    ScanWorkerPool,
    WorkerError,
    WorkerServer,
)
from sbeacon_tpu_torch.parallel.transport import (
    urllib_get,
    urllib_post,
    urllib_post_bytes,
)
from sbeacon_tpu_torch.payloads import SliceScanPayload
from sbeacon_tpu_torch.resilience import CircuitBreaker
from sbeacon_tpu_torch.testing import range_server
from torch_ingest_corpus import assert_shards_equal, no_thread_leak  # noqa: F401

SAMPLES = ["S0", "S1", "S2"]
#: a slice budget tiny enough to cut the test VCF into several slices
SMALL = dict(min_task_time=1e-6, scan_rate=1e6, dispatch_cost=1e-7,
             max_concurrency=1000, workers=4, compact_interval_s=0.0)
#: the dead address every "down worker" case dials
DEAD = "http://127.0.0.1:9"
#: a scan over every record of the file
WHOLE = dict(dataset_id="d", vstart=0, vend=1 << 40, sample_names=SAMPLES)


@pytest.fixture(scope="module")
def vcf(tmp_path_factory):
    root = tmp_path_factory.mktemp("divcf")
    recs = random_records(random.Random(31), chrom="5", n=5000,
                          n_samples=len(SAMPLES), spacing=400)
    path = root / "big.vcf.gz"
    j_write_vcf(path, recs, sample_names=SAMPLES)
    j_ensure_index(path)
    return path


class Workers:
    """Port worker servers over CPU engines; ``close`` shuts them all."""

    def __init__(self):
        self.servers: list[WorkerServer] = []
        self.engines: list[VariantEngine] = []
        self.services: list[IngestService] = []

    def engine(self) -> VariantEngine:
        eng = VariantEngine(
            BeaconConfig(engine=EngineConfig(microbatch=False,
                                             use_mesh=False)),
            device="cpu")
        self.engines.append(eng)
        return eng

    def start(self, token: str = "", open_scan: bool | None = None, *,
              engine=None, reload_fn=None) -> WorkerServer:
        if open_scan is None:
            open_scan = not token  # untokened test workers opt in
        w = WorkerServer(engine or self.engine(), token=token,
                         open_scan=open_scan,
                         reload_fn=reload_fn).start_background()
        self.servers.append(w)
        return w

    def close(self) -> None:
        for w in self.servers:
            w.shutdown()
        for svc in self.services:
            svc.close()
            svc.ledger.close()
        for e in self.engines:
            e.close()


@pytest.fixture()
def workers():
    ws = Workers()
    try:
        yield ws
    finally:
        ws.close()


def _pipeline(tmp_path, name, *, scan_pool=None, **cfg):
    config = BeaconConfig(storage=StorageConfig(root=tmp_path / name),
                          ingest=IngestConfig(**SMALL), **cfg)
    config.storage.ensure()
    return tpl.SummarisationPipeline(config, scan_pool=scan_pool)


def _jax_local(tmp_path, name="jax"):
    config = JBeaconConfig(storage=JStorageConfig(root=tmp_path / name),
                           ingest=JIngestConfig(**SMALL))
    config.storage.ensure()
    return jpl.SummarisationPipeline(config)


def _close(*pipes):
    for p in pipes:
        if isinstance(p, tpl.SummarisationPipeline):
            p.close()
        p.ledger.close()


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _equal_to_jax_local(tpipe, tmp_path, vcf_path, *, vcf_loc=None):
    """The port pipeline's summarisation of ``vcf_loc`` (default the
    file) equals the JAX pipeline's local one of the same file."""
    jpipe = _jax_local(tmp_path)
    try:
        loc = str(vcf_loc or vcf_path)
        a = tpipe.summarise_vcf("ds", loc)
        b = jpipe.summarise_vcf("ds", str(vcf_path))
        # the meta names the VCF location the pipeline was given
        assert_shards_equal(a, b, meta=vcf_loc is None)
        assert_shards_equal(tc.load_index(tpipe.shard_path("ds", loc)), b,
                            meta=vcf_loc is None)
        return a
    finally:
        _close(jpipe)


def test_scan_payload_roundtrip():
    p = SliceScanPayload(dataset_id="d", vcf_location="v", vstart=1,
                         vend=2, sample_names=["a"])
    assert SliceScanPayload.loads(p.dumps()) == p
    # the wire form is the JAX package's, field for field
    jp = JSliceScanPayload(dataset_id="d", vcf_location="v", vstart=1,
                           vend=2, sample_names=["a"])
    assert p.dumps() == jp.dumps()
    assert dataclasses.asdict(SliceScanPayload()) == dataclasses.asdict(
        JSliceScanPayload())


def test_multi_worker_ingest_bit_identical(vcf, tmp_path, workers):
    """Two port workers scan the slices: the base, the stats, the
    ledger and the portable region files equal JAX's local ingest."""
    w1, w2 = workers.start(), workers.start()
    pool = ScanWorkerPool([w1.address, w2.address])
    dist = _pipeline(tmp_path, "dist", scan_pool=pool)
    jpipe = _jax_local(tmp_path)
    try:
        a = dist.summarise_dataset("ds", [str(vcf)])
        b = jpipe.summarise_dataset("ds", [str(vcf)])
        assert a == b
        assert_shards_equal(
            tc.load_index(dist.shard_path("ds", str(vcf))),
            jc.load_index(jpipe.shard_path("ds", str(vcf))))
        assert dist.ledger.vcf_summary(str(vcf)) == jpipe.ledger.vcf_summary(
            str(vcf))
        assert _tree(dist.config.storage.index_dir / "portable") == _tree(
            jpipe.config.storage.index_dir / "portable")
        # the scatter really fanned out over both workers
        assert pool._next > 2
        assert not list(dist.config.storage.index_dir.rglob("*.slices"))
    finally:
        pool.close()
        _close(dist, jpipe)


def test_dead_worker_falls_back_to_local(vcf, tmp_path):
    pool = ScanWorkerPool([DEAD], retries=0, timeout_s=2)
    dist = _pipeline(tmp_path, "deadw", scan_pool=pool)
    try:
        _equal_to_jax_local(dist, tmp_path, vcf)
    finally:
        pool.close()
        _close(dist)


def test_mixed_dead_and_live_workers(vcf, tmp_path, workers):
    w = workers.start()
    pool = ScanWorkerPool([DEAD, w.address], retries=1, timeout_s=2)
    dist = _pipeline(tmp_path, "mixed", scan_pool=pool)
    try:
        _equal_to_jax_local(dist, tmp_path, vcf)
        assert pool.breaker.state(DEAD) == "open"
    finally:
        pool.close()
        _close(dist)


def test_scan_endpoint_token_gated(vcf, workers):
    """A tokened worker refuses an untokened scan; the right token
    scans (the JAX pool reaches the port worker too), a wrong one
    raises ``WorkerError``."""
    w = workers.start(token="tok")
    payload = SliceScanPayload(vcf_location=str(vcf), **WHOLE)
    status, _body = urllib_post_bytes(f"{w.address}/scan",
                                      json.loads(payload.dumps()), 10)
    assert status == 401
    pool = ScanWorkerPool([w.address], token="tok")
    jpool = jdispatch.ScanWorkerPool([w.address], token="tok")
    bad = ScanWorkerPool([w.address], token="nope", retries=0)
    try:
        shard = pool.scan(payload)
        assert shard.n_rows > 0
        assert pool.scan_blob(payload) == jpool.scan_blob(
            JSliceScanPayload(vcf_location=str(vcf), **WHOLE))
        with pytest.raises(WorkerError):
            bad.scan(payload)
    finally:
        for p in (pool, jpool, bad):
            p.close()


def test_workers_scan_remote_vcf(vcf, tmp_path, workers):
    """Workers range-read the VCF from an object store themselves: the
    coordinator ships only the URL and the offsets."""
    w = workers.start()
    pool = ScanWorkerPool([w.address])
    dist = _pipeline(tmp_path, "rdist", scan_pool=pool)
    try:
        with range_server(vcf.parent) as base:
            url = f"{base}/{vcf.name}"
            _equal_to_jax_local(dist, tmp_path, vcf, vcf_loc=url)
    finally:
        pool.close()
        _close(dist)


def test_config_env_scan_workers(monkeypatch):
    monkeypatch.setenv("BEACON_SCAN_WORKERS", "http://a:1, http://b:2")
    cfg = BeaconConfig.from_env()
    assert cfg.ingest.scan_worker_urls == ("http://a:1", "http://b:2")
    assert dataclasses.asdict(cfg.ingest) == dataclasses.asdict(
        JBeaconConfig.from_env().ingest)


def test_pipeline_builds_pool_from_config(vcf, tmp_path, workers):
    """A pipeline builds its scan pool from ``IngestConfig`` (with the
    worker token, the scan timeout and retries) and closes it."""
    w = workers.start(token="t2")
    config = BeaconConfig(
        storage=StorageConfig(root=tmp_path / "cfg"),
        ingest=IngestConfig(**SMALL, scan_worker_urls=(w.address,),
                            scan_timeout_s=30.0, scan_retries=2),
        auth=AuthConfig(worker_token="t2"))
    config.storage.ensure()
    pipe = tpl.SummarisationPipeline(config)
    try:
        pool = pipe.scan_pool
        assert pool is not None and pool.worker_urls == [w.address]
        assert (pool.token, pool.timeout_s, pool.retries) == ("t2", 30.0, 2)
        _equal_to_jax_local(pipe, tmp_path, vcf)
        assert pool.breaker.state(w.address) == "closed"
    finally:
        _close(pipe)


def test_scan_refused_without_token_or_opt_in(vcf, workers):
    """Secure default: ``/scan`` reads any client-supplied location, so
    an untokened worker refuses it unless the operator opted in; the
    query surface stays available."""
    w = workers.start(open_scan=False)
    payload = SliceScanPayload(vcf_location=str(vcf), **WHOLE)
    status, body = urllib_post_bytes(f"{w.address}/scan",
                                     json.loads(payload.dumps()), 10)
    assert status == 403 and b"token" in body
    status, _doc = urllib_get(f"{w.address}/datasets", 5)
    assert status == 200


def test_cooldown_skips_failing_worker(vcf, workers):
    """After a failure the wedged worker is skipped for ``cooldown_s``:
    later scans go straight to the healthy one."""
    w = workers.start()
    pool = ScanWorkerPool([DEAD, w.address], retries=1, timeout_s=2,
                          cooldown_s=60)
    try:
        pool.scan(SliceScanPayload(vcf_location=str(vcf), **WHOLE))
        assert pool.breaker.state(DEAD) == "open"
        assert {pool._pick() for _ in range(4)} == {w.address}
    finally:
        pool.close()


def test_auth_failure_marks_dead_and_reload_revives(vcf, workers):
    """401/403 on ``/scan`` opens the worker's circuit; a reload that
    still fails auth keeps it open, an acknowledged one closes it."""
    w = workers.start(token="tok", reload_fn=lambda: 0)
    pool = ScanWorkerPool([w.address], token="wrong", retries=0,
                          cooldown_s=300)
    try:
        with pytest.raises(WorkerError):
            pool.scan_blob(SliceScanPayload(vcf_location=str(vcf),
                                            **WHOLE))
        assert pool.breaker.state(w.address) == "open"
        assert pool.reload_workers() == 0
        assert pool.breaker.state(w.address) == "open"
        pool.token = "tok"
        assert pool.reload_workers() == 1
        assert pool.breaker.state(w.address) == "closed"
        assert pool._pick() == w.address
    finally:
        pool.close()


def test_half_open_probe_released_on_non200_answer():
    """A worker that ANSWERS (even 500) after its cooldown is reachable:
    the half-open probe records an outcome and closes the circuit."""
    url = "http://w:1"
    mode = {"raise": True}

    def post_bytes(u, doc, timeout_s, headers=None):
        if mode["raise"]:
            raise ConnectionError("injected: down")
        return 500, b"scan exploded"

    pool = ScanWorkerPool([url], retries=0, post_bytes=post_bytes)
    clock = [0.0]
    pool.breaker = CircuitBreaker(failure_threshold=1, reset_timeout_s=30.0,
                                  clock=lambda: clock[0])
    payload = SliceScanPayload(dataset_id="d")
    try:
        with pytest.raises(WorkerError):
            pool.scan_blob(payload)
        assert pool.breaker.state(url) == "open"
        clock[0] = 31.0
        mode["raise"] = False
        with pytest.raises(WorkerError):
            pool.scan_blob(payload)
        assert pool.breaker.state(url) == "closed"
    finally:
        pool.close()


def _shared_worker(workers, root, token="rt", **kw):
    """A port worker whose ``/reload`` re-pins shards from ``root``."""
    config = BeaconConfig(storage=StorageConfig(root=root),
                          ingest=IngestConfig(compact_interval_s=0.0))
    config.storage.ensure()
    eng = workers.engine()
    svc = IngestService(config, engine=eng)
    workers.services.append(svc)
    return config, eng, workers.start(token=token, engine=eng,
                                      reload_fn=svc.load_all, **kw)


def test_worker_reload_pins_new_shards(vcf, tmp_path, workers):
    """After a coordinator ingests into the worker's data root, ``POST
    /reload`` re-pins the new shards without a restart; it is token
    gated like every worker route."""
    config, eng, w = _shared_worker(workers, tmp_path / "shared")
    other = tpl.SummarisationPipeline(config)
    try:
        assert eng.datasets() == []
        other.summarise_vcf("dsNew", str(vcf))
        hdr = {"Authorization": "Bearer rt"}
        status, doc = urllib_post(f"{w.address}/reload", {}, 30, hdr)
        assert status == 200 and doc["ok"] and doc["shards"] >= 1
        assert eng.datasets() == ["dsNew"]
        status, _doc = urllib_post(f"{w.address}/reload", {}, 10)
        assert status == 401
    finally:
        _close(other)


def test_pipeline_auto_reloads_workers_after_ingest(vcf, tmp_path, workers):
    """``summarise_dataset`` ends by telling the scan workers to re-pin
    the shards from shared storage: the worker serves the new dataset,
    equal to the JAX local base."""
    config, weng, w = _shared_worker(workers, tmp_path / "sharedauto",
                                     open_scan=False)
    pool = ScanWorkerPool([w.address], token="rt")
    pipe = tpl.SummarisationPipeline(dataclasses.replace(
        config, ingest=IngestConfig(**SMALL)), scan_pool=pool)
    jpipe = _jax_local(tmp_path)
    try:
        assert weng.datasets() == []
        assert pipe.summarise_dataset("dsAuto", [str(vcf)]) == \
            jpipe.summarise_dataset("dsAuto", [str(vcf)])
        assert weng.datasets() == ["dsAuto"]
        (_k, (served, _d, _p)), = list(weng._indexes.items())
        assert_shards_equal(
            served, jc.load_index(jpipe.shard_path("dsAuto", str(vcf))))
    finally:
        pool.close()
        _close(pipe, jpipe)


def test_hedged_scan_not_gated_by_slow_worker():
    """A slow worker does not gate ``scan_blob``: after the hedge delay
    the scan races a second worker and the first answer wins. The slow
    worker sleeps 3 s, so the bound holds under a loaded test run."""
    slow_s = 3.0

    def post_bytes(url, doc, timeout_s, headers=None):
        if "slow" in url:
            time.sleep(slow_s)
            return 200, b"blob-slow"
        return 200, b"blob-fast"

    pool = ScanWorkerPool(["http://slow:1", "http://fast:1"], retries=0,
                          hedge_delay_s=0.05, post_bytes=post_bytes)
    try:
        t0 = time.perf_counter()
        blob = pool.scan_blob(SliceScanPayload(dataset_id="d"))
        took = time.perf_counter() - t0
        assert blob == b"blob-fast"
        assert took < slow_s / 2, took
        stats = pool.stats()
        assert stats["hedges"] == 1 and stats["hedge_wins"] == 1
    finally:
        pool.close()
