"""The port's async query job table and runner held against the JAX package's.

The cases of tests/test_query_jobs.py run on both packages' tables and
give the same transcripts (statuses, counters, response sets, spill
files). The runner then runs over a port engine on the CPU, beside the
JAX runner over a JAX engine fed the same seeded shard: coalescing of
concurrent identical queries, result caching and fingerprint
invalidation, a spilled result set read back from disk by a second
runner on the same job table, a failed job abandoned and re-run
directly (the real error reaching the caller), and the request deadline
and ``request_timeout_s`` bounds of ``run_variant_search``.
"""

import dataclasses
import random
import threading
import time

import pytest

import sbeacon_tpu.query_jobs as jq
import sbeacon_tpu_torch.query_jobs as pq
from sbeacon_tpu.api.requests import parse_request as j_parse_request
from sbeacon_tpu.api.variants import run_variant_search as j_run_variant_search
from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.config import EngineConfig as JEngineConfig
from sbeacon_tpu.engine import VariantEngine as JVariantEngine
from sbeacon_tpu.index import build_index as j_build_index
from sbeacon_tpu.payloads import VariantQueryPayload as JPayload
from sbeacon_tpu.payloads import VariantSearchResponse as JResponse
from sbeacon_tpu.testing import random_records as j_random_records
from sbeacon_tpu_torch.api.requests import parse_request
from sbeacon_tpu_torch.api.variants import run_variant_search
from sbeacon_tpu_torch.config import BeaconConfig, EngineConfig
from sbeacon_tpu_torch.engine import VariantEngine
from sbeacon_tpu_torch.harness import faults
from sbeacon_tpu_torch.index import shard_from_reference
from sbeacon_tpu_torch.payloads import VariantQueryPayload
from sbeacon_tpu_torch.payloads import VariantSearchResponse
from sbeacon_tpu_torch.resilience import (
    Deadline,
    DeadlineExceeded,
    deadline_scope,
)
from torch_ingest_corpus import no_thread_leak  # noqa: F401

PACKAGES = {"jax": (jq, JResponse), "port": (pq, VariantSearchResponse)}


def make_resp(cls, ds="ds1", n_variants=1):
    return cls(
        dataset_id=ds, vcf_location="v.vcf.gz", exists=True, call_count=10,
        all_alleles_count=20,
        variants=[f"22\t{100 + i}\tA\tT\tSNP" for i in range(n_variants)],
    )


def lifecycle(mod, resp, tmp):
    t = mod.QueryJobTable()
    out = [t.get_job_status("q1").name]
    claim = t.start("q1", fan_out=2)
    out += [claim is not None, t.start("q1"), t.get_job_status("q1").name,
            t.next_response_number("q1", claim),
            t.next_response_number("q1", claim),
            t.put_response("q1", 1, resp(), claim),
            t.mark_finished("q1", claim),
            t.put_response("q1", 2, resp(n_variants=2), claim),
            t.mark_finished("q1", claim), t.complete("q1", claim),
            t.get_job_status("q1").name,
            [dataclasses.asdict(r) for r in t.get_responses("q1")]]
    info = t.info("q1")
    out += [info["responses"], info["fan_out"], info["elapsed_time"] >= 0]
    return out


def ttl_and_lost_claim(mod, resp, tmp):
    t = mod.QueryJobTable(query_ttl_s=0.05)
    old = t.start("q")
    time.sleep(0.06)
    out = [t.get_job_status("q").name,
           t.put_response("q", 1, resp(), old)]
    new = t.start("q")
    out += [new is not None and new != old, t.get_responses("q"),
            t.next_response_number("q", old),
            t.put_response("q", 1, resp(), old),
            t.mark_finished("q", old), t.complete("q", old),
            t.get_job_status("q").name]
    t.abandon("q", old)
    out.append(t.get_job_status("q").name)
    return out


def crash_recovery(mod, resp, tmp):
    db = tmp / "jobs.sqlite"
    t1 = mod.QueryJobTable(db, spill_dir=tmp / "s", inline_limit=8)
    c = t1.start("crashed")
    t1.put_response("crashed", 1, resp(n_variants=20), c)
    cd = t1.start("completed")
    t1.complete("completed", cd)
    out = [len(list((tmp / "s").glob("*.json")))]
    t1.close()
    t2 = mod.QueryJobTable(db, spill_dir=tmp / "s")
    out += [t2.get_job_status("crashed").name,
            t2.get_job_status("completed").name,
            len(list((tmp / "s").glob("*.json")))]
    t2.close()
    return out


def spill(mod, resp, tmp):
    t = mod.QueryJobTable(spill_dir=tmp / "spill", inline_limit=64,
                          query_ttl_s=0.05, response_ttl_s=0.05)
    c = t.start("q")
    big = resp(n_variants=50)
    out = [t.put_response("q", 1, big, c),
           len(list((tmp / "spill").glob("*.json"))),
           [dataclasses.asdict(r) for r in t.get_responses("q")]]
    time.sleep(0.06)
    out += [t.purge_expired() >= 2,
            len(list((tmp / "spill").glob("*.json"))),
            t.get_job_status("q").name]
    c = t.start("q")
    t.put_response("q", 1, big, c)
    time.sleep(0.06)
    out += [t.start("q") is not None,  # a reclaim unlinks the spill
            len(list((tmp / "spill").glob("*.json")))]
    return out


def wait_polls(mod, resp, tmp):
    t = mod.QueryJobTable()
    c = t.start("q")

    def finish():
        time.sleep(0.03)
        t.complete("q", c)

    th = threading.Thread(target=finish)
    th.start()
    out = [t.wait("q", timeout_s=5)]
    th.join()
    return out + [t.wait("nonexistent", timeout_s=0.01)]


SCENARIOS = {f.__name__: f for f in (lifecycle, ttl_and_lost_claim,
                                     crash_recovery, spill, wait_polls)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_table_transcripts_equal(tmp_path, name):
    got = {}
    for pkg, (mod, cls) in PACKAGES.items():
        (tmp_path / pkg).mkdir()
        got[pkg] = SCENARIOS[name](
            mod, lambda **kw: make_resp(cls, **kw), tmp_path / pkg)
    assert got["port"] == got["jax"]


def test_hash_query_equal_to_jax():
    """The same payload and fingerprint hash to the same job id in both
    packages (why a port app never shares a JAX data root's job table)."""
    assert pq.hash_query({"x": 1, "y": [2, 3]}) == pq.hash_query(
        {"y": [2, 3], "x": 1})
    jp = JPayload(dataset_ids=["ds1"], reference_name="22", start_min=5)
    pp = VariantQueryPayload(dataset_ids=["ds1"], reference_name="22",
                             start_min=5)
    doc = {"payload": dataclasses.asdict(pp), "fp": "fp"}
    assert pq.hash_query(doc) == jq.hash_query(
        {"payload": dataclasses.asdict(jp), "fp": "fp"})


# -- the runner over real engines ----------------------------------------------


@pytest.fixture(scope="module")
def engines():
    recs = j_random_records(random.Random(23), chrom="22", n=300,
                            n_samples=4, spacing=15)
    jshard = j_build_index(recs, dataset_id="ds1", vcf_location="v.vcf.gz",
                           sample_names=["s0", "s1", "s2", "s3"])
    jeng = JVariantEngine(JBeaconConfig(engine=JEngineConfig(
        use_mesh=False, response_cache=False)))
    jeng.add_index(jshard)
    peng = VariantEngine(BeaconConfig(engine=EngineConfig(
        response_cache=False)), device="cpu")
    peng.add_index(shard_from_reference(jshard))
    yield jeng, peng
    jeng.close()
    peng.close()


class Counting:
    """Forwards search() to an engine, counting calls; ``delay`` holds
    each search in RUNNING."""

    def __init__(self, engine, delay=0.0):
        self.engine, self.delay = engine, delay
        self.config = engine.config
        self.calls = 0
        self._lock = threading.Lock()

    def index_fingerprint(self):
        return self.engine.index_fingerprint()

    def search(self, payload):
        with self._lock:
            self.calls += 1
        if self.delay:
            time.sleep(self.delay)
        return self.engine.search(payload)


BODY = {"query": {"requestedGranularity": "record",
                  "includeResultsetResponses": "HIT",
                  "requestParameters": {
                      "assemblyId": "GRCh38", "referenceName": "22",
                      "start": [0, 10_000_000], "end": [0, 10_000_000],
                      "alternateBases": "N"}}}


def _search(run, parse, eng, runner, body=BODY):
    req = parse("POST", None, body)
    s_min, s_max, e_min, e_max = req.coordinates()
    agg = run(eng, [{"id": "ds1"}], req, start_min=s_min, start_max=s_max,
              end_min=e_min, end_max=e_max, runner=runner)
    return agg.exists, sorted(agg.variants), agg.results


def test_runner_answers_equal_and_cache(engines):
    jeng, peng = engines
    jc, pc = Counting(jeng), Counting(peng)
    jr = jq.AsyncQueryRunner(jc, jq.QueryJobTable())
    pr = pq.AsyncQueryRunner(pc, pq.QueryJobTable())
    try:
        want = _search(j_run_variant_search, j_parse_request, jc, jr)
        got = _search(run_variant_search, parse_request, pc, pr)
        assert got == want and got[0] and got[1]
        # an identical resubmit is served from the job cache
        assert _search(run_variant_search, parse_request, pc, pr) == want
        assert pc.calls == jc.calls == 1
        # a new fingerprint is a new job
        pl = VariantQueryPayload(dataset_ids=["ds1"], reference_name="22")
        q1, _ = pr.submit(pl, fingerprint="v1")
        pr.result(q1, wait_s=5)
        q2, _ = pr.submit(pl, fingerprint="v2")
        assert q2 != q1
        pr.result(q2, wait_s=5)
        assert pc.calls == 3
        assert pr.metrics()["coalesced"] == 0
    finally:
        jr.close()
        pr.close()


def test_purge_sweep_expires_in_memory_handoffs(engines):
    """The periodic sweep drops expired in-memory answers. The handoff
    holds (responses, expiry, unavailable): the JAX runner's sweep
    unpacks two fields, raises in its thread and never purges."""
    _jeng, peng = engines
    ran = {}
    for mod in (pq, jq):
        runner = mod.AsyncQueryRunner(Counting(peng), mod.QueryJobTable())
        try:
            pl = VariantQueryPayload(dataset_ids=["ds1"], reference_name="22")
            qid, _ = runner.submit(pl, fingerprint="f")
            runner.result(qid, wait_s=5)
            assert qid in runner._results
            with runner._lock:
                runner._results = {q: (r, 0.0, u) for q, (r, _e, u)
                                   in runner._results.items()}
            runner._last_purge = 0.0
            errors = []
            hook = threading.excepthook
            threading.excepthook = lambda a: errors.append(a.exc_type)
            try:
                runner._maybe_purge()
                runner._sweeper.join(10)
            finally:
                threading.excepthook = hook
            ran[mod.__name__] = (qid in runner._results, errors)
        finally:
            runner.close()
    assert ran["sbeacon_tpu_torch.query_jobs"] == (False, [])
    assert ran["sbeacon_tpu.query_jobs"] == (True, [ValueError])


def test_runner_coalesces_concurrent_identical(engines):
    _jeng, peng = engines
    pc = Counting(peng, delay=0.1)
    runner = pq.AsyncQueryRunner(pc, pq.QueryJobTable())
    results = []

    def go():
        results.append(_search(run_variant_search, parse_request, pc,
                               runner))

    try:
        threads = [threading.Thread(target=go) for _ in range(5)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert pc.calls == 1  # one execution served all five
        assert len(results) == 5 and all(r == results[0] for r in results)
        assert runner.metrics()["coalesced"] == 4
    finally:
        runner.close()


def test_spilled_answer_read_back_equal_to_jax(engines, tmp_path):
    """A result set past the inline limit spills to disk; a second
    runner on the same job table (no in-memory handoff) reads it back,
    and its answer equals the JAX runner's."""
    jeng, peng = engines
    db, spill_dir = tmp_path / "jobs.sqlite", tmp_path / "spill"
    first = pq.AsyncQueryRunner(peng, pq.QueryJobTable(
        db, spill_dir=spill_dir, inline_limit=64))
    want = _search(run_variant_search, parse_request, peng, first)
    deadline = time.time() + 5
    while not list(spill_dir.glob("*.json")):
        assert time.time() < deadline
        time.sleep(0.01)
    while first.table.get_job_status(
            next(iter(first._results))) is not pq.JobStatus.COMPLETED:
        assert time.time() < deadline
        time.sleep(0.01)
    first.close()
    second_engine = Counting(peng)
    second = pq.AsyncQueryRunner(second_engine, pq.QueryJobTable(
        db, spill_dir=spill_dir, inline_limit=64))
    jr = jq.AsyncQueryRunner(jeng, jq.QueryJobTable())
    try:
        got = _search(run_variant_search, parse_request, second_engine,
                      second)
        assert second_engine.calls == 0  # answered from the table
        assert got == want
        assert got == _search(j_run_variant_search, j_parse_request, jeng,
                              jr)
    finally:
        second.close()
        jr.close()


def test_failed_job_abandoned_and_rerun_directly(engines):
    """A failing kernel launch abandons the job (never cached as an
    empty answer) and the direct re-run raises the real error."""
    _jeng, peng = engines
    runner = pq.AsyncQueryRunner(peng, pq.QueryJobTable())
    body = {"query": {**BODY["query"], "requestedGranularity": "count"}}
    try:
        faults.install({"rules": [{"site": "kernel.launch"}]})
        with pytest.raises(faults.FaultError):
            _search(run_variant_search, parse_request, peng, runner, body)
        faults.uninstall()
        # the job id reads NEW again, so the retry runs and answers
        got = _search(run_variant_search, parse_request, peng, runner, body)
        assert got[0] is True
    finally:
        faults.uninstall()
        runner.close()


def test_deadline_and_request_timeout(engines):
    """The result wait is clamped by the request deadline (504 path:
    DeadlineExceeded) and by request_timeout_s while the job still runs
    (TimeoutError, no second search)."""
    _jeng, peng = engines
    slow = Counting(peng, delay=0.5)
    runner = pq.AsyncQueryRunner(slow, pq.QueryJobTable())
    try:
        with deadline_scope(Deadline.after(0.05)):
            with pytest.raises(DeadlineExceeded):
                _search(run_variant_search, parse_request, slow, runner)
        timed = Counting(peng, delay=0.5)
        timed.config = dataclasses.replace(
            peng.config, engine=dataclasses.replace(
                peng.config.engine, request_timeout_s=0.05))
        runner2 = pq.AsyncQueryRunner(timed, pq.QueryJobTable())
        try:
            with pytest.raises(TimeoutError, match="timed out after 0.05s"):
                _search(run_variant_search, parse_request, timed, runner2)
            assert timed.calls == 1
        finally:
            runner2.close()
    finally:
        runner.close()
