"""The launch/fetch split of the port held against the JAX package's.

``run_queries(async_fetch=True)`` (the bisection kernel on a fused stack
and on an L0 composite) and ``MeshFusedIndex.run_mesh_queries(
async_fetch=True)`` (two CPU entries, every layout, with and without
planes) return a pending handle whose ``fetch()`` must equal the JAX
package's answer at tolerance 0; the scatter index answers behind
``ReadyQueryResults``. The micro-batcher's fetch stage is driven in both
packages through a fake index whose ``fetch()`` blocks on an event: with
``pipeline_depth`` d, batch d + 1 waits for a pipeline slot until a fetch
returns; a fetch that raises reaches every waiter of its batch and frees
its slot; ``close()`` leaves no fetcher thread. Everything runs on the
CPU, where a handle's readback is the twin's output itself.
"""

import random
import threading
import time

import jax
import numpy as np
import pytest
import torch

from sbeacon_tpu import serving as jserving
from sbeacon_tpu.index.columnar import build_index as j_build_index
from sbeacon_tpu.ops import kernel as jk
from sbeacon_tpu.ops import run_queries_auto as j_run_queries_auto
from sbeacon_tpu.parallel import mesh as jm
from sbeacon_tpu.testing import random_records
from sbeacon_tpu_torch import serving as tserving
from sbeacon_tpu_torch.index import shard_from_reference
from sbeacon_tpu_torch.ops import (
    ReadyQueryResults,
    make_device_index,
    run_queries_auto,
)
from sbeacon_tpu_torch.ops import kernel as tk
from sbeacon_tpu_torch.parallel import mesh as tm
from torch_ingest_corpus import no_thread_leak  # noqa: F401

CPU = torch.device("cpu")
FIELDS = ("exists", "call_count", "n_variants", "all_alleles_count",
          "n_matched", "overflow", "rows")
PLANE_FIELDS = ("pc_call", "pc_tok", "or_words")
LAYOUTS = {"owner": tm.LAYOUT_OWNER, "sliced": tm.LAYOUT_SLICED,
           "replicated": tm.LAYOUT_REPLICATED}
SPECS = [
    ("1", 1, 1 << 30, dict(alternate_bases="N")),
    ("1", 1500, 2500, dict(alternate_bases="N")),
    ("1", 900, 1600, dict(alternate_bases="N")),
    ("1", 1, 1 << 30, dict(variant_type="DEL")),
    ("1", 1, 1 << 30, dict(alternate_bases="N", reference_bases="A")),
    ("2", 1, 1 << 30, dict(alternate_bases="N")),
    ("7", 1, 1 << 30, dict(alternate_bases="N")),  # absent chromosome
]


def _shards(n, rows=250, n_samples=3, seed0=90):
    out = []
    for d in range(n):
        rng = random.Random(seed0 + d)
        recs = random_records(rng, chrom=rng.choice(["1", "2"]), n=rows,
                              n_samples=n_samples)
        out.append(j_build_index(
            recs, dataset_id=f"d{d}", vcf_location=f"v{d}",
            sample_names=[f"S{i}" for i in range(n_samples)]))
    return out


def _enc(mod, sids, specs=SPECS):
    pairs = [(s, sid) for s in specs for sid in sids]
    random.Random(len(pairs)).shuffle(pairs)
    return mod.encode_queries(
        [mod.QuerySpec(c, a, b, 1, 1 << 30, **kw) for (c, a, b, kw), _ in pairs],
        shard_ids=[sid for _, sid in pairs])


def _assert_same(got, want, fields=FIELDS):
    for name in fields:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.shape == w.shape and np.array_equal(g, w), name


@pytest.fixture(scope="module")
def shards():
    return _shards(4)


# -- the pending handles against JAX -----------------------------------------


@pytest.mark.parametrize("record_cap", [1024, 16])
def test_fused_pending_fetch_equals_jax(shards, record_cap):
    """The fused stack's pending handle: launched, not read, then fetched,
    equal to JAX's pending handle and to the synchronous call."""
    tf = tk.FusedDeviceIndex([shard_from_reference(s) for s in shards], CPU)
    jf = jk.FusedDeviceIndex(shards)
    sids = range(len(shards))
    pending = tk.run_queries(tf, _enc(tk, sids), window_cap=2048,
                             record_cap=record_cap, async_fetch=True)
    assert isinstance(pending, tk.PendingQueryResults)
    want = jk.run_queries(jf, _enc(jk, sids), window_cap=2048,
                          record_cap=record_cap, async_fetch=True).fetch()
    got = pending.fetch()
    _assert_same(got, want)
    # the handle let go of the launch's buffers
    assert pending._out is None and pending._host is None
    _assert_same(tk.run_queries(tf, _enc(tk, sids), window_cap=2048,
                                record_cap=record_cap), got)
    via_auto = run_queries_auto(tf, _enc(tk, sids), window_cap=2048,
                                record_cap=record_cap, async_fetch=True)
    _assert_same(via_auto.fetch(), want)


def test_l0_pending_fetch_equals_jax():
    """The delta tail's L0 composite (two blocks) behind the same
    handle, against JAX's."""
    tails = [_shards(3, rows=60, seed0=300), _shards(2, rows=90, seed0=400)]
    jc = jk.CompositeL0DeviceIndex([jk.L0DeviceIndex(b) for b in tails])
    tc = tk.CompositeL0DeviceIndex([
        tk.L0DeviceIndex([shard_from_reference(s) for s in b], CPU)
        for b in tails])
    assert tc.block_sid_offsets == jc.block_sid_offsets
    sids = [off + j for off, b in zip(tc.block_sid_offsets, tails)
            for j in range(len(b))]
    pending = tk.run_queries(tc, _enc(tk, sids), window_cap=2048,
                             record_cap=64, async_fetch=True)
    want = jk.run_queries(jc, _enc(jk, sids), window_cap=2048,
                          record_cap=64, async_fetch=True).fetch()
    _assert_same(pending.fetch(), want)


def test_scatter_index_answers_behind_ready_results(shards):
    """A single-shard scatter index reads back inside its launch and
    hands the result behind ReadyQueryResults, as JAX's does."""
    shard = shard_from_reference(shards[0])
    di = make_device_index(shard, "cpu")
    enc = tk.encode_queries([tk.QuerySpec(c, a, b, 1, 1 << 30, **kw)
                             for c, a, b, kw in SPECS])
    ready = run_queries_auto(di, enc, window_cap=2048, record_cap=64,
                             async_fetch=True)
    assert isinstance(ready, ReadyQueryResults)
    _assert_same(ready.fetch(), run_queries_auto(di, enc, window_cap=2048,
                                                 record_cap=64))
    with pytest.raises(ValueError, match="sample_masks"):
        run_queries_auto(di, enc, sample_masks=np.zeros((7, 1), np.uint32))


_JAX_MESH: dict = {}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("planes", [False, True])
def test_mesh_pending_fetch_equals_jax(shards, layout, planes):
    """MeshFusedIndex on two CPU entries: the undrained handle's fetch
    equals JAX's, with and without per-query sample masks."""
    sids = range(len(shards))
    b = len(SPECS) * len(shards)
    kw = dict(window_cap=2048, record_cap=48)
    if planes:
        w = max(s.gt_bits.shape[1] for s in shards)
        rng = np.random.default_rng(b)
        kw.update(sample_masks=rng.integers(0, 2**32, (b, w), np.uint64)
                  .astype(np.uint32),
                  mask_counts=np.arange(b) % 2 == 0)
    if planes not in _JAX_MESH:
        jmfi = jm.MeshFusedIndex(shards, jm.make_mesh(2), with_planes=planes)
        _JAX_MESH[planes] = jmfi.run_mesh_queries(
            _enc(jk, sids), async_fetch=True, **kw).fetch()
    want = _JAX_MESH[planes]
    mfi = tm.MeshFusedIndex([shard_from_reference(s) for s in shards],
                            tm.make_mesh(devices=[CPU, CPU]),
                            with_planes=planes, layout=LAYOUTS[layout])
    pending = mfi.run_mesh_queries(_enc(tk, sids), async_fetch=True, **kw)
    assert isinstance(pending, tm.MeshPendingResults)
    got = pending.fetch()
    _assert_same(got, want, FIELDS + (PLANE_FIELDS if planes else ()))
    _assert_same(mfi.run_mesh_queries(_enc(tk, sids), **kw), got,
                 FIELDS + (PLANE_FIELDS if planes else ()))


def test_mesh_fan_in_matches_psum():
    """The combine's device fan-in, folded, equals the read-back _psum
    (int64 sums wrapped to int32 as lax.psum wraps)."""
    parts = [torch.tensor([[2**31 - 1, 5], [-7, 1]], dtype=torch.int32),
             torch.tensor([[1, 2**31 - 1], [7, -2**31]], dtype=torch.int32)]
    folded = tm._fold(tm._fan_in(parts), torch.int32)
    assert folded.dtype == torch.int32
    np.testing.assert_array_equal(folded.numpy(), tm._psum(parts))
    want = np.asarray(jax.jit(lambda a, b: a + b)(
        parts[0].numpy(), parts[1].numpy()))
    np.testing.assert_array_equal(folded.numpy(), want)


# -- the batcher's fetch stage in both packages --------------------------------


class _Handle:
    def __init__(self, res, gate, fail):
        self._res, self._gate, self._fail = res, gate, fail

    def fetch(self):
        assert self._gate.wait(20), "test deadlock: fetch never released"
        if self._fail:
            raise RuntimeError("injected fetch failure")
        return self._res


class _FakeIndex:
    """Duck-typed as a mesh index (``run_mesh_queries``), so both
    packages' ``run_queries_auto`` hand it the encoded batch: every
    launch returns at once with a handle whose ``fetch()`` blocks until
    the test opens that launch's gate. Query i's ``call_count`` is its
    ``start_min``, so each waiter can check it got its own rows."""

    def __init__(self, results_cls):
        self.results_cls = results_cls
        self.lock = threading.Lock()
        self.gates: list[threading.Event] = []
        self.sizes: list[int] = []
        self.fail_next = False

    def run_mesh_queries(self, queries, *, window_cap, record_cap,
                         async_fetch=False, **kw):
        assert async_fetch, "the batcher's launch stage must not fetch"
        b = int(queries["chrom"].shape[0])
        start = np.asarray(queries["start_min"], np.int32)
        res = self.results_cls(
            exists=np.ones(b, np.bool_), call_count=start,
            n_variants=np.zeros(b, np.int32),
            all_alleles_count=np.zeros(b, np.int32),
            n_matched=np.ones(b, np.int32), overflow=np.zeros(b, np.bool_),
            rows=np.arange(b, dtype=np.int32)[:, None])
        gate = threading.Event()
        with self.lock:
            fail, self.fail_next = self.fail_next, False
            self.gates.append(gate)
            self.sizes.append(b)
        return _Handle(res, gate, fail)

    def launched(self) -> int:
        with self.lock:
            return len(self.gates)

    def wait_launched(self, n, limit=10.0):
        t_end = time.monotonic() + limit
        while self.launched() < n and time.monotonic() < t_end:
            time.sleep(0.005)
        return self.launched()


PACKAGES = {
    "jax": (jserving, jk),
    "port": (tserving, tk),
}


def _submitter(mb, index, kmod, pos, out):
    def run():
        try:
            out[pos] = mb.submit(index, kmod.QuerySpec("1", pos, pos + 1, 1,
                                                       1 << 30),
                                 window_cap=256, record_cap=4, shard_id=0)
        except BaseException as e:  # noqa: BLE001 - the test reads it
            out[pos] = e
    t = threading.Thread(target=run)
    t.start()
    return t


def _pipeline_trace(serving_mod, kmod, depth):
    """What the pipeline bound lets through: launches seen after each
    of d + 1 one-query submissions, then after the first fetch returns,
    then every answer."""
    mb = serving_mod.MicroBatcher(max_batch=1, max_wait_ms=0,
                                  pipeline_depth=depth, default_timeout_s=30)
    index = _FakeIndex(kmod.QueryResults)
    out, threads, trace = {}, [], []
    try:
        for i in range(depth + 1):
            threads.append(_submitter(mb, index, kmod, 100 + i, out))
            if i < depth:
                trace.append(index.wait_launched(i + 1))
        time.sleep(0.3)  # the last batch waits at the pipeline slot
        trace.append(index.launched())
        index.gates[0].set()
        trace.append(index.wait_launched(depth + 1))
        for g in list(index.gates):
            g.set()
        for t in threads:
            t.join(20)
            assert not t.is_alive()
        trace.append(sorted(int(r.call_count[0]) for r in out.values()))
        occ = mb.occupancy()
        timing = mb.timing_summary()
    finally:
        mb.close()
    return trace, occ, timing


@pytest.mark.parametrize("depth", [1, 2])
def test_batch_past_the_depth_waits_for_a_fetch(depth):
    """With pipeline_depth d, d batches launch and batch d + 1 waits at
    its slot until a fetch returns, in both packages."""
    got = {name: _pipeline_trace(*mods, depth)
           for name, mods in PACKAGES.items()}
    want = list(range(1, depth + 1)) + [depth, depth + 1, [
        100 + i for i in range(depth + 1)]]
    for name, (trace, occ, timing) in got.items():
        assert trace == want, name
        assert occ["launches"] == depth + 1
        assert set(occ["fetcher"]) == {"threads", "queued"}
        assert timing["fetch_ms"]["p50"] >= 0 and "exec_ms" in timing
    assert set(got["port"][1]) == set(got["jax"][1])
    assert set(got["port"][2]) == set(got["jax"][2])


def _failure_trace(serving_mod, kmod):
    mb = serving_mod.MicroBatcher(max_batch=2, max_wait_ms=300,
                                  pipeline_depth=1, default_timeout_s=30)
    index = _FakeIndex(kmod.QueryResults)
    index.fail_next = True
    out = {}
    try:
        threads = [_submitter(mb, index, kmod, 10 + i, out) for i in range(2)]
        assert index.wait_launched(1) == 1
        index.gates[0].set()
        for t in threads:
            t.join(20)
        errors = sorted(str(out[10 + i]) for i in range(2))
        # the slot came back: the next batch launches and is answered
        nxt = {}
        t = _submitter(mb, index, kmod, 77, nxt)
        assert index.wait_launched(2) == 2
        index.gates[1].set()
        t.join(20)
        occ = mb.occupancy()
    finally:
        mb.close()
    return errors, index.sizes, int(nxt[77].call_count[0]), occ["launches"]


def test_failed_fetch_reaches_every_waiter_and_frees_its_slot():
    """A fetch that raises fails both waiters of its batch with that
    error, nothing is rerun, and the next batch is served, as in JAX."""
    got = {name: _failure_trace(*mods) for name, mods in PACKAGES.items()}
    assert got["port"] == got["jax"]
    errors, sizes, answer, launches = got["port"]
    assert errors == ["injected fetch failure"] * 2
    assert sizes == [2, 1] and answer == 77 and launches == 2


def test_failed_launch_frees_its_slot():
    """A launch that raises fails its waiters and gives its slot back:
    at depth 1 the next batch still launches."""
    mb = tserving.MicroBatcher(max_batch=1, max_wait_ms=0, pipeline_depth=1,
                               default_timeout_s=30)
    index = _FakeIndex(tk.QueryResults)
    boom = [True]
    orig = index.run_mesh_queries

    def launch(queries, **kw):
        if boom and boom.pop():
            raise RuntimeError("injected launch failure")
        return orig(queries, **kw)

    index.run_mesh_queries = launch
    try:
        out = {}
        _submitter(mb, index, tk, 5, out).join(20)
        assert str(out[5]) == "injected launch failure"
        t = _submitter(mb, index, tk, 6, out)
        assert index.wait_launched(1) == 1
        index.gates[0].set()
        t.join(20)
        assert int(out[6].call_count[0]) == 6
    finally:
        mb.close()


@pytest.mark.parametrize("name", list(PACKAGES))
def test_close_leaves_no_fetcher_thread(name):
    """close() stops the fetcher pool's workers in both packages (the
    autouse no_thread_leak fixture fails a test that leaves one)."""
    serving_mod, kmod = PACKAGES[name]
    before = set(threading.enumerate())
    mb = serving_mod.MicroBatcher(max_batch=4, max_wait_ms=0)
    index = _FakeIndex(kmod.QueryResults)
    out = {}
    t = _submitter(mb, index, kmod, 3, out)
    assert index.wait_launched(1) == 1
    index.gates[0].set()
    t.join(20)
    assert int(out[3].call_count[0]) == 3
    assert mb.occupancy()["fetcher"]["threads"] == 1
    fetchers = [th for th in threading.enumerate()
                if th.name.startswith("kernel-fetch") and th not in before]
    assert len(fetchers) == 1
    mb.close()
    for th in fetchers:
        th.join(10)
    assert not any(th.is_alive() for th in fetchers)
    with pytest.raises(RuntimeError, match="closed"):
        mb._fetcher.submit(lambda: None)


def test_engine_batcher_takes_the_configured_depth(monkeypatch):
    """EngineConfig.fetch_pipeline_depth (BEACON_FETCH_PIPELINE_DEPTH)
    reaches the engine's batcher, as in JAX."""
    from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
    from sbeacon_tpu.engine import VariantEngine as JVariantEngine
    from sbeacon_tpu_torch.config import BeaconConfig
    from sbeacon_tpu_torch.engine import VariantEngine

    monkeypatch.setenv("BEACON_FETCH_PIPELINE_DEPTH", "3")
    cfg, jcfg = BeaconConfig.from_env(), JBeaconConfig.from_env()
    assert cfg.engine.fetch_pipeline_depth == jcfg.engine.fetch_pipeline_depth
    assert cfg.engine.fetch_pipeline_depth == 3
    assert '"fetch_pipeline_depth": 3' in cfg.dumps()
    eng = VariantEngine(cfg, device="cpu")
    jeng = JVariantEngine(jcfg)
    try:
        assert eng.batcher.pipeline_depth == jeng.batcher.pipeline_depth == 3
    finally:
        eng.close()
        jeng.close()


def test_served_launch_records_carry_the_fetch(shards):
    """Through the batcher, every submission is answered from its own
    rows of the fetched batch, equal to JAX's batcher on the same fused
    stack; each batched launch adds one fetch sample."""
    tf = tk.FusedDeviceIndex([shard_from_reference(s) for s in shards], CPU)
    jf = jk.FusedDeviceIndex(shards)
    specs = [(tk.QuerySpec(c, a, b, 1, 1 << 30, **kw),
              jk.QuerySpec(c, a, b, 1, 1 << 30, **kw), sid)
             for c, a, b, kw in SPECS for sid in range(len(shards))]
    got = {}
    for name, mb, index, col in (
        ("port", tserving.MicroBatcher(max_wait_ms=20), tf, 0),
        ("jax", jserving.MicroBatcher(max_wait_ms=20), jf, 1),
    ):
        res = [None] * len(specs)

        def run(i, mb=mb, index=index, col=col, res=res):
            res[i] = mb.submit(index, specs[i][col], window_cap=2048,
                               record_cap=32, shard_id=specs[i][2])

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(specs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        # one fetch sample a batched launch
        n_fetched = len(mb._fetch_ms)
        occ = mb.occupancy()
        mb.close()
        got[name] = (res, n_fetched, occ)
    for tr, jr in zip(got["port"][0], got["jax"][0]):
        _assert_same(tr, jr)
    for name, (_res, n_fetched, occ) in got.items():
        assert occ["submits"] == len(specs), name
        assert n_fetched == occ["launches"] >= 1, name


def test_run_queries_auto_signature_matches_jax():
    """run_queries_auto takes JAX's keywords, async_fetch included."""
    import inspect

    def params(fn):
        return [(p.name, p.default) for p in
                inspect.signature(fn).parameters.values()]

    assert params(run_queries_auto) == params(j_run_queries_auto)
    assert params(tserving.MicroBatcher.__init__) == params(
        jserving.MicroBatcher.__init__)
    assert params(tk.run_queries) == params(jk.run_queries)
