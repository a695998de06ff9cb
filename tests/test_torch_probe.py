"""The port's device time probes held against the JAX package.

``device_time_probe`` (the match kernel on a query mix) and
``device_plane_probe`` (the plane-stats kernel on a row set) keep the JAX
signatures and return values. What a CPU run can check: the probe splits
a mix into the same tiers with the same shares, slot batches and
gathered bytes as JAX's, and both probes return a positive time (the
host clock around the twins, since the caller asked for the CPU). The
device times themselves come from CUDA events on the card
(chip_smoke.py phase 18).
"""

import random
import time

import numpy as np
import pytest

from sbeacon_tpu.index import build_index as j_build_index
from sbeacon_tpu.ops import QuerySpec as JQuerySpec
from sbeacon_tpu.ops import scatter_kernel as jsk
from sbeacon_tpu.testing import random_records as j_random_records
from sbeacon_tpu_torch import telemetry
from sbeacon_tpu_torch.index import shard_from_reference
from sbeacon_tpu_torch.ops import plane_kernel as tpk
from sbeacon_tpu_torch.ops import scatter_kernel as tsk
from sbeacon_tpu_torch.ops.kernel import QuerySpec, encode_queries
from sbeacon_tpu_torch.ops.query_pack import Q_HI, Q_LO, pack_q8, window_bounds
from sbeacon_tpu_torch.testing import synthetic_shard


@pytest.fixture(scope="module")
def indexes():
    rng = random.Random(31)
    recs = []
    for chrom in ("1", "22"):
        recs += j_random_records(rng, chrom=chrom, n=1500, n_samples=0,
                                 spacing=12, p_symbolic=0.1,
                                 p_multiallelic=0.3)
    jshard = j_build_index(recs, dataset_id="p")
    return (jsk.ScatterDeviceIndex(jshard),
            tsk.ScatterDeviceIndex(shard_from_reference(jshard), "cpu"))


def _mix(shard, n, seed):
    """(JAX specs, port specs): exact points that hit, any-base and typed
    brackets of a few rows to a few hundred, and exact brackets."""
    rng = random.Random(seed)
    pos = shard.cols["pos"]
    out = []
    for _ in range(n):
        i = rng.randrange(shard.n_rows - 300)
        kw = dict(chrom=shard.row_chrom(i), start_min=int(pos[i]),
                  end_min=1, end_max=1 << 30)
        kind = rng.randrange(4)
        if kind == 0:
            kw.update(start_max=int(pos[i]), alternate_bases=shard.row_alt(i))
        elif kind == 1:
            kw.update(start_max=int(pos[i + rng.randint(0, 250)]),
                      alternate_bases="N")
        elif kind == 2:
            kw.update(start_max=int(pos[i + rng.randint(0, 40)]),
                      variant_type=rng.choice(["DEL", "INS", "CNV"]))
        else:
            kw.update(start_max=int(pos[i + rng.randint(0, 250)]),
                      reference_bases=shard.row_ref(i),
                      alternate_bases=shard.row_alt(i))
        out.append(kw)
    return [JQuerySpec(**kw) for kw in out], [QuerySpec(**kw) for kw in out]


def _recorder(calls, hot):
    """A stand-in for ``_probe_one_tier`` in either package: records each
    tier's batch and returns 1 s for call ``hot`` (0 else), so the probe's
    share-weighted seconds is that tier's share."""

    def fake(sindex, tile_ids, q8, *, cap, C, iters, exact_only=False):
        calls.append((np.asarray(tile_ids).copy(), np.asarray(q8).copy(),
                      cap, C, exact_only))
        return (1.0 if len(calls) - 1 == hot else 0.0), 0

    return fake


@pytest.mark.parametrize("window_cap", [None, 1000])
@pytest.mark.parametrize("n", [40, 100])
def test_tiers_and_shares_equal_jax(indexes, monkeypatch, n, window_cap):
    """Every tier the probe times (its slot batch, tile ids, packed
    queries, cap, C, exact split) and its share equal JAX's."""
    jidx, tidx = indexes
    jq, tq = _mix(tidx.shard, n, seed=n)
    hot = 0
    while True:
        j_calls, t_calls = [], []
        monkeypatch.setattr(jsk, "_probe_one_tier", _recorder(j_calls, hot))
        monkeypatch.setattr(tsk, "_probe_one_tier", _recorder(t_calls, hot))
        want = jsk.device_time_probe(jidx, jq, window_cap=window_cap)
        got = tsk.device_time_probe(tidx, tq, window_cap=window_cap)
        assert got == want
        assert len(t_calls) == len(j_calls) >= 2
        for (ti, tq8, *t_rest), (ji, jq8, *j_rest) in zip(t_calls, j_calls):
            assert len(ti) == (64 if n <= 64 else 2048)
            assert np.array_equal(ti, ji) and np.array_equal(tq8, jq8)
            assert t_rest == j_rest
        if hot == len(t_calls) - 1:
            break
        assert 0.0 < got[0] < 1.0  # call `hot` carries a share of the mix
        hot += 1


@pytest.mark.parametrize("n", [40, 100])
def test_gathered_bytes_equal_jax(indexes, monkeypatch, n):
    """The bytes gathered per batch come from the same formula. JAX's
    chain program is replaced by a host sleep of 0.2 ms a link, so its
    chain differencing runs on the CPU in a fraction of a second."""
    jidx, tidx = indexes
    jq, tq = _mix(tidx.shard, n, seed=n + 1)

    def chain(*_a, k, **_kw):
        time.sleep(k * 2e-4)
        return np.int32(0)

    monkeypatch.setattr(jsk, "_probe_rep", chain)
    _per, want = jsk.device_time_probe(jidx, jq, window_cap=1000)
    telemetry.reset_launch_counts()
    per, got = tsk.device_time_probe(tidx, tq, window_cap=1000, iters=1)
    assert got == want > 0
    assert per > 0.0
    assert tsk.scatter_match_launches == 0  # the CPU ran the twin


def test_plane_probe_times_the_twin_on_cpu():
    shard = synthetic_shard(800, seed=4, chroms=["1"], n_samples=70,
                            with_gt_planes=True, plane_density=0.2)
    pidx = tpk.PlaneDeviceIndex(shard, "cpu")
    rows = np.arange(0, 800, 3, dtype=np.int32)
    mask = tpk.sample_mask_words(range(0, 70, 2), pidx.n_words)
    telemetry.reset_launch_counts()
    seconds = tpk.device_plane_probe(pidx, rows, mask, iters=2)
    assert isinstance(seconds, float) and seconds > 0.0
    assert tpk.plane_stats_launches == 0


def test_probe_shifts_windows_by_whole_tiles(indexes, monkeypatch):
    """Each timed launch reads other tiles: the batch's windows move by
    whole tiles, keeping every slot's width, offset in its tile, tier and
    query fields."""
    _jidx, tidx = indexes
    _jq, tq = _mix(tidx.shard, 40, seed=9)
    enc = encode_queries(tq)
    lo, hi = window_bounds(tidx, enc)
    q8, _ = pack_q8(enc, lo, hi)
    ids = (lo // tidx.tile).astype(np.int32)
    seen = []

    def record(tiles, tile_ids, qarr, **kw):
        seen.append((tile_ids.numpy().copy(), qarr.numpy().copy(), kw))
        return None, None, None

    monkeypatch.setattr(tsk, "scatter_match", record)
    tsk._probe_one_tier(tidx, ids, q8, cap=256, C=None, iters=16)
    T = tidx.tile
    span = tidx.n_tiles - tidx.MAX_C
    moved = {t.tobytes() for t, _q, _kw in seen}
    assert len(moved) == tsk.PROBE_SHIFTS
    for t, q, kw in seen:
        assert kw["CAP"] == 256 and kw["C"] is None
        assert ((0 <= t) & (t < span)).all()
        assert np.array_equal(q[:, Q_LO] - t * T, q8[:, Q_LO] - ids * T)
        assert np.array_equal(q[:, Q_HI] - q[:, Q_LO], q8[:, Q_HI] - q8[:, Q_LO])
        rest = [c for c in range(q.shape[1]) if c not in (Q_LO, Q_HI)]
        assert np.array_equal(q[:, rest], q8[:, rest])
