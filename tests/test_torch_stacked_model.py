"""The stacked kernels' search and fan-in (``csrc/stacked_core.cuh``,
shared by J7 query ``csrc/stacked_query.cu`` and J7 selected
``csrc/stacked_selected.cu``), as the card runs them, held against
``warp_bound``, numpy, JAX and the twins.

- The search: each bound is found by four warps probing 128 rows a
  step (``block_bound``), where ``warp_bound`` (``csrc/bisect_core.cuh``)
  probes 32. A numpy model of each, warp ballots included, must return
  what ``np.searchsorted`` and JAX's ``_bisect`` return on a sorted
  segment: hypothesis draws the segments, and the edge cases are named
  (empty and inverted segments, clamped chromosome codes, runs of equal
  pos at the target, ``start_max = INT32_MAX``, a padding dataset's
  all-zero segment row).
- The fan-in: a cluster of c = min(d_local, 8) blocks per query, block
  ``rank`` summing datasets rank, rank + c, ... and the leader summing
  the blocks' partials. A numpy model of it (uint32 sums, as on the
  card) must equal the twin's ``agg`` (``local_query_reference``) and
  JAX's int32 sums for d_local 1-17, with wraparound and negative
  ``call_count`` (not a hit); the same fan-in of J7 selected's three
  partials (call_count, all_alleles, overflow) must equal
  ``local_selected_reference``'s ``agg`` and JAX's int32 sums.

The kernel itself is held against the twin on the card
(tests/test_torch_cuda.py, chip_smoke.py). Every value is an integer:
the tolerance is 0.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sbeacon_tpu.ops.kernel import _bisect as j_bisect
from sbeacon_tpu_torch.index import build_index
from sbeacon_tpu_torch.ops import kernel as tk
from sbeacon_tpu_torch.parallel import mesh as tm
from sbeacon_tpu_torch.testing import random_records

INT32_MAX = 2**31 - 1
N_SEGS = 27  # a segment table row: chromosome codes 0-25 and the end
MAX_CLUSTER = 8  # stacked_core.cuh kMaxCluster
C_AC = 8  # rows of the stacked column tensor (ops.kernel.C_AC)
SETTINGS = settings(max_examples=300, deadline=None, database=None,
                    derandomize=True)


def _bound(pos, a, b, target, upper, probes):
    """``block_bound`` (probes 128: four warps) or ``warp_bound`` (probes
    32: one warp): each step, thread t probes row a + t * step (step =
    ceil((b - a) / probes)) and each warp's ballot counts the probes
    that lie before the answer; the warps' counts are summed. Returns
    (the first row of [a, b) with pos >= target (> when ``upper``), or
    b; the number of steps)."""
    steps = 0
    while a < b:
        step = -(-(b - a) // probes)
        idx = a + np.arange(probes, dtype=np.int64) * step
        before = np.zeros(probes, dtype=bool)
        ok = idx < b
        p = pos[idx[ok]]
        before[ok] = (p <= target) if upper else (p < target)
        c = sum(int(np.count_nonzero(before[w : w + 32]))
                for w in range(0, probes, 32))
        a, b = (a + (c - 1) * step + 1 if c > 0 else a), min(a + c * step, b)
        steps += 1
    return a, steps


def _segment(seg, chrom):
    """The kernels' segment of chromosome code ``chrom`` in a 27-entry
    row, indices clamped as an XLA gather clamps them."""
    return (int(seg[min(max(chrom, 0), N_SEGS - 1)]),
            int(seg[min(max(chrom + 1, 0), N_SEGS - 1)]))


def _want(pos, a, b, target, upper):
    if a >= b:
        return a
    side = "right" if upper else "left"
    return a + int(np.searchsorted(pos[a:b], target, side=side))


def _jax(pos, a, b, target, upper):
    return int(j_bisect(jnp.asarray(pos, jnp.int32), jnp.int32(target),
                        jnp.int32(a), jnp.int32(b), 32, upper=upper))


def _check(pos, seg, chrom, target, jax_too=False):
    a, b = _segment(seg, chrom)
    for upper in (False, True):
        want = _want(pos, a, b, target, upper)
        got128, _ = _bound(pos, a, b, target, upper, 128)
        got32, _ = _bound(pos, a, b, target, upper, 32)
        assert got128 == got32 == want, (a, b, target, upper)
        if jax_too:
            assert _jax(pos, a, b, target, upper) == want


@st.composite
def _segments(draw):
    """A sorted pos column of 1-27 chromosome segments with runs of equal
    pos, its segment row, a chromosome code (clamped ones too) and a
    target at, between, or beyond the positions."""
    seed = draw(st.integers(0, 2**32 - 1))
    n = draw(st.integers(0, 3000))
    dup = draw(st.sampled_from([0.0, 0.5, 0.95]))
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(0, n + 1, size=N_SEGS - 1))
    seg = np.concatenate([[0], cuts]).astype(np.int64)
    seg[-1] = n
    pos = np.zeros(n, dtype=np.int64)
    for lo, hi in zip(seg[:-1], seg[1:]):
        steps = np.where(rng.random(hi - lo) < dup, 0,
                         rng.integers(1, 50, size=hi - lo))
        pos[lo:hi] = 1 + np.cumsum(steps)
    chrom = draw(st.integers(-3, N_SEGS + 3))
    lo, hi = _segment(seg, chrom)
    inside = [int(pos[rng.integers(lo, hi)])] if hi > lo else []
    target = draw(st.sampled_from(inside + [0, 1, 25, 10**6, INT32_MAX,
                                            -(2**31)]))
    return pos, seg, chrom, target


@SETTINGS
@given(_segments())
def test_block_bound_model_equals_warp_bound_and_searchsorted(case):
    _check(*case)


@pytest.mark.parametrize("case", [
    "empty", "inverted", "below_codes", "above_codes", "equal_run",
    "int32_max", "padding_row", "one_row",
])
def test_block_bound_edge_cases(case):
    """The named edge cases, also against JAX's ``_bisect``."""
    pos = np.repeat(np.arange(1, 401, dtype=np.int64), 3)  # runs of three
    seg = np.linspace(0, len(pos), N_SEGS).astype(np.int64)
    chrom, target = 3, int(pos[seg[3] + 7])
    if case == "empty":
        seg[4] = seg[3]
    elif case == "inverted":
        seg[4] = seg[3] - 5
    elif case == "below_codes":
        chrom = -4
    elif case == "above_codes":
        chrom, seg[-1] = N_SEGS + 2, len(pos)
    elif case == "equal_run":
        pos[seg[3] : seg[4]] = target
    elif case == "int32_max":
        target = INT32_MAX
    elif case == "padding_row":
        seg[:] = 0
    elif case == "one_row":
        seg[4] = seg[3] + 1
    _check(pos, seg, chrom, target, jax_too=True)
    if case == "equal_run":  # the bounds straddle the whole run
        a, b = _segment(seg, chrom)
        assert _bound(pos, a, b, target, False, 128)[0] == a
        assert _bound(pos, a, b, target, True, 128)[0] == b


def test_block_bound_takes_three_steps_on_chr1():
    """A chr1-sized segment of a 2e7-row dataset (1.6e6 rows): at most 3
    steps of 128 probes where 32 probes take up to 5."""
    rng = np.random.default_rng(1)
    pos = np.cumsum(rng.integers(1, 200, size=1_600_000)).astype(np.int64)
    steps = {128: [], 32: []}
    for at in np.linspace(0.0, 1.0, 41):
        target = int(pos[int(at * (len(pos) - 1))]) + int(at * 7) % 2
        for upper in (False, True):
            want = _want(pos, 0, len(pos), target, upper)
            for probes in steps:
                got, n = _bound(pos, 0, len(pos), target, upper, probes)
                assert got == want
                steps[probes].append(n)
    assert max(steps[128]) == 3 and max(steps[32]) == 5


def _cluster_sum(parts):
    """``stacked_core.cuh``'s cluster_sum of per-dataset partials
    ``parts`` int32 [d_local, B, k]: c = min(d_local, 8) blocks, block r
    summing datasets r, r + c, ... in uint32, the leader summing the
    blocks in rank order. Returns the sums int32 [B, k] and each
    dataset's block."""
    d_local, b, k = parts.shape
    c = min(d_local, MAX_CLUSTER)
    u = parts.astype(np.int64).astype(np.uint32)
    fan = np.zeros((c, b, k), dtype=np.uint32)
    owner = {}
    for r in range(c):
        for d in range(r, d_local, c):
            owner[d] = r
            fan[r] += u[d]
    total = np.zeros((b, k), dtype=np.uint32)
    for r in range(c):
        total += fan[r]
    return total.view(np.int32), owner


def _cluster_agg(per):
    """The stacked query kernel's fan-in of per-dataset rows ``per`` int32
    [d_local, B, 6] (exists, call_count, n_variants, all_alleles,
    n_matched, overflow): each block's five partials (call_count,
    all_alleles, n_variants, call_count > 0, overflow) through
    ``_cluster_sum``. Returns agg int32 [B, 5] and each dataset's
    block."""
    parts = np.stack([per[:, :, 1], per[:, :, 3], per[:, :, 2],
                      (per[:, :, 1] > 0).astype(np.int32), per[:, :, 5]],
                     axis=2)
    return _cluster_sum(parts)


def _crafted_rows(d_local, b, R, seed):
    """Per-dataset output rows with call_count, n_variants and
    all_alleles near both ends of the int32 range (the sums wrap) and
    negative call_count on some datasets; -1 padded row ids."""
    rng = np.random.default_rng(seed)
    big = lambda: (rng.choice([-1, 1], size=(d_local, b))
                   * rng.integers(2**31 - 2**20, 2**31, size=(d_local, b)))
    per = np.zeros((d_local, b, tk.N_AGG + R), dtype=np.int64)
    per[:, :, 1] = np.where(rng.random((d_local, b)) < 0.5, big(),
                            rng.integers(-5, 6, size=(d_local, b)))
    per[:, :, 0] = per[:, :, 1] > 0
    per[:, :, 2] = big()
    per[:, :, 3] = big()
    per[:, :, 4] = rng.integers(0, 9, size=(d_local, b))
    per[:, :, 5] = rng.integers(0, 2, size=(d_local, b))
    per[:, :, tk.N_AGG :] = -1
    return per.astype(np.int32)


@pytest.mark.parametrize("d_local", range(1, 18))
def test_cluster_fan_in_model_matches_twin_and_jax(d_local, monkeypatch):
    """The model over crafted per-dataset rows equals the twin's agg (its
    per-dataset query patched to return those rows) and JAX's int32
    sums over datasets; every dataset lies in exactly one block."""
    b, R = 6, 4
    per = _crafted_rows(d_local, b, R, seed=d_local)
    assert (per[:, :, 1] < 0).any()
    monkeypatch.setattr(tm, "_dataset_query",
                        lambda *a, **kw: torch.from_numpy(per[a[4]]))
    z = torch.zeros
    out, agg = tm.local_query_reference(
        z((d_local, 11, 8), dtype=torch.int32),
        z((d_local, 8, 4), dtype=torch.int32),
        z((d_local, N_SEGS), dtype=torch.int32),
        z((b, tk.N_QFIELDS), dtype=torch.int32),
        window_cap=R, record_cap=R, n_iters=4)
    got, owner = _cluster_agg(per)
    assert sorted(owner) == list(range(d_local))
    assert np.array_equal(got, agg.numpy())
    jsum = lambda k: np.asarray(jnp.sum(jnp.asarray(per[:, :, k]), axis=0))
    want = np.stack([jsum(1), jsum(3), jsum(2),
                     np.asarray(jnp.sum(jnp.asarray(per[:, :, 1]) > 0,
                                        axis=0, dtype=jnp.int32)),
                     jsum(5)], axis=1)
    assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def shards():
    rng = random.Random(31)
    return [build_index(random_records(rng, chrom="1", n=150, n_samples=0,
                                       spacing=20, p_multiallelic=0.3),
                        dataset_id=f"d{i}") for i in range(4)]


@pytest.mark.parametrize("d_local", [1, 3, 8, 9, 17])
def test_cluster_fan_in_model_on_a_stack(shards, d_local):
    """On a real stack of d_local datasets (the last a padding one once
    d_local > 1), AC overwritten with values near both ends of the int32
    range: the model over the twin's per-dataset rows equals its agg."""
    real = max(1, d_local - 1)
    stack = tm.StackedIndex([shards[i % len(shards)] for i in range(real)],
                            n_datasets_padded=d_local)
    (blk,) = stack.shard_to_mesh(tm.make_mesh(devices=[torch.device("cpu")]))
    rng = np.random.default_rng(d_local)
    ac = (rng.choice([-1, 1], size=blk.columns[:, C_AC].shape)
          * rng.integers(2**30, 2**31, size=blk.columns[:, C_AC].shape))
    cols = blk.columns.clone()
    cols[:, C_AC] = torch.from_numpy(ac.astype(np.int32))
    specs = [tk.QuerySpec("1", 1, 10**7, 1, 1 << 30, alternate_bases="N"),
             tk.QuerySpec("1", 500, 2500, 1, 1 << 30, alternate_bases="N"),
             tk.QuerySpec("1", 1, 10**7, 1, 1 << 30, variant_type="DEL"),
             tk.QuerySpec("22", 1, 10**7, 1, 1 << 30)]
    q = torch.from_numpy(tk.pack_queries(tk.encode_queries(specs),
                                         fused=False))
    out, agg = tm.local_query_reference(cols, blk.alt_prefix, blk.offsets, q,
                                        window_cap=256, record_cap=16,
                                        n_iters=stack.n_iters)
    got, _owner = _cluster_agg(out[:, :, : tk.N_AGG].numpy())
    assert np.array_equal(got, agg.numpy())
    assert (out[:, :, 1] < 0).any()  # sums past the int32 range wrapped


def _crafted_selected(d_local, b, R, seed):
    """Per-dataset outputs of the stacked selected kernel's two stages:
    the query rows (n_matched and overflow; no matched row, so no plane
    row is read) and the plane reduction's call_count and all_alleles
    near both ends of the int32 range (the sums wrap)."""
    rng = np.random.default_rng(seed)
    big = lambda: (rng.choice([-1, 1], size=(d_local, b))
                   * rng.integers(2**31 - 2**20, 2**31, size=(d_local, b)))
    per = np.zeros((d_local, b, tk.N_AGG + R), dtype=np.int64)
    per[:, :, 4] = rng.integers(0, 2 * R, size=(d_local, b))
    per[:, :, 5] = rng.integers(0, 2, size=(d_local, b))
    per[:, :, tk.N_AGG :] = -1
    sums = np.stack([big(), np.where(rng.random((d_local, b)) < 0.5, big(),
                                     rng.integers(-5, 6, (d_local, b)))],
                    axis=2)
    return per.astype(np.int32), sums.astype(np.int32)


@pytest.mark.parametrize("d_local", range(1, 18))
def test_selected_fan_in_model_matches_twin_and_jax(d_local, monkeypatch):
    """J7 selected's fan-in: each block's three partials (call_count,
    all_alleles, overflow | n_matched > record_cap) through the cluster
    model equal the twin's agg (its per-dataset query and plane
    reduction patched to crafted outputs) and JAX's int32 sums over
    datasets; every dataset lies in exactly one block."""
    b, R, w, record_cap = 6, 4, 2, 3
    per, sums = _crafted_selected(d_local, b, R, seed=100 + d_local)
    monkeypatch.setattr(tm, "_dataset_query",
                        lambda *a, **kw: torch.from_numpy(per[a[4]]))
    calls = iter(range(d_local))

    def plane_reduce(*a, **kw):
        d = next(calls)
        z = torch.zeros((b, R), dtype=torch.int32)
        return {"call_count": torch.from_numpy(sums[d, :, 0]),
                "all_alleles_count": torch.from_numpy(sums[d, :, 1]),
                "or_words": torch.zeros((b, w), dtype=torch.int32),
                "pc_call": z, "pc_tok": z}

    monkeypatch.setattr(tm, "plane_reduce_reference", plane_reduce)
    z = torch.zeros
    gt = z((d_local * 8, w), dtype=torch.int32)
    scal, *_rest, agg = tm.local_selected_reference(
        z((d_local, 11, 8), dtype=torch.int32),
        z((d_local, 8, 4), dtype=torch.int32),
        z((d_local, N_SEGS), dtype=torch.int32), gt, gt, gt, gt,
        z((d_local, w), dtype=torch.int32),
        z((b, tk.N_QFIELDS), dtype=torch.int32),
        window_cap=R, record_cap=record_cap, n_iters=4, has_counts=False)
    overflow = ((per[:, :, 5] != 0)
                | (per[:, :, 4] > record_cap)).astype(np.int32)
    parts = np.concatenate([sums, overflow[:, :, None]], axis=2)
    assert np.array_equal(scal.numpy()[:, :, :3], parts)
    got, owner = _cluster_sum(parts)
    assert sorted(owner) == list(range(d_local))
    assert np.array_equal(got, agg.numpy())
    want = np.stack([np.asarray(jnp.sum(jnp.asarray(parts[:, :, k]), axis=0))
                     for k in range(3)], axis=1)
    assert np.array_equal(got, want)
    if d_local > 1:  # sums past the int32 range wrapped
        assert (got[:, :2] != parts[:, :, :2].astype(np.int64).sum(0)).any()
