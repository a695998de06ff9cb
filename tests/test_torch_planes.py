"""The port's genotype planes and plane-stats kernel held against the JAX
package.

Seeded corpora (genotype-derived and INFO-sourced, ploidy > 2 overflow,
9 samples for one plane word and 70 for three with a tail word) go
through the JAX package (``PlaneDeviceIndex``, ``_plane_stats``,
``plane_row_stats``, ``materialize_response_loop``, XLA on the CPU) and
the port on ``device="cpu"``, where the kernel wrapper runs its
plain-PyTorch twin. Every output is an integer: the tolerance is 0. The
CUDA kernel itself is held against the twin on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import random
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbeacon_tpu.engine import (
    host_match_rows as j_host_match_rows,
    materialize_response_loop,
)
from sbeacon_tpu.index import build_index as j_build_index
from sbeacon_tpu.ops import plane_kernel as jpk
from sbeacon_tpu.ops.kernel import QuerySpec as JQuerySpec
from sbeacon_tpu.payloads import VariantQueryPayload as JPayload
from sbeacon_tpu.testing import random_records as j_random_records
from sbeacon_tpu.testing import synthetic_shard as j_synthetic_shard
from sbeacon_tpu_torch import testing as t_testing
from sbeacon_tpu_torch.config import BeaconConfig, EngineConfig
from sbeacon_tpu_torch.engine import VariantEngine, materialize_response
from sbeacon_tpu_torch.index import shard_from_reference
from sbeacon_tpu_torch.ops import plane_kernel as tpk
from sbeacon_tpu_torch.payloads import VariantQueryPayload


def _shard(seed, n_samples, *, p_no_acan, overflow=True, n=300):
    rng = random.Random(seed)
    recs = j_random_records(
        rng, chrom="7", n=n, n_samples=n_samples, p_multiallelic=0.35,
        p_symbolic=0.1, p_no_acan=p_no_acan,
    )
    if overflow:
        # ploidy > 2: the 2-bit planes saturate, the side tables carry
        # the exact copies
        for rec in recs[::6]:
            rec.genotypes[rng.randrange(n_samples)] = "1|1|1"
            rec.ac = None
            rec.an = None
    names = [f"S{i}" for i in range(n_samples)]
    shard = j_build_index(recs, dataset_id="pk", vcf_location="v",
                          sample_names=names)
    return recs, names, shard


@pytest.fixture(scope="module")
def derived():
    return _shard(41, 9, p_no_acan=0.6)


@pytest.fixture(scope="module")
def wide():
    return _shard(42, 70, p_no_acan=0.5)


@pytest.fixture(scope="module")
def info():
    return _shard(43, 9, p_no_acan=0.0, overflow=False)


def _planes(shard):
    return (
        jpk.PlaneDeviceIndex(shard),
        tpk.PlaneDeviceIndex(shard_from_reference(shard), "cpu"),
    )


@pytest.mark.parametrize("which", ["derived", "wide", "info"])
def test_plane_index_matches_jax(which, request):
    _recs, _names, shard = request.getfixturevalue(which)
    jp, tp = _planes(shard)
    assert tp.has_counts == jp.has_counts == (which != "info")
    assert (tp.n_rows, tp.n_words) == (jp.n_rows, jp.n_words)
    for name in ("gt", "gt2", "tok1", "tok2"):
        want, got = getattr(jp, name), getattr(tp, name)
        assert (got is None) == (want is None), name
        if want is not None:
            assert got.dtype == torch.int32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the card's bytes: no 128-lane padding of the minor dimension
    k = 4 if tp.has_counts else 1
    assert tp.nbytes_hbm() == shard.gt_bits.size * 4 * k
    assert tpk.PlaneDeviceIndex.estimate_hbm(shard) == tp.nbytes_hbm()
    assert jp.nbytes_hbm() == shard.gt_bits.shape[0] * 128 * 4 * k


def test_staged_upload_on_cpu_is_the_array():
    a = np.random.default_rng(3).integers(0, 2**32, (1000, 3),
                                          dtype=np.uint32)
    got = tpk.staged_upload(a, "cpu", chunk_bytes=1024)
    assert got.dtype == torch.int32 and got.shape == (1000, 3)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), a)


def test_popcount_and_or_reduce_pin_bit_patterns():
    words = np.array(
        [0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0, 1, 0x000000FF, 0xDEADBEEF],
        np.uint32,
    )
    got = tpk.popcount32(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.bitwise_count(words))
    x = np.random.default_rng(5).integers(0, 2**32, (37, 4), dtype=np.uint32)
    for n in (0, 1, 2, 7, 37):
        got = tpk.or_reduce(torch.from_numpy(x[:n].view(np.int32)), 0)
        want = np.bitwise_or.reduce(x[:n], axis=0) if n else np.zeros(4)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("with_or", [True, False])
@pytest.mark.parametrize("with_counts", [True, False])
@pytest.mark.parametrize("which", ["derived", "wide"])
def test_plane_stats_twin_matches_jax(which, with_counts, with_or, request):
    """Raw (planes, rows, or_sel, mask) through JAX ``_plane_stats`` and
    the twin, with masks of all ones, a sparse subset, none, and the
    70-sample tail word's high bits set."""
    _recs, _names, shard = request.getfixturevalue(which)
    jp, tp = _planes(shard)
    rng = np.random.default_rng(7)
    R = 300
    rows = rng.integers(0, shard.n_rows, R).astype(np.int32)
    or_sel = (rng.random(R) < 0.4).astype(np.int32)
    for mask in (
        np.full(jp.n_words, 0xFFFFFFFF, np.uint32),
        rng.integers(0, 2**32, jp.n_words, dtype=np.uint32),
        np.zeros(jp.n_words, np.uint32),
    ):
        want = jpk._plane_stats(
            jp.gt, jp.gt2, jp.tok1, jp.tok2, jnp.asarray(rows),
            jnp.asarray(or_sel), jnp.asarray(mask.view(np.int32)), R=R,
            with_counts=with_counts, with_or=with_or,
        )
        got = tpk.plane_stats_reference(
            tp.gt, tp.gt2, tp.tok1, tp.tok2, torch.from_numpy(rows),
            torch.from_numpy(or_sel), torch.from_numpy(mask.view(np.int32)),
            with_counts=with_counts, with_or=with_or,
        )
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("with_counts", [True, False])
@pytest.mark.parametrize("R", [1, 127, 128, 1000, 9000])
@pytest.mark.parametrize("which", ["derived", "wide"])
def test_plane_row_stats_matches_jax(which, R, with_counts, subset, request):
    """Every JAX row tier and its host chunking past 8192 rows, against
    the port's one launch at the row set's own size."""
    _recs, _names, shard = request.getfixturevalue(which)
    jp, tp = _planes(shard)
    rng = np.random.default_rng(R)
    rows = rng.integers(0, shard.n_rows, R)
    mask = rng.integers(0, 2**32, jp.n_words, dtype=np.uint32)
    or_sel = (rng.random(R) < 0.5).astype(np.int32) if subset else None
    want = jpk.plane_row_stats(jp, rows, mask, or_sel=or_sel,
                               with_counts=with_counts)
    got = tpk.plane_row_stats(tp, rows, mask, or_sel=or_sel,
                              with_counts=with_counts)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _payload(spec, gran, details, sel):
    return dict(
        dataset_ids=["pk"], reference_name="7", start_min=spec.start_min,
        start_max=spec.start_max, end_min=1, end_max=1 << 30,
        requested_granularity=gran,
        include_datasets="HIT" if details else "NONE",
        include_samples=True, selected_samples_only=sel is not None,
    )


@pytest.mark.parametrize("which", ["derived", "info", "wide"])
def test_materialize_plane_index_matches_loop_spec(which, request):
    """``materialize_response(plane_index=)`` (popcounts and the
    sample-hit OR by the plane-stats twin) equals the JAX package's loop
    spec over granularities, details and selections (the sweep of
    tests/test_plane_kernel.py)."""
    _recs, _names, shard = request.getfixturevalue(which)
    _jp, tp = _planes(shard)
    tshard = shard_from_reference(shard)
    rng = random.Random(5)
    pos = shard.cols["pos"]
    cases = 0
    for trial in range(25):
        p = int(pos[rng.randrange(len(pos))])
        spec = JQuerySpec(
            "7", max(1, p - rng.randint(0, 300)), p + rng.randint(0, 300),
            1, 1 << 30, alternate_bases=rng.choice(["N", None, "T"]),
            variant_type=rng.choice([None, "DEL", "CNV"]),
        )
        rows = j_host_match_rows(shard, spec)
        for gran in ("boolean", "count", "record"):
            for details in (True, False):
                for sel in (None, [0, 3, 8], []):
                    doc = _payload(spec, gran, details, sel)
                    kw = dict(chrom_label="7", dataset_id="pk",
                              selected_idx=sel)
                    want = materialize_response_loop(
                        shard, rows, JPayload(**doc), **kw
                    )
                    got = materialize_response(
                        tshard, rows, VariantQueryPayload(**doc),
                        plane_index=tp, **kw
                    )
                    assert asdict(got) == asdict(want), (trial, doc, sel)
                    cases += 1
    assert cases == 25 * 18


def test_plane_budget_gate(derived, info):
    """A plane set over the budget stays host-resident; the gate is
    cumulative over resident planes and counts the card's real bytes."""
    tder = shard_from_reference(derived[2])
    tinfo = shard_from_reference(info[2])
    tinfo.meta["dataset_id"] = "pk_info"
    need_der = tpk.PlaneDeviceIndex.estimate_hbm(tder)
    need_info = tpk.PlaneDeviceIndex.estimate_hbm(tinfo)

    def engine(budget_bytes):
        return VariantEngine(
            BeaconConfig(engine=EngineConfig(
                microbatch=False, plane_hbm_budget_gb=budget_bytes / 1e9)),
            device="cpu",
        )

    eng = engine(1)
    try:
        eng.add_index(tder)
        assert eng._indexes[("pk", "v")][2] is None
        assert eng.plane_hbm_resident() == 0
    finally:
        eng.close()
    # room for the first plane set exactly, not for the second as well
    eng = engine(need_der + need_info - 1)
    try:
        eng.add_index(tder)
        eng.add_index(tinfo)
        assert eng._indexes[("pk", "v")][2] is not None
        assert eng._indexes[("pk_info", "v")][2] is None
        assert eng.plane_hbm_resident() == need_der
        assert eng._plane_reserved == {}
        # re-ingesting the key releases its own planes before the gate
        eng.add_index(tder)
        assert eng.plane_hbm_resident() == need_der
    finally:
        eng.close()


@pytest.mark.parametrize(
    "n_samples,density", [(70, 0.01), (9, 0.3), (32, 0.5)]
)
def test_synthetic_shard_planes_match_jax(n_samples, density):
    kw = dict(seed=n_samples, chroms=["1", "22"], n_samples=n_samples,
              with_gt_planes=True, plane_density=density)
    want = j_synthetic_shard(3000, **kw)
    got = t_testing.synthetic_shard(3000, **kw)
    assert got.meta == want.meta
    for k in want.cols:
        np.testing.assert_array_equal(got.cols[k], want.cols[k], err_msg=k)
    for k in ("gt_bits", "gt_bits2", "tok_bits1", "tok_bits2",
              "gt_overflow", "tok_overflow", "chrom_offsets"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    if n_samples % 32:
        assert not (got.gt_bits[:, -1] >> np.uint32(n_samples % 32)).any()
