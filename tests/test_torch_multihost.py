"""The port's multi-process compute held against the JAX package.

Twin of tests/test_multihost.py: the mesh query, selected and
distinct-count paths run across TWO OS processes, each running this file
as a script (the worker body under ``__main__``) with four CPU mesh
entries, joined by ``parallel.dispatch.init_multihost(...,
backend="gloo", devices=[cpu] * 4)`` into one 8-entry mesh whose fan-in
is a ``torch.distributed.all_reduce``. The children import neither
``jax`` nor ``sbeacon_tpu``; they load the shards the parent wrote with
the port's ``save_index``. The parent holds both ranks' answers against
each other and against the JAX package's single-process
``sharded_query`` / ``sharded_selected_query`` / ``distinct_count_device``
on the suite's eight forced CPU devices (tests/conftest.py), and the
int32 fold of the cross-process sum against ``lax.psum``. Every output
is an integer: the tolerance is 0.

The JAX package is imported inside the tests, never at the top: the
children run this module.
"""

import json
import os
import random
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

#: each test's bound where pytest-timeout is installed; the children's
#: own bound is CHILD_TIMEOUT_S
pytestmark = pytest.mark.timeout(180)

HERE = Path(__file__).resolve()
REPO = HERE.parent.parent
N_DS = 8
SAMPLES = ["S0", "S1"]
#: mesh entries per child process: 2 x 4 = JAX's 8 forced devices
ENTRIES = 4
CHILD_TIMEOUT_S = 90
#: the JAX test's three queries (chrom, start_min, start_max, end_min,
#: end_max, keywords)
QUERIES = [
    ("7", 1, 1 << 30, 1, 1 << 30, {"alternate_bases": "N"}),
    ("7", 1500, 2500, 1, 1 << 30, {"alternate_bases": "N"}),
    ("7", 1, 10, 1, 1 << 30, {}),  # empty window
]
#: the selected batch: points, a bracket, a typed query, and a
#: whole-chromosome wildcard past record_cap
SELECTED = [
    ("7", 1000, 1000, 1, 1 << 30, {"alternate_bases": "N"}),
    ("7", 2000, 3000, 1, 1 << 30, {"alternate_bases": "N"}),
    ("7", 1, 1 << 30, 1, 1 << 30, {"variant_type": "DEL"}),
    ("7", 1, 1 << 30, 1, 1 << 30, {"alternate_bases": "N"}),
]
#: [mesh entry, 3] int32 partials whose sums pass 2^31 (and -2^31)
FOLD_PARTIALS = np.array(
    [[2**31 - 1, -(2**31), 7]] * 4 + [[1, -1, 2**30]] * 4, np.int32)


def _specs(cls, rows):
    return [cls(c, s0, s1, e0, e1, **kw) for c, s0, s1, e0, e1, kw in rows]


def _masks(n_words):
    """Dataset d's selected samples: none, S0, S1 or both, in turn."""
    from sbeacon_tpu_torch.ops.plane_kernel import sample_mask_words

    picks = [[], [0], [1], [0, 1]]
    return np.stack([sample_mask_words(picks[d % 4], n_words)
                     for d in range(N_DS)])


# -- the child: one process of the two ---------------------------------------


def _child(rank: int, port: int, shard_dir: Path, out_path: Path) -> None:
    import torch

    from sbeacon_tpu_torch.index.columnar import load_index
    from sbeacon_tpu_torch.ops.kernel import QuerySpec
    from sbeacon_tpu_torch.parallel import mesh as tm
    from sbeacon_tpu_torch.parallel.dispatch import (
        init_multihost,
        shutdown_multihost,
    )
    from sbeacon_tpu_torch.parallel.distinct import distinct_count_device

    cpu = torch.device("cpu")
    before = tm.make_mesh(devices=[cpu] * ENTRIES)
    init_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                   devices=[cpu] * ENTRIES)
    try:
        mesh = tm.make_mesh()
        local = tm.make_mesh(devices=[cpu] * 2)
        shards = [load_index(shard_dir / f"d{d}.npz") for d in range(N_DS)]
        qstack = tm.StackedIndex(shards, n_datasets_padded=N_DS)
        qblocks = qstack.shard_to_mesh(mesh)
        _, agg = tm.sharded_query(
            qblocks, _specs(QuerySpec, QUERIES), mesh=mesh,
            n_iters=qstack.n_iters, window_cap=2048, record_cap=64,
            aggregates_only=True)
        try:
            tm.sharded_query(qblocks, _specs(QuerySpec, QUERIES), mesh=mesh,
                             n_iters=qstack.n_iters)
            leaves_refused = False
        except ValueError:
            leaves_refused = True
        pstack = tm.StackedIndex(shards, n_datasets_padded=N_DS,
                                 with_planes=True)
        _, sagg = tm.sharded_selected_query(
            pstack.shard_to_mesh(mesh), _specs(QuerySpec, SELECTED),
            _masks(pstack.plane_words), mesh=mesh, n_iters=pstack.n_iters,
            window_cap=2048, record_cap=32,
            has_counts=pstack.has_count_planes, aggregates_only=True)
        distinct = distinct_count_device(shards, mesh=mesh)
        fold = tm._psum([torch.from_numpy(FOLD_PARTIALS[g])
                         for g in mesh.local_entries()], mesh)
        w = tm.world()
        result = {
            "rank": w.rank, "size": w.size, "backend": w.backend,
            "entries": [[str(d) for d in e] for e in w.entries],
            "mesh_size": mesh.size, "mesh_ranks": list(mesh.ranks),
            "local_entries": mesh.local_entries(),
            "blocks": len(qblocks),
            "before_spans": before.spans_processes,
            "local_spans": local.spans_processes,
            "leaves_refused": leaves_refused,
            "agg": {k: v.tolist() for k, v in agg.items()},
            "selected": {k: v.tolist() for k, v in sagg.items()},
            "has_count_planes": pstack.has_count_planes,
            "distinct": distinct,
            "fold": fold.tolist(),
            "all_reduces": tm.total("mesh_all_reduces"),
            "imported": sorted({m.split(".")[0] for m in sys.modules}
                               & {"jax", "sbeacon_tpu"}),
        }
    finally:
        shutdown_multihost()
    result["world_after"] = tm.world() is not None
    out_path.write_text(json.dumps(result))


# -- the parent ----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The JAX test's corpus (``random.Random(1234)``, 8 datasets x 300
    records on chromosome 7), built by the JAX package with genotype
    planes and saved with the port's ``save_index``."""
    from sbeacon_tpu.index import build_index
    from sbeacon_tpu.testing import random_records
    from sbeacon_tpu_torch.index import shard_from_reference
    from sbeacon_tpu_torch.index.columnar import save_index

    rng = random.Random(1234)
    shards = [
        build_index(random_records(rng, chrom="7", n=300, n_samples=2),
                    dataset_id=f"d{d}", sample_names=SAMPLES)
        for d in range(N_DS)
    ]
    root = tmp_path_factory.mktemp("multihost")
    for d, s in enumerate(shards):
        save_index(shard_from_reference(s), root / f"d{d}.npz",
                   compress=False)
    return shards, root


@pytest.fixture(scope="module")
def results(corpus, tmp_path_factory):
    _shards, root = corpus
    out = tmp_path_factory.mktemp("multihost-out")
    outs = [out / f"rank{r}.json" for r in range(2)]
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = [
        subprocess.Popen(
            [sys.executable, str(HERE), str(r), str(port), str(root),
             str(outs[r])],
            env=env, cwd=str(REPO), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for r in range(2)
    ]
    try:
        logs = [p.communicate(timeout=CHILD_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"child failed:\n{log[-3000:]}"
    return [json.loads(o.read_text()) for o in outs]


@pytest.fixture(scope="module")
def jax_truth(corpus):
    """The JAX package's single-process answers on its 8 CPU devices."""
    import jax
    from jax.sharding import PartitionSpec as P

    from sbeacon_tpu.ingest.pipeline import distinct_variant_count
    from sbeacon_tpu.ops.kernel import QuerySpec as JQuerySpec
    from sbeacon_tpu.parallel import mesh as jm
    from sbeacon_tpu.parallel.distinct import (
        distinct_count_device as j_distinct,
    )

    shards, _root = corpus
    jmesh = jm.make_mesh(8)
    qstack = jm.StackedIndex(shards, n_datasets_padded=N_DS)
    _, agg = jm.sharded_query(
        qstack.shard_to_mesh(jmesh), _specs(JQuerySpec, QUERIES), mesh=jmesh,
        n_iters=qstack.n_iters, window_cap=2048, record_cap=64,
        aggregates_only=True)
    pstack = jm.StackedIndex(shards, n_datasets_padded=N_DS,
                             with_planes=True)
    _, sagg = jm.sharded_selected_query(
        pstack.shard_to_mesh(jmesh), _specs(JQuerySpec, SELECTED),
        _masks(pstack.plane_words), mesh=jmesh, n_iters=pstack.n_iters,
        window_cap=2048, record_cap=32, has_counts=pstack.has_count_planes,
        aggregates_only=True)
    psum = jax.jit(jm.shard_map_compat(
        lambda x: jax.lax.psum(x, jm.AXIS), mesh=jmesh,
        in_specs=P(jm.AXIS), out_specs=P()))
    return {
        "agg": {k: np.asarray(v).tolist() for k, v in agg.items()},
        "selected": {k: np.asarray(v).tolist() for k, v in sagg.items()},
        "has_count_planes": pstack.has_count_planes,
        "distinct": j_distinct(shards, mesh=jmesh),
        "distinct_host": distinct_variant_count(shards),
        "fold": np.asarray(psum(FOLD_PARTIALS))[0].tolist(),
    }


def test_two_processes_form_one_eight_entry_mesh(results):
    for r, res in enumerate(results):
        assert (res["rank"], res["size"], res["backend"]) == (r, 2, "gloo")
        assert res["entries"] == [["cpu"] * ENTRIES] * 2
        assert res["mesh_size"] == 8
        assert res["mesh_ranks"] == [0] * ENTRIES + [1] * ENTRIES
        assert res["local_entries"] == list(range(r * ENTRIES,
                                                  (r + 1) * ENTRIES))
        # each process uploads only its own half of the stack
        assert res["blocks"] == ENTRIES
        # devices= and the mesh before init_multihost stay process-local
        assert not res["before_spans"] and not res["local_spans"]
        assert res["leaves_refused"]
        assert not res["world_after"]
        # 2 sharded calls and the distinct count and the fold: 4 collectives
        assert res["all_reduces"] == 4
        assert res["imported"] == []


@pytest.mark.parametrize("key", ["agg", "selected", "distinct", "fold"])
def test_both_ranks_agree(results, key):
    assert results[0][key] == results[1][key]


def test_query_aggregates_equal_jax(results, jax_truth):
    got = results[0]["agg"]
    assert got == jax_truth["agg"]
    assert got["exists"][0] and not got["exists"][2]
    assert got["n_datasets_hit"][0] == N_DS


def test_selected_aggregates_equal_jax(results, jax_truth):
    assert results[0]["has_count_planes"] is jax_truth["has_count_planes"]
    got = results[0]["selected"]
    assert got == jax_truth["selected"]
    assert got["n_overflow"][-1] > 0 and any(got["exists"])


def test_distinct_count_equals_jax(results, jax_truth):
    assert results[0]["distinct"] == jax_truth["distinct"]
    assert results[0]["distinct"] == jax_truth["distinct_host"]


def test_cross_process_fold_wraps_as_lax_psum(results, jax_truth):
    assert results[0]["fold"] == jax_truth["fold"]


# -- single-process cases ------------------------------------------------------


def test_fold_wraps_as_lax_psum(jax_truth):
    import torch

    from sbeacon_tpu_torch.parallel import mesh as tm

    got = tm._psum([torch.from_numpy(p) for p in FOLD_PARTIALS])
    assert got.dtype == np.int32 and got.tolist() == jax_truth["fold"]
    # an int64 count (the distinct count's) is summed without a fold
    big = tm._psum([torch.tensor(2**31, dtype=torch.int64)] * 3)
    assert int(big) == 3 * 2**31


def _port_shards(corpus, n):
    from sbeacon_tpu_torch.index.columnar import load_index

    _shards, root = corpus
    return [load_index(root / f"d{d}.npz") for d in range(n)]


def test_shard_to_mesh_uploads_only_local_entries(corpus):
    import torch

    from sbeacon_tpu_torch.parallel import mesh as tm

    stack = tm.StackedIndex(_port_shards(corpus, 4), n_datasets_padded=8)
    cpu = torch.device("cpu")
    # this process is rank 0 (no world): it owns entries 2 and 3
    mesh = tm.Mesh([cpu] * 4, ranks=(1, 1, 0, 0))
    assert mesh.spans_processes and mesh.local_entries() == [2, 3]
    blocks = stack.shard_to_mesh(mesh)
    assert len(blocks) == 2
    for blk, g in zip(blocks, (2, 3)):
        for i, name in enumerate(tm.COLUMNS):
            np.testing.assert_array_equal(
                blk.columns[:, i].numpy(), stack.arrays[name][2 * g:2 * g + 2])


def test_spanning_mesh_refuses_per_dataset_leaves(corpus):
    import torch

    from sbeacon_tpu_torch.ops.kernel import QuerySpec
    from sbeacon_tpu_torch.parallel import mesh as tm

    stack = tm.StackedIndex(_port_shards(corpus, 2), with_planes=True)
    mesh = tm.Mesh([torch.device("cpu")] * 2, ranks=(0, 1))
    blocks = stack.shard_to_mesh(mesh)
    specs = _specs(QuerySpec, QUERIES)
    with pytest.raises(ValueError, match="spans processes"):
        tm.sharded_query(blocks, specs, mesh=mesh, n_iters=stack.n_iters)
    with pytest.raises(ValueError, match="spans processes"):
        tm.sharded_selected_query(
            blocks, specs, _masks(stack.plane_words)[:2], mesh=mesh,
            n_iters=stack.n_iters)


def test_mesh_fused_index_refuses_a_spanning_mesh(corpus):
    import torch

    from sbeacon_tpu_torch.parallel import mesh as tm

    mesh = tm.Mesh([torch.device("cpu")] * 2, ranks=(0, 1))
    with pytest.raises(ValueError, match="spans processes"):
        tm.MeshFusedIndex(_port_shards(corpus, 2), mesh)


def test_make_mesh_stays_local_before_init_multihost(monkeypatch):
    import torch

    from sbeacon_tpu_torch.parallel import dispatch
    from sbeacon_tpu_torch.parallel import mesh as tm

    assert tm.world() is None
    mesh = tm.make_mesh(devices=[torch.device("cpu")] * 3)
    assert mesh.ranks == (0, 0, 0) and not mesh.spans_processes
    assert mesh.local_entries() == [0, 1, 2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.make_mesh()
    # the default entries are the card's: without one, init_multihost
    # raises before it contacts anyone, and no world is recorded
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dispatch.init_multihost("127.0.0.1:1", 2, 0)
    assert tm.world() is None
    dispatch.shutdown_multihost()  # no world: nothing to leave


def test_aggregate_struct_is_exported():
    from sbeacon_tpu_torch.parallel import aggregate_struct, mesh as tm

    assert aggregate_struct is tm.aggregate_struct


if __name__ == "__main__":
    _child(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]),
           Path(sys.argv[4]))
