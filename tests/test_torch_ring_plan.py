"""The ring gather's step plan (``ops.gather_kernel.ring_plan``), which
``ring_gather`` launches on the card, held against the twin and the
JAX package's gather.

The plan names, for every step and entry, the blocks a launch reads
(``src``, ``own``) and writes (``nxt``, ``acc``). The tests run it with
numpy and through ``ring_gather`` itself, whose CUDA branch runs here
with each launch done on the CPU by the kernel's arithmetic (int32 add
with wraparound, and the copy to ``nxt``). The CUDA kernel is held
against the twin on the card (tests/test_torch_cuda.py, chip_smoke.py).
Every value is an int32: the tolerance is 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbeacon_tpu.ops import gather_kernel as jg
from sbeacon_tpu.parallel import mesh as jm
from sbeacon_tpu_torch.ops import gather_kernel as tg

NS = range(2, 9)
P = jax.sharding.PartitionSpec


def _parts(n, shape=(3, 5), seed=0):
    """n int32 blocks near both ends of the int32 range, so the sums
    wrap."""
    rng = np.random.default_rng(seed + n)
    hi = rng.integers(2**31 - 64, 2**31, size=(n,) + shape, dtype=np.int64)
    sign = rng.choice([-1, 1], size=(n,) + shape)
    return (hi * sign).astype(np.int32)


def _run_plan(plan, parts, order):
    """Executes the plan with numpy, the entries of each step in
    ``order``; returns every buffer."""
    bufs = {("part", i): p.copy() for i, p in enumerate(parts)}
    for row in plan:
        for i in order:
            src, own, nxt, acc = row[i]
            s = bufs[src].copy()
            bufs[acc] = (bufs[own].astype(np.int64) + s).astype(np.int32)
            if nxt is not None:
                bufs[nxt] = s
    return bufs


def _jax_gather(parts):
    """JAX's portable gather under ``shard_map`` over the first n of the
    suite's eight forced CPU devices."""
    n = len(parts)
    mesh = jm.make_mesh(n)
    fn = jm.shard_map_compat(
        lambda x: jg.gather_partials_portable(x[0], jm.AXIS),
        mesh=mesh, in_specs=(P(jm.AXIS),), out_specs=P(), check_rep=False,
    )
    return np.asarray(jax.jit(fn)(jnp.asarray(parts)))


@pytest.mark.parametrize("n", NS)
def test_plan_writes_no_input(n):
    plan = tg.ring_plan(n)
    assert len(plan) == n - 1 and all(len(row) == n for row in plan)
    for row in plan:
        for _src, _own, nxt, acc in row:
            assert acc[0] == "acc" and (nxt is None or nxt[0] == "buf")
    assert all(nxt is None for *_x, nxt, _a in plan[-1])


@pytest.mark.parametrize("n", NS)
def test_plan_reads_nothing_written_in_the_same_step(n):
    """No launch reads a block that another entry's launch of the same
    step writes, and no two launches of a step write one block: the
    entries of a step may run in any order."""
    for row in tg.ring_plan(n):
        writes = [{acc} | ({nxt} if nxt else set())
                  for _s, _o, nxt, acc in row]
        for i, (src, own, _nxt, _acc) in enumerate(row):
            for j, w in enumerate(writes):
                if j != i:
                    assert not {src, own} & w, (i, j)
        assert len(set().union(*writes)) == sum(map(len, writes))


@pytest.mark.parametrize("n", NS)
def test_plan_sums_like_the_twin_and_jax(n):
    parts = _parts(n)
    want = tg.gather_partials_portable([torch.from_numpy(p) for p in parts])
    assert np.array_equal(want.numpy(), _jax_gather(parts))
    plan = tg.ring_plan(n)
    for order in (range(n), range(n - 1, -1, -1)):
        bufs = _run_plan(plan, parts, order)
        for i in range(n):
            assert np.array_equal(bufs[("acc", i)], want.numpy())
            assert np.array_equal(bufs[("part", i)], parts[i])


class _Event:
    def record(self, stream=None):
        pass


class _Stream:
    def wait_event(self, ev):
        pass


@pytest.mark.parametrize("n", NS)
def test_ring_gather_launches_the_plan(n, monkeypatch):
    """ring_gather's CUDA branch, each launch done on the CPU: n(n-1)
    launches, each as the plan lays it out, no copy of an input, the
    inputs unchanged, and the twin's sum on every entry. A ring of two
    is two launches and allocates no spare buffer; a ring of three, one
    spare an entry (its last step writes none); longer rings, two."""
    launches = []

    def step(src, nxt, acc, own=None):
        launches.append((src, own, nxt, acc))
        s = src.clone()
        acc.copy_(tg._wrap32(own.long() + s.long()))
        if nxt is not None:
            nxt.copy_(s)

    monkeypatch.setattr(tg, "_impl_for", lambda parts: "ring")
    monkeypatch.setattr(tg, "ring_step", step)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    parts = [torch.from_numpy(p) for p in _parts(n, seed=7)]
    keep = [p.clone() for p in parts]
    got = tg.ring_gather(parts)
    want = tg.gather_partials_portable(keep)
    assert len(launches) == n * (n - 1)
    for x, p in zip(got, parts):
        assert torch.equal(x, want) and x.data_ptr() != p.data_ptr()
    assert all(torch.equal(a, b) for a, b in zip(parts, keep))
    # step 0 reads the inputs themselves as src and own
    ptrs = {p.data_ptr(): i for i, p in enumerate(parts)}
    for i, (src, own, _nxt, _acc) in enumerate(launches[:n]):
        assert ptrs[own.data_ptr()] == i
        assert ptrs[src.data_ptr()] == (i - 1) % n
    spares = {nxt.data_ptr() for _s, _o, nxt, _a in launches
              if nxt is not None}
    assert len(spares) == n * min(2, n - 2)
