"""The port's ring gather (P1) held against the JAX package's.

JAX's ``gather_partials_portable`` / ``gather_partials_many`` run under
``shard_map`` on the first n of the suite's eight forced CPU devices,
one partial block per device; the port's ``gather_partials`` /
``gather_partials_many`` take one CPU tensor per mesh entry, where the
ring's wrapper runs its twin (the int32 sum). The same seeded int32
blocks (numpy) go into both, wraparound included: tolerance 0. The
CUDA ring itself is held against the twin on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbeacon_tpu.ops import gather_kernel as jg
from sbeacon_tpu.parallel import mesh as jm
from sbeacon_tpu_torch import telemetry
from sbeacon_tpu_torch.ops import gather_kernel as tg

P = jax.sharding.PartitionSpec


def _blocks(n, shape, seed, wrap=False):
    rng = np.random.default_rng(seed)
    if wrap:
        return rng.integers(2**31 - 50, 2**31, size=(n,) + shape,
                            dtype=np.int64).astype(np.int32)
    return rng.integers(-1000, 1000, size=(n,) + shape, dtype=np.int32)


def _jax_many(xs, n):
    """JAX's gather_partials_many over per-device blocks xs[i] [n, ...]."""
    mesh = jm.make_mesh(n)

    def body(*parts):
        return jg.gather_partials_many(
            tuple(p[0] for p in parts), jm.AXIS, n, impl="portable")

    fn = jm.shard_map_compat(
        body, mesh=mesh, in_specs=tuple(P(jm.AXIS) for _ in xs),
        out_specs=tuple(P() for _ in xs), check_rep=False,
    )
    return [np.asarray(o) for o in jax.jit(fn)(*[jnp.asarray(x) for x in xs])]


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("wrap", [False, True])
def test_gather_partials_matches_jax(n, wrap):
    x = _blocks(n, (5, 7), seed=n, wrap=wrap)
    (want,) = _jax_many([x], n)
    got = tg.gather_partials([torch.from_numpy(b) for b in x])
    assert len(got) == n
    for g in got:
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), want)
    portable = tg.gather_partials_portable([torch.from_numpy(b) for b in x])
    assert np.array_equal(portable.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_gather_partials_many_matches_jax(n):
    """Rows, pc_call, pc_tok [B, R] and or_words [B, W] concatenated, one
    pass, split back: each block equals JAX's."""
    b, r, w = 6, 9, 3
    xs = [_blocks(n, (b, r), 1), _blocks(n, (b, r), 2), _blocks(n, (b, r), 3),
          _blocks(n, (b, w), 4, wrap=True)]
    want = _jax_many(xs, n)
    got = tg.gather_partials_many(
        [tuple(torch.from_numpy(x[i]) for x in xs) for i in range(n)])
    assert len(got) == n
    for entry in got:
        assert [tuple(t.shape) for t in entry] == [(b, r)] * 3 + [(b, w)]
        for g, wnt in zip(entry, want):
            assert np.array_equal(g.numpy(), wnt)


def test_split_after_the_concatenation():
    """The split points are the cumulative widths: each output block is
    the sum of its own input blocks only."""
    parts = [(torch.full((2, 3), 1, dtype=torch.int32),
              torch.full((2, 1), 10, dtype=torch.int32),
              torch.full((2, 4), 100, dtype=torch.int32))] * 3
    (a, b, c), *_rest = tg.gather_partials_many(parts)
    assert (a == 3).all() and (b == 30).all() and (c == 300).all()
    ((only,),) = tg.gather_partials_many([(parts[0][0],)])
    assert torch.equal(only, parts[0][0])


def test_impl_follows_the_device():
    """The tensors' device picks the implementation: CPU blocks take the
    twin (no ring launch), blocks on mixed devices raise."""
    cpu = [torch.full((2, 2), i, dtype=torch.int32) for i in (1, 2)]
    assert tg._impl_for(cpu) == "portable"
    telemetry.reset_launch_counts()
    got = tg.gather_partials(cpu)
    assert all(torch.equal(g, torch.full((2, 2), 3, dtype=torch.int32))
               for g in got)
    assert tg.ring_gather_launches == 0
    with pytest.raises(ValueError, match="all cpu or all cuda"):
        tg.gather_partials([cpu[0], torch.zeros((2, 2), device="meta")])
