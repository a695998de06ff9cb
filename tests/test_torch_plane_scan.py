"""The or_sel scans and the cluster split of the plane reduction, as
``csrc/plane_reduce.cuh`` and ``csrc/mesh_fused.cu`` compute them, held
against ``plane_reduce_reference`` and JAX's ``_plane_reduce``.

The kernels scan only the valid lanes rounded up to a warp (at most R),
the padding filled with rc 0 and no record edge; each thread scans a
contiguous chunk and warp shuffles combine the chunks' totals. A slot's
rows are split into contiguous shares, one per block of its cluster,
whose ORs are ORed together. The numpy model below does the same, one
step at a time, so tier-1 covers the formulation the card alone runs.
Every output is an integer: the tolerance is 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbeacon_tpu.parallel import mesh as jm
from sbeacon_tpu_torch.index.columnar import FLAG
from sbeacon_tpu_torch.parallel import mesh as tm

I32_MIN = np.iinfo(np.int32).min
CLUSTER = 8  # blocks of one slot's cluster (mesh_fused.cu kCluster)


def _add(x, y):
    return int(np.array(x + y, np.int64).astype(np.int32))


def _max(x, y):
    return max(x, y)


def _block_scan(a, kmax, reverse, threads, warp):
    """plane_reduce::block_scan: thread t scans lanes [t * per, (t + 1) *
    per) of the (reversed) array, an inclusive shuffle scan combines the
    threads' totals within each warp, and one over the warps' totals."""
    comb, ident = (_max, I32_MIN) if kmax else (_add, 0)
    seq = list(a[::-1] if reverse else a)
    n = len(seq)
    per = -(-n // threads) if n else 0
    local, totals = [], []
    for t in range(threads):
        acc, part = ident, []
        for x in seq[t * per : (t + 1) * per]:
            acc = comb(acc, x)
            part.append(acc)
        local.append(part)
        totals.append(acc)
    out = []
    warp_pre = ident
    for w0 in range(0, threads, warp):
        inc = ident
        for t in range(w0, min(w0 + warp, threads)):
            pre = comb(warp_pre, inc)
            out += [comb(pre, x) for x in local[t]]
            inc = comb(inc, totals[t])
        warp_pre = comb(warp_pre, inc)
    return out[::-1] if reverse else out


def _or_sel(rc, rec, n_valid, R, threads, warp):
    """plane_reduce::or_select over the lanes rounded up to a warp."""
    n = min(-(-n_valid // 32) * 32, R)
    rc_v = [int(rc[k]) if k < n_valid else 0 for k in range(n)]
    c = _block_scan(rc_v, False, False, threads, warp)
    first = [k < n_valid and (k == 0 or rec[k] != rec[k - 1])
             for k in range(n)]
    base = _block_scan([_add(c[k], -rc_v[k]) if first[k] else -1
                        for k in range(n)], True, False, threads, warp)
    sel = [base[k] > 0 or _add(c[k], -base[k]) > 0 for k in range(n)]
    r = _block_scan(rc_v, False, True, threads, warp)
    last = [k < n_valid and (k == n_valid - 1 or rec[k] != rec[k + 1])
            for k in range(n)]
    base_b = _block_scan([_add(r[k], -rc_v[k]) if last[k] else -1
                          for k in range(n)], True, True, threads, warp)
    return [k < n_valid and (sel[k] or _add(r[k], -base_b[k]) > 0)
            for k in range(n_valid)]


def _popc(x):
    return np.array([bin(int(v) & 0xFFFFFFFF).count("1") for v in
                     np.ravel(x)]).reshape(np.shape(x)).sum(axis=-1)


def _kernel_model(flags, ac, rec, gt, gt2, tok1, tok2, n_valid, *,
                  has_counts, use_counts, threads, warp):
    """One slot as the cluster computes it: per-share popcounts, rc on
    the leader, or_sel by the kernel's scans, per-share ORs ORed."""
    R = len(ac)
    pc_call = np.zeros(R, np.int64)
    pc_tok = np.zeros(R, np.int64)
    share = -(-n_valid // CLUSTER)
    spans = [(min(b * share, n_valid), min((b + 1) * share, n_valid))
             for b in range(CLUSTER)]
    if has_counts:
        for lo, hi in spans:
            pc_call[lo:hi] = _popc(gt[lo:hi]) + _popc(gt2[lo:hi])
            pc_tok[lo:hi] = _popc(tok1[lo:hi]) + _popc(tok2[lo:hi])
    rc = [int(pc_call[k]) if has_counts and use_counts
          and not flags[k] & FLAG.AC_INFO else int(ac[k])
          for k in range(n_valid)]
    sel = _or_sel(rc, rec, n_valid, R, threads, warp)
    words = np.zeros(gt.shape[1], np.uint32)
    for lo, hi in spans:
        part = np.zeros_like(words)
        for k in range(lo, hi):
            if sel[k]:
                part |= gt[k].view(np.uint32)
        words |= part
    return pc_call.astype(np.int32), pc_tok.astype(np.int32), words


def _inputs(case, seed, B=4, R=40, W=3):
    g = np.random.default_rng(seed)
    n_valid = g.integers(0, R + 1, B)
    n_valid[0] = {"n_valid_0": 0, "n_valid_1": 1}.get(case, R)
    if case in ("n_valid_0", "n_valid_1", "n_valid_R"):
        n_valid[:] = n_valid[0]
    rec = np.sort(g.integers(0, R // 3, (B, R)), axis=1).astype(np.int32)
    if case == "one_record":
        rec[:] = 4
    if case == "one_lane_records":
        rec[:] = np.arange(R, dtype=np.int32)
    info = FLAG.AC_INFO | FLAG.AN_INFO
    flags = np.where(g.random((B, R)) < 0.5, info, 0).astype(np.int32)
    ac = g.integers(0, 4, (B, R)).astype(np.int32)
    an = g.integers(0, 20, (B, R)).astype(np.int32)
    if case == "wraparound":  # the cumulative rc passes 2^31
        flags[:] = info
        ac = g.integers(2**29, 2**31 - 1, (B, R)).astype(np.int32)
    if case == "negative_ac":  # rc from AC, cumsums that dip below zero
        flags[:] = info
        ac = g.integers(-6, 4, (B, R)).astype(np.int32)
    planes = [g.integers(-(2**31), 2**31, (B, R, W)).astype(np.int32)
              for _ in range(4)]
    valid = np.arange(R)[None, :] < n_valid[:, None]
    return flags, ac, an, rec, planes, valid, n_valid


CASES = ["seeded", "wraparound", "negative_ac", "one_lane_records",
         "one_record", "n_valid_0", "n_valid_1", "n_valid_R"]


@pytest.mark.parametrize("threads,warp", [(256, 32), (4, 2)])
@pytest.mark.parametrize("has_counts", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_kernel_scans_match_reference(case, has_counts, threads, warp):
    """The model on 4 slots of 40 lanes (a lane count the warp rounding
    passes) with use_counts mixed, against the twin and JAX: the
    popcounts on the valid lanes and the sample-hit words. (4, 2): four
    threads in warps of two, so every chunk holds ten lanes."""
    flags, ac, an, rec, planes, valid, n_valid = _inputs(
        case, CASES.index(case) * 2 + has_counts)
    use = np.array([True, False, True, True])
    gt, gt2, tok1, tok2 = planes
    t = torch.from_numpy
    want = tm.plane_reduce_reference(
        t(flags), t(ac), t(an), t(rec), t(gt),
        *((t(gt2), t(tok1), t(tok2)) if has_counts else (None,) * 3),
        t(valid), has_counts=has_counts, use_counts=t(use))
    jwant = jm._plane_reduce(
        jnp.asarray(flags), jnp.asarray(ac), jnp.asarray(an),
        jnp.asarray(rec), jnp.asarray(gt),
        *((jnp.asarray(gt2), jnp.asarray(tok1), jnp.asarray(tok2))
          if has_counts else (None,) * 3),
        jnp.asarray(valid), has_counts=has_counts,
        use_counts=jnp.asarray(use))
    np.testing.assert_array_equal(want["or_words"].numpy(),
                                  np.asarray(jwant["or_words"]))
    for q in range(len(ac)):
        nv = int(n_valid[q])
        pc_call, pc_tok, words = _kernel_model(
            flags[q], ac[q], rec[q], gt[q], gt2[q], tok1[q], tok2[q], nv,
            has_counts=has_counts, use_counts=bool(use[q]), threads=threads,
            warp=warp)
        np.testing.assert_array_equal(
            words, want["or_words"][q].numpy().view(np.uint32))
        np.testing.assert_array_equal(pc_call[:nv],
                                      want["pc_call"][q, :nv].numpy())
        np.testing.assert_array_equal(pc_tok[:nv],
                                      want["pc_tok"][q, :nv].numpy())
