"""The least time a kernel launch could take on the card: the larger of
the bytes its own inputs need at the HBM rate and its integer
operations at the int32 rate.

Frozen from ``chip_smoke.py``'s ``needed_bytes``, ``bisect_need`` and
``bound_of``, with their constants, and computed here from each launch's
recorded inputs alone: the window lanes, the searches' bounds and the
probes are worked out in this file, and no output of the launch and no
function of the program is used. What the matched lanes read beyond the
predicates (AC, AN) depends on the answer and is left out, so each bound
is a lower one. From the program it reads only the packed layouts: the
column, field and mode numbers of ``ops.kernel``, the query fields of
``ops.query_pack`` and the symbolic-ALT flag bit of ``index.columnar``.
"""

from __future__ import annotations

# H100 SXM peaks at the 700 W limit: HBM3 bytes/s (NVIDIA data sheet),
# and 32-bit integer operations/s outside the tensor cores (132 SMs x 64
# int32 lanes per SM (Hopper whitepaper) x the 1.98 GHz boost clock)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit operations per window lane of the match kernel
MATCH_OPS_PER_LANE = 40
# bytes of one memory sector, the least the device reads
SECTOR_BYTES = 32
# packed rows every window lane's predicates read
ROWS_PER_LANE = 6
# integer operations per valid window lane of the bisection kernel, and
# per probe of its two searches
BISECT_OPS_PER_LANE = 30
BISECT_OPS_PER_PROBE = 4


def bound_of(nbytes, ops):
    """(bound s, bound_by): the larger of the bytes at the HBM rate and
    the operations at the int32 rate."""
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = ops / INT32_OPS_PER_S
    return max(bytes_s, ops_s), "bytes" if bytes_s >= ops_s else "operations"


def needed_bytes(T, ids, q8, C, cap):
    """(bytes, window lanes) one scatter_match launch needs at the least:
    the sectors of the six packed rows the predicates read over the
    distinct window lanes of its slots, the slot inputs read once and
    the outputs (aggregates and match masks) written once."""
    import torch

    from sbeacon_tpu_torch.ops.query_pack import Q_HI, Q_LO

    span = C * T
    b = ids.shape[0]
    gidx = (ids[:, None].long() * T
            + torch.arange(span, device=ids.device)[None, :])
    lo = q8[:, Q_LO:Q_LO + 1].long()
    hi = q8[:, Q_HI:Q_HI + 1].long()
    win = (gidx >= lo) & (gidx < torch.minimum(hi, lo + cap))
    row_groups = torch.unique(gidx[win] // 8).numel()
    io = b * (4 + 32) + b * (32 + span // 16 * 4)
    return row_groups * ROWS_PER_LANE * SECTOR_BYTES + io, int(win.sum())


def scatter_match_need(rec):
    """(bytes, operations) of one recorded scatter_match launch."""
    nbytes, lanes = needed_bytes(rec["T"], rec["ids"], rec["q8"], rec["C"],
                                 rec["cap"])
    return nbytes, lanes * MATCH_OPS_PER_LANE


def _search(pos, key, lo, hi, *, upper: bool):
    """Per query, the first index of the ascending ``pos[lo:hi]`` whose
    value is above ``key`` (``upper``) or not below it, by a bisection run
    to its end."""
    import torch

    lo, hi = lo.clone(), hi.clone()
    n = pos.shape[0]
    longest = int((hi - lo).max()) if lo.numel() else 0
    for _ in range(max(longest, 1).bit_length() + 1):
        active = lo < hi
        mid = (lo + hi) // 2
        v = pos[mid.clamp(0, n - 1)].long()
        right = v <= key if upper else v < key
        lo = torch.where(active & right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    return lo


def bisect_need(rec):
    """(bytes, operations) one bisect_query launch needs at the least.
    Bytes: the distinct 32-B sectors of the columns each query's
    predicates read over its valid lanes (the rows whose position lies
    in its start bracket, up to the window cap); one probe sector for
    each step of the two searches a query's chromosome segment needs
    (its length's bits); the packed queries read once and the outputs
    written once."""
    import torch

    from sbeacon_tpu_torch.index.columnar import FLAG
    from sbeacon_tpu_torch.ops import kernel as tk

    cols, offsets, q = rec["columns"], rec["offsets"], rec["q"]
    W, R = rec["W"], rec["R"]
    dev = q.device
    k = offsets.shape[0]
    sid = q[:, tk.QF_SHARD].long().clamp(0, k - 1)
    chrom = q[:, tk.QF_CHROM].long()
    seg_lo = offsets[sid, chrom.clamp(0, 26)].long()
    seg_hi = offsets[sid, (chrom + 1).clamp(0, 26)].long()
    pos = cols[tk.C_POS]
    lo = _search(pos, q[:, tk.QF_START_MIN].long(), seg_lo, seg_hi,
                 upper=False)
    hi = _search(pos, q[:, tk.QF_START_MAX].long(), seg_lo, seg_hi,
                 upper=True)
    nv = (hi - lo).clamp(0, W)
    lane = torch.arange(W, device=dev)[None, :]
    valid = lane < nv[:, None]
    rows = (lo[:, None] + lane)[valid]
    qi = torch.arange(q.shape[0], device=dev)[:, None].expand(-1, W)[valid]
    mode = q[qi, tk.QF_ALT_MODE]
    fixed_ref = q[qi, tk.QF_REF_WILD] == 0
    sym = (cols[tk.C_FLAGS][rows] & FLAG.SYMBOLIC) != 0
    typed = (mode != tk.MODE_EXACT) & (mode != tk.MODE_ANY_BASE)
    need = {
        tk.C_REC_END: rows, tk.C_ALT_LEN: rows, tk.C_REC_ID: rows,
        tk.C_REF_HASH: rows[fixed_ref],
        tk.C_REF_LEN: rows[fixed_ref | typed],
        tk.C_ALT_HASH: rows[mode == tk.MODE_EXACT],
        tk.C_FLAGS: rows[mode != tk.MODE_EXACT],
        tk.C_REPEAT_K: rows[typed & ~sym],
    }
    sectors = sum(torch.unique(r // 8).numel() for r in need.values())
    sectors += torch.unique(rows[typed & sym] // 2).numel()  # alt_prefix
    b = q.shape[0]
    steps = torch.tensor([max(int(n), 0).bit_length()
                          for n in (seg_hi - seg_lo).tolist()])
    probes = 2 * int(steps.sum())
    io = q.numel() * 4 + b * (R + tk.N_AGG) * 4
    nbytes = (sectors + probes) * SECTOR_BYTES + io
    ops = (int(valid.sum()) * BISECT_OPS_PER_LANE
           + probes * BISECT_OPS_PER_PROBE)
    return nbytes, ops


NEED = {"scatter_match": scatter_match_need, "bisect_query": bisect_need}
