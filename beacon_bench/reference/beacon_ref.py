"""Plain NumPy reference of the Beacon v2 ``/g_variants`` answers the
benchmark's traffic asks for, computed from the benchmark's own rows
(``lib.datagen.Dataset``: positions, allele strings, AC, AN),
independent of the program.

What it states, from the GA4GH Beacon v2 and the sBeacon reference
implementation it follows (``performQuery/search_variants.py``,
``route_g_variants.py``):

- coordinates: 0-based request ``start``/``end`` become a 1-based
  bracket (two values each), or a start-anchored range (one each);
- a row matches when its position is in [start_min, start_max], its
  record's end (pos + len(REF) - 1) in [end_min, end_max], its REF
  equals ``referenceBases`` (upper case; ``N`` alone accepts anything),
  its ALT's
  length is within [variantMinLength, variantMaxLength], and its ALT is
  ``alternateBases`` (``N``: any single base), or of ``variantType``
  (symbolic ALT by its name; DEL/INS by length; DUP/CNV by REF
  repeats);
- per dataset, records are walked in order: the calls (AC) of a
  record's matched rows accumulate, a matched row with calls is a
  listed variant, and a boolean request stops at the first record with
  calls;
- across datasets the variants are one set (chromosome, position, REF,
  ALT), counted.

It imports numpy and the standard library only.
"""

from __future__ import annotations

import numpy as np

from ..lib.datagen import CHROMS, Dataset

CHROM_INDEX = {c: k for k, c in enumerate(CHROMS)}
INT32_MAX = 2**31 - 1


class Query:
    """The request fields a reference answer depends on."""

    def __init__(self, rp: dict, *, granularity: str, include: str):
        start, end = list(rp["start"]), list(rp["end"])
        if len(start) == 2:
            smin, smax = start
        else:
            smin = start[0]
        if len(end) == 2:
            emin, emax = end
        else:
            emin, emax = smin, end[0]
        if len(start) != 2:
            smax = emax
        self.chrom = rp["referenceName"].removeprefix("chr")
        self.start_min, self.start_max = smin + 1, smax + 1
        self.end_min, self.end_max = emin + 1, emax + 1
        self.ref = rp.get("referenceBases")
        self.alt = rp.get("alternateBases")
        self.vt = rp.get("variantType")
        self.vmin = int(rp.get("variantMinLength", 0))
        vmax = int(rp.get("variantMaxLength", -1))
        self.vmax = INT32_MAX if vmax < 0 else vmax
        self.granularity = granularity
        self.details = include in ("HIT", "ALL")


class VocabTables:
    """Per-allele facts of one dataset's vocabulary."""

    def __init__(self, vocab: list[str]):
        self.vocab = vocab
        self.upper = [v.upper() for v in vocab]
        self.length = np.array([len(v) for v in vocab], np.int64)
        self.sym = np.array([v.startswith("<") for v in vocab])
        self.single = np.array(
            [len(v) == 1 and v.upper() in "ACGTN" for v in vocab])

        def repeat_k(ref, alt):
            if not ref or not alt or len(alt) % len(ref):
                return -1
            k = len(alt) // len(ref)
            return min(k, 120) if alt == ref * k else -1

        self.k = np.array([[repeat_k(r, a) for a in vocab] for r in vocab],
                          np.int64)

        def has(prefix):
            return np.array([v.startswith(prefix) for v in vocab])

        self.cn = has("<CN")
        self.dele = has("<DEL")
        self.dup = has("<DUP")
        self.eq = {s: np.array([v == s for v in vocab])
                   for s in ("<CN0>", "<CN1>", "<CN2>", ".")}
        self._cache = {}

    def ref_ok(self, ref: str | None) -> np.ndarray | None:
        """[V] bool: REF allele matches, or None for no constraint."""
        if ref is None or ref == "N":
            return None
        key = ("ref", ref)
        if key not in self._cache:
            self._cache[key] = np.array([v == ref.upper()
                                         for v in self.upper])
        return self._cache[key]

    def alt_ok(self, q: Query) -> np.ndarray:
        """[V, V] bool indexed (REF id, ALT id): the ALT test of ``q``."""
        key = ("alt", q.alt, q.vt, q.vmin, q.vmax)
        if key in self._cache:
            return self._cache[key]
        V = len(self.vocab)
        ln = self.length
        len_ok = (q.vmin <= ln) & (ln <= q.vmax)
        if q.alt is None:
            vt = q.vt
            pm = np.array([v.startswith("<" + str(vt)) for v in self.vocab])
            sym = self.sym[None, :]
            rlen, alen = ln[:, None], ln[None, :]
            if vt == "DEL":
                ok = np.where(sym, (pm | self.eq["<CN0>"])[None, :],
                              alen < rlen)
            elif vt == "INS":
                ok = np.where(sym, pm[None, :], alen > rlen)
            elif vt == "DUP":
                ok = np.where(sym, (pm | (self.cn & ~self.eq["<CN0>"]
                                          & ~self.eq["<CN1>"]))[None, :],
                              self.k >= 2)
            elif vt == "DUP:TANDEM":
                ok = np.where(sym, (pm | self.eq["<CN2>"])[None, :],
                              self.k == 2)
            elif vt == "CNV":
                ok = np.where(sym, (pm | self.cn | self.dele
                                    | self.dup)[None, :],
                              self.eq["."][None, :] | (self.k >= 1))
            else:
                ok = np.broadcast_to(sym & pm[None, :], (V, V))
        elif q.alt == "N":
            ok = np.broadcast_to(self.single[None, :], (V, V))
        else:
            ok = np.broadcast_to(
                np.array([u == q.alt for u in self.upper])[None, :], (V, V))
        out = np.asarray(ok & len_ok[None, :])
        self._cache[key] = out
        return out


def matched_rows(ds: Dataset, tabs: VocabTables, q: Query,
                 cap: int | None = None) -> np.ndarray:
    """Ascending row ids of ``ds`` that match ``q``; with ``cap`` (the
    control) only the first ``cap`` rows of the start bracket are
    looked at."""
    c = CHROM_INDEX.get(q.chrom)
    if c is None:
        return np.zeros(0, np.int64)
    lo, hi = int(ds.chrom_start[c]), int(ds.chrom_start[c + 1])
    pos = ds.pos[lo:hi]
    a = lo + int(np.searchsorted(pos, q.start_min, side="left"))
    b = lo + int(np.searchsorted(pos, q.start_max, side="right"))
    if cap is not None:
        b = min(b, a + cap)
    if a >= b:
        return np.zeros(0, np.int64)
    ref_id = ds.ref_id[a:b].astype(np.int64)
    alt_id = ds.alt_id[a:b].astype(np.int64)
    end = ds.pos[a:b] + tabs.length[ref_id] - 1
    ok = (q.end_min <= end) & (end <= q.end_max)
    rok = tabs.ref_ok(q.ref)
    if rok is not None:
        ok &= rok[ref_id]
    ok &= tabs.alt_ok(q)[ref_id, alt_id]
    return np.flatnonzero(ok) + a


class DatasetAnswer:
    __slots__ = ("exists", "variants")

    def __init__(self, exists, variants):
        self.exists = exists
        self.variants = variants  # [(chrom, pos, ref, alt)] in order


def dataset_answer(ds: Dataset, tabs: VocabTables, q: Query,
                   cap: int | None = None) -> DatasetAnswer:
    rows = matched_rows(ds, tabs, q, cap)
    if not len(rows):
        return DatasetAnswer(False, [])
    rec = ds.rec_id[rows]
    starts = np.flatnonzero(np.r_[True, rec[1:] != rec[:-1]])
    ends = np.r_[starts[1:], len(rows)]
    calls = np.add.reduceat(ds.ac[rows].astype(np.int64), starts)
    cum = np.cumsum(calls)
    hit = np.flatnonzero(cum > 0)
    if not len(hit):
        return DatasetAnswer(False, [])
    first = int(hit[0])
    if q.granularity == "boolean" or not q.details:
        last = first  # the walk stops at the first record with calls
    else:
        last = len(starts) - 1
    keep = rows[: ends[last]]
    keep = keep[ds.ac[keep] != 0]
    variants = [(CHROMS[int(ds.chrom[r])], int(ds.pos[r]),
                 ds.vocab[int(ds.ref_id[r])], ds.vocab[int(ds.alt_id[r])])
                for r in keep]
    return DatasetAnswer(True, variants)


def variants_summary(answers: list[DatasetAnswer], q: Query) -> dict:
    """What a ``/g_variants`` envelope states: ``exists``, and past
    boolean ``numTotalResults``, the distinct variants of all datasets."""
    exists = any(a.exists for a in answers)
    out = {"exists": exists}
    if q.granularity == "boolean":
        return out
    seen = set()
    if q.details:
        for a in answers:
            seen.update(a.variants)
    out["count"] = len(seen)
    return out
