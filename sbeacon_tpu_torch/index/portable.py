"""Portable binary index files: the reference's on-S3 variant-index format.

Counterpart of ``sbeacon_tpu/index/portable.py``, copied whole.

The reference's ingest pipeline materialises, per VCF, a set of compact
binary region files under
``vcf-summaries/contig/{contig}/{escaped-location}/regions/{start}-{end}-{size}``
(reference: write_data_to_s3.h:98 key layout, parsed back at
initDuplicateVariantSearch.py:80-90), each a gzip stream of
``pos:u64 | len:u16 | packed_ref '_' packed_alt`` records with 4-bit base
packing, split at >100 kb position gaps (MAX_SLICE_GAP, main.tf:215) and
a 50 MB size ceiling (VCF_S3_OUTPUT_SIZE_LIMIT, main.tf:17). The
duplicate-variant search then reads ranges of these files and dedupes on
the ``{pos}{payload}`` key (duplicateVariantSearch.cpp:56-59).

Here the columnar shard (``columnar.py``) is the primary store; this
module provides the same portable exchange format — export from a shard,
range-filtered import, cross-dataset distinct-count — with the hot
encode/decode in C++ (``native/src/index_codec.cpp``) and a pure-Python
mirror used as fallback and as the round-trip oracle in tests.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from .. import native
from ..utils.chrom import CHROMOSOME_CODES
from .columnar import VariantIndexShard

#: reference terraform ceilings (main.tf:16-17,215)
MAX_SLICE_GAP = 100_000
MAX_FILE_RAW_BYTES = 50 * 1024 * 1024

_BASE_CODE = {
    65: 1, 97: 1,  # A a
    67: 2, 99: 2,  # C c
    71: 3, 103: 3,  # G g
    84: 4, 116: 4,  # T t
    78: 5, 110: 5,  # N n
    42: 6,  # *
    46: 7,  # .
}
_CODE_BASE = b"?ACGTN*."


def pack_seq(seq: bytes) -> bytes:
    """4-bit pack (first base of a pair in the high nibble, odd trailing
    base low-nibble alone); symbolic ``<...>`` and any unpackable text
    pass through raw (brackets stripped) — write_data_to_s3.h compressSeq."""
    n = len(seq)
    if n >= 2 and seq[0] == 0x3C and seq[-1] == 0x3E:  # <...>
        return seq[1:-1]
    codes = []
    for b in seq:
        c = _BASE_CODE.get(b)
        if c is None:
            return seq
        codes.append(c)
    if n == 1:
        return bytes(codes)
    out = bytearray()
    for i in range(0, n - 1, 2):
        out.append((codes[i] << 4) | codes[i + 1])
    if n % 2:
        out.append(codes[-1])
    return bytes(out)


def packed_len(seq: bytes) -> int:
    """len(pack_seq(seq)) computed arithmetically, without building the
    packed bytes (used by the export sizing pass)."""
    n = len(seq)
    if n >= 2 and seq[0] == 0x3C and seq[-1] == 0x3E:
        return n - 2
    if not all(b in _BASE_CODE for b in seq):
        return n  # raw passthrough
    return 1 if n == 1 else n // 2 + n % 2


_BASE_MEMBER = np.zeros(256, dtype=bool)
for _b in _BASE_CODE:
    _BASE_MEMBER[_b] = True


def packed_len_rows(blob: np.ndarray, off: np.ndarray) -> np.ndarray:
    """Vectorised :func:`packed_len` over every (blob, offsets) row —
    symbolic detection via first/last bytes, packability via a segment
    all() (cumsum-of-nonmembers difference), same arithmetic."""
    off = off.astype(np.int64)
    lens = np.diff(off)
    n = len(lens)
    starts, ends = off[:-1], off[1:]
    nz = lens > 0
    first = np.zeros(n, np.uint8)
    last = np.zeros(n, np.uint8)
    first[nz] = blob[starts[nz]]
    last[nz] = blob[ends[nz] - 1]
    symbolic = (lens >= 2) & (first == 0x3C) & (last == 0x3E)
    bad_cum = np.zeros(len(blob) + 1, np.int64)
    np.cumsum(~_BASE_MEMBER[blob], out=bad_cum[1:] if len(blob) else None)
    packable = (bad_cum[ends] - bad_cum[starts]) == 0
    packed = np.where(lens == 1, 1, lens // 2 + lens % 2)
    return np.where(symbolic, lens - 2, np.where(packable, packed, lens))


def unpack_seq(packed: bytes) -> bytes | None:
    """Inverse of :func:`pack_seq` for packed payloads; None when the
    bytes cannot be a packed sequence.

    HEURISTIC, exactly as ambiguous as the reference format itself: a
    raw/symbolic payload whose every byte happens to parse as valid
    nibble pairs (e.g. ``<GATA>`` stored raw as ``GATA``) decodes to a
    fabricated sequence. The format has no raw marker (the reference
    never decodes — it only compares packed payloads as opaque dedupe
    keys, duplicateVariantSearch.cpp:56-59); treat decoded text as
    display-only and use the payload bytes for identity."""
    out = bytearray()
    n = len(packed)
    for i, b in enumerate(packed):
        hi, lo = b >> 4, b & 0xF
        if lo == 0 or lo > 7 or hi > 7:
            return None
        if hi == 0:
            if i + 1 != n:
                return None
            out.append(_CODE_BASE[lo])
        else:
            out.append(_CODE_BASE[hi])
            out.append(_CODE_BASE[lo])
    return bytes(out)


def pack_records_py(pos, refs, alts, *, level: int = 9) -> bytes:
    """Pure-Python encoder (same wire format as the native codec)."""
    if not (len(pos) == len(refs) == len(alts)):
        raise ValueError("pos/refs/alts length mismatch")
    parts = []
    for p, ref, alt in zip(pos, refs, alts):
        payload = pack_seq(ref) + b"_" + pack_seq(alt)
        if len(payload) > 0xFFFF:
            raise ValueError("allele too long for u16 record length")
        parts.append(struct.pack("<QH", int(p), len(payload)) + payload)
    co = zlib.compressobj(level, zlib.DEFLATED, 15 + 16)
    return co.compress(b"".join(parts)) + co.flush()


def unpack_records_py(
    blob: bytes, range_start: int = 0, range_end: int = 2**63 - 1
):
    """Pure-Python decoder: (pos uint64 ndarray, payload list[bytes]).

    Inflates every concatenated gzip member: the reference writer emits
    multiple back-to-back members in one region object when its 50 MB raw
    ceiling is hit (write_data_to_s3.h saveOutputToS3:39-92), so a single
    ``zlib.decompress`` call would silently drop all records after the
    first member.
    """
    chunks = []
    rest = blob
    while rest:
        do = zlib.decompressobj(15 + 32)
        chunks.append(do.decompress(rest))
        chunks.append(do.flush())
        if not do.eof:
            raise ValueError("truncated gzip member")
        rest = do.unused_data
    raw = b"".join(chunks)
    positions, payloads = [], []
    i, n = 0, len(raw)
    while i + 10 <= n:
        p, ln = struct.unpack_from("<QH", raw, i)
        i += 10
        if i + ln > n:
            raise ValueError("truncated record")
        if range_start <= p <= range_end:
            positions.append(p)
            payloads.append(raw[i : i + ln])
        i += ln
    if i != n:
        raise ValueError("truncated record")
    return np.asarray(positions, dtype=np.uint64), payloads


def pack_records(pos, refs, alts, *, level: int = 9) -> bytes:
    if native.available():
        return native.pack_records(pos, list(refs), list(alts), level=level)
    return pack_records_py(pos, refs, alts, level=level)


def unpack_records(
    blob: bytes, range_start: int = 0, range_end: int = 2**63 - 1
):
    if native.available():
        return native.unpack_records(blob, range_start, range_end)
    return unpack_records_py(blob, range_start, range_end)


# -- region-file export / import ---------------------------------------------


def _escape_location(location: str) -> str:
    """Reference key escaping: '/' -> '%' (write_data_to_s3.h ctor)."""
    return str(location).replace("/", "%")


def export_region_files(
    shard: VariantIndexShard,
    out_dir: str | Path,
    *,
    max_gap: int = MAX_SLICE_GAP,
    max_raw_bytes: int = MAX_FILE_RAW_BYTES,
    level: int = 6,
) -> list[Path]:
    """Write the shard as reference-layout region files:
    ``contig/{chrom}/{escaped-location}/regions/{start}-{end}-{rawsize}``,
    new file at every >max_gap position gap or raw-size ceiling.

    ``level`` is zlib's standard default (6): exports were ~20% of ingest
    wall time at level 9 for low-single-digit % smaller files, and the
    wire format (and the {rawsize} suffix, which counts PRE-compression
    bytes) is identical at any level — importers never see the difference.
    """
    out_dir = Path(out_dir)
    location = _escape_location(shard.meta.get("vcf_location", "unknown"))
    pos = shard.cols["pos"]
    ref_off = shard.ref_off
    alt_off = shard.alt_off
    written: list[Path] = []

    # re-ingest must not leave stale region files from a previous export
    # of this VCF (the export is a full rewrite, like the npz shard);
    # glob-escape the location so [ ] * ? in file names match literally
    import glob as _glob
    import shutil

    for old in out_dir.glob(f"contig/*/{_glob.escape(location)}"):
        shutil.rmtree(old, ignore_errors=True)

    def row_ref_b(i: int) -> bytes:
        # python-fallback flush only (the native path slices blobs whole)
        return shard.ref_blob[ref_off[i] : ref_off[i + 1]].tobytes()

    def row_alt_b(i: int) -> bytes:
        return shard.alt_blob[alt_off[i] : alt_off[i + 1]].tobytes()


    for chrom, code in CHROMOSOME_CODES.items():
        lo = int(shard.chrom_offsets[code])
        hi = int(shard.chrom_offsets[code + 1])
        if hi <= lo:
            continue
        rdir = out_dir / "contig" / chrom / location / "regions"
        rdir.mkdir(parents=True, exist_ok=True)
        # raw record size = 10-byte header + packed ref + '_' + packed alt
        # (the reference's {size} suffix counts the pre-gzip packed stream,
        # write_data_to_s3.h bufferLength) — vectorised over JUST this
        # chromosome's blob span (whole-blob work per chromosome would be
        # O(n_chroms x blob))
        r0, a0 = int(ref_off[lo]), int(alt_off[lo])
        rec_raw = (
            10
            + packed_len_rows(
                shard.ref_blob[r0 : int(ref_off[hi])],
                ref_off[lo : hi + 1].astype(np.int64) - r0,
            )
            + 1
            + packed_len_rows(
                shard.alt_blob[a0 : int(alt_off[hi])],
                alt_off[lo : hi + 1].astype(np.int64) - a0,
            )
        )
        start = lo
        raw_bytes = 0

        def flush(start_row: int, end_row: int, raw: int):
            """[start_row, end_row) -> one region file."""
            if native.available():
                # zero-copy: shard blob slices + rebased offsets go
                # straight to the native packer (no per-row bytes)
                r0, r1 = int(ref_off[start_row]), int(ref_off[end_row])
                a0, a1 = int(alt_off[start_row]), int(alt_off[end_row])
                blob = native.pack_records_arrays(
                    pos[start_row:end_row].astype(np.uint64),
                    shard.ref_blob[r0:r1],
                    ref_off[start_row : end_row + 1] - r0,
                    shard.alt_blob[a0:a1],
                    alt_off[start_row : end_row + 1] - a0,
                    level=level,
                )
            else:
                blob = pack_records(
                    pos[start_row:end_row].astype(np.uint64),
                    [row_ref_b(i) for i in range(start_row, end_row)],
                    [row_alt_b(i) for i in range(start_row, end_row)],
                    level=level,
                )
            name = f"{int(pos[start_row])}-{int(pos[end_row - 1])}-{raw}"
            path = rdir / name
            path.write_bytes(blob)
            written.append(path)

        for i in range(lo, hi):
            gap_split = i > start and int(pos[i]) > int(pos[i - 1]) + max_gap
            size_split = (
                raw_bytes + int(rec_raw[i - lo]) > max_raw_bytes and i > start
            )
            if gap_split or size_split:
                flush(start, i, raw_bytes)
                start, raw_bytes = i, 0
            raw_bytes += int(rec_raw[i - lo])
        flush(start, hi, raw_bytes)
    _write_manifest(out_dir)
    return written


def _write_manifest(out_dir: Path) -> None:
    """Regenerate ``manifest.txt`` (one relative region path per line).

    Object stores have no directory listing over plain HTTP, so the
    manifest is the export's self-describing key list — the role S3
    ListObjects plays for the reference's vcf-summaries/ prefix
    (initDuplicateVariantSearch.py get_object_list)."""
    lines = sorted(
        str(p.relative_to(out_dir))
        for p in out_dir.glob("contig/*/*/regions/*")
    )
    (out_dir / "manifest.txt").write_text("\n".join(lines) + "\n")


def parse_region_filename(path: str | Path) -> tuple[int, int, int]:
    """(start, end, raw_size) from '{start}-{end}-{size}' — the parse at
    initDuplicateVariantSearch.py:80-90."""
    start, end, size = Path(path).name.rsplit("-", 2)
    return int(start), int(end), int(size)


def iter_region_files(root: str | Path):
    """Yield (chrom, location, path, start, end, raw_size) under an export
    root — a local directory, or a remote (http(s)/s3) root whose
    ``manifest.txt`` lists the region keys."""
    from ..io import is_remote, read_bytes

    if is_remote(root):
        base = str(root).rstrip("/")
        for rel in read_bytes(f"{base}/manifest.txt").decode().splitlines():
            rel = rel.strip()
            if not rel:
                continue
            parts = rel.split("/")
            chrom, location = parts[1], parts[2]
            start, end, size = parse_region_filename(parts[-1])
            yield chrom, location, f"{base}/{rel}", start, end, size
        return
    root = Path(root)
    for path in sorted(root.glob("contig/*/*/regions/*")):
        chrom = path.parts[-4]
        location = path.parts[-3]
        start, end, size = parse_region_filename(path)
        yield chrom, location, path, start, end, size


def distinct_variant_count_files(
    roots: list[str | Path],
    *,
    range_start: int = 0,
    range_end: int = 2**63 - 1,
) -> int:
    """Distinct (contig, pos, payload) across exported datasets — the
    duplicateVariantSearch tally (duplicateVariantSearch.cpp:31-84) over
    the portable files instead of live shards."""
    from ..io import read_bytes

    seen: set[tuple[str, int, bytes]] = set()
    for root in roots:
        for chrom, _loc, path, start, end, _size in iter_region_files(root):
            if end < range_start or start > range_end:
                continue
            positions, payloads = unpack_records(
                read_bytes(path), range_start, range_end
            )
            for p, pay in zip(positions.tolist(), payloads):
                seen.add((chrom, int(p), bytes(pay)))
    return len(seen)
