"""BGZF (blocked gzip) reading and writing.

Counterpart of ``sbeacon_tpu/genomics/bgzf.py``, copied whole.

BGZF is the framing used by bgzipped VCFs: a sequence of independent gzip
members, each at most 64 KiB uncompressed, whose total compressed size is
recorded in a BSIZE extra field so readers can hop block-to-block without
inflating. Positions inside the stream are "virtual offsets":
``(compressed_block_offset << 16) | offset_within_uncompressed_block``.

The reference consumes this format with a C++ streaming reader that splits a
VCF at block boundaries for Lambda fan-out (reference:
lambda/summariseSlice/source/vcf_chunk_reader.h:24-32 for the virtual-offset
split, :143-174 for block header parsing). This module provides the same
capabilities as a clean library: block scanning, random access by virtual
offset, region slicing for parallel ingest, and a writer for producing
bgzipped fixtures/outputs (the reference relies on the external ``bgzip``
binary for that).
"""

from __future__ import annotations

import io
import struct
import zlib
from pathlib import Path

# 18-byte BGZF member header: gzip magic, deflate, FEXTRA, mtime 0, XFL 0,
# OS unknown, XLEN=6, extra subfield BC(2) len 2, BSIZE u16.
_HEADER = struct.Struct("<BBBBIBBHBBHH")
_HEADER_SIZE = 18
_MAX_UNCOMPRESSED = 65280  # bgzip's per-block payload cap

# The canonical 28-byte BGZF EOF marker block.
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


class BgzfError(ValueError):
    pass


def make_virtual_offset(block_offset: int, within_offset: int) -> int:
    return (block_offset << 16) | within_offset


def split_virtual_offset(voffset: int) -> tuple[int, int]:
    return voffset >> 16, voffset & 0xFFFF


def read_block_header(buf: bytes, pos: int = 0) -> int:
    """Parse one BGZF member header at ``pos``; return total block size."""
    if len(buf) - pos < _HEADER_SIZE:
        raise BgzfError("truncated BGZF header")
    (id1, id2, cm, flg, _mtime, _xfl, _os, xlen, si1, si2, slen, bsize) = (
        _HEADER.unpack_from(buf, pos)
    )
    if id1 != 0x1F or id2 != 0x8B or cm != 8:
        raise BgzfError("not a gzip member")
    if not flg & 4:
        raise BgzfError("gzip member without FEXTRA — not BGZF")
    if si1 != 66 or si2 != 67 or slen != 2 or xlen < 6:
        # Extra field may hold more subfields; scan for BC.
        end = pos + 12 + xlen
        p = pos + 12
        while p + 4 <= end:
            s1, s2, sl = buf[p], buf[p + 1], struct.unpack_from("<H", buf, p + 2)[0]
            if s1 == 66 and s2 == 67 and sl == 2:
                bsize = struct.unpack_from("<H", buf, p + 4)[0]
                break
            p += 4 + sl
        else:
            raise BgzfError("no BGZF BC subfield")
    return bsize + 1


def decompress_block(buf: bytes, pos: int = 0) -> tuple[bytes, int]:
    """Inflate the BGZF block at ``pos``; return (payload, total_block_size)."""
    size = read_block_header(buf, pos)
    # Deflate data sits between the 18-byte header and the 8-byte trailer
    # (CRC32 + ISIZE). zlib with wbits=-15 consumes raw deflate.
    xlen = struct.unpack_from("<H", buf, pos + 10)[0]
    data_start = pos + 12 + xlen
    comp = buf[data_start : pos + size - 8]
    payload = zlib.decompress(comp, wbits=-15)
    (crc, isize) = struct.unpack_from("<II", buf, pos + size - 8)
    if isize != len(payload):
        raise BgzfError("BGZF ISIZE mismatch")
    if crc != (zlib.crc32(payload) & 0xFFFFFFFF):
        raise BgzfError("BGZF CRC mismatch")
    return payload, size


def compress_block(payload: bytes, level: int = 6) -> bytes:
    """Produce one complete BGZF member for <=65280 payload bytes."""
    if len(payload) > _MAX_UNCOMPRESSED:
        raise BgzfError("payload too large for one BGZF block")
    compressor = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = compressor.compress(payload) + compressor.flush()
    bsize = _HEADER_SIZE + len(comp) + 8 - 1
    if bsize >= 1 << 16:
        # Incompressible payload: retry with stored blocks via level 0.
        compressor = zlib.compressobj(0, zlib.DEFLATED, -15)
        comp = compressor.compress(payload) + compressor.flush()
        bsize = _HEADER_SIZE + len(comp) + 8 - 1
        if bsize >= 1 << 16:
            raise BgzfError("block does not fit even stored")
    header = _HEADER.pack(
        0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, 66, 67, 2, bsize
    )
    trailer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
    return header + comp + trailer


class BgzfWriter:
    """Streaming BGZF writer (the role bgzip plays for the reference)."""

    def __init__(self, path: str | Path, level: int = 6):
        self._fh = open(path, "wb")
        self._level = level
        self._buf = bytearray()

    def write(self, data: bytes | str) -> None:
        if isinstance(data, str):
            data = data.encode()
        self._buf.extend(data)
        while len(self._buf) >= _MAX_UNCOMPRESSED:
            chunk = bytes(self._buf[:_MAX_UNCOMPRESSED])
            del self._buf[:_MAX_UNCOMPRESSED]
            self._fh.write(compress_block(chunk, self._level))

    def close(self) -> None:
        if self._buf:
            self._fh.write(compress_block(bytes(self._buf), self._level))
            self._buf.clear()
        self._fh.write(BGZF_EOF)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def scan_blocks(path: str | Path) -> list[tuple[int, int, int]]:
    """Hop through a BGZF file reading only headers.

    Returns [(compressed_offset, compressed_size, uncompressed_size)] per
    block, excluding the EOF block. This gives the ingest planner its slice
    boundaries without any .tbi/.csi (the reference needs the tabix index
    for this, lambda/summariseVcf/index_reader.py).
    """
    out = []
    with open(path, "rb") as fh:
        data = fh.read()
    pos = 0
    n = len(data)
    while pos < n:
        size = read_block_header(data, pos)
        isize = struct.unpack_from("<I", data, pos + size - 4)[0]
        if isize > 0:
            out.append((pos, size, isize))
        pos += size
    return out


class BgzfReader:
    """Random-access BGZF reader with virtual-offset seeks.

    Local files are held in memory (framework files are block-sliced
    before they get here; the C++ path streams). A small block cache makes
    sequential line iteration cheap.

    Remote objects (``http(s)://`` / ``s3://`` — the port's ``io`` sources)
    are read by RANGED GETs: a bounded read prefetches its compressed
    span in one concurrent chunked fetch (the reference's 4-thread
    download ring, vcf_chunk_reader.h:69-105 + downloader.h), and
    unbounded iteration streams segment-sized fetches — the whole object
    is never required to be local.
    """

    #: remote segment fetch size for unbounded iteration
    SEG_BYTES = 2 * 1024 * 1024
    #: max size of one compressed BGZF block (BSIZE is u16)
    _BLOCK_MAX = 1 << 16

    def __init__(self, path: str | Path):
        from ..io import is_remote, open_source

        self._path = str(path)
        self._remote = is_remote(self._path)
        self._source = open_source(self._path) if self._remote else None
        self._data_loaded: bytes | None = None  # lazy: native paths never
        self._block_cache_off = -1              # touch the python copy
        self._block_cache: bytes = b""
        self._block_cache_size = 0
        self._seg_start = 0                     # remote segment buffer
        self._seg: bytes = b""

    @property
    def _data(self) -> bytes:
        if self._data_loaded is None:
            if self._remote:
                self._data_loaded = self._source.read_range(
                    0, self._source.size(), workers=4
                )
            else:
                with open(self._path, "rb") as fh:
                    self._data_loaded = fh.read()
        return self._data_loaded

    @property
    def _csize(self) -> int:
        """Compressed object size without forcing a full download."""
        if self._remote and self._data_loaded is None:
            return self._source.size()
        return len(self._data)

    def _native(self):
        """The C++ codec when built (parallel block inflate); None keeps
        the pure-Python path (also on single-core hosts, where the pool
        cannot beat python's one-shot zlib — see native.prefer_native_io).
        Remote objects always use the python path (the native codec reads
        local files).
        """
        if self._remote:
            return None
        try:
            from .. import native

            return native if native.prefer_native_io() else None
        except Exception:
            return None

    def _block_buf(self, coffset: int) -> tuple[bytes, int]:
        """(buffer, position) with the whole block at ``coffset`` present."""
        if not self._remote or self._data_loaded is not None:
            return self._data, coffset
        need_end = min(coffset + self._BLOCK_MAX, self._csize)
        covered = (
            self._seg_start <= coffset
            and need_end <= self._seg_start + len(self._seg)
        )
        if not covered:
            seg_end = min(
                max(coffset + self.SEG_BYTES, need_end), self._csize
            )
            self._seg = self._source.read_range(coffset, seg_end, workers=4)
            self._seg_start = coffset
        return self._seg, coffset - self._seg_start

    def prefetch(self, voffset_start: int, voffset_end: int) -> None:
        """One concurrent ranged fetch covering a virtual-offset span —
        block loads inside the span then hit the local segment."""
        if not self._remote or self._data_loaded is not None:
            return
        c0, _ = split_virtual_offset(voffset_start)
        c1, _ = split_virtual_offset(voffset_end)
        end = min(c1 + self._BLOCK_MAX, self._csize)
        if (
            self._seg_start <= c0
            and end <= self._seg_start + len(self._seg)
        ):
            return
        self._seg = self._source.read_range(c0, end, workers=4)
        self._seg_start = c0

    def _load_block(self, coffset: int) -> bytes:
        if coffset != self._block_cache_off:
            buf, pos = self._block_buf(coffset)
            payload, size = decompress_block(buf, pos)
            self._block_cache = payload
            self._block_cache_off = coffset
            self._block_cache_size = size
        return self._block_cache

    def read_all(self) -> bytes:
        nat = self._native()
        if nat is not None:
            try:
                return nat.inflate_range(self._path)
            except Exception:
                pass
        out = io.BytesIO()
        pos = 0
        while pos < len(self._data):
            payload, size = decompress_block(self._data, pos)
            out.write(payload)
            pos += size
        return out.getvalue()

    def read_range(self, voffset_start: int, voffset_end: int) -> bytes:
        """Uncompressed bytes in [voffset_start, voffset_end)."""
        nat = self._native()
        if nat is not None:
            try:
                return nat.inflate_range(
                    self._path, voffset_start, voffset_end
                )
            except Exception:
                pass
        self.prefetch(voffset_start, voffset_end)
        out = io.BytesIO()
        coff, uoff = split_virtual_offset(voffset_start)
        end_coff, end_uoff = split_virtual_offset(voffset_end)
        while True:
            payload = self._load_block(coff)
            size = self._block_cache_size
            if coff == end_coff:
                out.write(payload[uoff:end_uoff])
                break
            out.write(payload[uoff:])
            coff += size
            uoff = 0
            if coff >= self._csize or not payload:
                break
            if coff > end_coff:
                break
        return out.getvalue()

    def iter_lines(self, voffset_start: int = 0, voffset_end: int | None = None):
        """Yield (voffset_of_line_start, line_bytes_without_newline).

        Lines starting at or after ``voffset_end`` (when given) are not
        yielded; the final partial line (no trailing newline) is yielded.
        """
        if voffset_end is not None:
            self.prefetch(voffset_start, voffset_end)
        coff, uoff = split_virtual_offset(voffset_start)
        end = voffset_end
        carry = b""
        carry_voff = voffset_start
        while coff < self._csize:
            if end is not None and make_virtual_offset(coff, uoff) >= end:
                break
            payload = self._load_block(coff)
            size = self._block_cache_size
            chunk = payload[uoff:]
            base_coff, base_uoff = coff, uoff
            start = 0
            while True:
                nl = chunk.find(b"\n", start)
                if nl < 0:
                    carry += chunk[start:]
                    break
                line_voff = (
                    carry_voff
                    if carry
                    else make_virtual_offset(base_coff, base_uoff + start)
                )
                if end is not None and line_voff >= end:
                    return
                yield line_voff, carry + chunk[start:nl]
                carry = b""
                start = nl + 1
                carry_voff = make_virtual_offset(base_coff, base_uoff + start)
            if not carry:
                carry_voff = make_virtual_offset(coff + size, 0)
            coff += size
            uoff = 0
            if not payload:
                break
        if carry:
            if end is None or carry_voff < end:
                yield carry_voff, carry
