"""Native (C++) hot-path library: BGZF codec, VCF slice scanner,
record tokenizer, index record codec, genotype-plane builder.

Counterpart of ``sbeacon_tpu/native/__init__.py``: the same C++17
sources (copied under ``native/src/``), the same flat C surface loaded
through ctypes, every entry point and its pure-Python fallback
(``NativeUnavailable``, ``available()``, ``prefer_native_io()``). The
build differs (JAX package ``:49-70``): the library is compiled at first
use into ``build/native/`` of the checkout (git-ignored), named by a hash
of the sources and the flags, through a temporary file and an
``os.replace`` under a file lock, so several processes starting at once
(the tests' xdist workers) build it once and never load a half-written
file. A host with the zlib runtime but no ``zlib.h`` compiles against
``native/zlib_shim/zlib.h`` (searched after the system headers) and links
the ``libz.so.1`` that Python's ``zlib`` module loaded.

Every entry point has a pure-Python fallback in ``genomics/``; callers use
``available()`` or just call the wrappers, which raise ``NativeUnavailable``
when the toolchain/library is missing so the Python path can take over.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path

log = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "src"
_SHIM = Path(__file__).resolve().parent / "zlib_shim"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_SOURCES = [
    "bgzf.cpp",
    "scan.cpp",
    "index_codec.cpp",
    "gt_planes.cpp",
    "tokenize.cpp",
]
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None
_build_failed = False


class NativeUnavailable(RuntimeError):
    pass


def _zlib_link() -> list[str]:
    """Link arguments for zlib: the runtime Python's ``zlib`` module
    mapped (no ``libz.so`` development link needed), else ``-lz``."""
    import zlib  # noqa: F401  (maps libz.so.1 when it is shared)

    try:
        with open("/proc/self/maps") as f:
            for line in f:
                path = line.rsplit(None, 1)[-1]
                if "/libz.so" in path and os.path.exists(path):
                    return [path]
    except OSError:
        pass
    return ["-lz"]


def _digest() -> str:
    h = hashlib.sha256()
    for name in sorted(p.name for p in _SRC.iterdir()):
        h.update(name.encode() + (_SRC / name).read_bytes())
    h.update((_SHIM / "zlib.h").read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return h.hexdigest()[:16]


def build(force: bool = False) -> Path:
    """Compile the shared library into ``build/native/`` unless the one
    for these sources exists; returns its path."""
    out = BUILD_DIR / f"_sbnative-{_digest()}.so"
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists() and not force:
            return out  # another process built it while this one waited
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        try:
            cmd = [
                "g++",
                *_FLAGS,
                "-idirafter",
                str(_SHIM),
                *[str(_SRC / s) for s in _SOURCES],
                *_zlib_link(),
                "-o",
                tmp,
            ]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            path = build()
            lib = ctypes.CDLL(str(path))
        except Exception as e:
            _build_failed = True
            log.warning("native library unavailable: %s", e)
            return None
        lib.sbn_inflate_range.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.sbn_inflate_range.restype = ctypes.c_int
        if hasattr(lib, "sbn_inflate_buffer"):
            lib.sbn_inflate_buffer.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_uint64,
                ctypes.c_uint64,
                ctypes.c_uint64,
                ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.sbn_inflate_buffer.restype = ctypes.c_int
        lib.sbn_compress_bgzf.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.sbn_compress_bgzf.restype = ctypes.c_int
        lib.sbn_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.sbn_count_slice.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sbn_count_slice.restype = ctypes.c_int
        u8pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
        u32pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32))
        u64pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64))
        i64pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))
        lib.sbn_tokenize.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint64,
            ctypes.c_uint64,
            i64pp,              # pos
            u32pp, u32pp,       # chrom off/len
            u32pp, u32pp,       # ref off/len
            u32pp, u32pp,       # vt off/len
            i64pp, u8pp, u8pp,  # an, has_an, has_ac
            i64pp,              # tok_total
            u32pp, u32pp, u64pp,  # alt off/len/start
            i64pp,              # ac_gt
            i64pp, u64pp,       # ac, ac_start
            u8pp, u64pp,        # gt_blob, gt_off
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.sbn_tokenize.restype = ctypes.c_int
        lib.sbn_line_offsets.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64,
        ]
        lib.sbn_line_offsets.restype = ctypes.c_int64
        lib.sbn_pack_records.argtypes = [
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.sbn_pack_records.restype = ctypes.c_int
        lib.sbn_unpack_records.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
        ]
        lib.sbn_unpack_records.restype = ctypes.c_int64
        lib.sbn_unpack_seq.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint64,
        ]
        lib.sbn_unpack_seq.restype = ctypes.c_int64
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.sbn_gt_planes.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64,
            ctypes.c_uint64,
            i32p,
            i32p,
            ctypes.c_uint64,
            ctypes.c_uint64,
            u32p,
            u32p,
            u32p,
            u32p,
            ctypes.POINTER(i64p),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(i64p),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.sbn_gt_planes.restype = ctypes.c_int64
        if hasattr(lib, "sbn_tokenize_planes"):
            # uint64 params MUST be declared: the ctypes default of
            # c_int silently truncates len/n_samples/words >= 2^32
            # (a >=2 GiB decompressed slice would mis-parse with no
            # error on the fused hot path)
            u8pp_ = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
            u32pp_ = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32))
            u64pp_ = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64))
            i64pp_ = ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))
            u64p_ = ctypes.POINTER(ctypes.c_uint64)
            lib.sbn_tokenize_planes.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_uint64,      # len
                ctypes.c_uint64,      # n_samples
                ctypes.c_uint64,      # words
                i64pp_,               # pos
                u32pp_, u32pp_,       # chrom off/len
                u32pp_, u32pp_,       # ref off/len
                u32pp_, u32pp_,       # vt off/len
                i64pp_, u8pp_, u8pp_,  # an, has_an, has_ac
                i64pp_,               # tok_total
                u32pp_, u32pp_, u64pp_,  # alt off/len/start
                i64pp_,               # ac_gt
                i64pp_, u64pp_,       # ac, ac_start
                u32pp_, u32pp_,       # g1, g2
                u32pp_, u32pp_,       # t1, t2
                i64pp_, u64p_,        # gt_over, n_gt_over
                i64pp_, u64p_,        # tok_over, n_tok_over
                u64p_, u64p_, u64p_,  # n_rec, n_alt, n_ac
            ]
            lib.sbn_tokenize_planes.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def prefer_native_io() -> bool:
    """Whether the native BGZF codec should take over I/O paths: it wins
    via block-parallel inflate, so a single-core host keeps python's
    one-shot zlib (both are C underneath; the pool only adds overhead).
    ``BEACON_NATIVE_IO=0`` is the operator kill switch — every call site
    behind this gate has a pure-Python fallback, so flipping it degrades
    throughput, never correctness."""
    import os

    if os.environ.get("BEACON_NATIVE_IO", "").strip().lower() in (
        "0",
        "off",
        "false",
        "no",
    ):
        return False
    return (os.cpu_count() or 1) >= 2 and available()


def _take_buffer(lib, out_p, out_len) -> bytes:
    try:
        if not out_p or out_len.value == 0:
            return b""
        return ctypes.string_at(out_p, out_len.value)
    finally:
        if out_p:
            lib.sbn_free(out_p)


def inflate_range(
    path: str | Path,
    vstart: int = 0,
    vend: int | None = None,
    *,
    n_threads: int | None = None,
) -> bytes:
    """Decompress the BGZF virtual-offset range [vstart, vend) — the
    native VcfChunkReader role, blocks inflated in parallel (adaptive:
    single-core machines take a pool-free reused-z_stream path)."""
    if n_threads is None:
        import os

        n_threads = min(8, os.cpu_count() or 1)
    lib = get_lib()
    if lib is None:
        raise NativeUnavailable("native library not built")
    out_p = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_uint64()
    rc = lib.sbn_inflate_range(
        str(path).encode(),
        vstart,
        2**64 - 1 if vend is None else vend,
        n_threads,
        ctypes.byref(out_p),
        ctypes.byref(out_len),
    )
    if rc != 0:
        raise NativeUnavailable(f"sbn_inflate_range failed rc={rc}")
    return _take_buffer(lib, out_p, out_len)


def inflate_buffer(
    data: bytes,
    vstart: int = 0,
    vend: int | None = None,
    *,
    n_threads: int | None = None,
) -> bytes:
    """Decompress the BGZF virtual-offset range [vstart, vend) of a
    compressed blob already in memory — the remote scan-blob leg, where
    the span arrives by ranged GET and never touches local disk. Offsets
    are relative to the blob, whose first byte must be a block boundary
    (fetch from the compressed half of the slice's start voffset). The
    ctypes call releases the GIL, so scan workers inflate in parallel."""
    if n_threads is None:
        import os

        n_threads = min(8, os.cpu_count() or 1)
    lib = get_lib()
    if lib is None:
        raise NativeUnavailable("native library not built")
    if not hasattr(lib, "sbn_inflate_buffer"):
        raise NativeUnavailable("sbn_inflate_buffer missing (stale library)")
    import numpy as np

    # zero-copy in: the C side only reads the blob
    view = np.frombuffer(data or b"\0", dtype=np.uint8)
    out_p = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_uint64()
    rc = lib.sbn_inflate_buffer(
        view.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(data),
        vstart,
        2**64 - 1 if vend is None else vend,
        n_threads,
        ctypes.byref(out_p),
        ctypes.byref(out_len),
    )
    if rc != 0:
        raise NativeUnavailable(f"sbn_inflate_buffer failed rc={rc}")
    return _take_buffer(lib, out_p, out_len)


def compress_bgzf(data: bytes, level: int = 6) -> bytes:
    """Full BGZF stream (blocks + EOF marker) for the given payload."""
    lib = get_lib()
    if lib is None:
        raise NativeUnavailable("native library not built")
    out_p = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_uint64()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data else None
    rc = lib.sbn_compress_bgzf(
        buf, len(data), level, ctypes.byref(out_p), ctypes.byref(out_len)
    )
    if rc != 0:
        raise NativeUnavailable(f"sbn_compress_bgzf failed rc={rc}")
    return _take_buffer(lib, out_p, out_len)


def pack_records(
    pos, refs: list[bytes], alts: list[bytes], *, level: int = 9
) -> bytes:
    """Gzip blob of (pos, packed ref'_'alt) records — the reference
    writeDataToS3 on-S3 index format (write_data_to_s3.h:30-228).

    List form: joins the per-row bytes and delegates to the columnar
    ``pack_records_arrays`` (one FFI call site)."""
    import numpy as np

    n = len(refs)
    pos_a = np.ascontiguousarray(pos, dtype=np.uint64)
    if pos_a.shape != (n,) or len(alts) != n:
        raise ValueError("pos/refs/alts length mismatch")

    def runs(items):
        cum = np.cumsum([len(b) for b in items], dtype=np.uint64)
        offs = np.zeros(n + 1, dtype=np.uint64)
        offs[1:] = cum
        return np.frombuffer(b"".join(items), dtype=np.uint8), offs

    ref_blob, ref_offs = runs(refs)
    alt_blob, alt_offs = runs(alts)
    return pack_records_arrays(
        pos_a, ref_blob, ref_offs, alt_blob, alt_offs, level=level
    )


def unpack_records(
    blob: bytes,
    range_start: int = 0,
    range_end: int = 2**63 - 1,
):
    """(pos: uint64 ndarray, payloads: list[bytes]) for records in
    [range_start, range_end] — the ReadVcfData range-filtered read
    (readVcfData.cpp:3-38). Payloads are the packed ref'_'alt keys the
    reference dedupes on."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        raise NativeUnavailable("native library not built")
    out_pos = ctypes.POINTER(ctypes.c_uint64)()
    out_payload = ctypes.POINTER(ctypes.c_uint8)()
    out_offs = ctypes.POINTER(ctypes.c_uint32)()
    buf = (
        (ctypes.c_uint8 * len(blob)).from_buffer_copy(blob)
        if blob
        else (ctypes.c_uint8 * 1)()
    )
    n = lib.sbn_unpack_records(
        buf,
        len(blob),
        range_start,
        range_end,
        ctypes.byref(out_pos),
        ctypes.byref(out_payload),
        ctypes.byref(out_offs),
    )
    if n < 0:
        raise NativeUnavailable(f"sbn_unpack_records failed rc={n}")
    try:
        pos = np.ctypeslib.as_array(out_pos, shape=(n,)).copy()
        offs = np.ctypeslib.as_array(out_offs, shape=(n + 1,)).copy()
        payload = (
            ctypes.string_at(out_payload, int(offs[-1])) if n else b""
        )
    finally:
        lib.sbn_free(ctypes.cast(out_pos, ctypes.POINTER(ctypes.c_uint8)))
        lib.sbn_free(out_payload)
        lib.sbn_free(ctypes.cast(out_offs, ctypes.POINTER(ctypes.c_uint8)))
    return pos, [
        payload[offs[i] : offs[i + 1]] for i in range(n)
    ]


def unpack_seq(packed: bytes) -> bytes | None:
    """Sequence text for a packed payload half; None when it was stored
    raw (symbolic allele passthrough)."""
    lib = get_lib()
    if lib is None:
        raise NativeUnavailable("native library not built")
    cap = max(2 * len(packed), 1)
    out = (ctypes.c_uint8 * cap)()
    buf = (
        (ctypes.c_uint8 * len(packed)).from_buffer_copy(packed)
        if packed
        else (ctypes.c_uint8 * 1)()
    )
    n = lib.sbn_unpack_seq(buf, len(packed), out, cap)
    if n == -1:
        return None
    if n < 0:
        raise NativeUnavailable(f"sbn_unpack_seq failed rc={n}")
    return bytes(out[:n])


def gt_planes(
    gt_blob: bytes,
    gt_off,
    n_rec: int,
    n_samples: int,
    row_rec,
    row_allele,
    words: int,
):
    """(gt1, gt2, tok1, tok2, gt_overflow, tok_overflow) — the genotype
    bit planes for all index rows in one native pass (the per-(row,
    sample) hot loop of build_index). Arrays are uint32[n_rows, words];
    overflows are int64[k, 3] (row, sample, exact value)."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        raise NativeUnavailable("native library not built")
    gt_off = np.ascontiguousarray(gt_off, dtype=np.uint64)
    row_rec = np.ascontiguousarray(row_rec, dtype=np.int32)
    row_allele = np.ascontiguousarray(row_allele, dtype=np.int32)
    n_rows = len(row_rec)
    planes = [
        np.zeros((n_rows, words), dtype=np.uint32) for _ in range(4)
    ]
    # zero-copy: the C side only reads the blob; keep the buffer object
    # referenced (blob_view) for the duration of the call. Accepts bytes
    # or a uint8 ndarray (the tokenizer's gt_blob output) without copying.
    if isinstance(gt_blob, np.ndarray):
        blob_view = (
            np.ascontiguousarray(gt_blob, dtype=np.uint8)
            if len(gt_blob)
            else np.zeros(1, np.uint8)
        )
    else:
        blob_view = np.frombuffer(gt_blob or b"\0", dtype=np.uint8)
    u32 = ctypes.POINTER(ctypes.c_uint32)
    u64 = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    gt_over_p = i64p()
    tok_over_p = i64p()
    n_gt = ctypes.c_uint64()
    n_tok = ctypes.c_uint64()
    rc = lib.sbn_gt_planes(
        blob_view.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        gt_off.ctypes.data_as(u64),
        n_rec,
        n_samples,
        row_rec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        row_allele.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_rows,
        words,
        *[p.ctypes.data_as(u32) for p in planes],
        ctypes.byref(gt_over_p),
        ctypes.byref(n_gt),
        ctypes.byref(tok_over_p),
        ctypes.byref(n_tok),
    )
    if rc < 0:
        raise NativeUnavailable(f"sbn_gt_planes failed rc={rc}")
    try:
        gt_over = (
            np.ctypeslib.as_array(gt_over_p, shape=(int(n_gt.value), 3))
            .copy()
            .astype(np.int64)
            if n_gt.value
            else np.zeros((0, 3), np.int64)
        )
        tok_over = (
            np.ctypeslib.as_array(tok_over_p, shape=(int(n_tok.value), 3))
            .copy()
            .astype(np.int64)
            if n_tok.value
            else np.zeros((0, 3), np.int64)
        )
    finally:
        lib.sbn_free(ctypes.cast(gt_over_p, ctypes.POINTER(ctypes.c_uint8)))
        lib.sbn_free(ctypes.cast(tok_over_p, ctypes.POINTER(ctypes.c_uint8)))
    return planes[0], planes[1], planes[2], planes[3], gt_over, tok_over


def count_slice(text: bytes) -> tuple[int, int, int]:
    """(num_variants, num_calls, num_records) over VCF body text — the
    reference addCounts semantics (AC= commas / AN= value)."""
    lib = get_lib()
    if lib is None:
        raise NativeUnavailable("native library not built")
    buf = (ctypes.c_uint8 * len(text)).from_buffer_copy(text) if text else None
    nv = ctypes.c_int64()
    nc = ctypes.c_int64()
    nr = ctypes.c_int64()
    rc = lib.sbn_count_slice(
        buf, len(text), ctypes.byref(nv), ctypes.byref(nc), ctypes.byref(nr)
    )
    if rc != 0:
        raise NativeUnavailable(f"sbn_count_slice failed rc={rc}")
    return nv.value, nc.value, nr.value


def tokenize(text: bytes, n_samples: int) -> dict:
    """One native pass over VCF body text -> flat record/field arrays.

    The columnar fast path's front end (tokenize.cpp): per-record
    positions and field spans (byte offsets into ``text``), per-alt
    spans, INFO AC/AN/VT, genotype-derived allele/token tallies, and
    normalised per-sample GT cells ready for ``gt_planes``. Dict keys
    mirror the C out-params; span arrays index into the ``text`` the
    caller passed (keep it alive)."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        raise NativeUnavailable("native library not built")
    if not hasattr(lib, "sbn_tokenize"):
        raise NativeUnavailable("sbn_tokenize missing (stale library)")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    outs = {
        "pos": i64p(),
        "chrom_off": u32p(), "chrom_len": u32p(),
        "ref_off": u32p(), "ref_len": u32p(),
        "vt_off": u32p(), "vt_len": u32p(),
        "an": i64p(), "has_an": u8p(), "has_ac": u8p(),
        "tok_total": i64p(),
        "alt_off": u32p(), "alt_len": u32p(), "alt_start": u64p(),
        "ac_gt": i64p(),
        "ac": i64p(), "ac_start": u64p(),
        "gt_blob": u8p(), "gt_off": u64p(),
    }
    n_rec = ctypes.c_uint64()
    n_alt = ctypes.c_uint64()
    n_ac = ctypes.c_uint64()
    gt_blob_len = ctypes.c_uint64()
    text_view = np.frombuffer(text or b"\0", dtype=np.uint8)
    rc = lib.sbn_tokenize(
        text_view.ctypes.data_as(u8p),
        len(text),
        n_samples,
        *[ctypes.byref(v) for v in outs.values()],
        ctypes.byref(n_rec),
        ctypes.byref(n_alt),
        ctypes.byref(n_ac),
        ctypes.byref(gt_blob_len),
    )
    if rc != 0:
        raise NativeUnavailable(f"sbn_tokenize failed rc={rc}")
    nr, na, nac = n_rec.value, n_alt.value, n_ac.value
    shapes = {
        "pos": nr, "chrom_off": nr, "chrom_len": nr,
        "ref_off": nr, "ref_len": nr, "vt_off": nr, "vt_len": nr,
        "an": nr, "has_an": nr, "has_ac": nr, "tok_total": nr,
        "alt_off": na, "alt_len": na, "alt_start": nr + 1,
        "ac_gt": na, "ac": nac, "ac_start": nr + 1,
        "gt_blob": gt_blob_len.value,
        "gt_off": nr * n_samples + 1,
    }
    try:
        result = {
            k: (
                np.ctypeslib.as_array(v, shape=(shapes[k],)).copy()
                if shapes[k]
                else np.zeros(0, dtype=np.ctypeslib.as_array(v, shape=(1,)).dtype)
            )
            for k, v in outs.items()
        }
    finally:
        for v in outs.values():
            lib.sbn_free(ctypes.cast(v, u8p))
    result["n_rec"] = nr
    result["n_alt"] = na
    return result


def tokenize_planes(text: bytes, n_samples: int, words: int) -> dict:
    """Fused single native pass: tokenizer arrays + genotype bit planes.

    Same record/field outputs as :func:`tokenize` (minus the normalised
    GT blob, which no longer exists) plus ``g1``/``g2`` uint32
    [n_alt, words] planes in TEXT alt order, ``t1``/``t2`` uint32
    [n_rec, words] per-record token planes, and overflow triples
    ``gt_over`` (flat_alt, sample, copies) / ``tok_over`` (rec, sample,
    ntok). One scan of the input instead of tokenize + gt_planes' two —
    the per-core ingest hot path."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        raise NativeUnavailable("native library not built")
    if not hasattr(lib, "sbn_tokenize_planes"):
        raise NativeUnavailable("sbn_tokenize_planes missing (stale library)")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    outs = {
        "pos": i64p(),
        "chrom_off": u32p(), "chrom_len": u32p(),
        "ref_off": u32p(), "ref_len": u32p(),
        "vt_off": u32p(), "vt_len": u32p(),
        "an": i64p(), "has_an": u8p(), "has_ac": u8p(),
        "tok_total": i64p(),
        "alt_off": u32p(), "alt_len": u32p(), "alt_start": u64p(),
        "ac_gt": i64p(),
        "ac": i64p(), "ac_start": u64p(),
        "g1": u32p(), "g2": u32p(), "t1": u32p(), "t2": u32p(),
        "gt_over": i64p(),
    }
    n_gt_over = ctypes.c_uint64()
    tok_over_p = i64p()
    n_tok_over = ctypes.c_uint64()
    n_rec = ctypes.c_uint64()
    n_alt = ctypes.c_uint64()
    n_ac = ctypes.c_uint64()
    text_view = np.frombuffer(text or b"\0", dtype=np.uint8)
    vals = list(outs.values())
    rc = lib.sbn_tokenize_planes(
        text_view.ctypes.data_as(u8p),
        len(text),
        n_samples,
        words,
        *[ctypes.byref(v) for v in vals[:-1]],
        ctypes.byref(vals[-1]),
        ctypes.byref(n_gt_over),
        ctypes.byref(tok_over_p),
        ctypes.byref(n_tok_over),
        ctypes.byref(n_rec),
        ctypes.byref(n_alt),
        ctypes.byref(n_ac),
    )
    if rc != 0:
        raise NativeUnavailable(f"sbn_tokenize_planes failed rc={rc}")
    nr, na, nac = n_rec.value, n_alt.value, n_ac.value
    shapes = {
        "pos": nr, "chrom_off": nr, "chrom_len": nr,
        "ref_off": nr, "ref_len": nr, "vt_off": nr, "vt_len": nr,
        "an": nr, "has_an": nr, "has_ac": nr, "tok_total": nr,
        "alt_off": na, "alt_len": na, "alt_start": nr + 1,
        "ac_gt": na, "ac": nac, "ac_start": nr + 1,
        "g1": na * words, "g2": na * words,
        "t1": nr * words, "t2": nr * words,
        "gt_over": n_gt_over.value * 3,
    }
    import weakref

    planes = {"g1", "g2", "t1", "t2"}
    result = {}
    finalized = set()  # plane keys whose buffer a finalizer now owns
    try:
        for k, v in outs.items():
            if not shapes[k]:
                result[k] = np.zeros(
                    0, dtype=np.ctypeslib.as_array(v, shape=(1,)).dtype
                )
                continue
            arr = np.ctypeslib.as_array(v, shape=(shapes[k],))
            if k in planes:
                # the planes are the bulk of the output: wrap the C
                # buffer zero-copy and free it when the LAST view dies
                # (views keep the base array — and thus the finalizer —
                # alive); everything else is small enough to copy out
                weakref.finalize(
                    arr, lib.sbn_free, ctypes.cast(v, u8p)
                )
                finalized.add(k)
                result[k] = arr
            else:
                result[k] = arr.copy()
        nt = n_tok_over.value * 3
        result["tok_over"] = (
            np.ctypeslib.as_array(tok_over_p, shape=(nt,)).copy()
            if nt
            else np.zeros(0, np.int64)
        )
    finally:
        for k, v in outs.items():
            if k in finalized:
                continue  # freed by the finalizer above
            lib.sbn_free(ctypes.cast(v, u8p))
        lib.sbn_free(ctypes.cast(tok_over_p, u8p))
    for k in ("g1", "g2"):
        result[k] = result[k].view(np.uint32).reshape(na, words)
    for k in ("t1", "t2"):
        result[k] = result[k].view(np.uint32).reshape(nr, words)
    result["gt_over"] = result["gt_over"].reshape(-1, 3)
    result["tok_over"] = result["tok_over"].reshape(-1, 3)
    result["n_rec"] = nr
    result["n_alt"] = na
    return result


def pack_records_arrays(
    pos, ref_blob, ref_offs, alt_blob, alt_offs, *, level: int = 6
) -> bytes:
    """pack_records over columnar inputs (uint8 blobs + uint32 offsets) —
    the export path's zero-copy form: shard blobs slice straight in, no
    per-row python bytes objects."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        raise NativeUnavailable("native library not built")
    pos_a = np.ascontiguousarray(pos, dtype=np.uint64)
    ref_b = np.ascontiguousarray(ref_blob, dtype=np.uint8)
    alt_b = np.ascontiguousarray(alt_blob, dtype=np.uint8)
    n = len(pos_a)
    # validate BEFORE the uint32 cast: silent modular wrap of >=2^32
    # offsets (or offsets outside the blob) would hand the C side an
    # out-of-bounds read and a silently corrupt blob
    for name, offs, blob in (
        ("ref", ref_offs, ref_b),
        ("alt", alt_offs, alt_b),
    ):
        offs = np.asarray(offs)
        if len(offs) != n + 1:
            raise ValueError(f"{name} offsets must have n+1 entries")
        if len(offs) and int(offs[-1]) >= 2**32:
            raise ValueError("total allele bytes exceed u32 offset space")
        if len(offs) and (
            int(offs[0]) != 0
            or int(offs[-1]) != len(blob)
            or (np.diff(offs) < 0).any()
        ):
            raise ValueError(f"{name} offsets malformed for blob")
    ref_o = np.ascontiguousarray(ref_offs, dtype=np.uint32)
    alt_o = np.ascontiguousarray(alt_offs, dtype=np.uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    out_p = u8p()
    out_len = ctypes.c_uint64()
    # keep 1-byte dummies for empty blobs (NULL data pointers otherwise)
    ref_mem = ref_b if len(ref_b) else np.zeros(1, np.uint8)
    alt_mem = alt_b if len(alt_b) else np.zeros(1, np.uint8)
    rc = lib.sbn_pack_records(
        n,
        pos_a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ref_mem.ctypes.data_as(u8p),
        ref_o.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        alt_mem.ctypes.data_as(u8p),
        alt_o.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        level,
        ctypes.byref(out_p),
        ctypes.byref(out_len),
    )
    if rc == 3:
        raise ValueError("allele too long for u16 record length")
    if rc != 0:
        raise NativeUnavailable(f"sbn_pack_records failed rc={rc}")
    return _take_buffer(lib, out_p, out_len)
