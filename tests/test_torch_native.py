"""The port's native library against the JAX package's and against the
pure-Python paths, at tolerance 0: every ctypes entry point
(``inflate_range``, ``inflate_buffer``, ``compress_bgzf``,
``pack_records``/``unpack_records``/``unpack_seq``,
``pack_records_arrays``, ``gt_planes``, ``count_slice``, ``tokenize``,
``tokenize_planes``), ``build_index_from_text`` against
``parse_record`` + ``build_index`` (the reference's own rule) and
against JAX's, and the port's build: into ``build/native/`` under a file
lock, named by a hash of the sources, and against the zlib shim header.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gzip
import random
import subprocess
import threading

import numpy as np
import pytest

from sbeacon_tpu import native as jn
from sbeacon_tpu.genomics.vcf import parse_record as j_parse_record
from sbeacon_tpu.index import columnar as jc
from sbeacon_tpu.index import portable as jp
from sbeacon_tpu.testing import random_records as j_random_records
from sbeacon_tpu_torch import native as tn
from sbeacon_tpu_torch.genomics.bgzf import (
    BgzfReader,
    BgzfWriter,
    compress_block,
    make_virtual_offset,
    scan_blocks,
)
from sbeacon_tpu_torch.genomics.vcf import VcfRecord, parse_record, write_vcf
from sbeacon_tpu_torch.index import columnar as tc
from sbeacon_tpu_torch.index import portable as tp
from sbeacon_tpu_torch.testing import random_records, range_server
from torch_ingest_corpus import assert_shards_equal, no_thread_leak  # noqa: F401


def test_library_builds_under_build_native():
    assert tn.available() and jn.available()
    path = tn.build()
    assert path.parent == tn.BUILD_DIR
    assert tn.BUILD_DIR.parts[-2:] == ("build", "native")
    assert path.name.startswith("_sbnative-") and path.suffix == ".so"
    # the sources are copies of the JAX package's
    from pathlib import Path

    jsrc = Path(jn.__file__).parent / "src"
    tsrc = Path(tn.__file__).parent / "src"
    assert sorted(p.name for p in tsrc.iterdir()) == sorted(
        p.name for p in jsrc.iterdir())
    for p in jsrc.iterdir():
        assert (tsrc / p.name).read_bytes() == p.read_bytes(), p.name


def test_concurrent_builds_share_one_library(tmp_path, monkeypatch):
    """Builds racing in one directory (the tests' xdist workers) all
    return the same library through the lock and leave no temp file."""
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "native")
    out, errs = [], []

    def one():
        try:
            out.append(tn.build())
        except Exception as e:  # pragma: no cover - reported below
            errs.append(e)

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errs and len(set(out)) == 1
    names = sorted(p.name for p in (tmp_path / "native").iterdir())
    assert names == [".build.lock", out[0].name]
    lib = ctypes.CDLL(str(out[0]))
    assert hasattr(lib, "sbn_tokenize_planes")


def test_zlib_shim_header_builds_an_equal_codec(tmp_path):
    """The sources compiled against ``zlib_shim/zlib.h`` in place of the
    system header (linked to the runtime Python's zlib loaded) give
    the same BGZF bytes and inflate."""
    so = tmp_path / "shim.so"
    cmd = ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-I", str(tn._SHIM),
           *[str(tn._SRC / s) for s in tn._SOURCES], *tn._zlib_link(),
           "-o", str(so)]
    subprocess.run(cmd, check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    data = b"".join(f"{i}\tshim\n".encode() for i in range(30_000))
    out_p = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_uint64()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    rc = lib.sbn_compress_bgzf(buf, ctypes.c_uint64(len(data)), 6,
                               ctypes.byref(out_p), ctypes.byref(out_len))
    assert rc == 0
    blob = ctypes.string_at(out_p, out_len.value)
    assert blob == tn.compress_bgzf(data)
    assert gzip.decompress(blob) == data


@pytest.fixture(scope="module")
def vcf(tmp_path_factory):
    root = tmp_path_factory.mktemp("tnative")
    rng = random.Random(4)
    recs = []
    for c in ("1", "2"):
        recs.extend(random_records(rng, chrom=c, n=1500, n_samples=6))
    path = root / "n.vcf.gz"
    write_vcf(path, recs, sample_names=[f"S{i}" for i in range(6)])
    return path, recs


def _cases(path):
    blocks = scan_blocks(path)
    return [
        (0, None),
        (make_virtual_offset(blocks[0][0], 10),
         make_virtual_offset(blocks[1][0], 0)),
        (make_virtual_offset(blocks[1][0], 5),
         make_virtual_offset(blocks[2][0], 99)),
        (make_virtual_offset(blocks[2][0], 5),
         make_virtual_offset(blocks[-1][0] + (1 << 16), 0)),
    ]


@pytest.mark.parametrize("threads", [1, 4])
def test_inflate_range_equal(vcf, threads):
    path, _ = vcf
    reader = BgzfReader(path)
    for vs, ve in _cases(path):
        got = tn.inflate_range(path, vs, ve, n_threads=threads)
        assert got == jn.inflate_range(path, vs, ve, n_threads=threads)
        want = (reader.read_all() if ve is None
                else reader.read_range(vs, ve))
        assert got == want


@pytest.mark.parametrize("threads", [1, 3])
def test_inflate_buffer_equal(vcf, threads):
    path, _ = vcf
    blob = path.read_bytes()
    reader = BgzfReader(path)
    for vs, ve in _cases(path)[1:]:
        got = tn.inflate_buffer(blob, vs, ve, n_threads=threads)
        assert got == jn.inflate_buffer(blob, vs, ve, n_threads=threads)
        assert got == reader.read_range(vs, ve)


@pytest.mark.parametrize("n", [0, 1, 65280, 65281, 300_000])
@pytest.mark.parametrize("level", [1, 6])
def test_compress_bgzf_equal(tmp_path, n, level):
    data = bytes(random.Random(n).randrange(97, 123) for _ in range(n))
    blob = tn.compress_bgzf(data, level=level)
    assert blob == jn.compress_bgzf(data, level=level)
    p = tmp_path / "x.gz"
    p.write_bytes(blob)
    assert BgzfReader(p).read_all() == data
    assert blob.endswith(bytes.fromhex(
        "1f8b08040000000000ff0600424302001b0003000000000000000000"))
    if 0 < n <= 65280:  # one block: the pure-Python writer's bytes
        w = tmp_path / "w.gz"
        with BgzfWriter(w, level=level) as bw:
            bw.write(data)
        assert compress_block(data, level=level) == blob[:-28]


def test_count_slice_equal(vcf):
    path, recs = vcf
    text = BgzfReader(path).read_all()
    got = tn.count_slice(text)
    assert got == jn.count_slice(text)
    assert got == (sum(len(r.ac) for r in recs if r.ac is not None),
                   sum(r.an for r in recs if r.an is not None), len(recs))
    edge = (b"##h\n#CHROM\tPOS\n1\t100\t.\tA\tT,G\t.\tPASS\tAC=5,7;AN=20\n"
            b"1\t200\t.\tC\tG\t.\tPASS\tDP=3\n"
            b"1\t300\t.\tG\tA\t.\tPASS\tAN=8;AC=2")
    assert tn.count_slice(edge) == jn.count_slice(edge) == (3, 28, 3)


def _alleles(rng, n):
    seqs = ["A", "ACGT", "N", "<DEL>", "<DUP:TANDEM>", "GATTACA" * 3, "",
            "acgt", "AC*", "T"]
    return ([rng.choice(seqs).encode() for _ in range(n)],
            [rng.choice(seqs).encode() for _ in range(n)])


@pytest.mark.parametrize("n", [0, 1, 500])
def test_record_codec_native_python_and_jax_equal(n):
    rng = random.Random(n)
    pos = np.sort(np.array([rng.randrange(1, 10**9) for _ in range(n)],
                           dtype=np.uint64))
    refs, alts = _alleles(rng, n)
    blob = tn.pack_records(pos, refs, alts)
    assert blob == jn.pack_records(pos, refs, alts)
    assert blob == tp.pack_records_py(pos, refs, alts)
    lo, hi = (int(pos[n // 4]), int(pos[3 * n // 4])) if n else (0, 10)
    for rs, re_ in ((0, 2**63 - 1), (lo, hi)):
        pt, lt = tn.unpack_records(blob, rs, re_)
        pj, lj = jn.unpack_records(blob, rs, re_)
        pp, lp = tp.unpack_records_py(blob, rs, re_)
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(pt, pp)
        assert lt == lj == lp
    for payload in {b"", b"\x12", b"\x12\x30", b"\x01", b"DEL", b"\x77\x07"}:
        assert tn.unpack_seq(payload) == jn.unpack_seq(payload)
        assert tn.unpack_seq(payload) == tp.unpack_seq(payload)


def test_pack_records_arrays_equals_list_form():
    rng = random.Random(9)
    n = 300
    pos = np.arange(1, n + 1, dtype=np.uint64) * 7
    refs, alts = _alleles(rng, n)

    def runs(items):
        offs = np.zeros(n + 1, dtype=np.uint64)
        offs[1:] = np.cumsum([len(b) for b in items])
        return np.frombuffer(b"".join(items) or b"\0", np.uint8)[
            :int(offs[-1])], offs

    rb, ro = runs(refs)
    ab, ao = runs(alts)
    got = tn.pack_records_arrays(pos, rb, ro, ab, ao, level=9)
    assert got == jn.pack_records_arrays(pos, rb, ro, ab, ao, level=9)
    assert got == tn.pack_records(pos, refs, alts)


def _records(seed, n_samples):
    rng = random.Random(seed)
    recs = j_random_records(rng, chrom="4", n=300, n_samples=n_samples,
                            p_no_acan=0.5, p_multiallelic=0.4,
                            p_symbolic=0.1)
    for r in recs[::7]:  # polyploid, missing and odd genotypes
        if r.genotypes:
            r.genotypes[0] = "1/1/1"
            r.genotypes[-1] = "."
    return [VcfRecord(**dataclasses.asdict(r)) for r in recs]


@pytest.mark.parametrize("n_samples", [1, 9, 33])
def test_gt_planes_native_python_and_jax_equal(monkeypatch, n_samples):
    recs = _records(n_samples, n_samples)
    names = [f"S{i}" for i in range(n_samples)]
    native_shard = tc.build_index(recs, dataset_id="n", vcf_location="v",
                                  sample_names=names)
    j_shard = jc.build_index(recs, dataset_id="n", vcf_location="v",
                             sample_names=names)
    assert_shards_equal(native_shard, j_shard)
    monkeypatch.setattr(tn, "available", lambda: False)
    py_shard = tc.build_index(recs, dataset_id="n", vcf_location="v",
                              sample_names=names)
    for attr in ("gt_bits", "gt_bits2", "tok_bits1", "tok_bits2"):
        np.testing.assert_array_equal(getattr(native_shard, attr),
                                      getattr(py_shard, attr), attr)
    for attr in ("gt_overflow", "tok_overflow"):
        assert sorted(map(tuple, getattr(native_shard, attr).tolist())) == \
            sorted(map(tuple, getattr(py_shard, attr).tolist())), attr


def test_gt_planes_entry_point_equal():
    recs = _records(5, 6)
    n, s = len(recs), 6
    parts, offs = [], np.zeros(n * s + 1, dtype=np.uint64)
    k = total = 0
    for r in recs:
        gts = list(r.genotypes[:s]) + [""] * (s - len(r.genotypes[:s]))
        for g in gts:
            parts.append(g.encode())
            total += len(g)
            k += 1
            offs[k] = total
    row_rec = np.repeat(np.arange(n, dtype=np.int32), 2)
    row_allele = np.tile(np.array([1, 2], dtype=np.int32), n)
    a = tn.gt_planes(b"".join(parts), offs, n, s, row_rec, row_allele, 1)
    b = jn.gt_planes(b"".join(parts), offs, n, s, row_rec, row_allele, 1)
    assert len(a) == len(b) == 6
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _text_of(records, sample_names):
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
             + ("\tFORMAT\t" + "\t".join(sample_names)
                if sample_names else "")]
    for r in records:
        info = []
        if r.ac is not None:
            info.append("AC=" + ",".join(map(str, r.ac)))
        if r.an is not None:
            info.append(f"AN={r.an}")
        if r.vt != "N/A":
            info.append(f"VT={r.vt}")
        line = (f"{r.chrom}\t{r.pos}\t.\t{r.ref}\t{','.join(r.alts)}\t.\t.\t"
                + (";".join(info) or "."))
        if sample_names:
            gts = list(r.genotypes[: len(sample_names)])
            gts += ["./."] * (len(sample_names) - len(gts))
            line += "\tGT\t" + "\t".join(gts)
        lines.append(line)
    return ("\n".join(lines) + "\n").encode()


EDGE_TEXT = b"\n".join([
    b"##meta",
    b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tA\tB",
    b"1\t100\t.\tA\tG\t.\t.\tAC=1;AN=4\tGT\t0|1\t0|0",
    b"1\t101\t.\tA\tG\t.\t.",
    b"1\t102\t.\tC\tT\t.\t.\tAC=2;AN=4\tDP\t12\t13",
    b"1\t103\t.\tG\tA,T\t.\t.\tAN=4\tDP:GT\t9:1|2\t7:0/1",
    b"1\t104\t.\tT\tC\t.\t.\t.\tDP:GT\t5\t3:1|1",
    b"1\t105\t.\tA\tG\t.\t.\tAC=x;AN=4\tGT\t1/1\t0|1",
    b"1\t106\t.\tA\tG\t.\t.\tAC=1;AN=zz\tGT\t1|0\t.|.",
    b"1\t107\t.\tA\tG,C\t.\t.\tAC=9,9;AN=8;AC=1,2\tGT\t1|2\t2|2",
    b"1\t108\t.\tA\t<DEL>,<DUP:TANDEM>\t.\t.\tAC=1,1;AN=4;VT=SV\tGT\t0|1\t0|2",
    b"GL000225.1\t50\t.\tA\tG\t.\t.\tAC=1;AN=2\tGT\t1\t0",
    b"2\t200\t.\tA\tG\t.\t.\t.\tGT\t1\t.",
    b"2\t201\t.\tC\tA\t.\t.\tAN=5\tGT\t0|1\t1|1\t0|0",
    b"2\t202\t.\tG\tT\t.\t.\tAC=2;AN=4\tGT\t1|1\t0.5",
])


def _texts():
    out = [("edge", EDGE_TEXT, ["A", "B"]),
           ("edge-no-newline", EDGE_TEXT.rstrip(b"\n"), ["A", "B"]),
           ("no-samples", b"#h\n1\t10\t.\tA\tG\t.\t.\tAC=1;AN=2\n", []),
           ("headers-only", b"##only\n#headers\n", ["A"]),
           ("crlf", b"#h\r\n1\t10\t.\tA\tG\t.\t.\tAC=1;AN=2\tGT\t0|1\r\n",
            ["A"])]
    for seed in range(4):
        rng = random.Random(seed)
        names = [f"S{i}" for i in range(rng.choice([0, 1, 3, 40]))]
        recs = []
        for chrom in ("1", "22", "X", "weird_contig"):
            recs += j_random_records(rng, chrom=chrom,
                                     n=rng.randint(30, 150),
                                     n_samples=len(names), p_symbolic=0.2,
                                     p_multiallelic=0.3, p_no_acan=0.4)
        rng.shuffle(recs)
        out.append((f"random-{seed}", _text_of(recs, names), names))
    return out


@pytest.mark.parametrize("case", _texts(), ids=lambda c: c[0])
def test_build_index_from_text_bit_identical(case):
    _name, text, names = case
    recs = [r for r in (parse_record(line)
                        for line in text.decode().split("\n"))
            if r is not None]
    slow = tc.build_index(recs, dataset_id="d", vcf_location="v",
                          sample_names=names)
    fast = tc.build_index_from_text(text, dataset_id="d", vcf_location="v",
                                    sample_names=names)
    assert_shards_equal(slow, fast)
    jfast = jc.build_index_from_text(text, dataset_id="d", vcf_location="v",
                                     sample_names=names)
    assert_shards_equal(fast, jfast)
    jrecs = [r for r in (j_parse_record(line)
                         for line in text.decode().split("\n"))
             if r is not None]
    assert [dataclasses.asdict(r) for r in recs] == [
        dataclasses.asdict(r) for r in jrecs]


@pytest.mark.parametrize("n_samples", [0, 7, 70])
def test_tokenize_and_tokenize_planes_equal(n_samples):
    rng = random.Random(n_samples + 11)
    names = [f"S{i}" for i in range(n_samples)]
    recs = j_random_records(rng, chrom="5", n=200, n_samples=n_samples,
                            p_multiallelic=0.3, p_symbolic=0.1,
                            p_no_acan=0.4)
    text = _text_of(recs, names)
    a, b = tn.tokenize(text, n_samples), jn.tokenize(text, n_samples)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    words = max(1, (n_samples + 31) // 32)
    a = tn.tokenize_planes(text, n_samples, words)
    b = jn.tokenize_planes(text, n_samples, words)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    at = tn.get_lib().sbn_tokenize_planes.argtypes
    assert at[1] is at[2] is at[3] is ctypes.c_uint64


def test_ac_arity_mismatch_refused_and_overflow_absent():
    text = b"#h\n1\t10\t.\tA\tG,C\t.\t.\tAC=1;AN=2\tGT\t0|1\n"
    with pytest.raises(ValueError, match="arity"):
        tc.build_index_from_text(text, sample_names=["A"])
    text = (b"#h\n1\t10\t.\tA\tG\t.\t.\t"
            b"AC=1;AN=99999999999999999999\tGT\t0|1\n")
    fast = tc.build_index_from_text(text, sample_names=["A"])
    assert int(fast.cols["an"][0]) == 2
    assert_shards_equal(fast, jc.build_index_from_text(
        text, sample_names=["A"]))


def test_unfused_tokenizer_matches_fused(monkeypatch):
    rng = random.Random(31)
    recs = j_random_records(rng, chrom="5", n=300, n_samples=7,
                            p_multiallelic=0.3, p_symbolic=0.1,
                            p_no_acan=0.4)
    for rec in recs[::9]:
        rec.genotypes[rng.randrange(7)] = "0/1/1/1"
        rec.ac = rec.an = None
    names = [f"S{i}" for i in range(7)]
    text = _text_of(recs, names)
    fused = tc.build_index_from_text(text, dataset_id="f",
                                     sample_names=names)

    def unavailable(*a, **k):
        raise tn.NativeUnavailable("forced fallback")

    monkeypatch.setattr(tn, "tokenize_planes", unavailable)
    unfused = tc.build_index_from_text(text, dataset_id="f",
                                       sample_names=names)
    for k in fused.cols:
        np.testing.assert_array_equal(fused.cols[k], unfused.cols[k], k)
    for attr in ("gt_bits", "gt_bits2", "tok_bits1", "tok_bits2"):
        np.testing.assert_array_equal(getattr(fused, attr),
                                      getattr(unfused, attr), attr)
    for attr in ("gt_overflow", "tok_overflow"):
        assert {tuple(r) for r in getattr(fused, attr).tolist()} == {
            tuple(r) for r in getattr(unfused, attr).tolist()}, attr


@pytest.mark.parametrize("kind", ["multiallelic", "symbolic"])
def test_native_slice_text_local_and_remote(tmp_path, kind):
    from sbeacon_tpu.ingest.pipeline import native_slice_text as j_slice
    from sbeacon_tpu_torch.ingest.pipeline import native_slice_text

    rng = random.Random(80)
    recs = random_records(rng, chrom="9", n=6000, n_samples=4,
                          p_multiallelic=0.7 if kind == "multiallelic"
                          else 0.1,
                          p_symbolic=0.6 if kind == "symbolic" else 0.0)
    path = tmp_path / f"{kind}.vcf.gz"
    write_vcf(path, recs, sample_names=[f"S{i}" for i in range(4)])
    reader = BgzfReader(path)
    with range_server(tmp_path) as base:
        url = f"{base}/{path.name}"
        for vs, ve in _cases(path)[1:]:
            want = reader.read_range(vs, ve)
            assert native_slice_text(path, vs, ve) == want
            assert native_slice_text(url, vs, ve) == want
            assert j_slice(url, vs, ve) == want


def test_prefer_native_io_kill_switch(monkeypatch):
    monkeypatch.setenv("BEACON_NATIVE_IO", "off")
    assert tn.prefer_native_io() is jn.prefer_native_io() is False
    monkeypatch.delenv("BEACON_NATIVE_IO")
    assert tn.prefer_native_io() == jn.prefer_native_io()
