"""The port's VCF readers and writers against the JAX package's, at
tolerance 0: BGZF blocks and virtual offsets, ``.tbi`` bytes and their
parse, VCF record parsing, region reads and ``write_vcf`` bytes, and
the port's ``write_cohort_vcf`` (the 1000-Genomes-shaped writer of the
chip smoke's ingest phase) read back by both packages.
"""

from __future__ import annotations

import dataclasses
import gzip
import random

import pytest

from sbeacon_tpu.genomics import bgzf as jb
from sbeacon_tpu.genomics import tabix as jt
from sbeacon_tpu.genomics import vcf as jv
from sbeacon_tpu.testing import make_test_vcf as j_make_test_vcf
from sbeacon_tpu.testing import random_records as j_random_records
from sbeacon_tpu_torch.genomics import bgzf as tb
from sbeacon_tpu_torch.genomics import tabix as tt
from sbeacon_tpu_torch.genomics import vcf as tv
from sbeacon_tpu_torch.testing import make_test_vcf, write_cohort_vcf
from torch_ingest_corpus import no_thread_leak  # noqa: F401


def _data(n, seed):
    rng = random.Random(seed)
    return b"".join(f"row{i}\t{rng.random()}\n".encode() for i in range(n))


@pytest.mark.parametrize("n", [0, 1, 5_000, 60_000])
@pytest.mark.parametrize("level", [0, 6, 9])
def test_bgzf_writer_bytes_equal(tmp_path, n, level):
    data = _data(n, n)
    pj, pt = tmp_path / "j.gz", tmp_path / "t.gz"
    with jb.BgzfWriter(pj, level=level) as w:
        w.write(data)
    with tb.BgzfWriter(pt, level=level) as w:
        w.write(data)
    assert pt.read_bytes() == pj.read_bytes()
    assert gzip.decompress(pt.read_bytes()) == data
    assert tb.scan_blocks(pt) == jb.scan_blocks(pj)
    assert tb.BgzfReader(pt).read_all() == data


@pytest.mark.parametrize("size", [1, 1000, 65280])
def test_compress_block_and_header(size):
    payload = bytes(random.Random(size).randrange(256) for _ in range(size))
    for level in (0, 6):
        blk = tb.compress_block(payload, level=level)
        assert blk == jb.compress_block(payload, level=level)
        assert tb.read_block_header(blk) == jb.read_block_header(blk)
        assert tb.decompress_block(blk) == jb.decompress_block(blk)
    assert tb.BGZF_EOF == jb.BGZF_EOF


@pytest.mark.parametrize("voff", [(0, 0), (1, 2), (65535, 65279),
                                  (2**40, 17), (2**47, 65535)])
def test_virtual_offsets(voff):
    v = tb.make_virtual_offset(*voff)
    assert v == jb.make_virtual_offset(*voff)
    assert tb.split_virtual_offset(v) == jb.split_virtual_offset(v) == voff


def test_reader_ranges_and_lines(tmp_path):
    data = _data(40_000, 3)
    p = tmp_path / "x.gz"
    with tb.BgzfWriter(p) as w:
        w.write(data)
    rt, rj = tb.BgzfReader(p), jb.BgzfReader(p)
    lines_t = list(rt.iter_lines())
    assert lines_t == list(rj.iter_lines())
    rng = random.Random(5)
    for _ in range(20):
        a, b = sorted(rng.sample(range(len(lines_t)), 2))
        va, vb = lines_t[a][0], lines_t[b][0]
        assert rt.read_range(va, vb) == rj.read_range(va, vb)
        assert list(rt.iter_lines(va, vb)) == list(rj.iter_lines(va, vb))


def test_corrupt_block_raises(tmp_path):
    p = tmp_path / "x.gz"
    with tb.BgzfWriter(p) as w:
        w.write(b"A" * 1000)
    raw = bytearray(p.read_bytes())
    raw[30] ^= 0xFF
    with pytest.raises(Exception):
        jb.decompress_block(bytes(raw), 0)
    with pytest.raises(Exception):
        tb.decompress_block(bytes(raw), 0)


@pytest.mark.parametrize("chroms,n,spacing", [
    (("1",), 300, 30), (("1", "2", "X"), 700, 200), (("22",), 2500, 9000),
])
def test_tbi_bytes_and_parse_equal(tmp_path, chroms, n, spacing):
    p = tmp_path / "t.vcf.gz"
    j_make_test_vcf(p, seed=n, chroms=chroms, n_per_chrom=n, spacing=spacing)
    it, ij = tt.build_tbi(p), jt.build_tbi(p)
    assert dataclasses.asdict(it) == dataclasses.asdict(ij)
    tt.write_tbi(it, tmp_path / "t.tbi")
    jt.write_tbi(ij, tmp_path / "j.tbi")
    assert (tmp_path / "t.tbi").read_bytes() == (tmp_path / "j.tbi").read_bytes()
    assert (dataclasses.asdict(tt.parse_tbi(tmp_path / "j.tbi"))
            == dataclasses.asdict(jt.parse_tbi(tmp_path / "t.tbi")))
    # ensure_index writes the sidecar the JAX package reads, and back
    got = tt.ensure_index(p)
    assert (p.parent / (p.name + ".tbi")).read_bytes() == (
        tmp_path / "j.tbi").read_bytes()
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jt.find_index_for(p))
    assert tt.list_chromosomes(p) == jt.list_chromosomes(p) == list(chroms)
    for c in chroms:
        assert it.first_voffset(c) == ij.first_voffset(c)
        assert (it.chunks_for_region(c, 1000, 50_000)
                == [tt.Chunk(x.beg, x.end)
                    for x in ij.chunks_for_region(c, 1000, 50_000)])


def test_list_chromosomes_without_index_and_unsorted(tmp_path):
    p = tmp_path / "t.vcf.gz"
    make_test_vcf(p, seed=1, chroms=("1", "2", "X"), n_per_chrom=50)
    assert tt.list_chromosomes(p) == jt.list_chromosomes(p) == ["1", "2", "X"]
    bad = tmp_path / "bad.vcf.gz"
    recs = [tv.VcfRecord("1", 100, "A", ["G"], [1], 2, "SNP", ["0|1"]),
            tv.VcfRecord("2", 100, "A", ["G"], [1], 2, "SNP", ["0|1"]),
            tv.VcfRecord("1", 200, "A", ["G"], [1], 2, "SNP", ["0|1"])]
    tv.write_vcf(bad, recs, contigs=["1", "2"])
    with pytest.raises(ValueError, match="out of order"):
        tt.build_tbi(bad)
    with pytest.raises(ValueError, match="out of order"):
        jt.build_tbi(bad)


@pytest.mark.parametrize("info", [
    "AC=3,4;AN=10;VT=SNP", "DP=4", ".", "AC=x;AN=y", "AN=8;AC=2", "VT=SV",
    "AC=1,;AN=", "",
])
def test_parse_info_equal(info):
    assert tv.parse_info(info) == jv.parse_info(info)


@pytest.mark.parametrize("line", [
    "1\t123\t.\tA\tG,T\t.\tPASS\tAC=1,2;AN=6\tGT:DP\t0|1:3\t2/2:5\t.:1",
    "1\t5\t.\tA\tG\t.\t.\t.\tGT\t0|1\t1|1\t.|.",
    "X\t9\trs1\tAC\t<DEL>\t.\tPASS\tVT=SV",
    "2\t7\t.\tA\tC\t.\t.\tAC=1;AN=2\tDP:GT\t3:0/1\t4\t5:1|1",
    "#CHROM\tPOS", "", "1\t2\t.\tA",
])
def test_parse_record_equal(line):
    for form in (line, line.encode()):
        a, b = tv.parse_record(form), jv.parse_record(form)
        assert (a is None) == (b is None)
        if a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert a.genotype_calls() == b.genotype_calls()
            assert a.effective_ac() == b.effective_ac()
            assert a.effective_an() == b.effective_an()


@pytest.mark.parametrize("n_samples", [0, 4, 9])
def test_write_vcf_bytes_and_readers_equal(tmp_path, n_samples):
    rng = random.Random(n_samples)
    recs = (j_random_records(rng, chrom="1", n=150, n_samples=n_samples)
            + j_random_records(rng, chrom="2", n=150, n_samples=n_samples))
    names = [f"S{i}" for i in range(n_samples)] or None
    pj, pt = tmp_path / "j.vcf.gz", tmp_path / "t.vcf.gz"
    jv.write_vcf(pj, recs, sample_names=names)
    tv.write_vcf(pt, [tv.VcfRecord(**dataclasses.asdict(r)) for r in recs],
                 sample_names=names)
    assert pt.read_bytes() == pj.read_bytes()
    assert tv.read_sample_names(pt) == jv.read_sample_names(pj)
    got = [dataclasses.asdict(r) for r in tv.iter_vcf_records(pt)]
    assert got == [dataclasses.asdict(r) for r in jv.iter_vcf_records(pj)]
    lo, hi = recs[40].pos, recs[120].pos
    tt.ensure_index(pt)
    jt.ensure_index(pj)
    region = [dataclasses.asdict(r)
              for r in tv.iter_vcf_records(pt, region=("1", lo, hi))]
    assert region == [dataclasses.asdict(r) for r in
                      jv.iter_vcf_records(pj, region=("1", lo, hi))]
    assert region


def test_make_test_vcf_bytes_equal(tmp_path):
    a = make_test_vcf(tmp_path / "t.vcf.gz", seed=7, chroms=("1", "3"),
                      n_per_chrom=120, n_samples=5)
    b = j_make_test_vcf(tmp_path / "j.vcf.gz", seed=7, chroms=("1", "3"),
                        n_per_chrom=120, n_samples=5)
    assert [dataclasses.asdict(r) for r in a] == [dataclasses.asdict(r)
                                                   for r in b]
    assert ((tmp_path / "t.vcf.gz").read_bytes()
            == (tmp_path / "j.vcf.gz").read_bytes())


@pytest.mark.parametrize("n_records,n_samples,chunk", [(300, 7, 64),
                                                       (1000, 70, 4096)])
def test_write_cohort_vcf(tmp_path, n_records, n_samples, chunk):
    p = tmp_path / "c.vcf.gz"
    info = write_cohort_vcf(p, n_records, n_samples=n_samples, seed=3,
                            chunk=chunk, workers=2)
    again = tmp_path / "again.vcf.gz"
    write_cohort_vcf(again, n_records, n_samples=n_samples, seed=3,
                     chunk=chunk, workers=1)
    assert again.read_bytes() == p.read_bytes()  # seeded, worker-free
    assert info["compressed_bytes"] == p.stat().st_size
    assert gzip.decompress(p.read_bytes()).__len__() == info["text_bytes"]
    recs = list(jv.iter_vcf_records(p))
    assert [dataclasses.asdict(r) for r in tv.iter_vcf_records(p)] == [
        dataclasses.asdict(r) for r in recs]
    assert len(recs) == n_records
    assert jv.read_sample_names(p) == info["sample_names"]
    assert dataclasses.asdict(jt.find_index_for(p)) == dataclasses.asdict(
        jt.build_tbi(p))
    pos = [r.pos for r in recs]
    assert pos == sorted(set(pos)) and all(r.chrom == "22" for r in recs)
    for r in recs:
        assert len(r.genotypes) == n_samples
        assert all(len(g) == 3 and g[1] == "|" for g in r.genotypes)
        calls = r.genotype_calls()
        if r.ac is not None:  # INFO AC/AN agree with the genotypes
            assert r.ac == [calls.count(k + 1) for k in range(len(r.alts))]
            assert r.an == len(calls) == 2 * n_samples
    # the site mix of random_records: multi-allelic, symbolic, indels,
    # records without AC/AN
    assert any(len(r.alts) == 2 for r in recs)
    assert any(a.startswith("<") for r in recs for a in r.alts)
    assert any(len(r.ref) > 1 for r in recs)
    assert any(r.ac is None for r in recs)
