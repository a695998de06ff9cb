"""VCF record parsing and synthetic-VCF generation.

Counterpart of ``sbeacon_tpu/genomics/vcf.py``, copied whole.

The reference never parses VCF itself on the query path — it shells out to
``bcftools query`` per region (reference: lambda/performQuery/
search_variants.py:42-50) — and its C++ ingest scans raw bytes for the
handful of columns it needs (reference: lambda/summariseSlice/source/
main.cpp:52-109). Here the parse is an explicit, tested layer: records come
out with exactly the fields the matching semantics consume (POS, REF, ALTs,
INFO AC/AN/VT, genotypes), feeding both the CPU oracle and the columnar
index builder.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path

from .bgzf import BgzfWriter

_CALLS = re.compile(r"[0-9]+")

#: GT-string -> call tuple memo (cohorts use a handful of GT spellings;
#: bounded against pathological cardinality)
_CALLS_MEMO: dict[str, tuple[int, ...]] = {}


def _calls_for(gt: str) -> tuple[int, ...]:
    r = _CALLS_MEMO.get(gt)
    if r is None:
        r = tuple(int(m) for m in _CALLS.findall(gt))
        if len(_CALLS_MEMO) < 1 << 16:
            _CALLS_MEMO[gt] = r
    return r


@dataclass
class VcfRecord:
    chrom: str
    pos: int  # 1-based, as in the file
    ref: str
    alts: list[str]
    # INFO-derived; None when absent from the file
    ac: list[int] | None  # per-alt allele counts (INFO AC)
    an: int | None  # total allele number (INFO AN)
    vt: str  # INFO VT, 'N/A' when absent (reference main default)
    genotypes: list[str]  # raw GT strings per sample, e.g. '0|1'

    def genotype_calls(self) -> list[int]:
        """All haplotype allele indices, reference-style.

        Matches ``get_all_calls`` = ``re.compile('[0-9]+').findall`` over the
        joined genotype column (reference: performQuery/search_variants.py:
        28-29,219) — every integer in every GT contributes one call; '.'
        (missing) contributes none.
        """
        calls: list[int] = []
        for gt in self.genotypes:
            calls.extend(_calls_for(gt))
        return calls

    def effective_ac(self) -> list[int]:
        """Per-alt allele count: INFO AC when present, else genotype tally."""
        if self.ac is not None:
            return self.ac
        calls = self.genotype_calls()
        return [sum(1 for c in calls if c == i + 1) for i in range(len(self.alts))]

    def effective_an(self) -> int:
        """Allele number: INFO AN when present, else number of calls."""
        if self.an is not None:
            return self.an
        return len(self.genotype_calls())


def parse_info(info_str: str) -> tuple[list[int] | None, int | None, str]:
    """Extract (AC list, AN, VT) from an INFO column string.

    Mirrors the INFO scan in the reference hot loop (performQuery/
    search_variants.py:195-201): only ``AC=``, ``AN=``, ``VT=`` matter.
    """
    ac = None
    an = None
    vt = "N/A"
    for info in info_str.split(";"):
        if info.startswith("AC="):
            try:
                ac = [int(c) for c in info[3:].split(",")]
            except ValueError:
                ac = None
        elif info.startswith("AN="):
            try:
                an = int(info[3:])
            except ValueError:
                an = None
        elif info.startswith("VT="):
            vt = info[3:]
    return ac, an, vt


def parse_record(line: str | bytes) -> VcfRecord | None:
    """Parse one VCF body line; None for headers/empty lines."""
    if isinstance(line, bytes):
        line = line.decode()
    if not line or line.startswith("#"):
        return None
    fields = line.rstrip("\n").split("\t")
    if len(fields) < 8:
        return None
    chrom, pos, _id, ref, alt_str, _qual, _filt, info = fields[:8]
    genotypes: list[str] = []
    if len(fields) > 9:
        fmt = fields[8].split(":")
        try:
            gt_idx = fmt.index("GT")
        except ValueError:
            gt_idx = -1
        if gt_idx == 0:
            # GT-first is the overwhelmingly common FORMAT layout;
            # partition beats a full split across every sample column
            genotypes = [s.partition(":")[0] for s in fields[9:]]
        elif gt_idx > 0:
            for sample in fields[9:]:
                parts = sample.split(":")
                genotypes.append(parts[gt_idx] if gt_idx < len(parts) else ".")
    ac, an, vt = parse_info(info)
    return VcfRecord(
        chrom=chrom,
        pos=int(pos),
        ref=ref,
        alts=alt_str.split(","),
        ac=ac,
        an=an,
        vt=vt,
        genotypes=genotypes,
    )


def iter_vcf_records(
    path: str | Path,
    region: tuple[str, int, int] | None = None,
    index=None,
):
    """Yield VcfRecords from a bgzipped VCF, optionally region-filtered.

    ``region`` is (chrom, start, end) 1-based inclusive, bcftools
    ``--regions`` style: records whose REF span overlaps the region are
    yielded (htslib overlap semantics, which is why the reference re-checks
    ``first_bp <= pos <= last_bp`` afterwards — performQuery/
    search_variants.py:83-85). When a .tbi/.csi sits next to the file (or
    via ``index=``), the region path seeks straight to the candidate chunks
    instead of inflating the whole file.
    """
    from .bgzf import BgzfReader
    from .tabix import find_index_for

    reader = BgzfReader(path)
    if region is None:
        for _, line in reader.iter_lines():
            rec = parse_record(line)
            if rec is not None:
                yield rec
        return

    chrom, start, end = region
    if index is None:
        index = find_index_for(path)
    if index is not None and index.ref_id(chrom) is not None:
        spans = [
            (c.beg, c.end) for c in index.chunks_for_region(chrom, start - 1, end)
        ]
    else:
        spans = [(0, None)]
    for beg, stop in spans:
        for _, line in reader.iter_lines(beg, stop):
            rec = parse_record(line)
            if rec is None:
                continue
            if rec.chrom != chrom:
                if index is not None:
                    # sorted file + indexed seek: past this contig means done
                    break
                continue
            if rec.pos > end:
                break
            if rec.pos + len(rec.ref) - 1 < start:
                continue
            yield rec


def read_sample_names(path: str | Path) -> list[str]:
    """Sample names from the #CHROM header line (reference:
    summariseVcf/lambda_function.py:128-141 reads the same to count samples).
    """
    from .bgzf import BgzfReader

    reader = BgzfReader(path)
    for _, line in reader.iter_lines():
        if line.startswith(b"#CHROM"):
            cols = line.decode().rstrip("\n").split("\t")
            return cols[9:] if len(cols) > 9 else []
        if not line.startswith(b"#"):
            break
    return []


# ---------------------------------------------------------------------------
# Synthetic VCF writing (fixtures + simulation harness)
# ---------------------------------------------------------------------------

VCF_HEADER_LINES = [
    "##fileformat=VCFv4.2",
    '##INFO=<ID=AC,Number=A,Type=Integer,Description="Allele count">',
    '##INFO=<ID=AN,Number=1,Type=Integer,Description="Allele number">',
    '##INFO=<ID=VT,Number=.,Type=String,Description="Variant type">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
]


def write_vcf(
    path: str | Path,
    records: list[VcfRecord],
    sample_names: list[str] | None = None,
    contigs: list[str] | None = None,
) -> None:
    """Write a bgzipped VCF from records (sorted by (chrom order, pos))."""
    if sample_names is None:
        n = max((len(r.genotypes) for r in records), default=0)
        sample_names = [f"S{i:04d}" for i in range(n)]
    header = list(VCF_HEADER_LINES)
    if contigs is None:
        contigs = []
        for r in records:
            if r.chrom not in contigs:
                contigs.append(r.chrom)
    for c in contigs:
        header.append(f"##contig=<ID={c}>")
    cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]
    if sample_names:
        cols += ["FORMAT"] + sample_names
    header.append("\t".join(cols))
    with BgzfWriter(path) as w:
        for line in header:
            w.write(line + "\n")
        for r in records:
            info_parts = []
            if r.ac is not None:
                info_parts.append("AC=" + ",".join(str(a) for a in r.ac))
            if r.an is not None:
                info_parts.append(f"AN={r.an}")
            if r.vt and r.vt != "N/A":
                info_parts.append(f"VT={r.vt}")
            info = ";".join(info_parts) if info_parts else "."
            fields = [
                r.chrom,
                str(r.pos),
                ".",
                r.ref,
                ",".join(r.alts),
                ".",
                "PASS",
                info,
            ]
            if sample_names:
                fields.append("GT")
                gts = list(r.genotypes) + ["0|0"] * (
                    len(sample_names) - len(r.genotypes)
                )
                fields.extend(gts)
            w.write("\t".join(fields) + "\n")
