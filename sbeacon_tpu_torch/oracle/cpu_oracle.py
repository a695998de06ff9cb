"""CPU oracle: the variant-matching semantics, implemented as the spec.

Counterpart of ``sbeacon_tpu/oracle/cpu_oracle.py``, copied whole. This
is a faithful re-implementation of the reference's hot leaf (reference:
lambda/performQuery/search_variants.py:33-271) minus the bcftools
subprocess and AWS plumbing, over parsed VCF records. It is the parity
target, independent of the index: the engine's device kernels and its
host matcher must produce identical exists/call_count/all_alleles_count/
variants for any query.

Two deliberate divergences from the reference source, both bugs there:

1. The alt-undefined branch dispatches on the *local* ``variant_type``
   before assignment (reference :101 vs :193), which would raise
   UnboundLocalError on the first record; the intent is clearly
   ``payload.variant_type``, and that is what we implement.
2. ``reference_bases=None`` (legal for Beacon bracket/variantType queries)
   would compare ``reference.upper() != None`` and reject every record;
   we treat None like 'N' (wildcard), the only useful reading.
3. The genotype-fallback variants list indexes ``alts[i]`` with the
   *1-based* allele number (reference :220-225) — an off-by-one that lists
   the wrong alt for multi-alt records and raises IndexError for
   single-alt ones; the intent is ``alts[i - 1]`` and that is what we
   implement.

Everything else matches to the letter, including the quirks:
- the length filter applies to ``len(alt)`` even for symbolic alts,
- DUP matches ``<CN*>`` except literal '<CN0>'/'<CN1>' (so '<CNV>' counts),
- AN accumulates once per record that has any hit alt, even when AC is 0,
- the genotype fallback counts every integer in the GT column.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from ..genomics.vcf import VcfRecord
from ..payloads import VariantSearchResponse

BASES = ["A", "C", "G", "T", "N"]


@dataclass
class MatchResult:
    hit_indexes: list[int] = field(default_factory=list)
    # per-record contributions (reference loop accumulators)
    call_count: int = 0
    all_alleles_count: int = 0
    variants: list[str] = field(default_factory=list)
    sample_indices: set[int] = field(default_factory=set)


def _alt_hits(
    record: VcfRecord,
    alternate_bases: str | None,
    variant_type: str | None,
    min_len: int,
    max_len: float,
) -> list[int]:
    """Which alt indexes of the record satisfy the allele criteria."""
    alts = record.alts
    ref = record.ref
    ref_length = len(ref)
    # '<TYPE' prefix without closing '>'; variant_type=None formats to
    # '<None' and matches nothing (reference :54's exact behaviour)
    v_prefix = "<{}".format(variant_type)

    def len_ok(alt: str) -> bool:
        return min_len <= len(alt) <= max_len

    if alternate_bases is None:
        if variant_type == "DEL":
            return [
                i
                for i, alt in enumerate(alts)
                if (
                    (alt.startswith(v_prefix) or alt == "<CN0>")
                    if alt.startswith("<")
                    else len(alt) < ref_length
                )
                and len_ok(alt)
            ]
        if variant_type == "INS":
            return [
                i
                for i, alt in enumerate(alts)
                if (
                    alt.startswith(v_prefix)
                    if alt.startswith("<")
                    else len(alt) > ref_length
                )
                and len_ok(alt)
            ]
        if variant_type == "DUP":
            pattern = re.compile("({}){{2,}}".format(ref))
            return [
                i
                for i, alt in enumerate(alts)
                if (
                    (
                        alt.startswith(v_prefix)
                        or (alt.startswith("<CN") and alt not in ("<CN0>", "<CN1>"))
                    )
                    if alt.startswith("<")
                    else pattern.fullmatch(alt)
                )
                and len_ok(alt)
            ]
        if variant_type == "DUP:TANDEM":
            tandem = ref + ref
            return [
                i
                for i, alt in enumerate(alts)
                if (
                    (alt.startswith(v_prefix) or alt == "<CN2>")
                    if alt.startswith("<")
                    else alt == tandem
                )
                and len_ok(alt)
            ]
        if variant_type == "CNV":
            pattern = re.compile("\\.|({})*".format(ref))
            return [
                i
                for i, alt in enumerate(alts)
                if (
                    (
                        alt.startswith(v_prefix)
                        or alt.startswith("<CN")
                        or alt.startswith("<DEL")
                        or alt.startswith("<DUP")
                    )
                    if alt.startswith("<")
                    else pattern.fullmatch(alt)
                )
                and len_ok(alt)
            ]
        # structural variants not otherwise recognisable
        return [
            i
            for i, alt in enumerate(alts)
            if alt.startswith(v_prefix) and len_ok(alt)
        ]

    if alternate_bases == "N":
        return [
            i for i, alt in enumerate(alts) if alt.upper() in BASES and len_ok(alt)
        ]
    return [
        i
        for i, alt in enumerate(alts)
        if alt.upper() == alternate_bases and len_ok(alt)
    ]


def _subset_genotypes(record: VcfRecord, idx: list[int]) -> VcfRecord:
    """Copy of the record with GT columns subset to ``idx``, in that order
    (what ``bcftools query --samples a,b`` emits)."""
    import dataclasses

    return dataclasses.replace(
        record, genotypes=[record.genotypes[i] for i in idx]
    )


def match_record(
    record: VcfRecord,
    *,
    first_bp: int,
    last_bp: int,
    end_min: int,
    end_max: int,
    reference_bases: str | None,
    alternate_bases: str | None,
    variant_type: str | None,
    variant_min_length: int = 0,
    variant_max_length: int = -1,
    chrom_label: str | None = None,
    selected_sample_idx: list[int] | None = None,
) -> MatchResult | None:
    """Apply the per-record filter chain; None when the record is rejected.

    Mirrors the loop body of perform_query (reference :70-250): window
    ownership, end-range, ref validation, alt dispatch, AC/AN-vs-genotype
    counting duality.

    ``selected_sample_idx`` switches to the selected-samples leaf
    (reference: performQuery/search_variants_in_samples.py — the
    ``bcftools query --samples`` path): the genotype columns are subset to
    those sample indexes (INFO AC/AN stay full-cohort, exactly as bcftools
    leaves INFO untouched), genotype-derived counting and sample-hit
    extraction run over the subset, and the ref check becomes the
    N-wildcard regex (``reference_bases.replace('N', '[ACGTN]{1}')``,
    search_variants_in_samples.py:87-91).
    """
    out = MatchResult()
    pos = record.pos
    if not first_bp <= pos <= last_bp:
        return None

    ref_length = len(record.ref)
    if not end_min <= pos + ref_length - 1 <= end_max:
        return None

    approx = reference_bases is None or reference_bases == "N"
    if selected_sample_idx is None:
        if not approx and record.ref.upper() != reference_bases:
            return None
    else:
        if not approx:
            rgx = re.compile(
                "^" + reference_bases.replace("N", "[ACGTN]{1}") + "$"
            )
            if not rgx.match(record.ref.upper()):
                return None
        record = _subset_genotypes(record, selected_sample_idx)

    max_len = float("inf") if variant_max_length < 0 else variant_max_length
    hit_indexes = _alt_hits(
        record, alternate_bases, variant_type, variant_min_length, max_len
    )
    if not hit_indexes:
        return None

    out.hit_indexes = hit_indexes
    chrom = chrom_label if chrom_label is not None else record.chrom
    vt = record.vt

    if record.ac is not None:
        alt_counts = record.ac
        out.call_count = sum(alt_counts[i] for i in hit_indexes)
        out.variants = [
            f"{chrom}\t{pos}\t{record.ref}\t{record.alts[i]}\t{vt}"
            for i in hit_indexes
            if alt_counts[i] != 0
        ]
        all_calls = None
    else:
        all_calls = record.genotype_calls()
        hit_set = {i + 1 for i in hit_indexes}
        # divergence 3: allele number i is 1-based -> alts[i - 1]
        out.variants = [
            f"{chrom}\t{pos}\t{record.ref}\t{record.alts[i - 1]}\t{vt}"
            for i in sorted(set(all_calls) & hit_set)
        ]
        out.call_count = sum(1 for call in all_calls if call in hit_set)

    if record.an is not None:
        out.all_alleles_count = record.an
    else:
        if all_calls is None:
            all_calls = record.genotype_calls()
        out.all_alleles_count = len(all_calls)

    # sample hits: GT token-contains any hit allele index (reference :233-236
    # regex '(^|[|/])(hits)([|/]|$)'); the caller gates on *cumulative*
    # call_count exactly as the reference loop does
    hit_set = {i + 1 for i in hit_indexes}
    for s_idx, gt in enumerate(record.genotypes):
        tokens = re.split(r"[|/]", gt)
        if any(t.isdigit() and int(t) in hit_set for t in tokens):
            out.sample_indices.add(s_idx)
    return out


def oracle_search(
    records,
    *,
    first_bp: int,
    last_bp: int,
    end_min: int,
    end_max: int,
    reference_bases: str | None,
    alternate_bases: str | None,
    variant_type: str | None = None,
    variant_min_length: int = 0,
    variant_max_length: int = -1,
    requested_granularity: str = "record",
    include_details: bool = True,
    include_samples: bool = False,
    sample_names: list[str] | None = None,
    dataset_id: str = "",
    vcf_location: str = "",
    chrom_label: str | None = None,
    selected_sample_idx: list[int] | None = None,
) -> VariantSearchResponse:
    """Full scan over records, reference accumulator semantics included.

    The early-exit behaviours are preserved: boolean granularity stops at
    the first hit; include_details=False stops once exists flips true
    (reference :229-254) — both truncate the counters exactly as the
    reference does.
    """
    exists = False
    variants: list[str] = []
    call_count = 0
    all_alleles_count = 0
    sample_indices: set[int] = set()

    for record in records:
        m = match_record(
            record,
            first_bp=first_bp,
            last_bp=last_bp,
            end_min=end_min,
            end_max=end_max,
            reference_bases=reference_bases,
            alternate_bases=alternate_bases,
            variant_type=variant_type,
            variant_min_length=variant_min_length,
            variant_max_length=variant_max_length,
            chrom_label=chrom_label,
            selected_sample_idx=selected_sample_idx,
        )
        if m is None:
            continue
        variants += m.variants
        call_count += m.call_count

        if call_count:
            exists = True
            if not include_details:
                break
            if requested_granularity in ("record", "aggregated") and include_samples:
                sample_indices.update(m.sample_indices)

        all_alleles_count += m.all_alleles_count

        if requested_granularity == "boolean" and exists:
            break

    resolved_names: list[str] = []
    if (
        requested_granularity in ("record", "aggregated")
        and include_samples
        and sample_names
    ):
        resolved_names = [
            s for n, s in enumerate(sample_names) if n in sample_indices
        ]

    return VariantSearchResponse(
        dataset_id=dataset_id,
        vcf_location=vcf_location,
        exists=exists,
        all_alleles_count=all_alleles_count,
        call_count=call_count,
        variants=variants,
        sample_indices=sorted(sample_indices),
        sample_names=resolved_names,
    )
