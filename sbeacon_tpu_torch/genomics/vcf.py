"""VCF records: the fields the index builder and the test corpora use.

Counterpart of ``sbeacon_tpu/genomics/vcf.py``, trimmed to
``VcfRecord`` and the genotype tokenizer ``build_index`` needs. Parsing
and writing VCF text belong to the ingest slice.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

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
        """All haplotype allele indices, reference-style: every integer
        in every GT contributes one call; '.' (missing) contributes
        none."""
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
