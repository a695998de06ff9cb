"""Chromosome name normalisation + GRCh38 lengths.

Counterpart of ``sbeacon_tpu/utils/chrom.py``, copied verbatim so the
port imports nothing of the JAX package.

Semantics match the reference's chromosome matcher
(reference: shared_resources/utils/chrom_matching.py:6-79): a VCF contig name
is normalised by progressively stripping prefixes until a canonical name
(1..22, X, Y, MT, with M/x/y aliases) is found, so "chr1", "Chr1", "CHR1"
and "1" all map to "1". Canonical names additionally get a small integer
code used as the high bits of the device-side sort key.
"""

from __future__ import annotations

CHROMOSOME_ALIASES = {
    "M": "MT",
    "x": "X",
    "y": "Y",
}

CHROMOSOME_LENGTHS = {
    "1": 248956422,
    "2": 242193529,
    "3": 198295559,
    "4": 190214555,
    "5": 181538259,
    "6": 170805979,
    "7": 159345973,
    "8": 145138636,
    "9": 138394717,
    "10": 133797422,
    "11": 135086622,
    "12": 133275309,
    "13": 114364328,
    "14": 107043718,
    "15": 101991189,
    "16": 90338345,
    "17": 83257441,
    "18": 80373285,
    "19": 58617616,
    "20": 64444167,
    "21": 46709983,
    "22": 50818468,
    "X": 156040895,
    "Y": 57227415,
    "MT": 16569,
}

CHROMOSOMES = list(CHROMOSOME_LENGTHS.keys())

# 1-based integer code per canonical chromosome; 0 = unknown.
CHROMOSOME_CODES = {name: i + 1 for i, name in enumerate(CHROMOSOMES)}
CODE_TO_CHROMOSOME = {v: k for k, v in CHROMOSOME_CODES.items()}


def normalize_chromosome(chromosome_name: str) -> str | None:
    """'chr22' -> '22'; 'chrM' -> 'MT'; unknown -> None."""
    for i in range(len(chromosome_name)):
        chrom = chromosome_name[i:]
        if chrom in CHROMOSOME_LENGTHS:
            return chrom
        if chrom in CHROMOSOME_ALIASES:
            return CHROMOSOME_ALIASES[chrom]
    return None


def get_matching_chromosome(vcf_chromosomes, target_chromosome):
    """Find the VCF's native name for a canonical chromosome (or None)."""
    for vcf_chrom in vcf_chromosomes:
        if normalize_chromosome(vcf_chrom) == target_chromosome:
            return vcf_chrom
    return None


def chromosome_code(chromosome_name: str) -> int:
    """Canonical chromosome -> small int code (0 if unknown)."""
    norm = normalize_chromosome(chromosome_name)
    if norm is None:
        return 0
    return CHROMOSOME_CODES[norm]
