"""The benchmark's data: a deployment's variant rows and genotype bits,
made from the run's seed.

Frozen copy of ``sbeacon_tpu_torch.testing.synthetic_shard`` (the row
model: records of 1-3 alts, a 1/x allele-frequency spectrum, 2% of rows
monomorphic, SNVs, indels from a 60-word vocabulary and symbolic alts,
INFO AC/AN on every row) and of ``chip_smoke.attach_planes`` (genotype
bits drawn by a seeded generator on the device, about 1% set, the tail
word masked). Two departures, neither of which changes what a row holds:
positions are drawn per chromosome as sorted uniforms (a cumulative sum
of exponentials instead of a sort), and the function returns the raw
rows (allele ids into a vocabulary) rather than the program's index.
``lib.adapter`` hands them to the program; ``reference/`` reads them
as they are. Imports numpy and, for the planes, torch; nothing of the
program.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np

# GRCh38 chr1-22 lengths (sbeacon_tpu_torch/utils/chrom.py)
CHROM_LENGTHS = {
    "1": 248956422, "2": 242193529, "3": 198295559, "4": 190214555,
    "5": 181538259, "6": 170805979, "7": 159345973, "8": 145138636,
    "9": 138394717, "10": 133797422, "11": 135086622, "12": 133275309,
    "13": 114364328, "14": 107043718, "15": 101991189, "16": 90338345,
    "17": 83257441, "18": 80373285, "19": 58617616, "20": 64444167,
    "21": 46709983, "22": 50818468,
}
CHROMS = list(CHROM_LENGTHS)
GENOME_BP = float(sum(CHROM_LENGTHS.values()))
SYMBOLIC = ["<DEL>", "<DUP>", "<CN0>", "<CN2>", "<INS>", "."]
PLANE_DENSITY = 0.01


@dataclasses.dataclass
class Dataset:
    """One dataset's rows, sorted by (chromosome, position). ``chrom`` is
    an index into ``CHROMS``; ``ref_id`` / ``alt_id`` index ``vocab``;
    rows of one record are adjacent and share ``rec_id``, position, REF
    and AN. ``gt`` is the [rows, words] genotype bit plane (bit s of a
    row: sample s carries the alt) or None."""

    dataset_id: str
    sample_names: list[str]
    vocab: list[str]
    chrom: np.ndarray
    pos: np.ndarray
    ref_id: np.ndarray
    alt_id: np.ndarray
    ac: np.ndarray
    an: np.ndarray
    rec_id: np.ndarray
    n_records: int
    gt: np.ndarray | None = None
    chrom_start: np.ndarray = None

    def __post_init__(self):
        if self.chrom_start is None:
            self.chrom_start = np.searchsorted(
                self.chrom, np.arange(len(CHROMS) + 1), side="left")

    @property
    def n_rows(self) -> int:
        return len(self.pos)

    def row_chrom(self, i: int) -> str:
        return CHROMS[int(self.chrom[i])]

    def row_ref(self, i: int) -> str:
        return self.vocab[int(self.ref_id[i])]

    def row_alt(self, i: int) -> str:
        return self.vocab[int(self.alt_id[i])]


def allele_vocab(seed: int) -> list[str]:
    """4 bases, 60 random 2-24-base strings, the symbolic alts."""
    rng = random.Random(seed + 1)
    vocab = ["A", "C", "G", "T"]
    for _ in range(60):
        vocab.append("".join(rng.choice("ACGT")
                             for _ in range(rng.randint(2, 24))))
    return vocab + SYMBOLIC


def _sorted_positions(rng, n: int, length: int) -> np.ndarray:
    """n uniform positions in [1, length - 1], ascending."""
    if n == 0:
        return np.zeros(0, np.int64)
    cs = np.cumsum(rng.standard_exponential(n + 1))
    return (cs[:-1] / cs[-1] * (length - 1)).astype(np.int64) + 1


def make_rows(n_rows: int, *, n_samples: int, seed: int, dataset_id: str,
              p_multiallelic: float = 0.08, p_indel: float = 0.12,
              p_symbolic: float = 0.01) -> Dataset:
    """``n_rows`` rows over chr1-22 spread by length (no planes)."""
    rng = np.random.default_rng(seed)
    lengths = np.array([CHROM_LENGTHS[c] for c in CHROMS], np.float64)
    n_rec_est = n_rows + 8
    n_alts = np.where(rng.random(n_rec_est) < p_multiallelic,
                      rng.integers(2, 4, n_rec_est), 1).astype(np.int64)
    total = np.cumsum(n_alts)
    n_rec = min(int(np.searchsorted(total, n_rows, side="left")) + 1,
                n_rec_est)
    n_alts = n_alts[:n_rec]
    n = int(n_alts.sum())

    per_chrom = rng.multinomial(n_rec, lengths / lengths.sum())
    rec_chrom = np.repeat(np.arange(len(CHROMS), dtype=np.int8), per_chrom)
    rec_pos = np.concatenate([
        _sorted_positions(rng, int(k), int(L))
        for k, L in zip(per_chrom, lengths)])
    row_rec = np.repeat(np.arange(n_rec, dtype=np.int64), n_alts)

    vocab = allele_vocab(seed)
    kind = rng.random(n)
    is_sym = kind < p_symbolic
    is_indel = (~is_sym) & (kind < p_symbolic + p_indel)
    alt_id = np.where(
        is_sym, rng.integers(64, 64 + len(SYMBOLIC), n),
        np.where(is_indel, rng.integers(4, 64, n), rng.integers(0, 4, n)),
    ).astype(np.int16)
    ref_id = np.repeat(
        np.where(rng.random(n_rec) < p_indel / 2,
                 rng.integers(4, 64, n_rec), rng.integers(0, 4, n_rec)),
        n_alts).astype(np.int16)
    an_val = 2 * n_samples
    ac = np.minimum((1.0 / np.maximum(rng.random(n), 1e-6)).astype(np.int64),
                    an_val).astype(np.int32)
    ac[rng.random(n) < 0.02] = 0
    return Dataset(
        dataset_id=dataset_id,
        sample_names=[f"S{i}" for i in range(n_samples)],
        vocab=vocab,
        chrom=rec_chrom[row_rec],
        pos=rec_pos[row_rec],
        ref_id=ref_id,
        alt_id=alt_id,
        ac=ac,
        an=np.full(n, an_val, np.int32),
        rec_id=row_rec,
        n_records=n_rec,
    )


def make_planes(datasets: list[Dataset], seed: int, device) -> None:
    """Give every dataset a genotype bit plane drawn on ``device`` by one
    ``torch.Generator`` seeded from ``seed``, in 4-million-row calls,
    copied to the host (``Dataset.gt``)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed & (2**63 - 1))
    k_and = max(1, int(round(-np.log2(PLANE_DENSITY))))
    for ds in datasets:
        n_samples = len(ds.sample_names)
        w = (n_samples + 31) // 32
        tail = torch.full((w,), -1, dtype=torch.int32, device=device)
        if n_samples % 32:
            tail[-1] = (1 << (n_samples % 32)) - 1
        host = np.empty((ds.n_rows, w), np.uint32)
        step = 1 << 22
        for i in range(0, ds.n_rows, step):
            m = min(step, ds.n_rows - i)
            x = torch.randint(-(2**31), 2**31, (m, w), dtype=torch.int32,
                              device=device, generator=gen)
            for _ in range(k_and - 1):
                x &= torch.randint(-(2**31), 2**31, (m, w),
                                   dtype=torch.int32, device=device,
                                   generator=gen)
            host[i:i + m] = (x & tail).cpu().numpy().view(np.uint32)
        ds.gt = host


def make_deployment(config: dict, seed: int, device) -> list[Dataset]:
    """Every dataset of a configuration file (``datasets``, ``rows_per_
    dataset``, ``samples``, ``gt_plane``), each from its own seed
    drawn from ``seed``."""
    seeds = np.random.SeedSequence(seed).generate_state(
        config["datasets"], dtype=np.uint64)
    names = ([config["dataset_id"]] if config["datasets"] == 1 else
             [f"{config['dataset_id']}{k:04d}"
              for k in range(config["datasets"])])
    out = [make_rows(config["rows_per_dataset"],
                     n_samples=config["samples"], seed=int(s),
                     dataset_id=name)
           for s, name in zip(seeds, names)]
    if config.get("gt_plane"):
        make_planes(out, seed, device)
    return out
