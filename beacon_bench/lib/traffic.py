"""The one request generator: a traffic file (``traffic/<name>.json``)
names request kinds with their shares, and this module draws a run's
requests from them and the seed.

A kind is a request shape, a route and a granularity mix:

- ``shape``: ``snv_point`` (an SNV row's exact REF/ALT at its position,
  the end bound ``end_pad`` bases on), ``bracket`` (a start bracket of a
  width drawn from ``widths``, the end bracket ``end_pad`` further, or
  open with ``"open_end": true``; ``centered`` puts the row in the
  middle), or ``wide`` (``window_factor`` times the device window cap
  of rows of the densest dataset);
- ``alt`` / ``ref`` / ``variant_types``: choices drawn uniformly
  (``null`` leaves the field out); ``p_variant_type`` sends a type
  instead of ``alt`` on that share;
- ``route``: ``dataset`` (``/datasets/{id}/g_variants``: one dataset)
  or ``all`` (``/g_variants``: every dataset);
- ``granularity``: {granularity: share}, of ``boolean`` and ``count``
  (the granularities the reference's summary covers).

Frozen from ``chip_smoke.request_bodies`` (the BASELINE mix) and
``fused_specs`` (the multi-dataset mix); the shapes are theirs, the
mixes are in the traffic files. ``people_of`` gives a configuration's
individuals (the server's metadata). Imports nothing of the program.
"""

from __future__ import annotations

import json
import random

from .datagen import GENOME_BP, Dataset

HP_TERMS = ("HP:0001250", "HP:0001631", "HP:0000717", "HP:0001263",
            "HP:0000252", "HP:0002664", "HP:0001627", "HP:0004322")
HP_PARENT = "HP:0000118"
SEX_TERMS = ("NCIT:C16576", "NCIT:C20197")
ASSEMBLY = "GRCh38"


def people_of(ds: Dataset, seed: int) -> dict:
    """{individual id: (sample, sex, disease)}: one individual a sample,
    the sex alternating, a disease drawn from HP_TERMS."""
    rng = random.Random(seed)
    return {f"I{k}": (name, SEX_TERMS[k % 2], rng.choice(HP_TERMS))
            for k, name in enumerate(ds.sample_names)}


def _snv_row(rng, ds: Dataset) -> int:
    while True:
        i = rng.randrange(ds.n_rows)
        if len(ds.row_ref(i)) == 1 and ds.row_alt(i) in "ACGT":
            return i


class Generator:
    def __init__(self, traffic: dict, datasets: list[Dataset],
                 window_cap: int):
        self.t = traffic
        self.datasets = datasets
        self.window_cap = window_cap
        shares = [k["share"] for k in traffic["kinds"]]
        if abs(sum(shares) - 1.0) > 1e-9:
            raise ValueError("traffic kinds' shares must add up to 1")
        for k in traffic["kinds"]:
            if set(k["granularity"]) - {"boolean", "count"}:
                raise ValueError("the check compares only boolean and "
                                 "count answers")

    def combos(self) -> list[tuple[int, str, float]]:
        """(kind, granularity, share) of every pairing the mix draws."""
        out = []
        for i, k in enumerate(self.t["kinds"]):
            out += [(i, g, k["share"] * p)
                    for g, p in k["granularity"].items()]
        return out

    def draw(self, rng: random.Random, kind: int, gran: str) -> dict:
        k = self.t["kinds"][kind]
        ds = self.datasets[rng.randrange(len(self.datasets))]
        i = rng.randrange(ds.n_rows)
        p = int(ds.pos[i])
        rp = {"assemblyId": ASSEMBLY, "referenceName": ds.row_chrom(i)}
        shape = k["shape"]
        if shape == "snv_point":
            i = _snv_row(rng, ds)
            p = int(ds.pos[i])
            rp.update(referenceName=ds.row_chrom(i), start=[p - 1],
                      end=[p + len(ds.row_ref(i)) + k.get("end_pad", 5)],
                      referenceBases=ds.row_ref(i),
                      alternateBases=ds.row_alt(i))
        else:
            if shape == "wide":
                dense = max(d.n_rows for d in self.datasets)
                w = int(k["window_factor"] * self.window_cap * GENOME_BP
                        / dense)
                end_pad = 0
            else:
                w = rng.choice(k["widths"])
                end_pad = k.get("end_pad", 10_000)
            lo = p - 1 - (w if k.get("centered") else 0)
            rp["start"] = [max(lo, 0), p - 1 + w]
            rp["end"] = ([0, 1 << 30] if k.get("open_end")
                         else [p - 1, p + w + end_pad])
            if rng.random() < k.get("p_variant_type", 0.0):
                rp["variantType"] = rng.choice(k["variant_types"])
            elif k.get("alt"):
                rp["alternateBases"] = rng.choice(k["alt"])
            if k.get("ref"):
                ref = rng.choice(k["ref"])
                if ref is not None:
                    rp["referenceBases"] = ref
        body = {"meta": {"apiVersion": "2.0"},
                "query": {"requestedGranularity": gran,
                          "includeResultsetResponses": "HIT",
                          "requestParameters": rp}}
        route = k["route"]
        check = {"rp": rp, "granularity": gran,
                 "datasets": [d.dataset_id for d in self.datasets]}
        if route == "dataset":
            path = f"/datasets/{ds.dataset_id}/g_variants"
            check["datasets"] = [ds.dataset_id]
        elif route == "all":
            path = "/g_variants"
        else:
            raise ValueError(f"unknown route {route!r}")
        return {"method": "POST", "path": path, "body": body,
                "check": check}


BLOCK = 200


def draw_requests(gen: Generator, seed: int, n: int) -> list[dict]:
    """``n`` requests; every run of ``BLOCK`` requests holds each
    (kind, granularity) pairing at its share (largest remainders), in an
    order shuffled by the seed, so that the requests a window reaches
    hold the mix at every seed alike."""
    rng = random.Random(seed)
    combos = gen.combos()
    exact = [share * BLOCK for _k, _g, share in combos]
    counts = [int(x) for x in exact]
    for j in sorted(range(len(combos)), key=lambda j: counts[j] - exact[j]
                    )[: BLOCK - sum(counts)]:
        counts[j] += 1
    block = [j for j, c in enumerate(counts) for _ in range(c)]
    out = []
    while len(out) < n:
        order = block[:]
        rng.shuffle(order)
        for j in order[: n - len(out)]:
            kind, gran, _share = combos[j]
            out.append(gen.draw(rng, kind, gran))
    return out


def wire(req: dict) -> list:
    """[method, path, body text]: what a client process sends."""
    return [req["method"], req["path"], json.dumps(req["body"])]
