"""Shared pieces of the port's fleet-plane parity tests.

Every corpus is made twice from the same seeded records: a JAX engine
over ``sbeacon_tpu.index.columnar.build_index`` of them and a port
engine (on the CPU) over ``shard_from_reference`` of the same shard, so
a JAX fleet and a port fleet hold the same bytes. ``Fleet`` starts
``WorkerServer``s of either package (or both) and closes everything it
opened. Responses compare as their ``dumps()`` strings, at tolerance 0.
"""

from __future__ import annotations

import dataclasses
import random

from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.config import EngineConfig as JEngineConfig
from sbeacon_tpu.engine import VariantEngine as JVariantEngine
from sbeacon_tpu.index.columnar import build_index as j_build_index
from sbeacon_tpu.parallel import dispatch as jdispatch
from sbeacon_tpu.testing import random_records
from sbeacon_tpu_torch.config import BeaconConfig, EngineConfig
from sbeacon_tpu_torch.engine import VariantEngine
from sbeacon_tpu_torch.index.columnar import shard_from_reference
from sbeacon_tpu_torch.parallel import dispatch as tdispatch
from sbeacon_tpu_torch.payloads import VariantQueryPayload

SAMPLES = ["S0", "S1"]


def shard(ds: str, seed: int, *, n: int = 120, chrom: str = "1",
          vcf: str | None = None, recs=None):
    """The JAX shard of ``n`` seeded records of dataset ``ds``."""
    if recs is None:
        recs = random_records(random.Random(seed), chrom=chrom, n=n,
                              n_samples=2)
    return j_build_index(recs, dataset_id=ds,
                         vcf_location=vcf or f"{ds}.vcf.gz",
                         sample_names=SAMPLES)


def jax_engine(shards, deltas=(), **engine_kw):
    kw = {"microbatch": False, **engine_kw}
    eng = JVariantEngine(JBeaconConfig(engine=JEngineConfig(**kw)))
    for s in shards:
        eng.add_index(s)
    for s in deltas:
        eng.add_delta(s)
    return eng


def port_engine(shards, deltas=(), **engine_kw):
    kw = {"microbatch": False, **engine_kw}
    eng = VariantEngine(BeaconConfig(engine=EngineConfig(**kw)),
                        device="cpu")
    for s in shards:
        eng.add_index(shard_from_reference(s))
    for s in deltas:
        eng.add_delta(shard_from_reference(s))
    return eng


def payload(ds_list=(), *, chrom="1", granularity="count", include="HIT",
            **kw):
    """The port's payload over every position of ``chrom``."""
    return VariantQueryPayload(
        dataset_ids=list(ds_list), reference_name=chrom, start_min=1,
        start_max=1 << 30, end_min=1, end_max=1 << 30,
        alternate_bases="N", requested_granularity=granularity,
        include_datasets=include, **kw)


def jax_payload(p: VariantQueryPayload):
    """The JAX package's payload of the same fields."""
    from sbeacon_tpu.payloads import VariantQueryPayload as JPayload

    return JPayload(**dataclasses.asdict(p))


def dumps(responses) -> list[str]:
    return [r.dumps() for r in responses]


class Fleet:
    """Worker servers and coordinators of either package; ``close``
    shuts every one down, coordinators first."""

    def __init__(self):
        self.engines: list = []
        self.workers: list = []
        self.coordinators: list = []

    def worker(self, engine, *, jax: bool = False, **kw):
        mod = jdispatch if jax else tdispatch
        self.engines.append(engine)
        w = mod.WorkerServer(engine, **kw).start_background()
        self.workers.append(w)
        return w

    def coordinator(self, urls, *, jax: bool = False, **kw):
        mod = jdispatch if jax else tdispatch
        d = mod.DistributedEngine(list(urls), **kw)
        self.coordinators.append(d)
        return d

    def own(self, engine):
        self.engines.append(engine)
        return engine

    def close(self) -> None:
        for d in self.coordinators:
            d.close()
        for w in self.workers:
            w.shutdown()
            if getattr(w, "thread", None) is not None:
                w.thread.join()
        for e in self.engines:
            close = getattr(e, "close", None)
            if close is not None:
                close()
