"""The pod dispatch tier: one launch over the mesh-sharded fused index.

Counterpart of ``MeshDispatchTier`` of ``sbeacon_tpu/parallel/dispatch.py``
(the rest of that module, the fleet plane, is not ported yet). The
engine's shards stack into a ``parallel.mesh.MeshFusedIndex`` sharded
over the engine's mesh, and a query whose datasets all live on the mesh
costs ONE mesh launch through the engine's micro-batcher
(``submit_many``): the boolean OR, the count and allele sums and the
record-granularity hit rows, and for plane-reading shapes the per-query
sample-mask reduction too.

The delta tail of a served key (the shards ``VariantEngine.add_delta``
published since the stack was built; the base fingerprint, and so the
stack, stays warm) rides beside the mesh launch: the engine's L0 index
answers its covered targets in one launch (``engine.l0_pre_rows``, which
also charges the host-walked ones), and the rest are matched on the
host, as in the JAX package. ``resolve`` and ``search`` note their
``mesh`` plan stage and the request annotations, ``search`` checks the
request deadline, and a launch without the batcher hits the
``kernel.launch`` fault point.

Deliberate differences from the JAX package:

- a failed build, upload or launch raises on the request (a background
  build's failure is raised by the requests that consult the tier until
  the index set changes), where the JAX tier logs it and the caller
  falls back to the thread scatter; so there is no fallback counter and
  no ``mesh.dispatch`` fault site;
- no journal events and no plane-ledger headroom in the ``planes``
  refusal (the ledger's surface comes with the HTTP plane).
"""

from __future__ import annotations

import threading
import time
import weakref

import numpy as np
import torch

from ..harness.faults import fault_point
from ..plan import plan_stage
from ..resilience import current_deadline
from ..telemetry import annotate
from . import mesh as _mesh


class MeshDispatchTier:
    """Pod-local single-launch dispatch over a mesh-sharded fused index.

    The tier is an optimisation a caller consults per query (``resolve``
    then ``search``): dataset groups it cannot serve (stack not built
    yet, stale after a publish, a plane-reading shape the stack cannot
    answer, fewer than ``min_shards`` targets) keep the engine's own
    paths, and each refusal is counted by reason. ``min_shards``
    defaults to the engine config's ``mesh_min_shards``; ``layout`` is
    the stack's output layout (``parallel.mesh.LAYOUT_*``: owner-sharded
    by default, or combined over the entries through the ring gather)."""

    def __init__(self, engine, *, min_shards: int | None = None,
                 axis: str = "d", devices=None,
                 layout: int = _mesh.LAYOUT_OWNER):
        self.engine = engine
        if min_shards is None:
            min_shards = engine.config.engine.mesh_min_shards
        self.min_shards = max(1, int(min_shards))
        self.axis = axis
        self.layout = layout
        self._devices = None if devices is None else list(devices)
        self._lock = threading.Lock()
        # (MeshFusedIndex, {key: sid}, {key: shard}, {ds: [keys]}, fp,
        #  {key: plane_index})
        self._state: tuple | None = None
        self._building = False
        # fingerprint a build declined (too few shards): no rebuild per
        # query for an index set that cannot produce a tier
        self._skip_fp: str | None = None
        # (fingerprint, exception) of a failed background build: raised
        # by every consult until the index set changes
        self._error: tuple | None = None
        self._builds: "weakref.WeakSet[threading.Thread]" = weakref.WeakSet()
        self._dispatches = 0
        self._gather_rows = 0
        # why queries fell off the tier, by reason: planes (a plane shape
        # the stack cannot serve), stale (a publish outran the stack),
        # min_shards (too few local targets), unbuilt (no stack yet,
        # fewer than two mesh entries included)
        self._refusals: dict[str, int] = {}
        # close() raced a background build: the build re-checks this
        # before publishing or registering plane bytes
        self._tier_closed = False
        self._built_at: float | None = None

    # -- availability / build ----------------------------------------------

    def _entries_on_engine(self, mesh) -> int:
        """Mesh entries on the engine's own device, the one its plane
        budget covers: each holds its own copy of a block's planes."""
        return _mesh.entries_on(mesh, self.engine.device)

    def _engine_bytes(self, index) -> int:
        """The stack's plane bytes on the engine's device."""
        return index.plane_bytes_device * self._entries_on_engine(index.mesh)

    def _mesh_devices(self) -> list:
        if self._devices is not None:
            return self._devices
        return _mesh.mesh_devices(self.engine.device)

    def available(self) -> bool:
        """Two or more mesh entries: a one-entry 'pod' would only re-spell
        the fused single-device stack, which the engine already serves."""
        return len(self._mesh_devices()) >= 2

    def _snapshot(self):
        """(keys, shards, planes_of) the stack would build from, via the
        engine's locked snapshot; ``planes_of`` maps keys to the device
        plane index of the same publish."""
        triples = self.engine.index_snapshot()
        return ([k for k, _s, _p in triples], [s for _k, s, _p in triples],
                {k: p for k, _s, p in triples})

    def _ready(self, wait: bool = False):
        """The current state, or None while unbuilt or stale (the caller
        keeps the engine's paths). A stale state arms a background
        rebuild; ``wait=True`` builds inline on the caller's thread. A
        failed background build for the current index set raises."""
        if not self.available():
            return None
        fp = self.engine.base_fingerprint()
        while True:
            with self._lock:
                if self._tier_closed:
                    return None
                state = self._state
                if state is not None and state[4] == fp:
                    return state
                err = self._error
                if err is not None and err[0] == fp and not wait:
                    raise RuntimeError(
                        "the mesh dispatch tier failed to build"
                    ) from err[1]
                if self._skip_fp == fp and not wait:
                    return None
                if not self._building:
                    self._building = True
                    break
                if not wait:
                    return None
            # wait=True with a background build in flight: join it
            # instead of racing a duplicate stack build
            time.sleep(0.05)
        if wait:
            return self._build(fp, inline=True)
        dev = torch.device(self.engine.device)
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        t = threading.Thread(target=self._build_on, args=(fp, dev, stream),
                             name="mesh-tier-build", daemon=True)
        self._builds.add(t)
        t.start()
        return None

    def _build_on(self, fp, dev, stream):
        """The background build, on the engine's device and stream."""
        if stream is None:
            return self._build(fp)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            return self._build(fp)

    def _build(self, fp: str, *, inline: bool = False):
        """Build and publish the stack over the engine's snapshot. The
        plane budget is checked and reserved atomically before the
        build. A failure rolls the reservation back to the stack still
        serving and raises when inline; in the background it is kept for
        the next consult to raise."""
        try:
            state = self._build_state(fp)
        except BaseException as e:
            with self._lock:
                self._error = (fp, e)
                prev = (self._engine_bytes(self._state[0])
                        if self._state is not None else 0)
            self.engine.register_plane_bytes(self, prev)
            if inline:
                raise
            return None
        finally:
            with self._lock:
                self._building = False
        return state

    def _build_state(self, fp):
        keys, shards, planes_of = self._snapshot()
        if len(keys) < self.min_shards:
            with self._lock:
                self._skip_fp = fp
            return None
        mesh = _mesh.make_mesh(devices=self._mesh_devices(), axis=self.axis)
        eng_cfg = self.engine.config.engine
        # the previous stack keeps serving until the new state publishes,
        # so it stays accounted through the build
        with self._lock:
            prev_bytes = (self._engine_bytes(self._state[0])
                          if self._state is not None else 0)
        with_planes = all(s.gt_bits is not None for s in shards)
        if with_planes:
            per_dev = _mesh.MeshFusedIndex.plane_bytes_per_device(
                shards, n_dev=mesh.size)
            # atomic check-and-reserve BEFORE the build: a per-dataset
            # upload admitted mid-build sees these bytes
            with_planes = self.engine.try_reserve_plane_bytes(
                self, prev_bytes + per_dev * self._entries_on_engine(mesh),
                eng_cfg.plane_hbm_budget_gb * 1e9)
        index = _mesh.MeshFusedIndex(
            shards, mesh, axis=self.axis, with_planes=with_planes,
            layout=self.layout,
        )
        for dev in {d for d in mesh.devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)  # the uploads are on the card
        sid_of = {k: i for i, k in enumerate(keys)}
        keys_by_ds: dict[str, list] = {}
        for k in keys:
            keys_by_ds.setdefault(k[0], []).append(k)
        state = (index, sid_of, dict(zip(keys, shards)), keys_by_ds, fp,
                 planes_of)
        reg = self.engine.register_plane_bytes
        with self._lock:
            if self._tier_closed:
                reg(self, 0)
                return None
            self._state = state
            self._error = None
            self._built_at = time.time()
        # settle the budget on the new stack alone (a plane-less rebuild
        # releases the old stack's bytes)
        reg(self, self._engine_bytes(index))
        with self._lock:
            raced_close = self._tier_closed
        if raced_close:
            reg(self, 0)
            return None
        return state

    def close(self) -> None:
        """Drop the state and release the stack's plane bytes from the
        engine's budget ledger; an in-flight background build sees the
        flag and discards itself, and is joined here."""
        with self._lock:
            self._tier_closed = True
            self._state = None
        for t in list(self._builds):
            t.join()
        self.engine.register_plane_bytes(self, 0)

    def warmup(self) -> int:
        """Build inline and launch the tier once (and once with planes
        when the stack holds them), which builds and loads its kernels;
        returns the launch count (0 when the tier cannot engage)."""
        from ..ops.kernel import QuerySpec, encode_queries

        state = self._ready(wait=True)
        if state is None:
            return 0
        index = state[0]
        eng = self.engine.config.engine
        spec = QuerySpec("1", 1, 1, 1, 2)
        # one query per entry that owns a shard
        sids = [g * index.d_local for g in range(index.n_dev)
                if g * index.d_local < index.n_shards]
        kw = [{}]
        if index.has_planes:
            kw.append(dict(
                sample_masks=np.zeros((len(sids), index.plane_words),
                                      np.uint32),
                mask_counts=np.zeros(len(sids), np.bool_),
            ))
        for extra in kw:
            index.run_mesh_queries(
                encode_queries([spec] * len(sids), shard_ids=sids),
                window_cap=eng.window_cap, record_cap=eng.record_cap, **extra,
            )
        return len(kw)

    # -- per-query consult ---------------------------------------------------

    def _note_refusal(self, reason: str) -> None:
        with self._lock:
            self._refusals[reason] = self._refusals.get(reason, 0) + 1

    def resolve(self, dataset_ids, payload) -> set:
        """The subset of ``dataset_ids`` this tier serves for this query:
        empty when it should not engage (unbuilt or stale stack, a plane
        shape the stack cannot answer, below ``min_shards``), each
        refusal counted by reason."""
        if not dataset_ids:
            return set()
        # read before _ready: a background build it arms may publish a
        # state before the refusal is counted
        with self._lock:
            built = self._state is not None
        state = self._ready()
        if state is None:
            reason = "stale" if built else "unbuilt"
            self._note_refusal(reason)
            plan_stage("mesh", decision="refused", reason=reason)
            return set()
        index = state[0]
        if self.engine._wants_planes(payload):
            # plane shapes ride the launch when the stack carries the
            # planes AND device row matching is exact for this query (an
            # N-wildcard ref needs host semantics; payload doubles as the
            # spec, only reference_bases is read)
            if not (index.has_planes
                    and self.engine._device_ref_ok(payload, payload)):
                self._note_refusal("planes")
                plan_stage("mesh", decision="refused", reason="planes",
                           has_planes=bool(index.has_planes))
                return set()
        keys_by_ds = state[3]
        covered = {ds for ds in dataset_ids if ds in keys_by_ds}
        n_targets = sum(len(keys_by_ds[ds]) for ds in covered)
        if n_targets < self.min_shards:
            self._note_refusal("min_shards")
            plan_stage("mesh", decision="refused", reason="min_shards",
                       targets=n_targets, min_shards=self.min_shards)
            return set()
        return covered

    def search(self, payload, dataset_ids) -> list:
        """Answer ``dataset_ids`` (a :meth:`resolve` result) with one mesh
        launch for the stacked base shards, then their delta tail: the
        base responses in sorted key order, the tail's after them.
        Raises on any failure."""
        from ..engine import host_match_rows, materialize_response
        from ..ops.kernel import QuerySpec, encode_queries
        from ..ops.plane_kernel import sample_mask_words

        current_deadline().check("mesh.dispatch")
        with self._lock:
            state = self._state
        if state is None:
            raise RuntimeError("mesh tier state gone")
        index, sid_of, shard_of, keys_by_ds, _fp, planes_of = state
        plane_q = self.engine._wants_planes(payload)
        spec_base = QuerySpec(
            chrom=payload.reference_name,
            start_min=payload.start_min,
            start_max=payload.start_max,
            end_min=payload.end_min,
            end_max=payload.end_max,
            reference_bases=payload.reference_bases,
            alternate_bases=payload.alternate_bases,
            variant_type=payload.variant_type,
            variant_min_length=payload.variant_min_length,
            variant_max_length=payload.variant_max_length,
        )
        targets = []
        for ds in sorted(dataset_ids):
            for key in keys_by_ds.get(ds, ()):
                shard = shard_of[key]
                native = shard.meta.get("chrom_native", {}).get(
                    payload.reference_name)
                if native is None:
                    continue  # no matching chromosome in this VCF
                targets.append((key, shard, native, sid_of[key]))
        # the delta tail: shards published since the stack was built (the
        # base fingerprint did not move, so the stack is not stale)
        delta_targets = []
        for ds, vcf, (shard, _di, pl) in self.engine.indexes_for(
                sorted(dataset_ids)):
            if (ds, vcf) in sid_of:
                continue  # base rows: the mesh launch serves them
            native = shard.meta.get("chrom_native", {}).get(
                payload.reference_name)
            if native is None:
                continue
            delta_targets.append(((ds, vcf), shard, native, pl))
        if not targets and not delta_targets:
            return []
        eng = self.engine.config.engine
        specs = [spec_base] * len(targets)
        sids = [sid for _k, _s, _n, sid in targets]
        sel_idx_of: dict = {}
        masks = mask_counts = None
        if plane_q:
            # per-query sample masks, sliced WITH the batch: the owning
            # entry reduces each query's matched rows under ITS mask.
            # Selected samples restrict to the named samples (with
            # genotype-derived counting when the count planes are
            # stacked); extraction takes the full-cohort mask and keeps
            # the INFO-column counts
            W = index.plane_words
            masks = np.zeros((len(targets), W), np.uint32)
            mask_counts = np.zeros(len(targets), np.bool_)
            for i, (key, shard, _native, _sid) in enumerate(targets):
                if payload.selected_samples_only:
                    sel = self.engine._selected_idx(shard, payload, key[0])
                    sel_idx_of[key] = sel
                    masks[i] = sample_mask_words(sel, W)
                    mask_counts[i] = index.has_count_planes
                else:
                    masks[i] = 0xFFFFFFFF
        responses = []
        gathered = 0
        batcher = self.engine.batcher
        if not targets:
            res = None
        elif batcher is not None:
            res = batcher.submit_many(
                index, specs, shard_ids=sids, window_cap=eng.window_cap,
                record_cap=eng.record_cap, sample_masks=masks,
                mask_counts=mask_counts,
            )
        else:
            fault_point("kernel.launch")
            res = index.run_mesh_queries(
                encode_queries(specs, shard_ids=sids),
                window_cap=eng.window_cap, record_cap=eng.record_cap,
                sample_masks=masks, mask_counts=mask_counts,
            )
        for i, (key, shard, native, _sid) in enumerate(targets):
            fused = None
            if res.overflow[i] or res.n_matched[i] > eng.record_cap:
                # window/record overflow: the uncapped host matcher, the
                # contract of every device kernel path
                rows = host_match_rows(
                    shard, spec_base,
                    ref_wildcard=payload.selected_samples_only,
                )
            else:
                keep = res.rows[i] >= 0
                rows = res.rows[i][keep]
                gathered += int(rows.size)
                # the fused triple is exact for this shard only when its
                # count-plane availability matches the stack-wide one (a
                # shard WITH count planes in a stack without them was
                # counted full-cohort); extraction shapes read only
                # or_words, which the count planes do not change
                if plane_q and res.or_words is not None and (
                    not payload.selected_samples_only
                    or index.has_count_planes
                    or not shard.has_count_planes
                ):
                    # or_words come back stack-wide (the widest shard's
                    # W): materialise in this shard's own width (its tail
                    # words are zero by construction)
                    w_shard = shard.gt_bits.shape[1]
                    fused = (
                        res.pc_call[i][keep],
                        res.pc_tok[i][keep],
                        np.asarray(res.or_words[i]).view(np.uint32)[:w_shard],
                    )
            responses.append(materialize_response(
                shard, rows, payload, chrom_label=native, dataset_id=key[0],
                vcf_location=key[1], selected_idx=sel_idx_of.get(key),
                plane_index=planes_of.get(key) if plane_q else None,
                fused=fused,
            ))
        # the tail: the engine's L0 index first (one launch for every
        # covered target; it charges the host-walked ones), the rest on
        # the host
        l0_rows = (
            self.engine.l0_pre_rows(
                [(key, shard) for key, shard, _n, _p in delta_targets],
                spec_base, payload,
            )
            if delta_targets else {}
        )
        l0_covered = sum(1 for v in l0_rows.values() if v is not None)
        for key, shard, native, pl in delta_targets:
            rows = l0_rows.get(key)
            if rows is None:
                rows = host_match_rows(
                    shard, spec_base,
                    ref_wildcard=payload.selected_samples_only,
                )
            responses.append(materialize_response(
                shard, rows, payload, chrom_label=native, dataset_id=key[0],
                vcf_location=key[1],
                selected_idx=(
                    self.engine._selected_idx(shard, payload, key[0])
                    if payload.selected_samples_only else None
                ),
                plane_index=pl if plane_q else None,
            ))
        with self._lock:
            self._dispatches += 1
            self._gather_rows += gathered
        annotate(mesh_shards=len(targets), mesh_delta_tail=len(delta_targets),
                 mesh_tail_l0=l0_covered, mesh_planes=plane_q)
        plan_stage("mesh", decision="served", shards=len(targets),
                   delta_tail=len(delta_targets), tail_l0=l0_covered,
                   planes=plane_q)
        return responses

    def stats(self) -> dict:
        with self._lock:
            state = self._state
            built_at = self._built_at
            out = {
                "dispatches": self._dispatches,
                "gather_rows": self._gather_rows,
                "refusals": dict(self._refusals),
            }
        out["ready"] = state is not None
        out["shards"] = len(state[1]) if state is not None else 0
        out["devices"] = state[0].n_dev if state is not None else 0
        out["planes"] = bool(state[0].has_planes) if state else False
        out["fingerprint"] = state[4] if state is not None else ""
        out["ageS"] = (
            round(time.time() - built_at, 1)
            if state is not None and built_at is not None
            else None
        )
        return out
