"""Dataset-sharded query execution over a mesh of devices.

Counterpart of ``sbeacon_tpu/parallel/mesh.py`` (``make_mesh``,
``StackedIndex``, ``plane_budget_verdict``, ``_plane_reduce``,
``sharded_query``, ``sharded_selected_query``, ``MeshFusedIndex`` with
``MeshPendingResults``, which ``run_mesh_queries(async_fetch=True)``
returns undrained). Its XLA programs ``_local_query`` and
``_local_selected``, the per-device body of a ``shard_map`` (a grid of
local dataset x query running ``_query_one``, the sums over the local
datasets and one ``psum``), and ``_local_fused_query``, the per-device
body of the mesh-sharded fused index, are replaced by three
hand-written CUDA kernels:

- ``csrc/stacked_query.cu`` (wrapper ``stacked_query``, twin
  ``local_query_reference``), the query-only body;
- ``csrc/stacked_selected.cu`` (wrapper ``stacked_selected``, twin
  ``local_selected_reference``), the selected-samples body, whose plane
  reduction ``_plane_reduce`` is the block routine ``csrc/plane_reduce.cuh``
  (twin ``plane_reduce_reference``);
- ``csrc/mesh_fused.cu`` (wrapper ``mesh_fused``, twin
  ``local_fused_reference``), one mesh entry's part of
  ``MeshFusedIndex.run_mesh_queries``: ownership, the search over the
  entry's fused block, the ``seg_base`` rebase and the per-query-mask
  plane reduction, written in the owner, sliced-combine or replicated
  layout. The combine layouts then fan in on the first entry
  (``_fan_in``) and through the ring gather ``ops.gather_kernel`` (P1).

All three answer the bisection kernel's per-query semantics
(``csrc/bisect_core.cuh``), and the stacked ones fold the cross-dataset
sums into the same launch: both through one cluster of blocks per
query whose leader sums the blocks' partials, with the search and lane
loads of ``csrc/stacked_core.cuh``. A wrapper launches on
a CUDA tensor (or raises) and runs the twin on a CPU tensor; every CUDA
launch adds one to its launch count (``stacked_query_launches``,
``stacked_selected_launches``, ``mesh_fused_launches``).

The mesh is an ordered tuple of ``torch.device`` s, each entry owned by
one OS process (``Mesh.ranks``). ``StackedIndex`` builds the host stack
byte for byte as the JAX package does; ``shard_to_mesh`` gives mesh
entry g the datasets ``[g * d_local, (g + 1) * d_local)``, uploading only
the entries this process owns. ``sharded_query`` /
``sharded_selected_query`` make one launch per local entry over its
block, and the ``psum`` (``_psum``) is the sum of the local entries'
``[B]`` partials, then, over a mesh that spans processes, one
``torch.distributed.all_reduce`` across the world.

Multi-process compute (JAX's ``jax.distributed``): after
``parallel.dispatch.init_multihost`` this module holds the world
(``world()``: rank, size, backend, every rank's local entries) and
``make_mesh()`` returns the global mesh, entries rank-major. Every
process makes the same calls; the cross-dataset aggregates come back
equal in every process, and the per-dataset leaves, which live on their
owning processes, are refused (``aggregates_only=True``), as JAX's
multi-controller contract has it.

Deliberate differences from the JAX package: ``plane_bytes_per_device``
counts the card's real ``W * 4`` bytes a row (a CUDA tensor has no
128-lane padding), the engine's mesh leg stays process-local
(``mesh_devices``: a serving engine cannot run collectives in lockstep
with other processes) and raises where JAX falls back to thread
scatter, ``MeshFusedIndex`` refuses a mesh that spans processes (JAX
asserts single-controller in its owner-sharded fetch) and pads neither
its slices nor its replicated batch to a tier (see its docstring).
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from ..index.columnar import (
    FLAG,
    N_CHROM_CODES,
    VariantIndexShard,
    stack_shard_columns,
)
from ..ops import _build
from ..ops.gather_kernel import gather_partials_many
from ..ops.kernel import (
    _SMEM_MAX,
    COLUMNS,
    C_AC,
    C_AN,
    C_FLAGS,
    C_REC_ID,
    N_AGG,
    N_QFIELDS,
    DeviceIndex,
    QueryResults,
    _upload_columns,
    _wrap32,
    bisect_iters,
    encode_queries,
    pack_queries,
    pad_shard_columns,
    padded_rows,
    query_batch_reference,
    stage_readback,
    stage_upload,
    window_hint_for,
)
from ..ops.plane_kernel import or_reduce, popcount32, staged_upload
from ..telemetry import (
    add_total,
    launch_count,
    note_device_stage,
    record_device_launch,
    total,
)

AXIS = "d"
QUERY_KERNEL = "stacked_query"
SELECTED_KERNEL = "stacked_selected"
#: aggregate columns of stacked_query: call_count, all_alleles_count,
#: n_variants, n_datasets_hit, n_overflow
N_STACK_AGG = 5
#: per-dataset scalars of stacked_selected: call_count,
#: all_alleles_count, overflow, n_matched
N_SEL_SCAL = 4
#: aggregate columns of stacked_selected: call_count,
#: all_alleles_count, n_overflow
N_SEL_AGG = 3


def __getattr__(name: str):
    """Counters since the last ``telemetry.reset_launch_counts()``:

    - ``stacked_query_launches`` / ``stacked_selected_launches`` /
      ``mesh_fused_launches``: CUDA launches of the three mesh kernels;
    - ``N_LAUNCHES``: calls of ``MeshFusedIndex.run_mesh_queries`` (one
      mesh program each, whatever the kernel launches under it; a plain
      total, not a launch count);
    - ``N_EVALUATED_PAIRS``: evaluated (entry, query-slot) pairs summed
      over the mesh per launch (the replicated layout evaluates batch x
      n_dev pairs, the sliced layout about the batch).
    """
    if name == "stacked_query_launches":
        return launch_count(QUERY_KERNEL)
    if name == "stacked_selected_launches":
        return launch_count(SELECTED_KERNEL)
    if name == "mesh_fused_launches":
        return launch_count(FUSED_KERNEL)
    if name == "N_LAUNCHES":
        return total(MESH_PROGRAM)
    if name == "N_EVALUATED_PAIRS":
        return total("mesh_evaluated_pairs")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass(frozen=True)
class World:
    """The process group ``parallel.dispatch.init_multihost`` joined:
    this process's ``rank``, the world ``size``, the ``backend`` of its
    collectives and ``entries``, each rank's local mesh entries in rank
    order."""

    rank: int
    size: int
    backend: str
    entries: tuple


_world: World | None = None
#: one collective at a time from this process (JAX's
#: ``_collective_guard``): request threads never interleave their
#: all_reduces on the process group; every rank must still make them in
#: the same order
_COLLECTIVE_LOCK = threading.Lock()


def world() -> World | None:
    """The process group this process joined, None before
    ``init_multihost`` (and after ``shutdown_multihost``)."""
    return _world


def set_world(w: World | None) -> None:
    """Record (or, with None, forget) the process group; called by
    ``parallel.dispatch.init_multihost`` / ``shutdown_multihost``."""
    global _world
    _world = w


class Mesh:
    """A 1-D mesh: an ordered tuple of devices along one named axis, entry
    g owned by the process of rank ``ranks[g]`` (every entry this
    process's by default)."""

    def __init__(self, devices, axis: str = AXIS, *, ranks=None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis = axis
        w = world()
        #: this process's rank
        self.rank = 0 if w is None else w.rank
        self.ranks = (tuple(int(r) for r in ranks) if ranks is not None
                      else (self.rank,) * len(self.devices))
        if len(self.ranks) != len(self.devices):
            raise ValueError(f"{len(self.ranks)} ranks for "
                             f"{len(self.devices)} mesh entries")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def spans_processes(self) -> bool:
        """Whether another process owns any entry: the fan-in then runs a
        collective across the world."""
        return any(r != self.rank for r in self.ranks)

    def local_entries(self) -> list[int]:
        """The indices of this process's entries, in mesh order."""
        return [g for g, r in enumerate(self.ranks) if r == self.rank]

    def __repr__(self) -> str:
        ranks = f", ranks={list(self.ranks)}" if self.spans_processes else ""
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis!r}{ranks})")


def make_mesh(n_devices: int | None = None, axis: str = AXIS, *,
              devices=None) -> Mesh:
    """1-D device mesh. ``devices`` is an ordered list of this process's
    devices; by default, after ``init_multihost``, the global mesh over
    every rank's entries (rank-major, as ``jax.devices()`` orders them by
    process), and before it every visible CUDA device (without one this
    raises as ``ops.resolve_device`` does). ``n_devices`` truncates to a
    prefix; an empty selection is an error."""
    ranks = None
    w = world()
    if devices is None and w is not None:
        devices = [d for ents in w.entries for d in ents]
        ranks = [r for r, ents in enumerate(w.entries) for _ in ents]
    elif devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU — "
                "pass devices=[torch.device('cpu')] to build a CPU mesh"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} available"
            )
        devices = devices[:n_devices]
        ranks = None if ranks is None else ranks[:n_devices]
    if not devices:
        raise ValueError("make_mesh: 0 devices selected")
    return Mesh(devices, axis, ranks=ranks)


def mesh_devices(device) -> list[torch.device]:
    """The devices an engine on ``device`` builds its mesh over: every
    visible CUDA device for a CUDA engine, ``[device]`` for a CPU one.
    The engine takes its mesh leg only when this lists two or more."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


@dataclasses.dataclass
class StackBlock:
    """One mesh device's block of the stack, in the kernels' layout:
    ``columns`` int32 [d_local, 11, n_pad], ``alt_prefix`` int32
    [d_local, n_pad, 4], ``offsets`` int32 [d_local, 27] and, with
    planes, ``planes`` = (gt,) or (gt, gt2, tok1, tok2), each int32
    [d_local * n_pad, W] (dataset d's row r is row d * n_pad + r)."""

    device: torch.device
    columns: torch.Tensor
    alt_prefix: torch.Tensor
    offsets: torch.Tensor
    planes: tuple | None = None

    @property
    def n_datasets(self) -> int:
        return self.columns.shape[0]

    @property
    def n_pad(self) -> int:
        return self.columns.shape[2]


class StackedIndex:
    """D dataset shards padded to a common row count and stacked: [D, Np].

    The stack is the unit the mesh shards: axis 0 is partitioned over
    the mesh. D is padded up to ``n_datasets_padded`` with empty datasets
    (all-zero chrom_offsets: no query ever selects a row). ``arrays``
    holds the host stack, byte for byte the JAX package's."""

    def __init__(
        self,
        shards: list[VariantIndexShard],
        *,
        n_datasets_padded: int | None = None,
        pad_unit: int = DeviceIndex.PAD_UNIT,
        with_planes: bool = False,
    ):
        if not shards:
            raise ValueError("StackedIndex needs at least one shard")
        self.shards = shards
        d = len(shards)
        d_pad = n_datasets_padded or d
        if d_pad < d:
            raise ValueError("n_datasets_padded < number of shards")
        n_max = max(s.n_rows for s in shards)
        n_pad = padded_rows(n_max, pad_unit)
        self.n_datasets = d
        self.n_datasets_padded = d_pad
        self.n_padded = n_pad

        per = [pad_shard_columns(s, n_pad) for s in shards]
        names = [k for k in per[0] if k != "chrom_offsets"]
        self.arrays = {}
        for name in names:
            mats = [p[name] for p in per]
            # padding datasets reuse shard 0's padded tail row, whose
            # values are the canonical fills; their all-zero
            # chrom_offsets make them unreachable regardless
            fill = mats[0][-1]
            self.arrays[name] = np.stack(
                mats + [np.full_like(mats[0], fill)] * (d_pad - d)
            )
        self.arrays["chrom_offsets"] = np.stack(
            [p["chrom_offsets"] for p in per]
            + [np.zeros(N_CHROM_CODES + 1, np.int32)] * (d_pad - d)
        )
        self.n_iters = bisect_iters(n_pad)

        # genotype planes, stacked WITH their datasets: W is the widest
        # shard's, and absent planes stack as zeros for padding datasets
        self.plane_words = 0
        self.has_planes = False
        self.has_count_planes = False
        if with_planes and all(s.gt_bits is not None for s in shards):
            W = max(s.gt_bits.shape[1] for s in shards)
            self.plane_words = W
            self.has_planes = True
            self.has_count_planes = all(s.has_count_planes for s in shards)

            def stackp(attr):
                # one preallocated block: per-shard padded copies and
                # np.stack would hold a multi-GB plane set twice
                out = np.zeros((d_pad, n_pad, W), np.uint32)
                for di, sh in enumerate(shards):
                    a = getattr(sh, attr)
                    out[di, : a.shape[0], : a.shape[1]] = a
                return out.view(np.int32)

            self.arrays["plane_gt"] = stackp("gt_bits")
            if self.has_count_planes:
                self.arrays["plane_gt2"] = stackp("gt_bits2")
                self.arrays["plane_tok1"] = stackp("tok_bits1")
                self.arrays["plane_tok2"] = stackp("tok_bits2")

    @classmethod
    def plane_bytes_per_device(
        cls,
        shards,
        *,
        n_datasets_padded: int,
        n_mesh: int,
        pad_unit: int = DeviceIndex.PAD_UNIT,
    ) -> int:
        """Device bytes the stacked genotype planes take on each mesh
        device (row padding, the widest shard's W, the count-plane
        multiplicity). The card's real ``W * 4`` bytes a row: the JAX
        package counts XLA's 128-lane padding of W instead."""
        if not shards or any(s.gt_bits is None for s in shards):
            return 0
        W = max(s.gt_bits.shape[1] for s in shards)
        n_pad = padded_rows(max(s.n_rows for s in shards), pad_unit)
        n_planes = 4 if all(s.has_count_planes for s in shards) else 1
        return -(-n_datasets_padded // n_mesh) * n_pad * W * 4 * n_planes

    def shard_to_mesh(self, mesh: Mesh) -> list[StackBlock]:
        """Upload the stack, mesh entry g taking datasets
        ``[g * d_local, (g + 1) * d_local)``; the planes go up through
        ``ops.plane_kernel.staged_upload``. Only this process's entries
        are uploaded (``Mesh.local_entries``, all of them on a
        process-local mesh), a block each in mesh order."""
        n_dev = mesh.size
        if self.n_datasets_padded % n_dev:
            raise ValueError(
                f"{self.n_datasets_padded} stacked datasets do not split "
                f"over {n_dev} mesh devices"
            )
        dl = self.n_datasets_padded // n_dev
        n_pad = self.n_padded
        plane_names = ["plane_gt"]
        if self.has_count_planes:
            plane_names += ["plane_gt2", "plane_tok1", "plane_tok2"]
        blocks = []
        for g in mesh.local_entries():
            dev = mesh.devices[g]
            sl = slice(g * dl, (g + 1) * dl)
            cols = np.stack([self.arrays[name][sl] for name in COLUMNS],
                            axis=1).astype(np.int32, copy=False)
            columns = torch.from_numpy(cols).to(dev)
            del cols
            alt = self.arrays["alt_prefix"][sl].view(np.int32)
            planes = None
            if self.has_planes:
                planes = tuple(
                    staged_upload(
                        self.arrays[name][sl].reshape(dl * n_pad, -1), dev
                    )
                    for name in plane_names
                )
            blocks.append(StackBlock(
                device=dev,
                columns=columns,
                alt_prefix=torch.from_numpy(np.ascontiguousarray(alt)).to(dev),
                offsets=torch.from_numpy(np.ascontiguousarray(
                    self.arrays["chrom_offsets"][sl])).to(dev),
                planes=planes,
            ))
        return blocks


def _device_key(dev) -> tuple:
    """(type, index) with a CUDA device's missing index read as the
    current device, so ``cuda`` and ``cuda:0`` compare equal."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return ("cuda", torch.cuda.current_device())
    return (dev.type, dev.index)


def entries_on(mesh: Mesh, device) -> int:
    """Mesh entries on ``device``: each holds its own copy of its block
    (a mesh may list one card more than once), so a plane budget on that
    device counts the per-entry bytes this many times."""
    own = _device_key(device)
    return sum(_device_key(d) == own for d in mesh.devices)


def plane_budget_verdict(
    per_device_bytes: int, resident_bytes: int, budget_bytes: float
) -> dict:
    """The plane-budget gate's decision with its evidence: whether the
    stacked planes fit next to what is already resident, and the
    headroom either way."""
    budget = int(budget_bytes)
    return {
        "fits": per_device_bytes + resident_bytes <= budget,
        "perDeviceBytes": int(per_device_bytes),
        "residentBytes": int(resident_bytes),
        "budgetBytes": budget,
        "headroomBytes": budget - resident_bytes - per_device_bytes,
    }


# -- the query-only body (J7) ---------------------------------------------


def _dataset_query(columns, alt_prefix, offsets, qpack, d, **kw):
    """``query_batch_reference`` over dataset d of a block: its columns
    and its segment row (the twin clamps the shard field into a
    one-row table)."""
    return query_batch_reference(
        columns[d], alt_prefix[d], offsets[d : d + 1], qpack, **kw
    )


def local_query_reference(
    columns, alt_prefix, offsets, qpack, *, window_cap, record_cap, n_iters
):
    """Plain-PyTorch twin of the stacked query kernel: JAX's
    ``_local_query`` (a vmap of ``_query_one`` over datasets and
    queries), as ``query_batch_reference`` once per local dataset, then
    the int32 sums over datasets.

    ``columns`` int32 [d_local, 11, n_pad], ``alt_prefix`` int32
    [d_local, n_pad, 4], ``offsets`` int32 [d_local, 27], ``qpack`` int32
    [B, N_QFIELDS]. Returns (out int32 [d_local, B, N_AGG + R], laid out
    as ``query_batch_reference`` returns it per dataset; agg int32 [B, 5]:
    call_count, all_alleles_count, n_variants, n_datasets_hit,
    n_overflow)."""
    kw = dict(window_cap=window_cap, record_cap=record_cap, n_iters=n_iters)
    out = torch.stack([
        _dataset_query(columns, alt_prefix, offsets, qpack, d, **kw)
        for d in range(columns.shape[0])
    ])
    sums = out[:, :, [1, 3, 2, 0, 5]].long().sum(dim=0)
    return out, _wrap32(sums)


def _check_inputs(dev, tensors):
    for name, x, shape in tensors:
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {dev}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} shape {tuple(x.shape)} != {tuple(shape)}")


def _window(window_cap, record_cap):
    W = int(window_cap)
    R = min(int(record_cap), W)
    if W < 1 or R < 1:
        raise ValueError(f"window_cap={window_cap}, record_cap={record_cap}: "
                         "both must be at least 1")
    return W, R


def stacked_query(
    columns, alt_prefix, offsets, qpack, *, window_cap, record_cap, n_iters
):
    """The stacked query kernel over one mesh device's block: (out, agg,
    seq), laid out as ``local_query_reference`` returns them.

    CUDA tensors launch ``csrc/stacked_query.cu`` on the current stream
    (asynchronously) and record the launch, ``seq`` being its launch
    record. CPU tensors run ``local_query_reference`` and ``seq`` is
    None. Any other device, or inputs the kernel does not take, raise.
    ``n_iters`` is the twin's bisection depth; the kernel's search ends
    by itself."""
    if columns.device.type == "cpu":
        out, agg = local_query_reference(
            columns, alt_prefix, offsets, qpack, window_cap=window_cap,
            record_cap=record_cap, n_iters=n_iters,
        )
        return out, agg, None
    if columns.device.type != "cuda":
        raise ValueError(f"stacked_query runs on cuda or cpu, not {columns.device}")
    dev = columns.device
    dl, _n_cols, n_pad = columns.shape
    b = qpack.shape[0]
    _check_inputs(dev, (
        ("columns", columns, (dl, len(COLUMNS), n_pad)),
        ("alt_prefix", alt_prefix, (dl, n_pad, 4)),
        ("offsets", offsets, (dl, N_CHROM_CODES + 1)),
        ("qpack", qpack, (b, N_QFIELDS)),
    ))
    W, R = _window(window_cap, record_cap)
    if 5 * W > _SMEM_MAX:
        raise ValueError(
            f"unsupported window_cap={window_cap}: the kernel keeps 5 bytes "
            f"per window lane in at most {_SMEM_MAX} bytes of shared memory"
        )
    out = torch.empty((dl, b, N_AGG + R), dtype=torch.int32, device=dev)
    if b == 0 or dl == 0:
        return out, torch.zeros((b, N_STACK_AGG), dtype=torch.int32,
                                device=dev), None
    # the launch writes every word of agg: no fill before it
    agg = torch.empty((b, N_STACK_AGG), dtype=torch.int32, device=dev)
    lib = _build.load(QUERY_KERNEL)
    t0 = time.perf_counter()
    with torch.cuda.device(dev):
        rc = lib.stacked_query_launch(
            columns.data_ptr(), n_pad, alt_prefix.data_ptr(),
            offsets.data_ptr(), dl, qpack.data_ptr(), b, out.data_ptr(),
            agg.data_ptr(), W, R, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"stacked_query launch failed: CUDA error {rc}")
    seq = record_device_launch(
        QUERY_KERNEL, family="mesh", device=str(dev), datasets=dl, specs=b,
        window=W, record_cap=R, launch_ms=(time.perf_counter() - t0) * 1e3,
    )
    return out, agg, seq


# -- the plane reduction (J5) and the selected body (J7) --------------------


def plane_reduce_reference(
    flags_r, ac_r, an_r, rec_r, gt, gt2, tok1, tok2, valid, *,
    has_counts, use_counts=None,
):
    """Plain-PyTorch twin of ``csrc/plane_reduce.cuh``: an op-by-op
    mirror of ``sbeacon_tpu/parallel/mesh.py::_plane_reduce``.

    Batch-leading inputs: ``flags_r``/``ac_r``/``an_r``/``rec_r`` int32
    [B, R] row gathers, ``gt``/``gt2``/``tok1``/``tok2`` int32 [B, R, W]
    plane gathers already ANDed with each query's sample mask (the last
    three may be None without ``has_counts``), ``valid`` bool [B, R] the
    real-row mask. ``use_counts`` is None (all True) or a bool [B]
    switch: False rows take the INFO-column AC/AN. Returns a dict of
    int32 tensors: call_count [B], all_alleles_count [B], or_words
    [B, W], pc_call and pc_tok [B, R] (zero where not valid). Sums and
    scans are int32 with wraparound."""
    i32 = torch.int32
    pcw = lambda x: popcount32(x).sum(dim=-1).to(i32)
    if has_counts:
        pc_call = pcw(gt) + pcw(gt2)
        pc_tok = pcw(tok1) + pcw(tok2)
        use_gt = (flags_r & FLAG.AC_INFO) == 0
        use_an = (flags_r & FLAG.AN_INFO) == 0
        if use_counts is not None:
            use_gt = use_gt & use_counts[:, None]
            use_an = use_an & use_counts[:, None]
        rc = torch.where(use_gt, pc_call, ac_r)
        an_eff = torch.where(use_an, pc_tok, an_r)
    else:
        pc_call = torch.zeros_like(ac_r)
        pc_tok = torch.zeros_like(ac_r)
        rc = ac_r
        an_eff = an_r
    vi = valid.to(i32)
    rc = rc * vi
    call_count = _wrap32(rc.long().sum(dim=1))

    # record boundaries among the matched rows: invalid lanes take an
    # impossible record id, so no segment crosses the valid/padding edge
    rec_eff = torch.where(valid, rec_r, -2)
    ones = torch.ones_like(valid[:, :1])
    first = valid & torch.cat([ones, rec_eff[:, 1:] != rec_eff[:, :-1]], 1)
    alleles = _wrap32(torch.where(first, an_eff, 0).long().sum(dim=1))

    # the sample-hit OR over materialize_response's grp >= k0 subset:
    # the forward segmented scans, then the flipped pass
    c = _wrap32(torch.cumsum(rc.long(), dim=1))
    before = _wrap32(c.long() - rc.long())
    base = torch.cummax(torch.where(first, before, -1), dim=1).values
    fwd_any = _wrap32(c.long() - base.long()) > 0
    rc_f = torch.flip(rc, [1])
    rec_f = torch.flip(rec_eff, [1])
    first_f = torch.flip(valid, [1]) & torch.cat(
        [ones, rec_f[:, 1:] != rec_f[:, :-1]], 1
    )
    c_f = _wrap32(torch.cumsum(rc_f.long(), dim=1))
    base_f = torch.cummax(
        torch.where(first_f, _wrap32(c_f.long() - rc_f.long()), -1), dim=1
    ).values
    bwd_any = torch.flip(_wrap32(c_f.long() - base_f.long()) > 0, [1])
    or_sel = valid & ((base > 0) | fwd_any | bwd_any)
    or_words = or_reduce(
        torch.where(or_sel[:, :, None], gt, torch.zeros_like(gt)), 1
    )
    return {
        "call_count": call_count,
        "all_alleles_count": alleles,
        "or_words": or_words,
        "pc_call": pc_call * vi,
        "pc_tok": pc_tok * vi,
    }


def local_selected_reference(
    columns, alt_prefix, offsets, gt, gt2, tok1, tok2, masks, qpack, *,
    window_cap, record_cap, n_iters, has_counts,
):
    """Plain-PyTorch twin of the stacked selected kernel: JAX's
    ``_local_selected`` per local dataset (``query_batch_reference``,
    the gathers of the matched rows' columns and of their plane rows ANDed
    with the dataset's mask, ``plane_reduce_reference``, the record_cap
    truncation flag), then the int32 sums over datasets.

    Inputs as ``local_query_reference``'s, plus the planes int32
    [d_local * n_pad, W] (``gt`` for all four without counts) and
    ``masks`` int32 [d_local, W]. Returns (scal int32 [d_local, B, 4]:
    call_count, all_alleles_count, overflow, n_matched; rows, pc_call,
    pc_tok int32 [d_local, B, R]; or_words int32 [d_local, B, W]; agg
    int32 [B, 3]: call_count, all_alleles_count, n_overflow)."""
    n_pad = columns.shape[2]
    kw = dict(window_cap=window_cap, record_cap=record_cap, n_iters=n_iters)
    per = []
    for d in range(columns.shape[0]):
        res = _dataset_query(columns, alt_prefix, offsets, qpack, d, **kw)
        rows = res[:, N_AGG:]
        valid = rows >= 0
        safe = rows.long().clamp(0, n_pad - 1)
        g = lambda c: columns[d, c][safe]
        prow = d * n_pad + safe
        m = masks[d][None, None, :]
        pr = plane_reduce_reference(
            g(C_FLAGS), g(C_AC), g(C_AN), g(C_REC_ID),
            gt[prow] & m,
            gt2[prow] & m if has_counts else None,
            tok1[prow] & m if has_counts else None,
            tok2[prow] & m if has_counts else None,
            valid, has_counts=has_counts,
        )
        n_matched = res[:, 4]
        overflow = (res[:, 5] != 0) | (n_matched > record_cap)
        scal = torch.stack([pr["call_count"], pr["all_alleles_count"],
                            overflow.to(torch.int32), n_matched], dim=1)
        per.append((scal, rows, pr["pc_call"], pr["pc_tok"], pr["or_words"]))
    scal, rows, pc_call, pc_tok, or_words = (
        torch.stack(x) for x in zip(*per)
    )
    agg = _wrap32(scal[:, :, :3].long().sum(dim=0))
    return scal, rows, pc_call, pc_tok, or_words, agg


def stacked_selected(
    columns, alt_prefix, offsets, gt, gt2, tok1, tok2, masks, qpack, *,
    window_cap, record_cap, n_iters, has_counts,
):
    """The stacked selected kernel over one mesh device's block: (scal,
    rows, pc_call, pc_tok, or_words, agg, seq), laid out as
    ``local_selected_reference`` returns them.

    CUDA tensors launch ``csrc/stacked_selected.cu`` on the current
    stream (asynchronously) and record the launch; CPU tensors run
    ``local_selected_reference`` and ``seq`` is None. Any other device,
    or inputs the kernel does not take, raise. Without counts the caller
    passes ``gt`` for the three count planes."""
    kw = dict(window_cap=window_cap, record_cap=record_cap, n_iters=n_iters,
              has_counts=has_counts)
    if columns.device.type == "cpu":
        return (*local_selected_reference(
            columns, alt_prefix, offsets, gt, gt2, tok1, tok2, masks, qpack,
            **kw), None)
    if columns.device.type != "cuda":
        raise ValueError(
            f"stacked_selected runs on cuda or cpu, not {columns.device}")
    dev = columns.device
    dl, _n_cols, n_pad = columns.shape
    b = qpack.shape[0]
    w = gt.shape[1]
    _check_inputs(dev, (
        ("columns", columns, (dl, len(COLUMNS), n_pad)),
        ("alt_prefix", alt_prefix, (dl, n_pad, 4)),
        ("offsets", offsets, (dl, N_CHROM_CODES + 1)),
        ("gt", gt, (dl * n_pad, w)),
        ("gt2", gt2, (dl * n_pad, w)),
        ("tok1", tok1, (dl * n_pad, w)),
        ("tok2", tok2, (dl * n_pad, w)),
        ("masks", masks, (dl, w)),
        ("qpack", qpack, (b, N_QFIELDS)),
    ))
    W, R = _window(window_cap, record_cap)
    lib = _build.load(SELECTED_KERNEL)
    smem = lib.stacked_selected_smem(R, w)
    if w < 1 or smem > _SMEM_MAX:
        raise ValueError(
            f"unsupported shape: R={R}, W={w} need {smem} bytes of shared "
            f"memory, at most {_SMEM_MAX}"
        )
    # the launch writes every word of agg: no fill before it
    out = dict(
        scal=torch.empty((dl, b, N_SEL_SCAL), dtype=torch.int32, device=dev),
        rows=torch.empty((dl, b, R), dtype=torch.int32, device=dev),
        pc_call=torch.empty((dl, b, R), dtype=torch.int32, device=dev),
        pc_tok=torch.empty((dl, b, R), dtype=torch.int32, device=dev),
        or_words=torch.empty((dl, b, w), dtype=torch.int32, device=dev),
        agg=(torch.empty if b and dl else torch.zeros)(
            (b, N_SEL_AGG), dtype=torch.int32, device=dev),
    )
    seq = None
    if b and dl:
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            rc = lib.stacked_selected_launch(
                columns.data_ptr(), n_pad, alt_prefix.data_ptr(),
                offsets.data_ptr(), gt.data_ptr(), gt2.data_ptr(),
                tok1.data_ptr(), tok2.data_ptr(), masks.data_ptr(), dl,
                qpack.data_ptr(), b, out["scal"].data_ptr(),
                out["rows"].data_ptr(), out["pc_call"].data_ptr(),
                out["pc_tok"].data_ptr(), out["or_words"].data_ptr(),
                out["agg"].data_ptr(), W, R, w, int(record_cap),
                int(bool(has_counts)),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"stacked_selected launch failed: CUDA error {rc}")
        seq = record_device_launch(
            SELECTED_KERNEL, family="mesh", device=str(dev), datasets=dl,
            specs=b, window=W, record_cap=R, words=w,
            with_counts=bool(has_counts),
            launch_ms=(time.perf_counter() - t0) * 1e3,
        )
    return (out["scal"], out["rows"], out["pc_call"], out["pc_tok"],
            out["or_words"], out["agg"], seq)


# -- the mesh entry points --------------------------------------------------


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the world's processes, on the host: one
    ``torch.distributed.all_reduce`` under the collective lock, on a host
    copy of ``t`` with gloo and on a copy on ``t``'s card with nccl.
    Every process must call it in the same order. Adds one to the
    ``mesh_all_reduces`` total and the call's microseconds to
    ``mesh_all_reduce_us``."""
    import torch.distributed as dist

    w = world()
    if w is None:
        raise RuntimeError("no process group: call "
                           "parallel.dispatch.init_multihost first")
    buf = t.to("cpu", copy=True) if w.backend == "gloo" else t.clone()
    t0 = time.perf_counter()
    with _COLLECTIVE_LOCK:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    out = buf.cpu()
    add_total("mesh_all_reduces")
    add_total("mesh_all_reduce_us", round((time.perf_counter() - t0) * 1e6))
    return out


def _fan_in(parts: list[torch.Tensor]) -> torch.Tensor:
    """The sum of this process's per-entry partials, in int64, on the
    first entry's device: enqueued there, nothing read back."""
    total = parts[0].long()
    for p in parts[1:]:
        total = total + p.to(total.device).long()
    return total


def _fold(total: torch.Tensor, dtype) -> torch.Tensor:
    """An int64 sum of ``dtype`` partials back to ``dtype``: int32 folds
    modulo 2^32, so the result wraps as ``lax.psum``'s does."""
    return _wrap32(total) if dtype == torch.int32 else total


def _psum(parts: list[torch.Tensor], mesh: Mesh | None = None) -> np.ndarray:
    """The cross-device fan-in (JAX's ``psum``), read back: the sum of
    this process's per-entry partials on its first entry (``_fan_in``),
    then, over a mesh that spans processes, ``all_reduce_sum`` across
    the world. The sums run in int64 and int32 partials fold back to
    int32 after them (gloo's own int32 sum would overflow a C++ int)."""
    total = _fan_in(parts)
    if mesh is not None and mesh.spans_processes:
        total = all_reduce_sum(total)
    return _fold(total, parts[0].dtype).cpu().numpy()


def _local_blocks(stacked_arrays, mesh: Mesh, aggregates_only: bool) -> int:
    """Check that ``stacked_arrays`` are this process's blocks of
    ``mesh`` and that a mesh spanning processes asks for the aggregates
    alone; returns the first local dataset's stack position."""
    if mesh.spans_processes and not aggregates_only:
        raise ValueError(
            "the mesh spans processes: per-dataset leaves live on their "
            "owning processes, so only the aggregates come back "
            "(aggregates_only=True), as under JAX's multi-controller "
            "jax.distributed"
        )
    local = mesh.local_entries()
    if len(stacked_arrays) != len(local):
        raise ValueError("the stack was not sharded over this mesh")
    return local[0] * stacked_arrays[0].n_datasets


def _packed(queries, blocks):
    enc = encode_queries(queries) if isinstance(queries, list) else queries
    q = pack_queries(enc, fused=False)
    return [torch.from_numpy(q).to(blk.device) for blk in blocks]


def sharded_query(
    stacked_arrays: list[StackBlock],
    queries,
    *,
    mesh: Mesh,
    n_iters: int,
    axis: str = AXIS,
    window_cap: int = 2048,
    record_cap: int = 1024,
    aggregates_only: bool = False,
):
    """Run a query batch against a mesh-sharded dataset stack
    (``StackedIndex.shard_to_mesh``): one ``stacked_query`` launch per
    local mesh entry over its block, then the fan-in ``_psum``.

    Returns (per_dataset, aggregates) as numpy: per_dataset leaves are
    [D, B, ...] (D = padded dataset count), aggregates are [B]-shaped
    cross-dataset sums. ``aggregates_only`` skips reading the
    per-dataset leaves back; over a mesh that spans processes it is
    required (the leaves live on their owning processes) and every
    process gets the same aggregates."""
    _local_blocks(stacked_arrays, mesh, aggregates_only)
    qs = _packed(queries, stacked_arrays)
    outs, parts = [], []
    for blk, q in zip(stacked_arrays, qs):
        out, agg, _seq = stacked_query(
            blk.columns, blk.alt_prefix, blk.offsets, q,
            window_cap=window_cap, record_cap=record_cap, n_iters=n_iters,
        )
        outs.append(out)
        parts.append(agg)
    a = _psum(parts, mesh)
    call_count = a[:, 0]
    aggregates = {
        "call_count": call_count,
        "all_alleles_count": a[:, 1],
        "n_variants": a[:, 2],
        "n_datasets_hit": a[:, 3],
        "n_overflow": a[:, 4],
        "exists": call_count > 0,
    }
    if aggregates_only:
        return {}, aggregates
    host = np.concatenate([o.cpu().numpy() for o in outs])
    per_ds = {
        "exists": host[:, :, 0] != 0,
        "call_count": host[:, :, 1],
        "n_variants": host[:, :, 2],
        "all_alleles_count": host[:, :, 3],
        "n_matched": host[:, :, 4],
        "overflow": host[:, :, 5] != 0,
        "rows": host[:, :, N_AGG:],
    }
    return per_ds, aggregates


def sharded_selected_query(
    stacked_arrays: list[StackBlock],
    queries,
    sample_masks: np.ndarray,
    *,
    mesh: Mesh,
    n_iters: int,
    axis: str = AXIS,
    window_cap: int = 2048,
    record_cap: int = 1024,
    has_counts: bool = False,
    aggregates_only: bool = False,
):
    """Selected-samples query batch over mesh-sharded planes: one
    ``stacked_selected`` launch per local mesh entry over its block,
    then the fan-in ``_psum`` (``aggregates_only`` as in
    ``sharded_query``).

    ``sample_masks``: uint32 [D, W], dataset d's selected-sample bit
    mask. Returns (per_dataset, aggregates) as numpy: per-dataset
    ``or_words`` [D, B, W] are the masked sample-hit unions, ``rows``,
    ``pc_call``, ``pc_tok`` [D, B, R] feed
    ``materialize_response(fused=...)``; aggregates are the selected
    call/allele counts summed over datasets and ``n_overflow``. The
    aggregate counts sum over ALL matched records, which equals
    ``materialize_response`` only for the include_details shapes, as in
    the JAX package."""
    start = _local_blocks(stacked_arrays, mesh, aggregates_only)
    masks = np.ascontiguousarray(np.asarray(sample_masks, np.uint32)).view(
        np.int32)
    qs = _packed(queries, stacked_arrays)
    outs, parts = [], []
    for blk, q in zip(stacked_arrays, qs):
        if blk.planes is None:
            raise ValueError("the stack was built without planes")
        if has_counts and len(blk.planes) < 4:
            raise ValueError("has_counts needs the stack's count planes")
        planes = blk.planes if has_counts else (blk.planes[0],) * 4
        dl = blk.n_datasets
        m = torch.from_numpy(masks[start : start + dl]).to(blk.device)
        start += dl
        *res, agg, _seq = stacked_selected(
            blk.columns, blk.alt_prefix, blk.offsets, *planes, m, q,
            window_cap=window_cap, record_cap=record_cap, n_iters=n_iters,
            has_counts=has_counts,
        )
        outs.append(res)
        parts.append(agg)
    a = _psum(parts, mesh)
    call_count = a[:, 0]
    aggregates = {
        "call_count": call_count,
        "all_alleles_count": a[:, 1],
        "n_overflow": a[:, 2],
        "exists": call_count > 0,
    }
    if aggregates_only:
        return {}, aggregates
    scal, rows, pc_call, pc_tok, or_words = (
        np.concatenate([o[i].cpu().numpy() for o in outs]) for i in range(5)
    )
    per_ds = {
        "call_count": scal[:, :, 0],
        "all_alleles_count": scal[:, :, 1],
        "overflow": scal[:, :, 2] != 0,
        "n_matched": scal[:, :, 3],
        "rows": rows,
        "pc_call": pc_call,
        "pc_tok": pc_tok,
        "or_words": or_words,
    }
    return per_ds, aggregates


def aggregate_struct(agg: dict) -> dict:
    """Human-readable summary of the psum aggregates for one query.

    ``n_overflow`` > 0 means at least one dataset's candidate window was
    truncated at window_cap: the aggregates are then lower bounds and the
    caller must re-answer those datasets on the host
    (``engine.host_match_rows``), as the single-device engine's overflow
    fallback does."""
    return {
        "exists": bool(agg["exists"]),
        "call_count": int(agg["call_count"]),
        "all_alleles_count": int(agg["all_alleles_count"]),
        "n_variants": int(agg["n_variants"]),
        "n_datasets_hit": int(agg["n_datasets_hit"]),
        "n_overflow": int(agg["n_overflow"]),
        "exact": int(agg["n_overflow"]) == 0,
    }


# -- the mesh-sharded fused index and its owner-sliced query (J6) -----------

FUSED_KERNEL = "mesh_fused"
#: the total counting run_mesh_queries calls (one per mesh program,
#: whatever the number of kernel launches under it)
MESH_PROGRAM = "mesh_programs"
#: aggregate columns of mesh_fused: call_count, n_variants,
#: all_alleles_count, n_matched, overflow
N_MESH_AGG = 5
#: mesh_fused's output layouts (its ``layout`` argument): owner-sharded
#: outputs, the sliced batch combined over entries, the replicated batch
LAYOUT_OWNER, LAYOUT_SLICED, LAYOUT_REPLICATED = range(3)
_PLANE_ATTRS = ("gt_bits", "gt_bits2", "tok_bits1", "tok_bits2")


def local_fused_reference(
    columns, alt_prefix, offsets, seg_base, qpack, *, me, d_local, n_dev, C,
    layout, window_cap, record_cap, n_iters, planes=None, masks=None,
    use_counts=None, has_counts=False,
):
    """Plain-PyTorch twin of the owner-sliced fused query kernel: JAX's
    ``_local_fused_query`` for mesh entry ``me``.

    ``columns`` int32 [11, n_pad], ``alt_prefix`` int32 [n_pad, 4],
    ``offsets`` int32 [d_local, 27] (block-absolute rows), ``seg_base``
    int32 [d_local], ``qpack`` int32 [S, N_QFIELDS] with global shard
    ids. With ``planes`` ((gt,) or (gt, gt2, tok1, tok2), int32 [n_pad,
    W]), ``masks`` int32 [S, W] and ``use_counts`` int32 [S] arm the
    plane reduction. Ownership (``0 <= shard - me * d_local <
    d_local``) masks every output; rows come back dataset-local
    (``row - seg_base``). Returns a dict of int32 tensors: ``agg`` [n_out,
    5] (call_count, n_variants, all_alleles_count, n_matched, overflow),
    ``rows`` [n_out, R] and with planes ``pc_call``, ``pc_tok`` [n_out, R]
    and ``or_words`` [n_out, W]. The owner layout returns the raw
    rebased rows (-1 padded, n_out = S); the combine layouts return rows
    + 1 (0 for padding and non-owners), in slots ``[me * C, me * C + S)``
    of zeroed ``n_dev * C`` outputs for ``LAYOUT_SLICED`` and in slots
    ``[0, S)`` for ``LAYOUT_REPLICATED``."""
    i32 = torch.int32
    sid = qpack[:, 1].long() - me * d_local  # QF_SHARD
    owned = (sid >= 0) & (sid < d_local)
    sidc = sid.clamp(0, d_local - 1)
    q = qpack.clone()
    q[:, 1] = sidc.to(i32)
    res = query_batch_reference(
        columns, alt_prefix, offsets, q, window_cap=window_cap,
        record_cap=record_cap, n_iters=n_iters,
    )
    own = owned.to(i32)[:, None]
    out = {"agg": res[:, 1:N_AGG] * own}  # exists is derived at fetch
    rows_abs = res[:, N_AGG:]
    combine = layout != LAYOUT_OWNER
    rebased = rows_abs - seg_base[sidc][:, None] + int(combine)
    out["rows"] = torch.where(
        (rows_abs >= 0) & owned[:, None], rebased, 0 if combine else -1
    ).to(i32)
    if planes is not None:
        n = columns.shape[1]
        valid = rows_abs >= 0
        safe = rows_abs.long().clamp(0, n - 1)
        g = lambda c: columns[c][safe]
        m = masks[:, None, :]
        counts = ([p[safe] & m for p in planes[1:4]] if has_counts
                  else [None] * 3)
        pr = plane_reduce_reference(
            g(C_FLAGS), g(C_AC), g(C_AN), g(C_REC_ID), planes[0][safe] & m,
            *counts, valid, has_counts=has_counts,
            use_counts=use_counts != 0,
        )
        for k in ("pc_call", "pc_tok", "or_words"):
            out[k] = pr[k] * own
    if layout == LAYOUT_SLICED:
        full = {}
        for k, v in out.items():
            buf = torch.zeros((n_dev * C,) + tuple(v.shape[1:]), dtype=i32,
                              device=v.device)
            buf[me * C : me * C + v.shape[0]] = v
            full[k] = buf
        out = full
    return out


def mesh_fused(
    columns, alt_prefix, offsets, seg_base, qpack, *, me, d_local, n_dev, C,
    layout, window_cap, record_cap, n_iters, planes=None, masks=None,
    use_counts=None, has_counts=False,
):
    """The owner-sliced fused query kernel over one mesh entry's block:
    (out, seq), ``out`` laid out as ``local_fused_reference`` returns it.

    CUDA tensors launch ``csrc/mesh_fused.cu`` on the current stream
    (asynchronously; its match-only entry point without ``planes``, with
    them a thread-block cluster of 8 blocks per output slot, which a
    card before Hopper refuses: the launch then raises) and record the
    launch, ``seq`` being its launch record. CPU tensors run
    ``local_fused_reference`` and ``seq`` is None. Any other device, or
    inputs the kernel does not take, raise. ``n_iters`` is the twin's
    bisection depth; the kernel's search ends by itself."""
    kw = dict(me=me, d_local=d_local, n_dev=n_dev, C=C, layout=layout,
              window_cap=window_cap, record_cap=record_cap, n_iters=n_iters,
              planes=planes, masks=masks, use_counts=use_counts,
              has_counts=has_counts)
    if columns.device.type == "cpu":
        return local_fused_reference(
            columns, alt_prefix, offsets, seg_base, qpack, **kw), None
    if columns.device.type != "cuda":
        raise ValueError(f"mesh_fused runs on cuda or cpu, not {columns.device}")
    if layout not in (LAYOUT_OWNER, LAYOUT_SLICED, LAYOUT_REPLICATED):
        raise ValueError(f"unknown layout {layout}")
    dev = columns.device
    n_pad = columns.shape[1]
    s = qpack.shape[0]
    shapes = [
        ("columns", columns, (len(COLUMNS), n_pad)),
        ("alt_prefix", alt_prefix, (n_pad, 4)),
        ("offsets", offsets, (d_local, N_CHROM_CODES + 1)),
        ("seg_base", seg_base, (d_local,)),
        ("qpack", qpack, (s, N_QFIELDS)),
    ]
    w = 0
    if planes is not None:
        w = planes[0].shape[1]
        if has_counts and len(planes) < 4:
            raise ValueError("has_counts needs the block's count planes")
        planes = tuple(planes) if has_counts else (planes[0],) * 4
        shapes += [(f"planes[{i}]", p, (n_pad, w)) for i, p in enumerate(planes)]
        shapes += [("masks", masks, (s, w)), ("use_counts", use_counts, (s,))]
    _check_inputs(dev, shapes)
    if layout == LAYOUT_SLICED and (s != C or not 0 <= me < n_dev):
        raise ValueError(f"sliced layout: {s} slots != C={C} or entry {me} "
                         f"outside {n_dev}")
    W, R = _window(window_cap, record_cap)
    lib = _build.load(FUSED_KERNEL)
    # 0 match-only, 1 planes, 2 planes with counts (a gt cache)
    smem = lib.mesh_fused_smem(
        W, R, w, 0 if planes is None else 1 + int(bool(has_counts)))
    if (planes is not None and w < 1) or smem > _SMEM_MAX:
        raise ValueError(
            f"unsupported shape: window_cap={window_cap}, R={R}, W={w} need "
            f"{smem} bytes of shared memory, at most {_SMEM_MAX}"
        )
    n_out = n_dev * C if layout == LAYOUT_SLICED else s
    empty = lambda *shape: torch.empty(shape, dtype=torch.int32, device=dev)
    out = {"agg": empty(n_out, N_MESH_AGG), "rows": empty(n_out, R)}
    if planes is not None:
        out.update(pc_call=empty(n_out, R), pc_tok=empty(n_out, R),
                   or_words=empty(n_out, w))
    if s == 0:
        return out, None
    t0 = time.perf_counter()
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (columns.data_ptr(), n_pad, alt_prefix.data_ptr(),
            offsets.data_ptr(), seg_base.data_ptr(), d_local, me, n_dev,
            qpack.data_ptr(), s, C, layout, out["agg"].data_ptr(),
            out["rows"].data_ptr())
    with torch.cuda.device(dev):
        if planes is None:
            rc = lib.mesh_fused_launch(*head, W, R, stream)
        else:
            rc = lib.mesh_fused_planes_launch(
                *head, *(p.data_ptr() for p in planes), masks.data_ptr(),
                use_counts.data_ptr(), out["pc_call"].data_ptr(),
                out["pc_tok"].data_ptr(), out["or_words"].data_ptr(), W, R,
                w, int(bool(has_counts)), stream,
            )
    if rc != 0:
        raise RuntimeError(f"mesh_fused launch failed: CUDA error {rc}")
    # the JAX package's program families: plane, mesh_sliced (both
    # sliced layouts), mesh_replicated
    family = ("plane" if planes is not None
              else "mesh_replicated" if layout == LAYOUT_REPLICATED
              else "mesh_sliced")
    seq = record_device_launch(
        FUSED_KERNEL, family=family, device=str(dev), slots=s, layout=layout,
        sliced=layout != LAYOUT_REPLICATED,
        window=W, record_cap=R, words=w, with_counts=bool(has_counts),
        launch_ms=(time.perf_counter() - t0) * 1e3,
    )
    return out, seq


class MeshPendingResults:
    """The results of one mesh launch, read back by :meth:`fetch`.

    ``out`` is, under owner-sharded outputs (``owner_layout`` = (n_dev,
    c_slot, counts)), one dict of output tensors per mesh entry, entry g
    holding its ``c_slot`` slots of which the first ``counts[g]`` carry
    real queries; otherwise one dict of combined outputs (the fan-in's
    ``agg`` and the ring-gathered blocks, on the first entry's device).
    ``positions`` is the sliced layout's slot map (query j's results
    live at slot ``positions[j]``), applied as the inverse permute; None
    means the replicated layout (the first ``b`` slots). ``streams``
    maps each CUDA device of the launch to the stream it was launched
    on; ``staged`` holds the launch's uploads (pinned host staging
    included) until :meth:`fetch` returns.

    Nothing is read back until :meth:`fetch`: it enqueues every copy
    into pinned host memory on the launch's streams, records one CUDA
    event per card after that card's last copy, waits on them and
    slices (owner-sharded: only each owner's real rows cross)."""

    __slots__ = ("_out", "_b", "_pos", "_owner", "_streams", "_staged",
                 "flight_seq")

    def __init__(self, out, b: int, positions=None, flight_seq=None,
                 owner_layout=None, streams=None, staged=None):
        self._out = out
        self._b = b
        self._pos = positions
        self._owner = owner_layout
        self._streams = streams or {}
        self._staged = staged
        self.flight_seq = flight_seq

    def _read_back(self, leaves: dict) -> dict:
        """{key: [numpy array]} of ``leaves`` ({key: [tensor]}): the
        copies of CUDA tensors enqueued on their launch stream into
        pinned memory, one event per card recorded after them, waited
        on; CPU tensors as they are."""
        hosts = {}
        for k, ts in leaves.items():
            hosts[k] = []
            for t in ts:
                stream = self._streams.get(t.device)
                if stream is None:
                    hosts[k].append(stage_readback(t))
                    continue
                with torch.cuda.stream(stream):
                    hosts[k].append(stage_readback(t))
        for stream in self._streams.values():
            done = torch.cuda.Event()
            done.record(stream)
            done.synchronize()
        return {k: [h.numpy() for h in hs] for k, hs in hosts.items()}

    def _host_owner_sharded(self):
        """Each owner's real rows, straight off its own outputs: returns
        (host leaves, the counts-trimmed blocks concatenated in owner
        order; ``sel_idx``, query j's row in that compact layout)."""
        n_dev, c_slot, counts = self._owner
        assert len(self._out) == n_dev, "one output set per mesh entry"
        leaves = {}
        for k in self._out[0]:
            leaves[k] = []
            for g, outs in enumerate(self._out):
                # each entry holds ONLY its own c_slot slots: a full-size
                # block here would mean the outputs were combined
                assert outs[k].shape[0] == c_slot, (
                    f"owner-sharded output {k!r} holds {outs[k].shape[0]} "
                    f"slots (want {c_slot})"
                )
                leaves[k].append(outs[k][: int(counts[g])])
        host = {k: np.concatenate(v)
                for k, v in self._read_back(leaves).items()}
        starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
        pos = np.asarray(self._pos)
        return host, starts[pos // c_slot] + pos % c_slot

    def fetch(self) -> QueryResults:
        t0 = time.perf_counter()
        if self._owner is not None:
            out, sel_idx = self._host_owner_sharded()
            sel = lambda a: np.ascontiguousarray(a[sel_idx])
        else:
            out = {k: v[0] for k, v in self._read_back(
                {k: [v] for k, v in self._out.items()}).items()}
            if self._pos is None:
                sel = lambda a: np.ascontiguousarray(a[: self._b])
            else:
                sel = lambda a: np.ascontiguousarray(a[self._pos])
        nbytes = sum(v.nbytes for v in out.values())
        note_device_stage(
            self.flight_seq, fetch_ms=(time.perf_counter() - t0) * 1e3,
            fetch_bytes=nbytes,
        )
        add_total("mesh_fetch_bytes", nbytes)
        # free the device buffers and the staged uploads promptly
        self._out = self._staged = None
        agg = out["agg"]
        call_count = sel(agg[:, 0])
        extra = {k: sel(out[k]) for k in ("pc_call", "pc_tok", "or_words")
                 if k in out}
        return QueryResults(
            exists=call_count > 0,
            call_count=call_count,
            n_variants=sel(agg[:, 1]),
            all_alleles_count=sel(agg[:, 2]),
            n_matched=sel(agg[:, 3]),
            overflow=sel(agg[:, 4]) > 0,
            rows=sel(out["rows"]),
            **extra,
        )


@dataclasses.dataclass
class FusedBlock:
    """One mesh entry's block of the mesh-sharded fused index:
    ``columns`` int32 [11, n_pad], ``alt_prefix`` int32 [n_pad, 4]
    (the entry's shards concatenated and padded to the common row
    count), ``offsets`` int32 [d_local, 27] (block-absolute segment
    rows), ``seg_base`` int32 [d_local] (each shard's first block row)
    and, with planes, ``planes`` = (gt,) or (gt, gt2, tok1, tok2), each
    int32 [n_pad, W]."""

    device: torch.device
    columns: torch.Tensor
    alt_prefix: torch.Tensor
    offsets: torch.Tensor
    seg_base: torch.Tensor
    planes: tuple | None = None


class MeshFusedIndex:
    """The fused stacked index (``ops.kernel.FusedDeviceIndex`` layout:
    contiguous per-shard row spans and a per-shard segment table),
    sharded over a 1-D mesh.

    Datasets are grouped round-robin-contiguously: mesh entry g owns
    shards ``[g * d_local, (g + 1) * d_local)`` as ONE fused block
    (``FusedBlock``), uploaded to that entry's device, so each entry
    holds only its own block. Empty trailing groups (fewer shards than
    ``n_dev * d_local``) reuse group 0's column dtypes with zero
    offsets: every row span there is empty.

    :meth:`run_mesh_queries` answers a batch of (shard, query) pairs
    with one ``mesh_fused`` launch per entry, in the index's ``layout``.
    Under the two sliced layouts (``LAYOUT_OWNER``, the default, and
    ``LAYOUT_SLICED``) the encoded batch is split by owning entry
    (owner-sorted permute), so each entry evaluates only the queries
    targeting its shards; ``LAYOUT_REPLICATED`` runs the whole batch on
    every entry, masked by ownership. A one-entry mesh or an empty batch
    always takes the replicated layout. Owner-sharded outputs
    (``LAYOUT_OWNER``) need no combine; otherwise the scalar
    aggregates fan in on the first entry (``_fan_in``, as ``_psum``
    sums without its readback) and the hit rows (with the plane blocks)
    through the ring gather ``ops.gather_kernel``, both left on the card
    until the pending results are fetched. Row ids come
    back dataset-local. Built ``with_planes=True``, the genotype planes
    stack group-wise with their datasets and plane-reading query shapes
    ride the same launch with per-query sample masks.

    The serving micro-batcher treats this index like a FusedDeviceIndex:
    ``submit_many(index, specs, shard_ids=...)`` coalesces concurrent
    queries for different datasets into one launch
    (``ops.run_queries_auto`` dispatches on ``run_mesh_queries``).

    Deliberate differences from the JAX package: the slice width
    ``c_slot`` is the largest per-entry count and the replicated batch is
    not padded (a CUDA kernel compiles no shapes, and the JAX package's
    tier ladder is not ported); ``plane_bytes_per_device`` counts the
    card's real ``W * 4`` bytes a row; uploads are never donated; the
    layout is the constructor's ``layout`` argument alone (the JAX
    package's call arguments, config knobs and ``BEACON_MESH_SLICE`` /
    ``BEACON_MESH_OWNER_OUTPUTS`` are not kept).
    """

    PAD_UNIT = DeviceIndex.PAD_UNIT

    def __init__(
        self,
        shards: list[VariantIndexShard],
        mesh: Mesh,
        *,
        axis: str = AXIS,
        pad_unit: int | None = None,
        with_planes: bool = False,
        layout: int = LAYOUT_OWNER,
    ):
        if not shards:
            raise ValueError("MeshFusedIndex needs at least one shard")
        if mesh.spans_processes:
            raise ValueError(
                "MeshFusedIndex needs every mesh entry in this process: a "
                "mesh that spans processes is refused (the JAX package "
                "asserts a single controller in its owner-sharded fetch)"
            )
        self.mesh = mesh
        self.axis = axis
        if layout not in (LAYOUT_OWNER, LAYOUT_SLICED, LAYOUT_REPLICATED):
            raise ValueError(f"unknown layout {layout}")
        #: run_mesh_queries' output layout (a LAYOUT_* constant)
        self.layout = layout
        n_dev = mesh.size
        d = len(shards)
        d_local = -(-d // n_dev)  # shards per entry, last groups may pad
        self.n_dev = n_dev
        self.d_local = d_local
        self.n_shards = d

        groups = [shards[g * d_local : (g + 1) * d_local] for g in range(n_dev)]
        stacked = [stack_shard_columns(grp) if grp else None for grp in groups]
        n_rows = [int(e[2][-1]) if e else 0 for e in stacked]
        n_pad = padded_rows(max(n_rows), pad_unit or self.PAD_UNIT)
        proto_cols = stacked[0][0]
        offsets = np.zeros((n_dev, d_local, N_CHROM_CODES + 1), np.int32)
        seg_base = np.zeros((n_dev, d_local), np.int32)

        self.plane_words = 0
        self.has_planes = False
        self.has_count_planes = False
        attrs = ()
        if with_planes and all(s.gt_bits is not None for s in shards):
            self.plane_words = max(s.gt_bits.shape[1] for s in shards)
            self.has_planes = True
            self.has_count_planes = all(s.has_count_planes for s in shards)
            attrs = _PLANE_ATTRS if self.has_count_planes else _PLANE_ATTRS[:1]

        self.blocks: list[FusedBlock] = []
        for g, dev in enumerate(mesh.devices):
            if stacked[g] is None:
                cols = {k: np.empty((0,) + v.shape[1:], v.dtype)
                        for k, v in proto_cols.items()}
            else:
                cols, offs, base = stacked[g]
                offsets[g, : offs.shape[0]] = offs
                seg_base[g, : offs.shape[0]] = base[:-1].astype(np.int32)
            columns, alt_prefix = _upload_columns(cols, n_rows[g], n_pad, dev)
            planes = tuple(
                self._group_plane(groups[g], a, n_pad, dev) for a in attrs
            ) or None
            self.blocks.append(FusedBlock(
                device=torch.device(dev), columns=columns,
                alt_prefix=alt_prefix,
                offsets=torch.from_numpy(offsets[g].copy()).to(dev),
                seg_base=torch.from_numpy(seg_base[g].copy()).to(dev),
                planes=planes,
            ))
        #: host copy of the segment tables, [n_dev, d_local, 27]
        self.chrom_offsets = offsets
        #: device bytes the stacked planes take on each entry (0 without
        #: planes): what the owner registers against the engine's plane
        #: budget ledger
        self.plane_bytes_device = (
            self.plane_bytes_per_device(
                shards, n_dev=n_dev, pad_unit=pad_unit or self.PAD_UNIT)
            if self.has_planes else 0
        )
        self.n_padded = n_pad
        self.n_iters = bisect_iters(n_pad)
        #: the widest (shard, chromosome) segment of every block:
        #: run_mesh_queries clamps its window_cap to this
        self.window_hint = window_hint_for(offsets)

    def _group_plane(self, grp, attr, n_pad, dev) -> torch.Tensor:
        """One plane of a group: its shards' rows concatenated, padded to
        ``n_pad`` rows and the widest shard's words, on ``dev``."""
        if not grp:
            return torch.zeros((n_pad, self.plane_words), dtype=torch.int32,
                               device=dev)
        out = np.zeros((n_pad, self.plane_words), np.uint32)
        r0 = 0
        for sh in grp:
            a = getattr(sh, attr)
            out[r0 : r0 + a.shape[0], : a.shape[1]] = a
            r0 += a.shape[0]
        return staged_upload(out, dev)

    @classmethod
    def plane_bytes_per_device(cls, shards, *, n_dev: int,
                               pad_unit: int | None = None) -> int:
        """Device bytes the group-stacked genotype planes take on each
        mesh entry (group row padding, the widest shard's W, the
        count-plane multiplicity): the card's real ``W * 4`` bytes a
        row, where the JAX package counts XLA's 128-lane padding of W.
        The dispatch tier's budget gate asks this."""
        if not shards or any(s.gt_bits is None for s in shards):
            return 0
        d_local = -(-len(shards) // n_dev)
        groups = [shards[g * d_local : (g + 1) * d_local] for g in range(n_dev)]
        rows = max(sum(s.n_rows for s in g) for g in groups)
        n_pad = padded_rows(rows, pad_unit or cls.PAD_UNIT)
        W = max(s.gt_bits.shape[1] for s in shards)
        n_planes = 4 if all(s.has_count_planes for s in shards) else 1
        return n_pad * W * 4 * n_planes

    def shard_id(self, position: int) -> int:
        """Global shard id of the ``position``-th shard of the build
        list: entry ``position // d_local``, local slot ``% d_local``;
        contiguous by construction, so the identity."""
        return position

    def _slice_layout(self, enc, masks, use_counts):
        """Owner-sorted sliced layout: entry g's queries occupy slots
        ``[g * C, g * C + counts[g])`` of ``[n_dev * C]`` arrays, C being
        the largest per-entry count. Filler slots carry chrom code 0 (an
        empty row span in every shard) aimed at their own entry's first
        local shard, which may lie past ``n_shards`` in an empty trailing
        group, whose span is empty too. Returns ``(enc, masks,
        use_counts, positions, counts, c_slot)``: ``positions[j]`` is
        query j's slot (the inverse permute at fetch) and ``counts[g]``
        entry g's real query count."""
        shard = np.asarray(enc["shard"])
        b = shard.shape[0]
        owner = shard // self.d_local
        counts = np.bincount(owner, minlength=self.n_dev)
        c_slot = int(counts.max())
        order = np.argsort(owner, kind="stable")
        starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
        ranks = np.arange(b, dtype=np.int64) - np.repeat(starts, counts)
        pos = np.empty(b, dtype=np.int64)
        pos[order] = owner[order] * c_slot + ranks
        total = self.n_dev * c_slot
        out = {}
        for k, v in enc.items():
            if k == "shard":
                arr = np.repeat(
                    np.arange(self.n_dev, dtype=np.int32)
                    * np.int32(self.d_local),
                    c_slot,
                )
            else:
                arr = np.zeros((total,) + v.shape[1:], v.dtype)
            arr[pos] = v
            out[k] = arr
        if masks is not None:
            m = np.zeros((total, masks.shape[1]), masks.dtype)
            m[pos] = masks
            masks = m
            uc = np.zeros(total, np.bool_)
            uc[pos] = use_counts
            use_counts = uc
        return out, masks, use_counts, pos, counts, c_slot

    def launch_inputs(self, enc, layout, *, sample_masks=None,
                      mask_counts=None, staged=None):
        """The batch laid out for one ``mesh_fused`` launch per entry:
        returns ``(entries, positions, counts, C)``, ``entries`` being per
        mesh entry ``(block, packed slots on its device, the keyword
        arguments of its launch)``. The sliced layouts take the
        owner-sorted slots ``[g * C, (g + 1) * C)`` of ``_slice_layout``
        (``positions``, ``counts`` as it returns them); the replicated
        layout hands every entry the whole batch (C = B, ``positions``
        and ``counts`` None). ``sample_masks`` (uint32 [B, W]) arm the
        plane reduction; ``mask_counts`` ([B] bool, default off) is
        forced off when the stack has no count planes: restricted
        counting must then come from the host path, never a zero
        plane. Each upload goes up from pinned memory without the host
        waiting for the card; a list passed as ``staged`` collects every
        (tensor, pinned staging) pair, for a caller that holds them
        until the launch's results are read."""
        b = int(enc["chrom"].shape[0])
        masks = use_counts = None
        if sample_masks is not None:
            masks = np.ascontiguousarray(
                np.asarray(sample_masks, np.uint32)).view(np.int32)
            use_counts = np.zeros(b, np.bool_)
            if mask_counts is not None and self.has_count_planes:
                use_counts = np.asarray(mask_counts, np.bool_)
        pos = counts = None
        if layout == LAYOUT_REPLICATED:
            C = b
        else:
            enc, masks, use_counts, pos, counts, C = self._slice_layout(
                enc, masks, use_counts)
        qpack = pack_queries(enc, fused=True)
        entries = []
        for g, blk in enumerate(self.blocks):
            sl = (slice(None) if layout == LAYOUT_REPLICATED
                  else slice(g * C, (g + 1) * C))

            def put(a, dev=blk.device, sl=sl):
                t, pinned = stage_upload(
                    np.asarray(a[sl]).astype(np.int32, copy=False), dev)
                if staged is not None:
                    staged.append((t, pinned))
                return t

            kw = dict(me=g, d_local=self.d_local, n_dev=self.n_dev, C=C,
                      layout=layout, n_iters=self.n_iters)
            if masks is not None:
                kw.update(planes=blk.planes, masks=put(masks),
                          use_counts=put(use_counts),
                          has_counts=self.has_count_planes)
            entries.append((blk, put(qpack), kw))
        return entries, pos, counts, C

    def run_mesh_queries(
        self,
        queries,
        *,
        window_cap: int = 2048,
        record_cap: int = 1024,
        async_fetch: bool = False,
        sample_masks=None,
        mask_counts=None,
    ):
        """One mesh launch (one ``mesh_fused`` launch per entry, then the
        combine) answering a (shard, query)-pair batch.

        ``queries``: a pre-encoded dict (``encode_queries`` with
        ``shard_ids``); a bare list is a loud error, as in the JAX
        package. ``rows`` come back dataset-local. ``sample_masks``
        (uint32 [B, W], W = ``plane_words``) arm the plane reduction: each
        query's matched rows reduce under ITS mask on the owning entry,
        and the results carry ``pc_call`` / ``pc_tok`` / ``or_words``;
        ``mask_counts`` ([B] bool) switches a query to genotype-derived
        counting (forced off when the stack has no count planes). The
        layout is the index's, replicated on a one-entry mesh or for an
        empty batch.

        On CUDA entries the call does not wait for the card: the uploads
        go up from pinned memory, and the launches and the combine (the
        fan-in of ``agg`` on the first entry and P1's ring pass) stay
        enqueued. ``async_fetch=True`` returns the
        :class:`MeshPendingResults` undrained; the default fetches it
        and returns the ``QueryResults``."""
        if isinstance(queries, list):
            raise ValueError(
                "MeshFusedIndex batches must carry explicit shard ids "
                "(encode_queries(..., shard_ids=...)): a bare list "
                "would silently target shard 0, which can only answer "
                "for its own row span"
            )
        enc = queries
        if "shard" not in enc:
            raise ValueError(
                "MeshFusedIndex batches must carry shard ids "
                "(encode_queries(..., shard_ids=...))"
            )
        with_planes = sample_masks is not None
        if with_planes and not self.has_planes:
            raise ValueError(
                "sample_masks passed but this stack carries no "
                "genotype planes (built with_planes=False)"
            )
        b = int(enc["chrom"].shape[0])
        window_cap = min(window_cap, self.window_hint)
        layout = (self.layout if self.n_dev > 1 and b > 0
                  else LAYOUT_REPLICATED)
        staged = []
        entries, pos, counts, local_b = self.launch_inputs(
            enc, layout, sample_masks=sample_masks, mask_counts=mask_counts,
            staged=staged)
        owner_layout = ((self.n_dev, local_b, counts)
                        if layout == LAYOUT_OWNER else None)
        outs, seqs = [], []
        for blk, q, kw in entries:
            out, seq = mesh_fused(
                blk.columns, blk.alt_prefix, blk.offsets, blk.seg_base, q,
                window_cap=window_cap, record_cap=record_cap, **kw,
            )
            outs.append(out)
            seqs.append(seq)
        if layout != LAYOUT_OWNER:
            # scalar fan-in: exactly one entry owns each query, so the
            # psum is a select; the hit rows (+1, so padding and
            # non-owners add 0) and the plane blocks ride ONE ring pass
            parts = [o["agg"] for o in outs]
            combined = {"agg": _fold(_fan_in(parts), parts[0].dtype)}
            names = ["rows"] + (["pc_call", "pc_tok", "or_words"]
                                if with_planes else [])
            (got,) = gather_partials_many(
                [tuple(o[k] for k in names) for o in outs])[:1]
            combined.update(zip(names, got))
            combined["rows"] = combined["rows"] - 1
            outs = combined
        add_total(MESH_PROGRAM)
        add_total("mesh_evaluated_pairs", local_b * self.n_dev)
        # the streams the readback must follow: each card's, as launched
        streams = {}
        for o in (outs if layout == LAYOUT_OWNER else [outs]):
            for t in o.values():
                if t.device.type == "cuda" and t.device not in streams:
                    streams[t.device] = torch.cuda.current_stream(t.device)
        # the fetch's stage timing lands on the first kernel launch's
        # record (None on CPU, which records nothing)
        pending = MeshPendingResults(
            outs, b, pos, seqs[0] if seqs else None,
            owner_layout=owner_layout, streams=streams, staged=staged)
        return pending if async_fetch else pending.fetch()
