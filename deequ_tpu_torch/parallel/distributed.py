"""The mesh-sharded fused scan: one process shards each batch's rows over
a list of devices and merges the per-shard partials by the semigroup.

A mesh (`data_mesh`) is an ordered list of devices, one per shard, and
may list a device more than once: eight CPU shards in the tests, eight
shards on one card, or one shard per card of a multi-GPU machine. Per
batch, shard d takes rows [d * per_dev, (d + 1) * per_dev) of the batch
padded to n * per_dev rows (`_pad_size`, the JAX package's shard rows),
packs them into its own wire (the padded rows masked out) and copies it
to its device, where the fused program reduces it: the same
`device_reduce`, so the same kernel launches, per shard. The shards'
packed partials come to the mesh's first device (a peer copy across
cards, none on one card), are stacked and copied to the host in one
copy, and fold there with `merge_agg` in shard order 0..n-1, then
across batches in batch order (ops/fused.py:PipelinedAggFold, n_dev).
An assisted member (a quantile sketch) finishes each shard's histogram
against that shard's rows of the host batch, so it samples each shard
as the JAX mesh does. Host-placed members fold each whole batch on the
host under every placement (`fold_host_batch`), as in the single pass.

Processes meet only in parallel/multihost.py, which moves serialized
states between them. The JAX counterpart is
deequ_tpu/parallel/distributed.py (a jax Mesh and shard_map).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from deequ_tpu_torch import observe
from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.ops.fused import (
    AnalyzerRunResult,
    FusedScanPass,
    _BatchScan,
    _pad_size,
    _Prepped,
    get_fused_fn,
    pack_batch_inputs,
    plan_decode_fastpath,
    PipelinedAggFold,
)

class DeviceMesh:
    """An ordered list of devices of one type, one per shard."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = tuple(devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        types = {d.type for d in self.devices}
        if len(types) != 1:
            raise ValueError(f"a mesh's devices must be of one type, got {sorted(types)}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def __eq__(self, other) -> bool:
        return isinstance(other, DeviceMesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"DeviceMesh({[str(d) for d in self.devices]})"


def data_mesh(devices: Optional[Sequence] = None) -> DeviceMesh:
    """A one-axis data-parallel mesh over `devices` (names or
    torch.devices, in shard order), else over every CUDA device of this
    process; with no CUDA device that raises, as runs do."""
    if devices is None:
        runtime.resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return DeviceMesh([runtime.resolve_device(d) for d in devices])


class _MeshBatchScan(_BatchScan):
    """The pass's per-batch loop over a mesh: `_ship` packs and copies each
    shard's slice of the batch to its device, `_launch` runs the fused
    program per shard and submits the stacked partials to the fold."""

    def __init__(self, mesh: DeviceMesh, per_device: int, controller, analyzers, plan):
        super().__init__(mesh.devices[0], controller, analyzers, plan)
        self.mesh = mesh
        self.per_device = per_device
        self.fold = PipelinedAggFold(self.analyzers, self.device, self.assisted, n_dev=mesh.size)
        self.copy_streams: Dict[torch.device, Any] = {}

    def _make_copy_streams(self) -> None:
        for device in set(self.mesh.devices):
            self.copy_streams[device] = torch.cuda.Stream(device=device)

    def _ship(self, item: _Prepped, items, wire_rows) -> None:
        n = item.batch.num_rows
        per_dev = _pad_size(-(-n // self.mesh.size), self.per_device)
        shards = []
        item.wire_bytes = 0
        for d, device in enumerate(self.mesh.devices):
            lo = min(d * per_dev, n)
            hi = min(lo + per_dev, n)
            # a shard past the batch's end is all padding: every mask of
            # it is False, so it folds to the identity
            host, layout = pack_batch_inputs(
                [(key, arr[lo:hi]) for key, arr in items], per_dev, self.sticky, hi - lo,
                pin=device.type == "cuda",
            )
            item.wire_bytes += sum(int(v.nbytes) for v in host.values())
            wire, copied = self._copy_to(host, device, self.copy_streams.get(device))
            shards.append((device, wire, copied, layout, lo, hi))
        item.wire = shards

    def _dispatch_attrs(self) -> Dict[str, Any]:
        return {"devices": self.mesh.size}

    def _launch(self, item: _Prepped) -> None:
        flats, bounds, meta = [], [], None
        for device, wire, copied, layout, lo, hi in item.wire:
            # the kernels launch on the current device's stream
            with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
                self._await_copy(wire, copied, device)
                program = get_fused_fn(self.analyzers, layout, device, self.assisted)
                runtime.record_launch()
                flat, meta = program(wire, hi - lo)
            flats.append(flat.to(self.device))
            bounds.append((lo, hi))
        self.fold.submit(
            torch.stack(flats).reshape(-1), meta,
            item.built if self.assisted else None, shard_bounds=bounds,
        )


class DistributedScanPass(FusedScanPass):
    """The fused pass with each batch's rows sharded over `mesh` (every
    CUDA device of the process by default). `batch_size_per_device` rows
    per shard make a batch of `batch_size_per_device * mesh.size` rows.
    A partitioned source streams as one: the mesh pass never uses a
    state cache, as in the JAX package. Its trace is one `dist_scan`
    span over the run, with no `plan_fuse` or `fused_scan` of its own."""

    _scan_spans = False

    def __init__(
        self,
        analyzers: Sequence[ScanShareableAnalyzer],
        mesh: Optional[DeviceMesh] = None,
        batch_size_per_device: int = 1 << 21,
        controller=None,
    ):
        self.mesh = mesh if mesh is not None else data_mesh()
        self.batch_size_per_device = batch_size_per_device
        super().__init__(
            analyzers,
            batch_size=batch_size_per_device * self.mesh.size,
            device=self.mesh.devices[0],
            controller=controller,
        )

    def run(self, table: Table) -> List[AnalyzerRunResult]:
        runtime.record_mesh_pass(self.mesh.size)
        with observe.span(
            "dist_scan", cat="scan", devices=self.mesh.size, analyzers=len(self.analyzers)
        ):
            return self._run_single(table)

    def _pass_label(self, scan) -> str:
        return f"dist-scan[{self.mesh.size}x]:" + ",".join(a.name for a in self.analyzers)

    def _plan_decode(self, table, plan, live):
        # each shard packs its own wire from the built arrays: no column
        # decodes to the wire or folds encoded
        return plan_decode_fastpath(table, plan.specs)

    def _new_scan(self, plan) -> _MeshBatchScan:
        return _MeshBatchScan(
            self.mesh, self.batch_size_per_device, self._controller, self.analyzers, plan
        )


def sharded_bincount(codes: np.ndarray, nbins: int, mesh: DeviceMesh) -> np.ndarray:
    """Row-sharded group counting: each shard's dense group codes counted
    on its device (`torch.bincount`), the counts summed on the mesh's
    first device in shard order. A code of -1 (a null group) counts into
    a trash bin that is dropped. Returns int64 counts[nbins]."""
    per_dev = _pad_size(-(-len(codes) // mesh.size), 1 << 30)
    codes = np.where(codes >= 0, codes, nbins).astype(np.int64)
    total = None
    with observe.span(
        "group_bincount", cat="dispatch", rows=len(codes), bins=nbins, devices=mesh.size
    ):
        for d, device in enumerate(mesh.devices):
            shard = torch.from_numpy(codes[d * per_dev : (d + 1) * per_dev]).to(device)
            counts = torch.bincount(shard, minlength=nbins + 1).to(mesh.devices[0])
            runtime.record_launch()
            total = counts if total is None else total + counts
        return total[:nbins].cpu().numpy().astype(np.int64)


def run_distributed_analysis(
    table: Table,
    analyzers: Sequence[ScanShareableAnalyzer],
    mesh: Optional[DeviceMesh] = None,
    batch_size_per_device: int = 1 << 21,
):
    """The sharded pass -> AnalyzerContext."""
    from deequ_tpu_torch.runners.context import AnalyzerContext

    scan = DistributedScanPass(analyzers, mesh=mesh, batch_size_per_device=batch_size_per_device)
    metrics = {}
    for result in scan.run(table):
        a = result.analyzer
        if result.error is not None:
            metrics[a] = a.to_failure_metric(result.error)
        else:
            metrics[a] = a.compute_metric_from(result.state, scan.device)
    return AnalyzerContext(metrics)
