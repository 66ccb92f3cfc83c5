"""Multi-process runs: each process folds its own data, and only states
cross process boundaries.

Within a process, rows shard over the process's devices
(parallel/distributed.py). Across processes, each folds its own
partitions to per-analyzer states (bytes to kilobytes of sufficient
statistics), the processes exchange them serialized in the binary
layouts of the state providers (analyzers/state_provider.py) and the
state repository (repository/states.py), and every process folds the
semigroup and ends with the same table-level metrics. Rows never move,
and no state tensor crosses a process boundary on a device: the bytes
go through `torch.distributed` over gloo, on CPU tensors.

    from deequ_tpu_torch.data.source import PartitionedParquetSource
    from deequ_tpu_torch.parallel import multihost

    multihost.initialize("127.0.0.1:29500", num_processes=2, process_id=rank)
    try:
        context = multihost.run_sharded_analysis(PartitionedParquetSource(paths), analyzers)
    finally:
        multihost.shutdown()

`run_sharded_analysis` assigns the dataset's partitions to processes by
rendezvous hash (parallel/shard.py), folds each through the solo
partitioned scan's sub-scan, and merges per-partition state envelopes in
one all-gather, in the dataset's partition order: bit for bit a solo
run at any shard count. The older `run_multihost_analysis` (deprecated)
takes this process's part as an in-memory Table. With one process
(no group initialized) both run locally.

The JAX counterpart is deequ_tpu/parallel/multihost.py
(`jax.distributed` and `process_allgather`).
"""

from __future__ import annotations

import datetime
import hashlib
import struct
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deequ_tpu_torch import observe
from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.analyzers.state_provider import (
    InMemoryStateProvider,
    deserialize_state,
    serialize_state,
)
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.observe import counters
from deequ_tpu_torch.testing import faults
from deequ_tpu_torch.runners.context import AnalyzerContext


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    backend: str = "gloo",
    timeout_s: float = 120.0,
) -> None:
    """Join the process group (`torch.distributed.init_process_group`)
    at `coordinator_address` ("host:port" or "tcp://host:port"). A rank
    that does not arrive within `timeout_s` fails the group's start, and
    a collective that waits longer fails too: a run never hangs on a
    lost process. Call `shutdown()` before the process exits."""
    import torch.distributed as dist

    address = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend,
        init_method=address,
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def shutdown() -> None:
    """Leave the process group (a process that exits without it may hang
    at exit)."""
    import torch.distributed as dist

    global _BYTES_GROUP
    _BYTES_GROUP = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank, 0 when no group is initialized."""
    import torch.distributed as dist

    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    """The group's size, 1 when no group is initialized."""
    import torch.distributed as dist

    return dist.get_world_size() if _initialized() else 1


def global_data_mesh():
    """The mesh over this process's CUDA devices. A device mesh across
    processes is not supported: with more than one process this raises
    (processes exchange states through `allgather_bytes` instead)."""
    if process_count() > 1:
        raise NotImplementedError(
            "a device mesh across processes is not supported; shard the data "
            "over processes with run_sharded_analysis"
        )
    from deequ_tpu_torch.parallel.distributed import data_mesh

    return data_mesh()


_BYTES_GROUP = None


def _bytes_group():
    """The group the state bytes travel on: the default group when it is
    gloo, else a gloo group of its own (made collectively, on the first
    exchange), since the bytes are CPU tensors."""
    import torch.distributed as dist

    global _BYTES_GROUP
    if dist.get_backend() == "gloo":
        return None
    if _BYTES_GROUP is None:
        _BYTES_GROUP = dist.new_group(backend="gloo")
    return _BYTES_GROUP


def allgather_bytes(payload: bytes) -> List[bytes]:
    """One variable-length byte string from every process, in rank order:
    the lengths in one all-gather, then the payloads padded to the
    longest in a second. With one process, the identity."""
    n = process_count()
    if n == 1:
        return [payload]
    import torch.distributed as dist

    group = _bytes_group()
    lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(lengths, torch.tensor([len(payload)], dtype=torch.int64), group=group)
    sizes = [int(t.item()) for t in lengths]
    buf = torch.zeros(max(max(sizes), 1), dtype=torch.uint8)
    if payload:
        buf[: len(payload)] = torch.from_numpy(np.frombuffer(payload, dtype=np.uint8).copy())
    gathered = [torch.zeros_like(buf) for _ in range(n)]
    dist.all_gather(gathered, buf, group=group)
    return [gathered[i][: sizes[i]].numpy().tobytes() for i in range(n)]


# envelope tags: one process's contribution per analyzer
_EMPTY = b"\x00"  # no state (every row NULL in this part)
_STATE = b"\x01"  # a serialized state follows
_FAILED = b"\x02"  # the analyzer failed here; a utf-8 message follows


def analyzer_list_digest(analyzers: Sequence[Analyzer]) -> bytes:
    """8-byte digest of the (deduplicated, ordered) analyzer list that
    leads every state envelope; every process must give the same."""
    return hashlib.sha1("\x1f".join(repr(a) for a in analyzers).encode("utf-8")).digest()[:8]


def _dedup(analyzers: Sequence[Analyzer]) -> List[Analyzer]:
    seen = set()
    unique: List[Analyzer] = []
    for analyzer in analyzers:
        if analyzer not in seen:
            seen.add(analyzer)
            unique.append(analyzer)
    return unique


def merge_states_across_hosts(
    analyzers: Sequence[Analyzer], local_states, gather=allgather_bytes, local_errors=None
) -> tuple:
    """All-gather and fold every analyzer's state across processes: all
    the analyzers' tagged payloads ride one envelope per process, in one
    gather. Returns (merged InMemoryStateProvider, errors), `errors`
    mapping an analyzer to the first failure any process reported: a
    failure anywhere fails the global metric, never shrinks it. An empty
    local state contributes nothing. `gather` is injectable (it takes
    this process's envelope and returns every process's)."""
    analyzers = _dedup(analyzers)
    merged = InMemoryStateProvider()
    errors: Dict[Analyzer, str] = {}
    local_errors = local_errors or {}
    # the envelope decodes positionally against the local list: a digest
    # of the list leads it, so processes with other lists fail loudly
    digest = analyzer_list_digest(analyzers)
    parts: List[bytes] = [digest]
    for analyzer in analyzers:
        if analyzer in local_errors:
            payload = _FAILED + str(local_errors[analyzer]).encode("utf-8")
        else:
            state = local_states.load(analyzer)
            payload = _EMPTY if state is None else _STATE + serialize_state(analyzer, state)
        parts.append(struct.pack(">i", len(payload)))
        parts.append(payload)
    envelope = b"".join(parts)
    with observe.span(
        "state_allgather", cat="transfer", analyzers=len(analyzers), envelope_bytes=len(envelope)
    ):
        host_envelopes = gather(envelope)
    with observe.span(
        "state_merge", cat="merge", analyzers=len(analyzers), hosts=len(host_envelopes)
    ):
        for envelope in host_envelopes:
            if envelope[:8] != digest:
                raise ValueError(
                    "multihost analyzer-list mismatch: a process sent a state envelope "
                    "for another analyzer set or order; every process must pass the "
                    "same analyzer list"
                )
            offset = 8
            for analyzer in analyzers:
                (length,) = struct.unpack(">i", envelope[offset : offset + 4])
                offset += 4
                blob = envelope[offset : offset + length]
                offset += length
                tag, body = blob[:1], blob[1:]
                if tag == _FAILED and analyzer not in errors:
                    errors[analyzer] = body.decode("utf-8")
                if tag != _STATE:
                    continue
                other = deserialize_state(analyzer, body)
                prev = merged.load(analyzer)
                merged.persist(analyzer, other if prev is None else prev.merge(other))
    return merged, errors


def run_sharded_analysis(
    source,
    analyzers: Sequence[Analyzer],
    *,
    shard: Optional[int] = None,
    num_shards: Optional[int] = None,
    exclude: Sequence[int] = (),
    state_repository=None,
    dataset_name: str = "default",
    engine: str = "auto",
    mesh=None,
    gather=allgather_bytes,
    controller=None,
    cancel_token=None,
    batch_size: Optional[int] = None,
    device=None,
) -> AnalyzerContext:
    """The sharded streaming scan: this process folds its own slice of a
    `PartitionedParquetSource` (parallel/shard.py), partition by
    partition through the solo partitioned scan's sub-scan
    (ops/fused.py:scan_partition) on `device` (CUDA unless the caller
    asks for the CPU), saving each clean partition's states to
    `state_repository`; then every process exchanges its per-partition
    state envelopes (repository/states.py:encode_shard_states) in ONE
    `gather` and folds them in the dataset's partition order.

    Bit-identity: a partition's states come from the sub-scan a solo run
    uses, under the same (dataset, plan signature, fingerprint) keys,
    and merge in the solo run's order, so a sharded run at any shard
    count equals the solo run bit for bit, and the two share a state
    repository. Gathered envelopes signed under another plan raise.

    Recovery: a shard envelope that is missing or does not decode (a lost
    process), or a partition entry that does not decode, falls back to
    the states this process holds, then to the state repository, then to
    a local rescan: the same fold, the same bits (DQ320 warnings).

    Cancellation (`controller`, and a cross-process `cancel_token`,
    core/controller.SharedCancelToken): a cancel never unwinds past the
    gather. The cancelled shard stops at a partition boundary, still
    gathers an envelope flagged cancelled, and every shard raises
    RunCancelled after the exchange.

    `shard`/`num_shards` default to `process_index()`/`process_count()`;
    `exclude` plans around lost shards; `gather` is injectable, so an
    N-shard run can be driven in one process. Analyzers that are not
    scan-shareable (grouping, Histogram) run over this shard's subset
    and merge through `merge_states_across_hosts`, a second gather."""
    from deequ_tpu_torch.analyzers.base import Preconditions, ScanShareableAnalyzer
    from deequ_tpu_torch.analyzers.grouping import GroupingAnalyzer
    from deequ_tpu_torch.core.controller import RunCancelled
    from deequ_tpu_torch.core.exceptions import EmptyStateException, MetricCalculationException
    from deequ_tpu_torch.core.metrics import Metric
    from deequ_tpu_torch.ops import runtime
    from deequ_tpu_torch.ops.fused import scan_partition
    from deequ_tpu_torch.parallel.shard import plan_shards
    from deequ_tpu_torch.repository.states import (
        StateDecodeError,
        decode_shard_states,
        decode_states,
        encode_shard_states,
        encode_states,
        merge_states,
        plan_signature_for,
    )
    from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner

    device = runtime.resolve_device(device)
    analyzers = _dedup(analyzers)
    shard = int(process_index() if shard is None else shard)
    num_shards = int(process_count() if num_shards is None else num_shards)
    if not 0 <= shard < num_shards:
        raise ValueError(f"shard {shard} out of range for {num_shards} shards")

    # preconditions against the whole dataset's schema: every shard
    # agrees on the analyzers that run (envelopes decode positionally)
    passed: List[Analyzer] = []
    failure_map: Dict[Analyzer, Metric] = {}
    for a in analyzers:
        err = Preconditions.find_first_failing(source, a.preconditions())
        if err is None:
            passed.append(a)
        else:
            failure_map[a] = a.to_failure_metric(err)
    shareable = [
        a for a in passed
        if isinstance(a, ScanShareableAnalyzer) and not isinstance(a, GroupingAnalyzer)
    ]
    rest = [a for a in passed if a not in shareable]

    all_parts = list(source.partitions())
    parts_by_name = {p.name: p for p in all_parts}
    plan = plan_shards(all_parts, num_shards, exclude=exclude)
    mine = plan.assignment(shard)
    ctl = controller
    if ctl is not None and cancel_token is not None:
        ctl.bind_shared_cancel(cancel_token)
    repo = state_repository if runtime.state_cache_enabled() else None
    metrics: Dict[Analyzer, Metric] = {}
    merge_bytes = 0

    if shareable:
        signature = plan_signature_for(shareable, source, batch_size, device=device)
        entries: List[tuple] = []
        # states of partitions scanned here that could not ship (an
        # analyzer failed): recovery reads them before a second rescan
        local_states_by_fp: Dict[str, List] = {}
        scan_errors: Dict[Analyzer, BaseException] = {}
        cancelled = False
        cancel_reason = ""
        cached_n = scanned_n = 0

        def scan_one(part):
            """One partition through the solo sub-scan; saved when clean.
            -> (states, pairs, clean)."""
            results = scan_partition(
                shareable, part, batch_size=batch_size, device=device, controller=ctl
            )
            for a, r in zip(shareable, results):
                if r.error is not None and a not in scan_errors:
                    scan_errors[a] = r.error
            clean = all(r.error is None for r in results)
            pairs = [(r.analyzer, r.state if r.error is None else None) for r in results]
            if repo is not None and clean:
                with observe.span("state_cache", cat="cache", op="save", partition=part.name):
                    repo.save_states(dataset_name, part.fingerprint, signature, pairs)
            return [state for _a, state in pairs], pairs, clean

        for part in (parts_by_name[n] for n in mine.names):
            try:
                if ctl is not None:
                    ctl.check(
                        where=f"shard {shard} partition {part.name}",
                        progress={
                            "shard": shard,
                            "partitions_done": cached_n + scanned_n,
                            "partitions_total": mine.num_partitions,
                            "partitions_cached": cached_n,
                        },
                        boundary=True,
                    )
                states = None
                if repo is not None:
                    sp = observe.span("state_cache", cat="cache", op="load", partition=part.name)
                    with sp:
                        states = repo.load_states(
                            dataset_name, part.fingerprint, signature, shareable
                        )
                        if sp:
                            sp.set(hit=states is not None)
                if states is not None:
                    # re-encoding decoded states gives the saved bytes
                    # (the state serde round-trips bit for bit)
                    entries.append((part.fingerprint, encode_states(list(zip(shareable, states)))))
                    cached_n += 1
                else:
                    states, pairs, clean = scan_one(part)
                    scanned_n += 1
                    if clean:
                        entries.append((part.fingerprint, encode_states(pairs)))
                    else:
                        # an errored partition never ships: each shard
                        # rescans it and meets the failure itself
                        local_states_by_fp[part.fingerprint] = states
            except RunCancelled as rc:
                # flag the envelope and gather: no shard waits in a dead
                # collective
                cancelled = True
                cancel_reason = rc.reason
                if cancel_token is not None:
                    cancel_token.trip(rc.reason)
                break

        envelope = encode_shard_states(
            shard, signature, entries, cancelled=cancelled, reason=cancel_reason
        )
        lost_directive = faults.fault_point("shard.host_loss")
        with observe.span(
            "shard_allgather", cat="transfer", shard=shard, shards=num_shards,
            envelope_bytes=len(envelope),
        ):
            shard_envelopes = list(gather(envelope))
        if lost_directive == "lost":
            # chaos: the next shard's contribution vanishes after the exchange
            shard_envelopes[(shard + 1) % len(shard_envelopes)] = b""
        merge_bytes = sum(len(e) for e in shard_envelopes)
        decoded = []
        for i, env in enumerate(shard_envelopes):
            try:
                decoded.append(decode_shard_states(env))
            except StateDecodeError as e:
                warnings.warn(
                    f"DQ320: shard envelope {i} is unusable ({e}); its partitions "
                    "fall back to committed states or a rescan",
                    RuntimeWarning,
                    stacklevel=2,
                )
        for env in decoded:
            if env.signature != signature:
                raise ValueError(
                    f"sharded-scan plan-signature mismatch: shard {env.shard} folded "
                    f"under {env.signature!r}, this shard under {signature!r}; every "
                    "shard must run the same plan with the same runtime knobs"
                )
        remote_cancel = next(((e.reason or "cancelled") for e in decoded if e.cancelled), None)
        if cancelled or remote_cancel is not None:
            if cancel_token is not None:
                cancel_token.trip(cancel_reason or remote_cancel)
            raise RunCancelled(
                cancel_reason or remote_cancel,
                where=f"shard {shard}",
                progress={
                    "shard": shard,
                    "partitions_done": cached_n + scanned_n,
                    "partitions_total": mine.num_partitions,
                },
            )

        blob_by_fp: Dict[str, bytes] = {}
        for env in decoded:
            for fp, blob in env.entries:
                blob_by_fp.setdefault(fp, blob)
        merged: List = [None] * len(shareable)
        # the dataset's partition order: a solo run's merge order
        with observe.span(
            "shard_merge", cat="merge", shard=shard, shards=len(shard_envelopes),
            partitions=len(plan.order),
        ):
            for name, _path, fp in plan.order:
                states = None
                blob = blob_by_fp.get(fp)
                if blob is not None:
                    if faults.fault_point("shard.merge") == "corrupt":
                        blob = blob[:-1]
                    try:
                        states = decode_states(blob, shareable)
                    except StateDecodeError as e:
                        warnings.warn(
                            f"DQ320: gathered states for partition {name!r} are unusable "
                            f"({e}); falling back to committed states or a rescan",
                            RuntimeWarning,
                            stacklevel=2,
                        )
                if states is None:
                    # a lost shard or a bad entry: what this process holds,
                    # then the repository, then a rescan; the same fold
                    states = local_states_by_fp.get(fp)
                    if states is None and repo is not None:
                        states = repo.load_states(dataset_name, fp, signature, shareable)
                    if states is None:
                        states, _pairs, _clean = scan_one(parts_by_name[name])
                        scanned_n += 1
                merged = [merge_states(m, s) for m, s in zip(merged, states)]

        for a, state in zip(shareable, merged):
            if a in scan_errors:
                metrics[a] = a.to_failure_metric(scan_errors[a])
            else:
                metrics[a] = a.compute_metric_from(state, device)
        counters.record_state_cache(cached_n, scanned_n, mine.num_partitions)

    if rest:
        local_provider = InMemoryStateProvider()
        local_errors: Dict[Analyzer, object] = {}
        rest_cancel = None
        if mine.num_partitions:
            try:
                local_context = AnalysisRunner.do_analysis_run(
                    source.subset(list(mine.paths)),
                    rest,
                    device,
                    save_states_with=local_provider,
                    engine=engine,
                    mesh=mesh,
                    controller=ctl,
                )
                local_errors = {
                    a: metric.value.exception
                    for a, metric in local_context.metric_map.items()
                    if metric.value.is_failure
                    and not isinstance(metric.value.exception, EmptyStateException)
                }
            except RunCancelled as rc:
                # the same rule: contribute a failure per analyzer, so the
                # other shards fail these metrics instead of shrinking them
                rest_cancel = rc
                if cancel_token is not None:
                    cancel_token.trip(rc.reason)
                local_errors = {a: f"shard {shard} cancelled: {rc.reason}" for a in rest}
        merged_rest, rest_errors = merge_states_across_hosts(
            rest, local_provider, gather=gather, local_errors=local_errors
        )
        if rest_cancel is not None:
            raise rest_cancel
        for a in rest:
            if a in rest_errors:
                metrics[a] = a.to_failure_metric(MetricCalculationException(rest_errors[a]))
            else:
                metrics[a] = a.compute_metric_from(merged_rest.load(a), device)

    rows_local = 0
    if mine.num_partitions:
        import pyarrow.parquet as pq

        for path in mine.paths:
            with pq.ParquetFile(path) as pf:
                rows_local += int(pf.metadata.num_rows)
    counters.record_shard_scan(
        shard, num_shards, mine.num_partitions, plan.max_partitions, len(plan.order),
        merge_bytes, rows_local,
    )
    metrics.update(failure_map)
    return AnalyzerContext(metrics)


def run_multihost_analysis(
    local_table: Table,
    analyzers: Sequence[Analyzer],
    mesh=None,
    engine: str = "auto",
    gather=allgather_bytes,
    save_states_with=None,
    device=None,
) -> AnalyzerContext:
    """DEPRECATED: this process's part must already sit in memory as a
    Table; use `run_sharded_analysis` over a `PartitionedParquetSource`.

    Analyze the local part on `device`, then merge the states across all
    processes: every process ends with the same table-level metrics. A
    failure on any process fails that analyzer's metric on every process.
    `save_states_with` receives this process's local states (read-only:
    the merge serializes the same objects)."""
    warnings.warn(
        "run_multihost_analysis is deprecated: it takes an in-memory Table and "
        "bypasses the streamed scan path. Use run_sharded_analysis with a "
        "PartitionedParquetSource instead.",
        DeprecationWarning,
        stacklevel=2,
    )
    from deequ_tpu_torch.core.exceptions import EmptyStateException, MetricCalculationException
    from deequ_tpu_torch.ops import runtime
    from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner

    device = runtime.resolve_device(device)
    analyzers = _dedup(analyzers)
    local_states = InMemoryStateProvider()
    local_context = AnalysisRunner.do_analysis_run(
        local_table, analyzers, device, save_states_with=local_states, engine=engine, mesh=mesh
    )
    if save_states_with is not None:
        for analyzer in analyzers:
            state = local_states.load(analyzer)
            if state is not None:
                save_states_with.persist(analyzer, state)
    # an all-NULL local part is an empty contribution, not a failure
    local_errors = {
        analyzer: metric.value.exception
        for analyzer, metric in local_context.metric_map.items()
        if metric.value.is_failure and not isinstance(metric.value.exception, EmptyStateException)
    }
    merged, errors = merge_states_across_hosts(
        analyzers, local_states, gather=gather, local_errors=local_errors
    )
    metrics = {}
    for analyzer in analyzers:
        if analyzer in errors:
            metrics[analyzer] = analyzer.to_failure_metric(MetricCalculationException(errors[analyzer]))
        else:
            metrics[analyzer] = analyzer.compute_metric_from(merged.load(analyzer), device)
    return AnalyzerContext(metrics)
