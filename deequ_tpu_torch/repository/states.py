"""Persistent partition-state cache: incremental scans as a pure merge.

The reference's core algebra — every analyzer folds its data into a
mergeable sufficient statistic (`State.sum`, a commutative semigroup;
reference: analyzers/Analyzer.scala:48-76) — exists precisely so that
metrics become *incrementally* computable: fold each shard once, merge
forever after. This module is that promise made persistent. After a
partitioned scan, every partition's folded states are serialized to one
compact versioned envelope and stored keyed by

    (dataset, plan signature, partition fingerprint)

where the fingerprint hashes the parquet file's name, size and
row-group metadata (`data/source.py:partition_fingerprint`) so any
modified partition self-invalidates, and the plan signature
(`plan_signature`) hashes everything that changes the fold arithmetic —
analyzer set and order, placement, compute dtype, batch sizing, serde
version — so a cached state is only ever reused by a plan that would
have produced the identical bytes. On the next run the fused pass
(`ops/fused.py:FusedScanPass._run_partitioned`) scans only partitions
without a usable entry and merges everything through the existing
`State.merge` surface in deterministic partition order — bit-identical
to a full rescan, at a cost proportional to NEW data only.

Safety contract:

* writes are atomic (fsio tmp + rename) and serialized per dataset by
  an advisory lock file, so concurrent suite runs never interleave
  partial state files;
* a corrupt, truncated or version-bumped entry NEVER produces a wrong
  answer: the envelope carries a trailing sha256 digest and every
  decode failure degrades to a rescan of that partition, surfaced as a
  DQ314 lenient warning;
* `pickle` is banned from this path (tools/lint.py SERDE rule) — the
  payloads are the exact-width binary formats of
  `analyzers/state_provider.py`, which round-trip bit-exactly.

`merge_range(...)` answers "metrics over these partitions" as a pure
state merge with zero scan (the persistent analogue of
`AnalysisRunner.run_on_aggregated_states`).

The JAX counterpart is deequ_tpu/repository/states.py; both write the
same envelopes for the same states, and the same signature where the
fold arithmetic is the same.
"""

from __future__ import annotations

import hashlib
import os
import struct
import threading
import warnings
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from deequ_tpu_torch.core.fsio import FileSystem, LocalFileSystem, resolve_filesystem
from deequ_tpu_torch.testing import faults

#: envelope magic — "DeeQu STate"; bump STATE_FORMAT_VERSION whenever
#: any per-family payload format in analyzers/state_provider.py changes
STATE_MAGIC = b"DQST"
STATE_FORMAT_VERSION = 1

_DIGEST = hashlib.sha256
_DIGEST_LEN = 32


class StateDecodeError(ValueError):
    """A state-cache entry that cannot be decoded (corrupt, truncated,
    version-mismatched, or missing an analyzer). Callers treat it as a
    cache miss — rescan, never a wrong answer."""


def _warn_fallback(dataset: str, fingerprint: str, reason: str) -> None:
    """The DQ314 lenient warning: one line, machine-greppable code."""
    warnings.warn(
        f"DQ314: state-cache entry for dataset {dataset!r} partition "
        f"{fingerprint[:12]}… is unusable ({reason}); the partition "
        "falls back to a rescan",
        RuntimeWarning,
        stacklevel=3,
    )


# -- plan signature -----------------------------------------------------------


def plan_signature(
    analyzers: Sequence[Any],
    *,
    placement: str,
    compute_dtype: str,
    batch_size: Optional[int],
    batch_rows: Optional[int],
    variant: str = "",
) -> str:
    """Hash of every knob that changes the fold arithmetic of a fused
    pass: the analyzer reprs IN PASS ORDER, the placement mode, the
    compute dtype, the explicit batch size (None = engine default), the
    source's per-batch row cap, and the serde version. Deliberately
    EXCLUDED: pipeline/pushdown/decode/wire knobs — the differential
    suites prove those bit-identical, so toggling them must not evict
    the cache. `variant` names a fold-arithmetic variant that is NOT
    bit-identical to the default (here "cuda-folds", the moment folds of
    the CUDA kernels) — the empty default leaves signatures unchanged.

    A CPU run's variant (runtime.fold_signature_variant: "" or, with
    the encoded fold possible, "encfold") is the JAX package's, so under
    the same knobs the two packages sign a pass alike and share a
    repository. Bit-identity holds within one package only: the torch
    CPU fold and the XLA fold add in other orders, so a cache filled by
    both matches a rescan within the parity tolerance (1e-12 relative on
    float sums), not bit for bit."""
    h = _DIGEST()
    h.update(STATE_MAGIC)
    h.update(struct.pack(">I", STATE_FORMAT_VERSION))
    h.update(str(placement).encode("utf-8") + b"\x00")
    h.update(str(compute_dtype).encode("utf-8") + b"\x00")
    h.update(str(batch_size).encode("utf-8") + b"\x00")
    h.update(str(batch_rows).encode("utf-8") + b"\x00")
    if variant:
        h.update(b"variant:" + variant.encode("utf-8") + b"\x00")
    for a in analyzers:
        h.update(repr(a).encode("utf-8") + b"\x00")
    return h.hexdigest()[:32]


def plan_signature_for(
    analyzers: Sequence[Any],
    source: Any = None,
    batch_size: Optional[int] = None,
    device: Any = None,
) -> str:
    """`plan_signature` with placement, dtype and fold variant read from
    the runtime for `device` (resolved as the runners resolve it: CUDA
    unless the caller asks for ``"cpu"``) — the exact signature
    `FusedScanPass._run_partitioned` computes for these analyzers over
    `source` on that device."""
    from deequ_tpu_torch.ops import runtime

    device = runtime.resolve_device(device)
    batch_rows = getattr(source, "batch_rows", None) if source is not None else None
    return plan_signature(
        analyzers,
        placement=runtime.placement_mode(device),
        compute_dtype=dtype_name(runtime.compute_dtype()),
        batch_size=batch_size,
        batch_rows=int(batch_rows) if batch_rows else None,
        variant=runtime.fold_signature_variant(device),
    )


def dtype_name(dtype) -> str:
    """A torch dtype's numpy name ("float64"), the string the plan
    signature hashes in both packages (numpy cannot read a torch dtype)."""
    return str(dtype).rsplit(".", 1)[-1]


# -- versioned envelope -------------------------------------------------------


def encode_states(pairs: Sequence[Tuple[Any, Any]]) -> bytes:
    """Serialize `(analyzer, state)` pairs into one versioned envelope:

        DQST | version u32 | count u32 |
          ( repr_len u32 | repr utf8 | flag u8 | payload_len u32 | payload )*
        | sha256(previous bytes)

    Per-analyzer payloads are the exact-width binary formats of
    `analyzers/state_provider.py:serialize_state` (bit-exact round
    trips); flag 0 marks a None state (analyzer produced no state on
    this partition — merges as the identity). Raises ValueError when
    any analyzer has no serde — the partition is then not cacheable."""
    from deequ_tpu_torch.analyzers.state_provider import serialize_state

    body = bytearray()
    body += STATE_MAGIC
    body += struct.pack(">I", STATE_FORMAT_VERSION)
    body += struct.pack(">I", len(pairs))
    for analyzer, state in pairs:
        payload = b"" if state is None else serialize_state(analyzer, state)
        rep = repr(analyzer).encode("utf-8")
        body += struct.pack(">I", len(rep)) + rep
        body += struct.pack(">B", 0 if state is None else 1)
        body += struct.pack(">I", len(payload)) + payload
    return bytes(body) + _DIGEST(bytes(body)).digest()


def decode_states(blob: bytes, analyzers: Sequence[Any]) -> List[Any]:
    """Inverse of `encode_states`, validated end to end: digest first
    (corruption), then magic/version (format drift), then per-entry
    bounds (truncation), then per-analyzer presence. Any failure raises
    `StateDecodeError` — the caller rescans that partition. Returns one
    state (or None) per requested analyzer, in request order."""
    from deequ_tpu_torch.analyzers.state_provider import deserialize_state

    if len(blob) < len(STATE_MAGIC) + 8 + _DIGEST_LEN:
        raise StateDecodeError("truncated envelope")
    body, digest = blob[:-_DIGEST_LEN], blob[-_DIGEST_LEN:]
    if _DIGEST(body).digest() != digest:
        raise StateDecodeError("integrity digest mismatch")
    if body[: len(STATE_MAGIC)] != STATE_MAGIC:
        raise StateDecodeError("bad magic")
    off = len(STATE_MAGIC)
    version, count = struct.unpack_from(">II", body, off)
    off += 8
    if version != STATE_FORMAT_VERSION:
        raise StateDecodeError(
            f"state format version {version} != {STATE_FORMAT_VERSION}"
        )
    entries: Dict[str, Tuple[int, bytes]] = {}
    try:
        for _ in range(count):
            (rep_len,) = struct.unpack_from(">I", body, off)
            off += 4
            rep = body[off : off + rep_len].decode("utf-8")
            if len(rep.encode("utf-8")) != rep_len:
                raise StateDecodeError("truncated entry name")
            off += rep_len
            (flag,) = struct.unpack_from(">B", body, off)
            off += 1
            (payload_len,) = struct.unpack_from(">I", body, off)
            off += 4
            payload = body[off : off + payload_len]
            if len(payload) != payload_len:
                raise StateDecodeError("truncated entry payload")
            off += payload_len
            entries[rep] = (flag, payload)
    except struct.error as e:
        raise StateDecodeError(f"truncated envelope: {e}") from e
    if off != len(body):
        raise StateDecodeError("trailing bytes after last entry")
    out: List[Any] = []
    for analyzer in analyzers:
        entry = entries.get(repr(analyzer))
        if entry is None:
            raise StateDecodeError(f"no state for analyzer {analyzer!r}")
        flag, payload = entry
        if flag == 0:
            out.append(None)
            continue
        try:
            out.append(deserialize_state(analyzer, payload))
        except Exception as e:  # noqa: BLE001 — any payload defect = unusable
            raise StateDecodeError(
                f"payload for {analyzer!r} does not decode: {e}"
            ) from e
    return out


# -- shard envelope (the sharded scan, parallel/multihost.py) ------------------

#: magic of one shard's gathered contribution: its per-partition DQST
#: envelopes and its cancel status, versioned apart from DQST
SHARD_MAGIC = b"DQSH"
SHARD_FORMAT_VERSION = 1


@dataclass
class ShardEnvelope:
    """One shard's decoded contribution to the cross-process merge: which
    shard, under which plan signature, whether it was cancelled (and
    why), and its (partition fingerprint, DQST envelope) entries in the
    shard's partition order."""

    shard: int
    signature: str
    cancelled: bool
    reason: str
    entries: List[Tuple[str, bytes]]


def encode_shard_states(
    shard: int,
    signature: str,
    entries: Sequence[Tuple[str, bytes]],
    *,
    cancelled: bool = False,
    reason: str = "",
) -> bytes:
    """One shard's per-partition state envelopes, for the all-gather:

        DQSH | version u32 | shard u32 | flags u8 (bit0 = cancelled) |
          reason_len u32 | reason utf8 | sig_len u32 | signature utf8 |
          count u32 | ( fp_len u32 | fingerprint utf8 |
                        blob_len u32 | DQST blob )*
        | sha256(previous bytes)

    Each blob is the `encode_states` envelope the shard saved to its
    state repository, so the merge decodes a partition exactly as a
    resumed solo run loads it. A cancelled shard still gathers (with its
    flag set), and every shard raises after the exchange. The bytes are
    the JAX package's for the same entries."""
    body = bytearray()
    body += SHARD_MAGIC
    body += struct.pack(">I", SHARD_FORMAT_VERSION)
    body += struct.pack(">I", int(shard))
    body += struct.pack(">B", 1 if cancelled else 0)
    reason_b = reason.encode("utf-8")
    body += struct.pack(">I", len(reason_b)) + reason_b
    sig_b = signature.encode("utf-8")
    body += struct.pack(">I", len(sig_b)) + sig_b
    body += struct.pack(">I", len(entries))
    for fingerprint, blob in entries:
        fp_b = fingerprint.encode("utf-8")
        body += struct.pack(">I", len(fp_b)) + fp_b
        body += struct.pack(">I", len(blob)) + blob
    return bytes(body) + _DIGEST(bytes(body)).digest()


def decode_shard_states(blob: bytes) -> ShardEnvelope:
    """Inverse of `encode_shard_states`, validated end to end as
    `decode_states` is. Any defect raises `StateDecodeError`: the caller
    treats the envelope as a lost shard and recovers its partitions from
    the state repository or by a rescan."""
    header = len(SHARD_MAGIC)
    if len(blob) < header + 8 + _DIGEST_LEN:
        raise StateDecodeError("truncated shard envelope")
    body, digest = blob[:-_DIGEST_LEN], blob[-_DIGEST_LEN:]
    if _DIGEST(body).digest() != digest:
        raise StateDecodeError("shard envelope digest mismatch")
    if body[:header] != SHARD_MAGIC:
        raise StateDecodeError("bad shard magic")
    off = header
    try:
        version, shard = struct.unpack_from(">II", body, off)
        off += 8
        if version != SHARD_FORMAT_VERSION:
            raise StateDecodeError(f"shard format version {version} != {SHARD_FORMAT_VERSION}")
        (flags,) = struct.unpack_from(">B", body, off)
        off += 1
        (reason_len,) = struct.unpack_from(">I", body, off)
        off += 4
        reason = body[off : off + reason_len].decode("utf-8")
        off += reason_len
        (sig_len,) = struct.unpack_from(">I", body, off)
        off += 4
        signature = body[off : off + sig_len].decode("utf-8")
        off += sig_len
        (count,) = struct.unpack_from(">I", body, off)
        off += 4
        entries: List[Tuple[str, bytes]] = []
        for _ in range(count):
            (fp_len,) = struct.unpack_from(">I", body, off)
            off += 4
            fingerprint = body[off : off + fp_len].decode("utf-8")
            if len(fingerprint.encode("utf-8")) != fp_len:
                raise StateDecodeError("truncated shard entry fingerprint")
            off += fp_len
            (blob_len,) = struct.unpack_from(">I", body, off)
            off += 4
            entry = body[off : off + blob_len]
            if len(entry) != blob_len:
                raise StateDecodeError("truncated shard entry payload")
            off += blob_len
            entries.append((fingerprint, bytes(entry)))
    except struct.error as e:
        raise StateDecodeError(f"truncated shard envelope: {e}") from e
    if off != len(body):
        raise StateDecodeError("trailing bytes after last shard entry")
    return ShardEnvelope(
        shard=int(shard),
        signature=signature,
        cancelled=bool(flags & 1),
        reason=reason,
        entries=entries,
    )


def merge_states(a: Any, b: Any) -> Any:
    """Semigroup merge with None as the identity (an empty partition
    contributes no state)."""
    if a is None:
        return b
    if b is None:
        return a
    return a.merge(b)


# -- repositories -------------------------------------------------------------


class StateRepository:
    """Keyed blob store for partition-state envelopes plus the shared
    load/save/merge logic. Backends implement `_get` / `_put` /
    `_exists` over `(dataset, signature, fingerprint)` keys."""

    def _get(self, dataset: str, signature: str, fingerprint: str) -> Optional[bytes]:
        raise NotImplementedError

    def _put(self, dataset: str, signature: str, fingerprint: str, blob: bytes) -> None:
        raise NotImplementedError

    def _exists(self, dataset: str, signature: str, fingerprint: str) -> bool:
        raise NotImplementedError

    # -- raw envelope surface (windows/segments.py and other layered
    # -- caches store their own self-validated envelopes here) ---------------

    def get_blob(self, dataset: str, signature: str, key: str) -> Optional[bytes]:
        return self._get(dataset, signature, key)

    def put_blob(self, dataset: str, signature: str, key: str, blob: bytes) -> None:
        self._put(dataset, signature, key, blob)

    def has_blob(self, dataset: str, signature: str, key: str) -> bool:
        return self._exists(dataset, signature, key)

    # -- the cache surface the fused pass consumes ---------------------------

    def has_states(self, dataset: str, fingerprint: str, signature: str) -> bool:
        """Cheap probe: whether a partition has an entry, unread."""
        return self._exists(dataset, signature, fingerprint)

    def load_states(
        self,
        dataset: str,
        fingerprint: str,
        signature: str,
        analyzers: Sequence[Any],
    ) -> Optional[List[Any]]:
        """One state (or None) per analyzer, or None on any miss or
        decode failure (DQ314 lenient warning) — never a wrong answer."""
        try:
            faults.fault_point("state.load")
            blob = self._get(dataset, signature, fingerprint)
        except Exception as e:  # noqa: BLE001 — unreadable entry = miss
            _warn_fallback(dataset, fingerprint, f"unreadable: {e}")
            return None
        if blob is None:
            return None
        try:
            return decode_states(blob, analyzers)
        except StateDecodeError as e:
            _warn_fallback(dataset, fingerprint, str(e))
            return None

    def save_states(
        self,
        dataset: str,
        fingerprint: str,
        signature: str,
        pairs: Sequence[Tuple[Any, Any]],
    ) -> bool:
        """Best-effort atomic publish. False when any analyzer's state
        has no serde (the partition is not cacheable) or the write
        fails — the run itself is never affected."""
        try:
            blob = encode_states(pairs)
        except ValueError:
            return False
        try:
            faults.fault_point("state.save")
            self._put(dataset, signature, fingerprint, blob)
        except Exception:  # noqa: BLE001 — cache write must never break a run
            return False
        return True

    # -- accounting ----------------------------------------------------------

    def disk_usage(self, dataset: str) -> Optional[int]:
        """Bytes of state envelopes stored for `dataset`, or None when the
        backend cannot account for them (an opaque object store). The
        DQService holds a tenant's state-disk budget against this at
        admission and at every partition boundary."""
        return None

    # -- zero-scan range queries ---------------------------------------------

    def merge_range(
        self,
        dataset: str,
        fingerprints: Sequence[str],
        analyzers: Sequence[Any],
        signature: str,
        device: Any = None,
    ):
        """Metrics over a set of partitions as a PURE state merge — zero
        rows scanned ("metrics over the last N days"). States merge in
        the given fingerprint order through the same semigroup surface
        the fused pass uses, so the result is bit-identical to scanning
        those partitions together. A metric that reduces on a device (the
        frequency analyzers') does so on `device`, resolved as the
        runners resolve it: CUDA unless the caller asks for ``"cpu"``.
        Raises KeyError when any partition has no cached entry, and
        StateDecodeError when an entry is unusable — a range query must
        never silently drop data."""
        from deequ_tpu_torch import observe
        from deequ_tpu_torch.ops import runtime
        from deequ_tpu_torch.runners.context import AnalyzerContext

        device = runtime.resolve_device(device)

        merged: List[Any] = [None] * len(analyzers)
        with observe.span(
            "state_cache", cat="cache", op="merge_range", partitions=len(fingerprints)
        ):
            for fingerprint in fingerprints:
                blob = self._get(dataset, signature, fingerprint)
                if blob is None:
                    raise KeyError(
                        f"no cached states for dataset {dataset!r} "
                        f"partition {fingerprint!r} under signature "
                        f"{signature!r}"
                    )
                states = decode_states(blob, analyzers)
                merged = [merge_states(m, s) for m, s in zip(merged, states)]
        metrics = {
            analyzer: analyzer.compute_metric_from(state, device)
            for analyzer, state in zip(analyzers, merged)
        }
        return AnalyzerContext(metrics)


class InMemoryStateRepository(StateRepository):
    """Process-local backend (tests, notebooks): a locked dict of
    envelopes. Envelopes still round-trip through the binary format so
    the memory and fs backends exercise identical serde."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._blobs: Dict[Tuple[str, str, str], bytes] = {}

    def _get(self, dataset: str, signature: str, fingerprint: str) -> Optional[bytes]:
        with self._lock:
            return self._blobs.get((dataset, signature, fingerprint))

    def _put(self, dataset: str, signature: str, fingerprint: str, blob: bytes) -> None:
        with self._lock:
            self._blobs[(dataset, signature, fingerprint)] = bytes(blob)

    def _exists(self, dataset: str, signature: str, fingerprint: str) -> bool:
        with self._lock:
            return (dataset, signature, fingerprint) in self._blobs

    def disk_usage(self, dataset: str) -> Optional[int]:
        with self._lock:
            return sum(len(blob) for (ds, _sig, _fp), blob in self._blobs.items() if ds == dataset)


def _safe_component(name: str) -> str:
    """A dataset name as one path component: pass through simple names,
    hash anything with separators or exotic characters."""
    if name and all(c.isalnum() or c in "-_." for c in name):
        return name
    return "ds-" + hashlib.sha256(name.encode("utf-8")).hexdigest()[:16]


class FileSystemStateRepository(StateRepository):
    """Disk-backed repository:

        <base_path>/<dataset>/<signature>/<fingerprint>.dqstate

    Writes go through the fsio seam — atomic tmp + rename on the local
    filesystem, whole-object puts on stores — and are additionally
    serialized per dataset by an advisory `.lock` file (fcntl.flock on
    POSIX; a process-local lock elsewhere and for non-local backends),
    so concurrent suite runs over the same dataset can't interleave
    partial state files."""

    def __init__(self, base_path: str, filesystem: Optional[FileSystem] = None):
        self.base_path = base_path
        self.fs = resolve_filesystem(filesystem)
        self._local_locks: Dict[str, threading.Lock] = {}
        self._locks_guard = threading.Lock()

    def _path(self, dataset: str, signature: str, fingerprint: str) -> str:
        return os.path.join(
            self.base_path, _safe_component(dataset), signature,
            f"{fingerprint}.dqstate",
        )

    @contextmanager
    def _dataset_lock(self, dataset: str) -> Iterator[None]:
        """Per-dataset writer exclusion. Cross-process via flock on the
        local filesystem; in-process (threads) always, which also covers
        backends with no lockable files (memory/object stores, where the
        atomic whole-object put already prevents interleaving)."""
        key = _safe_component(dataset)
        with self._locks_guard:
            lock = self._local_locks.setdefault(key, threading.Lock())
        with lock:
            if not isinstance(self.fs, LocalFileSystem):
                yield
                return
            lock_path = os.path.join(self.base_path, key, ".lock")
            os.makedirs(os.path.dirname(lock_path), exist_ok=True)
            try:
                import fcntl
            except ImportError:  # non-POSIX: thread lock only
                yield
                return
            with open(lock_path, "a+b") as handle:
                fcntl.flock(handle.fileno(), fcntl.LOCK_EX)
                try:
                    yield
                finally:
                    fcntl.flock(handle.fileno(), fcntl.LOCK_UN)

    def _get(self, dataset: str, signature: str, fingerprint: str) -> Optional[bytes]:
        path = self._path(dataset, signature, fingerprint)
        if not self.fs.exists(path):
            return None
        return self.fs.read_bytes(path)

    def _put(self, dataset: str, signature: str, fingerprint: str, blob: bytes) -> None:
        with self._dataset_lock(dataset):
            self.fs.write_bytes(self._path(dataset, signature, fingerprint), blob)

    def _exists(self, dataset: str, signature: str, fingerprint: str) -> bool:
        return self.fs.exists(self._path(dataset, signature, fingerprint))

    def disk_usage(self, dataset: str) -> Optional[int]:
        """The sizes of the `.dqstate` envelopes under the dataset's
        directory, every signature summed. The local filesystem only:
        other backends give None (unknown), which the disk budget treats
        as within budget."""
        if not isinstance(self.fs, LocalFileSystem):
            return None
        root = os.path.join(self.base_path, _safe_component(dataset))
        if not os.path.isdir(root):
            return 0
        total = 0
        for dirpath, _dirnames, filenames in os.walk(root):
            for name in filenames:
                if name.endswith(".dqstate"):
                    try:
                        total += os.path.getsize(os.path.join(dirpath, name))
                    except OSError:  # fault-ok: a file deleted meanwhile counts 0
                        pass
        return total


@dataclass
class StateCacheContext:
    """What the fused pass needs to consult the cache: the repository
    and the dataset name the entries are keyed under. Built by
    `AnalysisRunBuilder.with_state_repository(...)` and threaded through
    `AnalysisRunner._run_scanning_analyzers` to `FusedScanPass`."""

    repository: StateRepository
    dataset: str


__all__ = [
    "STATE_FORMAT_VERSION",
    "STATE_MAGIC",
    "FileSystemStateRepository",
    "InMemoryStateRepository",
    "StateCacheContext",
    "StateDecodeError",
    "StateRepository",
    "decode_states",
    "encode_states",
    "merge_states",
    "plan_signature",
    "plan_signature_for",
]
