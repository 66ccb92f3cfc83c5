"""Execution runtime: the device a run uses, its compute dtype, where
reductions are placed (the bandwidth probe and its disk cache), the
fold-arithmetic tag a plan signature hashes, the knobs of the host fast
paths and the decode-to-wire records. `monitored()` and `ExecutionStats`
are observe/counters.py's, importable from here too.

Entry points run on CUDA unless the caller passes ``device="cpu"``. With
no device given and no CUDA device present a run raises: it never moves
to the CPU on its own, and a CUDA run whose placement probe fails raises
too.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch

from deequ_tpu_torch.observe.counters import ExecutionStats, monitored  # noqa: F401 - re-exported

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device a run uses: the caller's choice, else ``cuda``. Raises
    when the chosen device is CUDA and no CUDA device is present."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if resolved.index is None:
            resolved = torch.device("cuda", torch.cuda.current_device())
    elif resolved.type != "cpu":
        raise ValueError(f"unsupported device {resolved}; use 'cuda' or 'cpu'")
    return resolved


def compute_dtype() -> torch.dtype:
    """float64 on every device: the H100 folds f64 at memory speed, and
    f64 keeps device partials within the 1e-6 parity bound."""
    return torch.float64


# -- placement: where a reduction earns its bytes --------------------------------

#: a value reduction ships ~8 B/row and costs ~2 ns/row on the host, so the
#: device wins above ~2 GB/s links; discrete (mask/code-only) reductions
#: ship ~0.1-2 B/row against ~1 ns/row of host popcount and break even
#: around 100 MB/s (the JAX package's thresholds)
PLACEMENT_DEVICE_ALL_BANDWIDTH = 2e9  # bytes/s: everything on the device
PLACEMENT_BANDWIDTH_FLOOR = 100e6  # bytes/s: below, nothing earns the link
#: a cached probe is trusted this long, then measured again
PLACEMENT_CACHE_TTL_S = 7 * 24 * 3600
PLACEMENT_MODES = ("device", "host-discrete", "host-all")

_PLACEMENT_CACHE: Dict[str, str] = {}  # link key -> mode, for this process


def _timed(fn) -> float:
    start = time.perf_counter()
    fn()
    return time.perf_counter() - start


def measure_device_bandwidth(device: torch.device, nbytes: int = 4 << 20, iters: int = 3) -> float:
    """The link's bytes/s: copy a 4 MiB host array to `device`, sum it
    there and read the sum back (`.item()` synchronizes). The best of
    `iters` copies, less the best of `iters` one-element round trips, so
    the per-call latency does not make a fast link look slow."""
    data = torch.zeros(nbytes // 4, dtype=torch.float32)
    tiny = torch.zeros(1, dtype=torch.float32)

    def round_trip(t):
        return t.to(device).sum().item()

    round_trip(data)  # first use: allocator, context, kernel load
    round_trip(tiny)
    best = min(_timed(lambda: round_trip(data)) for _ in range(iters))
    dispatch = min(_timed(lambda: round_trip(tiny)) for _ in range(iters))
    return nbytes / max(best - dispatch, 1e-9)


def classify_bandwidth(bandwidth: float) -> str:
    """The placement a measured link earns: "device" above
    PLACEMENT_DEVICE_ALL_BANDWIDTH, "host-discrete" above
    PLACEMENT_BANDWIDTH_FLOOR, "host-all" below it."""
    if bandwidth >= PLACEMENT_DEVICE_ALL_BANDWIDTH:
        return "device"
    if bandwidth >= PLACEMENT_BANDWIDTH_FLOOR:
        return "host-discrete"
    return "host-all"


def placement_mode(device: DeviceLike = None) -> str:
    """Where a pass's reductions run:

      "device"         every member in the fused device pass;
      "host-discrete"  the mask- and code-only members (Size, the ratio
                       analyzers, DataType, ApproxCountDistinct) fold on
                       the host, the value-dense ones on the device;
      "host-all"       every member folds on the host and the device
                       program is skipped.

    ``DEEQU_TPU_PLACEMENT`` picks one (``host`` is ``host-all``); unset or
    ``auto`` decides by the link: a CPU run (`device` resolving to the
    CPU) has no link and places as "device"; a CUDA run measures the
    link once (`measure_device_bandwidth`) and keeps the measurement on
    disk per host and card for PLACEMENT_CACHE_TTL_S. A probe that fails
    raises: a run never leaves the card on its own."""
    env = os.environ.get("DEEQU_TPU_PLACEMENT", "auto")
    if env == "device":
        return "device"
    if env in ("host", "host-all"):
        return "host-all"
    if env == "host-discrete":
        return "host-discrete"
    if env != "auto":
        raise ValueError(
            f"DEEQU_TPU_PLACEMENT={env!r}: expected auto, device, host, "
            "host-all or host-discrete"
        )
    resolved = resolve_device(device)
    if resolved.type != "cuda":
        return "device"
    key = _platform_key(resolved)
    mode = _PLACEMENT_CACHE.get(key)
    if mode is None:
        bandwidth = _load_bandwidth_from_disk(key)
        if bandwidth is None:
            bandwidth = measure_device_bandwidth(resolved)
            _save_bandwidth_to_disk(key, bandwidth)
        # classified at use, so a cached measurement survives new thresholds
        mode = _PLACEMENT_CACHE[key] = classify_bandwidth(bandwidth)
    return mode


def _platform_key(device: torch.device) -> str:
    """The cache key of a link: this host's name and the card's, since
    the same card reached from another host has another link."""
    import socket

    return f"{socket.gethostname() or '?'}:{torch.cuda.get_device_name(device)}"


def cache_dir() -> Optional[str]:
    """The port's per-user cache directory (mode 0700, owned by this
    user): ``$DEEQU_TPU_CACHE_DIR/deequ_tpu_torch`` when that variable is
    set, else ``deequ_tpu_torch_<uid>`` in the temporary directory. None
    when it cannot be made or belongs to someone else."""
    import tempfile

    override = os.environ.get("DEEQU_TPU_CACHE_DIR")
    if override:
        path = os.path.join(override, "deequ_tpu_torch")
    else:
        path = os.path.join(tempfile.gettempdir(), f"deequ_tpu_torch_{os.getuid()}")
    try:
        os.makedirs(path, mode=0o700, exist_ok=True)
        if os.stat(path).st_uid != os.getuid():
            return None
    except OSError:
        return None
    return path


def _placement_cache_path() -> Optional[str]:
    directory = cache_dir()
    return None if directory is None else os.path.join(directory, "placement.json")


def _read_placement_file(path: str) -> dict:
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def _fresh(entry, now: float) -> bool:
    return (
        isinstance(entry, dict)
        and isinstance(entry.get("bandwidth"), (int, float))
        and entry["bandwidth"] > 0
        and isinstance(entry.get("ts"), (int, float))
        and now - float(entry["ts"]) <= PLACEMENT_CACHE_TTL_S
    )


def _load_bandwidth_from_disk(key: str) -> Optional[float]:
    """The cached measurement of the link `key`, or None when absent,
    expired or unreadable (a corrupt file is ignored, never fatal)."""
    path = _placement_cache_path()
    if path is None:
        return None
    entry = _read_placement_file(path).get(key)
    if not _fresh(entry, time.time()):
        return None
    return float(entry["bandwidth"])


def _save_bandwidth_to_disk(key: str, bandwidth: float) -> None:
    """Record the link's measurement (tmp file and rename); expired and
    malformed entries are dropped on the way."""
    path = _placement_cache_path()
    if path is None:
        return
    now = time.time()
    data = {k: v for k, v in _read_placement_file(path).items() if _fresh(v, now)}
    data[key] = {"bandwidth": float(bandwidth), "ts": now}
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(data, f)
        os.replace(tmp, path)
    except OSError:
        with contextlib.suppress(OSError):
            os.unlink(tmp)


def fold_variant(device: Optional[torch.device]) -> str:
    """The fold-arithmetic tag a plan signature hashes: "cuda-folds" when
    the moment folds run as CUDA kernels (their summation order differs
    from the plain fold's), "" on the CPU."""
    return "cuda-folds" if device is not None and device.type == "cuda" else ""


def fold_signature_variant(device: Optional[torch.device]) -> str:
    """The variant a plan signature hashes: `fold_variant` plus the
    "encfold" tag whenever the encoded fold could engage (its switch, the
    C reader and decode it rides on, and the C library all on), as the
    JAX package's `fold_signature_variant` adds it. The encoded fold
    gives the row fold's bits, but its states still never mix with the
    row fold's in a state repository."""
    base = fold_variant(device)
    if encoded_fold_enabled() and native_reader_enabled() and decode_fastpath_enabled():
        from deequ_tpu_torch.ops import native

        if native.available():
            return base + "+encfold" if base else "encfold"
    return base


def narrow_int_wire(arr: np.ndarray, key: str, sticky: dict) -> np.ndarray:
    """Range-downcast an integer array to the narrowest exact wire dtype.
    `sticky` pins each key's dtype monotonically wider across the batches
    of one pass, so the wire layout does not flap with each batch's range."""
    unsigned = np.issubdtype(arr.dtype, np.unsignedinteger)
    candidates = (
        (np.uint8, np.uint16, np.uint32, np.uint64)
        if unsigned
        else (np.int8, np.int16, np.int32, np.int64)
    )
    chosen = np.dtype(sticky.get(key, candidates[0]))
    if arr.size:
        mn, mx = int(arr.min()), int(arr.max())
        for cand in candidates:
            info = np.iinfo(cand)
            if (
                np.dtype(cand).itemsize >= chosen.itemsize
                and info.min <= mn
                and mx <= info.max
            ):
                chosen = np.dtype(cand)
                break
    chosen = np.dtype(min(chosen, arr.dtype, key=lambda d: np.dtype(d).itemsize))
    sticky[key] = chosen
    return arr.astype(chosen, copy=False)


def wire_pad_size(n: int) -> int:
    """A batch's padded row length on the wire: the next multiple of 8, so
    a bit-packed mask (1 bit per row) decodes to exactly the padded rows.
    (The JAX package pads to a power of two to bound recompiles; eager
    PyTorch compiles nothing, so the port pads only to whole bytes.)"""
    return max(-(-n // 8) * 8, 8)


def shard_tag() -> str:
    """This process's shard in a sharded scan (``DEEQU_TPU_SHARD``, set
    by the launcher for each worker), which the pipeline's thread names
    carry so that a stack dump says whose stage thread it is. Empty
    outside sharded runs."""
    return os.environ.get("DEEQU_TPU_SHARD", "")


# -- fault containment knobs (data/source.py, ops/fused.py) ---------------------


def _env_number(name: str, default, cast):
    """The variable `name` read by `cast` and held at 0 or above;
    `default` when it is unset, empty or not a number."""
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return max(cast(0), cast(raw))
    except ValueError:
        return default


def retry_budget() -> int:
    """Retries of one transient-IO operation, the C reader's pread of a
    column chunk (``DEEQU_TPU_RETRIES``, default 3, 0 = none): a failed or
    short read is issued again with exponential backoff up to this many
    times before its unit reads through pyarrow. Neither changes a
    metric; the outcomes count as `engine.retry.*`."""
    return _env_number("DEEQU_TPU_RETRIES", 3, int)


def retry_base_s() -> float:
    """The first retry's backoff in seconds (``DEEQU_TPU_RETRY_BASE_MS``,
    default 10 ms): attempt k sleeps ``base * 2**k`` with a deterministic
    jitter (`core.controller.backoff_s`)."""
    return _env_number("DEEQU_TPU_RETRY_BASE_MS", 10.0, float) / 1000.0


def stall_watchdog_s() -> float:
    """The stall watchdog's window in seconds
    (``DEEQU_TPU_STALL_WATCHDOG_S``, default 0 = off): when positive and
    a RunController is attached, a watchdog thread reads the controller's
    per-batch beat count every window; one silent window dumps the
    stages' state to stderr, a second cancels the run with DQ404."""
    return _env_number("DEEQU_TPU_STALL_WATCHDOG_S", 0.0, float)


# -- stream knob (data/source.py, ops/pipeline.py) ------------------------------


def forensics_enabled() -> bool:
    """Whether verification runs capture failure forensics by default
    (observe/forensics.py): a bounded, deterministic sample of violating
    rows per row-level-capable constraint, and the run's provenance,
    saved as an audit trail. Off unless asked for: capture does work per
    batch, so ``DEEQU_TPU_FORENSICS=1`` (or ``on``/``true``) or
    `with_forensics()` on the run builder turns it on. Off, the fused
    pass carries no capture and each batch pays one falsy check."""
    return os.environ.get("DEEQU_TPU_FORENSICS", "") in ("1", "on", "true")


def heartbeat_s() -> float:
    """The live scan heartbeat's interval in seconds
    (``DEEQU_TPU_HEARTBEAT_S``, default 0 = off): when positive, a scan
    emits progress snapshots (batches done and predicted, rows/s, the
    pipeline's busiest stage, an ETA) through `observe.heartbeat`. Off,
    the scan loop touches a falsy no-op handle and starts no thread."""
    from deequ_tpu_torch.observe import heartbeat

    return heartbeat.env_interval_s()


def pipeline_enabled() -> bool:
    """Whether a streamed scan runs the staged pipeline: decode on a
    prefetch thread, per-batch prep (input builds, wire packing, the H2D
    copy on its own CUDA stream) on a stage thread, every fold on the
    caller in batch order. ``DEEQU_TPU_PIPELINE=0`` (or ``off``) runs it
    all on the caller; both give the same bits."""
    return os.environ.get("DEEQU_TPU_PIPELINE", "") not in ("0", "off")


#: prepped batches that may wait between the prep stage and the fold
#: when `DEEQU_TPU_PIPELINE_DEPTH` is unset or not a number
DEFAULT_PIPELINE_DEPTH = 2


def pipeline_depth() -> int:
    """The staged pipeline's queue depth between prep and fold
    (``DEEQU_TPU_PIPELINE_DEPTH``, default 2, held to 1-64): at most this
    many prepped batches, their buffers already copied to the device,
    wait for the fold. Depth 1 is double buffering; a deeper queue
    smooths decode jitter for one resident batch more each."""
    return max(1, min(_env_number("DEEQU_TPU_PIPELINE_DEPTH", DEFAULT_PIPELINE_DEPTH, int), 64))


def decode_workers() -> int:
    """Host threads that decode a Parquet scan's row groups
    (``DEEQU_TPU_DECODE_WORKERS``, default ``min(cores, 4)``; 1 is the
    serial decode). pyarrow and the C decode release the GIL, so workers
    overlap; their batches merge back in file order, so every count
    gives the same bits. The workers never touch the device."""
    return _env_number("DEEQU_TPU_DECODE_WORKERS", 0, int) or min(os.cpu_count() or 1, 4)


def source_stall_s() -> float:
    """A modelled per-read latency of the source in seconds
    (``DEEQU_TPU_SOURCE_STALL_MS``, default 0, negative or malformed
    values off): each row-group read sleeps this long on the thread that
    reads it, as a remote store's ranged GET would block, so that a
    measurement can see how much source wait the decode workers, the C
    reader's read-ahead and the pipeline hide. It changes no result;
    never set it for a throughput number of a local file."""
    return _env_number("DEEQU_TPU_SOURCE_STALL_MS", 0.0, float) / 1000.0


def state_cache_enabled() -> bool:
    """Whether a partitioned scan may consult an attached state
    repository (repository/states.py): a partition whose fingerprint and
    plan signature already have a stored envelope loads its states
    instead of scanning its rows. ``DEEQU_TPU_STATE_CACHE=0`` (or
    ``off``) scans every partition, as with no repository; partitions
    merge in partition order either way, so both give the same bits."""
    return os.environ.get("DEEQU_TPU_STATE_CACHE", "") not in ("0", "off")


# -- service knobs (service/service.py, service/sharing.py) ---------------------


def scan_sharing_enabled() -> bool:
    """Whether the DQService may run co-tenant submissions over the same
    dataset fingerprint as ONE superset fused scan (service/sharing.py)
    once the subsumption prover (lint/subsume.py) proves every
    participant contained. ``DEEQU_TPU_SCAN_SHARING=0`` (or ``off``) scans
    every submission solo; the fan-out selects states of the same
    semigroup, so both give the same bits."""
    return os.environ.get("DEEQU_TPU_SCAN_SHARING", "") not in ("0", "off")


def share_group_max() -> int:
    """The most participants of one shared scan
    (``DEEQU_TPU_SHARE_GROUP_MAX``, default 8, at least 1): it bounds one
    worker's fan-out and what one preemption re-queues."""
    return max(1, _env_number("DEEQU_TPU_SHARE_GROUP_MAX", 8, int))


def service_workers() -> int:
    """The DQService's worker threads (``DEEQU_TPU_SERVICE_WORKERS``,
    default 2, at least 1): how many suites run at once. On one card each
    worker's fused pass launches on its own thread's current stream."""
    return max(1, _env_number("DEEQU_TPU_SERVICE_WORKERS", 2, int))


def service_drain_s() -> float:
    """The DQService's graceful-drain window in seconds
    (``DEEQU_TPU_SERVICE_DRAIN_S``, default 30): on SIGTERM or close(),
    running suites get this long to commit their in-flight partition and
    end at a boundary (DQ407) before the drain cancels them outright.
    Queued work is returned with DQ414 at once either way."""
    return _env_number("DEEQU_TPU_SERVICE_DRAIN_S", 30.0, float)


def pushdown_enabled() -> bool:
    """Whether a Parquet scan may skip the row groups that the pruning
    interpreter (lint/pushdown.py) proves hold no row for ANY fused
    member's where filter, and swap the filters it proves all-true for
    constant masks. ``DEEQU_TPU_PUSHDOWN=0`` (or ``off``) decodes every
    group and evaluates every filter; folds are where-masked, so both
    give the same bits."""
    return os.environ.get("DEEQU_TPU_PUSHDOWN", "") not in ("0", "off")


# -- decode knobs (data/source.py, data/arrow_decode.py, data/native_reader.py) --


def decode_fastpath_enabled() -> bool:
    """Whether a Parquet scan may decode the planner's columns through
    the C library's Arrow-buffer kernels (data/arrow_decode.py) instead
    of the host chain. ``DEEQU_TPU_DECODE_FASTPATH=0`` (or ``off``) sends
    every column through the host chain, and turns the C reader off with
    it; both routes give the same Columns bit for bit."""
    return os.environ.get("DEEQU_TPU_DECODE_FASTPATH", "") not in ("0", "off")


def native_reader_enabled() -> bool:
    """Whether the planner's column chunks may be read by the C Parquet
    reader (data/native_reader.py): page headers parsed, pages
    decompressed and decoded into the Arrow buffer layout the decode
    kernels read, pyarrow never touching those chunks.
    ``DEEQU_TPU_NATIVE_READER=0`` (or ``off``) reads every chunk through
    pyarrow; both give the same batches bit for bit."""
    return os.environ.get("DEEQU_TPU_NATIVE_READER", "") not in ("0", "off")


def wire_fused_enabled() -> bool:
    """Whether the planner's packed-only columns decode straight to the
    wire (data/arrow_decode.py, data/native_reader.py): mask bits and
    narrow-int or float64 value rows written by the C decode into the
    buffers copied to the device, with no Column in between and no pack.
    ``DEEQU_TPU_WIRE_FUSED=0`` (or ``off``) packs every column from its
    Column; the device sees the same values, so both give the same bits."""
    return os.environ.get("DEEQU_TPU_WIRE_FUSED", "") not in ("0", "off")


def encoded_fold_enabled() -> bool:
    """Whether the planner's dictionary-coded columns fold their family
    state over (run length, dictionary code) streams from the C reader
    (data/encfold.py) instead of expanding to rows first.
    ``DEEQU_TPU_ENCODED_FOLD=0`` (or ``off``) expands every chunk; the run
    fold declines wherever it cannot prove the row fold's bits, so both
    give the same bits. The mode still enters the plan signature
    (`fold_signature_variant`)."""
    return os.environ.get("DEEQU_TPU_ENCODED_FOLD", "") not in ("0", "off")


def multi_family_enabled() -> bool:
    """Whether host-folded sketch families that share a where mask and a
    sample cap run as one multi-column C traversal
    (`masked_moments_select_multi`); ``DEEQU_TPU_NO_MULTI_FAMILY`` (any
    value but ``0``) runs one traversal per column, with the same bits."""
    return os.environ.get("DEEQU_TPU_NO_MULTI_FAMILY", "") in ("", "0")


# -- decode-to-wire records (data/arrow_decode.py, data/native_reader.py) -------


@dataclass(frozen=True)
class ColumnWireSpec:
    """One decode-to-wire column's layout, pinned before the scan: which
    wire rows its packed consumers read and their dtypes, so every batch
    of the pass ships the same layout and the decode writes final wire
    bytes without seeing any data. The port's wire is float64, so no
    column waits for a pre-centring shift (the JAX package's float32
    wire does)."""

    column: str
    token: str  # the Arrow type token a chunk must have at decode
    want_value: bool  # a num:{column} spec is live
    want_valid: bool  # a valid:{column} spec is live
    value_kind: str = ""  # "val" (float64) | "ival" (narrow int)
    value_dtype: str = ""  # numpy dtype name of the value row
    desc: str = ""  # short form for reports ("f64", "i8", ...)


@dataclass
class WireRow:
    """One wire row the decode attaches to a batch (`table.wire_rows`):
    a buffer padded to `wire_pad_size(rows)` (rows for values, bytes of
    MSB-first bits for masks) that `pack_batch_inputs` splices in as it
    is."""

    kind: str  # "bits" | "val" | "ival"
    arr: np.ndarray
    all_valid: bool = False  # a bits row with no invalid row (elides to const)


class WireFusionPlan:
    """The decode-to-wire columns of one pass (column -> ColumnWireSpec),
    attached to the source by the planner and read by its decode."""

    def __init__(self, columns):
        self.columns = dict(columns)
