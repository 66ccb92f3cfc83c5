"""Execution runtime: the device a run uses, its compute dtype, where
reductions are placed, and the fold-arithmetic tag.

Entry points run on CUDA unless the caller passes ``device="cpu"``. With
no device given and no CUDA device present a run raises: it never moves
to the CPU on its own.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Union

import numpy as np
import torch

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


def placement_mode() -> str:
    """Where reductions run. Only ``"device"`` (every analyzer in the
    fused device pass) is ported; ``DEEQU_TPU_PLACEMENT`` naming a
    host-fold placement raises until the host fold is ported."""
    env = os.environ.get("DEEQU_TPU_PLACEMENT", "auto")
    if env in ("auto", "device"):
        return "device"
    if env in ("host", "host-all", "host-discrete"):
        raise NotImplementedError(
            f"DEEQU_TPU_PLACEMENT={env}: the host-fold placements are not ported yet"
        )
    raise ValueError(
        f"DEEQU_TPU_PLACEMENT={env!r}: expected auto, device, host, "
        "host-all or host-discrete"
    )


def fold_variant(device: Optional[torch.device]) -> str:
    """The fold-arithmetic tag a plan signature hashes: "cuda-folds" when
    the moment folds run as CUDA kernels (their summation order differs
    from the plain fold's), "" on the CPU."""
    return "cuda-folds" if device is not None and device.type == "cuda" else ""


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


# -- pass accounting -----------------------------------------------------------


@dataclass
class ExecutionStats:
    """Counts of engine work during a `monitored()` block."""

    device_passes: int = 0  # one per fused scan over a table
    device_launches: int = 0  # one per device program run (per batch)
    group_passes: int = 0  # one per group-by frequency computation
    # partitioned scans: partitions whose states loaded from a state
    # repository, partitions that scanned, and all of them
    partitions_cached: int = 0
    partitions_scanned: int = 0
    partitions_total: int = 0

    @property
    def jobs(self) -> int:
        return self.device_passes + self.group_passes


_local = threading.local()


def _sinks() -> List[ExecutionStats]:
    return getattr(_local, "sinks", [])


@contextlib.contextmanager
def monitored() -> Iterator[ExecutionStats]:
    """Count the passes of everything run on this thread inside the block."""
    stats = ExecutionStats()
    try:
        stack = _local.sinks
    except AttributeError:
        stack = _local.sinks = []
    stack.append(stats)
    try:
        yield stats
    finally:
        stack.pop()


def record_pass() -> None:
    """One fused scan over a table, or one shared frequency aggregation."""
    for sink in _sinks():
        sink.device_passes += 1


def record_launch() -> None:
    """One run of a batch's device program, or of a frequency aggregation."""
    for sink in _sinks():
        sink.device_launches += 1


def record_group_pass() -> None:
    """One group-by counting pass over a table."""
    for sink in _sinks():
        sink.group_passes += 1


def record_state_cache(cached: int, scanned: int, total: int) -> None:
    """The split of one partitioned scan: loaded, scanned, all partitions."""
    for sink in _sinks():
        sink.partitions_cached += int(cached)
        sink.partitions_scanned += int(scanned)
        sink.partitions_total += int(total)


# -- stream knob (data/source.py, ops/pipeline.py) ------------------------------


def pipeline_enabled() -> bool:
    """Whether a streamed scan runs the staged pipeline: decode on a
    prefetch thread, per-batch prep (input builds, wire packing, the H2D
    copy on its own CUDA stream) on a stage thread, every fold on the
    caller in batch order. ``DEEQU_TPU_PIPELINE=0`` (or ``off``) runs it
    all on the caller; both give the same bits."""
    return os.environ.get("DEEQU_TPU_PIPELINE", "") not in ("0", "off")


def state_cache_enabled() -> bool:
    """Whether a partitioned scan may consult an attached state
    repository (repository/states.py): a partition whose fingerprint and
    plan signature already have a stored envelope loads its states
    instead of scanning its rows. ``DEEQU_TPU_STATE_CACHE=0`` (or
    ``off``) scans every partition, as with no repository; partitions
    merge in partition order either way, so both give the same bits."""
    return os.environ.get("DEEQU_TPU_STATE_CACHE", "") not in ("0", "off")


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
