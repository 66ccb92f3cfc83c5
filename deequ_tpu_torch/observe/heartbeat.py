"""Live scan heartbeat: periodic progress snapshots for streaming scans.

The 1B-row cold pass runs for ~13 minutes and, before this module,
emitted nothing until it finished.  A heartbeat attaches to a scan and
periodically reports completed/predicted batches, instantaneous and
average rows/s, the current pipeline-stage bottleneck, and an ETA — to
registered callbacks and/or as JSONL lines — without perturbing the
scan itself.

Off by default.  Enable with `DEEQU_TPU_HEARTBEAT_S=<seconds>` (or an
explicit `interval=`); `DEEQU_TPU_HEARTBEAT_OUT=<path>` appends each
snapshot as a JSON line (the fallback sink is stderr — never stdout,
which belongs to results; the repo linter bans `print(` in observe/).

Design constraints mirror tracing:
  * near-zero-cost disabled path — `start()` returns a falsy singleton
    whose `advance()`/`timed()` are no-op attribute probes, and no
    timer thread is ever spawned;
  * all clock reads live here in `observe/` (the TIMING lint keeps
    `ops/` free of ad-hoc timing), so scan loops just wrap stages in
    `progress.timed(stage)`;
  * single-writer counters: only the scan (fold) thread calls
    `advance()`, so plain int updates suffice; the stage-busy map is
    written from multiple stage threads and guarded by one lock.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

__all__ = [
    "ENV_KNOB",
    "ENV_OUT",
    "NOOP_PROGRESS",
    "ScanProgress",
    "current",
    "env_interval_s",
    "publish_event",
    "register_callback",
    "scan_heartbeat",
    "start",
    "unregister_callback",
]

ENV_KNOB = "DEEQU_TPU_HEARTBEAT_S"
ENV_OUT = "DEEQU_TPU_HEARTBEAT_OUT"

THREAD_NAME = "deequ-heartbeat"

_perf_counter = time.perf_counter

_callback_lock = threading.Lock()
_callbacks: List[Callable[[Dict[str, Any]], None]] = []


def register_callback(fn: Callable[[Dict[str, Any]], None]) -> None:
    """Register a process-wide heartbeat consumer (fn(snapshot_dict))."""
    with _callback_lock:
        if fn not in _callbacks:
            _callbacks.append(fn)


def unregister_callback(fn: Callable[[Dict[str, Any]], None]) -> None:
    with _callback_lock:
        if fn in _callbacks:
            _callbacks.remove(fn)


def publish_event(event: str, **fields: Any) -> None:
    """One-shot discrete pulse (vs the periodic scan snapshots): the DQ
    service publishes its lifecycle moments — preemptions, sheds,
    breaker trips, drain — through the same sinks a heartbeat uses, so
    one JSONL tail (DEEQU_TPU_HEARTBEAT_OUT) or one registered callback
    sees the whole fleet timeline interleaved with scan progress.

    Best-effort by design: a broken sink must never fail the service
    hot path, so every sink error is swallowed."""
    snap: Dict[str, Any] = {"ts": round(time.time(), 3), "event": event}
    snap.update(fields)
    with _callback_lock:
        registered = list(_callbacks)
    for fn in registered:
        try:
            fn(snap)
        except Exception:  # fault-ok: a sink must not fail the service
            pass
    out_path = os.environ.get(ENV_OUT, "").strip()
    if out_path:
        try:
            with open(out_path, "a", encoding="utf-8") as fh:
                fh.write(json.dumps(snap, sort_keys=True) + "\n")
        except OSError:  # fault-ok: sink errors never propagate
            pass


def env_interval_s() -> float:
    """Heartbeat interval from DEEQU_TPU_HEARTBEAT_S; 0.0 means off."""
    raw = os.environ.get(ENV_KNOB, "").strip()
    if not raw or raw.lower() in ("0", "off", "no", "false"):
        return 0.0
    try:
        return max(0.0, float(raw))
    except ValueError:
        return 0.0


# ---------------------------------------------------------------------------
# disabled fast path
# ---------------------------------------------------------------------------


class _NoopTimer:
    __slots__ = ()

    def __enter__(self) -> "_NoopTimer":
        return self

    def __exit__(self, *exc: object) -> bool:
        return False


_NOOP_TIMER = _NoopTimer()


class _NoopProgress:
    """Falsy inert progress handle returned when the heartbeat is off."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def advance(self, rows: int, batches: int = 1) -> None:
        pass

    def timed(self, stage: str) -> _NoopTimer:
        return _NOOP_TIMER

    def note_readahead(self, hit: bool) -> None:
        pass

    def snapshot(self, final: bool = False) -> Optional[Dict[str, Any]]:
        return None

    def finish(self) -> None:
        pass


NOOP_PROGRESS = _NoopProgress()


# ---------------------------------------------------------------------------
# active-progress registry
# ---------------------------------------------------------------------------
#
# Worker threads the scan spawns (decode pool, the native reader's
# read-ahead fetch thread) have no handle on the scan's progress object;
# the registry lets them self-time under their stage without any
# plumbing: `heartbeat.current().timed("read")`. Process-wide, not
# thread-local, because those threads are precisely NOT the scan thread.

_active_lock = threading.Lock()
_active: List["ScanProgress"] = []


def current() -> Any:
    """The innermost live ScanProgress, or NOOP_PROGRESS when no
    heartbeat is running (the usual case — everything stays no-op)."""
    with _active_lock:
        return _active[-1] if _active else NOOP_PROGRESS


def _register(progress: "ScanProgress") -> None:
    with _active_lock:
        _active.append(progress)


def _unregister(progress: "ScanProgress") -> None:
    with _active_lock:
        if progress in _active:
            _active.remove(progress)


# ---------------------------------------------------------------------------
# live progress
# ---------------------------------------------------------------------------


class _StageTimer:
    __slots__ = ("_progress", "_stage", "_t0")

    def __init__(self, progress: "ScanProgress", stage: str) -> None:
        self._progress = progress
        self._stage = stage

    def __enter__(self) -> "_StageTimer":
        self._t0 = _perf_counter()
        return self

    def __exit__(self, *exc: object) -> bool:
        dt = _perf_counter() - self._t0
        progress = self._progress
        with progress._stage_lock:
            busy = progress._stage_busy
            busy[self._stage] = busy.get(self._stage, 0.0) + dt
        return False


class ScanProgress:
    """Mutable progress state for one scan plus its emission timer."""

    def __init__(
        self,
        interval: float,
        *,
        total_rows: Optional[int] = None,
        predicted_batches: Optional[int] = None,
        callback: Optional[Callable[[Dict[str, Any]], None]] = None,
        out_path: Optional[str] = None,
        name: str = "scan",
    ) -> None:
        self.interval = float(interval)
        self.total_rows = total_rows
        self.predicted_batches = predicted_batches
        self.name = name
        self.rows = 0
        self.batches = 0
        self.snapshots_emitted = 0
        self._callback = callback
        self._out_path = out_path
        self._t0 = _perf_counter()
        self._epoch_unix = time.time()
        self._last_rows = 0
        self._last_t = self._t0
        self._stage_lock = threading.Lock()
        self._stage_busy: Dict[str, float] = {}
        self._readahead_hits = 0
        self._readahead_misses = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def __bool__(self) -> bool:
        return True

    # -- scan-side hooks (hot path) -----------------------------------------

    def advance(self, rows: int, batches: int = 1) -> None:
        self.rows += int(rows)
        self.batches += batches

    def timed(self, stage: str) -> _StageTimer:
        return _StageTimer(self, stage)

    def note_readahead(self, hit: bool) -> None:
        """Read-ahead window accounting from the native parquet reader's
        decode side: `hit` means the prefetch future was already done
        when the decoder asked for it. A miss is a decode stall waiting
        on the window — time the stage timers misattribute to the
        *consumer's* stage, so it must be counted, not timed."""
        with self._stage_lock:
            if hit:
                self._readahead_hits += 1
            else:
                self._readahead_misses += 1

    # -- snapshots -----------------------------------------------------------

    def snapshot(self, final: bool = False) -> Dict[str, Any]:
        now = _perf_counter()
        wall = max(now - self._t0, 1e-9)
        rows, batches = self.rows, self.batches
        dt = max(now - self._last_t, 1e-9)
        inst = (rows - self._last_rows) / dt
        self._last_rows, self._last_t = rows, now
        avg = rows / wall
        with self._stage_lock:
            stages = dict(self._stage_busy)
            ra_hits, ra_misses = self._readahead_hits, self._readahead_misses

        eta: Optional[float] = None
        progress_frac: Optional[float] = None
        if self.total_rows and avg > 0.0:
            eta = max(self.total_rows - rows, 0) / avg
            progress_frac = min(rows / self.total_rows, 1.0)
        elif self.predicted_batches and batches > 0:
            eta = max(self.predicted_batches - batches, 0) * (wall / batches)
            progress_frac = min(batches / self.predicted_batches, 1.0)

        snap: Dict[str, Any] = {
            "ts": round(self._epoch_unix + (now - self._t0), 3),
            "name": self.name,
            "wall_s": round(wall, 3),
            "rows": rows,
            "batches": batches,
            "rows_per_s": round(inst, 1),
            "avg_rows_per_s": round(avg, 1),
            "done": bool(final),
        }
        if self.predicted_batches is not None:
            snap["predicted_batches"] = self.predicted_batches
        if self.total_rows is not None:
            snap["total_rows"] = self.total_rows
        if progress_frac is not None:
            snap["progress"] = round(progress_frac, 4)
        if eta is not None:
            snap["eta_s"] = round(eta, 3)
        if stages:
            snap["bottleneck"] = max(stages, key=lambda s: stages[s])
            snap["occupancy"] = {s: round(b / wall, 4) for s, b in sorted(stages.items())}
        if ra_hits or ra_misses:
            snap["readahead"] = {"hits": ra_hits, "misses": ra_misses}
            if ra_misses > ra_hits:
                # a starved read-ahead window stalls the decoder inside
                # its own stage timer; name the true bottleneck
                snap["bottleneck"] = "read"
        return snap

    def _emit(self, snap: Dict[str, Any]) -> None:
        self.snapshots_emitted += 1
        sinks = 0
        if self._callback is not None:
            sinks += 1
            try:
                self._callback(snap)
            except Exception:
                pass
        with _callback_lock:
            registered = list(_callbacks)
        for fn in registered:
            sinks += 1
            try:
                fn(snap)
            except Exception:
                pass
        line = json.dumps(snap, sort_keys=True) + "\n"
        if self._out_path:
            try:
                with open(self._out_path, "a", encoding="utf-8") as fh:
                    fh.write(line)
            except OSError:
                pass
        elif sinks == 0:
            # last-resort sink so an env-enabled heartbeat is never silent;
            # stderr, because stdout carries results (a caller's JSON output)
            sys.stderr.write(line)

    # -- timer lifecycle ------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self._emit(self.snapshot())

    def start_timer(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True, name=THREAD_NAME)
        self._thread.start()

    def finish(self) -> None:
        """Stop the timer and emit one final (done=True) snapshot."""
        _unregister(self)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._emit(self.snapshot(final=True))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def start(
    interval: Optional[float] = None,
    *,
    total_rows: Optional[int] = None,
    predicted_batches: Optional[int] = None,
    callback: Optional[Callable[[Dict[str, Any]], None]] = None,
    out_path: Optional[str] = None,
    name: str = "scan",
) -> Any:
    """Begin a heartbeat; returns NOOP_PROGRESS (falsy) when disabled.

    Imperative twin of `scan_heartbeat` for call sites that pair it with
    an existing try/finally; callers must invoke `.finish()`.
    """
    iv = env_interval_s() if interval is None else float(interval)
    if iv <= 0.0:
        return NOOP_PROGRESS
    if out_path is None:
        out_path = os.environ.get(ENV_OUT, "").strip() or None
    progress = ScanProgress(
        iv,
        total_rows=total_rows,
        predicted_batches=predicted_batches,
        callback=callback,
        out_path=out_path,
        name=name,
    )
    progress.start_timer()
    _register(progress)
    return progress


@contextlib.contextmanager
def scan_heartbeat(
    interval: Optional[float] = None,
    *,
    total_rows: Optional[int] = None,
    predicted_batches: Optional[int] = None,
    callback: Optional[Callable[[Dict[str, Any]], None]] = None,
    out_path: Optional[str] = None,
    name: str = "scan",
) -> Iterator[Any]:
    """Context-managed heartbeat around a scan (yields the progress handle)."""
    progress = start(
        interval,
        total_rows=total_rows,
        predicted_batches=predicted_batches,
        callback=callback,
        out_path=out_path,
        name=name,
    )
    try:
        yield progress
    finally:
        progress.finish()
