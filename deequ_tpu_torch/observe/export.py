"""Chrome-trace-format (Perfetto-viewable) JSON export.

Emits the Trace Event Format's duration events: a `B`/`E` pair per
span with microsecond `ts` relative to the tracer epoch, `pid` = the
torch.distributed rank (0 when no process group is initialized), `tid`
= a small stable index
per OS thread. Load the file at https://ui.perfetto.dev or
chrome://tracing.

Events are emitted depth-first (B, children, E), so B/E pairs nest
properly by construction regardless of clock granularity. Multihost
runs write one file per process; `merge_chrome_traces` concatenates
them keyed by each file's recorded process index so one Perfetto view
shows every host.

A torch.profiler trace joins a span trace on one clock: a tracer made
while a profiler records opens a zero-length `deequ.trace_epoch`
record_function at its epoch (observe/spans.py), and `on_span_clock`
shifts the profiler's events so that the marker's end falls at the
span trace's 0. `chrome_trace(..., device_trace=...)` appends them, so
one view shows the host spans beside the CUDA kernels.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Union

from deequ_tpu_torch.observe.spans import EPOCH_MARKER, Span


def process_index() -> int:
    """This process's `torch.distributed` rank when a process group is
    initialized (the sharded scan's workers, parallel/multihost.py),
    else 0."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # noqa: BLE001 - a trace never fails a run
        return 0
    return 0


def process_count() -> int:
    """The `torch.distributed` world size when a process group is
    initialized, else 1."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_world_size())
    except Exception:  # noqa: BLE001 - a trace never fails a run
        return 1
    return 1


def _events_for(
    span: Span,
    epoch: float,
    pid: int,
    tid_map: Dict[int, int],
    out: List[dict],
) -> None:
    tid = tid_map.setdefault(span.tid, len(tid_map))
    ts = max((span.t0 - epoch) * 1e6, 0.0)
    end = max((span.t1 - epoch) * 1e6, ts)
    args = {k: v for k, v in span.attrs.items()}
    args["cpu_ms"] = round(span.cpu_s * 1e3, 3)
    begin = {
        "ph": "B",
        "ts": ts,
        "pid": pid,
        "tid": tid,
        "name": span.name,
        "cat": span.cat or "other",
        "args": args,
    }
    out.append(begin)
    for child in span.children:
        _events_for(child, epoch, pid, tid_map, out)
    out.append(
        {
            "ph": "E",
            "ts": end,
            "pid": pid,
            "tid": tid,
            "name": span.name,
            "cat": span.cat or "other",
        }
    )


def on_span_clock(device_trace: Union[str, dict]) -> List[dict]:
    """The events of a torch.profiler Chrome trace (its document, or the
    path `export_chrome_trace` wrote) with `ts` in microseconds on the
    span clock of the first tracer made while the profiler recorded.
    Raises ValueError when the trace holds no epoch marker."""
    if isinstance(device_trace, str):
        with open(device_trace, encoding="utf-8") as f:
            device_trace = json.load(f)
    events = device_trace.get("traceEvents", [])
    markers = [e for e in events if e.get("name") == EPOCH_MARKER and e.get("ph") == "X"]
    if not markers:
        raise ValueError(
            f"the device trace holds no {EPOCH_MARKER} marker: make the tracer while "
            "the profiler records"
        )
    first = min(markers, key=lambda e: e["ts"])
    # the tracer read its epoch last thing inside the marker
    anchor = float(first["ts"]) + float(first.get("dur", 0.0))
    out = []
    for event in events:
        event = dict(event)
        if "ts" in event:
            event["ts"] = float(event["ts"]) - anchor
        out.append(event)
    return out


def chrome_trace(
    roots: Sequence[Span],
    epoch: float = 0.0,
    pid: Optional[int] = None,
    metadata: Optional[dict] = None,
    device_trace: Union[str, dict, None] = None,
) -> dict:
    """The trace document for a span forest: `{"traceEvents": [...]}`.
    `device_trace`, a torch.profiler Chrome trace of the same run, joins
    it on the span clock (`on_span_clock`), its processes renumbered."""
    if pid is None:
        pid = process_index()
    events: List[dict] = []
    tid_map: Dict[int, int] = {}
    for root in roots:
        _events_for(root, epoch, pid, tid_map, events)
    if device_trace is not None:
        # the profiler's processes move to 1000 * (pid + 1) + n, apart
        # from every span process (a rank, below 1000)
        pid_map: Dict[object, int] = {}
        for event in on_span_clock(device_trace):
            if "pid" in event:
                event["pid"] = pid_map.setdefault(event["pid"], 1000 * (pid + 1) + len(pid_map))
            events.append(event)
    meta = {"process_index": pid}
    if metadata:
        meta.update(metadata)
    events.append(
        {
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "name": "process_name",
            "args": {"name": f"deequ_tpu p{pid}"},
        }
    )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": meta,
    }


def write_chrome_trace(
    path: str,
    roots: Sequence[Span],
    epoch: float = 0.0,
    pid: Optional[int] = None,
    metadata: Optional[dict] = None,
) -> str:
    """Serialize a span forest to `path` (atomic tmp+rename), return
    the path."""
    from deequ_tpu_torch.core.fileio import write_text_output

    doc = chrome_trace(roots, epoch=epoch, pid=pid, metadata=metadata)
    write_text_output(path, json.dumps(doc), overwrite=True)
    return path


def merge_chrome_traces(paths: Sequence[str], out_path: Optional[str] = None) -> dict:
    """Merge per-process trace files (multihost runs write one per
    process) into a single document, keyed by each file's recorded
    process index — falling back to file order when indexes collide so
    no host's events shadow another's."""
    merged_events: List[dict] = []
    seen_pids: set = set()
    sources = []
    for order, path in enumerate(paths):
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        pid = doc.get("metadata", {}).get("process_index", order)
        while pid in seen_pids:
            pid += len(paths)
        seen_pids.add(pid)
        sources.append({"path": path, "process_index": pid})
        for event in doc.get("traceEvents", []):
            event = dict(event)
            event["pid"] = pid
            merged_events.append(event)
    merged = {
        "traceEvents": merged_events,
        "displayTimeUnit": "ms",
        "metadata": {"merged_from": sources},
    }
    if out_path is not None:
        from deequ_tpu_torch.core.fileio import write_text_output

        write_text_output(out_path, json.dumps(merged), overwrite=True)
    return merged
