"""Human-readable run reports and per-phase accounting.

`phase_seconds` buckets SELF time (a span's duration minus what its
own thread's children cover) by span category, so the buckets of one
thread are disjoint and sum to ~its wall time; stage and pool threads
add their busy thread-seconds — the per-operator accounting LaraDB
(arXiv:1703.07342) argues fused kernels need. `wait_seconds` sums the
queue waits (`pipe_wait` leaves) by the stage waited for, and
`build_seconds` the input builds by spec key. `render_report` draws
the span tree with durations, categories and attributes; repeated
siblings (per-batch dispatches, per-family kernels) aggregate into one
`×N` line so streaming runs stay readable.

Both are pure functions of the span forest — the golden test feeds
hand-built spans with fixed times and string-compares the output.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from deequ_tpu_torch.observe.spans import WAIT_SPAN, Span, Tracer

# The headline buckets (always present in phase_seconds, even at 0.0):
# fuse-group planning, kernel dispatch, device<->host transfer, state
# merge. Other categories (native, group, scan, constraint, ...) appear
# when spans carry them.
PHASES = ("plan", "dispatch", "transfer", "merge")

# Stream-pipeline span vocabulary (ops/pipeline.py, data/source.py):
# one PIPE_STAGE_SPAN per stage-thread lifetime, one PIPE_ITEM_SPAN
# child per batch of actual stage work. Wall minus the items' busy time
# is stall — waiting on a queue, i.e. on another stage.
PIPE_STAGE_SPAN = "pipe_stage"
PIPE_ITEM_SPAN = "pipe_item"

Roots = Union[Span, Tracer, Sequence[Span]]

#: input builds the run report lists
TOP_BUILDS = 5


def _roots_of(roots: Roots) -> Sequence[Span]:
    if isinstance(roots, Span):
        return [roots]
    if isinstance(roots, Tracer):
        return roots.roots
    return list(roots)


def _covered_s(span: Span) -> float:
    """The part of `span`'s interval that its children on its own thread
    cover (the union of their intervals, clipped to the span). A child of
    another thread (a stage or pool thread that adopted the span) runs
    beside the span, not inside its time."""
    intervals = sorted(
        (max(c.t0, span.t0), min(c.t1, span.t1)) for c in span.children if c.tid == span.tid
    )
    covered, end = 0.0, span.t0
    for t0, t1 in intervals:
        t0 = max(t0, end)
        if t1 > t0:
            covered += t1 - t0
            end = t1
    return covered


def phase_seconds(roots: Roots) -> Dict[str, float]:
    """Disjoint self-time per span category, in seconds: a span's
    duration less what its own thread's children cover."""
    buckets: Dict[str, float] = {phase: 0.0 for phase in PHASES}

    def visit(span: Span) -> None:
        self_time = max(span.duration_s - _covered_s(span), 0.0)
        cat = span.cat or "other"
        buckets[cat] = buckets.get(cat, 0.0) + self_time
        for child in span.children:
            visit(child)

    for root in _roots_of(roots):
        visit(root)
    return buckets


def _spans_of(roots: Roots):
    for root in _roots_of(roots):
        yield from root.walk()


def wait_seconds(roots: Roots) -> Dict[str, float]:
    """Seconds of the queue waits by the stage waited for (`on`); a put
    that found its queue full counts under "<on> (blocked)"."""
    out: Dict[str, float] = {}
    for span in _spans_of(roots):
        if span.name == WAIT_SPAN:
            key = str(span.attrs.get("on"))
            if span.attrs.get("blocked"):
                key += " (blocked)"
            out[key] = out.get(key, 0.0) + span.duration_s
    return out


def build_seconds(roots: Roots) -> Dict[str, float]:
    """Seconds of the input builds by spec key, from the `build_s:<key>`
    attributes the builds add to the span open around them."""
    out: Dict[str, float] = {}
    for span in _spans_of(roots):
        for attr, value in span.attrs.items():
            if attr.startswith("build_s:"):
                key = attr[len("build_s:"):]
                out[key] = out.get(key, 0.0) + value
    return out


def pipeline_occupancy(roots: Roots) -> List[Dict[str, Any]]:
    """Aggregate stream-pipeline stage utilisation from the span forest.

    For every `pipe_stage` span (one per stage-thread lifetime), its
    `pipe_item` children are the stage's actual per-batch work; the
    rest of the stage's wall is stall — blocked on an inter-stage queue,
    i.e. waiting for another stage. Returns one row per stage name:

        {stage, wall_s, busy_s, stall_s, occupancy, items}

    sorted by busy_s descending, so row 0 is the pipeline's bottleneck
    stage (the one the other stages stall on). The native parquet
    reader's read-ahead window (data/source.py `page_read` spans +
    `readahead_hit` on `page_decode`) folds in as a synthetic "read"
    row: when prefetch misses dominate, the decoder's blocked waits
    hide inside another stage's time, so the read row is promoted to
    the bottleneck slot instead of the stall showing up as idle decode.
    Pure function of the spans; the same rows back `render_report`'s
    pipeline section and the telemetry record's occupancy series.
    Empty when the run never engaged the pipeline (serial fallback,
    in-memory tables)."""
    rows: Dict[str, Dict[str, Any]] = {}
    order: List[str] = []
    readahead = {"spans": 0, "busy_s": 0.0, "hits": 0, "misses": 0}

    def visit(span: Span) -> None:
        if span.name == PIPE_STAGE_SPAN:
            stage = str(span.attrs.get("stage", "?"))
            row = rows.get(stage)
            if row is None:
                row = rows[stage] = {
                    "stage": stage, "wall_s": 0.0, "busy_s": 0.0, "items": 0,
                }
                order.append(stage)
            row["wall_s"] += span.duration_s
            for child in span.children:
                if child.name != PIPE_ITEM_SPAN:
                    continue
                # the eos item is the decode tail (flush + close): real
                # stage time, but not a delivered batch
                row["busy_s"] += child.duration_s
                if not child.attrs.get("eos"):
                    row["items"] += 1
        elif span.name == "page_read":
            readahead["spans"] += 1
            readahead["busy_s"] += span.duration_s
        elif span.name == "page_decode" and "readahead_hit" in span.attrs:
            key = "hits" if span.attrs.get("readahead_hit") else "misses"
            readahead[key] += 1
        for child in span.children:
            visit(child)

    for root in _roots_of(roots):
        visit(root)
    out = []
    for stage in order:
        row = rows[stage]
        row["stall_s"] = max(row["wall_s"] - row["busy_s"], 0.0)
        row["occupancy"] = (
            row["busy_s"] / row["wall_s"] if row["wall_s"] > 0 else 0.0
        )
        out.append(row)
    out.sort(key=lambda r: -r["busy_s"])
    if out and readahead["spans"]:
        # the fetch thread has no pipe_stage span of its own; its wall
        # is the pipeline's wall (the widest stage)
        wall = max(r["wall_s"] for r in out)
        busy = min(readahead["busy_s"], wall)
        row = {
            "stage": "read",
            "wall_s": wall,
            "busy_s": busy,
            "items": readahead["spans"],
            "stall_s": max(wall - busy, 0.0),
            "occupancy": busy / wall if wall > 0 else 0.0,
            "readahead_hits": readahead["hits"],
            "readahead_misses": readahead["misses"],
        }
        if readahead["misses"] > readahead["hits"]:
            # starved window: consumers block on fetch futures, so the
            # read stage is the true bottleneck
            out.insert(0, row)
        else:
            out.append(row)
    return out


def _fmt_attr(value: Any) -> str:
    if isinstance(value, float):
        return f"{value:.4g}"
    return str(value)


def _attr_text(attrs: Dict[str, Any]) -> str:
    parts = [
        f"{key}={_fmt_attr(value)}"
        for key, value in sorted(attrs.items())
        if isinstance(value, (int, float, str, bool)) and key != "cpu_ms"
    ]
    return " ".join(parts)


def _aggregate(children: Sequence[Span]) -> List[Tuple[Span, int, float]]:
    """Collapse same-(name, cat) siblings: (exemplar, count, total_s)."""
    order: List[Tuple[str, Optional[str]]] = []
    groups: Dict[Tuple[str, Optional[str]], List[Span]] = {}
    for child in children:
        key = (child.name, child.cat)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(child)
    out = []
    for key in order:
        members = groups[key]
        out.append((members[0], len(members), sum(m.duration_s for m in members)))
    return out


def _render_span(
    span: Span,
    count: int,
    total_s: float,
    prefix: str,
    is_last: bool,
    lines: List[str],
    depth: int,
    max_depth: int,
) -> None:
    connector = "└─ " if is_last else "├─ "
    label = span.name if count == 1 else f"{span.name} ×{count}"
    head = f"{prefix}{connector}{label}"
    tail = f"{total_s * 1e3:9.1f} ms"
    if span.cat:
        tail += f"  [{span.cat}]"
    attrs = _attr_text(span.attrs) if count == 1 else ""
    if attrs:
        tail += f"  {attrs}"
    lines.append(f"{head:<44}{tail}")
    if depth + 1 >= max_depth:
        return
    child_prefix = prefix + ("   " if is_last else "│  ")
    grouped = _aggregate(span.children)
    for i, (child, n, secs) in enumerate(grouped):
        _render_span(
            child,
            n,
            secs,
            child_prefix,
            i == len(grouped) - 1,
            lines,
            depth + 1,
            max_depth,
        )


def render_report(
    roots: Roots,
    counters: Optional[Dict[str, int]] = None,
    max_depth: int = 8,
    forensics: Optional[Any] = None,
) -> str:
    """The run report: headline counters, the (aggregated) span tree,
    and the per-phase self-time line. Pass a ForensicsReport (e.g.
    `result.forensics()`) as `forensics` to append the failure-forensics
    section — sampled violating rows and scan provenance per failed
    constraint."""
    root_list = _roots_of(roots)
    if not root_list:
        return "deequ_tpu run report — (no spans recorded)"
    head = root_list[0]
    wall_s = sum(r.duration_s for r in root_list)
    cpu_s = sum(r.cpu_s for r in root_list)
    title = head.name if len(root_list) == 1 else f"{len(root_list)} runs"
    lines = [f"deequ_tpu run report — {title}"]
    headline = [f"wall {wall_s * 1e3:.1f} ms", f"cpu {cpu_s * 1e3:.1f} ms"]
    for key in ("device_passes", "device_launches", "group_passes"):
        value = (counters or {}).get(key, head.attrs.get(key))
        if value is not None:
            headline.append(f"{key} {value}")
    strings_total = (counters or {}).get("device_strings_total")
    if strings_total:
        # STRING columns' DataType/HLL inputs a batch: computed on the device
        headline.append(f"device_strings {counters.get('device_strings', 0)}/{strings_total}")
    lines.append(" | ".join(headline))
    for root in root_list:
        grouped = _aggregate(root.children)
        root_tail = f"{root.duration_s * 1e3:9.1f} ms"
        attrs = _attr_text(root.attrs)
        if attrs:
            root_tail += f"  {attrs}"
        lines.append(f"{root.name:<44}{root_tail}")
        for i, (child, n, secs) in enumerate(grouped):
            _render_span(
                child, n, secs, "", i == len(grouped) - 1, lines, 1, max_depth
            )
    occupancy = pipeline_occupancy(root_list)
    waits = wait_seconds(root_list)
    if occupancy or waits:
        lines.append("pipeline occupancy (busy/wall per stage):")
        for i, row in enumerate(occupancy):
            marker = "  <- bottleneck" if i == 0 else ""
            ra = ""
            if "readahead_hits" in row:
                ra = (
                    f"  readahead {row['readahead_hits']}h"
                    f"/{row['readahead_misses']}m"
                )
            lines.append(
                f"  {row['stage']:<8} {row['occupancy'] * 100:5.1f}%"
                f"  busy {row['busy_s']:.3f}s"
                f"  stall {row['stall_s']:.3f}s"
                f"  items {row['items']}{ra}{marker}"
            )
        if waits:
            # the stalls' measured split, by the stage waited for
            lines.append("  waits on: " + " | ".join(
                f"{key} {waits[key]:.3f}s" for key in sorted(waits, key=lambda k: (-waits[k], k))
            ))
    builds = build_seconds(root_list)
    if builds:
        lines.append(f"input builds (top {TOP_BUILDS} of {len(builds)}):")
        for key in sorted(builds, key=lambda k: (-builds[k], k))[:TOP_BUILDS]:
            lines.append(f"  {builds[key]:.3f}s  {key}")
    phases = phase_seconds(root_list)
    phase_text = " | ".join(
        f"{name} {phases[name]:.3f}s"
        for name in sorted(phases, key=lambda k: (-phases[k], k))
        if phases[name] > 0 or name in PHASES
    )
    lines.append(f"phases (self-time): {phase_text}")
    if forensics is not None:
        # duck-typed (ForensicsReport.render via __str__) so this module
        # never imports observe/forensics — row VALUES belong to reports
        # the operator asks for, never to telemetry records
        lines.append(str(forensics))
    return "\n".join(lines)
