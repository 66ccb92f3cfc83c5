"""The staged stream pipeline: a bounded prep stage between decode and fold.

A streamed scan moves every batch through decode (Parquet -> Arrow ->
Table, on the source's prefetch thread), prep (input builds, wire
packing, the host-to-device copy on its own CUDA stream) and the fold
(the fused program's launch on the consumer's stream, the device-to-host
copy, `merge_agg` and the host members' folds). `staged` runs the prep
on a stage thread of its own, with a bounded queue to the consumer:

    decode thread --q--> prep thread --q--> consumer (launch + fold)

so batch N+1's packing and copy overlap batch N's kernels and fold.

Every fold still runs on the consumer, in batch order, over the same
inputs, and the sticky wire dict is written by the one prep thread in
batch order: the pipeline changes where per-batch work runs, never what
is computed. `DEEQU_TPU_PIPELINE=0` runs everything on the caller, and
gives the same bits.

The stage thread adopts the consumer's `monitored()` blocks and its
trace context (tracer and innermost span) in one hook, and reports a
`pipe_stage` span with one `pipe_item` child per batch: what the run
report's pipeline occupancy reads. The waits at both ends of the queue
are `pipe_wait` leaves (`observe.waiting`), so a stage's items and waits
cover its wall. With tracing off the spans are the no-op singleton.

The JAX counterpart is deequ_tpu/ops/pipeline.py.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, List, Optional

from deequ_tpu_torch import observe
from deequ_tpu_torch.observe import counters
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.testing import faults

_SENTINEL = object()

#: how long shutdown waits for a stage thread (as data/source.py waits
#: for its decode thread)
JOIN_TIMEOUT_S = 10.0


def put_blocking(q: "queue.Queue[Any]", item: Any, stop: threading.Event, on: str) -> bool:
    """Put `item` on `q`, polling until it fits or `stop` is set; -> whether
    it went in. A put that finds the queue full is a `pipe_wait` leaf on
    `on` (the consumer's stage) with `blocked=True`."""
    if stop.is_set():
        return False
    try:
        q.put_nowait(item)
        return True
    except queue.Full:
        pass
    with observe.waiting(on, blocked=True):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
    return False


def staged(
    iterable: Iterable[Any],
    fn: Callable[[Any], Any],
    *,
    name: str = "prep",
    depth: Optional[int] = None,
    progress: Any = None,
) -> Iterator[Any]:
    """Run `fn` over `iterable`'s items on a stage thread, yielding the
    results in input order through a queue of `depth` items
    (`runtime.pipeline_depth()`, ``DEEQU_TPU_PIPELINE_DEPTH``, when
    None): at most `depth` + 1 prepped batches are resident however far
    the consumer falls behind.

    Shutdown: when the consumer closes or abandons the generator, the
    stage thread is signalled, the queue is drained so a blocked put
    wakes, and the thread is joined within `JOIN_TIMEOUT_S`. The stage
    thread closes the upstream iterator on its own thread before it
    exits, so a generator upstream (a source's `batches`) runs its own
    cleanup there. An exception from `fn` or from upstream ends the stage
    and is raised again in the consumer, after the same cleanup; a batch
    whose `fn` fails is first redone once in place (`fn` is a pure
    per-batch prep, so the redo gives the same bits), and only a second
    failure ends the stage.

    With tracing on, the consumer's every wait for an item is a
    `pipe_wait` leaf span on `name`, and a put that finds the queue full
    one on "fold" (the consumer) with `blocked=True`.

    `progress` is a live heartbeat handle (`observe.heartbeat`): the
    stage times its wait for upstream items as the `decode` stage and
    `fn`'s work as its own; the no-op handle by default."""
    if depth is None:
        depth = runtime.pipeline_depth()
    if progress is None:
        progress = observe.heartbeat.NOOP_PROGRESS
    q: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    error: List[BaseException] = []

    sinks = counters.current_sinks()
    tracer = observe.current_tracer()
    parent = observe.current_span()

    def _apply(item: Any) -> Any:
        faults.fault_point("pipeline.stage")
        return fn(item)

    def worker() -> None:
        with counters.attached_sinks(sinks), observe.attached(tracer, parent):
            _work()

    def _work() -> None:
        it = iter(iterable)
        try:
            with observe.span("pipe_stage", cat="pipeline", stage=name) as stage_sp:
                items = 0
                while not stop.is_set():
                    # the wait for upstream is another stage's time: it
                    # stays outside the item span
                    try:
                        with progress.timed("decode"):
                            item = next(it)
                    except StopIteration:
                        break
                    sp = observe.span("pipe_item", cat="pipeline", stage=name)
                    with sp, progress.timed(name):
                        rows = getattr(item, "num_rows", None)
                        if sp and rows is not None:
                            sp.set(rows=int(rows))
                        faults.fault_point("pipeline.stall")
                        try:
                            out = _apply(item)
                        except Exception:  # noqa: BLE001 - one redo
                            # a contained stage fault: one redo in place;
                            # a second failure is a real error and ends
                            # the stage
                            counters.record_fault(injected=1)
                            out = _apply(item)
                            counters.record_retry(1, 1, 0)
                    if not put_blocking(q, out, stop, "fold"):
                        return
                    items += 1
                if stage_sp:
                    stage_sp.set(items=items)
        except BaseException as e:  # noqa: BLE001 - raised again in the consumer
            error.append(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                try:
                    close()
                except BaseException as e:  # noqa: BLE001
                    if not error:
                        error.append(e)
            put_blocking(q, _SENTINEL, stop, "fold")

    tag = runtime.shard_tag()
    thread = threading.Thread(
        target=worker, daemon=True, name=f"deequ-pipe-{name}" + (f"-shard{tag}" if tag else "")
    )
    thread.start()
    try:
        while True:
            with observe.waiting(name):
                out = q.get()
            if out is _SENTINEL:
                break
            yield out
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=JOIN_TIMEOUT_S)
    if error:
        raise error[0]
