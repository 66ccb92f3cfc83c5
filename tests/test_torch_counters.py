"""Every engine count, pinned: one case per counted event (with values,
and again with zeros where it takes values), recorded on the caller's
thread and from a worker thread that adopted the caller's context.

Each case asserts the exact `ExecutionStats` fields of two nested
`monitored()` blocks, the exact tracer `counters` dict (its keys, its
values, and which keys stay absent while zero), and the same counts on
the enclosing span's attributes. Integer arguments are numpy scalars, so
each case also pins that what is recorded is a plain int.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest

from deequ_tpu_torch import observe
from deequ_tpu_torch.data.source import _WorkerContext
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.observe import counters as recorder

# (event, args, kwargs, ExecutionStats fields that change, tracer counters)
CASES = [
    ("pass", ("scan:x",), {}, {"device_passes": 1, "pass_labels": ["scan:x"]}, {"device_passes": 1}),
    ("launch", (), {}, {"device_launches": 1}, {"device_launches": 1}),
    ("group_pass", ("g",), {}, {"group_passes": 1, "pass_labels": ["group:g"]}, {"group_passes": 1}),
    (
        "state_cache",
        (2, 3, 5),
        {},
        {"partitions_cached": 2, "partitions_scanned": 3, "partitions_total": 5},
        {"partitions_cached": 2, "partitions_scanned": 3, "partitions_total": 5},
    ),
    (
        "state_cache",
        (0, 0, 0),
        {},
        {},
        {"partitions_cached": 0, "partitions_scanned": 0, "partitions_total": 0},
    ),
    (
        "placement",
        ("host-discrete", 3, 4),
        {},
        {"placements": ["host-discrete"], "device_members": 3, "host_members": 4},
        {},
    ),
    ("placement", ("device", 0, 0), {}, {"placements": ["device"]}, {}),
    ("family", (), {"kernels": 2, "shortcuts": 3}, {"family_kernels": 2, "family_shortcuts": 3}, {}),
    ("family", (), {}, {}, {}),
    (
        "wire_fused",
        (["a", "b"], 5, [("c", "string", "k")]),
        {},
        {
            "wire_fused_cols": 2,
            "wire_cols_total": 5,
            "wire_fused": ["a", "b"],
            "wire_falloffs": [("c", "string", "k")],
        },
        {"wire_fused_cols": 2, "wire_cols_total": 5},
    ),
    ("wire_fused", ([], 0), {}, {}, {"wire_fused_cols": 0, "wire_cols_total": 0}),
    (
        "device_strings",
        (2, 3),
        {},
        {"device_strings": 2, "device_strings_total": 3},
        {"device_strings": 2, "device_strings_total": 3},
    ),
    ("device_strings", (0, 0), {}, {}, {"device_strings": 0, "device_strings_total": 0}),
    (
        "dictionary_predicates",
        (1, 2),
        {},
        {"dictionary_predicates": 1, "dictionary_predicates_total": 2},
        {"dictionary_predicates": 1, "dictionary_predicates_total": 2},
    ),
    (
        "dictionary_predicates",
        (0, 0),
        {},
        {},
        {"dictionary_predicates": 0, "dictionary_predicates_total": 0},
    ),
    (
        "device_quantile_samples",
        (3, 4),
        {},
        {"device_quantile_samples": 3, "device_quantile_samples_total": 4},
        {"device_quantile_samples": 3, "device_quantile_samples_total": 4},
    ),
    (
        "device_quantile_samples",
        (0, 0),
        {},
        {},
        {"device_quantile_samples": 0, "device_quantile_samples_total": 0},
    ),
    (
        "encfold_plan",
        (["a"], 4, [("b", "reason")]),
        {},
        {
            "encfold_cols": 1,
            "encfold_cols_total": 4,
            "encfold_planned": ["a"],
            "encfold_falloffs": [("b", "reason")],
        },
        {"encfold_cols": 1, "encfold_cols_total": 4},
    ),
    ("encfold_plan", ([], 0), {}, {}, {"encfold_cols": 0, "encfold_cols_total": 0}),
    (
        "encfold",
        (1, 2, 3, 4, 5, 6),
        {},
        {
            "encfold_chunks": 1,
            "encfold_chunks_fallback": 2,
            "encfold_runs": 3,
            "encfold_values": 4,
            "encfold_codes_folded": 5,
            "encfold_bytes_saved": 6,
        },
        {
            "encfold_chunks": 1,
            "encfold_chunks_fallback": 2,
            "encfold_runs": 3,
            "encfold_values": 4,
            "encfold_codes_folded": 5,
            "encfold_bytes_saved": 6,
        },
    ),
    ("encfold", (0, 0, 0, 0, 0, 0), {}, {}, {"encfold_chunks": 0}),
    ("mesh_pass", (4,), {}, {"mesh_passes": 1, "mesh_shards": 4}, {}),
    ("mesh_pass", (0,), {}, {"mesh_passes": 1}, {}),
    (
        "shard_scan",
        (1, 4, 3, 5, 17, 100, 1000),
        {},
        {"shard_partitions_local": 3, "shard_merge_bytes": 100, "shard_rows_local": 1000},
        {
            "shard.index": 1,
            "shard.count": 4,
            "shard.partitions_local": 3,
            "shard.partitions_max": 5,
            "shard.partitions_total": 17,
            "shard.merge_bytes": 100,
            "shard.rows_local": 1000,
        },
    ),
    (
        "shard_scan",
        (0, 0, 0, 0, 0, 0, 0),
        {},
        {},
        {
            "shard.index": 0,
            "shard.count": 0,
            "shard.partitions_local": 0,
            "shard.partitions_max": 0,
            "shard.partitions_total": 0,
            "shard.merge_bytes": 0,
            "shard.rows_local": 0,
        },
    ),
    (
        "pruned_groups",
        (2, 5, 200, 1),
        {},
        {"rg_skipped": 2, "rg_total": 5, "rg_rows_skipped": 200, "wheres_elided": 1},
        {"rg_skipped": 2, "rg_total": 5},
    ),
    ("pruned_groups", (0, 0, 0, 0), {}, {}, {"rg_skipped": 0, "rg_total": 0}),
    (
        "decode_fastpath",
        (3, 5, 4),
        {},
        {},
        {"decode_cols_fast": 3, "decode_cols_total": 5, "decode_workers": 4, "decode_passes": 1},
    ),
    (
        "decode_fastpath",
        (0, 0, 0),
        {},
        {},
        {"decode_cols_fast": 0, "decode_cols_total": 0, "decode_workers": 0, "decode_passes": 1},
    ),
    (
        "reader_chunks",
        (3, 2, 5),
        {},
        {},
        {"reader_chunks_native": 3, "reader_chunks_fallback": 2, "reader_chunks_total": 5},
    ),
    (
        "reader_chunks",
        (0, 0, 0),
        {},
        {},
        {"reader_chunks_native": 0, "reader_chunks_fallback": 0, "reader_chunks_total": 0},
    ),
    ("plan_cache", (True,), {}, {}, {"plan_cache.lookups": 1, "plan_cache.hits": 1}),
    ("plan_cache", (False,), {}, {}, {"plan_cache.lookups": 1}),
    (
        "retry",
        (2, 1, 1),
        {},
        {},
        {"retry.attempts": 2, "retry.recovered": 1, "retry.exhausted": 1},
    ),
    ("retry", (0, 0, 0), {}, {}, {}),
    (
        "fault",
        (),
        {"injected": 1, "fallback_units": 1},
        {},
        {"fault.observed": 1, "fault.fallback_units": 1},
    ),
    ("fault", (), {}, {}, {}),
    (
        "window",
        (3, 2, 1, 4, 10),
        {},
        {},
        {
            "window.spans": 3,
            "window.segments_merged": 3,
            "window.segment_hits": 2,
            "window.segments_built": 1,
            "window.partitions_rescanned": 4,
            "window.partitions": 10,
        },
    ),
    (
        "window",
        (0, 0, 0, 0, 0),
        {},
        {},
        {
            "window.spans": 0,
            "window.segments_merged": 0,
            "window.segment_hits": 0,
            "window.segments_built": 0,
            "window.partitions_rescanned": 0,
            "window.partitions": 0,
        },
    ),
]


def _numpy_ints(value):
    return np.int64(value) if type(value) is int else value


def _case_ids():
    seen = set()
    ids = []
    for event, *_ in CASES:
        ids.append(f"{event}-zeros" if event in seen else event)
        seen.add(event)
    return ids


def test_every_event_has_a_case():
    events = {case[0] for case in CASES}
    defined = {name[len("record_"):] for name in dir(recorder) if name.startswith("record_")}
    assert events == defined


@pytest.mark.parametrize("thread", ["caller", "worker"])
@pytest.mark.parametrize("case", CASES, ids=_case_ids())
def test_event_counts_into_stats_tracer_and_span(case, thread):
    event, args, kwargs, fields, counters = case
    record = getattr(recorder, f"record_{event}")
    args = tuple(_numpy_ints(a) for a in args)
    kwargs = {k: _numpy_ints(v) for k, v in kwargs.items()}

    with runtime.monitored() as outer, runtime.monitored() as inner:
        with observe.tracing() as tracer, observe.span("unit") as sp:
            if thread == "caller":
                record(*args, **kwargs)
            else:
                context = _WorkerContext()
                errors = []

                def work():
                    try:
                        with context():
                            record(*args, **kwargs)
                    except BaseException as exc:  # noqa: BLE001 - re-raised below
                        errors.append(exc)

                t = threading.Thread(target=work)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive() and not errors

    want = {**dataclasses.asdict(runtime.ExecutionStats()), **fields}
    for stats in (outer, inner):
        got = dataclasses.asdict(stats)
        assert got == want
        assert all(type(v) is int for v in got.values() if not isinstance(v, list))
    assert list(tracer.counters.items()) == list(counters.items())
    assert all(type(v) is int for v in tracer.counters.values())
    assert list(sp.attrs.items()) == list(counters.items())


@pytest.mark.parametrize("case", CASES, ids=_case_ids())
def test_event_outside_any_block_records_nothing(case):
    event, args, kwargs = case[:3]
    getattr(recorder, f"record_{event}")(*args, **kwargs)
    with runtime.monitored() as stats:
        pass
    assert stats == runtime.ExecutionStats()
