#!/usr/bin/env python3
"""GPU smoke run of deequ_tpu_torch's main paths: verification under each
placement, traced, with forensics and telemetry, column profiling,
constraint suggestion, streamed Parquet with its host fast paths and
its decode workers,
row-group pruning and EXPLAIN, fault containment under injected faults,
incremental runs, window queries and drift checks, anomaly detection, the
mesh-sharded scan and the sharded scan across processes.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py [--rows 8388608] [--seed 7] [--profile-rows 10000000]
                          [--stream-rows 8388608]

Phases, one JSON line each:
  1. device   the card (nvidia-smi name and power limit), torch and CUDA,
              and whether pyarrow and pandas import;
  2. build    nvcc builds deequ_tpu_torch/csrc/ for sm_90a;
     native   gcc builds the C host library (deequ_tpu_torch/ops/native/)
              from the checkout's sources, with its build time and the
              decompression codecs its Parquet reader can load on this
              host; on one batch of the main path's columns the C HLL
              codes (xxhash64_pack) of x, y and id and the three
              dictionary-code bincount sites (Histogram, the profiler's
              histograms, _LowCardCounts) equal their numpy routes
              (DEEQU_TPU_NO_NATIVE) bit for bit, with both routes' times;
  3. kernel   each CUDA kernel against its plain PyTorch version on the
              card, at n = 0, 1, a ragged n and the main path's batch of
              4,194,304 rows, with its time, the plain version's time,
              the least time the card could take, and a library call's
              time where one PyTorch call computes the same function;
              masked_moments and masked_centered_sumsq also at n = 2, 3,
              5 and 7, on views whose bases are not 16-byte aligned, on
              float32 x, on an all-masked batch and with live NaNs, their
              sums bit for bit against the blocked emulation of the
              kernel's own order; hist16 also on a one-value and a
              five-value column (atomic contention), one value over 2^24
              live rows (16-bit counter overflow), unaligned views and a
              flush probe; hll_register_max also with ranks rising into
              one register and on unaligned views; counts and registers
              must match exactly, two launches must agree. For every
              kernel the device time from torch.profiler stands beside
              the CUDA-event time; a launch the card refuses must raise.
              classify_hash_dictionary (K5) on the strings corpus and on
              one SF 1 batch of TPC-H comments from the benchmark's
              generator, bit for bit, timed beside its bound; then the
              default profile streamed over two such row groups, K5
              launching once a batch for l_comment and every column's
              histogram and HLL estimate those of "host-discrete";
              hist16_select (K6) on the eight numeric lineitem columns
              and on one float32 bin holding 1,048,576 rows, bit for bit,
              timed beside its bound and by kernel;
  4. main_path  a VerificationSuite on a --rows table (float64 x and y
              with every 11th x null, int64 id, string cat, int64 grp)
              over the flagship analyzers, two approximate-quantile
              analyzers, a Compliance, a containment, a pattern and the
              frequency analyzers (uniqueness, distinct values, entropy),
              run twice on CUDA: every moment and HLL kernel launches once
              per batch and hist16 once per batch and quantile analyzer,
              the two runs agree bit for bit, the metrics agree with a
              numpy reference, and quantiles, HLL registers, count
              metrics, check statuses and messages equal a device="cpu"
              run. The second run's wall time is split into the fused
              pass and, inside it, the host's predicate evaluation, wire
              packing and quantile selection (host_finish_batch), the
              grouping pass and the static pass (lint/: validate_run_plan).
              explain_plan of the same check on the same table predicts
              the warm run's passes, group passes, launches and batches
              exactly, and its first-batch wire bytes up to the masks the
              run found all-true and sent as constants (listed);
     observe  on phase 4's table, its check less the containment
              (`observe_check`), placement "device" and the counts
              shortcut off (the cost model's assumptions): untraced,
              traced, untraced, traced, the same bits and K1-K4 launches
              (the traced/untraced wall ratio of each pair printed); the
              trace's counters equal runtime.monitored()'s, with a label
              per pass; observe.dispatch_signature of the trace equals
              the PlanCost's and cost_drift is 0 on every counter and
              span; phase_seconds, the root span's share of the wall and,
              from one traced run under torch.profiler, the device's busy
              time and K1-K4's; the Chrome trace written and read back
              (pid 0, one B event per span); two runs with forensics:
              metric-neutral, the same samples, is_complete("x")'s rows
              null in numpy, the audit trail saved and loaded back; the
              engine telemetry record saved, loaded and rendered as
              OpenMetrics text;
     placement  the bandwidth probe on the card with an empty disk
              cache (it must place as "device"; a second call is served
              from the cache with no copy), then phase 4's check less its
              containment and group-bys (`placement_check`) on the same
              table under "device", "host-discrete" and "host-all", each
              twice: the metrics and verdicts agree (float sums within
              1e-12, quantiles within their rank error where the host
              folds the table as one batch), K1-K4 launch as on the main
              path under "device", K3 not under "host-discrete", nothing
              under "host-all"; wall times split into the host fold and
              the device program; then a profile of a boolean, a string
              and a float column (`memo_profile_runs`) under each
              placement: on the host fold the profiler's memos serve
              the boolean and string columns' HLL registers, K3 launches
              under "device" alone, and the distinct counts and
              completeness agree bit for bit;
  5. basic_example  the README's example (examples/basic_example.py's
              checks) on the card, with BASELINE.md's outcome;
  6. profile  ColumnProfilerRunner over the TPC-H lineitem table of
              BASELINE.json config 3 at --profile-rows rows, twice on
              CUDA and once with device="cpu": the CUDA runs bit for bit
              alike, the CPU run equal (mean, sum and stddev within
              METRIC_RTOL), l_quantity and l_extendedprice against numpy,
              one fused pass, and K1-K4 launched as often as the plan
              predicts; the warm run's wall time split by pass;
  7. profile_example  examples/data_profiling_example.py's raw data
              profiled on the card, equal to the CPU run and to the
              values worked out by hand;
  8. suggest  ConstraintSuggestionRunner (Rules.DEFAULT, a test-set ratio
              of 0.1, seed 0) on the lineitem table: suggestions and
              their verdicts equal a device="cpu" run;
  9. stream   streamed Parquet (pyarrow must import): the lineitem table
              written with row groups of 4,194,304 rows and profiled
              through Table.scan_parquet twice with the default pipeline
              (its numeric columns read by the C reader where the host
              loads libsnappy, decoded by the C kernels), once on the
              pyarrow route (DEEQU_TPU_NATIVE_READER=0,
              DEEQU_TPU_DECODE_FASTPATH=0) and once from an UNCOMPRESSED
              copy with DEEQU_TPU_PIPELINE=0, whose every numeric column
              the C reader must take: all four bit for bit alike and
              equal to phase 6's in-memory profile, with its launches;
              the columns the C reader took are printed. Over the
              UNCOMPRESSED copy (`stream_fusion_runs`): decode-to-wire of
              four numeric columns read by merge members only
              (DEEQU_TPU_WIRE_FUSED on and off, the same bits and
              launches), and the encoded fold of four low-cardinality
              columns under "host-all" (DEEQU_TPU_ENCODED_FOLD on and off,
              the same bits, no launch), equal to the device-placed run;
              the warm run's
              wall time split into the consumer's wait for batches, the
              fused pass's host work, host_finish_batch and the device
              fold, and the decode and prep threads' times into the C
              reader, its assembly and the HLL hashing; the warm profile
              on one decode worker beside the default, in mirrored order
              (default, one, one, default: the same bits and launches;
              the four walls and the decode threads' seconds printed);
              the stall pair (`stall_pair`): the chaos check
              over the UNCOMPRESSED copy on one decode worker and on the
              default, unstalled and under DEEQU_TPU_SOURCE_STALL_MS=500,
              the same bits, each run's wall and read-ahead hits and
              misses printed. Then phase 4's
              checks over --stream-rows rows of its table written in row
              groups of 262,144 rows (16 coalesce into each batch),
              streamed on CUDA: equal to the in-memory CUDA run of the
              same rows (phase 4's first run when it ran the same
              table), metric for metric
              and bit for bit, with the grouping analyzers folded through
              GroupCountAccumulator; then the flagship scan analyzers
              streamed over that file with the heartbeat on
              (`observe_heartbeat`: snapshots every 0.2 s to a JSONL file,
              batches never falling, the last one's equal to the scan's).
              Files go to a temporary directory;
              their writing is timed apart from the runs.
 9a. chaos    fault containment over the UNCOMPRESSED lineitem copy
              (`chaos_phase`): two clean traced runs of `chaos_check`
              (the flagship scan analyzers on its numeric columns and
              one quantile; the first warms up), then one run under each
              CHAOS_SPECS fault spec
              (the JAX package's chaos matrix; its decode.worker case on
              two decode workers, as the JAX test runs it) and
              under CHAOS_EXHAUST (every pread fails, each chunk spends
              its retries and reads through pyarrow): each the clean
              run's bits, verdicts and K1-K4 launches, its trace's
              retry and fault counters agreeing with the plan's
              injections, no engine thread left, its wall time beside the
              clean run's; the stall watchdog cancelling a stalled scan
              with DQ404; state.save failing for three of CHAOS_DAYS daily
              partitions, whose rerun scans those three alone, with the
              same bits;
 9b. prune    the lineitem table stably sorted by l_orderkey (dbgen's
              order) in one zstd file of 10 row groups of 1,048,576 rows.
              Run A filters every member (Size, Completeness, Mean, Sum,
              Minimum, Maximum, StandardDeviation, ApproxCountDistinct,
              ApproxQuantile) on l_orderkey >= K, K the smallest key of
              group 7, plus a Size whose where adds a DOUBLE atom (never
              elided); run B filters the same members on l_quantity >= 1
              (proven all-true), the quantile on l_extendedprice. Each
              with DEEQU_TPU_PUSHDOWN on and off, placement "device": the
              metrics bit for bit alike; A skips exactly the groups whose
              pyarrow statistics put their largest key below K, as
              explain_plan predicts, and launches K1-K4 once per
              predicted batch, fewer than off; B skips nothing, elides
              the where (never evaluated, one column fewer decoded) and
              packs the same first-batch wire bytes on and off. EXPLAIN's
              passes, launches, batches and first-batch wire bytes equal
              every run's exactly (B off: up to its all-true mask). Wall
              times and the static pass's time per run, on and off;
 10. incremental  BASELINE.json config 5's incremental state merge:
              INCREMENTAL_DAYS (100) daily Parquet partitions of the
              main path's schema, INCREMENTAL_ROWS (131,072) rows each,
              verified on CUDA with a FileSystemStateRepository and a
              FileSystemMetricsRepository (the flagship analyzers, one
              approximate quantile, one predicate, one string pattern
              and is_unique("id")). A cold fill scans every partition;
              after one more day the rerun scans that day alone and
              launches one partition's worth of K1-K4
              (incremental_launches), while the id group-by reads every
              partition on every run (incremental_passes); a rescan with
              DEEQU_TPU_STATE_CACHE=0 equals it bit for bit; a truncated
              envelope gives DQ314 and a rescan of that partition alone;
              a device="cpu" run over the first ten partitions caches
              none of the card's entries and agrees with merge_range
              over the card's states (counts, minima, maxima, HLL
              registers and sketch bytes exactly, sums within
              METRIC_RTOL); the metrics repository gives back each run's
              metrics; the flows of the three incremental examples (one
              with a frequency analyzer over merged states) equal their
              CPU runs. The append run's time is split into
              loading the envelopes and scanning the new partition. Then
              BASELINE.json config 5's anomaly half: after the cold fill,
              one VerificationSuite run per day over its partition alone
              (the scan analyzers, no group-by), served by the partition
              cache with no launch, saves its metrics under
              ResultKey(day); day 101 (the appended partition) and a day
              102 whose x is shifted by +1.0 run with three anomaly
              checks (OnlineNormalStrategy and Holt-Winters on Mean("x"),
              RateOfChangeStrategy on Size()), on CUDA and with
              device="cpu": the verdicts equal, the Holt-Winters
              parameters within 1e-6, day 102 flagged on Mean("x") by
              both strategies; the fit's time, objective evaluations and
              launches (torch.profiler over one more fit).
 10b. windows  window queries over phase 10's partitions and state
              repository (`windows_phase`): Sliding(7), Tumbling(7) and
              LastN(100) cold and warm, each equal to a card rescan of
              its partitions bit for bit, the warm query reading no row
              and launching nothing, its segment merges equal to the cost
              model's and EXPLAIN's `windows:` line (cost_drift 0); a
              DriftCheck of week 14 against week 13 passing and of day
              102 (x + 1.0, rescanned by the query) against its week
              failing on mean and quantile drift; a state.segment fault
              with the same bits; examples/drift_example.py on the card.
 10c. service  the data-quality service over phase 10's 101 partitions
              (`service_phase`), four tenants' suites (SERVICE_TENANTS:
              scan-shareable analyzers of phase 10's check, no group-by):
              each run solo on the card; then one DQService (one worker,
              a fresh FileSystemStateRepository) runs the four as one
              shared scan while an in-memory blocker holds the worker:
              every handle done with a CONTAINED proof and zero drift,
              each tenant's metric bits and verdicts its solo run's, the
              pro-rata charges summing to the union's predicted bytes,
              K1-K4 launched as one run of the union plan
              (incremental_launches), fewer than the solo runs together;
              each tenant again with DEEQU_TPU_SCAN_SHARING=0 loads all
              101 partitions from the entries the shared scan fanned out,
              scans none and launches nothing; a heavy run of all four
              suites (SERVICE_TIERS: the tier thresholds lowered) preempted by an
              interactive submission once 10 partitions committed (DQ405)
              resumes to the solo bits, launching across its attempts
              what one run launches and scanning each partition once;
              close() with a heavy run in flight and one queued: DQ414
              for the queued one, DQ407 or done for the running one, no
              service thread left; submit_window of Sliding(7) over the
              heavy tenant's entries equals phase 10b's answer bit for
              bit, reading no row and launching nothing.
 11. mesh     BASELINE.json config 4 ("ApproxCountDistinct(HLL) +
              ApproxQuantile(KLL) on 1B-row clickstream, v5e-8 psum State
              merge"), its 1B rows cut to --mesh-rows (33,554,432) for the
              time limit and host memory: user_id Zipf(1.2) over 10^8
              ids, latency_ms lognormal(3, 1) with every 13th row null,
              page_id uniform over 10,000 values; Size, Completeness,
              Mean, StandardDeviation, Minimum and Maximum of latency_ms,
              ApproxCountDistinct(user_id), ApproxQuantiles(latency_ms,
              0.5/0.9/0.99), CountDistinct and Histogram of page_id,
              through VerificationSuite on the single-device pass (first
              and last) and twice over data_mesh([cuda:0] * 8), config
              4's v5e-8 as 8 shards on the card, 2,097,152 rows per shard
              and batch (and over every card where there are more): the
              mesh runs bit for bit alike, K1-K4 launched once per shard,
              batch and kernel use, and against the single runs counts,
              extremes, HLL registers, distinct counts and verdicts
              exact, sums within 1e-12 and quantiles within 1% of rank;
              the first 4,194,304 rows over data_mesh(["cpu"] * 8) with
              device="cpu" equal to the card's mesh (quantiles, registers,
              counts and verdicts exactly);
 12. sharded  the clickstream as 16 zstd Parquet partitions of 1,048,576
              rows (the card's host reads them through the C reader): a
              solo partitioned do_analysis_run with a
              FileSystemStateRepository, then 2 worker processes on
              cuda:0 (parallel/procspawn.py) joined over gloo, each
              running run_sharded_analysis twice with a repository of its
              own: every worker's metrics equal the solo run's bit for
              bit, the workers' first runs launch what the solo run did,
              and their second runs load all 16 partitions from the
              repositories; each traces its second run into a file of
              its own (suffixed with its rank), and the two traces merge
              with pids 0 and 1; times of the solo run, each worker's
              scan and gather, and the spawn.
Then the kernels' summary line (launches on the main path, on the
profile as `launches_profile`, on the streamed profile and verification
as `launches_stream`, on the incremental append run as
`launches_incremental`, per placement of phase `placement` as
`launches_placement`, on one mesh run as `launches_mesh`, on the
workers' first sharded runs as `launches_sharded`, on the pruned run A
as `launches_prune`, on phase `observe`'s traced run as
`launches_observe`, on the clean chaos run as `launches_chaos`, in
the window queries' own rescans as `launches_windows` and in the
service's shared round as `launches_service`) and, last, the device
line. Any failed
check raises: the script exits non-zero and prints no result. Without
CUDA it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import types

BATCH = 1 << 22  # the fused pass's batch: 4,194,304 rows
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP64_OPS_PER_S = 34e12  # H100 SXM FP64 outside the tensor cores (data sheet)
INT32_OPS_PER_S = 33.5e12  # 64 INT32 lanes/SM/clock: half the 67 TFLOP/s FP32 rate
SUM_RTOL = 1e-10  # kernel vs plain: float64 sums taken in another order
METRIC_RTOL = 1e-9  # metrics vs the numpy reference


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def imports(module: str) -> bool:
    try:
        __import__(module)
    except ImportError:
        return False
    return True


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of single launches, with the 50 MB L2
    evicted before each by writing a 256 MB buffer (the main path finds
    its inputs cold too)."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, reps: int = 30) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(nbytes: float, ops: float, ops_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def close(a: float, b: float, rtol: float) -> bool:
    return a == b or abs(a - b) <= rtol * max(abs(a), abs(b))


def moments_phase(torch, ck, device, rng, timer, profile):
    """K1 masked_moments and K2 masked_centered_sumsq against their plain
    versions on the card, with masked rows holding ordinary values (the
    kernels load x before they know the mask): normal data at n = 0, 1,
    2, 3, 5, 7 (head and tail alone), 4,194,267 and 4,194,304; views
    with x at +8 bytes and the mask at +1 and +3 bytes; float32 x, also
    as a view at +4 bytes (a head of three rows); an all-masked batch; and
    live NaNs at rows 5 and n - 3 with a NaN on a masked row, where min,
    max and the sums must be NaN as in the plain version. Count, min and
    max must equal the plain version's, sums agree within SUM_RTOL, two
    launches give the same bits, and the sums equal the blocked emulation
    of the kernel's own order bit for bit. Returns the two summary rows."""
    import numpy as np

    def inputs(kind, n, dtype, xo, mo):
        x = rng.normal(3.0, 2.0, n + 3).astype(dtype)
        valid = np.ones(n + 3, dtype=bool)
        valid[::11] = False  # about 9% nulls, as the main path's x
        if kind == "all-masked":
            valid[:] = False
        elif kind == "nan":
            x[[xo + 5, xo + n - 3]] = np.nan
            valid[[mo + 5, mo + n - 3]] = True
            x[xo] = np.nan  # a masked row: changes nothing
            valid[mo] = False
        x_all = torch.from_numpy(x).to(device)
        m_all = torch.from_numpy(valid).to(device)
        return x_all[xo:xo + n], m_all[mo:mo + n]

    def same(a, b):  # the same value, NaN included
        return a == b or (np.isnan(a) and np.isnan(b))

    def same_bits(a, b):  # the same float64 bits; any NaN matches a NaN
        return np.float64(a).tobytes() == np.float64(b).tobytes() or same(a, b) and a != a

    def calls(x, m, avg):  # {kernel: (its wrapper, its plain version)} on these inputs
        return {
            "masked_moments": (lambda: ck.masked_moments(x, m),
                               lambda: ck.masked_moments_plain(x, m)),
            "masked_centered_sumsq": (lambda: ck.masked_centered_sumsq(x, m, avg),
                                      lambda: ck.masked_centered_sumsq_plain(x, m, avg)),
        }

    f64, f32 = np.float64, np.float32
    # (case, n, dtype, rows x is offset by, bytes the mask is offset by)
    cases = [("normal", n, f64, 0, 0) for n in (0, 1, 2, 3, 5, 7, BATCH - 37, BATCH)]
    cases += [("view", BATCH - 37, f64, 1, 1), ("view", BATCH - 37, f64, 1, 3)]
    cases += [("float32", BATCH, f32, 0, 0), ("float32-view", BATCH - 37, f32, 1, 2)]
    cases += [("all-masked", BATCH, f64, 0, 0), ("nan", BATCH, f64, 0, 0)]
    worst = {"masked_moments": 0.0, "masked_centered_sumsq": 0.0}
    for kind, n, dtype, xo, mo in cases:
        x, m = inputs(kind, n, dtype, xo, mo)
        live = m.any().item()
        avg = x[m].double().mean() if live else torch.zeros((), dtype=torch.float64, device=device)
        head, grid = ck.moments_plan(n, x.data_ptr(), x.element_size())
        where = {"case": kind, "n": n, "dtype": str(x.dtype).replace("torch.", ""),
                 "x_offset_bytes": x.data_ptr() % 16, "mask_offset_bytes": m.data_ptr() % 16,
                 "plan": {"head": head, "grid": grid}}

        got = ck.masked_moments(x, m).cpu().numpy()
        again = ck.masked_moments(x, m).cpu().numpy()
        want = ck.masked_moments_plain(x, m).cpu().numpy()
        blocked = ck.masked_moments_blocked(x, m).cpu().numpy()
        if got.tobytes() != again.tobytes():
            raise AssertionError(f"masked_moments {where}: two launches differ")
        exact = got[0] == want[0] and same(got[2], want[2]) and same(got[3], want[3])
        sum_ok = close(got[1], want[1], SUM_RTOL) or (np.isnan(got[1]) and np.isnan(want[1]))
        if not (exact and sum_ok and same_bits(got[1], blocked[1])):
            raise AssertionError(f"masked_moments {where}: kernel {got} plain {want} blocked {blocked}")
        if kind == "nan" and not np.isnan(got[1:]).all():
            raise AssertionError(f"masked_moments {where}: live NaNs gave {got}")
        if kind == "all-masked" and got.tolist() != [0.0, 0.0, np.inf, -np.inf]:
            raise AssertionError(f"masked_moments {where}: all masked gave {got}")
        err = 0.0 if kind == "nan" or not live else float(np.max(np.abs(got - want)))
        worst["masked_moments"] = max(worst["masked_moments"], err)
        emit({"phase": "kernel_check", "kernel": "masked_moments", **where, "max_abs_err": err,
              "result": got.tolist(), "sum_equals_blocked_emulation": True})

        got = float(ck.masked_centered_sumsq(x, m, avg))
        again = float(ck.masked_centered_sumsq(x, m, avg))
        want = float(ck.masked_centered_sumsq_plain(x, m, avg))
        blocked = float(ck.masked_centered_sumsq_blocked(x, m, avg))
        if np.float64(got).tobytes() != np.float64(again).tobytes():
            raise AssertionError(f"masked_centered_sumsq {where}: two launches differ")
        if not same_bits(got, blocked):
            raise AssertionError(f"masked_centered_sumsq {where}: kernel {got} blocked {blocked}")
        if not (close(got, want, SUM_RTOL) or (np.isnan(got) and np.isnan(want))):
            raise AssertionError(f"masked_centered_sumsq {where}: kernel {got} plain {want}")
        if kind == "all-masked" and got != 0.0:
            raise AssertionError(f"masked_centered_sumsq {where}: all masked gave {got}")
        err = 0.0 if kind == "nan" else abs(got - want)
        worst["masked_centered_sumsq"] = max(worst["masked_centered_sumsq"], err)
        emit({"phase": "kernel_check", "kernel": "masked_centered_sumsq", **where,
              "max_abs_err": err, "result": got, "equals_blocked_emulation": True})
        if kind == "float32":
            emit({"phase": "kernel_float32", **where,
                  **{name: {"ms": timer.ms(fn), "plain_ms": timer.ms(plain)}
                     for name, (fn, plain) in calls(x, m, avg).items()}})
        if kind == "normal" and n == BATCH:
            batch = calls(x, m, avg)
    rows = []
    for name, replaces, outputs, kernel in (
        ("masked_moments", "deequ_tpu/ops/pallas_kernels.py:231", 4, "masked_moments_kernel"),
        ("masked_centered_sumsq", "deequ_tpu/ops/pallas_kernels.py:269", 1,
         "centered_sumsq_kernel"),
    ):
        fn, plain = batch[name]
        ms = timer.ms(fn)
        # bytes: x (float64) and the mask read once, the outputs written once
        bound, by = bound_ms(BATCH * 9 + outputs * 8, 3 * BATCH, FP64_OPS_PER_S)
        profile(name, fn, kernel, ms)
        row = {
            "name": name,
            "route": "cuda",
            "source": "deequ_tpu_torch/csrc/kernels.cu",
            "replaces": replaces,
            "launches": None,
            "max_abs_err": worst[name],
            "ms": ms,
            "plain_ms": timer.ms(plain),
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": None,  # no single PyTorch call computes it
            "held_against_plain": True,
        }
        emit({"phase": "kernel", **row, "rows": BATCH})
        rows.append(row)
    return rows


def same_twice(torch, fn, plain):
    """fn() against plain(), and against a second fn(): both exact."""
    got, again, want = fn(), fn(), plain()
    return torch.equal(got, want) and torch.equal(got, again), got, want


def hll_phase(torch, ck, hll, device, rng, timer, profile):
    """hll_register_max against its plain version: hashed codes at every
    n, then the cases where test-before-atomic and the vector loads can
    break: every live code in one register with ranks rising in row
    order (every row raises it), codes and mask as views whose bases are
    not 16-byte aligned. Registers must match exactly and two launches
    must agree. Returns the summary row."""
    import numpy as np

    def hashed(n):
        # every row hashed, so the mask alone must drop the nulls
        ids = rng.integers(0, max(n, 1), n)
        return hll.pack_codes(ids, np.ones(n, dtype=bool))

    def mask(n):
        valid = np.ones(n, dtype=bool)
        valid[::11] = False  # about 9% nulls, as the main path's x
        return valid

    def rising(n):
        rank = 1 + (np.arange(n) * 63) // max(n, 1)  # 1 .. 63 in row order
        return ((300 << 6) | rank).astype(np.int32)

    # (case, n, codes, mask, offset of the codes view, offset of the mask view)
    cases = [("hashed", n, hashed(n), mask(n), 0, 0) for n in (0, 1, BATCH - 37, BATCH)]
    cases += [("rising-one-register", BATCH, rising(BATCH), mask(BATCH), 0, 0)]
    cases += [("hashed-view", BATCH - 37, hashed(BATCH - 34), mask(BATCH - 34), 1, 1)]
    cases += [("hashed-view", BATCH - 37, hashed(BATCH - 34), mask(BATCH - 34), 1, 2)]
    worst = 0.0
    for kind, n, codes_np, m_np, co, mo in cases:
        codes_all = torch.from_numpy(codes_np).to(device)
        m_all = torch.from_numpy(m_np).to(device)
        codes, m = codes_all[co:co + n], m_all[mo:mo + n]
        ok, got, want = same_twice(torch, lambda: ck.hll_register_max(codes, m),
                                   lambda: ck.hll_register_max_plain(codes, m))
        if not ok:
            raise AssertionError(f"hll_register_max {kind} n={n}: registers differ")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        emit({"phase": "kernel_check", "kernel": "hll_register_max", "case": kind, "n": n,
              "codes_offset_bytes": codes.data_ptr() % 16, "mask_offset_bytes": m.data_ptr() % 16,
              "max_abs_err": err, "max_register": int(got.max()) if n else 0})
        if kind == "hashed" and n == BATCH:
            batch = (codes, m)
    codes, m = batch
    n = BATCH
    ms = timer.ms(lambda: ck.hll_register_max(codes, m))
    plain = timer.ms(lambda: ck.hll_register_max_plain(codes, m))
    # the one-call library yardstick: scatter_reduce_ "amax" over
    # the unpacked register index and rank of the live rows
    live = m & (codes != 0)
    idx = torch.where(live, codes >> 6, 0).to(torch.int64)
    rank = torch.where(live, codes & 0x3F, 0)
    regs = torch.zeros(ck.N_REGISTERS, dtype=torch.int32, device=device)
    regs.scatter_reduce_(0, idx, rank, "amax")
    if not torch.equal(regs, ck.hll_register_max(codes, m)):
        raise AssertionError("hll_register_max: scatter_reduce_ disagrees")
    library = timer.ms(lambda: regs.scatter_reduce_(0, idx, rank, "amax"))
    bound, by = bound_ms(n * 5 + 512 * 4, 4 * n, INT32_OPS_PER_S)
    profile("hll_register_max", lambda: ck.hll_register_max(codes, m), "hll_max", ms)
    row = {
        "name": "hll_register_max",
        "route": "cuda",
        "source": "deequ_tpu_torch/csrc/kernels.cu",
        "replaces": "deequ_tpu/ops/pallas_kernels.py:58",
        "launches": None,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": library,
        "held_against_plain": True,
    }
    emit({"phase": "kernel", **row, "rows": n})
    return row


def hist16_phase(torch, ck, device, rng, timer, profile):
    """hist16 against its plain version: normal data at every n, the two
    contention cases at the main path's batch, then the cases where the
    shared 16-bit counters and the vector loads can break: one value over
    2^24 live rows (every block counts far more than 65535 rows of one
    bin, so only its flushes keep the counts exact) and views whose bases
    are not 16-byte aligned. Counts are integers and must match exactly;
    two launches must agree. A flush probe (a few thousand rows a block)
    times the part of a launch that does not grow with n. Returns the
    summary row."""
    import numpy as np

    def inputs(kind, n, every_live=False):
        if kind == "normal":
            x = rng.normal(3.0, 2.0, n)
        elif kind == "one-value":
            x = np.full(n, 2.5)
        else:  # five values, the shape of the main path's grp column
            x = rng.integers(0, 5, n).astype(np.float64)
        live = np.ones(n, dtype=bool)
        if not every_live:
            live[::11] = False  # excluded rows: the sentinel bin
        return torch.from_numpy(x).to(device), torch.from_numpy(live).to(device)

    probe = ck.sm_count(device) * 4096
    # (case, data, n, offset of the x view, offset of the mask view, every row live)
    cases = [("normal", "normal", n, 0, 0, False) for n in (0, 1, BATCH - 37, BATCH)]
    cases += [(kind, kind, BATCH, 0, 0, False) for kind in ("one-value", "five-value")]
    cases += [("one-value-2^24", "one-value", 1 << 24, 0, 0, True)]
    cases += [("normal-view", "normal", BATCH - 37, 1, 1, False),
              ("normal-view", "normal", BATCH - 37, 2, 3, False)]
    cases += [("flush-probe", "normal", probe, 0, 0, False)]
    timed = {}
    worst = 0.0
    for kind, data, n, xo, lo, every_live in cases:
        x, live = inputs(data, n + 3, every_live)
        x, live = x[xo:xo + n], live[lo:lo + n]
        ok, got, want = same_twice(torch, lambda: ck.hist16(x, live), lambda: ck.hist16_plain(x, live))
        if not ok:
            raise AssertionError(f"hist16 {kind} n={n}: counts differ from the plain version")
        err = float((got - want).abs().max()) if n else 0.0
        worst = max(worst, err)
        head, window, grid = ck.hist16_plan(n, ck.sm_count(device), x.data_ptr())
        emit({"phase": "kernel_check", "kernel": "hist16", "case": kind, "n": n,
              "x_offset_bytes": x.data_ptr() % 16, "mask_offset_bytes": live.data_ptr() % 16,
              "plan": {"head": head, "window": window, "grid": grid},
              "max_abs_err": err, "excluded": int(got[ck.HIST_SENTINEL]),
              "largest_bin": int(got[:ck.HIST_SENTINEL].max()) if n else 0,
              "nonzero_bins": int((got != 0).sum())})
        if kind in ("normal", "one-value", "five-value", "flush-probe") and n in (BATCH, probe):
            bins = ck.f32_sortable_bin16_plain(x.float(), live).long()
            library_counts = torch.bincount(bins, minlength=ck.HIST_BINS)
            if not torch.equal(library_counts.int(), got):
                raise AssertionError(f"hist16 {kind}: torch.bincount disagrees")
            n_live = int(live.sum())
            # the bytes this data needs: the mask, x where live, the counts
            bound, by = bound_ms(n + 8 * n_live + ck.HIST_BINS * 4, 4 * n, INT32_OPS_PER_S)
            timed[kind] = {
                "ms": timer.ms(lambda: ck.hist16(x, live)),
                "plain_ms": timer.ms(lambda: ck.hist16_plain(x, live)),
                "library_ms": timer.ms(lambda: torch.bincount(bins, minlength=ck.HIST_BINS)),
                "bound_ms": bound,
                "bound_by": by,
                "rows": n,
            }
            if kind == "normal":
                profile("hist16", lambda: ck.hist16(x, live), "hist16_count",
                        timed[kind]["ms"])
    emit({"phase": "kernel_contention", "kernel": "hist16", "cases": timed})
    row = {
        "name": "hist16",
        "route": "cuda",
        "source": "deequ_tpu_torch/csrc/kernels.cu",
        "replaces": "deequ_tpu/ops/pallas_kernels.py:165",
        "launches": None,
        "max_abs_err": worst,
        **{k: v for k, v in timed["normal"].items() if k != "rows"},
        "held_against_plain": True,
    }
    emit({"phase": "kernel", **row, "rows": BATCH})
    return row


SELECT_ROWS = 1 << 20  # a row group of the benchmark's TPC-H lineitem at SF 1
SELECT_CAP = 460  # ApproxQuantiles' sample at relative error 0.01


def lineitem_numeric(name: str, rows: int, rng):
    """A numeric TPC-H lineitem column in its Clause 4.2.3 value domain."""
    import numpy as np

    if name == "l_quantity":
        return rng.integers(1, 51, rows).astype(np.float64)
    if name == "l_discount":
        return rng.integers(0, 11, rows) / 100.0
    if name == "l_tax":
        return rng.integers(0, 9, rows) / 100.0
    if name == "l_partkey":
        return rng.integers(1, 200_001, rows).astype(np.float64)
    if name == "l_suppkey":
        return rng.integers(1, 10_001, rows).astype(np.float64)
    if name == "l_linenumber":
        return np.minimum(rng.geometric(0.25, rows), 7).astype(np.float64)
    if name == "l_extendedprice":
        return rng.integers(1, 51, rows) * rng.integers(90_000, 210_000, rows) / 100.0
    if name == "l_orderkey":  # sorted and sparse
        return np.sort(rng.integers(1, 6_000_000, rows)).astype(np.float64)
    raise ValueError(name)


def select_phase(torch, ck, device, rng, timer, card: str, power_limit: str):
    """hist16_select (K6) against its plain version on one row group of
    SELECT_ROWS rows: the eight numeric TPC-H lineitem columns in their
    value domains, and the worst case, one float32 bin holding every row
    (values in [1, 1 + 2^-7)). Sample bits, n and level must match
    exactly, and two launches must agree. Times K6 alone (K4's counts made
    first), its plain version and its bound: 9 bytes a row read, and the
    wanted rows' (key, row) pairs written and read once, 24 bytes each.
    One traced call a case gives K6's device time by kernel. Returns the
    kernel's row."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile as torch_profile

    def wanted_rows(counts):
        c = counts.cpu().numpy().astype(np.int64)
        c[ck.SELECT_VALUE_BINS:] = 0
        level, kept = ck.decimation(int(c.sum()), SELECT_CAP)
        stride = 1 << level
        ranks = stride // 2 + stride * np.arange(kept)
        wanted = np.zeros(ck.HIST_BINS, dtype=bool)
        wanted[np.searchsorted(np.cumsum(c), ranks, side="right")] = True
        zero = list(ck.ZERO_BINS)
        wanted[zero] = wanted[zero].any()
        return int(c[wanted].sum())

    def device_ms_by_kernel(fn):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
                if "select_" in e.key}
    names = ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber", "l_quantity",
             "l_extendedprice", "l_discount", "l_tax")
    cases = [(name, lineitem_numeric(name, SELECT_ROWS, rng)) for name in names]
    cases.append(("one-float32-bin",
                  1.0 + rng.random(SELECT_ROWS) * (2.0 ** -7) * (1 - 2 ** -20)))
    live = torch.ones(SELECT_ROWS, dtype=torch.bool, device=device)
    timed = {}
    for name, values in cases:
        x = torch.from_numpy(values).to(device)
        counts = ck.hist16(x, live)

        def call():
            return ck.hist16_select(x, live, counts, SELECT_CAP)

        got, again = call(), call()
        want = ck.hist16_select_plain(x, live, counts, SELECT_CAP)
        for a, b, w in zip(got, again, want):
            if not (torch.equal(a.view(torch.int64), w.view(torch.int64))
                    and torch.equal(a.view(torch.int64), b.view(torch.int64))):
                raise AssertionError(f"hist16_select {name}: differs from the plain version")
        m = wanted_rows(counts)
        bound, by = bound_ms(9 * SELECT_ROWS + 24 * m, 0, INT32_OPS_PER_S)
        timed[name] = {
            "ms": timer.ms(call),
            "plain_ms": timer.ms(lambda: ck.hist16_select_plain(x, live, counts, SELECT_CAP),
                                 reps=5),
            "bound_ms": bound,
            "bound_by": by,
            "wanted_rows": m,
            "level": int(got[2]),
            "device_ms_by_kernel": device_ms_by_kernel(call),
        }
        emit({"phase": "kernel_check", "kernel": "hist16_select", "case": name,
              "rows": SELECT_ROWS, **timed[name]})
    lineitem = [timed[name] for name in names]
    row = {
        "name": "hist16_select",
        "route": "cuda",
        "source": "deequ_tpu_torch/csrc/kernels.cu",
        "replaces": "none: the JAX package selects the sample on the host "
                    "(deequ_tpu/analyzers/sketch.py host_finish_batch)",
        "rows": SELECT_ROWS,
        "cap": SELECT_CAP,
        "ms_lineitem_mean": statistics.fmean(t["ms"] for t in lineitem),
        "plain_ms_lineitem_mean": statistics.fmean(t["plain_ms"] for t in lineitem),
        "bound_ms_lineitem_mean": statistics.fmean(t["bound_ms"] for t in lineitem),
        "worst_case": timed["one-float32-bin"],
        "library_ms": None,  # no single PyTorch call selects it
        "held_against_plain": True,
        "card": card,
        "power_limit": power_limit,
    }
    emit({"phase": "kernel", **row})
    return row


def profiler_phase(torch, timer):
    """A `profile(name, fn, kernel, event_ms)` that runs fn under
    torch.profiler, the L2 evicted before each call as the event timer
    does, and emits the kernel's device time beside the CUDA-event time
    of the call. From the device timeline: the span from the start of
    the call's first device operation (the output's zero fill, where the
    call has one) to the end of the kernel, and the gap between the
    eviction's end and that start, which would hold any host delay
    inside the event time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    def run(name, fn, kernel, event_ms, reps=20):
        fn()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                timer.flush.zero_()
                fn()
            torch.cuda.synchronize()
        ops = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        kernel_us, span_us, gap_us, first_ops = [], [], [], set()
        evict = None  # the eviction's fill of the uint8 buffer, then the call's ops
        for i, e in enumerate(ops):
            if "FillFunctor<unsigned char>" in e.name:
                evict = i
            elif kernel in e.name and evict is not None and evict < i:
                first = ops[evict + 1]
                first_ops.add(first.name)
                kernel_us.append(e.time_range.end - e.time_range.start)
                span_us.append(e.time_range.end - first.time_range.start)
                gap_us.append(first.time_range.start - ops[evict].time_range.end)
                evict = None

        def median_ms(values):
            return statistics.median(values) / 1e3 if values else None

        emit({"phase": "kernel_profile", "kernel": name, "launches": len(kernel_us),
              "kernel_device_ms": median_ms(kernel_us), "call_span_ms": median_ms(span_us),
              "gap_after_eviction_ms": median_ms(gap_us), "event_ms": event_ms,
              "call_first_ops": sorted(first_ops)})

    return run


SF1_BATCH = 1 << 20  # the benchmark's row group of TPC-H lineitem at SF 1


def strings_phase(torch, ck, device, timer, profile, seed: int, card: str, power_limit: str):
    """K5 (classify_hash_dictionary) against its plain version on the
    card, bit for bit and two launches alike: the edge corpus
    (deequ_tpu_torch/testing/strings_corpus.py) and one SF 1 batch of
    TPC-H comments from the benchmark's generator (1,048,576 rows, about
    910,000 dictionary entries), with its median time beside the least
    time the card could take (the offsets, the UTF-8 bytes and the codes
    read once, 5 B a row written) and the plain version's. Then the
    default profile streamed over two such row groups: K5 launches once a
    batch, for l_comment alone (`device_strings`), and every column's
    DataType histogram and HLL estimate equal the host-discrete
    placement's, whose host route computes them on the host. Returns the
    kernel's row."""
    import tempfile

    import numpy as np

    from benchmark.gen import lineitem as tpch
    from deequ_tpu_torch import ColumnProfilerRunner, Table
    from deequ_tpu_torch.ops import runtime
    from deequ_tpu_torch.testing import strings_corpus

    def on_card(offsets, data, codes):
        return [torch.from_numpy(a).to(device) for a in (offsets, data, codes)]

    values = strings_corpus.EDGE_CASES + strings_corpus.fuzz(20_000, seed)
    offsets, data = strings_corpus.utf8_arrays(values)
    edge = on_card(offsets, data,
                   np.concatenate([np.arange(len(values)), [-1, 0, -1]]).astype(np.int32))
    comments = tpch.generate(SF1_BATCH, seed).comments.arrow().dictionary_encode()
    dictionary = comments.dictionary
    raw = dictionary.buffers()
    sf1_offsets = np.frombuffer(raw[1], dtype=np.int32)[: len(dictionary) + 1].astype(np.int64)
    sf1_data = np.frombuffer(raw[2], dtype=np.uint8)[: int(sf1_offsets[-1])].copy()
    sf1 = on_card(sf1_offsets, sf1_data, comments.indices.to_numpy().astype(np.int32))
    for case, args in (("edge_corpus", edge), ("sf1_comments", sf1)):
        got = ck.classify_hash_dictionary(*args)
        again = ck.classify_hash_dictionary(*args)
        want = ck.classify_hash_dictionary_plain(*args)
        for g, a, w in zip(got, again, want):
            if not (torch.equal(g, w) and torch.equal(g, a)):
                raise AssertionError(
                    f"classify_hash_dictionary {case}: rows differ from the plain version")
        emit({"phase": "kernel_check", "kernel": "classify_hash_dictionary", "case": case,
              "entries": args[0].numel() - 1, "rows": args[2].numel(), "bytes": args[1].numel(),
              "classes": torch.bincount(got[0].long(), minlength=5).tolist()})
    n, rows, text = len(dictionary), sf1[2].numel(), len(sf1_data)
    ms = timer.ms(lambda: ck.classify_hash_dictionary(*sf1))
    plain = timer.ms(lambda: ck.classify_hash_dictionary_plain(*sf1), reps=5)
    bound, by = bound_ms(8 * (n + 1) + text + 4 * rows + 5 * rows, 0, INT32_OPS_PER_S)
    for kernel in ("dict_strings_entries", "dict_strings_rows"):
        profile("classify_hash_dictionary", lambda: ck.classify_hash_dictionary(*sf1), kernel, ms)

    # the default profile streamed over two SF 1 row groups: K5 for
    # l_comment in each batch, the host route's answers under host-discrete
    with tempfile.TemporaryDirectory(prefix="chip_smoke_strings_") as tmp:
        path = tpch.write(tpch.generate(2 * SF1_BATCH, seed),
                          os.path.join(tmp, "lineitem.parquet"), SF1_BATCH, "zstd")

        def run():
            with runtime.monitored() as stats:
                ck.reset_launch_counts()
                start = time.perf_counter()
                profiles = ColumnProfilerRunner.on_data(
                    Table.scan_parquet(path), device="cuda").run()
                wall = time.perf_counter() - start
            answers = {name: (p.approximate_num_distinct_values, getattr(p, "type_counts", None),
                              p.data_type) for name, p in profiles.profiles.items()}
            seen = (stats.device_strings, stats.device_strings_total)
            return answers, wall, ck.launch_counts(), seen

        device_runs = [run(), run()]
        with env(DEEQU_TPU_PLACEMENT="host-discrete"):
            host = run()
    for answers, _wall, launches, strings_seen in device_runs:
        if launches["classify_hash_dictionary"] != 2 or strings_seen[0] != 2:
            raise AssertionError(
                f"strings profile: launches {launches}, device strings {strings_seen}")
        if answers != host[0]:
            raise AssertionError("strings profile: the device route's histograms or HLL estimates "
                                 "differ from the host route's")
    if host[2]["classify_hash_dictionary"] or host[3][0]:
        raise AssertionError(f"strings profile: host-discrete launched {host[2]}")
    row = {
        "name": "classify_hash_dictionary",
        "route": "cuda",
        "source": "deequ_tpu_torch/csrc/kernels.cu",
        "replaces": "none: the JAX package classifies and hashes strings on the host "
                    "(deequ_tpu/ops/strings.py)",
        "entries": n,
        "rows": rows,
        "utf8_bytes": text,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
        "held_against_plain": True,
        "launches_profile": device_runs[1][2]["classify_hash_dictionary"],
        "device_strings_profile": list(device_runs[1][3]),
        "profile_rows": 2 * SF1_BATCH,
        "profile_warm_run_s": device_runs[1][1],
        "profile_host_discrete_run_s": host[1],
        "card": card,
        "power_limit": power_limit,
    }
    emit({"phase": "kernel", **row})
    return row


def refused_launch_phase(torch, ck, cuda_build, device):
    """A launch the card refuses (here: a grid of 0 blocks) comes back
    as a CUDA error from the C launcher, and the wrapper's check raises."""
    lib = cuda_build.load()
    x = torch.zeros(8, dtype=torch.float64, device=device)
    live = torch.ones(8, dtype=torch.bool, device=device)
    out = torch.empty(ck.HIST_BINS, dtype=torch.int32, device=device)
    err = lib.dq_hist16(x.data_ptr(), live.data_ptr(), 8, 0, 8, 0, out.data_ptr(), ck._stream(x))
    if err == 0:
        raise AssertionError("a launch of 0 blocks was not refused")
    try:
        ck._raise_on(err, "hist16")
    except RuntimeError as exc:
        emit({"phase": "refused_launch", "cuda_error": err, "raised": str(exc)})
    else:
        raise AssertionError("the wrapper's check let a refused launch pass")
    torch.cuda.synchronize()


def flagship_table(rows: int, seed: int):
    from deequ_tpu_torch.data.table import ColumnType, Table

    data = flagship_data(rows, seed)
    return data, Table.from_numpy(data, types={"cat": ColumnType.STRING})


def flagship_data(rows: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.normal(3.0, 2.0, rows)
    y = 0.5 * x + rng.normal(0.0, 1.0, rows)
    x[::11] = np.nan  # nulls exercise the mask algebra
    ids = rng.integers(0, rows, rows)
    cats = np.array(["ok", "warn", "err", "skip", None], dtype=object)
    cat = cats[rng.integers(0, len(cats), rows)]
    grp = rng.integers(0, 5, rows)
    return {"x": x, "y": y, "id": ids, "cat": cat, "grp": grp}


def numpy_reference(data):
    import numpy as np

    x, y = data["x"], data["y"]
    valid = ~np.isnan(x)
    xv = x[valid]
    both = valid & ~np.isnan(y)
    xb, yb = x[both] - x[both].mean(), y[both] - y[both].mean()
    return {
        "Size(None)": float(len(x)),
        "Completeness(x,None)": float(valid.sum()) / len(x),
        "Mean(x,None)": float(xv.mean()),
        "Minimum(x,None)": float(xv.min()),
        "Maximum(x,None)": float(xv.max()),
        "Sum(x,None)": float(xv.sum()),
        "StandardDeviation(x,None)": float(xv.std()),
        "Correlation(x,y,None)": float((xb * yb).sum() / np.sqrt((xb * xb).sum() * (yb * yb).sum())),
    }


def numpy_slice2_reference(data):
    """Counts and entropy of the second slice's analyzers, from numpy."""
    import numpy as np

    n = len(data["x"])
    x, cat, ids, grp = data["x"], data["cat"], data["id"], data["grp"]
    present = np.array([c is not None for c in cat])
    labels, cat_counts = np.unique(cat[present].astype(str), return_counts=True)
    _, id_counts = np.unique(ids, return_counts=True)
    p = cat_counts / n
    with np.errstate(invalid="ignore"):
        positive = np.isnan(x) | (np.nan_to_num(x) > 0)
    in_set = np.isin(cat[present].astype(str), ["ok", "warn", "err", "skip"]).sum()
    ok_warn = np.isin(cat[present].astype(str), ["ok", "warn"]).sum()
    return {
        "Compliance(x positive or null,x > 0 OR x IS NULL,None)": float(positive.sum()) / n,
        CONTAINED: float((~present).sum() + in_set) / n,
        "PatternMatch(cat,^(ok|warn)$,None)": float(ok_warn) / n,
        "Uniqueness(List(id))": float((id_counts == 1).sum()) / n,
        "Histogram(grp,None,1000)": float(len(np.unique(grp))),
        "Entropy(cat)": float(-(p * np.log(p)).sum()),
    }


CONTAINED = (
    "Compliance(cat contained in ok,warn,err,skip,"
    "`cat` IS NULL OR `cat` IN ('ok','warn','err','skip'),None)"
)
QUANTILES = {"ApproxQuantile(x,0.5,0.01)": ("x", (0.5,)),
             "ApproxQuantiles(y,List(0.1, 0.5, 0.9),0.01)": ("y", (0.1, 0.5, 0.9))}


EXACT = ("Size(None)", "Completeness(x,None)", "Minimum(x,None)", "Maximum(x,None)")


def metric_values(result):
    """{analyzer repr: value}: a float, a {quantile: float} dict for
    ApproxQuantiles, and a Histogram's number of bins."""
    out = {}
    for analyzer, metric in result.metrics.items():
        value = metric.value.get()
        if isinstance(value, dict):
            out[repr(analyzer)] = value
        elif hasattr(value, "number_of_bins"):
            out[repr(analyzer)] = float(value.number_of_bins)
        else:
            out[repr(analyzer)] = value
    return out


def same_bits(a, b) -> bool:
    import numpy as np

    if isinstance(a, dict):
        return list(a) == list(b) and all(same_bits(a[k], b[k]) for k in a)
    return np.float64(a).tobytes() == np.float64(b).tobytes()


_TIMING_LOCK = threading.Lock()


@contextlib.contextmanager
def timed_calls(owner, name, totals, calls=None):
    """Accumulate the wall time of every call of owner.<name> in
    totals[name]; with `calls`, also append each call's time to it."""
    original = getattr(owner, name)
    # a class keeps its own attribute (a staticmethod stays one)
    saved = vars(owner).get(name, original) if isinstance(owner, type) else original

    def wrapper(*args, **kwargs):
        start = time.perf_counter()
        try:
            return original(*args, **kwargs)
        finally:
            elapsed = time.perf_counter() - start
            with _TIMING_LOCK:  # decode workers and read-ahead slots add at once
                totals[name] = totals.get(name, 0.0) + elapsed
                if calls is not None:
                    calls.append(elapsed)

    setattr(owner, name, wrapper)
    try:
        yield totals
    finally:
        setattr(owner, name, saved)


def flagship_check(rows: int):
    """The main path's check over a `rows`-row flagship table."""
    from deequ_tpu_torch import Check, CheckLevel

    return (
        Check(CheckLevel.ERROR, "flagship")
        .has_size(lambda n: n == rows)
        .is_complete("x")  # fails: every 11th x is null
        .has_completeness("x", lambda c: c > 0.9)
        .has_mean("x", lambda v: 2.9 < v < 3.1)
        .has_min("x", lambda v: v < 0)
        .has_max("x", lambda v: v > 6)
        .has_sum("x", lambda v: v > 0)
        .has_standard_deviation("x", lambda v: 1.9 < v < 2.1)
        .has_correlation("x", "y", lambda r: r > 0.5)
        .has_approx_count_distinct("id", lambda v: v > 0.5 * rows)
        .has_approx_quantile("x", 0.5, lambda m: 2.9 < m < 3.1)
        .satisfies("x > 0 OR x IS NULL", "x positive or null", lambda r: r > 0.9)
        .is_contained_in("cat", ["ok", "warn", "err", "skip"])
        .has_pattern("cat", "^(ok|warn)$", lambda r: 0.35 < r < 0.45)
        .is_unique("id")  # fails: ids are drawn with repeats
        .has_number_of_distinct_values("grp", lambda b: b == 5)
        .has_entropy("cat", lambda e: e > 1.0)
    )


def flagship_launches(rows: int):
    """Each kernel's launches in one main-path run over `rows` rows."""
    batches = -(-rows // BATCH)
    return {
        "masked_moments": batches,
        "masked_centered_sumsq": batches,
        "hll_register_max": batches,
        "hist16": 2 * batches,  # one per batch and quantile analyzer
        "classify_hash_dictionary": 0,  # no string dictionary past 65,536 entries
        "hist16_select": 2 * batches,  # one per hist16: each selects its sample
    }


INCREMENTAL_DAYS = 100
INCREMENTAL_ROWS = 1 << 17  # rows of one daily partition: 131,072
INCREMENTAL_INEXACT = ("Mean", "Sum", "StandardDeviation", "Correlation")  # float sums


def incremental_check():
    """The incremental phase's check over daily partitions: the flagship
    analyzers, one quantile and one predicate, so K1-K4 all run, one
    string predicate, which caches with the scan, and one grouping
    analyzer, whose group-by reads every partition on every run."""
    from deequ_tpu_torch import Check, CheckLevel

    return (
        Check(CheckLevel.ERROR, "daily")
        .has_size(lambda n: n > 0)
        .is_complete("x")  # fails: every 11th x is null
        .has_completeness("x", lambda c: c > 0.9)
        .has_mean("x", lambda v: 2.9 < v < 3.1)
        .has_min("x", lambda v: v < 0)
        .has_max("x", lambda v: v > 6)
        .has_sum("x", lambda v: v > 0)
        .has_standard_deviation("x", lambda v: 1.9 < v < 2.1)
        .has_correlation("x", "y", lambda r: r > 0.5)
        .has_approx_count_distinct("id", lambda v: v > 0)
        .has_approx_quantile("x", 0.5, lambda m: 2.9 < m < 3.1)
        .satisfies("x > 0 OR x IS NULL", "x positive or null", lambda r: r > 0.9)
        .has_pattern("cat", "^(ok|warn)$", lambda r: 0.35 < r < 0.45)
        .is_unique("id")  # fails: every day draws ids from one range
    )


def incremental_launches(partitions: int, rows_per_partition: int):
    """Each kernel's launches when `partitions` partitions of
    `rows_per_partition` rows are scanned with incremental_check(): every
    partition folds its own batches, each batch launches every kernel
    once (hist16 once per quantile analyzer, and the check has one), and
    a partition whose states load from the repository launches nothing."""
    batches = partitions * -(-rows_per_partition // BATCH)
    return {
        "masked_moments": batches,
        "masked_centered_sumsq": batches,
        "hll_register_max": batches,
        "hist16": batches,
        "classify_hash_dictionary": 0,
        "hist16_select": batches,
    }


def incremental_passes(scanned: int, rows_in_source: int):
    """The engine's work in one incremental_check() run that scans
    `scanned` partitions of a source of `rows_in_source` rows: a fused
    pass per scanned partition and one shared frequency aggregation on
    the device, and one group-by over the whole source. The partition
    cache holds scan states only, so the group-by reads every row of
    every partition, cached or not."""
    return {"device_passes": scanned + 1, "group_passes": 1, "group_rows": rows_in_source}


@contextlib.contextmanager
def counted_rows(owner, name, totals):
    """Sum in totals[name] the rows of the table that each call of
    owner.<name> gets as its first argument."""
    original = getattr(owner, name)

    def wrapper(table, *args, **kwargs):
        totals[name] = totals.get(name, 0) + table.num_rows
        return original(table, *args, **kwargs)

    setattr(owner, name, wrapper)
    try:
        yield totals
    finally:
        setattr(owner, name, original)


def verdicts(result):
    return [
        (cr.status.value, cr.message)
        for res in result.check_results.values()
        for cr in res.constraint_results
    ]


def main_path_phase(torch, ck, rows: int, seed: int, card: str, power_limit: str):
    import numpy as np

    from deequ_tpu_torch import CheckStatus, VerificationSuite
    from deequ_tpu_torch.analyzers import (
        ApproxCountDistinct, ApproxQuantiles, Completeness, Correlation, Maximum, Mean,
        Minimum, Size, StandardDeviation, Sum,
    )
    from deequ_tpu_torch.analyzers.sketch import _QuantileAnalyzerBase
    from deequ_tpu_torch.data.expr import Predicate
    from deequ_tpu_torch.ops import fused, runtime
    from deequ_tpu_torch.ops.fused import FusedScanPass
    from deequ_tpu_torch.lint import explain_plan
    from deequ_tpu_torch.runners import analysis_runner
    from deequ_tpu_torch.verification import suite

    t0 = time.perf_counter()
    data, table = flagship_table(rows, seed)
    setup_s = time.perf_counter() - t0
    check = flagship_check(rows)
    quantiles_y = ApproxQuantiles("y", [0.1, 0.5, 0.9])
    batches = -(-rows // BATCH)
    expected_launches = flagship_launches(rows)

    def run(device):
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = (
            VerificationSuite.on_data(table, device=device)
            .add_check(check)
            .add_required_analyzer(quantiles_y)
            .run()
        )
        wall = time.perf_counter() - start
        return result, wall, ck.launch_counts()

    runs = []
    split = {}
    seen = []
    for i in range(2):
        with contextlib.ExitStack() as stack:
            if i == 1:  # the warm run: where its wall time goes
                stack.enter_context(packed_bytes(seen))
                stack.enter_context(timed_calls(suite, "validate_run_plan", split))
                warm_stats = stack.enter_context(runtime.monitored())
                stack.enter_context(timed_calls(FusedScanPass, "run", split))
                stack.enter_context(timed_calls(Predicate, "eval_mask", split))
                stack.enter_context(timed_calls(Predicate, "eval", split))
                stack.enter_context(timed_calls(fused, "pack_batch_inputs", split))
                stack.enter_context(timed_calls(_QuantileAnalyzerBase, "host_finish_batch", split))
                stack.enter_context(timed_calls(analysis_runner, "run_grouping_analyzers", split))
            result, wall, counts = run("cuda")
        if counts != expected_launches:
            raise AssertionError(f"launches {counts}, expected {expected_launches}")
        runs.append((result, wall, counts))
    # EXPLAIN of the same check on the same table against the warm run
    t0 = time.perf_counter()
    explained = explain_plan(table, [quantiles_y], [check], device="cuda")
    explain_s = time.perf_counter() - t0
    explain_line = explained_against_run("main path", explained, warm_stats, seen,
                                         exact_wire=False)
    metrics = [metric_values(r) for r, _w, _c in runs]
    for key, value in metrics[0].items():
        if not same_bits(value, metrics[1][key]):
            raise AssertionError(f"{key}: runs differ, {value!r} vs {metrics[1][key]!r}")

    want = numpy_reference(data)
    for key, ref in want.items():
        got = metrics[0][key]
        if not (got == ref if key in EXACT else close(got, ref, METRIC_RTOL)):
            raise AssertionError(f"{key}: port {got!r} vs numpy {ref!r}")
    for key, ref in numpy_slice2_reference(data).items():
        got = metrics[0][key]
        exact = not key.startswith("Entropy")
        if not (got == ref if exact else abs(got - ref) <= 1e-9):
            raise AssertionError(f"{key}: port {got!r} vs numpy {ref!r}")
    for key, (column, qs) in QUANTILES.items():
        got = metrics[0][key]
        values = [got] if not isinstance(got, dict) else [got[repr(q)] for q in qs]
        col = np.sort(data[column][~np.isnan(data[column])])
        for q, value in zip(qs, values):
            rank = float(np.searchsorted(col, value))
            if abs(rank - q * len(col)) > 0.01 * len(col):
                raise AssertionError(f"{key} q={q}: rank {rank} off {q * len(col)} by more than 1%")

    cpu_result, cpu_wall, cpu_counts = run("cpu")
    if any(cpu_counts.values()):
        raise AssertionError(f"a device='cpu' run launched kernels: {cpu_counts}")
    cpu_metrics = metric_values(cpu_result)
    for key in list(QUANTILES) + [k for k in numpy_slice2_reference(data) if not k.startswith("Entropy")]:
        if not same_bits(metrics[0][key], cpu_metrics[key]):
            raise AssertionError(f"{key}: cuda {metrics[0][key]!r} vs cpu {cpu_metrics[key]!r}")

    if verdicts(runs[0][0]) != verdicts(cpu_result):
        raise AssertionError(f"verdicts differ: {verdicts(runs[0][0])} vs {verdicts(cpu_result)}")
    if runs[0][0].status != CheckStatus.ERROR:  # is_complete("x") must fail
        raise AssertionError(f"unexpected suite status {runs[0][0].status}")
    failed = [msg for status, msg in verdicts(runs[0][0]) if status == "Failure"]
    if len(failed) != 2:  # is_complete("x") and is_unique("id") only
        raise AssertionError(f"expected two failed constraints, got {failed}")

    flagship = [
        Size(), Completeness("x"), Mean("x"), Minimum("x"), Maximum("x"), Sum("x"),
        StandardDeviation("x"), Correlation("x", "y"), ApproxCountDistinct("id"),
    ]
    states = {
        dev: [r.state_or_raise() for r in FusedScanPass(flagship, device=dev).run(table)]
        for dev in ("cuda", "cpu")
    }
    acd_gpu, acd_cpu = states["cuda"][-1], states["cpu"][-1]
    if not np.array_equal(acd_gpu.registers, acd_cpu.registers):
        raise AssertionError("ApproxCountDistinct registers differ between cuda and cpu")
    for gpu_state, cpu_state in zip(states["cuda"][:2], states["cpu"][:2]):
        if gpu_state != cpu_state:  # Size and Completeness counts: exact
            raise AssertionError(f"count states differ: {gpu_state} vs {cpu_state}")

    second = runs[1][1]
    out = {
        "phase": "main_path",
        "rows": rows,
        "batches": batches,
        "seed": seed,
        "card": card,
        "power_limit": power_limit,
        "fold_variant": runtime.fold_variant(runtime.resolve_device("cuda")),
        "table_setup_s": setup_s,
        "first_run_s": runs[0][1],
        "second_run_s": second,
        "rows_per_s_second_run": rows / second,
        # predicates, packing and host_finish_batch run inside the fused pass
        "second_run_split_s": {
            "fused_pass": split.get("run", 0.0),
            "predicates": split.get("eval_mask", 0.0) + split.get("eval", 0.0),
            "pack_batch_inputs": split.get("pack_batch_inputs", 0.0),
            "host_finish_batch": split.get("host_finish_batch", 0.0),
            "grouping_pass": split.get("run_grouping_analyzers", 0.0),
            "static_pass": split.get("validate_run_plan", 0.0),
        },
        "explain_s": explain_s,
        "explain": explain_line,
        "host_finish_batch_share": split.get("host_finish_batch", 0.0) / second,
        "cpu_run_s": cpu_wall,
        "launches_per_run": runs[0][2],
        "metrics": metrics[0],
        "status": runs[0][0].status.value,
    }
    emit(out)
    # the first run, which the stream phase compares its streamed run
    # with, and the table, which the observe phase runs on
    return runs[0][2], ((rows, seed), runs[0], data, table)


# the CUDA symbol of each kernel, as torch.profiler names its launches
KERNEL_SYMBOLS = {
    "masked_moments": "masked_moments_kernel",
    "masked_centered_sumsq": "centered_sumsq_kernel",
    "hll_register_max": "hll_max",
    "hist16": "hist16_count",
}


def observe_check(rows: int):
    """The main path's check less its string containment
    (`is_contained_in`, ~17 s of the main path's ~20 s warm run: host
    work over Python strings, the same traced or not), so that the
    observe phase's runs fit its time budget; the flagship analyzers,
    two quantiles, a Compliance, a pattern and the three grouping sets
    stay."""
    from deequ_tpu_torch import Check, CheckLevel

    return (
        Check(CheckLevel.ERROR, "observe")
        .has_size(lambda n: n == rows)
        .is_complete("x")  # fails: every 11th x is null
        .has_completeness("x", lambda c: c > 0.9)
        .has_mean("x", lambda v: 2.9 < v < 3.1)
        .has_min("x", lambda v: v < 0)
        .has_max("x", lambda v: v > 6)
        .has_sum("x", lambda v: v > 0)
        .has_standard_deviation("x", lambda v: 1.9 < v < 2.1)
        .has_correlation("x", "y", lambda r: r > 0.5)
        .has_approx_count_distinct("id", lambda v: v > 0.5 * rows)
        .has_approx_quantile("x", 0.5, lambda m: 2.9 < m < 3.1)
        .satisfies("x > 0 OR x IS NULL", "x positive or null", lambda r: r > 0.9)
        .has_pattern("cat", "^(ok|warn)$", lambda r: 0.35 < r < 0.45)
        .is_unique("id")  # fails: ids are drawn with repeats
        .has_number_of_distinct_values("grp", lambda b: b == 5)
        .has_entropy("cat", lambda e: e > 1.0)
    )


def device_busy_ms(prof, DeviceType):
    """(the union of the device operations' intervals, each kernel's
    device time) of a torch.profiler run, in ms."""
    ops = sorted(
        ((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
         if e.device_type == DeviceType.CUDA),
        key=lambda t: t[0],
    )
    busy_us, end = 0.0, None
    for start, stop, _name in ops:
        if end is None or start > end:
            busy_us += stop - start
            end = stop
        elif stop > end:
            busy_us += stop - end
            end = stop
    kernels = {
        name: sum(stop - start for start, stop, op in ops if symbol in op) / 1e3
        for name, symbol in KERNEL_SYMBOLS.items()
    }
    return busy_us / 1e3, kernels


def observe_phase(torch, ck, main_run, card: str, power_limit: str, kernel_rows):
    """Tracing, counters, the trace differential, forensics and telemetry
    on the main path's table (`main_run` of phase 4), placement "device"
    and the counts shortcut off (the knobs the cost model assumes, as
    tests/test_trace_differential.py pins them). -> the kernels'
    launches in the traced run."""
    import tempfile

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from deequ_tpu_torch import VerificationSuite, observe
    from deequ_tpu_torch.analyzers import ApproxQuantiles
    from deequ_tpu_torch.lint.cost import cost_drift
    from deequ_tpu_torch.ops import runtime
    from deequ_tpu_torch.repository import engine
    from deequ_tpu_torch.repository.audit import load_audit_trail
    from deequ_tpu_torch.repository.base import ResultKey
    from deequ_tpu_torch.repository.fs import FileSystemMetricsRepository

    phase_t0 = time.perf_counter()
    (rows, _seed), _first, data, table = main_run
    check = observe_check(rows)
    quantiles_y = ApproxQuantiles("y", [0.1, 0.5, 0.9])
    expected_launches = flagship_launches(rows)

    def run(traced=False, forensics=False, repository=None, key=None):
        builder = (VerificationSuite.on_data(table, device="cuda").add_check(check)
                   .add_required_analyzer(quantiles_y).with_tracing(traced))
        if forensics:
            builder = builder.with_forensics()
        if repository is not None:
            builder = builder.use_repository(repository).save_or_append_result(key)
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        with runtime.monitored() as stats:
            start = time.perf_counter()
            result = builder.run()
            wall = time.perf_counter() - start
        counts = ck.launch_counts()
        if counts != expected_launches:
            raise AssertionError(f"observe: launches {counts}, expected {expected_launches}")
        return result, wall, counts, stats

    with env(DEEQU_TPU_PLACEMENT="device", DEEQU_TPU_NO_COUNTS_FASTPATH="1"), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_observe_") as tmp:
        # warm untraced, traced, untraced, traced: the same bits and launches
        runs = [run(traced) for traced in (False, True, False, True)]
        plain = metric_values(runs[0][0])
        for result, _wall, counts, _stats in runs[1:]:
            got = metric_values(result)
            if list(got) != list(plain) or not all(same_bits(got[k], v) for k, v in plain.items()):
                raise AssertionError("observe: a traced run's metrics differ from an untraced run's")
            if verdicts(result) != verdicts(runs[0][0]):
                raise AssertionError("observe: a traced run's verdicts differ")
        for result, _wall, _counts, _stats in runs[::2]:
            if result.run_trace is not None:
                raise AssertionError("observe: an untraced run carries a trace")
        pairs = [runs[1][1] / runs[0][1], runs[3][1] / runs[2][1]]

        # the counters: the trace's equal monitored() of the same run
        traced, traced_wall, traced_launches, stats = runs[3]
        trace = traced.run_trace
        for name in ("device_passes", "device_launches", "group_passes"):
            if trace.counters.get(name, 0) != getattr(stats, name):
                raise AssertionError(f"observe: trace {name} {trace.counters.get(name, 0)} vs "
                                     f"monitored() {getattr(stats, name)}")
        labels = list(stats.pass_labels)
        if len(labels) != stats.device_passes + stats.group_passes or not all(
                label.startswith(("scan:", "freq-agg:", "group:")) for label in labels):
            raise AssertionError(f"observe: pass labels {labels}")

        # the trace differential: the cost model's prediction equals the trace
        predicted = traced.plan_cost.dispatch_signature()
        observed = observe.dispatch_signature(trace)
        if predicted != observed:
            raise AssertionError(f"observe: predicted {predicted} vs traced {observed}")
        drift = cost_drift(traced.plan_cost, trace)
        moved = {k: v for k, v in drift.items()
                 if k.startswith(("drift.counter.", "drift.span.")) and v != 0.0}
        if moved:
            raise AssertionError(f"observe: cost_drift {moved}")

        # where the time goes: the spans' self time, the root's share of
        # the wall, and the device's busy time under torch.profiler
        phases = trace.phase_seconds()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled, profiled_wall, _c, _s = run(traced=True)
            torch.cuda.synchronize()
        busy_ms, kernel_ms = device_busy_ms(prof, DeviceType)
        estimate_ms = sum(row["ms"] * expected_launches[row["name"]] for row in kernel_rows)

        # the Chrome trace, written and read back
        trace_path = trace.write(os.path.join(tmp, "observe_trace.json"))
        with open(trace_path, encoding="utf-8") as f:
            doc = json.load(f)
        begins = [e for e in doc["traceEvents"] if e["ph"] == "B"]
        n_spans = sum(1 for _ in trace.spans())
        if len(begins) != n_spans or {e["pid"] for e in doc["traceEvents"]} != {0}:
            raise AssertionError(f"observe: trace file holds {len(begins)} spans of {n_spans}, "
                                 f"pids {sorted({e['pid'] for e in doc['traceEvents']})}")

        # forensics: deterministic, metric-neutral, saved and loaded back
        repo = FileSystemMetricsRepository(os.path.join(tmp, "metrics.json"))
        key = ResultKey(1, {"phase": "observe"})
        first, first_wall, _c, _s = run(forensics=True)
        second, second_wall, _c, _s = run(forensics=True, repository=repo, key=key)
        for result in (first, second):
            got = metric_values(result)
            if not all(same_bits(got[k], v) for k, v in plain.items()):
                raise AssertionError("observe: a forensics run's metrics differ from the run off")
        report = first.forensics()
        if report.to_dict() != second.forensics().to_dict():
            raise AssertionError("observe: two forensics runs sampled different rows")
        complete = [c for c in report.constraints
                    if c.kind == "completeness" and c.columns == ["x"] and c.status == "FAILURE"]
        if len(complete) != 1 or not complete[0].samples:
            raise AssertionError(f"observe: is_complete('x') gave {complete}")
        sampled = np.array([s.row_index for s in complete[0].samples])
        if not np.isnan(data["x"][sampled]).all():
            raise AssertionError(f"observe: sampled rows {sampled.tolist()} are not null in x")
        loaded = load_audit_trail(repo, key)
        if loaded is None or loaded.to_dict() != second.forensics().to_dict():
            raise AssertionError("observe: the audit trail did not load back")

        # telemetry: the engine record saved, loaded back and rendered
        record = observe.engine_metric_record(trace, traced.plan_cost)
        engine.record_run(repo, trace, traced.plan_cost, suite="chip_smoke",
                          dataset="main_path", data_set_date=2)
        series = engine.engine_series(repo, "engine.rows_per_s")
        if [p.metric_value for p in series] != [record["engine.rows_per_s"]]:
            raise AssertionError(f"observe: engine series {series}")
        text = observe.openmetrics_text(repo.load().get())
        if not text.endswith("# EOF\n") or "deequ_tpu_engine_rows_per_s" not in text:
            raise AssertionError("observe: OpenMetrics text lacks the engine series")

    emit({
        "phase": "observe",
        "rows": rows,
        "card": card,
        "power_limit": power_limit,
        "runs_s": {"untraced": [runs[0][1], runs[2][1]], "traced": [runs[1][1], runs[3][1]]},
        "traced_over_untraced": pairs,
        "launches_per_run": traced_launches,
        "counters": {k: trace.counters.get(k, 0)
                     for k in ("device_passes", "device_launches", "group_passes")},
        "pass_labels": labels,
        "dispatch_signature": observed,
        "cost_drift": drift,
        "phase_seconds": phases,
        "root_span_share_of_wall": trace.duration_s / traced_wall,
        "spans": n_spans,
        "profiled_run": {
            "wall_s": profiled_wall,
            "device_busy_ms": busy_ms,
            "k1_k4_device_ms": kernel_ms,
            "device_idle_share": 1.0 - busy_ms / (profiled_wall * 1e3),
            "k1_k4_launches_times_kernel_line_ms": estimate_ms,
            "phase_seconds": profiled.run_trace.phase_seconds(),
        },
        "forensics": {
            "runs_s": [first_wall, second_wall],
            "constraints": len(report.constraints),
            "falloffs": len(report.falloffs),
            "is_complete_x_samples": sampled.tolist(),
            "violations_seen": complete[0].violations_seen,
        },
        "telemetry": {
            "rows_per_s": record["engine.rows_per_s"],
            "peak_rss_mb": record["engine.peak_rss_mb"],
            "keys": len(record),
        },
        "seconds": time.perf_counter() - phase_t0,
    })
    return traced_launches


def observe_heartbeat(torch, ck, path: str, rows: int, card: str, power_limit: str):
    """A streamed scan of the stream phase's flagship Parquet file (`path`,
    `rows` rows) with the heartbeat on (DEEQU_TPU_HEARTBEAT_S=0.2, a
    JSONL out file): at least one snapshot, completed batches never fall,
    and the last snapshot's batches equal the scan's."""
    import tempfile

    from deequ_tpu_torch import Table
    from deequ_tpu_torch.analyzers import (
        ApproxCountDistinct, Completeness, Maximum, Mean, Minimum, Size, StandardDeviation,
    )
    from deequ_tpu_torch.runners import AnalysisRunner

    analyzers = [Size(), Completeness("x"), Mean("x"), Minimum("x"), Maximum("x"),
                 StandardDeviation("x"), ApproxCountDistinct("id")]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_heartbeat_") as tmp:
        out = os.path.join(tmp, "heartbeat.jsonl")
        with env(DEEQU_TPU_HEARTBEAT_S="0.2", DEEQU_TPU_HEARTBEAT_OUT=out):
            ck.reset_launch_counts()
            start = time.perf_counter()
            ctx = (AnalysisRunner.on_data(Table.scan_parquet(path), device="cuda")
                   .add_analyzers(analyzers).with_tracing(True).run())
            wall = time.perf_counter() - start
        with open(out, encoding="utf-8") as f:
            snaps = [json.loads(line) for line in f if line.strip()]
    batches = [s["batches"] for s in snaps if s.get("name") == "fused_scan"]
    scan_batches = sum(sp.attrs.get("batches", 0) for sp in ctx.run_trace.spans()
                       if sp.name == "fused_scan")
    if not batches or any(b < a for a, b in zip(batches, batches[1:])):
        raise AssertionError(f"heartbeat: snapshot batches {batches}")
    if batches[-1] != scan_batches or not snaps[-1].get("done"):
        raise AssertionError(f"heartbeat: last snapshot {snaps[-1]}, the scan's {scan_batches}")
    if ck.launch_counts()["masked_moments"] != scan_batches:
        raise AssertionError(f"heartbeat: launches {ck.launch_counts()}")
    emit({"phase": "observe_heartbeat", "rows": rows, "card": card, "power_limit": power_limit,
          "run_s": wall, "snapshots": len(snaps), "snapshot_batches": batches,
          "last_snapshot": snaps[-1]})


PLACEMENT_RTOL = 1e-12  # float sums folded on the host and on the card (the CPU tests' bound)
PLACEMENT_INEXACT = ("Mean", "Sum", "StandardDeviation", "Correlation")


def placement_check(rows: int):
    """Phase 4's check without its containment (a string IN list that is
    the same work under every placement) and its grouping analyzers: the
    flagship analyzers, one quantile, a Compliance and a pattern."""
    from deequ_tpu_torch import Check, CheckLevel

    return (
        Check(CheckLevel.ERROR, "placement")
        .has_size(lambda n: n == rows)
        .is_complete("x")  # fails: every 11th x is null
        .has_completeness("x", lambda c: c > 0.9)
        .has_mean("x", lambda v: 2.9 < v < 3.1)
        .has_min("x", lambda v: v < 0)
        .has_max("x", lambda v: v > 6)
        .has_sum("x", lambda v: v > 0)
        .has_standard_deviation("x", lambda v: 1.9 < v < 2.1)
        .has_correlation("x", "y", lambda r: r > 0.5)
        .has_approx_count_distinct("id", lambda v: v > 0.5 * rows)
        .has_approx_quantile("x", 0.5, lambda m: 2.9 < m < 3.1)
        .satisfies("x > 0 OR x IS NULL", "x positive or null", lambda r: r > 0.9)
        .has_pattern("cat", "^(ok|warn)$", lambda r: 0.35 < r < 0.45)
    )


def placement_launches(rows: int, mode: str):
    """Each kernel's launches in one placement-phase run: as on the main
    path under "device"; under "host-discrete" ApproxCountDistinct folds
    on the host, so hll_register_max never launches; under "host-all"
    nothing does."""
    launches = flagship_launches(rows)
    if mode == "host-all":
        return {name: 0 for name in launches}
    if mode == "host-discrete":
        launches["hll_register_max"] = 0
    return launches


def assert_placements_agree(got, want, label: str, exact_quantiles: bool, data=None) -> None:
    """`got` against `want` as the CPU tests hold them: float sums within
    PLACEMENT_RTOL, quantiles bit for bit when both runs cut the same
    batches (else within the sketch's 1% rank error of the column), every
    other value bit for bit."""
    import numpy as np

    if list(got) != list(want):
        raise AssertionError(f"{label}: metrics {list(got)} vs {list(want)}")
    for key, value in want.items():
        if key.startswith(PLACEMENT_INEXACT):
            ok = close(got[key], value, PLACEMENT_RTOL)
        elif key.startswith("ApproxQuantile") and not exact_quantiles:
            column, qs = QUANTILES[key]
            col = np.sort(data[column][~np.isnan(data[column])])
            values = [got[key]] if not isinstance(got[key], dict) else [got[key][repr(q)] for q in qs]
            ok = all(abs(float(np.searchsorted(col, v)) - q * len(col)) <= 0.01 * len(col)
                     for q, v in zip(qs, values))
        else:
            ok = same_bits(got[key], value)
        if not ok:
            raise AssertionError(f"{label} {key}: {got[key]!r} vs {value!r}")


def probe_check(device):
    """The bandwidth probe on `device` with an empty disk cache: it must
    place as "device"; a second call, as a new process would make it,
    must be served from the disk cache with no copy. Returns the link's
    bandwidth and both calls' times."""
    import tempfile

    from deequ_tpu_torch.ops import runtime

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cache_") as cache, \
            env(DEEQU_TPU_CACHE_DIR=cache, DEEQU_TPU_PLACEMENT="auto"):
        runtime._PLACEMENT_CACHE.clear()
        probes = []
        with timed_calls(runtime, "measure_device_bandwidth", {}, probes):
            t0 = time.perf_counter()
            cold_mode = runtime.placement_mode(device)
            cold_s = time.perf_counter() - t0
            bandwidth = runtime._load_bandwidth_from_disk(runtime._platform_key(device))
            runtime._PLACEMENT_CACHE.clear()  # as a new process starts
            t0 = time.perf_counter()
            cached_mode = runtime.placement_mode(device)
            cached_s = time.perf_counter() - t0
    runtime._PLACEMENT_CACHE.clear()
    if cold_mode != "device" or cached_mode != "device":
        raise AssertionError(f"probe: placement {cold_mode!r}, cached {cached_mode!r} "
                             f"at {bandwidth} B/s; the H100 must place as 'device'")
    if len(probes) != 1 or bandwidth is None:
        raise AssertionError(f"probe: {len(probes)} measurements, cached bandwidth {bandwidth}")
    return {
        "bandwidth_gb_per_s": bandwidth / 1e9,
        "placement": cold_mode,
        "cold_s": cold_s,
        "measure_s": probes[0],
        "cached_s": cached_s,
    }


MEMO_ROWS = 1 << 20  # rows of the placement phase's memo profile


def memo_profile_runs(torch, ck, seed: int):
    """A profile of a MEMO_ROWS-row table with a boolean and a string
    column (both with nulls) and a float column, under "device",
    "host-discrete" and "host-all". On the host fold `_LowCardCounts`'
    memos serve ApproxCountDistinct's registers of the boolean and string
    columns (counted at sketch._memo_registers) and their Completeness;
    hll_register_max launches under "device" alone, with the memos as
    without them. Every column's distinct count and completeness equal
    across placements, bit for bit. Returns per placement the K3
    launches, the registers the memos served and the wall time."""
    import numpy as np

    from deequ_tpu_torch import ColumnProfilerRunner, Table
    from deequ_tpu_torch.analyzers import sketch

    rng = np.random.default_rng(seed)
    flag = np.where(rng.random(MEMO_ROWS) < 0.1, None, rng.random(MEMO_ROWS) < 0.3)
    cat = np.array(["ok", "warn", "fail", "skip"], dtype=object)[rng.integers(0, 4, MEMO_ROWS)]
    cat[rng.random(MEMO_ROWS) < 0.05] = None
    table = Table.from_numpy({"flag": flag, "cat": cat, "x": rng.normal(size=MEMO_ROWS)})
    real = sketch._memo_registers
    out, want = {}, None
    for mode in ("device", "host-discrete", "host-all"):
        served = []

        def counting(inputs, column):
            registers = real(inputs, column)
            served.append(registers is not None)
            return registers

        sketch._memo_registers = counting
        try:
            with env(DEEQU_TPU_PLACEMENT=mode):
                ck.reset_launch_counts()
                torch.cuda.synchronize()
                start = time.perf_counter()
                profile = ColumnProfilerRunner.on_data(table, device="cuda").run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - start
        finally:
            sketch._memo_registers = real
        got = {name: (p.approximate_num_distinct_values, p.completeness.hex())
               for name, p in profile.profiles.items()}
        want = got if want is None else want
        k3 = ck.launch_counts()["hll_register_max"]
        memo = served.count(True)
        if got != want or (mode == "device") != (k3 > 0) or (mode == "device") == (memo == 2):
            raise AssertionError(f"memo profile {mode}: {got} vs {want}, K3 {k3}, "
                                 f"memo registers {memo}")
        out[mode] = {"hll_register_max": k3, "memo_registers_served": memo, "wall_s": wall}
    return out


def placement_phase(torch, ck, rows: int, seed: int, card: str, power_limit: str):
    """The bandwidth probe on the card, cold and then served from its disk
    cache with no copy (it must choose "device"); then placement_check()
    over the main path's --rows table under "device", "host-discrete" and
    "host-all", each twice in mirrored order (device, host-discrete,
    host-all, host-all, host-discrete, device): equal metrics
    (`assert_placements_agree`) and verdicts, each placement's two runs
    bit for bit alike, K1-K4 launched as `placement_launches` predicts,
    each run's wall time split into the fused pass, its host fold and its
    device program. Returns each kernel's launches per placement."""
    from deequ_tpu_torch import VerificationSuite
    from deequ_tpu_torch.analyzers import ApproxQuantiles
    from deequ_tpu_torch.data.expr import Predicate
    from deequ_tpu_torch.ops import fused, runtime

    probe = probe_check(runtime.resolve_device("cuda"))
    data, table = flagship_table(rows, seed)
    check = placement_check(rows)
    quantiles_y = ApproxQuantiles("y", [0.1, 0.5, 0.9])
    runs, launches = {}, {}
    # each placement twice, in mirrored order, so none runs only first
    for mode in ("device", "host-discrete", "host-all", "host-all", "host-discrete", "device"):
        split = {}
        with env(DEEQU_TPU_PLACEMENT=mode), runtime.monitored() as stats, \
                contextlib.ExitStack() as stack:
            stack.enter_context(timed_calls(fused.FusedScanPass, "run", split))
            stack.enter_context(timed_calls(fused, "fold_host_batch", split))
            stack.enter_context(timed_calls(fused.FusedProgram, "__call__", split))
            stack.enter_context(timed_calls(fused.PipelinedAggFold, "_fold", split))
            stack.enter_context(timed_calls(Predicate, "eval_mask", split))
            stack.enter_context(timed_calls(Predicate, "eval", split))
            ck.reset_launch_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            result = (VerificationSuite.on_data(table, device="cuda").add_check(check)
                      .add_required_analyzer(quantiles_y).run())
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        counts = ck.launch_counts()
        if counts != placement_launches(rows, mode):
            raise AssertionError(f"placement {mode}: launches {counts}, "
                                 f"expected {placement_launches(rows, mode)}")
        if stats.placements != [mode] or (mode == "host-all") != (stats.device_launches == 0):
            raise AssertionError(f"placement {mode}: passes placed {stats.placements}, "
                                 f"{stats.device_launches} device programs")
        launches[mode] = counts
        run = runs.setdefault(mode, {
            "metrics": metric_values(result),
            "verdicts": verdicts(result),
            "wall_s": [],
            "split_s": [],
            "members_device_host": [stats.device_members, stats.host_members],
            "family_kernels": stats.family_kernels,
            "family_shortcuts": stats.family_shortcuts,
        })
        if not all(same_bits(v, run["metrics"][k]) for k, v in metric_values(result).items()):
            raise AssertionError(f"placement {mode}: its two runs differ")
        run["wall_s"].append(wall)
        run["split_s"].append({
            "fused_pass": split.get("run", 0.0),
            "host_fold": split.get("fold_host_batch", 0.0),
            "device_program": split.get("__call__", 0.0) + split.get("_fold", 0.0),
            "predicates": split.get("eval_mask", 0.0) + split.get("eval", 0.0),
        })
    base = runs["device"]
    for mode in ("host-discrete", "host-all"):
        # host-all folds the in-memory table as one batch (no device copy
        # to bound), so its sketches cut other batches than the device's
        assert_placements_agree(runs[mode]["metrics"], base["metrics"], f"placement {mode}",
                                exact_quantiles=mode != "host-all", data=data)
        if runs[mode]["verdicts"] != base["verdicts"]:
            raise AssertionError(f"placement {mode}: verdicts {runs[mode]['verdicts']} "
                                 f"vs {base['verdicts']}")
    memo_profile = memo_profile_runs(torch, ck, seed)
    emit({
        "phase": "placement",
        "rows": rows,
        "card": card,
        "power_limit": power_limit,
        "probe": probe,
        "memo_profile": {"rows": MEMO_ROWS, "runs": memo_profile},
        "runs": {mode: {k: v for k, v in run.items() if k not in ("metrics", "verdicts")}
                 for mode, run in runs.items()},
        "launches": launches,
    })
    return launches


def basic_example_phase(torch, ck):
    """The README's example on the card, with BASELINE.md's outcome: the
    ERROR check fails on Completeness(name) = 0.8, the WARNING check on
    containsURL(description) = 0.4; size 5, id unique and complete, the
    median of numViews at most 10."""
    import numpy as np

    from deequ_tpu_torch import Check, CheckLevel, CheckStatus, Table, VerificationSuite

    items = [
        (1, "Thingy A", "awesome thing.", "high", 0),
        (2, "Thingy B", "available at http://thingb.com", None, 0),
        (3, None, None, "low", 5),
        (4, "Thingy D", "checkout https://thingd.ca", "low", 10),
        (5, "Thingy E", None, "high", 12),
    ]
    cols = list(zip(*items))
    table = Table.from_numpy({
        "id": np.array(cols[0], dtype=np.int64),
        "name": np.array(cols[1], dtype=object),
        "description": np.array(cols[2], dtype=object),
        "priority": np.array(cols[3], dtype=object),
        "numViews": np.array(cols[4], dtype=np.int64),
    })
    ck.reset_launch_counts()
    result = (
        VerificationSuite()
        .on_data(table)
        .add_check(
            Check(CheckLevel.ERROR, "integrity checks")
            .has_size(lambda size: size == 5)
            .is_complete("id")
            .is_unique("id")
            .is_complete("name")
            .is_contained_in("priority", ["high", "low"])
            .is_non_negative("numViews")
        )
        .add_check(
            Check(CheckLevel.WARNING, "distribution checks")
            .contains_url("description", lambda ratio: ratio >= 0.5)
            .has_approx_quantile("numViews", 0.5, lambda median: median <= 10)
        )
        .run()
    )
    launches = ck.launch_counts()
    failed = {
        repr(cr.constraint): cr.message
        for res in result.check_results.values()
        for cr in res.constraint_results
        if cr.status.value == "Failure"
    }
    want = {
        "CompletenessConstraint(Completeness(name,None))":
            "Value: 0.8 does not meet the constraint requirement!",
        "containsURL(description)": "Value: 0.4 does not meet the constraint requirement!",
    }
    statuses = {c.description: r.status for c, r in result.check_results.items()}
    metrics = metric_values(result)
    if failed != want or result.status != CheckStatus.ERROR:
        raise AssertionError(f"basic example: failed {failed}, status {result.status}")
    if statuses != {"integrity checks": CheckStatus.ERROR, "distribution checks": CheckStatus.WARNING}:
        raise AssertionError(f"basic example: check statuses {statuses}")
    if not (metrics["Size(None)"] == 5 and metrics["Uniqueness(List(id))"] == 1.0
            and metrics["Completeness(id,None)"] == 1.0
            and metrics["ApproxQuantile(numViews,0.5,0.01)"] <= 10):
        raise AssertionError(f"basic example: metrics {metrics}")
    if launches["hist16"] != 1:
        raise AssertionError(f"basic example: launches {launches}")
    emit({"phase": "basic_example", "status": result.status.value, "failed": failed,
          "metrics": metrics, "launches": launches})


LINEITEM_STRINGS = ("l_returnflag", "l_linestatus", "l_shipdate", "l_commitdate",
                    "l_receiptdate", "l_shipinstruct", "l_shipmode", "l_comment")


def lineitem_table(rows: int, seed: int):
    """BASELINE.json config 3's table: TPC-H lineitem, 16 columns, as the
    JAX package's bench.py builds it (`build_lineitem_table`): dates are
    ISO strings (2,352 distinct), l_comment comes from a bounded template
    dictionary (2,048 distinct). The string columns are typed up front."""
    import numpy as np

    from deequ_tpu_torch.data.table import ColumnType, Table

    rng = np.random.default_rng(seed)
    n = rows
    days = np.array(
        [f"199{y}-{m:02d}-{d:02d}" for y in range(2, 9) for m in range(1, 13) for d in range(1, 29)],
        dtype=object,
    )
    instruct = np.array(["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"],
                        dtype=object)
    modes = np.array(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"], dtype=object)
    words = np.array(
        ["carefully", "quickly", "furiously", "slyly", "blithely", "deposits",
         "requests", "packages", "theodolites", "accounts", "instructions",
         "foxes", "pinto beans", "ideas", "dependencies", "platelets"],
        dtype=object,
    )
    comments = np.array([f"{a} {b} {c}" for a in words for b in words for c in words[:8]],
                        dtype=object)
    quantity = rng.integers(1, 51, n)
    price_per_unit = rng.integers(90_000, 110_000, n) / 100.0
    data = {
        "l_orderkey": rng.integers(1, max(n // 4, 2), n),
        "l_partkey": rng.integers(1, 200_001, n),
        "l_suppkey": rng.integers(1, 10_001, n),
        "l_linenumber": rng.integers(1, 8, n),
        "l_quantity": quantity,
        "l_extendedprice": quantity * price_per_unit,
        "l_discount": rng.integers(0, 11, n) / 100.0,
        "l_tax": rng.integers(0, 9, n) / 100.0,
        "l_returnflag": np.array(["A", "N", "R"], dtype=object)[rng.integers(0, 3, n)],
        "l_linestatus": np.array(["O", "F"], dtype=object)[rng.integers(0, 2, n)],
        "l_shipdate": days[rng.integers(0, len(days), n)],
        "l_commitdate": days[rng.integers(0, len(days), n)],
        "l_receiptdate": days[rng.integers(0, len(days), n)],
        "l_shipinstruct": instruct[rng.integers(0, 4, n)],
        "l_shipmode": modes[rng.integers(0, 7, n)],
        "l_comment": comments[rng.integers(0, len(comments), n)],
    }
    types = {name: ColumnType.STRING for name in LINEITEM_STRINGS}
    return data, Table.from_numpy(data, types=types)


INEXACT_PROFILE_KEYS = ("mean", "sum", "stdDev")  # float sums taken in another order


def profile_columns(profiles):
    """{column: its entry of ColumnProfiles.to_json()}."""
    return {entry["column"]: entry for entry in json.loads(profiles.to_json())["columns"]}


def assert_profiles_agree(got, want, label: str) -> None:
    """Every field exact except mean, sum and stdDev (METRIC_RTOL)."""
    got, want = profile_columns(got), profile_columns(want)
    if list(got) != list(want):
        raise AssertionError(f"{label}: columns {list(got)} vs {list(want)}")
    for column, entry in want.items():
        other = got[column]
        if sorted(other) != sorted(entry):
            raise AssertionError(f"{label} {column}: fields {sorted(other)} vs {sorted(entry)}")
        for key, value in entry.items():
            ok = (close(other[key], value, METRIC_RTOL) if key in INEXACT_PROFILE_KEYS
                  else other[key] == value)
            if not ok:
                raise AssertionError(f"{label} {column}.{key}: {other[key]!r} vs {value!r}")


def profile_phase(torch, ck, rows: int, seed: int, card: str, power_limit: str):
    """ColumnProfilerRunner over the lineitem table, twice on CUDA and once
    with device="cpu": the two CUDA runs bit-identical, the CPU run equal
    (mean, sum and stddev within METRIC_RTOL), l_quantity's and
    l_extendedprice's mean, min and max within METRIC_RTOL of numpy, the
    pass counts and K1-K4's launches as the plan predicts. The warm run's
    wall time is split into pass 1, the quantiles' host selection inside
    it, pass 2 and the histogram pass. Returns (the warm run's seconds,
    its launches, the table, the warm run's profiles)."""
    import numpy as np

    from deequ_tpu_torch import ColumnProfilerRunner
    from deequ_tpu_torch.analyzers.sketch import _QuantileAnalyzerBase
    from deequ_tpu_torch.data.table import ColumnType
    from deequ_tpu_torch.ops import runtime
    from deequ_tpu_torch.ops.fused import FusedScanPass
    from deequ_tpu_torch.profiles import column_profiler

    t0 = time.perf_counter()
    data, table = lineitem_table(rows, seed)
    setup_s = time.perf_counter() - t0
    # the plan: one fused pass (no string column looks numeric, and every
    # low-cardinality column is counted inside it); per batch one K1, K2
    # K4 and K6 launch for each numeric column and one K3 launch per column
    batches = -(-rows // BATCH)
    numeric = sum(1 for _name, ctype in table.schema if ctype != ColumnType.STRING)
    columns = len(table.schema)
    expected_launches = {
        "masked_moments": numeric * batches,
        "masked_centered_sumsq": numeric * batches,
        "hll_register_max": columns * batches,
        "hist16": numeric * batches,
        "classify_hash_dictionary": 0,  # an in-memory table has no Arrow dictionary
        "hist16_select": numeric * batches,
    }
    expected_passes = {"device_passes": 1, "group_passes": 0}

    def run(device, split=None):
        with contextlib.ExitStack() as stack:
            if split is not None:
                split["pass_calls"] = []
                stack.enter_context(timed_calls(FusedScanPass, "run", split, split["pass_calls"]))
                stack.enter_context(timed_calls(_QuantileAnalyzerBase, "host_finish_batch", split))
                stack.enter_context(timed_calls(column_profiler, "_compute_histograms", split))
            stats = stack.enter_context(runtime.monitored())
            ck.reset_launch_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            profiles = ColumnProfilerRunner.on_data(table, device=device).run()
            wall = time.perf_counter() - start
        passes = {"device_passes": stats.device_passes, "group_passes": stats.group_passes}
        return profiles, wall, ck.launch_counts(), passes

    split = {}
    runs = [run("cuda"), run("cuda", split)]
    for profiles, _wall, launches, passes in runs:
        if launches != expected_launches:
            raise AssertionError(f"profile: launches {launches}, expected {expected_launches}")
        if passes != expected_passes:
            raise AssertionError(f"profile: passes {passes}, expected {expected_passes}")
    if runs[0][0].to_json() != runs[1][0].to_json():
        raise AssertionError("profile: the two CUDA runs differ")
    cpu_profiles, cpu_wall, cpu_launches, cpu_passes = run("cpu")
    if any(cpu_launches.values()) or cpu_passes != expected_passes:
        raise AssertionError(f"profile: the cpu run launched {cpu_launches}, passes {cpu_passes}")
    assert_profiles_agree(runs[0][0], cpu_profiles, "profile cuda vs cpu")

    profiles = runs[1][0].profiles
    for column in ("l_quantity", "l_extendedprice"):
        values = np.asarray(data[column], dtype=np.float64)
        p = profiles[column]
        for key, got, ref in (("mean", p.mean, values.mean()), ("minimum", p.minimum, values.min()),
                              ("maximum", p.maximum, values.max())):
            if not close(got, float(ref), METRIC_RTOL):
                raise AssertionError(f"profile {column}.{key}: port {got!r} vs numpy {ref!r}")
    kinds = {name: p.data_type for name, p in profiles.items()}
    histograms = sorted(name for name, p in profiles.items() if p.histogram is not None)
    warm = runs[1][1]
    pass_calls = split["pass_calls"]
    emit({
        "phase": "profile",
        "rows": rows,
        "cut": "BASELINE.json config 3 has 100,000,000 rows; cut to this for host memory and the run's time limit",
        "batches": batches,
        "seed": seed,
        "card": card,
        "power_limit": power_limit,
        "table_setup_s": setup_s,
        "first_run_s": runs[0][1],
        "warm_run_s": warm,
        "rows_per_s_warm_run": rows / warm,
        "warm_run_split_s": {
            "pass_1": pass_calls[0],
            "host_finish_batch_in_pass_1": split.get("host_finish_batch", 0.0),
            "pass_2": sum(pass_calls[1:]),
            "histogram_pass": split.get("_compute_histograms", 0.0),
        },
        "cpu_run_s": cpu_wall,
        "passes": runs[1][3],
        "launches_per_run": runs[1][2],
        "expected_launches": expected_launches,
        "data_types": kinds,
        "histograms": histograms,
        "approx_distinct": {name: p.approximate_num_distinct_values for name, p in profiles.items()},
    })
    return warm, runs[1][2], table, runs[1][0]


EXAMPLE_PROFILE = {
    # the raw data of examples/data_profiling_example.py, profiled by hand
    "name": {"dataType": "String", "completeness": 1.0, "approximateNumDistinctValues": 5},
    "count": {"dataType": "Fractional", "isDataTypeInferred": "true", "completeness": 0.75,
              "minimum": 1.0, "maximum": 20.0, "mean": 11.0, "sum": 66.0},
    "status": {"dataType": "String", "completeness": 1.0,
               "histogram": {"IN_TRANSIT": 2, "DELAYED": 4, "UNKNOWN": 2}},
    "valuable": {"dataType": "Boolean", "isDataTypeInferred": "true", "completeness": 0.625},
}


def profile_example_phase(torch, ck):
    """examples/data_profiling_example.py's raw data profiled on the card:
    equal to the device="cpu" run, with the values of EXAMPLE_PROFILE."""
    import numpy as np

    from deequ_tpu_torch import ColumnProfilerRunner, Table

    table = Table.from_numpy({
        "name": np.array(["thingA", "thingA", "thingB", "thingC", "thingD", "thingC",
                          "thingC", "thingE"], dtype=object),
        "count": np.array(["13.0", "5", None, None, "1.0", "7.0", "20", "20"], dtype=object),
        "status": np.array(["IN_TRANSIT", "DELAYED", "DELAYED", "IN_TRANSIT", "DELAYED",
                            "UNKNOWN", "UNKNOWN", "DELAYED"], dtype=object),
        "valuable": np.array(["true", "false", None, "false", "true", None, None, "false"],
                             dtype=object),
    })
    ck.reset_launch_counts()
    gpu = ColumnProfilerRunner.on_data(table).run()
    launches = ck.launch_counts()
    cpu = ColumnProfilerRunner.on_data(table, device="cpu").run()
    if gpu.to_json() != cpu.to_json():
        raise AssertionError("profile_example: cuda and cpu profiles differ")
    got = profile_columns(gpu)
    for column, fields in EXAMPLE_PROFILE.items():
        for key, want in fields.items():
            value = got[column].get(key)
            if key == "histogram":
                value = {entry["value"]: entry["count"] for entry in value or []}
            if value != want:
                raise AssertionError(f"profile_example {column}.{key}: {value!r}, expected {want!r}")
    if launches["hll_register_max"] != len(EXAMPLE_PROFILE):
        raise AssertionError(f"profile_example: launches {launches}")
    emit({"phase": "profile_example", "launches": launches, "columns": got})


def suggest_phase(torch, ck, table, warm_profile_s: float):
    """ConstraintSuggestionRunner with Rules.DEFAULT and a test-set ratio
    of 0.1 (seed 0) on the lineitem table, or on its first 4,194,304 rows
    when the profile's warm run took over 60 s: the suggestions (column,
    rule, code) and their verdicts on the test set equal a device="cpu"
    run."""
    from deequ_tpu_torch import ConstraintSuggestionRunner, Rules

    rows = table.num_rows if warm_profile_s <= 60.0 else min(table.num_rows, BATCH)
    data = table if rows == table.num_rows else table.slice(0, rows)

    def run(device):
        start = time.perf_counter()
        result = (
            ConstraintSuggestionRunner.on_data(data, device=device)
            .add_constraint_rules(Rules.DEFAULT)
            .use_train_test_split_with_test_set_ratio(0.1, seed=0)
            .run()
        )
        suggestions = [(s.column_name, repr(s.suggesting_rule), s.code_for_constraint)
                       for s in result.all_suggestions()]
        verdicts = [(cr.status.value, cr.message)
                    for res in result.verification_result.check_results.values()
                    for cr in res.constraint_results]
        return suggestions, verdicts, time.perf_counter() - start

    ck.reset_launch_counts()
    gpu = run("cuda")
    launches = ck.launch_counts()
    cpu = run("cpu")
    if gpu[:2] != cpu[:2]:
        raise AssertionError(f"suggest: cuda {gpu[:2]} vs cpu {cpu[:2]}")
    if not gpu[0] or len(gpu[1]) != len(gpu[0]) or not all(launches[k] for k in KERNEL_SYMBOLS):
        raise AssertionError(f"suggest: {len(gpu[0])} suggestions, {len(gpu[1])} verdicts, "
                             f"launches {launches}")
    emit({"phase": "suggest", "rows": rows,
          "table": "the whole lineitem table" if rows == table.num_rows
          else "its first 4,194,304 rows (the profile's warm run took over 60 s)",
          "cuda_run_s": gpu[2], "cpu_run_s": cpu[2], "launches": launches,
          "suggestions": gpu[0], "verdicts": [status for status, _msg in gpu[1]]})


@contextlib.contextmanager
def library_off():
    """The C host library off for the block (DEEQU_TPU_NO_NATIVE), on
    again after it."""
    from deequ_tpu_torch.ops import native

    native.reset()
    try:
        with env(DEEQU_TPU_NO_NATIVE="1"):
            yield
    finally:
        native.reset()


def median_s(fn, reps: int = 5) -> float:
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        fn()
        times.append(time.perf_counter() - start)
    return statistics.median(times)


def native_phase(torch, seed: int, card: str, power_limit: str):
    """The C host library on the card's host: its build from the
    checkout's sources, the codecs its reader can load there, and each C
    route of the main path (HLL codes, the three dictionary-code bincount
    sites) equal to its numpy route bit for bit on the main path's
    columns, one batch of them, with the two routes' times."""
    import numpy as np

    from deequ_tpu_torch.analyzers import Histogram
    from deequ_tpu_torch.ops import fused, native
    from deequ_tpu_torch.ops.sketches import hll
    from deequ_tpu_torch.profiles.column_profiler import _compute_histograms
    from deequ_tpu_torch.profiles.internal_analyzers import _LowCardCounts

    start = time.perf_counter()
    library = native.build()
    build_s = time.perf_counter() - start
    if not native.available():
        raise AssertionError("native: the C library is off")
    codecs = native.reader_codecs()
    data, table = flagship_table(BATCH, seed)

    def routes(fn):
        on = fn()
        with library_off():
            off = fn()
        return on, off

    codes_equal = {}
    for name in ("x", "y", "id"):
        col = table.column(name)
        on, off = routes(lambda col=col: hll.pack_codes(col.values, col.valid))
        if on.tobytes() != off.tobytes():
            raise AssertionError(f"native: xxhash64_pack codes of {name} differ from numpy")
        codes_equal[name] = int(np.count_nonzero(on))

    def histogram_site():
        state = Histogram("cat")._state_of_batch(table)
        return dict(zip(state.key_columns[0].tolist(), state.counts.tolist())), state.num_rows

    def profiler_site():
        return {k: (v.absolute, v.ratio) for k, v in
                _compute_histograms(table, ["cat"], table.num_rows)["cat"].values.items()}

    def low_card_site():
        (res,) = fused.FusedScanPass([_LowCardCounts("cat", 256)], device="cuda").run(table)
        state = res.state_or_raise()
        return state.counts, state.null_count

    bincounts = {}
    for label, site in (("histogram", histogram_site), ("column_profiler", profiler_site),
                        ("low_card_counts", low_card_site)):
        on, off = routes(site)
        if on != off:
            raise AssertionError(f"native: the {label} bincount differs from numpy: {on} vs {off}")
        bincounts[label] = "equal"

    canon = hll.canonical_int64(table.column("x").values)
    valid = np.asarray(table.column("x").valid)
    codes, _uniques = table.column("cat").dict_encode()

    def numpy_pack():
        idx, rank = hll.registers_from_hashes(hll.xxhash64_u64(canon[valid]))
        packed = np.zeros(len(canon), dtype=np.int32)
        packed[valid] = (idx << 6) | rank
        return packed

    times = {
        "xxhash64_pack_s": median_s(lambda: native.xxhash64_pack(canon, valid)),
        "xxhash64_pack_numpy_s": median_s(numpy_pack),
        "bincount_s": median_s(lambda: native.bincount(codes, len(_uniques) + 1, base=1)),
        "bincount_numpy_s": median_s(
            lambda: np.bincount(codes + 1, minlength=len(_uniques) + 1)),
    }
    emit({
        "phase": "native",
        "card": card,
        "power_limit": power_limit,
        "library": os.path.relpath(library),
        "build_s": build_s,
        "reader_codecs": {name: bool(codecs & bit) for name, bit in native.READER_CODEC_MASK.items()},
        "rows": BATCH,
        "xxhash64_pack_equal_numpy_nonzero_codes": codes_equal,
        "bincount_sites_equal_numpy": bincounts,
        "one_column_times": times,
    })
    return codecs


@contextlib.contextmanager
def read_columns(native_reader, seen):
    """Add to `seen` the column of every chunk the C reader decodes."""
    original = native_reader.decode_chunk

    def wrapper(raw, meta):
        seen.add(meta.column)
        return original(raw, meta)

    native_reader.decode_chunk = wrapper
    try:
        yield seen
    finally:
        native_reader.decode_chunk = original


@contextlib.contextmanager
def timed_iteration(module, name, totals):
    """Replace module.<name>, a function returning an iterator, with one
    whose iterators add the time each `next()` takes to totals[name]:
    the time the caller waits for its next item."""
    original = getattr(module, name)

    def timed(*args, **kwargs):
        it = original(*args, **kwargs)
        try:
            while True:
                start = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                finally:
                    totals[name] = totals.get(name, 0.0) + time.perf_counter() - start
                yield item
        finally:
            it.close()

    setattr(module, name, timed)
    try:
        yield totals
    finally:
        setattr(module, name, original)


@contextlib.contextmanager
def env(**values):
    old = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, value in old.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


PRUNE_GROUP_ROWS = 1 << 20  # row groups of the clustered lineitem file: 10 groups


@contextlib.contextmanager
def packed_bytes(seen):
    """Append to `seen` each `fused.pack_batch_inputs` call's (sum of the
    `nbytes` of the buffers it returns, its layout), as timed_calls wraps
    a function."""
    from deequ_tpu_torch.ops import fused

    original = fused.pack_batch_inputs

    def wrapper(*args, **kwargs):
        buffers, layout = original(*args, **kwargs)
        seen.append((sum(b.numel() * b.element_size() for b in buffers.values()), layout))
        return buffers, layout

    fused.pack_batch_inputs = wrapper
    try:
        yield seen
    finally:
        fused.pack_batch_inputs = original


def explained_against_run(label: str, explained, stats, seen, exact_wire: bool):
    """EXPLAIN's prediction against the run it predicts: passes, group
    passes, device launches, batches and skipped row groups must be
    equal; the first batch's wire bytes equal the sum of `nbytes` of the
    buffers pack_batch_inputs returned, less one bit row (padded / 8
    bytes) for each mask the prediction ships that the run found all-true
    on that batch and sent as a constant. `exact_wire` requires no such
    mask. -> the comparison, for the phase's line."""
    cost = explained.cost
    scan = cost.scan_pass
    observed = {
        "device_passes": stats.device_passes,
        "device_launches": stats.device_launches,
        "group_passes": stats.group_passes,
    }
    if cost.counters != observed:
        raise AssertionError(f"{label}: EXPLAIN predicted {cost.counters}, the run {observed}")
    if scan.n_batches != len(seen):
        raise AssertionError(f"{label}: EXPLAIN predicted {scan.n_batches} batches, "
                             f"the run packed {len(seen)}")
    if (scan.rg_skipped or 0) != stats.rg_skipped:
        raise AssertionError(f"{label}: EXPLAIN predicted {scan.rg_skipped} row groups "
                             f"skipped, the run skipped {stats.rg_skipped}")
    nbytes, layout = seen[0]
    constant = [key for key in scan.wire_bit_keys if key in set(layout[1])]
    if exact_wire and constant:
        raise AssertionError(f"{label}: masks {constant} went as constants")
    predicted = scan.wire_bytes_per_batch
    if predicted is None or predicted - len(constant) * (layout[2] // 8) != nbytes:
        raise AssertionError(f"{label}: EXPLAIN predicted {predicted} first-batch wire bytes "
                             f"({len(constant)} masks sent as constants), the run packed {nbytes}")
    return {
        "counters": observed,
        "batches": len(seen),
        "rg_skipped": stats.rg_skipped,
        "first_batch_wire_bytes_predicted": predicted,
        "first_batch_wire_bytes_packed": nbytes,
        "masks_sent_as_constants": constant,
    }


def prune_members(where: str, double_where=None, quantile_column: str = "l_quantity"):
    """The "new orders" check's members: each carries `where`; with
    `double_where` one more member whose where has a DOUBLE atom."""
    from deequ_tpu_torch.analyzers import (
        ApproxCountDistinct, ApproxQuantile, Completeness, Maximum, Mean, Minimum, Size,
        StandardDeviation, Sum,
    )

    members = [
        Size(where=where),
        Completeness("l_comment", where=where),
        Mean("l_extendedprice", where=where),
        Sum("l_extendedprice", where=where),
        Minimum("l_extendedprice", where=where),
        Maximum("l_extendedprice", where=where),
        StandardDeviation("l_extendedprice", where=where),
        ApproxCountDistinct("l_partkey", where=where),
        ApproxQuantile(quantile_column, 0.5, where=where),
    ]
    if double_where is not None:
        members.append(Size(where=double_where))
    return members


def prune_phase(torch, ck, lineitem, card: str, power_limit: str):
    """Row-group pruning on the card: the lineitem table stably sorted by
    l_orderkey (dbgen's order) in one zstd file of 10 row groups of
    PRUNE_GROUP_ROWS rows. Run A: every member filtered on l_orderkey >= K
    (K the smallest key of group 7), one more with a DOUBLE atom; run B:
    the members on l_quantity >= 1 (int64, no nulls: proven all-true), the
    quantile on l_extendedprice. Each with DEEQU_TPU_PUSHDOWN on and off:
    the metrics bit for bit alike; A skips exactly the groups whose
    pyarrow statistics put their largest key below K, as EXPLAIN predicts,
    and launches K1-K4 once per predicted batch, fewer than off; B skips
    nothing, elides one where (never evaluated, l_quantity never decoded)
    and ships the same wire bytes on and off. EXPLAIN's passes, batches,
    launches and first-batch wire bytes equal both runs' exactly. ->
    run A's kernel launches."""
    import tempfile

    import numpy as np
    import pyarrow.parquet as pq

    from deequ_tpu_torch.data.expr import Predicate
    from deequ_tpu_torch.data.table import Table
    from deequ_tpu_torch.lint import explain_plan
    from deequ_tpu_torch.ops import runtime
    from deequ_tpu_torch.runners import analysis_runner
    from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner

    with tempfile.TemporaryDirectory(prefix="chip_smoke_prune_") as tmp:
        path = os.path.join(tmp, "lineitem_by_orderkey.parquet")
        t0 = time.perf_counter()
        arrow = lineitem.to_arrow()
        order = np.argsort(arrow.column("l_orderkey").to_numpy(), kind="stable")
        arrow = arrow.take(order)
        keys = arrow.column("l_orderkey").to_numpy()
        k7 = int(keys[7 * PRUNE_GROUP_ROWS])
        pq.write_table(arrow, path, row_group_size=PRUNE_GROUP_ROWS, compression="zstd")
        del arrow, order, keys
        write_s = time.perf_counter() - t0
        meta = pq.ParquetFile(path).metadata
        key_col = meta.schema.to_arrow_schema().get_field_index("l_orderkey")
        below = sum(
            1 for g in range(meta.num_row_groups)
            if meta.row_group(g).column(key_col).statistics.max < k7
        )

        def run(members, pushdown: str, evaluated=None):
            seen, validate = [], {}
            with contextlib.ExitStack() as stack, env(DEEQU_TPU_PUSHDOWN=pushdown):
                stack.enter_context(packed_bytes(seen))
                stack.enter_context(timed_calls(analysis_runner, "validate_run_plan", validate))
                if evaluated is not None:
                    original = Predicate.eval_mask

                    def counting(self, table):
                        evaluated.append(self.expression)
                        return original(self, table)

                    stack.callback(setattr, Predicate, "eval_mask", original)
                    Predicate.eval_mask = counting
                stats = stack.enter_context(runtime.monitored())
                ck.reset_launch_counts()
                torch.cuda.synchronize()
                start = time.perf_counter()
                ctx = (
                    AnalysisRunner.on_data(Table.scan_parquet(path), device="cuda")
                    .add_analyzers(members)
                    .run()
                )
                torch.cuda.synchronize()
                wall = time.perf_counter() - start
                launches = ck.launch_counts()
                explained = explain_plan(Table.scan_parquet(path), members, device="cuda")
            values = {repr(a): m.value.get() for a, m in ctx.metric_map.items()}
            return {
                "values": values, "stats": stats, "seen": seen, "wall": wall,
                "launches": launches, "explained": explained,
                "validate_s": validate.get("validate_run_plan", 0.0),
            }

        with env(DEEQU_TPU_PLACEMENT="device"):
            where_a = f"l_orderkey >= {k7}"
            members_a = prune_members(where_a, double_where=f"{where_a} and l_discount >= 0.0")
            a_on, a_off = run(members_a, "1"), run(members_a, "0")
            where_b = "l_quantity >= 1"
            members_b = prune_members(where_b, quantile_column="l_extendedprice")
            evaluated_on, evaluated_off = [], []
            b_on = run(members_b, "1", evaluated_on)
            b_off = run(members_b, "0", evaluated_off)

    lines = {}
    for label, on, off in (("A", a_on, a_off), ("B", b_on, b_off)):
        for key, value in on["values"].items():
            if not same_bits(value, off["values"][key]):
                raise AssertionError(f"run {label}: {key} differs with pushdown on and off: "
                                     f"{value!r} vs {off['values'][key]!r}")
        # with pushdown off nothing proves run B's where all-true: the run
        # alone finds its mask all-true and ships it as a constant
        lines[label] = {
            side: explained_against_run(f"run {label} pushdown {side}", r["explained"],
                                        r["stats"], r["seen"], exact_wire=(label, side) != ("B", "off"))
            for side, r in (("on", on), ("off", off))
        }
    # run A: the skip
    stats = a_on["stats"]
    predicted = a_on["explained"].cost.scan_pass.rg_skipped
    if not (stats.rg_skipped == below == predicted) or stats.rg_total != meta.num_row_groups:
        raise AssertionError(f"run A skipped {stats.rg_skipped} of {stats.rg_total} groups; the "
                             f"statistics put {below} below K, EXPLAIN predicted {predicted}")
    double = f"{where_a} and l_discount >= 0.0"
    if double in a_on["explained"].cost.prune.elided_wheres():
        raise AssertionError("run A: the DOUBLE where was elided")
    batches = a_on["explained"].cost.scan_pass.n_batches
    for name, count in a_on["launches"].items():
        if count != batches or not count < a_off["launches"][name]:
            raise AssertionError(f"run A: {name} launched {count} times with pushdown on "
                                 f"({a_off['launches'][name]} off), {batches} batches predicted")
    # run B: the elision
    stats_on, stats_off = b_on["stats"], b_off["stats"]
    if stats_on.rg_skipped or stats_on.wheres_elided != 1 or stats_off.wheres_elided:
        raise AssertionError(f"run B: {stats_on.rg_skipped} groups skipped, "
                             f"{stats_on.wheres_elided} wheres elided on, "
                             f"{stats_off.wheres_elided} off")
    if where_b in evaluated_on or where_b not in evaluated_off:
        raise AssertionError("run B: the elided where was evaluated, or the unelided one not")
    if stats_on.wire_cols_total != stats_off.wire_cols_total - 1:
        raise AssertionError(f"run B decoded {stats_on.wire_cols_total} columns on, "
                             f"{stats_off.wire_cols_total} off")
    if b_on["seen"][0][0] != b_off["seen"][0][0]:
        raise AssertionError("run B: the wire bytes differ on and off")
    emit({
        "phase": "prune",
        "rows": lineitem.num_rows,
        "row_groups": meta.num_row_groups,
        "group_rows": PRUNE_GROUP_ROWS,
        "k": k7,
        "card": card,
        "power_limit": power_limit,
        "write_s": write_s,
        "run_a": {
            "groups_skipped": stats.rg_skipped,
            "groups_below_k_by_pyarrow": below,
            "rows_skipped": stats.rg_rows_skipped,
            "wall_s_on": a_on["wall"], "wall_s_off": a_off["wall"],
            "validate_s_on": a_on["validate_s"], "validate_s_off": a_off["validate_s"],
            "launches_on": a_on["launches"], "launches_off": a_off["launches"],
            "explain": lines["A"],
        },
        "run_b": {
            "wheres_elided": stats_on.wheres_elided,
            "decoded_columns_on": stats_on.wire_cols_total,
            "decoded_columns_off": stats_off.wire_cols_total,
            "wall_s_on": b_on["wall"], "wall_s_off": b_off["wall"],
            "validate_s_on": b_on["validate_s"], "validate_s_off": b_off["validate_s"],
            "first_batch_wire_bytes_on": b_on["seen"][0][0],
            "first_batch_wire_bytes_off": b_off["seen"][0][0],
            "explain": lines["B"],
        },
        "explain_run_a": a_on["explained"].render(),
    })
    return a_on["launches"]


def stream_phase(torch, ck, lineitem, memory_profiles, memory_launches, stream_rows: int,
                 seed: int, card: str, power_limit: str, main_run=None):
    """Streamed Parquet on the card (pyarrow must import): the lineitem
    profile streamed three times, bit for bit alike and equal to phase
    6's in-memory profile with the same launches; then the main path's
    checks streamed over `stream_rows` rows, equal to the in-memory CUDA
    run of the same rows: phase 4's first run (`main_run`, ((rows, seed),
    (result, seconds, launches))) when it ran the same table, else a run
    here. Returns the kernels' launches over the warm
    streamed profile and the streamed verification."""
    import tempfile

    import pyarrow  # noqa: F401 - the stream phase has no fallback

    from deequ_tpu_torch import ColumnProfilerRunner, Table, VerificationSuite
    from deequ_tpu_torch.analyzers import ApproxQuantiles
    from deequ_tpu_torch.analyzers.freq_spill import GroupCountAccumulator
    from deequ_tpu_torch.analyzers.sketch import _QuantileAnalyzerBase
    from deequ_tpu_torch.data import native_reader, source
    from deequ_tpu_torch.data.source import ParquetSource
    from deequ_tpu_torch.ops import fused, runtime
    from deequ_tpu_torch.ops.sketches import hll

    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as tmp:
        import pyarrow.parquet as pq

        lineitem_path = os.path.join(tmp, "lineitem.parquet")
        t0 = time.perf_counter()
        arrow = lineitem.to_arrow()  # written twice: Snappy now, UNCOMPRESSED below
        pq.write_table(arrow, lineitem_path, row_group_size=BATCH)
        lineitem_write_s = time.perf_counter() - t0

        def profile(split=None, path=None, read=None):
            with contextlib.ExitStack() as stack:
                if read is not None:
                    stack.enter_context(read_columns(native_reader, read))
                if split is not None:
                    stack.enter_context(timed_calls(fused.FusedScanPass, "run", split))
                    stack.enter_context(timed_iteration(fused.pipeline, "staged", split))
                    stack.enter_context(timed_iteration(source.DataSource, "batches", split))
                    # thread seconds on the decode and prep threads
                    stack.enter_context(timed_calls(source.Table, "from_arrow", split))
                    stack.enter_context(timed_calls(fused._BatchScan, "prep", split))
                    stack.enter_context(timed_calls(hll, "pack_codes", split))
                    stack.enter_context(timed_calls(ParquetSource, "_fetch_unit", split))
                    stack.enter_context(timed_calls(ParquetSource, "_decode_fetched", split))
                    stack.enter_context(timed_calls(native_reader, "assemble_column", split))
                    stack.enter_context(timed_calls(_QuantileAnalyzerBase, "host_finish_batch", split))
                    stack.enter_context(timed_calls(fused.PipelinedAggFold, "_fold", split))
                    stack.enter_context(timed_calls(torch.cuda.Event, "synchronize", split))
                stats = stack.enter_context(runtime.monitored())
                ck.reset_launch_counts()
                torch.cuda.synchronize()
                start = time.perf_counter()
                result = ColumnProfilerRunner.on_data(
                    Table.scan_parquet(path or lineitem_path), device="cuda").run()
                wall = time.perf_counter() - start
            return result, wall, ck.launch_counts(), stats.device_passes

        split, serial_split = {}, {}
        snappy_read, plain_read = set(), set()
        runs = [profile(), profile(split, read=snappy_read)]
        # the warm profile on one decode worker beside the default's
        # runtime.decode_workers(), in mirrored order (default, one, one,
        # default) so that run order weighs on neither: the same bits and
        # launches, each run's wall and decode threads' seconds
        worker_splits = [split, {}, {}, {}]
        worker_runs = [runs[1]]
        for knob, worker_split in zip(("1", "1", None), worker_splits[1:]):
            with env(**({"DEEQU_TPU_DECODE_WORKERS": knob} if knob else {})):
                worker_runs.append(profile(worker_split))
        # the pyarrow route: no C reader, no C decode
        with env(DEEQU_TPU_NATIVE_READER="0", DEEQU_TPU_DECODE_FASTPATH="0"):
            runs.append(profile())
        # an UNCOMPRESSED copy, which the C reader reads without libsnappy,
        # with the pipeline off: the caller reads, decodes and folds
        plain_path = os.path.join(tmp, "lineitem_plain.parquet")
        t0 = time.perf_counter()
        pq.write_table(arrow, plain_path, row_group_size=BATCH, compression="NONE")
        plain_write_s = time.perf_counter() - t0
        del arrow
        with env(DEEQU_TPU_PIPELINE="0"):
            runs.append(profile(serial_split, path=plain_path, read=plain_read))
        fusion_line = stream_fusion_runs(torch, ck, plain_path, lineitem.num_rows)
        numeric = {name for name, ctype in lineitem.schema if ctype.name in ("LONG", "DOUBLE")}
        if plain_read != numeric:
            raise AssertionError(f"stream profile: the C reader took {sorted(plain_read)} of the "
                                 f"UNCOMPRESSED file, not every numeric column {sorted(numeric)}")
        for result, _wall, launches, passes in runs + worker_runs[1:]:
            if launches != memory_launches or passes != 1:
                raise AssertionError(f"stream profile: launches {launches}, passes {passes}; "
                                     f"in memory {memory_launches}")
            if result.to_json() != runs[0][0].to_json():
                raise AssertionError("stream profile: the streamed runs differ (pipeline on and "
                                     "off, C reader and pyarrow, Snappy and UNCOMPRESSED, "
                                     "default decode workers and one)")
        stall_line = stall_pair(torch, ck, plain_path, lineitem.num_rows)

        def decode_thread_s(times):
            # summed over the threads that ran them; the unit decode is
            # every route's (the C reader's or pyarrow's) and holds the
            # Arrow-to-Table seconds of its batches
            return {"arrow_to_table": times.get("from_arrow", 0.0),
                    "c_reader_fetch": times.get("_fetch_unit", 0.0),
                    "unit_decode": times.get("_decode_fetched", 0.0)}

        sum_differences = compare_stream_profile(runs[1][0], memory_profiles)
        warm = runs[1][1]
        fused_pass = split.get("run", 0.0)
        waits = split.get("staged", 0.0)
        fold = split.get("_fold", 0.0)
        profile_line = {
            "rows": lineitem.num_rows,
            "row_group_size": BATCH,
            "write_s": lineitem_write_s,
            "first_run_s": runs[0][1],
            "warm_run_s": warm,
            "rows_per_s_warm_run": lineitem.num_rows / warm,
            "pyarrow_route_run_s": runs[2][1],
            "uncompressed_file_write_s": plain_write_s,
            "uncompressed_file_serial_run_s": runs[3][1],
            "workers": {
                "order": ["default", "one", "one", "default"],
                "default": {"decode_workers": runtime.decode_workers(),
                            "warm_run_s": [worker_runs[0][1], worker_runs[3][1]],
                            "decode_thread_s": [decode_thread_s(worker_splits[0]),
                                                decode_thread_s(worker_splits[3])]},
                "one": {"decode_workers": 1,
                        "warm_run_s": [worker_runs[1][1], worker_runs[2][1]],
                        "decode_thread_s": [decode_thread_s(worker_splits[1]),
                                            decode_thread_s(worker_splits[2])]},
            },
            "c_reader_columns_snappy_file": sorted(snappy_read),
            "c_reader_columns_uncompressed_file": sorted(plain_read),
            "warm_run_split_s": {
                "fused_pass": fused_pass,
                "consumer_wait_for_batches": waits,
                "fused_pass_host_work": fused_pass - waits - fold,
                "host_finish_batch": split.get("host_finish_batch", 0.0),
                "device_fold": fold - split.get("host_finish_batch", 0.0),
                "device_fold_event_wait": split.get("synchronize", 0.0),
                "decode_thread_s_arrow_to_table": split.get("from_arrow", 0.0),
                "read_ahead_s_c_reader_fetch": split.get("_fetch_unit", 0.0),
                "decode_workers_s_unit_decode": split.get("_decode_fetched", 0.0),
                "decode_thread_s_c_assembly": split.get("assemble_column", 0.0),
                "prep_thread_s": split.get("prep", 0.0),
                "prep_thread_s_hll_codes": split.get("pack_codes", 0.0),
                "prep_thread_wait_for_decode": split.get("batches", 0.0),
            },
            "uncompressed_file_serial_run_split_s": {
                "fused_pass": serial_split.get("run", 0.0),
                "read_and_decode": serial_split.get("batches", 0.0),
                "arrow_to_table": serial_split.get("from_arrow", 0.0),
                "c_reader_fetch": serial_split.get("_fetch_unit", 0.0),
                "unit_decode": serial_split.get("_decode_fetched", 0.0),
                "c_assembly": serial_split.get("assemble_column", 0.0),
                "prep": serial_split.get("prep", 0.0),
                "hll_codes": serial_split.get("pack_codes", 0.0),
                "host_finish_batch": serial_split.get("host_finish_batch", 0.0),
            },
            "launches": runs[1][2],
            "sums_within_1e-12_not_bits": sum_differences,
        }
        profile_launches = runs[1][2]
        os.unlink(lineitem_path)

        data, table = flagship_table(stream_rows, seed)
        path = os.path.join(tmp, "flagship.parquet")
        t0 = time.perf_counter()
        table.to_parquet(path, row_group_size=1 << 18)
        flagship_write_s = time.perf_counter() - t0
        del data
        check = flagship_check(stream_rows)
        quantiles_y = ApproxQuantiles("y", [0.1, 0.5, 0.9])

        def verify(data_or_source):
            ck.reset_launch_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            result = (VerificationSuite.on_data(data_or_source, device="cuda")
                      .add_check(check).add_required_analyzer(quantiles_y).run())
            return result, time.perf_counter() - start, ck.launch_counts()

        if main_run is not None and main_run[0] == (stream_rows, seed):
            (memory, memory_s, memory_counts), memory_from = main_run[1], "main_path first run"
        else:
            (memory, memory_s, memory_counts), memory_from = verify(table), "stream phase"
        del table
        batch_rows = [b.num_rows for b in Table.scan_parquet(path).batches(BATCH)]
        adds = []
        with timed_calls(GroupCountAccumulator, "add", {}, adds):
            streamed, streamed_s, streamed_counts = verify(Table.scan_parquet(path))
        if streamed_counts != memory_counts or streamed_counts != flagship_launches(stream_rows):
            raise AssertionError(f"stream verify: launches {streamed_counts} vs {memory_counts}")
        if not adds:
            raise AssertionError("stream verify: no grouping analyzer went through "
                                 "GroupCountAccumulator")
        got, want = metric_values(streamed), metric_values(memory)
        if list(got) != list(want):
            raise AssertionError(f"stream verify: metrics {list(got)} vs {list(want)}")
        for key, value in want.items():
            if not same_bits(got[key], value):
                raise AssertionError(f"stream verify {key}: {got[key]!r} vs in memory {value!r}")
        if verdicts(streamed) != verdicts(memory) or streamed.status != memory.status:
            raise AssertionError(f"stream verify: verdicts {verdicts(streamed)} vs {verdicts(memory)}")
        if ParquetSource(path).num_rows != stream_rows:
            raise AssertionError("stream verify: the file lost rows")
        observe_heartbeat(torch, ck, path, stream_rows, card, power_limit)

        emit({
            "phase": "stream",
            "card": card,
            "power_limit": power_limit,
            "pipeline_depth": runtime.pipeline_depth(),
            "profile": profile_line,
            "stall_pair": stall_line,
            "fusion": fusion_line,
            "verify": {
                "rows": stream_rows,
                "row_group_size": 1 << 18,
                "batch_rows": batch_rows,
                "write_s": flagship_write_s,
                "in_memory_run_s": memory_s,
                "in_memory_run": memory_from,
                "streamed_run_s": streamed_s,
                "rows_per_s_streamed": stream_rows / streamed_s,
                "group_accumulator_adds": len(adds),
                "launches": streamed_counts,
                "status": streamed.status.value,
            },
        })
        chaos_launches_ = chaos_phase(torch, ck, plain_path, lineitem.num_rows, seed, card,
                                      power_limit)
    return ({name: profile_launches[name] + streamed_counts[name] for name in profile_launches},
            chaos_launches_)


WIRE_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
ENCFOLD_COLUMNS = ("l_linenumber", "l_quantity", "l_discount", "l_tax")


def stream_fusion_runs(torch, ck, path: str, rows: int):
    """Two streamed runs over the UNCOMPRESSED lineitem copy, each with its
    switch on and off. (a) Decode-to-wire: a verification whose numeric
    columns only merge members read (Completeness, Mean, Sum, Minimum,
    Maximum, StandardDeviation and two Correlations on WIRE_COLUMNS): the
    planner fuses all four, and the runs with DEEQU_TPU_WIRE_FUSED on and
    off are bit for bit alike with equal launches. (b) The encoded fold
    under "host-all": an AnalysisRunner with Completeness, Mean, Sum,
    Minimum, Maximum, StandardDeviation, ApproxCountDistinct and
    ApproxQuantile on ENCFOLD_COLUMNS, DEEQU_TPU_ENCODED_FOLD on and off
    bit for bit alike (no launch), and equal to the device-placed run as
    the CPU tests hold them (sums within PLACEMENT_RTOL, the rest bit for
    bit; a quantile that differs must stay within its 1% rank error of
    the device's)."""
    from deequ_tpu_torch import Check, CheckLevel, Table, VerificationSuite
    from deequ_tpu_torch.analyzers import (
        ApproxCountDistinct, ApproxQuantile, Completeness, Maximum, Mean, Minimum,
        StandardDeviation, Sum,
    )
    from deequ_tpu_torch.ops import runtime
    from deequ_tpu_torch.runners import AnalysisRunner

    check = Check(CheckLevel.ERROR, "wire")
    for c in WIRE_COLUMNS:
        check = (check.is_complete(c).has_mean(c, lambda v: v > 0).has_sum(c, lambda v: v > 0)
                 .has_min(c, lambda v: v >= 0).has_max(c, lambda v: v > 0)
                 .has_standard_deviation(c, lambda v: v > 0))
    check = (check.has_correlation("l_quantity", "l_extendedprice", lambda r: r > 0.5)
             .has_correlation("l_discount", "l_tax", lambda r: abs(r) < 0.1))

    def run(fn):
        with runtime.monitored() as stats:
            ck.reset_launch_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        return result, wall, ck.launch_counts(), stats

    wire = {}
    for switch in ("1", "0"):
        with env(DEEQU_TPU_WIRE_FUSED=switch):
            wire[switch] = run(lambda: VerificationSuite.on_data(
                Table.scan_parquet(path), device="cuda").add_check(check).run())
    fused_cols = sorted(wire["1"][3].wire_fused)
    if fused_cols != sorted(WIRE_COLUMNS) or wire["0"][3].wire_fused:
        raise AssertionError(f"wire fusion: fused {fused_cols} with the switch on, "
                             f"{wire['0'][3].wire_fused} off")
    if wire["1"][2] != wire["0"][2] or not wire["1"][2]["masked_moments"]:
        raise AssertionError(f"wire fusion: launches {wire['1'][2]} on, {wire['0'][2]} off")
    got, want = metric_values(wire["1"][0]), metric_values(wire["0"][0])
    for key, value in want.items():
        if not same_bits(got[key], value):
            raise AssertionError(f"wire fusion {key}: {got[key]!r} on vs {value!r} off")

    analyzers = []
    for c in ENCFOLD_COLUMNS:
        analyzers += [Completeness(c), Mean(c), Sum(c), Minimum(c), Maximum(c),
                      StandardDeviation(c), ApproxCountDistinct(c), ApproxQuantile(c, 0.5)]

    def analyze():
        context = AnalysisRunner.on_data(Table.scan_parquet(path), device="cuda") \
            .add_analyzers(analyzers).run()
        return types.SimpleNamespace(metrics=context.metric_map)

    enc = {}
    for switch in ("1", "0"):
        with env(DEEQU_TPU_PLACEMENT="host-all", DEEQU_TPU_ENCODED_FOLD=switch):
            enc[switch] = run(analyze)
    with env(DEEQU_TPU_PLACEMENT="device"):
        on_card = run(analyze)
    stats_on = enc["1"][3]
    if sorted(stats_on.encfold_planned) != sorted(ENCFOLD_COLUMNS) or not stats_on.encfold_chunks:
        raise AssertionError(f"encoded fold: planned {stats_on.encfold_planned}, "
                             f"{stats_on.encfold_chunks} chunks, falloffs "
                             f"{stats_on.encfold_falloffs}")
    if any(any(counts.values()) for _r, _w, counts, _s in enc.values()):
        raise AssertionError("encoded fold: a host-all run launched a kernel")
    got, want = metric_values(enc["1"][0]), metric_values(enc["0"][0])
    for key, value in want.items():
        if not same_bits(got[key], value):
            raise AssertionError(f"encoded fold {key}: {got[key]!r} on vs {value!r} off")
    card = metric_values(on_card[0])
    quantile_bits = True
    for key, value in card.items():
        if key.startswith(PLACEMENT_INEXACT):
            ok = close(got[key], value, PLACEMENT_RTOL)
        elif key.startswith("ApproxQuantile") and not same_bits(got[key], value):
            # the host sample is the device's: a difference would be a
            # fault of the order of zeros, held to the declared rank error
            quantile_bits = False
            ok = abs(got[key] - value) <= 0.01 * max(abs(value), 1.0)
        else:
            ok = same_bits(got[key], value)
        if not ok:
            raise AssertionError(f"encoded fold {key}: host-all {got[key]!r} vs device {value!r}")
    return {
        "rows": rows,
        "wire": {
            "columns_fused": fused_cols,
            "falloffs": wire["1"][3].wire_falloffs,
            "on_s": wire["1"][1],
            "off_s": wire["0"][1],
            "launches": wire["1"][2],
        },
        "encoded_fold": {
            "placement": "host-all",
            "columns_folded": sorted(stats_on.encfold_planned),
            "falloffs": stats_on.encfold_falloffs,
            "chunks": stats_on.encfold_chunks,
            "chunks_fallback": stats_on.encfold_chunks_fallback,
            "runs": stats_on.encfold_runs,
            "values": stats_on.encfold_values,
            "codes_folded": stats_on.encfold_codes_folded,
            "family_kernels_on_off": [stats_on.family_kernels, enc["0"][3].family_kernels],
            "on_s": enc["1"][1],
            "off_s": enc["0"][1],
            "device_placed_s": on_card[1],
            "device_placed_launches": on_card[2],
            "quantiles_bit_equal_to_device": quantile_bits,
        },
    }


def compare_stream_profile(streamed, memory):
    """The streamed profile against the in-memory one: every field exact,
    histograms as {value: count}; mean, sum and stddev bit for bit, or
    else within 1e-12 relative, and each such one is returned."""
    got, want = profile_columns(streamed), profile_columns(memory)
    if list(got) != list(want):
        raise AssertionError(f"stream profile: columns {list(got)} vs {list(want)}")
    differences = []
    for column, entry in want.items():
        other = got[column]
        if sorted(other) != sorted(entry):
            raise AssertionError(f"stream profile {column}: fields {sorted(other)} vs {sorted(entry)}")
        for key, value in entry.items():
            mine = other[key]
            if key == "histogram":
                mine = {h["value"]: (h["count"], h["ratio"]) for h in mine}
                value = {h["value"]: (h["count"], h["ratio"]) for h in value}
            if key in INEXACT_PROFILE_KEYS and not same_bits(mine, value):
                if not close(mine, value, 1e-12):
                    raise AssertionError(f"stream profile {column}.{key}: {mine!r} vs {value!r}")
                differences.append([column, key, mine, value])
            elif key not in INEXACT_PROFILE_KEYS and mine != value:
                raise AssertionError(f"stream profile {column}.{key}: {mine!r} vs {value!r}")
    return differences


def write_daily_partition(directory: str, day: int, rows: int, seed: int,
                          x_shift: float = 0.0) -> str:
    """One day of the flagship table's schema as its own Parquet file
    (pyarrow's default Snappy), its x shifted by `x_shift`."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    data = flagship_data(rows, seed + day)
    data["x"] = data["x"] + x_shift
    path = os.path.join(directory, f"day-{day:03d}.parquet")
    pq.write_table(pa.table(data), path)
    return path


#: the chaos phase's fault specs: the JAX package's chaos matrix
#: (tests/test_suite_differential_fuzz.py, CHAOS_MATRIX)
CHAOS_SPECS = (
    "seed=101,read.pread:0.4:4",
    "seed=102,read.short:0.5:3",
    "seed=103,read.corrupt:0.5:2",
    "seed=104,decode.chunk:0.6:3",
    "seed=105,decode.worker:1.0:1",
    "seed=106,pipeline.stage:1.0:1",
    "seed=107,stall=0.005,pipeline.stall:1.0:2",
    "seed=108,stall=0.005,read.latency:1.0:3",
)
CHAOS_EXHAUST = "seed=109,read.pread:1.0"  # every pread of every attempt fails
CHAOS_RETRY_BASE_MS = "1"  # the first retry's backoff under chaos
WATCHDOG_S = 0.2  # the stall watchdog's window in the watchdog case
WATCHDOG_STALL = "seed=110,stall=0.8,pipeline.stall:1.0:1"  # 4 windows on the first batch
SAVE_FAULT = "seed=111,state.save:1.0:3"  # the first three partition saves fail
CHAOS_DAYS = 12  # daily partitions of the state.save case (the incremental layout)
CHAOS_WORKER_DECODE = "2"  # decode workers of the decode.worker case, as the JAX test takes
STALL_MS = "500"  # the stall pair's modelled latency of one ranged GET round
CHAOS_COUNTERS = ("retry.attempts", "retry.recovered", "retry.exhausted", "fault.observed",
                  "fault.fallback_units")


def chaos_check():
    """The chaos phase's check over the lineitem file: the flagship scan
    analyzers on its numeric columns and one approximate quantile, so
    K1-K4 all launch."""
    from deequ_tpu_torch import Check, CheckLevel

    return (
        Check(CheckLevel.ERROR, "chaos")
        .has_size(lambda n: n > 0)
        .is_complete("l_extendedprice")
        .has_completeness("l_discount", lambda c: c == 1.0)
        .has_mean("l_extendedprice", lambda v: v > 0)
        .has_min("l_quantity", lambda v: v >= 1)
        .has_max("l_quantity", lambda v: v <= 50)
        .has_sum("l_tax", lambda v: v > 0)
        .has_standard_deviation("l_extendedprice", lambda v: v > 0)
        .has_correlation("l_quantity", "l_extendedprice", lambda r: r > 0.5)
        .has_approx_count_distinct("l_orderkey", lambda v: v > 0)
        .has_approx_quantile("l_discount", 0.5, lambda m: 0.0 <= m <= 0.1)
    )


def chaos_launches(rows: int):
    """Each kernel's launches in one chaos_check() run over `rows` rows in
    row groups of BATCH rows: per batch, masked_moments once per moment
    column (l_extendedprice, l_quantity, l_tax), the others once (one
    standard deviation, one HLL, one quantile)."""
    batches = -(-rows // BATCH)
    return {"masked_moments": 3 * batches, "masked_centered_sumsq": batches,
            "hll_register_max": batches, "hist16": batches, "classify_hash_dictionary": 0,
            "hist16_select": batches}


def chaos_counters_expected(spec: str, injected: int, got):
    """Whether a faulted run's retry and fault counters (its trace's
    `retry.*`, `fault.*`) agree with the plan's injections: every read
    fault is seen, and each one retried until its chunk recovers or its
    budget runs out; a corrupt read is seen and not retried; a failed
    stage is redone once; decode refusals and stalls are no IO faults."""
    point = spec.split(",")[-1].split(":")[0]
    if point in ("read.pread", "read.short"):
        # a chunk whose budget (RETRIES, 3) ran out took 3 retries; the
        # rest belong to chunks that recovered, at least one retry each
        attempts, exhausted = got["retry.attempts"], got["retry.exhausted"]
        recovering = attempts - 3 * exhausted
        recovered_ok = (got["retry.recovered"] >= 1) == (recovering > 0) and (
            got["retry.recovered"] <= recovering)
        return (got["fault.observed"] == injected and attempts + exhausted == injected
                and got["fault.fallback_units"] == 0 and recovered_ok)
    if point == "read.corrupt":
        return got == {**dict.fromkeys(CHAOS_COUNTERS, 0), "fault.observed": injected}
    if point in ("pipeline.stage", "decode.worker"):
        # a failed stage item or a dead decode worker: one redo in place
        return got == {"retry.attempts": 1, "retry.recovered": 1, "retry.exhausted": 0,
                       "fault.observed": 1, "fault.fallback_units": 0}
    return got == dict.fromkeys(CHAOS_COUNTERS, 0)


def engine_threads():
    import threading

    return [t.name for t in threading.enumerate() if t.name.startswith("deequ-")]


def wait_no_engine_threads(label: str, timeout_s: float = 5.0) -> None:
    deadline = time.monotonic() + timeout_s
    while engine_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    if engine_threads():
        raise AssertionError(f"{label}: engine threads outlived the run: {engine_threads()}")


def chaos_phase(torch, ck, path: str, rows: int, seed: int, card: str, power_limit: str):
    """Fault containment on the card, over phase 9's UNCOMPRESSED lineitem
    file (the C reader takes its numeric columns): two clean streamed runs
    of chaos_check() (placement "device", pipeline on; the second is the
    baseline), one run per
    CHAOS_SPECS spec and one under CHAOS_EXHAUST, each traced. Every
    faulted run must give the clean run's metrics and verdicts bit for
    bit, with the clean run's K1-K4 launches, its plan must have fired,
    its trace's retry and fault counters must agree with the plan
    (chaos_counters_expected), and no engine thread may outlive it; each
    run's wall time is printed beside the clean run's. Then the stall
    watchdog (DEEQU_TPU_STALL_WATCHDOG_S) with a controller and a stall of
    four windows: the scan raises RunCancelled with DQ404 after one dump
    and the cancel's own, and no thread stays. Then SAVE_FAULT over
    CHAOS_DAYS daily partitions of the incremental layout: the rerun
    scans exactly the three partitions whose saves failed and gives the
    same bits. Returns the clean run's launches."""
    import io
    import tempfile

    from deequ_tpu_torch import Table, VerificationSuite
    from deequ_tpu_torch.core.controller import DQ_STALLED, RunCancelled, RunController
    from deequ_tpu_torch.ops import runtime
    from deequ_tpu_torch.repository import FileSystemStateRepository
    from deequ_tpu_torch.repository.states import plan_signature_for
    from deequ_tpu_torch.runners import AnalysisRunner
    from deequ_tpu_torch.testing import faults

    check = chaos_check()

    def run(spec=None):
        with contextlib.ExitStack() as stack:
            plan = stack.enter_context(faults.install(spec)) if spec else None
            ck.reset_launch_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            result = (VerificationSuite.on_data(Table.scan_parquet(path), device="cuda")
                      .add_check(check).with_tracing(True).run())
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        wait_no_engine_threads(f"chaos {spec or 'clean'}")
        counters = {k: int(result.run_trace.counters.get(k, 0)) for k in CHAOS_COUNTERS}
        return result, wall, ck.launch_counts(), counters, dict(plan.injected) if plan else {}

    runs = {}
    phase_start = time.perf_counter()
    with env(DEEQU_TPU_PLACEMENT="device", DEEQU_TPU_PIPELINE="1",
             DEEQU_TPU_RETRY_BASE_MS=CHAOS_RETRY_BASE_MS):
        # the first run warms what every later run reuses; the second is
        # the clean baseline, and the same bits
        first, first_s, _, _, _ = run()
        clean, clean_s, clean_launches, clean_counters, _ = run()
        assert_same_values(metric_values(clean), metric_values(first), "chaos clean runs")
        if clean_launches != chaos_launches(rows):
            raise AssertionError(f"chaos clean: launches {clean_launches}, "
                                 f"expected {chaos_launches(rows)}")
        if any(clean_counters.values()):
            raise AssertionError(f"chaos clean: retry or fault counters {clean_counters}")
        want, want_verdicts = metric_values(clean), verdicts(clean)
        for spec in CHAOS_SPECS + (CHAOS_EXHAUST,):
            # the decode.worker case kills a worker of a pool of two, as
            # the JAX test does; the clean run's bits hold at any count
            workers = CHAOS_WORKER_DECODE if "decode.worker" in spec else None
            with env(**({"DEEQU_TPU_DECODE_WORKERS": workers} if workers else {})):
                result, wall, launches, counters, injected = run(spec)
            label = f"chaos {spec}"
            if not injected or sum(injected.values()) < 1:
                raise AssertionError(f"{label}: the plan never fired")
            assert_same_values(metric_values(result), want, label)
            if verdicts(result) != want_verdicts or result.status != clean.status:
                raise AssertionError(f"{label}: verdicts differ from the clean run's")
            if launches != clean_launches:
                raise AssertionError(f"{label}: launches {launches} vs clean {clean_launches}")
            n = sum(injected.values())
            agree = chaos_counters_expected(spec, n, counters)
            if spec == CHAOS_EXHAUST:
                agree = (counters["retry.exhausted"] >= 1 and counters["retry.recovered"] == 0
                         and counters["retry.attempts"] == 3 * counters["retry.exhausted"]
                         and counters["fault.observed"] == n == 4 * counters["retry.exhausted"])
            if not agree:
                raise AssertionError(f"{label}: counters {counters} disagree with {injected}")
            runs[spec] = {"wall_s": wall, "clean_wall_s": clean_s, "injected": injected,
                          "counters": counters}
            if workers:
                runs[spec]["decode_workers"] = int(workers)

        # the stall watchdog: a controller, and a stall of four windows
        ctl = RunController()
        dump = io.StringIO()
        analyzers = check.required_analyzers()
        start = time.perf_counter()
        with env(DEEQU_TPU_STALL_WATCHDOG_S=str(WATCHDOG_S)), faults.install(WATCHDOG_STALL) as plan, \
                contextlib.redirect_stderr(dump):
            try:
                AnalysisRunner.do_analysis_run(Table.scan_parquet(path), analyzers, "cuda",
                                               controller=ctl)
            except RunCancelled as e:
                cancelled = e
            else:
                raise AssertionError("chaos watchdog: the stalled scan was not cancelled")
        watchdog_s = time.perf_counter() - start
        wait_no_engine_threads("chaos watchdog")
        dumps = dump.getvalue().count("deequ-watchdog: no batch progress")
        if cancelled.code != DQ_STALLED or dumps != 2 or plan.injected != {"pipeline.stall": 1}:
            raise AssertionError(f"chaos watchdog: code {cancelled.code}, {dumps} dumps, "
                                 f"injected {plan.injected}")

    # state.save over the incremental layout: the rerun scans exactly the
    # partitions whose saves failed
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_") as tmp:
        data_dir = os.path.join(tmp, "daily")
        os.makedirs(data_dir)
        for day in range(CHAOS_DAYS):
            write_daily_partition(data_dir, day, INCREMENTAL_ROWS, seed)
        repo = FileSystemStateRepository(os.path.join(tmp, "states"))
        daily = incremental_check()
        shareable = scan_shareable(daily)

        def fill(spec=None):
            with contextlib.ExitStack() as stack:
                plan = stack.enter_context(faults.install(spec)) if spec else None
                stats = stack.enter_context(runtime.monitored())
                result = (VerificationSuite.on_data(Table.scan_parquet_dataset(data_dir), device="cuda")
                          .add_check(daily).with_state_repository(repo, "daily").run())
            return result, (stats.partitions_cached, stats.partitions_scanned), plan

        first, split, plan = fill(SAVE_FAULT)
        source = Table.scan_parquet_dataset(data_dir)
        signature = plan_signature_for(shareable, source, device="cuda")
        missing = [p.name for p in source.partitions()
                   if not repo.has_states("daily", p.fingerprint, signature)]
        if plan.injected != {"state.save": 3} or split != (0, CHAOS_DAYS) or len(missing) != 3:
            raise AssertionError(f"chaos state.save: injected {plan.injected}, split {split}, "
                                 f"unsaved {missing}")
        rerun, rerun_split, _ = fill()
        if rerun_split != (CHAOS_DAYS - 3, 3) or any(
                not repo.has_states("daily", p.fingerprint, signature) for p in source.partitions()):
            raise AssertionError(f"chaos state.save: the rerun's split {rerun_split}")
        assert_same_values(metric_values(rerun), metric_values(first), "chaos state.save rerun")
        if verdicts(rerun) != verdicts(first):
            raise AssertionError("chaos state.save: the rerun's verdicts differ")

    emit({
        "phase": "chaos",
        "card": card,
        "power_limit": power_limit,
        "rows": rows,
        "row_group_size": BATCH,
        "retry_base_ms": float(CHAOS_RETRY_BASE_MS),
        "phase_s": time.perf_counter() - phase_start,
        "first_clean_run_s": first_s,
        "clean_run_s": clean_s,
        "launches": clean_launches,
        "runs": runs,
        "watchdog": {"window_s": WATCHDOG_S, "spec": WATCHDOG_STALL, "code": cancelled.code,
                     "dumps": dumps, "run_s": watchdog_s},
        "state_save": {"spec": SAVE_FAULT, "partitions": CHAOS_DAYS, "unsaved": missing,
                       "rerun_cached_scanned": list(rerun_split)},
    })
    return clean_launches


def stall_pair(torch, ck, path: str, rows: int):
    """The modelled remote store over the UNCOMPRESSED lineitem copy (the
    C reader's file): chaos_check() streamed and traced on one decode
    worker and on the default runtime.decode_workers(), without a stall
    and then with DEEQU_TPU_SOURCE_STALL_MS=STALL_MS, each stalled pair
    in mirrored order (one, default, default, one). One worker keeps two
    read-ahead slots, the default min(units, workers) of them; each slot
    pays the stall once per unit (a unit of at most READER_INFLIGHT_GETS
    row groups is one round of GETs). Every run gives the
    same bits and the chaos phase's launches, its trace's report folds a
    "read" stage with one read-ahead hit or miss per unit, and no engine
    thread stays. Returns each run's wall time, hits and misses."""
    from deequ_tpu_torch import Table, VerificationSuite, observe
    from deequ_tpu_torch.observe.report import pipeline_occupancy
    from deequ_tpu_torch.ops import runtime

    import pyarrow.parquet as pq

    check = chaos_check()
    row_groups = pq.ParquetFile(path).metadata.num_row_groups
    units = None
    default = runtime.decode_workers()
    out, want = [], None
    plan = [("1", None), (None, None), ("1", STALL_MS), (None, STALL_MS), (None, STALL_MS),
            ("1", STALL_MS)]
    for workers, stall in plan:
        knobs = {"DEEQU_TPU_PLACEMENT": "device", "DEEQU_TPU_PIPELINE": "1"}
        if workers:
            knobs["DEEQU_TPU_DECODE_WORKERS"] = workers
        if stall:
            knobs["DEEQU_TPU_SOURCE_STALL_MS"] = stall
        with env(**knobs):
            ck.reset_launch_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            result = (VerificationSuite.on_data(Table.scan_parquet(path), device="cuda")
                      .add_check(check).with_tracing(True).run())
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        label = f"stall pair (workers {workers or default}, stall {stall or 0} ms)"
        wait_no_engine_threads(label)
        if ck.launch_counts() != chaos_launches(rows):
            raise AssertionError(f"{label}: launches {ck.launch_counts()}")
        values = metric_values(result)
        if want is None:
            want = values
        assert_same_values(values, want, label)
        stages = {row["stage"]: row for row in pipeline_occupancy(result.run_trace.root)}
        spans = observe.span_name_counts(result.run_trace, ["page_read", "page_decode"])
        read = stages.get("read")
        units = spans.get("page_decode", 0) if units is None else units
        if (not units or read is None or read["readahead_hits"] + read["readahead_misses"] != units
                or spans != {"page_read": units, "page_decode": units}):
            raise AssertionError(f"{label}: read stage {read}, spans {spans}, {units} units")
        w = int(workers or default)
        out.append({"decode_workers": w, "fetch_slots": min(units, max(2, w)),
                    "stall_ms": float(stall or 0), "wall_s": wall,
                    "readahead_hits": read["readahead_hits"],
                    "readahead_misses": read["readahead_misses"],
                    "read_stage_busy_s": read["busy_s"]})
    return {"units": units, "row_groups": row_groups, "runs": out}


def scan_shareable(check):
    """The fused pass's analyzers of `check`, in its order (deduped,
    scan-shareable, not grouping): the plan signature hashes them."""
    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
    from deequ_tpu_torch.analyzers.grouping import GroupingAnalyzer

    return [a for a in dict.fromkeys(check.required_analyzers())
            if isinstance(a, ScanShareableAnalyzer) and not isinstance(a, GroupingAnalyzer)]


def context_values(metric_map):
    return {repr(a): m.value.get() for a, m in metric_map.items()}


def assert_same_values(got, want, label: str) -> None:
    if list(got) != list(want):
        raise AssertionError(f"{label}: metrics {list(got)} vs {list(want)}")
    for key, value in want.items():
        if not same_bits(got[key], value):
            raise AssertionError(f"{label} {key}: {got[key]!r} vs {value!r}")


def incremental_phase(torch, ck, days: int, rows: int, seed: int, card: str, power_limit: str):
    """BASELINE.json config 5's scan half on the card: `days` daily
    partitions of `rows` rows, verified with a state repository and a
    metrics repository (pyarrow must import). Steps: a cold fill scans
    every partition; one more day, and the rerun scans that day alone;
    a rescan with the cache off equals it bit for bit; a truncated
    envelope warns DQ314 and rescans its partition alone; a CPU run over
    ten partitions misses the card's entries and agrees with
    `merge_range` of the card's states; the metrics repository gives back
    each run's metrics; the three incremental examples equal their CPU
    runs. Every run's passes and group-by rows are held to
    incremental_passes. Returns the kernels' launches in the append run."""
    import tempfile
    import warnings

    import pyarrow  # noqa: F401 - the incremental phase has no fallback

    from deequ_tpu_torch import Table, VerificationSuite
    from deequ_tpu_torch.analyzers import frequency
    from deequ_tpu_torch.analyzers.state_provider import serialize_state
    from deequ_tpu_torch.ops import fused, runtime
    from deequ_tpu_torch.repository import (
        FileSystemMetricsRepository, FileSystemStateRepository, ResultKey,
    )
    from deequ_tpu_torch.repository.states import StateRepository, merge_states, plan_signature_for

    check = incremental_check()
    shareable = scan_shareable(check)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_incremental_") as tmp:
        data_dir = os.path.join(tmp, "daily")
        os.makedirs(data_dir)
        t0 = time.perf_counter()
        paths = [write_daily_partition(data_dir, day, rows, seed) for day in range(days)]
        write_s = time.perf_counter() - t0
        states_dir = os.path.join(tmp, "states")
        states = FileSystemStateRepository(states_dir)
        metrics_repo = FileSystemMetricsRepository(os.path.join(tmp, "metrics.json"))

        def run(label, key=None, device="cuda", files=None, split=None, expect=None):
            source = Table.scan_parquet_dataset(files if files is not None else data_dir)
            builder = (VerificationSuite.on_data(source, device=device).add_check(check)
                       .with_state_repository(states, "daily"))
            if key is not None:
                builder = builder.use_repository(metrics_repo).save_or_append_result(
                    ResultKey(key, {"dataset": "daily"}))
            read = {}
            with contextlib.ExitStack() as stack:
                stack.enter_context(counted_rows(frequency, "_frequencies_of_batch", read))
                if split is not None:
                    stack.enter_context(timed_calls(StateRepository, "load_states", split))
                    stack.enter_context(timed_calls(StateRepository, "save_states", split))
                    stack.enter_context(timed_calls(fused.FusedScanPass, "_run_single", split))
                stats = stack.enter_context(runtime.monitored())
                ck.reset_launch_counts()
                torch.cuda.synchronize()
                start = time.perf_counter()
                result = builder.run()
                wall = time.perf_counter() - start
            counts = ck.launch_counts()
            got = (stats.partitions_cached, stats.partitions_scanned, stats.partitions_total)
            cached, scanned = expect
            if got != (cached, scanned, cached + scanned):
                raise AssertionError(f"incremental {label}: cached, scanned, total {got}, "
                                     f"expected {(cached, scanned, cached + scanned)}")
            want = (incremental_launches(scanned, rows) if device == "cuda"
                    else dict.fromkeys(counts, 0))
            if counts != want:
                raise AssertionError(f"incremental {label}: launches {counts}, expected {want}")
            passes = {"device_passes": stats.device_passes, "group_passes": stats.group_passes,
                      "group_rows": read.get("_frequencies_of_batch", 0)}
            want = incremental_passes(scanned, source.num_rows)
            if passes != want:
                raise AssertionError(f"incremental {label}: passes {passes}, expected {want}")
            return {"result": result, "values": metric_values(result), "wall_s": wall,
                    "launches": counts, "passes": passes, "split": got}

        cold = run("cold fill", key=1, expect=(0, days))
        daily = daily_runs(torch, ck, paths, shareable, states,
                           FileSystemMetricsRepository(os.path.join(tmp, "anomaly.json")))
        paths.append(write_daily_partition(data_dir, days, rows, seed))
        append_split = {}
        append = run("append", key=2, split=append_split, expect=(days, 1))
        with env(DEEQU_TPU_STATE_CACHE="0"):
            rescan = run("rescan", key=3, expect=(0, days + 1))
        assert_same_values(append["values"], rescan["values"], "incremental append vs rescan")
        if verdicts(append["result"]) != verdicts(rescan["result"]) or (
                append["result"].status != rescan["result"].status):
            raise AssertionError("incremental: the append run's verdicts differ from the rescan's")

        # a truncated envelope: DQ314, and exactly its partition rescans
        source = Table.scan_parquet_dataset(data_dir)
        card_signature = plan_signature_for(shareable, source, device="cuda")
        victim = source.partitions()[days // 2]
        envelope = os.path.join(states_dir, "daily", card_signature, f"{victim.fingerprint}.dqstate")
        envelope_bytes = os.path.getsize(envelope)
        with open(envelope, "r+b") as fh:
            fh.truncate(envelope_bytes // 2)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            corrupt = run("truncated envelope", key=4, expect=(days, 1))
        dq314 = [str(w.message) for w in caught if str(w.message).startswith("DQ314")]
        if len(dq314) != 1 or victim.fingerprint[:12] not in dq314[0]:
            raise AssertionError(f"incremental: DQ314 warnings {dq314}")
        assert_same_values(corrupt["values"], rescan["values"], "incremental corrupt vs rescan")

        # the CPU misses the card's entries: another fold, another signature
        first = paths[:10]
        cpu = run("cpu", device="cpu", files=first, expect=(0, len(first)))
        first_source = Table.scan_parquet_dataset(first)
        fingerprints = [p.fingerprint for p in first_source.partitions()]
        card_sig = plan_signature_for(shareable, first_source, device="cuda")
        cpu_sig = plan_signature_for(shareable, first_source, device="cpu")
        if card_sig == cpu_sig:
            raise AssertionError("incremental: the card's and the CPU's signatures are equal")
        t0 = time.perf_counter()
        ranged = context_values(states.merge_range("daily", fingerprints, shareable, card_sig).metric_map)
        merge_range_s = time.perf_counter() - t0

        def merged(signature):
            out = [None] * len(shareable)
            for fp in fingerprints:
                loaded = states.load_states("daily", fp, signature, shareable)
                out = [merge_states(m, s) for m, s in zip(out, loaded)]
            return out

        inexact = {}
        for analyzer, card_state, cpu_state in zip(shareable, merged(card_sig), merged(cpu_sig)):
            key = repr(analyzer)
            got, want = ranged[key], cpu["values"][key]
            if key.startswith(INCREMENTAL_INEXACT):
                if not close(got, want, METRIC_RTOL):
                    raise AssertionError(f"incremental merge_range {key}: {got!r} vs cpu {want!r}")
                inexact[key] = [got, want]
            elif (serialize_state(analyzer, card_state) != serialize_state(analyzer, cpu_state)
                  or not same_bits(got, want)):
                raise AssertionError(f"incremental merge_range {key}: the card's state differs "
                                     "from the CPU's")

        # the metrics repository gives back what each run returned
        saved = {r.result_key.data_set_date: context_values(r.analyzer_context.metric_map)
                 for r in metrics_repo.load().with_tag_values({"dataset": "daily"}).get()}
        if sorted(saved) != [1, 2, 3, 4]:
            raise AssertionError(f"incremental: saved keys {sorted(saved)}")
        for key, step in zip((1, 2, 3, 4), (cold, append, rescan, corrupt)):
            assert_same_values(saved[key], step["values"], f"incremental repository key {key}")

        shifted = write_daily_partition(tmp, days + 1, rows, seed, x_shift=1.0)
        anomaly = anomaly_days(torch, paths[days], shifted, shareable, daily["repository"])

        examples = incremental_example_flows("cuda")
        if examples != incremental_example_flows("cpu"):
            raise AssertionError("incremental examples: cuda and cpu differ")
        emit({
            "phase": "incremental",
            "card": card,
            "power_limit": power_limit,
            "days": days,
            "rows_per_day": rows,
            "write_s": write_s,
            "cold_fill_s": cold["wall_s"],
            "append_run_s": append["wall_s"],
            "rescan_s": rescan["wall_s"],
            "truncated_envelope_run_s": corrupt["wall_s"],
            "cpu_run_s": cpu["wall_s"],
            "merge_range_s": merge_range_s,
            "append_run_split_s": {
                "load_envelopes": append_split.get("load_states", 0.0),
                "scan_partition": append_split.get("_run_single", 0.0),
                "save_envelope": append_split.get("save_states", 0.0),
            },
            "envelope_bytes": envelope_bytes,
            "launches": {"cold_fill": cold["launches"], "append": append["launches"],
                         "rescan": rescan["launches"], "truncated_envelope": corrupt["launches"]},
            "passes": {"cold_fill": cold["passes"], "append": append["passes"],
                       "rescan": rescan["passes"], "truncated_envelope": corrupt["passes"],
                       "cpu": cpu["passes"]},
            "merge_range_vs_cpu_within_rtol": inexact,
            "status": append["result"].status.value,
            "examples_equal_cpu": sorted(examples),
            "daily_runs": {k: v for k, v in daily.items() if k != "repository"},
            "anomaly": anomaly,
        })
        window_launches, window_answer = windows_phase(
            torch, ck, data_dir, paths, shifted, shareable, states, rows, card, power_limit)
        service_launches = service_phase(torch, ck, data_dir, paths, window_answer, tmp, rows,
                                         card, power_limit)
    return append["launches"], window_launches, service_launches


WINDOW_SEGMENT_FAULT = "seed=112,state.segment:1.0:1"  # the first segment load fails


def windows_phase(torch, ck, data_dir: str, paths, shifted: str, shareable, states, rows: int,
                  card: str, power_limit: str):
    """Window queries and drift checks on the card, over phase 10's daily
    partitions (`paths`: the 100 of the cold fill and the appended day)
    and its FileSystemStateRepository, whose entries the cold fill and
    the append run saved. A WindowQuery over the incremental check's
    scan-shareable analyzers in fill order answers Sliding(7),
    Tumbling(7) and LastN(100), each cold (the segments no earlier query
    built are built from the partitions' states) and warm (segment loads
    alone): the warm query
    reads no row and launches nothing, both equal a card rescan of the
    window's partitions bit for bit, and `window.segments_merged` equals
    the cost model's prediction and EXPLAIN's `windows:` line, with
    cost_drift 0. A DriftCheck of week 14 (days 91-97) against week 13
    passes; day 102 (`shifted`, x + 1.0, no saved state, so the query
    rescans it on the card) against the seven days before fails its mean
    and quantile constraints and no other. A query under
    WINDOW_SEGMENT_FAULT degrades to the partitions' states (DQ323) with
    the same bits. Then examples/drift_example.py, renamed onto the port,
    on the card. Returns the window queries' own launches."""
    import re
    import warnings

    from deequ_tpu_torch import Table
    from deequ_tpu_torch.checks import CheckLevel, DriftCheck
    from deequ_tpu_torch.lint.cost import cost_drift
    from deequ_tpu_torch.lint.explain import render_explain
    from deequ_tpu_torch.ops import runtime
    from deequ_tpu_torch.runners import AnalysisRunner
    from deequ_tpu_torch.testing import faults
    from deequ_tpu_torch.windows import LastN, Sliding, Tumbling, WindowQuery

    source = Table.scan_parquet_dataset(data_dir)
    if [p.path for p in source.partitions()] != list(paths):
        raise AssertionError("windows: the source's partitions are not the incremental phase's")
    phase_start = time.perf_counter()
    query = WindowQuery(source, shareable, repository=states, dataset="daily", device="cuda")
    launches = dict.fromkeys(ck.launch_counts(), 0)

    def timed_query(fn, count=True):
        with runtime.monitored() as stats:
            ck.reset_launch_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        counts = ck.launch_counts()
        for name, n in counts.items():
            launches[name] += n if count else 0
        return out, wall, counts, stats

    windows, answers = {}, {}
    for spec in (Sliding(7), Tumbling(7), LastN(100)):
        label = f"windows {spec!r}"
        steps = {}
        for step in ("cold", "warm"):
            cost = query.admission_cost(spec)
            ctx, wall, counts, stats = timed_query(lambda: query.run(spec, tracing=True))
            plan, counters = ctx.window_plan, ctx.run_trace.counters
            explained = [line for line in render_explain(cost).splitlines()
                         if line.startswith("windows:")]
            merges = re.search(r"-> (\d+) segment merges", explained[0]) if explained else None
            drift = cost_drift(cost, ctx.run_trace)
            if not merges or not (int(merges.group(1)) == cost.window_segments_merged
                                  == counters["window.segments_merged"] == plan.segments_merged):
                raise AssertionError(f"{label} {step}: EXPLAIN {explained}, predicted "
                                     f"{cost.window_segments_merged}, ran {plan.segments_merged}")
            if (drift["drift.window_segments_merged"], drift["drift.window_partitions_rescanned"]) != (0.0, 0.0):
                raise AssertionError(f"{label} {step}: cost drift {drift}")
            if plan.partitions_rescanned or stats.partitions_scanned or any(counts.values()):
                raise AssertionError(f"{label} {step}: rescanned {plan.partitions_rescanned}, "
                                     f"scanned {stats.partitions_scanned}, launches {counts}")
            # a cold query builds the segments no earlier query built
            hits, built = counters.get("window.segment_hits", 0), counters.get("window.segments_built", 0)
            if hits + built != plan.segments_merged or (step == "warm") != (built == 0):
                raise AssertionError(f"{label} {step}: {hits} segment hits and {built} built "
                                     f"of {plan.segments_merged}")
            steps[step] = {"ctx": ctx, "wall_s": wall, "segments_merged": plan.segments_merged,
                           "segment_hits": hits, "segments_built": built,
                           "partitions": len(plan.frame.indices)}
        members = [paths[i] for i in steps["warm"]["ctx"].window_plan.frame.indices]
        # the reference: its launches are not the queries'
        rescan, rescan_s, rescan_counts, _ = timed_query(
            lambda: AnalysisRunner.do_analysis_run(source.subset(members), shareable, "cuda"),
            count=False)
        if rescan_counts != incremental_launches(len(members), rows):
            raise AssertionError(f"{label} rescan: launches {rescan_counts}")
        want = answers[repr(spec)] = context_values(rescan.metric_map)
        for step in ("cold", "warm"):
            assert_same_values(context_values(steps[step]["ctx"].metric_map), want, f"{label} {step}")
        windows[repr(spec)] = {
            **{f"{step}_{k}": v for step in ("cold", "warm") for k, v in steps[step].items()
               if k != "ctx"},
            "rescan_s": rescan_s,
        }

    # a segment that does not load degrades to the partitions' states
    with faults.install(WINDOW_SEGMENT_FAULT) as plan, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        faulted, _, _, _ = timed_query(lambda: query.run(Sliding(7)))
    if plan.injected != {"state.segment": 1} or not any("DQ323" in str(w.message) for w in caught):
        raise AssertionError(f"windows segment fault: injected {plan.injected}")
    assert_same_values(context_values(faulted.metric_map), answers[repr(Sliding(7))],
                       "windows segment fault")

    # drift: week 14 against week 13, then the shifted day against its week
    check = (DriftCheck(CheckLevel.ERROR, "day over week")
             .has_no_quantile_drift("x", max_quantile_shift=0.05)
             .has_no_mean_drift("x", max_relative_delta=0.05)
             .has_no_stddev_drift("x", max_relative_delta=0.05)
             .has_no_completeness_drift("x", max_delta=0.02))
    drifted = WindowQuery(Table.scan_parquet_dataset(list(paths) + [shifted]), shareable,
                          repository=states, dataset="daily", device="cuda")
    timeline = drifted.timeline()

    def evaluate(current, baseline):
        return check.evaluate(current=drifted.states(current), baseline=drifted.states(baseline))

    weeks, weeks_s, weeks_counts, _ = timed_query(
        lambda: evaluate(timeline.frame(91, 98), timeline.frame(84, 91)))
    day, day_s, day_counts, day_stats = timed_query(
        lambda: evaluate(timeline.frame(101, 102), timeline.frame(94, 101)))
    failed = {r.constraint.description.split(" of ")[0] for r in day.constraint_results
              if r.status.name == "FAILURE"}
    if weeks.status.name != "SUCCESS" or any(weeks_counts.values()):
        raise AssertionError(f"windows drift: week 14 vs 13 {weeks.status.name}, "
                             f"launches {weeks_counts}")
    if day.status.name != "ERROR" or failed != {"quantile drift", "mean drift"}:
        raise AssertionError(f"windows drift: the shifted day {day.status.name}, failed {failed}")
    if day_counts != incremental_launches(1, rows) or day_stats.partitions_scanned != 1:
        raise AssertionError(f"windows drift: the shifted day's rescan launched {day_counts}")

    example = drift_example_on_the_card()
    emit({
        "phase": "windows",
        "card": card,
        "power_limit": power_limit,
        "partitions": len(paths),
        "rows_per_partition": rows,
        "phase_s": time.perf_counter() - phase_start,
        "windows": windows,
        "segment_fault": {"spec": WINDOW_SEGMENT_FAULT, "dq323": True},
        "drift": {
            "week14_vs_week13": {"status": weeks.status.name, "s": weeks_s,
                                 "values": {r.constraint.description: r.value
                                            for r in weeks.constraint_results}},
            "day102_vs_week": {"status": day.status.name, "s": day_s, "failed": sorted(failed),
                               "values": {r.constraint.description: r.value
                                          for r in day.constraint_results},
                               "launches": day_counts},
        },
        "drift_example": example,
        "launches": launches,
    })
    return launches, answers[repr(Sliding(7))]


SERVICE_PREEMPT_AFTER = 10  # partitions the heavy run commits before the interactive arrives
# the tier thresholds of the preemption and drain steps: a scan of more
# than 1 MiB is heavy, the 1,000-row interactive probe stays interactive
SERVICE_TIERS = {"DEEQU_TPU_TIER_INTERACTIVE_BYTES": str(1 << 20), "DEEQU_TPU_TIER_HEAVY_BYTES": "1"}


def service_tenants():
    """The service phase's four tenants: incremental_check()'s
    scan-shareable analyzers split into overlapping suites (no group-by:
    is_unique("id") reads the whole source on every run). Together they
    launch K1-K4; every one reads x."""
    from deequ_tpu_torch import Check, CheckLevel

    return {
        "billing": (Check(CheckLevel.ERROR, "billing")
                    .has_size(lambda n: n > 0)
                    .is_complete("x")  # fails: every 11th x is null
                    .has_mean("x", lambda v: 2.9 < v < 3.1)
                    .has_standard_deviation("x", lambda v: 1.9 < v < 2.1)),
        "growth": (Check(CheckLevel.ERROR, "growth")
                   .has_approx_count_distinct("id", lambda v: v > 0)
                   .has_mean("x", lambda v: 2.9 < v < 3.1)),
        "latency": (Check(CheckLevel.ERROR, "latency")
                    .has_approx_quantile("x", 0.5, lambda m: 2.9 < m < 3.1)
                    .has_min("x", lambda v: v < 0)
                    .has_max("x", lambda v: v > 6)),
        "audit": (Check(CheckLevel.ERROR, "audit")
                  .has_correlation("x", "y", lambda r: r > 0.5)
                  .satisfies("x > 0 OR x IS NULL", "x positive or null", lambda r: r > 0.9)
                  .has_sum("x", lambda v: v > 0)
                  .has_pattern("cat", "^(ok|warn)$", lambda r: 0.35 < r < 0.45)),
    }


def heavy_check(tenants):
    """One check with every constraint of the four tenants: the heavy
    run of the preemption and drain steps."""
    from deequ_tpu_torch import Check, CheckLevel

    return Check(CheckLevel.ERROR, "heavy", [c for t in tenants.values() for c in t.constraints])


def state_files(directory: str) -> int:
    return sum(name.endswith(".dqstate") for _, _, names in os.walk(directory) for name in names)


def wait_for(predicate, label: str, timeout_s: float = 120.0, poll_s: float = 0.005) -> None:
    deadline = time.monotonic() + timeout_s
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"{label}: timed out after {timeout_s} s")
        time.sleep(poll_s)


def service_phase(torch, ck, data_dir: str, paths, window_answer, tmp: str, rows: int,
                  card: str, power_limit: str):
    """The data-quality service on the card over phase 10's 101 daily
    partitions (`paths`, in `data_dir`), in six steps (the module
    docstring's phase 10c). Every handle that ends `failed` raises: the
    service contains a worker's failure, the phase does not. Returns the
    shared round's launches (the blocker's taken off)."""
    import threading

    from deequ_tpu_torch import Check, CheckLevel, Table, VerificationSuite
    from deequ_tpu_torch.ops import fused
    from deequ_tpu_torch.repository import FileSystemStateRepository
    from deequ_tpu_torch.repository.states import StateRepository
    from deequ_tpu_torch.service import DQ_DRAINED, DQService
    from deequ_tpu_torch.service import sharing
    from deequ_tpu_torch.windows import Sliding

    tenants = service_tenants()
    source = Table.scan_parquet_dataset(data_dir)
    if [p.path for p in source.partitions()] != list(paths):
        raise AssertionError("service: the source's partitions are not the incremental phase's")
    parts = len(paths)
    union_launches = incremental_launches(parts, rows)

    def factory():
        return Table.scan_parquet_dataset(data_dir)

    def launched(fn):
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - start, ck.launch_counts()

    def ended(handle, label):
        if not handle.wait(600):
            raise AssertionError(f"service {label}: no end after 600 s ({handle.status})")
        if handle.status == "failed":
            raise AssertionError(f"service {label}: failed: {handle.reason}") from handle.error
        if handle.status != "done":
            raise AssertionError(f"service {label}: {handle.status} {handle.code} {handle.reason}")
        return handle

    def same_run(result, want, label):
        # a shared run lists its metrics in the constraints' order, a solo
        # run in its check's analyzer set's
        assert_same_values(dict(sorted(metric_values(result).items())),
                           dict(sorted(want["values"].items())), label)
        if verdicts(result) != want["verdicts"] or result.status != want["status"]:
            raise AssertionError(f"{label}: verdicts differ from the solo run's")

    def scans_and_loads():
        totals, calls = {}, {"scan_partition": [], "load_states": []}
        stack = contextlib.ExitStack()
        stack.enter_context(timed_calls(fused, "scan_partition", totals, calls["scan_partition"]))
        stack.enter_context(timed_calls(StateRepository, "load_states", totals,
                                        calls["load_states"]))
        return stack, calls

    phase_start = time.perf_counter()
    # 1. each tenant alone on the card
    solo = {}
    for name, check in tenants.items():
        result, wall, counts = launched(
            lambda: VerificationSuite.on_data(factory(), device="cuda").add_check(check)
            .with_engine("single").run())
        solo[name] = {"values": metric_values(result), "verdicts": verdicts(result),
                      "status": result.status, "wall_s": wall, "launches": counts}
    solo_launches = {k: sum(t["launches"][k] for t in solo.values()) for k in union_launches}

    # 2. the four as one shared scan behind a blocker that holds the worker
    blocker_table = Table.from_pydict({"k": ["a", "b", "c"]})
    holding, release = threading.Event(), threading.Event()

    def hold(n):
        holding.set()
        return release.wait(120) and n >= 0

    blocker_check = Check(CheckLevel.ERROR, "blocker").has_size(hold)
    release.set()
    _, _, blocker_launches = launched(
        lambda: VerificationSuite.on_data(blocker_table, device="cuda").add_check(blocker_check).run())
    release.clear()
    holding.clear()
    shared_repo = FileSystemStateRepository(os.path.join(tmp, "service_shared"))
    with DQService(workers=1, state_repository=shared_repo) as svc:
        ck.reset_launch_counts()
        blocker = svc.submit("blocker", "other", lambda: blocker_table, checks=[blocker_check])
        wait_for(holding.is_set, "service blocker")
        handles, admission_s = {}, {}
        for t, c in tenants.items():
            start = time.perf_counter()
            handles[t] = svc.submit(t, "ds", factory, checks=[c])  # admission runs here
            admission_s[t] = time.perf_counter() - start
        if [h.status for h in handles.values()] != ["queued"] * len(tenants):
            raise AssertionError(f"service: {[h.status for h in handles.values()]} behind the blocker")
        torch.cuda.synchronize()
        released = time.perf_counter()
        release.set()
        for name, handle in handles.items():
            ended(handle, f"shared {name}")
        torch.cuda.synchronize()
        shared_wall = time.perf_counter() - released
        ended(blocker, "blocker")
        counts = ck.launch_counts()
        round_launches = {k: counts[k] - blocker_launches[k] for k in counts}
        predicted = {t: h.cost.predicted_scan_bytes for t, h in handles.items()}
        charges = {t: svc.ledger.bytes_total(t) for t in tenants}
        telemetry = {k: svc.telemetry.value(k) for k in ("shared_scans", "shared_participants",
                                                         "sharing_declined", "completed")}
        for name, handle in handles.items():
            info = handle.sharing or {}
            if not (info.get("shared") and info["participants"] == len(tenants)
                    and info["proof"]["verdict"] == "CONTAINED"
                    and not any(info["drift"].values())):
                raise AssertionError(f"service shared {name}: sharing {info}")
            same_run(handle.result, solo[name], f"service shared {name}")
    wait_no_engine_threads("service shared round")
    if (telemetry["shared_scans"], telemetry["shared_participants"]) != (1, len(tenants)):
        raise AssertionError(f"service: telemetry {telemetry}")
    # the probe charges at each partition boundary the partitions before
    # it, so the last partition is never charged (the JAX package's
    # accounting): the group pays (P - 1) / P of one union scan
    union_bytes = max(predicted.values())
    if not close(sum(charges.values()), union_bytes * (parts - 1) / parts, 1e-9):
        raise AssertionError(f"service: pro-rata charges {charges} against the union's "
                             f"predicted {union_bytes} bytes")
    if round_launches != union_launches or (
            sum(round_launches.values()) >= sum(solo_launches.values())
            and sum(union_launches.values()) > 0):
        raise AssertionError(f"service: the shared round launched {round_launches}, one run of "
                             f"the union {union_launches}, the solo runs {solo_launches}")

    # 3. solo reruns off the entries the shared scan fanned out
    warm = {}
    with env(DEEQU_TPU_SCAN_SHARING="0"), DQService(workers=1, state_repository=shared_repo) as svc:
        for name, check in tenants.items():
            stack, calls = scans_and_loads()
            with stack:
                handle, wall, counts = launched(
                    lambda: ended(svc.submit(name, "ds", factory, checks=[check]), f"warm {name}"))
            scanned, loaded = len(calls["scan_partition"]), len(calls["load_states"])
            if handle.sharing is not None or (scanned, loaded) != (0, parts) or any(counts.values()):
                raise AssertionError(f"service warm {name}: scanned {scanned}, loaded {loaded}, "
                                     f"launched {counts}, sharing {handle.sharing}")
            same_run(handle.result, solo[name], f"service warm {name}")
            warm[name] = wall
    wait_no_engine_threads("service warm reruns")

    # 4. a heavy run preempted by an interactive one, resumed from its partitions
    heavy = heavy_check(tenants)
    ping_table = Table.from_pydict({"x": [float(i) for i in range(1000)]})
    ping_check = Check(CheckLevel.ERROR, "ping").has_size(lambda n: n == 1000).is_complete("x")
    _, _, ping_launches = launched(
        lambda: VerificationSuite.on_data(ping_table, device="cuda").add_check(ping_check).run())
    preempt_dir = os.path.join(tmp, "service_preempt")
    preempt_repo = FileSystemStateRepository(preempt_dir)
    with env(**SERVICE_TIERS), DQService(workers=1, state_repository=preempt_repo) as svc:
        stack, calls = scans_and_loads()
        with stack:
            ck.reset_launch_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            big = svc.submit("heavy", "ds", factory, checks=[heavy])
            if big.tier != "heavy":
                raise AssertionError(f"service: the heavy run was admitted as {big.tier}")
            wait_for(lambda: state_files(preempt_dir) >= SERVICE_PREEMPT_AFTER or big.done(),
                     "service heavy run's partitions")
            ping_start = time.perf_counter()
            ping = svc.submit("ops", "ping", ping_table, checks=[ping_check])
            ended(ping, "interactive")
            ping_s = time.perf_counter() - ping_start
            ended(big, "heavy")
            torch.cuda.synchronize()
            heavy_wall = time.perf_counter() - start
            counts = ck.launch_counts()
        preempted = svc.telemetry.value("preempted")
    wait_no_engine_threads("service preemption")
    heavy_launches = {k: counts[k] - ping_launches[k] for k in counts}
    scanned, loaded = len(calls["scan_partition"]), len(calls["load_states"])
    cached_on_resume = loaded - parts
    if ping.tier != "interactive" or big.preemptions < 1 or big.attempts < 2 or preempted < 1:
        raise AssertionError(f"service: the heavy run was not preempted (tier {ping.tier}, "
                             f"preemptions {big.preemptions}, attempts {big.attempts})")
    if scanned != parts or cached_on_resume < SERVICE_PREEMPT_AFTER or heavy_launches != union_launches:
        raise AssertionError(f"service heavy: scanned {scanned}, cached on resume "
                             f"{cached_on_resume}, launched {heavy_launches}, one run "
                             f"{union_launches}")
    want = {}
    for t in solo.values():
        want.update(t["values"])
    got = metric_values(big.result)
    assert_same_values(got, {k: want[k] for k in got}, "service heavy against the solo runs")

    # 5. close() with a heavy run in flight and one queued
    drain_dir = os.path.join(tmp, "service_drain")
    with env(**SERVICE_TIERS):
        svc = DQService(workers=1, state_repository=FileSystemStateRepository(drain_dir))
        try:
            running = svc.submit("heavy", "ds", factory, checks=[heavy])
            wait_for(lambda: state_files(drain_dir) >= 1 or running.done(), "service drain's run")
            queued = svc.submit("billing", "ds", factory, checks=[tenants["billing"]])
            queued_status = queued.status
            start = time.perf_counter()
        finally:
            svc.close()
        drain_s = time.perf_counter() - start
    wait_no_engine_threads("service drain")
    if queued_status != "queued" or (queued.status, queued.code) != ("drained", DQ_DRAINED):
        raise AssertionError(f"service drain: the queued run {queued_status} -> {queued.status} "
                             f"{queued.code}")
    if running.status == "failed" or (running.status, running.code) not in (
            ("drained", "DQ407"), ("done", None)):
        raise AssertionError(f"service drain: the running run {running.status} {running.code} "
                             f"{running.reason}")

    # 6. a window over the heavy tenant's partition states
    shareable = sharing.scan_shareable_subset(sharing._solo_order([heavy], []), source)
    with DQService(workers=1, state_repository=preempt_repo) as svc:
        handle, window_s, window_counts = launched(
            lambda: ended(svc.submit_window("heavy", "ds", factory, window=Sliding(7),
                                            analyzers=shareable), "window"))
    wait_no_engine_threads("service window")
    ctx = handle.result
    window_scanned = ctx.run_trace.counters.get("partitions_scanned", 0)
    if ctx.window_plan.partitions_rescanned or window_scanned or any(window_counts.values()):
        raise AssertionError(f"service window: rescanned {ctx.window_plan.partitions_rescanned}, "
                             f"scanned {window_scanned}, launched {window_counts}")
    assert_same_values(context_values(ctx.metric_map),
                       {repr(a): window_answer[repr(a)] for a in shareable},
                       "service window against phase 10b's")

    emit({
        "phase": "service",
        "card": card,
        "power_limit": power_limit,
        "partitions": parts,
        "rows_per_partition": rows,
        "phase_s": time.perf_counter() - phase_start,
        "solo_s": {name: t["wall_s"] for name, t in solo.items()},
        "solo_sum_s": sum(t["wall_s"] for t in solo.values()),
        "solo_max_s": max(t["wall_s"] for t in solo.values()),
        "admission_s": admission_s,
        "shared_round_s": shared_wall,
        "shared_launches": round_launches,
        "solo_launches_sum": solo_launches,
        "blocker_launches": blocker_launches,
        "predicted_scan_bytes": predicted,
        "prorata_charges": charges,
        "warm_rerun_s": warm,
        "preemption": {"attempts": big.attempts, "preemptions": big.preemptions,
                       "wall_s": heavy_wall, "interactive_submit_to_done_s": ping_s, "partitions_cached_on_resume": cached_on_resume,
                       "partitions_scanned": scanned, "launches": heavy_launches},
        "drain": {"running": [running.status, running.code], "queued": [queued.status, queued.code],
                  "close_s": drain_s},
        "window": {"wall_s": window_s, "segments_merged": ctx.window_plan.segments_merged,
                   "analyzers": len(shareable)},
    })
    return round_launches


def drift_example_on_the_card():
    """examples/drift_example.py with its deequ_tpu imports renamed onto
    the port, run on the card (the port's default device): two stable
    weeks pass, and after the skewed day the mean and cardinality
    constraints fail, as in the JAX package's run of the script."""
    import io
    import re

    here = os.path.dirname(os.path.abspath(__file__))
    name = os.path.join(here, "examples", "drift_example.py")
    with open(name, encoding="utf-8") as f:
        source = re.sub(r"\bdeequ_tpu\b(?=[ .])", "deequ_tpu_torch", f.read())
    out = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out):
        exec(compile(source, name, "exec"), {"__name__": "__main__", "__file__": name})
    wall = time.perf_counter() - start
    text = out.getvalue()
    stable, _, skewed = text.partition("week over week after the skewed day landed:")
    failed = sorted({line.split("] ")[1].split(" of ")[0] for line in skewed.splitlines()
                     if line.startswith("\t[FAILURE]")})
    if ("drift status: SUCCESS" not in stable or "[FAILURE]" in stable
            or "drift status: ERROR" not in skewed or failed != ["cardinality drift", "mean drift"]):
        raise AssertionError(f"drift example on the card:\n{text}")
    return {"s": wall, "failed_after_skew": failed}


def daily_runs(torch, ck, paths, shareable, states, repository):
    """One VerificationSuite run a day over the cold-filled partitions,
    with the phase's scan analyzers and no group-by, each saving its
    metrics under ResultKey(day): the partition cache serves every one,
    so none may launch a kernel."""
    from deequ_tpu_torch import Table, VerificationSuite
    from deequ_tpu_torch.ops import runtime
    from deequ_tpu_torch.repository import ResultKey

    start = time.perf_counter()
    for day, path in enumerate(paths, start=1):
        with runtime.monitored() as stats:
            ck.reset_launch_counts()
            (VerificationSuite.on_data(Table.scan_parquet_dataset([path]), device="cuda")
             .add_required_analyzers(shareable).with_state_repository(states, "daily")
             .use_repository(repository)
             .save_or_append_result(ResultKey(day, {"dataset": "daily"})).run())
            torch.cuda.synchronize()
        counts = ck.launch_counts()
        if any(counts.values()) or (stats.partitions_cached, stats.partitions_total) != (1, 1):
            raise AssertionError(f"daily run {day}: launches {counts}, "
                                 f"cached {stats.partitions_cached} of {stats.partitions_total}")
    return {"runs": len(paths), "wall_s": time.perf_counter() - start, "launches": 0,
            "repository": repository}


def anomaly_days(torch, day_101, day_102, shareable, repository):
    """BASELINE.json config 5's anomaly half: day 101 (the appended
    partition) and day 102 (x shifted by +1.0), each verified on the card
    and with device="cpu" against the history of the daily runs, with
    three anomaly checks: OnlineNormalStrategy and Holt-Winters (daily,
    weekly) on Mean("x"), RateOfChangeStrategy (+-0.1) on Size(). The
    card's verdicts equal the CPU's, its fitted Holt-Winters parameters
    are within 1e-6 of the CPU's, and day 102 is flagged on Mean("x") by
    both strategies. The CPU runs save nothing, so each pair sees the same
    history; the card's runs save day 101 and 102."""
    from deequ_tpu_torch import Table, VerificationSuite
    from deequ_tpu_torch.analyzers import Mean, Size
    from deequ_tpu_torch.anomaly import (
        HoltWinters, MetricInterval, OnlineNormalStrategy, RateOfChangeStrategy, SeriesSeasonality,
    )
    from deequ_tpu_torch.repository import ResultKey

    fits = []  # (device, detect's wall time, evaluations, series, interval)

    def run(path, device, key):
        holt = HoltWinters(MetricInterval.DAILY, SeriesSeasonality.WEEKLY, device=device)
        detect = holt.detect

        def timed_detect(series, interval):
            start = time.perf_counter()
            out = detect(series, interval)
            fits.append((device, time.perf_counter() - start, holt.evaluations, series, interval))
            return out

        holt.detect = timed_detect
        builder = (VerificationSuite.on_data(Table.scan_parquet_dataset([path]), device=device)
                   .add_required_analyzers(shareable).use_repository(repository)
                   .add_anomaly_check(OnlineNormalStrategy(), Mean("x"))
                   .add_anomaly_check(holt, Mean("x"))
                   .add_anomaly_check(RateOfChangeStrategy(max_rate_decrease=-0.1,
                                                           max_rate_increase=0.1), Size()))
        if key is not None:
            builder = builder.save_or_append_result(ResultKey(key, {"dataset": "daily"}))
        start = time.perf_counter()
        result = builder.run()
        torch.cuda.synchronize()
        statuses = [r.status.value for r in result.check_results.values()]
        return statuses, holt.params, time.perf_counter() - start

    out = {}
    for day, path in ((101, day_101), (102, day_102)):
        cpu, cpu_params, _ = run(path, "cpu", None)
        card, card_params, card_s = run(path, "cuda", day)
        if card != cpu:
            raise AssertionError(f"anomaly day {day}: card verdicts {card}, cpu {cpu}")
        if float(max(abs(a - b) for a, b in zip(card_params, cpu_params))) > 1e-6:
            raise AssertionError(f"anomaly day {day}: Holt-Winters parameters {card_params} "
                                 f"on the card, {cpu_params} on the CPU")
        out[f"day_{day}"] = {"verdicts": card, "run_s": card_s,
                             "holt_winters_params": [float(v) for v in card_params],
                             "holt_winters_params_cpu": [float(v) for v in cpu_params]}
    if out["day_102"]["verdicts"][:2] != ["Warning", "Warning"]:
        raise AssertionError(f"anomaly: day 102 not flagged on Mean(x): {out['day_102']}")

    # the card's last fit again, under the profiler: its launches
    _device, _s, _evals, series, interval = fits[-1]
    holt = HoltWinters(MetricInterval.DAILY, SeriesSeasonality.WEEKLY, device="cuda")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        holt.detect(series, interval)
        torch.cuda.synchronize()
    events = prof.key_averages()
    out["holt_winters_fit"] = {
        "history_points": len(series) - 1,
        "card_s": [f[1] for f in fits if f[0] == "cuda"],
        "cpu_s": [f[1] for f in fits if f[0] == "cpu"],
        "evaluations": [f[2] for f in fits if f[0] == "cuda"],
        "evaluations_cpu": [f[2] for f in fits if f[0] == "cpu"],
        "launch_calls_per_fit": sum(e.count for e in events if "LaunchKernel" in e.key),
        "device_kernels_per_fit": sum(
            e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
    }
    return out


def incremental_example_flows(device: str):
    """The flows of examples/incremental_metrics_example.py,
    update_metrics_on_partitioned_data_example.py and
    metrics_repository_example.py against the port on `device`, with
    their hand-derived values checked: {flow: what it printed}."""
    import tempfile

    import numpy as np

    from deequ_tpu_torch import AnalysisRunner, Check, CheckLevel, Table, VerificationSuite
    from deequ_tpu_torch.analyzers import ApproxCountDistinct, Completeness, Size
    from deequ_tpu_torch.analyzers.state_provider import InMemoryStateProvider
    from deequ_tpu_torch.repository import FileSystemMetricsRepository, ResultKey

    def items(*rows):
        return Table.from_numpy({
            "id": np.array([r[0] for r in rows], dtype=np.int64),
            "name": np.array([r[1] for r in rows], dtype=object),
            "description": np.array([r[2] for r in rows], dtype=object),
            "priority": np.array([r[3] for r in rows], dtype=object),
            "numViews": np.array([r[4] for r in rows], dtype=np.int64),
        })

    def manufacturers(*rows):
        return Table.from_numpy({
            "id": np.array([r[0] for r in rows], dtype=np.int64),
            "name": np.array([r[1] for r in rows], dtype=object),
            "countryCode": np.array([r[2] for r in rows], dtype=object),
        })

    out = {}
    # examples/incremental_metrics_example.py
    analyzers = [Size(), ApproxCountDistinct("id"), Completeness("name"), Completeness("description")]
    store = InMemoryStateProvider()
    AnalysisRunner.do_analysis_run(
        items((1, "Thingy A", "awesome thing.", "high", 0),
              (2, "Thingy B", "available tomorrow", "low", 0),
              (3, "Thing C", None, None, 5)),
        analyzers, device, save_states_with=store)
    after = AnalysisRunner.do_analysis_run(
        items((4, "Thingy D", None, "low", 10), (5, "Thingy E", None, "high", 12)),
        analyzers, device, aggregate_with=store)
    out["incremental_metrics"] = context_values(after.metric_map)
    if out["incremental_metrics"] != {"Size(None)": 5.0, "ApproxCountDistinct(id,None)": 5.0,
                                      "Completeness(name,None)": 1.0,
                                      "Completeness(description,None)": 0.4}:
        raise AssertionError(f"incremental_metrics example: {out['incremental_metrics']}")

    # examples/update_metrics_on_partitioned_data_example.py
    check = (Check(CheckLevel.WARNING, "a check").is_complete("name")
             .contains_url("name", lambda ratio: ratio == 0.0)
             .is_contained_in("countryCode", ["DE", "US", "CN"])
             .is_unique("id"))  # a frequency state, merged and aggregated on `device`
    analyzers = sorted(check.required_analyzers(), key=repr)
    de = manufacturers((1, "ManufacturerA", "DE"), (2, "ManufacturerB", "DE"))
    us = manufacturers((3, "ManufacturerD", "US"), (4, "ManufacturerE", "US"),
                       (5, "ManufacturerF", "US"))
    cn = manufacturers((6, "ManufacturerG", "CN"), (7, "ManufacturerH", "CN"))
    providers = []
    for part in (de, us, cn):
        providers.append(InMemoryStateProvider())
        AnalysisRunner.do_analysis_run(part, analyzers, device, save_states_with=providers[-1])
    whole = AnalysisRunner.run_on_aggregated_states(de, analyzers, providers, device=device)
    updated_us = InMemoryStateProvider()
    AnalysisRunner.do_analysis_run(
        manufacturers((3, "ManufacturerDNew", "US"), (4, None, "US"),
                      (5, "ManufacturerFNew http://clickme.com", "US")),
        analyzers, device, save_states_with=updated_us)
    updated = AnalysisRunner.run_on_aggregated_states(
        de, analyzers, [providers[0], updated_us, providers[2]], device=device)
    out["partitioned_whole"] = context_values(whole.metric_map)
    out["partitioned_updated"] = context_values(updated.metric_map)
    if (out["partitioned_updated"]["Completeness(name,None)"] != 6 / 7
            or out["partitioned_updated"]["Uniqueness(List(id))"] != 1.0):
        raise AssertionError(f"partitioned example: {out['partitioned_updated']}")

    # examples/metrics_repository_example.py
    with tempfile.TemporaryDirectory(prefix="chip_smoke_repository_") as tmp:
        repository = FileSystemMetricsRepository(os.path.join(tmp, "metrics.json"))
        key = ResultKey(1_700_000_000_000, {"tag": "repositoryExample"})
        VerificationSuite.on_data(items(
            (1, "Thingy A", "awesome thing.", "high", 0),
            (2, "Thingy B", "available at http://thingb.com", None, 0),
            (3, None, None, "low", 5),
            (4, "Thingy D", "checkout https://thingd.ca", "low", 10),
            (5, "Thingy E", None, "high", 12),
        ), device=device).add_check(
            Check(CheckLevel.ERROR, "integrity checks")
            .has_size(lambda size: size == 5).is_complete("id").is_complete("name")
            .is_contained_in("priority", ["high", "low"]).is_non_negative("numViews")
        ).use_repository(repository).save_or_append_result(key).run()
        out["repository_completeness_of_name"] = (
            repository.load_by_key(key).metric(Completeness("name")).value.get())
        out["repository_json"] = repository.load().after(key.data_set_date - 600_000) \
            .get_success_metrics_as_json()
        out["repository_rows"] = (repository.load().with_tag_values({"tag": "repositoryExample"})
                                  .get_success_metrics_as_rows())
    if out["repository_completeness_of_name"] != 0.8:
        raise AssertionError(f"repository example: {out['repository_completeness_of_name']}")
    return out


# -- BASELINE.json config 4: the clickstream, on a mesh and across processes ----

CLICK_USERS = 10 ** 8  # user ids drawn Zipf(1.2) over 10^8 ids
CLICK_PAGES = 10_000  # page ids uniform over 10,000 values
CLICK_QUANTILES = (0.5, 0.9, 0.99)
MESH_ROWS = 1 << 25  # 33,554,432 of config 4's 1B rows (time limit, host memory)
MESH_SHARDS = 8  # config 4's v5e-8, as 8 shards on one card
MESH_PER_DEVICE = 1 << 21  # rows per shard and batch: 2 batches of 8 shards
MESH_CPU_ROWS = 1 << 22  # the device="cpu" mesh's rows
SHARDED_PARTS = 16  # Parquet partitions of the sharded phase
SHARDED_PART_ROWS = 1 << 20  # rows per partition: 16,777,216 in all
SHARDED_PROCS = 2  # worker processes, both on cuda:0
CLICK_INEXACT = ("Mean", "StandardDeviation")  # float sums: 1e-12 against another order
SUM_PARITY_RTOL = 1e-12


def clickstream_data(rows: int, seed: int):
    """Config 4's clickstream: user_id int64 Zipf(1.2) over 10^8 ids,
    latency_ms float64 lognormal(3, 1) with every 13th row null, page_id
    int64 uniform over 10,000 values."""
    import numpy as np

    rng = np.random.default_rng(seed)
    user = rng.zipf(1.2, rows)
    over = np.nonzero(user > CLICK_USERS)[0]
    while over.size:  # a bounded Zipf: draw the tail again
        user[over] = rng.zipf(1.2, over.size)
        over = over[user[over] > CLICK_USERS]
    latency = rng.lognormal(3.0, 1.0, rows)
    latency[::13] = np.nan
    return {"user_id": user - 1, "latency_ms": latency,
            "page_id": rng.integers(0, CLICK_PAGES, rows)}


def clickstream_analyzers():
    """Config 4's analyzers, for the sharded phase and its workers."""
    from deequ_tpu_torch.analyzers import (
        ApproxCountDistinct, ApproxQuantiles, Completeness, CountDistinct, Histogram, Maximum,
        Mean, Minimum, Size, StandardDeviation,
    )

    return [
        Size(), Completeness("latency_ms"), Mean("latency_ms"), StandardDeviation("latency_ms"),
        Minimum("latency_ms"), Maximum("latency_ms"), ApproxCountDistinct("user_id"),
        ApproxQuantiles("latency_ms", CLICK_QUANTILES), CountDistinct(["page_id"]),
        Histogram("page_id"),
    ]


def clickstream_check(rows: int):
    """Config 4's analyzers as a check; ApproxQuantiles and CountDistinct
    join as required analyzers (`clickstream_extra`)."""
    from deequ_tpu_torch import Check, CheckLevel

    return (
        Check(CheckLevel.ERROR, "clickstream")
        .has_size(lambda n: n == rows)
        .is_complete("latency_ms")  # fails: every 13th row is null
        .has_completeness("latency_ms", lambda c: c > 0.9)
        .has_mean("latency_ms", lambda v: 30 < v < 37)  # e^3.5 = 33.1
        .has_standard_deviation("latency_ms", lambda v: 30 < v < 60)  # 43.4
        .has_min("latency_ms", lambda v: v > 0)
        .has_max("latency_ms", lambda v: v > 1000)
        .has_approx_count_distinct("user_id", lambda v: v > 1e5)
        .has_number_of_distinct_values("page_id", lambda b: b == CLICK_PAGES)
    )


def clickstream_extra():
    from deequ_tpu_torch.analyzers import ApproxQuantiles, CountDistinct

    return [ApproxQuantiles("latency_ms", CLICK_QUANTILES), CountDistinct(["page_id"])]


def value_key(value):
    """A metric value as exact JSON: floats as hex, a keyed metric by key,
    a Distribution as its bins and absolute counts."""
    if isinstance(value, float):
        return value.hex()
    if isinstance(value, dict):
        return {k: value_key(v) for k, v in value.items()}
    if hasattr(value, "number_of_bins"):
        return {"bins": value.number_of_bins,
                "values": {k: v.absolute for k, v in value.values.items()}}
    return value


def assert_click_metrics(got, want, label: str, exact_quantiles: bool) -> None:
    """`metric_values` of two runs: counts, extremes, registers'
    estimates, distinct counts and histogram bins exactly; sums within
    SUM_PARITY_RTOL; quantiles exactly or (over other shards) left to
    `assert_click_quantiles`."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: metrics {sorted(got)} vs {sorted(want)}")
    for key, value in want.items():
        if key.startswith(CLICK_INEXACT):
            ok = close(got[key], value, SUM_PARITY_RTOL)
        elif key.startswith("ApproxQuantile") and not exact_quantiles:
            continue
        elif isinstance(value, float):
            ok = same_bits(got[key], value)
        else:
            ok = got[key] == value
        if not ok:
            raise AssertionError(f"{label} {key}: {got[key]!r} vs {value!r}")


def assert_click_quantiles(values, latency, label: str) -> None:
    """Each quantile's rank in the sorted non-null column within 1% of q·n."""
    import numpy as np

    col = np.sort(latency[~np.isnan(latency)])
    for q in CLICK_QUANTILES:
        rank = float(np.searchsorted(col, values[repr(q)]))
        if abs(rank - q * len(col)) > 0.01 * len(col):
            raise AssertionError(f"{label} q={q}: rank {rank} off {q * len(col)} by more than 1%")


def mesh_phase(torch, ck, rows: int, seed: int, card: str, power_limit: str):
    """BASELINE.json config 4 on a mesh: `rows` clickstream rows in memory
    through VerificationSuite over 8 shards of cuda:0 (and over every card
    when there are more), against the single-device pass and a
    device="cpu" mesh. -> the launches of one mesh run."""
    import numpy as np

    from deequ_tpu_torch import VerificationSuite
    from deequ_tpu_torch.analyzers import ApproxCountDistinct
    from deequ_tpu_torch.analyzers.frequency import compute_frequencies
    from deequ_tpu_torch.data.table import Table
    from deequ_tpu_torch.ops import runtime
    from deequ_tpu_torch.ops.fused import FusedScanPass
    from deequ_tpu_torch.parallel import DistributedScanPass, data_mesh

    t0 = time.perf_counter()
    data = clickstream_data(rows, seed)
    table = Table.from_numpy(data)
    setup_s = time.perf_counter() - t0
    card_mesh = data_mesh([torch.device("cuda", 0)] * MESH_SHARDS)

    def run(tbl, n_rows, engine, mesh=None, device=None):
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        with runtime.monitored() as stats:
            result = (
                VerificationSuite.on_data(tbl, device=device)
                .add_check(clickstream_check(n_rows))
                .add_required_analyzers(clickstream_extra())
                .with_engine(engine, mesh)
                .run()
            )
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        if mesh is not None and stats.mesh_passes != 1:
            raise AssertionError(f"{engine} run made {stats.mesh_passes} mesh passes")
        return {"result": result, "wall_s": wall, "launches": ck.launch_counts(),
                "metrics": metric_values(result)}

    # mirrored: the first single run also pays the table's one-time
    # column caches (HLL codes, dictionary encodes); the last is warm
    single = run(table, rows, "single")
    meshes = [run(table, rows, "distributed", card_mesh) for _ in range(2)]
    warm_single = run(table, rows, "single")
    if warm_single["launches"] != single["launches"]:
        raise AssertionError(f"single runs launched {single['launches']}, {warm_single['launches']}")
    assert_click_metrics(warm_single["metrics"], single["metrics"], "single runs", True)
    single_batches = -(-rows // BATCH)
    mesh_programs = MESH_SHARDS * -(-rows // (MESH_SHARDS * MESH_PER_DEVICE))
    for name, count in single["launches"].items():
        per_program = count / single_batches
        if not count or per_program != int(per_program):
            raise AssertionError(f"single run: {name} launched {count} times in {single_batches} batches")
        for m in meshes:
            if m["launches"][name] != per_program * mesh_programs:
                raise AssertionError(f"mesh run: {name} launched {m['launches'][name]} times, "
                                     f"expected {per_program * mesh_programs}")
    for key, value in meshes[0]["metrics"].items():
        if value_key(value) != value_key(meshes[1]["metrics"][key]):
            raise AssertionError(f"{key}: mesh runs differ, {value!r} vs {meshes[1]['metrics'][key]!r}")
    assert_click_metrics(meshes[0]["metrics"], single["metrics"], "mesh vs single", False)
    quantile_key = repr(clickstream_extra()[0])
    for label, r in (("single", single), ("mesh", meshes[0])):
        assert_click_quantiles(r["metrics"][quantile_key], data["latency_ms"], label)
    if verdicts(meshes[0]["result"]) != verdicts(single["result"]):
        raise AssertionError(f"verdicts differ: {verdicts(meshes[0]['result'])} vs {verdicts(single['result'])}")
    failed = [msg for status, msg in verdicts(single["result"]) if status == "Failure"]
    if len(failed) != 1:  # is_complete("latency_ms") only
        raise AssertionError(f"expected one failed constraint, got {failed}")
    acd = [ApproxCountDistinct("user_id")]
    registers = {
        "single": FusedScanPass(acd).run(table)[0].state_or_raise().registers,
        "mesh": DistributedScanPass(acd, mesh=card_mesh).run(table)[0].state_or_raise().registers,
    }
    if not np.array_equal(registers["single"], registers["mesh"]):
        raise AssertionError("HLL registers differ between the mesh and the single pass")
    # the grouping's counts, row-sharded on the card (sharded_bincount),
    # against numpy's
    with runtime.monitored() as stats:
        freqs = compute_frequencies(table, ["page_id"], mesh=card_mesh)
    if stats.device_launches != MESH_SHARDS:
        raise AssertionError(f"the mesh grouping ran {stats.device_launches} bincounts, "
                             f"expected one per shard ({MESH_SHARDS})")
    page_counts = np.zeros(CLICK_PAGES, dtype=np.int64)
    page_counts[freqs.key_columns[0].astype(np.int64)] = freqs.counts
    if not np.array_equal(page_counts, np.bincount(data["page_id"], minlength=CLICK_PAGES)):
        raise AssertionError("the mesh grouping's page_id counts differ from np.bincount")

    # the first MESH_CPU_ROWS rows on the card's mesh and on a CPU mesh
    cut = {k: v[:MESH_CPU_ROWS] for k, v in data.items()}
    cut_table = Table.from_numpy(cut)
    cpu_mesh = data_mesh(["cpu"] * MESH_SHARDS)
    small_card = run(cut_table, MESH_CPU_ROWS, "distributed", card_mesh)
    small_cpu = run(cut_table, MESH_CPU_ROWS, "distributed", cpu_mesh, device="cpu")
    if any(small_cpu["launches"].values()):
        raise AssertionError(f"the CPU mesh launched kernels: {small_cpu['launches']}")
    assert_click_metrics(small_cpu["metrics"], small_card["metrics"], "cpu mesh vs card mesh", True)
    if verdicts(small_cpu["result"]) != verdicts(small_card["result"]):
        raise AssertionError("verdicts differ between the CPU mesh and the card's")
    cpu_regs = DistributedScanPass(acd, mesh=cpu_mesh).run(cut_table)[0].state_or_raise().registers
    card_regs = DistributedScanPass(acd, mesh=card_mesh).run(cut_table)[0].state_or_raise().registers
    if not np.array_equal(cpu_regs, card_regs):
        raise AssertionError("HLL registers differ between the CPU mesh and the card's")

    all_cards = None
    if torch.cuda.device_count() > 1:
        every = data_mesh([torch.device("cuda", i) for i in range(torch.cuda.device_count())])
        r = run(table, rows, "distributed", every)
        assert_click_metrics(r["metrics"], single["metrics"], "all-card mesh vs single", False)
        assert_click_quantiles(r["metrics"][quantile_key], data["latency_ms"], "all-card mesh")
        all_cards = {"cards": every.size, "wall_s": r["wall_s"], "launches": r["launches"]}

    emit({
        "phase": "mesh",
        "rows": rows,
        "shards": MESH_SHARDS,
        "rows_per_shard_and_batch": MESH_PER_DEVICE,
        "batches": mesh_programs // MESH_SHARDS,
        "card": card,
        "power_limit": power_limit,
        "table_setup_s": setup_s,
        "single_runs_s": [single["wall_s"], warm_single["wall_s"]],
        "mesh_runs_s": [m["wall_s"] for m in meshes],
        "mesh_over_warm_single": statistics.mean(m["wall_s"] for m in meshes) / warm_single["wall_s"],
        "launches_single": single["launches"],
        "launches_mesh": meshes[0]["launches"],
        "cpu_mesh_rows": MESH_CPU_ROWS,
        "cpu_mesh_run_s": small_cpu["wall_s"],
        "card_mesh_run_s_same_rows": small_card["wall_s"],
        "all_cards": all_cards,
        "metrics": {k: value_key(v) for k, v in meshes[0]["metrics"].items()},
        "status": meshes[0]["result"].status.value,
    })
    return meshes[0]["launches"]


SHARDED_WORKER = """
import json, os, sys, time

rank, port, _tmp, data_dir, cache_root = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5]
import torch

import chip_smoke
from deequ_tpu_torch import observe
from deequ_tpu_torch.data.source import PartitionedParquetSource
from deequ_tpu_torch.ops import cuda_kernels as ck
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.parallel import multihost
from deequ_tpu_torch.repository.states import FileSystemStateRepository

multihost.initialize(f"127.0.0.1:{port}", chip_smoke.SHARDED_PROCS, rank, backend="gloo",
                     timeout_s=300)
try:
    source = PartitionedParquetSource(data_dir)
    analyzers = chip_smoke.clickstream_analyzers()
    repository = FileSystemStateRepository(os.path.join(cache_root, f"rank{rank}"))
    gather_s = []

    def gather(payload):
        start = time.perf_counter()
        out = multihost.allgather_bytes(payload)
        gather_s.append(time.perf_counter() - start)
        return out

    runs = []
    for i in range(2):  # the second run loads every partition from the repository
        del gather_s[:]
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        # the second run is traced: each worker writes its own trace file,
        # suffixed with its rank (observe.runtrace)
        trace_to = os.path.join(cache_root, "trace.json") if i == 1 else False
        with runtime.monitored() as stats, observe.traced_run(
                "sharded_scan", enable=trace_to) as handle:
            context = multihost.run_sharded_analysis(
                source, analyzers, state_repository=repository, dataset_name="clicks",
                gather=gather)
        torch.cuda.synchronize()
        runs.append({
            "trace_path": handle.trace.path if handle else None,
            "trace_counters": handle.trace.counters if handle else None,
            "wall_s": time.perf_counter() - start,
            "gather_s": sum(gather_s),
            "gathers": len(gather_s),
            "launches": ck.launch_counts(),
            "partitions_cached": stats.partitions_cached,
            "partitions_scanned": stats.partitions_scanned,
            "partitions_local": stats.shard_partitions_local,
            "merge_bytes": stats.shard_merge_bytes,
            "rows_local": stats.shard_rows_local,
            "metrics": {repr(a): chip_smoke.value_key(m.value.get())
                        for a, m in context.metric_map.items()},
        })
finally:
    multihost.shutdown()
print("RESULT:" + json.dumps({"rank": rank, "runs": runs}), flush=True)
"""


def sharded_phase(torch, ck, seed: int, card: str, power_limit: str):
    """BASELINE.json config 4 across processes: the clickstream as
    SHARDED_PARTS zstd Parquet partitions, a solo partitioned run in this
    process, then SHARDED_PROCS worker processes on cuda:0 running
    `run_sharded_analysis` over gloo, each twice (the second served by
    its state repository). -> the workers' launches, summed."""
    import tempfile

    import pyarrow as pa
    import pyarrow.parquet as pq

    from deequ_tpu_torch import observe
    from deequ_tpu_torch.data.source import PartitionedParquetSource
    from deequ_tpu_torch.ops import runtime
    from deequ_tpu_torch.parallel import procspawn
    from deequ_tpu_torch.repository.states import FileSystemStateRepository
    from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner

    with tempfile.TemporaryDirectory() as tmp, env(DEEQU_TPU_PLACEMENT="device"):
        data_dir = os.path.join(tmp, "clicks")
        os.makedirs(data_dir)
        t0 = time.perf_counter()
        data = clickstream_data(SHARDED_PARTS * SHARDED_PART_ROWS, seed + 1)
        for i in range(SHARDED_PARTS):
            part = slice(i * SHARDED_PART_ROWS, (i + 1) * SHARDED_PART_ROWS)
            latency = data["latency_ms"][part]
            pq.write_table(
                pa.table({
                    "user_id": data["user_id"][part],
                    "latency_ms": pa.array(latency, mask=latency != latency),
                    "page_id": data["page_id"][part],
                }),
                os.path.join(data_dir, f"part-{i:03d}.parquet"),
                compression="zstd", row_group_size=SHARDED_PART_ROWS,
            )
        write_s = time.perf_counter() - t0
        source = PartitionedParquetSource(data_dir)
        analyzers = clickstream_analyzers()

        ck.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        with runtime.monitored() as stats:
            solo = AnalysisRunner.do_analysis_run(
                source, analyzers, state_repository=FileSystemStateRepository(
                    os.path.join(tmp, "solo")), dataset_name="clicks")
        torch.cuda.synchronize()
        solo_s = time.perf_counter() - start
        solo_launches = ck.launch_counts()
        if stats.partitions_scanned != SHARDED_PARTS:
            raise AssertionError(f"the solo run scanned {stats.partitions_scanned} partitions")
        want = {repr(a): value_key(m.value.get()) for a, m in solo.metric_map.items()}
        quantiles = solo.metric_map[analyzers[7]].value.get()
        assert_click_quantiles(quantiles, data["latency_ms"], "solo partitioned run")

        start = time.perf_counter()
        results = procspawn.run_worker_processes(
            SHARDED_WORKER, SHARDED_PROCS, [data_dir, os.path.join(tmp, "workers")],
            timeout=600, env={"DEEQU_TPU_PLACEMENT": "device"})
        spawn_s = time.perf_counter() - start
        # the workers' traces of their second runs, merged into one document
        trace_paths = [r["runs"][1]["trace_path"] for r in results]
        merged = observe.merge_chrome_traces(trace_paths)
        merged_pids = sorted({e["pid"] for e in merged["traceEvents"]})
        merged_spans = sorted({e["name"] for e in merged["traceEvents"] if e["ph"] == "B"})
        for r in results:
            counters = r["runs"][1]["trace_counters"]
            if (counters.get("shard.count") != SHARDED_PROCS
                    or counters.get("shard.index", 0) != r["rank"]
                    or not r["runs"][1]["trace_path"].endswith(f"_p{r['rank']}.json")):
                raise AssertionError(f"rank {r['rank']}: trace {r['runs'][1]['trace_path']}, "
                                     f"counters {counters}")
        if merged_pids != list(range(SHARDED_PROCS)) or "shard_allgather" not in merged_spans:
            raise AssertionError(f"merged worker traces: pids {merged_pids}, spans {merged_spans}")

    workers_launches = {name: 0 for name in solo_launches}
    for result in results:
        first, second = result["runs"]
        for run in (first, second):
            if run["metrics"] != want:
                bad = [k for k in want if run["metrics"].get(k) != want[k]]
                raise AssertionError(f"rank {result['rank']} differs from the solo run on {bad}")
        if first["partitions_scanned"] != first["partitions_local"] or first["partitions_cached"]:
            raise AssertionError(f"rank {result['rank']} first run: {first}")
        for name, count in first["launches"].items():
            workers_launches[name] += count
    if sum(r["runs"][1]["partitions_cached"] for r in results) != SHARDED_PARTS:
        raise AssertionError("the second sharded run was not served wholly by the repositories")
    if any(r["runs"][1]["partitions_scanned"] for r in results):
        raise AssertionError("the second sharded run scanned a partition")
    if workers_launches != solo_launches:
        raise AssertionError(f"workers launched {workers_launches}, the solo run {solo_launches}")
    emit({
        "phase": "sharded",
        "partitions": SHARDED_PARTS,
        "rows_per_partition": SHARDED_PART_ROWS,
        "processes": SHARDED_PROCS,
        "card": card,
        "power_limit": power_limit,
        "write_s": write_s,
        "solo_run_s": solo_s,
        "spawn_wall_s": spawn_s,
        "workers": [{
            "rank": r["rank"],
            "partitions": r["runs"][0]["partitions_local"],
            "rows": r["runs"][0]["rows_local"],
            "scan_run_s": r["runs"][0]["wall_s"],
            "gather_s": r["runs"][0]["gather_s"],
            "gathers": r["runs"][0]["gathers"],
            "envelope_bytes_gathered": r["runs"][0]["merge_bytes"],
            "cached_run_s": r["runs"][1]["wall_s"],
            "cached_run_gather_s": r["runs"][1]["gather_s"],
            "launches": r["runs"][0]["launches"],
        } for r in results],
        "launches_solo": solo_launches,
        "launches_sharded": workers_launches,
        "merged_worker_traces": {"pids": merged_pids, "spans": merged_spans,
                                 "events": len(merged["traceEvents"])},
    })
    return workers_launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", type=int, default=2 * BATCH)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--profile-rows", type=int, default=10_000_000)
    parser.add_argument("--stream-rows", type=int, default=2 * BATCH)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device; this script measures the GPU only\n")
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from deequ_tpu_torch.ops import cuda_build
    from deequ_tpu_torch.ops import cuda_kernels as ck
    from deequ_tpu_torch.ops import runtime
    from deequ_tpu_torch.ops.sketches import hll

    smi = nvidia_smi_line()
    card, power_limit = (part.strip() for part in smi.split(",", 1))
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    emit({
        "phase": "device",
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        # whether the streamed-Parquet slice could run on this machine
        "pyarrow_imports": imports("pyarrow"),
        "pandas_imports": imports("pandas"),
        # the streamed source's concurrency as this machine resolves it
        "cpu_count": os.cpu_count(),
        "decode_workers": runtime.decode_workers(),
        "pipeline_depth": runtime.pipeline_depth(),
        "source_stall_s": runtime.source_stall_s(),
    })

    start = time.perf_counter()
    cuda_build.build(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - start,
          "library": os.path.relpath(cuda_build.library_path())})
    native_phase(torch, args.seed, card, power_limit)

    rng = np.random.default_rng(args.seed)
    timer = Timer(torch, device)
    emit({"phase": "timer", "empty_call_ms": timer.ms(lambda: torch.empty(1, device=device))})
    profile = profiler_phase(torch, timer)
    # K3 and K4 first: measured after the moments cases' many batch-sized
    # buffers, hist16's kernel itself ran slower (PERF.md, Findings)
    rest = [hll_phase(torch, ck, hll, device, rng, timer, profile),
            hist16_phase(torch, ck, device, rng, timer, profile)]
    summary = moments_phase(torch, ck, device, rng, timer, profile) + rest
    strings_phase(torch, ck, device, timer, profile, args.seed, card, power_limit)
    select_phase(torch, ck, device, rng, timer, card, power_limit)
    refused_launch_phase(torch, ck, cuda_build, device)
    del timer, profile  # frees the 256 MB L2 flush buffer before the main path
    launches, main_run = main_path_phase(torch, ck, args.rows, args.seed, card, power_limit)
    observe_launches = observe_phase(torch, ck, main_run, card, power_limit, summary)
    main_run = main_run[:2]  # the stream phase reads the first run alone
    placement_launches_by_mode = placement_phase(torch, ck, args.rows, args.seed, card, power_limit)
    basic_example_phase(torch, ck)
    warm_profile_s, profile_launches, lineitem, profiles = profile_phase(
        torch, ck, args.profile_rows, args.seed, card, power_limit)
    profile_example_phase(torch, ck)
    suggest_phase(torch, ck, lineitem, warm_profile_s)
    stream_launches, chaos_launches = stream_phase(
        torch, ck, lineitem, profiles, profile_launches, args.stream_rows, args.seed, card,
        power_limit, main_run)
    prune_launches = prune_phase(torch, ck, lineitem, card, power_limit)
    del lineitem
    append_launches, window_launches, service_launches = incremental_phase(
        torch, ck, INCREMENTAL_DAYS, INCREMENTAL_ROWS, args.seed, card, power_limit)
    mesh_launches = mesh_phase(torch, ck, MESH_ROWS, args.seed, card, power_limit)
    sharded_launches = sharded_phase(torch, ck, args.seed, card, power_limit)
    for row in summary:
        row["launches"] = launches[row["name"]]
        row["launches_profile"] = profile_launches[row["name"]]
        row["launches_stream"] = stream_launches[row["name"]]
        row["launches_incremental"] = append_launches[row["name"]]
        row["launches_placement"] = {
            mode: counts[row["name"]] for mode, counts in placement_launches_by_mode.items()}
        row["launches_mesh"] = mesh_launches[row["name"]]
        row["launches_sharded"] = sharded_launches[row["name"]]
        row["launches_prune"] = prune_launches[row["name"]]
        row["launches_observe"] = observe_launches[row["name"]]
        row["launches_chaos"] = chaos_launches[row["name"]]
        row["launches_windows"] = window_launches[row["name"]]
        row["launches_service"] = service_launches[row["name"]]
        if not (row["launches"] and row["launches_profile"] and row["launches_stream"]
                and row["launches_incremental"] and row["launches_mesh"]
                and row["launches_sharded"] and row["launches_prune"]
                and row["launches_observe"] and row["launches_chaos"]
                and row["launches_windows"] and row["launches_service"]):
            raise AssertionError(f"{row['name']} never launched on the main path, the profile, "
                                 "the streamed path, the incremental path, the mesh, the "
                                 "sharded scan, the pruned scan, the traced run, the chaos "
                                 "runs, the window queries or the service's shared round")
    emit({"kernels": summary})
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
