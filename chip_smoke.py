#!/usr/bin/env python3
"""GPU smoke run of deequ_tpu_torch's verification main path.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py [--rows 16777216] [--seed 7]

Phases, one JSON line each:
  1. device   the card (nvidia-smi name and power limit), torch and CUDA;
  2. build    nvcc builds deequ_tpu_torch/csrc/ for sm_90a;
  3. kernel   each CUDA kernel against its plain PyTorch version on the
              card, at n = 0, 1, a ragged n and the main path's batch of
              4,194,304 rows, with its time, the plain version's time,
              the least time the card could take, and a library call's
              time where one PyTorch call computes the same function;
              hist16 also on a one-value and a five-value column (atomic
              contention), one value over 2^24 live rows (16-bit counter
              overflow), views whose bases are not 16-byte aligned and a
              flush probe; hll_register_max also with ranks rising into
              one register and on unaligned views; counts and registers
              must match exactly, two launches must agree. For K3 and K4
              the kernel's device time from torch.profiler stands beside
              the CUDA-event time; a launch the card refuses must raise;
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
              packing and quantile selection (host_finish_batch), and the
              grouping pass;
  5. basic_example  the README's example (examples/basic_example.py's
              checks) on the card, with BASELINE.md's outcome.
Then the kernels' summary line and, last, the device line. Any failed
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
import time

BATCH = 1 << 22  # the fused pass's batch: 4,194,304 rows
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP64_OPS_PER_S = 34e12  # H100 SXM FP64 outside the tensor cores (data sheet)
INT32_OPS_PER_S = 33.5e12  # 64 INT32 lanes/SM/clock: half the 67 TFLOP/s FP32 rate
SUM_RTOL = 1e-10  # kernel vs plain: float64 sums taken in another order
METRIC_RTOL = 1e-9  # metrics vs the numpy reference


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def kernel_phase(torch, ck, device, rng, timer):
    """Each kernel against its plain version on the card; returns the
    summary rows (launch counts are filled in from the main path)."""
    import numpy as np

    rows = []
    for name in ("masked_moments", "masked_centered_sumsq"):
        worst = 0.0
        for n in (0, 1, BATCH - 37, BATCH):
            x_np = rng.normal(3.0, 2.0, n)
            valid = np.ones(n, dtype=bool)
            valid[::11] = False  # about 9% nulls, as the main path's x
            x = torch.from_numpy(np.where(valid, x_np, 0.0)).to(device)
            m = torch.from_numpy(valid).to(device)
            if name == "masked_moments":
                got = ck.masked_moments(x, m).cpu().numpy()
                if got.tobytes() != ck.masked_moments(x, m).cpu().numpy().tobytes():
                    raise AssertionError(f"masked_moments n={n}: two launches differ")
                want = ck.masked_moments_plain(x, m).cpu().numpy()
                exact = got[0] == want[0] and got[2] == want[2] and got[3] == want[3]
                if not (exact and close(got[1], want[1], SUM_RTOL)):
                    raise AssertionError(f"masked_moments n={n}: kernel {got} plain {want}")
                err = float(np.max(np.abs(got - want))) if n and valid.any() else 0.0
            elif name == "masked_centered_sumsq":
                avg = torch.tensor(float(x_np[valid].mean()) if valid.any() else 0.0,
                                   dtype=torch.float64, device=device)
                got = float(ck.masked_centered_sumsq(x, m, avg))
                if got != float(ck.masked_centered_sumsq(x, m, avg)):
                    raise AssertionError(f"masked_centered_sumsq n={n}: two launches differ")
                want = float(ck.masked_centered_sumsq_plain(x, m, avg))
                if not close(got, want, SUM_RTOL):
                    raise AssertionError(f"masked_centered_sumsq n={n}: kernel {got} plain {want}")
                err = abs(got - want)
            worst = max(worst, err)
            emit({"phase": "kernel_check", "kernel": name, "n": n, "max_abs_err": err})
        # x, m are the full batch's after the loop
        n = BATCH
        if name == "masked_moments":
            ms = timer.ms(lambda: ck.masked_moments(x, m))
            plain = timer.ms(lambda: ck.masked_moments_plain(x, m))
            bound, by = bound_ms(n * 9 + 4 * 8, 3 * n, FP64_OPS_PER_S)
            replaces = "deequ_tpu/ops/pallas_kernels.py:231"
        else:
            ms = timer.ms(lambda: ck.masked_centered_sumsq(x, m, avg))
            plain = timer.ms(lambda: ck.masked_centered_sumsq_plain(x, m, avg))
            bound, by = bound_ms(n * 9 + 2 * 8, 3 * n, FP64_OPS_PER_S)
            replaces = "deequ_tpu/ops/pallas_kernels.py:269"
        row = {
            "name": name,
            "route": "cuda",
            "source": "deequ_tpu_torch/csrc/kernels.cu",
            "replaces": replaces,
            "launches": None,
            "max_abs_err": worst,
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": None,  # no single PyTorch call computes it
            "held_against_plain": True,
        }
        emit({"phase": "kernel", **row, "rows": n})
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


def profiler_phase(torch, timer):
    """A `profile(name, fn, kernel, event_ms)` that runs fn under
    torch.profiler, the L2 evicted before each call as the event timer
    does, and emits the kernel's device time beside the CUDA-event time
    of the call. From the device timeline: the span from the start of
    the call's first device operation (the output's zero fill) to the
    end of the kernel, and the gap between the eviction's end and that
    start, which would hold any host delay inside the event time."""
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
    import numpy as np

    from deequ_tpu_torch.data.table import ColumnType, Table

    rng = np.random.default_rng(seed)
    x = rng.normal(3.0, 2.0, rows)
    y = 0.5 * x + rng.normal(0.0, 1.0, rows)
    x[::11] = np.nan  # nulls exercise the mask algebra
    ids = rng.integers(0, rows, rows)
    cats = np.array(["ok", "warn", "err", "skip", None], dtype=object)
    cat = cats[rng.integers(0, len(cats), rows)]
    grp = rng.integers(0, 5, rows)
    data = {"x": x, "y": y, "id": ids, "cat": cat, "grp": grp}
    return data, Table.from_numpy(data, types={"cat": ColumnType.STRING})


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


@contextlib.contextmanager
def timed_calls(owner, name, totals):
    """Accumulate the wall time of every call of owner.<name> in totals[name]."""
    original = getattr(owner, name)

    def wrapper(*args, **kwargs):
        start = time.perf_counter()
        try:
            return original(*args, **kwargs)
        finally:
            totals[name] = totals.get(name, 0.0) + time.perf_counter() - start

    setattr(owner, name, wrapper)
    try:
        yield totals
    finally:
        setattr(owner, name, original)


def main_path_phase(torch, ck, rows: int, seed: int, card: str, power_limit: str):
    import numpy as np

    from deequ_tpu_torch import Check, CheckLevel, CheckStatus, VerificationSuite
    from deequ_tpu_torch.analyzers import (
        ApproxCountDistinct, ApproxQuantiles, Completeness, Correlation, Maximum, Mean,
        Minimum, Size, StandardDeviation, Sum,
    )
    from deequ_tpu_torch.analyzers.sketch import _QuantileAnalyzerBase
    from deequ_tpu_torch.data.expr import Predicate
    from deequ_tpu_torch.ops import fused, runtime
    from deequ_tpu_torch.ops.fused import FusedScanPass
    from deequ_tpu_torch.runners import analysis_runner

    t0 = time.perf_counter()
    data, table = flagship_table(rows, seed)
    setup_s = time.perf_counter() - t0
    check = (
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
    quantiles_y = ApproxQuantiles("y", [0.1, 0.5, 0.9])
    batches = -(-rows // BATCH)
    expected_launches = {
        "masked_moments": batches,
        "masked_centered_sumsq": batches,
        "hll_register_max": batches,
        "hist16": 2 * batches,  # one per batch and quantile analyzer
    }

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
    for i in range(2):
        with contextlib.ExitStack() as stack:
            if i == 1:  # the warm run: where its wall time goes
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

    def verdicts(result):
        return [
            (cr.status.value, cr.message)
            for res in result.check_results.values()
            for cr in res.constraint_results
        ]

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
        },
        "host_finish_batch_share": split.get("host_finish_batch", 0.0) / second,
        "cpu_run_s": cpu_wall,
        "launches_per_run": runs[0][2],
        "metrics": metrics[0],
        "status": runs[0][0].status.value,
    }
    emit(out)
    return runs[0][2]


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", type=int, default=4 * BATCH)
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device; this script measures the GPU only\n")
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from deequ_tpu_torch.ops import cuda_build
    from deequ_tpu_torch.ops import cuda_kernels as ck
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
    })

    start = time.perf_counter()
    cuda_build.build(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - start,
          "library": os.path.relpath(cuda_build.library_path())})

    rng = np.random.default_rng(args.seed)
    timer = Timer(torch, device)
    emit({"phase": "timer", "empty_call_ms": timer.ms(lambda: torch.empty(1, device=device))})
    profile = profiler_phase(torch, timer)
    summary = kernel_phase(torch, ck, device, rng, timer)
    summary.append(hll_phase(torch, ck, hll, device, rng, timer, profile))
    summary.append(hist16_phase(torch, ck, device, rng, timer, profile))
    refused_launch_phase(torch, ck, cuda_build, device)
    del timer, profile  # frees the 256 MB L2 flush buffer before the main path
    launches = main_path_phase(torch, ck, args.rows, args.seed, card, power_limit)
    basic_example_phase(torch, ck)
    for row in summary:
        row["launches"] = launches[row["name"]]
        if not row["launches"]:
            raise AssertionError(f"{row['name']} never launched on the main path")
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
