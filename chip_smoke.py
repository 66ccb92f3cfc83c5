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
  4. main_path  a VerificationSuite over the flagship analyzers on a
              --rows table (float64 x and y with every 11th x null, int64
              id, string cat, int64 grp), run twice on CUDA: every kernel
              launches once per batch, the two runs agree bit for bit,
              the metrics agree with a numpy reference, and HLL registers,
              check statuses and messages equal a device="cpu" run.
Then the kernels' summary line and, last, the device line. Any failed
check raises: the script exits non-zero and prints no result. Without
CUDA it exits non-zero at once.
"""

from __future__ import annotations

import argparse
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


def kernel_phase(torch, ck, hll, device, rng, timer):
    """Each kernel against its plain version on the card; returns the
    summary rows (launch counts are filled in from the main path)."""
    import numpy as np

    rows = []
    for name in ("masked_moments", "masked_centered_sumsq", "hll_register_max"):
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
            else:
                # every row hashed, so the mask alone must drop the nulls
                ids = rng.integers(0, max(n, 1), n)
                codes = torch.from_numpy(hll.pack_codes(ids, np.ones(n, dtype=bool))).to(device)
                got = ck.hll_register_max(codes, m).cpu().numpy()
                want = ck.hll_register_max_plain(codes, m).cpu().numpy()
                if not np.array_equal(got, want):
                    raise AssertionError(f"hll_register_max n={n}: registers differ")
                err = float(np.max(np.abs(got - want)))
            worst = max(worst, err)
            emit({"phase": "kernel_check", "kernel": name, "n": n, "max_abs_err": err})
        # x, m, codes are the full batch's after the loop
        n = BATCH
        if name == "masked_moments":
            ms = timer.ms(lambda: ck.masked_moments(x, m))
            plain = timer.ms(lambda: ck.masked_moments_plain(x, m))
            library = None
            bound, by = bound_ms(n * 9 + 4 * 8, 3 * n, FP64_OPS_PER_S)
            replaces = "deequ_tpu/ops/pallas_kernels.py:231"
        elif name == "masked_centered_sumsq":
            ms = timer.ms(lambda: ck.masked_centered_sumsq(x, m, avg))
            plain = timer.ms(lambda: ck.masked_centered_sumsq_plain(x, m, avg))
            library = None
            bound, by = bound_ms(n * 9 + 2 * 8, 3 * n, FP64_OPS_PER_S)
            replaces = "deequ_tpu/ops/pallas_kernels.py:269"
        else:
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
            replaces = "deequ_tpu/ops/pallas_kernels.py:58"
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
            "library_ms": library,
            "held_against_plain": True,
        }
        emit({"phase": "kernel", **row, "rows": n})
        rows.append(row)
    return rows


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


EXACT = ("Size(None)", "Completeness(x,None)", "Minimum(x,None)", "Maximum(x,None)")


def main_path_phase(torch, ck, rows: int, seed: int, card: str, power_limit: str):
    import numpy as np

    from deequ_tpu_torch import Check, CheckLevel, CheckStatus, VerificationSuite
    from deequ_tpu_torch.analyzers import (
        ApproxCountDistinct, Completeness, Correlation, Maximum, Mean, Minimum,
        Size, StandardDeviation, Sum,
    )
    from deequ_tpu_torch.ops import runtime
    from deequ_tpu_torch.ops.fused import FusedScanPass

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
    )
    batches = -(-rows // BATCH)

    def run(device):
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = VerificationSuite.on_data(table, device=device).add_check(check).run()
        wall = time.perf_counter() - start
        return result, wall, ck.launch_counts()

    runs = []
    for _ in range(2):
        result, wall, counts = run("cuda")
        for name, launches in counts.items():
            if launches != batches:
                raise AssertionError(f"{name} launched {launches} times, expected {batches}")
        runs.append((result, wall, counts))
    metrics = [
        {repr(a): m.value.get() for a, m in r.metrics.items()} for r, _w, _c in runs
    ]
    for key, value in metrics[0].items():
        if np.float64(value).tobytes() != np.float64(metrics[1][key]).tobytes():
            raise AssertionError(f"{key}: runs differ, {value!r} vs {metrics[1][key]!r}")

    want = numpy_reference(data)
    for key, ref in want.items():
        got = metrics[0][key]
        if not (got == ref if key in EXACT else close(got, ref, METRIC_RTOL)):
            raise AssertionError(f"{key}: port {got!r} vs numpy {ref!r}")

    cpu_result, cpu_wall, cpu_counts = run("cpu")
    if any(cpu_counts.values()):
        raise AssertionError(f"a device='cpu' run launched kernels: {cpu_counts}")

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
        "second_run_s": runs[1][1],
        "rows_per_s_second_run": rows / runs[1][1],
        "cpu_run_s": cpu_wall,
        "launches_per_run": runs[0][2],
        "metrics": metrics[0],
        "status": runs[0][0].status.value,
    }
    emit(out)
    return runs[0][2]


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
    summary = kernel_phase(torch, ck, hll, device, rng, Timer(torch, device))
    launches = main_path_phase(torch, ck, args.rows, args.seed, card, power_limit)
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
