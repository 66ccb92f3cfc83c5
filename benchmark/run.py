#!/usr/bin/env python3
"""The benchmark of deequ_tpu_torch: run one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the repository root, on a machine with the CUDA cards the cell asks
for. Earlier lines of standard output describe the run (the card, the
host, the program's resolved settings, the window's requests); the last
is one JSON object with `correct`, `attempted`, `failed`, `metrics`,
`device` (and with `--trace 1`, `breakdown`) and, last, `checks`: each
number compared with the plain reference beside its limit, which the
last lines of standard error repeat. `--trace 0` reports the cell's
end-to-end metrics, `--trace 1` its per-layer metrics.

Exits 1 without a result when CUDA is missing or has fewer cards than
the cell asks for, and 3 when the JAX stack or the JAX package was
loaded in this process.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: build and kernel caches at fixed paths inside the checkout, so that
#: only a checkout's first run builds
CACHE_DIR = os.path.join(ROOT, ".bench_cache")


def card_line() -> dict:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        out = f"nvidia-smi unavailable: {exc}"
    return {"bench": "card", "nvidia_smi": out, "cpu_count": os.cpu_count()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    scratch = tempfile.mkdtemp(prefix="deequ-bench-")  # under TMPDIR
    # the port's probe and state caches live and die with this run
    os.environ["DEEQU_TPU_CACHE_DIR"] = os.path.join(scratch, "cache")
    try:
        return run(args, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def run(args, scratch: str) -> int:
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import core

    cell = core.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), found {count}",
              file=sys.stderr)
        return 1
    print(json.dumps(card_line()), flush=True)
    workdir = os.path.join(scratch, "data")
    os.makedirs(workdir)
    result = core.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           t0=T0, workdir=workdir)
    return report(result)


def report(result: dict) -> int:
    """Print the result, or, when the JAX stack or the JAX package is
    loaded in this process (the program's run and the reference's both
    done), say so on standard error and print none."""
    from benchmark import core

    found = core.forbidden_modules()
    if found:
        print(f"benchmark: modules loaded that the port may not use: {', '.join(found)}",
              file=sys.stderr, flush=True)
        return 3
    print(f"correct = {result['correct']}", file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name} = {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
