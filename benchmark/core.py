"""The harness: one cell of BENCHMARK.json, run once.

Everything that belongs to one configuration, traffic mix or metric is
found by name:

    BENCHMARK.json                 the cells and metrics
    benchmark/configs/<config>.json   sizes, layout, guarantees; names its
                                      generator
    benchmark/gen/<generator>.py      make(config, seed, workdir) -> data
    benchmark/traffic/<traffic>.json  parameters; names its driver
    benchmark/drivers/<driver>.py     setup / request / output / close
    benchmark/reference/<traffic>.py  judge(...) -> [(name, value, limit)]
    benchmark/metrics/<metric>.py     read(run) -> number or None

A run: set-up (data from the seed, the traffic driver's set-up with one warm-up
request), the window (closed loop, one client: requests back to back
until `seconds` have passed; the last one started completes), the
comparison with the plain reference, and one JSON line. The generator's
arrays are let go before the window and made again from the seed after
it, and each request's result is reduced to plain numbers as it
returns, so that the window's resident set is the program's.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: top-level module names that may not be loaded in a run: the JAX stack
#: and the JAX package (the port's name begins with it, so names compare whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "deequ_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, bench_dir: str = BENCH_DIR):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One workload of BENCHMARK.json with its files resolved."""

    name: str
    chips: int
    config: dict
    traffic: dict
    traffic_name: str
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, bench_dir: str = BENCH_DIR) -> Cell:
    bench = load_json(os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(os.path.dirname(bench_dir), configs[entry["config"]]["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic", f"{entry['traffic']}.json"))
    return Cell(workload, entry["chips"], config, traffic, entry["traffic"],
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)])


@dataclass
class Iteration:
    """One request of the window: a whole run of a scan cell."""

    start: float
    end: float
    rows: int
    latency_s: float
    ok: bool
    output: object = None
    error: str = ""
    self_s: Dict[str, float] = field(default_factory=dict)  # traced runs
    roots: Optional[list] = None  # traced runs: the request's span forest


@dataclass
class RunRecord:
    """What the metric readers get."""

    setup_s: float
    iterations: List[Iteration]
    window: Tuple[float, float]
    rss_peak_bytes: int
    trace: bool
    device: object = None  # trace.DeviceRecord (traced runs on the card)
    launches: Optional[list] = None  # trace.LaunchLog.sizes() (traced runs on the card)

    @property
    def done(self) -> List[Iteration]:
        return [it for it in self.iterations if it.ok]


@dataclass
class Written:
    """What the window keeps of the generated data: the file and its rows."""

    path: str
    rows: int


@dataclass
class Context:
    """What a driver gets: the cell, the generated data, where to write,
    and the device the program runs on."""

    cell: Cell
    data: object
    seed: int
    workdir: str
    device: str


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN_MODULES))


class RssPeak:
    """The process's highest resident set over the window: a thread reads
    /proc/self/statm every `PERIOD_S` and keeps the largest reading."""

    PERIOD_S = 0.01

    def __init__(self) -> None:
        self.peak = 0
        self._stop = threading.Event()
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._thread = threading.Thread(target=self._sample, name="bench-rss", daemon=True)

    def _read(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _sample(self) -> None:
        while True:
            self.peak = max(self.peak, self._read())
            if self._stop.wait(self.PERIOD_S):
                return

    def __enter__(self) -> "RssPeak":
        self.peak = self._read()
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._read())


def run_window(driver, state, ctx: Context, seconds: float, traced: bool) -> List[Iteration]:
    """Requests back to back until `seconds` have passed since the first
    started; the last one started completes."""
    iterations: List[Iteration] = []
    start = time.perf_counter()
    index = 1  # request 0 was the warm-up
    while time.perf_counter() - start < seconds:
        if traced:
            from deequ_tpu_torch import observe

            with observe.tracing() as tracer:
                it = driver.request(state, ctx, index)
            from benchmark.trace import self_seconds

            it.self_s, it.roots = self_seconds(tracer.roots), tracer.roots
        else:
            it = driver.request(state, ctx, index)
        if it.ok:  # plain numbers for the reference; the result object goes
            it.output = driver.output(state, ctx, it.output)
        iterations.append(it)
        index += 1
    return iterations


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, t0: float,
             workdir: str, device: str = "cuda", sizes: Optional[dict] = None,
             bench_dir: str = BENCH_DIR, log=print) -> dict:
    """Run one cell and return the contract's result object. `sizes`
    overrides the configuration's scale (the CPU tests' tiny runs)."""
    import torch

    from benchmark.reference import plain

    cell = resolve(workload, bench_dir)
    gen = load_module("gen", cell.config["generator"], bench_dir)
    driver = load_module("drivers", cell.traffic["driver"], bench_dir)
    reference = load_module("reference", cell.traffic_name, bench_dir)
    on_card = device == "cuda"
    os.environ.update({k: str(v) for k, v in cell.config.get("knobs", {}).items()})

    data = gen.make(cell.config, seed, workdir, **(sizes or {}))
    ctx = Context(cell, data, seed, workdir, device)
    state = driver.setup(ctx)
    log(json.dumps({"bench": "setting", **driver.settings(state, ctx)}))
    ctx.data = Written(data.path, data.rows)
    del data
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    device_record = launches = None
    with RssPeak() as rss:
        if trace and on_card:
            from benchmark.trace import DeviceRecord, LaunchLog, profiled

            device_record, log_ = DeviceRecord(), LaunchLog()
            with log_.installed(), profiled(device_record):
                window_start = time.perf_counter()
                iterations = run_window(driver, state, ctx, seconds, True)
                window_end = time.perf_counter()
            launches = log_.sizes()
        else:
            window_start = time.perf_counter()
            iterations = run_window(driver, state, ctx, seconds, trace)
            if on_card:
                torch.cuda.synchronize()
            window_end = time.perf_counter()
    rss_peak = rss.peak
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    record = RunRecord(setup_s, iterations, (window_start, window_end), rss_peak, trace,
                       device_record, launches)
    log(json.dumps({"bench": "window", "requests": len(iterations),
                    "seconds": window_end - window_start,
                    "request_s": [it.latency_s for it in iterations],
                    "failed": [it.error for it in iterations if not it.ok][:5]}))

    driver.close(state)
    del state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ctx.data = gen.make(cell.config, seed, workdir, write_file=False, **(sizes or {}))
    numbers = reference.judge(ctx, [it.output for it in iterations if it.ok])
    failed = sum(1 for it in iterations if not it.ok)
    numbers.append(("failed_requests", float(failed), plain.LIMITS["failed_requests"]))
    correct = bool(iterations) and all(value <= limit for _, value, limit in numbers)

    metrics = {}
    for entry in (cell.per_layer if trace else cell.end_to_end):
        value = load_module("metrics", entry["name"], bench_dir).read(record)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    result = {"correct": correct, "attempted": len(iterations), "failed": failed,
              "metrics": metrics, "device": device_info(on_card, cell.chips, memory_peak)}
    if trace and device_record is not None:
        from benchmark.breakdown import breakdown

        result["device"]["busy_s"] = device_record.busy_s()
        result["device"]["window_s"] = device_record.window_s
        result["breakdown"] = breakdown(record)
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in numbers}
    return result


def device_info(on_card: bool, chips: int, memory_peak: int) -> dict:
    import torch

    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(memory_peak)}
