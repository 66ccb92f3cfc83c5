"""One clock for the port's spans and torch.profiler's trace: run a traced
verification under torch.profiler, then write one Chrome-trace document
in which the host spans and the profiler's CPU ops and CUDA kernels line
up (load it at https://ui.perfetto.dev).

The port's tracer, made while the profiler records, marks its epoch in
the profiler's trace with a zero-length `deequ.trace_epoch` event;
`observe.export.chrome_trace(..., device_trace=...)` puts the profiler's
events on the span clock by that marker.

Run from the repository's root:
`PYTHONPATH=. python examples/torch_device_clock_demo.py`. The scan runs
on the CUDA device where there is one, and its kernels join the view;
else on the CPU.
"""

import json
import os
import tempfile

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from deequ_tpu_torch import Check, CheckLevel, VerificationSuite
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.observe import export


def main() -> None:
    rng = np.random.default_rng(42)
    n = 200_000
    data = Table.from_numpy(
        {
            "price": rng.lognormal(3.0, 1.0, n),
            "quantity": rng.integers(1, 50, n).astype(np.float64),
        }
    )
    device = "cuda" if torch.cuda.is_available() else "cpu"
    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        # the tracer is made inside the profiler: it marks its epoch there
        result = (
            VerificationSuite()
            .on_data(data, device=device)
            .add_check(
                Check(CheckLevel.ERROR, "prices")
                .is_complete("price")
                .has_min("quantity", lambda v: v >= 1.0)
            )
            .with_tracing(True)
            .run()
        )
    work = tempfile.gettempdir()
    device_path = os.path.join(work, "deequ_tpu_demo_profiler_trace.json")
    prof.export_chrome_trace(device_path)
    run_trace = result.run_trace
    doc = export.chrome_trace([run_trace.root], epoch=run_trace.epoch, device_trace=device_path)
    path = os.path.join(work, "deequ_tpu_demo_device_clock_trace.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    events = export.on_span_clock(device_path)
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"verification: {result.status}")
    print(
        f"spans and {len(events)} profiler events ({kernels} CUDA kernels) "
        f"on one clock: {path}"
    )


if __name__ == "__main__":
    main()
