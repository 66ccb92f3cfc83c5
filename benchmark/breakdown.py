"""The traced run's `breakdown`: the device operations that took most
time, and the longest idle gaps of the device, each labelled with the
category of the innermost span of the requesting thread open when the
gap began ("between requests" outside every request)."""

from __future__ import annotations

import threading

from benchmark.trace import innermost

TOP = 10


def breakdown(run) -> dict:
    device = run.device
    ops = sorted(device.op_seconds().items(), key=lambda kv: -kv[1])[:TOP]
    tid = threading.get_ident()  # requests run on the harness's thread
    gaps = []
    for start, stop in sorted(device.gaps(), key=lambda g: g[0] - g[1])[:TOP]:
        label = "between requests"
        for it in run.iterations:
            if it.start <= start < it.end:
                label = innermost(it.roots or [], tid, start) or "request"
                break
        gaps.append([label, stop - start])
    return {"device_ops": [[name, seconds] for name, seconds in ops], "idle_gaps": gaps}
