"""Arithmetic the metric readers share."""

from __future__ import annotations

from typing import Iterable, Optional


def self_time_per_request(run, categories: Iterable[str]) -> Optional[float]:
    """Mean over the window's completed requests of the self time, in
    seconds, of the program's spans of these categories; None when the
    run was not traced or no span of these categories was recorded."""
    done = run.done
    if not run.trace or not done:
        return None
    categories = tuple(categories)
    if not any(cat in it.self_s for it in done for cat in categories):
        return None
    return sum(it.self_s.get(cat, 0.0) for it in done for cat in categories) / len(done)


def idle_share_percent(run) -> Optional[float]:
    device = run.device
    if device is None or device.window_s <= 0:
        return None
    return 100.0 * (1.0 - device.busy_s() / device.window_s)
