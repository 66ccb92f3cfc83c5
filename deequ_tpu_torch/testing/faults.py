"""Seed-driven chaos harness: deterministic fault injection at named
points in the engine's execution stack.

Product code calls `faults.fault_point("<name>")` at each seam (the C
reader's pread, the page decode, the pipeline's stage worker, the state
repository's IO, the sharded scan's plan and gather), and an armed fault
plan decides, deterministically from `(seed, point, occurrence index)`,
whether that occurrence fails.

Disabled path: `fault_point` is a module-global `None` check plus a
function call, nothing else, cheap enough for per-chunk call sites
(bounded in tests/test_torch_observe_overhead.py beside the tracing and
forensics guards).

Spec grammar (`DEEQU_TPU_FAULTS` or `install(spec)`), comma-separated:

    seed=7,stall=0.05,read.pread:0.5:3,decode.chunk:1.0:1

  * `seed=N` — base seed for the per-occurrence hash (default 0);
  * `stall=S` — sleep seconds for the latency/stall kinds (default 0.02);
  * `name:rate[:count]` — arm point `name`: each occurrence injects
    independently with probability `rate`; `count` caps total
    injections at that point (a transient fault: the first `count`
    qualifying occurrences fail, later retries succeed). No `count`
    with rate 1.0 models a persistent fault.

Every point name is registered in `FAULT_POINTS`; a test
(tests/test_torch_faults.py) rejects a `fault_point("...")` call site in
the package whose literal is not registered here, so the harness cannot
drift from the product code it exercises. The registry equals the JAX
package's, and every point has a call site in the port.

Injection behavior is keyed by the point's kind:

  * raise-kind points raise `InjectedFaultError` (an `OSError`
    subclass, so transient-IO retry paths treat it as retryable);
  * sleep-kind points block the calling thread for `stall` seconds
    (latency spikes and stage stalls) and return None;
  * data-kind points return a directive string (`"short"`, `"corrupt"`,
    `"fail"`, `"lost"`) the call site applies to its own data — the
    harness never touches buffers itself.

Determinism: occurrence `i` at point `p` under seed `s` injects iff
`random.Random(f"{s}:{p}:{i}").random() < rate`. The occurrence counter
is per-point and process-global (lock-guarded), so a fixed spec over a
fixed workload injects the same schedule every run regardless of thread
interleaving of OTHER points. (Which thread hits occurrence `i` may
vary under races: bit-identity of RESULTS under faults is the contract
the chaos differential pins, not the per-thread schedule.)

The JAX counterpart is deequ_tpu/testing/faults.py; the port keeps its
own copy (stdlib only), with the same schedule for the same spec.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

ENV_KNOB = "DEEQU_TPU_FAULTS"

#: every injectable point, name -> kind. Kinds: "raise" (the point
#: raises InjectedFaultError), "sleep" (the point blocks for the plan's
#: stall seconds), "data" (the point returns a directive the call site
#: applies: read.short -> "short", read.corrupt -> "corrupt",
#: decode.chunk / decode.runs -> "fail", shard.merge -> "corrupt",
#: shard.host_loss -> "lost").
FAULT_KINDS: Dict[str, str] = {
    # the C reader's column-chunk fetch (data/source.py)
    "read.pread": "raise",     # transient/persistent pread / ranged-GET error
    "read.short": "data",      # short read: the fetch returns truncated data
    "read.latency": "sleep",   # latency spike in the fetch slot
    "read.corrupt": "data",    # corrupt page bytes reach the decoder
    # native page decode (data/native_reader.py)
    "decode.chunk": "data",    # one column chunk fails to decode
    "decode.runs": "data",     # a run-length stream corrupts mid-chunk
    "decode.worker": "raise",  # a decode worker dies mid-unit (data/source.py)
    # staged stream pipeline (ops/pipeline.py)
    "pipeline.stage": "raise",  # the stage worker raises mid-batch
    "pipeline.stall": "sleep",  # the stage worker wedges on one batch
    # state repository (repository/states.py, windows/segments.py)
    "state.save": "raise",     # the per-partition state commit fails
    "state.load": "raise",     # a cached-state read fails
    "state.segment": "raise",  # a DQSG segment envelope read/write fails
    # DQ service: the fleet-scale execution layer (service/)
    "service.worker": "raise",     # a pool worker dies executing a run
    "service.scheduler": "sleep",  # the scheduler housekeeping tick wedges
    "service.admission": "raise",  # admission bookkeeping fails mid-submit
    "service.queue": "raise",      # a tier-queue pop fails (corruption)
    # sharded streaming scan (parallel/shard.py, parallel/multihost.py)
    "shard.assign": "raise",       # the shard planner fails mid-plan
    "shard.merge": "data",         # one gathered partition entry corrupts
    "shard.host_loss": "data",     # a whole shard's envelope is lost
}

FAULT_POINTS = frozenset(FAULT_KINDS)

DEFAULT_STALL_S = 0.02


class InjectedFaultError(OSError):
    """A fault the harness injected. Subclasses OSError so the engine's
    transient-IO retry paths handle it exactly like a real pread/GET
    failure — nothing in product code special-cases injection."""

    def __init__(self, point: str, occurrence: int) -> None:
        super().__init__(f"injected fault at {point} (occurrence {occurrence})")
        self.point = point
        self.occurrence = occurrence


class FaultSpecError(ValueError):
    """The DEEQU_TPU_FAULTS spec string does not parse."""


class FaultPlan:
    """One armed injection schedule: per-point rates/budgets plus the
    occurrence counters that make the schedule deterministic."""

    def __init__(
        self,
        specs: Dict[str, Tuple[float, Optional[int]]],
        *,
        seed: int = 0,
        stall_s: float = DEFAULT_STALL_S,
    ) -> None:
        for name in specs:
            if name not in FAULT_POINTS:
                raise FaultSpecError(
                    f"unknown fault point {name!r} (registered: "
                    f"{', '.join(sorted(FAULT_POINTS))})"
                )
        self.specs = dict(specs)
        self.seed = int(seed)
        self.stall_s = float(stall_s)
        self._lock = threading.Lock()
        self._occurrences: Dict[str, int] = {}
        #: point -> injections actually fired (tests/bench assert on it)
        self.injected: Dict[str, int] = {}

    def decide(self, point: str) -> Optional[str]:
        """One occurrence at `point`: None (pass through) or the point's
        kind-directive when this occurrence injects."""
        spec = self.specs.get(point)
        if spec is None:
            return None
        rate, budget = spec
        with self._lock:
            i = self._occurrences.get(point, 0)
            self._occurrences[point] = i + 1
            fired = self.injected.get(point, 0)
            if budget is not None and fired >= budget:
                return None
            if random.Random(f"{self.seed}:{point}:{i}").random() >= rate:
                return None
            self.injected[point] = fired + 1
        kind = FAULT_KINDS[point]
        if kind == "raise":
            raise InjectedFaultError(point, i)
        if kind == "sleep":
            time.sleep(self.stall_s)
            return None
        # data kind: the call site applies the directive to its buffers
        return {
            "read.short": "short",
            "read.corrupt": "corrupt",
            "decode.chunk": "fail",
            "decode.runs": "fail",
            "shard.merge": "corrupt",
            "shard.host_loss": "lost",
        }[point]


def parse_spec(spec: str) -> FaultPlan:
    """Parse a DEEQU_TPU_FAULTS spec string into a FaultPlan."""
    seed = 0
    stall_s = DEFAULT_STALL_S
    specs: Dict[str, Tuple[float, Optional[int]]] = {}
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        if token.startswith("seed="):
            seed = int(token[len("seed="):])
            continue
        if token.startswith("stall="):
            stall_s = float(token[len("stall="):])
            continue
        parts = token.split(":")
        if len(parts) not in (2, 3):
            raise FaultSpecError(
                f"bad fault token {token!r}: expected name:rate[:count]"
            )
        name = parts[0].strip()
        try:
            rate = float(parts[1])
            count = int(parts[2]) if len(parts) == 3 else None
        except ValueError as e:
            raise FaultSpecError(f"bad fault token {token!r}: {e}") from e
        if not (0.0 <= rate <= 1.0):
            raise FaultSpecError(f"rate out of [0,1] in {token!r}")
        specs[name] = (rate, count)
    return FaultPlan(specs, seed=seed, stall_s=stall_s)


# the armed plan; None (the overwhelmingly common case) short-circuits
# fault_point to a single global read. Written only by install()/_disarm
# under _install_lock; racing readers see either None or a full plan.
_PLAN: Optional[FaultPlan] = None
_install_lock = threading.Lock()


def fault_point(point: str) -> Optional[str]:
    """One occurrence at a named fault seam. Returns None (no fault) or
    a data directive; raises InjectedFaultError for raise-kind points;
    sleeps for sleep-kind points. Product call sites must use a string
    literal registered in FAULT_POINTS (lint-enforced)."""
    plan = _PLAN
    if plan is None:
        return None
    return plan.decide(point)


def active_plan() -> Optional[FaultPlan]:
    """The armed FaultPlan, or None."""
    return _PLAN


@contextlib.contextmanager
def install(spec: str) -> Iterator[FaultPlan]:
    """Arm a fault plan for the duration of the block (tests)."""
    global _PLAN
    plan = parse_spec(spec)
    with _install_lock:
        previous = _PLAN
        _PLAN = plan
    try:
        yield plan
    finally:
        with _install_lock:
            _PLAN = previous


def install_from_env() -> Optional[FaultPlan]:
    """Arm from DEEQU_TPU_FAULTS (the entry for a subprocess).
    Returns the armed plan, or None when the knob is unset/empty."""
    global _PLAN
    raw = os.environ.get(ENV_KNOB, "").strip()
    if not raw:
        return None
    plan = parse_spec(raw)
    with _install_lock:
        _PLAN = plan
    return plan


# a process started with the knob set is armed from import, so a
# subprocess under chaos needs no harness code
install_from_env()

__all__ = [
    "DEFAULT_STALL_S",
    "ENV_KNOB",
    "FAULT_KINDS",
    "FAULT_POINTS",
    "FaultPlan",
    "FaultSpecError",
    "InjectedFaultError",
    "active_plan",
    "fault_point",
    "install",
    "install_from_env",
    "parse_spec",
]
