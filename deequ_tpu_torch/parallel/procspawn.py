"""Start worker processes and collect their results: the launcher of a
multi-process run on one machine (the two-process tests and
chip_smoke.py's sharded phase).

Each worker is a fresh interpreter (`subprocess.Popen`, never a fork of a
process that may have CUDA up) running `worker_source` with argv
``[rank, port, tmpdir, *extra_args]``; `port` is a free TCP port on
localhost for `multihost.initialize`. A worker prints one
``RESULT:<json>`` line. Every worker is reaped on the way out, also on a
timeout or an error.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence


class WorkerFailure(RuntimeError):
    """A worker exited non-zero, broke the RESULT protocol, or the run
    timed out; `details` holds every worker's stderr tail."""

    def __init__(self, message: str, details: str = ""):
        super().__init__(message + ("\n" + details if details else ""))
        self.details = details


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_worker_processes(
    worker_source: str,
    n_processes: int,
    extra_args: Sequence[str] = (),
    timeout: float = 240.0,
    env: Optional[dict] = None,
) -> List[dict]:
    """Run `worker_source` in `n_processes` interpreters and return their
    RESULT payloads in rank order. `timeout` bounds the whole run; `env`
    adds variables to the workers' environment. Each worker gets the
    repository on its PYTHONPATH and its rank as ``DEEQU_TPU_SHARD``.
    Raises WorkerFailure with every worker's stderr tail."""
    port = free_port()
    base_env = dict(os.environ)
    base_env.update(env or {})
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    base_env["PYTHONPATH"] = repo_root + os.pathsep + base_env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmpdir:
        worker_path = os.path.join(tmpdir, "worker.py")
        with open(worker_path, "w", encoding="utf-8") as f:
            f.write(worker_source)
        procs, logs = [], []
        try:
            for rank in range(n_processes):
                out = open(os.path.join(tmpdir, f"rank{rank}.out"), "w+", encoding="utf-8")
                err = open(os.path.join(tmpdir, f"rank{rank}.err"), "w+", encoding="utf-8")
                logs.append((out, err))
                procs.append(
                    subprocess.Popen(
                        [sys.executable, worker_path, str(rank), str(port), tmpdir]
                        + [str(a) for a in extra_args],
                        stdout=out,
                        stderr=err,
                        stdin=subprocess.DEVNULL,
                        env=dict(base_env, DEEQU_TPU_SHARD=str(rank)),
                    )
                )
            deadline = time.monotonic() + timeout
            timed_out = False
            for p in procs:
                try:
                    p.wait(timeout=max(deadline - time.monotonic(), 0.01))
                except subprocess.TimeoutExpired:
                    timed_out = True
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            outputs = []
            for out, err in logs:
                out.seek(0)
                err.seek(0)
                outputs.append((out.read(), err.read()))
                out.close()
                err.close()
        codes = [p.returncode for p in procs]
        details = "\n---\n".join(
            f"rank {i} rc={rc}:\n{err[-2000:]}" for i, (rc, (_o, err)) in enumerate(zip(codes, outputs))
        )
        if timed_out:
            raise WorkerFailure(f"{n_processes} worker processes timed out after {timeout:.0f}s", details)
        if any(rc != 0 for rc in codes):
            raise WorkerFailure(f"a worker of {n_processes} failed", details)
        results = []
        for rank, (stdout, _err) in enumerate(outputs):
            lines = [line for line in stdout.splitlines() if line.startswith("RESULT:")]
            if not lines:
                raise WorkerFailure(f"rank {rank} exited 0 but printed no RESULT line", details)
            try:
                results.append(json.loads(lines[-1][len("RESULT:"):]))
            except ValueError as e:
                raise WorkerFailure(f"rank {rank} printed a malformed RESULT line: {e}", details)
        return results
