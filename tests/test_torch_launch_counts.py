"""The kernels' launch counters stay exact across threads.

The service's workers, a fused pass's prep thread and the sharded scan's
shards launch kernels from several threads at once, and `chip_smoke.py`
holds every path to exact launch counts. A bare `kernel.launches += 1`
is a read, an add and a write that two threads can interleave; the
wrappers count through `count_launch`, under one lock."""

from __future__ import annotations

import sys
import threading

import pytest

from deequ_tpu_torch.ops import cuda_kernels as ck

THREADS = 8
BUMPS = 10_000


@pytest.fixture(autouse=True)
def _zero_counts():
    ck.reset_launch_counts()
    yield
    ck.reset_launch_counts()


@pytest.mark.parametrize("kernel", ck.KERNELS, ids=lambda k: k.__name__)
def test_count_launch_loses_nothing_across_threads(kernel):
    barrier = threading.Barrier(THREADS)

    def bump():
        barrier.wait()
        for _ in range(BUMPS):
            ck.count_launch(kernel)

    threads = [threading.Thread(target=bump) for _ in range(THREADS)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: a lost update shows
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    counts = ck.launch_counts()
    assert counts[kernel.__name__] == THREADS * BUMPS == 80_000
    assert sum(counts.values()) == 80_000
    ck.reset_launch_counts()
    assert set(ck.launch_counts().values()) == {0}


def test_every_wrapper_counts_through_the_lock():
    """The four wrappers' only increments are `count_launch` calls."""
    import inspect

    source = inspect.getsource(ck)
    assert ".launches += 1" not in source.replace("kernel.launches += 1", "")
    for kernel in ck.KERNELS:
        assert f"count_launch({kernel.__name__})" in inspect.getsource(kernel)
