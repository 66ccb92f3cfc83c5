"""device.idle_wait_share.scan: 100 x the device's idle time (torch.profiler)
that the requesting thread spends in its `pipe_wait` spans, over the
device's idle time in the traced window, each gap over its whole length."""
from benchmark import waits


def read(run):
    return waits.idle_wait_share(run)
