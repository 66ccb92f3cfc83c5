"""device.idle_share.scan: 100 x (1 - the union of the device operations'
intervals / the traced window), from torch.profiler."""
from benchmark.stats import idle_share_percent


def read(run):
    return idle_share_percent(run)
