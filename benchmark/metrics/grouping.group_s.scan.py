"""grouping.group_s.scan: self time of the `group` spans (the grouping
runner, the frequency spill, freq_agg), seconds per run."""
from benchmark.stats import self_time_per_request


def read(run):
    return self_time_per_request(run, ("group",))
