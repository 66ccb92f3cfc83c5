"""fused.host_s.scan: self time of the `scan`, `host`, `native` and
`dispatch` spans (the fused pass's input build, predicates, HLL codes,
packing and launch), seconds per run."""
from benchmark.stats import self_time_per_request


def read(run):
    return self_time_per_request(run, ("scan", "host", "native", "dispatch"))
