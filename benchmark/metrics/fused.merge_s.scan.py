"""fused.merge_s.scan: self time of the `merge` spans (PipelinedAggFold,
the quantiles' host_finish_batch), seconds per run."""
from benchmark.stats import self_time_per_request


def read(run):
    return self_time_per_request(run, ("merge",))
