"""source.decode_s.scan: self time of the `read` and `decode` spans of the
streamed source, seconds per run; busy thread-seconds of the decode pool
and the read-ahead slots, which overlap the scan."""
from benchmark.stats import self_time_per_request


def read(run):
    return self_time_per_request(run, ("read", "decode"))
