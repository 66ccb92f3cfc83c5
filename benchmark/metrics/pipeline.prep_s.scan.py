"""pipeline.prep_s.scan: self time of the staged pipeline's prep stage
(`pipe_item` spans of stage "prep": a batch's device inputs built on the
prep thread, with the string predicates, HLL codes, packing and the copy
to the card), seconds per run; busy thread-seconds beside the fold."""
from benchmark.stats import self_time_per_request


def read(run):
    return self_time_per_request(run, ("pipe_item:prep",))
