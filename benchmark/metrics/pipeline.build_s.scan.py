"""pipeline.build_s.scan: thread-seconds per run of the fused pass's
input builds (the `build_s` attributes they add to the span open around
them: predicates, string work, HLL codes, value columns); None when the
program records none."""
from benchmark import waits


def read(run):
    return waits.attr_sum(run, "build_s")
