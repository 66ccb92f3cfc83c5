"""lint.plan_s.scan: self time of the program's `plan` spans (the static
pass, validate_run_plan, plan_fuse), seconds per run."""
from benchmark.stats import self_time_per_request


def read(run):
    return self_time_per_request(run, ("plan",))
