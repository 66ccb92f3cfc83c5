"""grouping.spill_s.scan: seconds per run of the grouping's disk spill
(`spill_write`, `spill_finalize` and `spill_read` spans); 0 when the
group passes say they did not spill, None when no group pass says."""
from benchmark import waits


def read(run):
    return waits.spill_s(run)
