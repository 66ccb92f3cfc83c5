"""source.wait_s.scan: seconds per run the streamed source's consumers
(the prep thread, the grouping pass) wait for decoded batches
(`pipe_wait` spans with `on` "decode", blocked puts left out); None when
the program records no wait spans."""
from benchmark import waits


def read(run):
    return waits.wait_s(run, "decode")
