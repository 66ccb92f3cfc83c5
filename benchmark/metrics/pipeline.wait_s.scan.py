"""pipeline.wait_s.scan: seconds per run the fold waits for the staged
pipeline's prep (`pipe_wait` spans with `on` "prep", blocked puts left
out); None when the program records no wait spans."""
from benchmark import waits


def read(run):
    return waits.wait_s(run, "prep")
