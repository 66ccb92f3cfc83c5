"""rows_per_s: the rows of every completed request divided by the time
from the first request's start to the last one's end (not a median of runs)."""


def read(run):
    done = run.done
    if not done:
        return None
    return sum(it.rows for it in done) / (done[-1].end - done[0].start)
