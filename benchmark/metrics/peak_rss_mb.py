"""peak_rss_mb: the highest resident set of the process during the
window alone, in MB (10^6 bytes): the largest of /proc/self/statm's
readings every 10 ms from a harness thread."""


def read(run):
    return run.rss_peak_bytes / 1e6
