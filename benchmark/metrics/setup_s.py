"""setup_s: seconds from the process start to the end of the warm-up
request: CUDA init, the kernel and C libraries (from their caches in the
checkout), the data made from the seed, the traffic driver's set-up."""


def read(run):
    return run.setup_s
