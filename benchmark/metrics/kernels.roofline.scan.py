"""kernels.roofline.scan: the summed least time of every K1-K4 launch of
the traced window over their summed device time from torch.profiler, in
percent. A launch's least time is its bytes over the HBM bandwidth or its
operations over the peak rate, whichever is larger (benchmark/roofline.py).
None when no K1-K4 launch ran."""
from benchmark import roofline


def read(run):
    if run.device is None or not run.launches:
        return None
    device_s = sum(run.device.kernel_seconds().values())
    if device_s <= 0:
        return None
    return 100.0 * sum(roofline.least_seconds(*launch) for launch in run.launches) / device_s
