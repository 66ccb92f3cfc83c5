"""fused.program_span_s.scan: seconds per run between two CUDA events that
the program records on its stream around each batch's fused program (the
sum of `device_ms` on the `transfer` spans): the program's span on the
device's clock, kernels and the gaps while the host still launches its
ops alike, so it moves with launch overhead as much as with the kernels.
None without it (no card, or a program that does not time its launches)."""
from benchmark import waits


def read(run):
    ms = waits.attr_sum(run, "device_ms", name="transfer")
    return None if ms is None else ms / 1000.0
