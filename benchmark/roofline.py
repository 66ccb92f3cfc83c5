"""The least time the card could take for each K1-K4 launch.

A frozen copy of chip_smoke.py's peaks (:313-316), `bound_ms` (:367) and
byte counts (:486, :571, :647): each input byte read once and each output
byte written once; the operations as there. Peaks are NVIDIA's data sheet
for the H100 SXM at its full 700 W.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP64_OPS_PER_S = 34e12  # FP64 outside the tensor cores
INT32_OPS_PER_S = 33.5e12  # 64 INT32 lanes/SM/clock: half the 67 TFLOP/s FP32 rate
N_REGISTERS = 512  # HLL++ p = 9
HIST_BINS = 65536  # hist16's sortable-key bins (int32 counts)


def launch_cost(kernel: str, rows: int, value_bytes: int, live: int):
    """(bytes, operations, peak operations per second) of one launch."""
    if kernel == "masked_moments":  # x and its mask in; count, sum, min, max out
        return rows * (value_bytes + 1) + 4 * 8, 3 * rows, FP64_OPS_PER_S
    if kernel == "masked_centered_sumsq":  # x and its mask in; m2 out
        return rows * (value_bytes + 1) + 8, 3 * rows, FP64_OPS_PER_S
    if kernel == "hll_register_max":  # int32 codes and the mask in; the registers out
        return rows * 5 + N_REGISTERS * 4, 4 * rows, INT32_OPS_PER_S
    if kernel == "hist16":  # the mask, the live values, the counts out
        return rows + value_bytes * live + HIST_BINS * 4, 4 * rows, INT32_OPS_PER_S
    raise ValueError(f"unknown kernel {kernel!r}")


def least_seconds(kernel: str, rows: int, value_bytes: int, live: int) -> float:
    nbytes, ops, peak = launch_cost(kernel, rows, value_bytes, live)
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)
