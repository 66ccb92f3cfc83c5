"""CUDA kernels of the fused pass, each beside its plain PyTorch version.

The counterpart of `deequ_tpu/ops/pallas_kernels.py`. Each wrapper takes
the plain version for a tensor on the CPU, and for a CUDA tensor launches
its hand-written kernel (`csrc/kernels.cu`, built by `cuda_build`) or
raises. There is no shape gate and no fallback: the kernels take any
length, 0 and ragged tails included.

Each wrapper counts its kernel launches in an integer attribute
(`masked_moments.launches`, ...), so a run can show that its main path
went through the kernels; `reset_launch_counts()` zeroes them.

K1 and K2 also have a blocked emulation (`masked_moments_blocked`,
`masked_centered_sumsq_blocked`): PyTorch that adds the rows in the
kernel's own order, so the tests and `chip_smoke.py` can hold the
kernel's sums to the bit. Nothing on the main path calls them.

| wrapper               | replaces (deequ_tpu/ops/pallas_kernels.py) |
|-----------------------|--------------------------------------------|
| masked_moments        | masked_moments (:231)                      |
| masked_centered_sumsq | masked_centered_sumsq (:269)               |
| hll_register_max      | hll_register_max (:58)                     |
| hist16                | hist16 (:165), fed by f32_sortable_bin16   |
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

N_REGISTERS = 512  # HLL++ p = 9 (ops/sketches/hll.M)
HIST_BINS = 65536  # the full 16-bit sortable-key space
HIST_SENTINEL = HIST_BINS - 1  # the bin of excluded rows
# K1 and K2 run blocks of this many threads (csrc/kernels.cu
# kMomentsThreads), at least two quads of four rows a thread, and at most
# two blocks on each of the H100's 132 SMs. Constants, so the grid — and
# with it the summation order — depends on the row count alone.
MOMENTS_THREADS = 512
MOMENTS_MAX_GRID = 2 * 132
# K3 runs two blocks and K4 one block of this many threads per SM
# (csrc/kernels.cu kHllThreads, kHistThreads); their results do not
# depend on the grid.
BLOCK_THREADS = 1024
# K4's rows per flush window: its 16-bit shared counters never pass
# 65535, and windows stay whole quads of four rows.
HIST_MAX_WINDOW = 65532
# K4 flushes two adjacent int32 bins in one 64-bit atomic; below 2^32
# rows the low bin's count never carries into the high one.
HIST_MAX_ROWS = (1 << 32) - 1
_FLOATS = (torch.float64, torch.float32)


def _check_1d(name: str, t: torch.Tensor, dtypes) -> None:
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor, got shape {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")


def _check_pair(x: torch.Tensor, m: torch.Tensor, x_dtypes) -> None:
    _check_1d("x", x, x_dtypes)
    _check_1d("m", m, (torch.bool,))
    if x.shape != m.shape or x.device != m.device:
        raise ValueError(
            f"x {tuple(x.shape)} on {x.device} and m {tuple(m.shape)} on "
            f"{m.device} must match in shape and device"
        )


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"tensor on {t.device}: the kernels take cuda or cpu tensors")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {err}")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's number of SMs, which sizes the K3 and K4 grids."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def hll_plan(n: int, sms: int, codes_ptr: int) -> Tuple[int, int]:
    """(head, grid) of a K3 launch: `head` rows (0-3) bring the int32
    codes at `codes_ptr` to a 16-byte boundary; then at most two blocks
    per SM, each thread one quad of four rows per step."""
    if codes_ptr % 4:
        raise ValueError(f"int32 codes at {codes_ptr:#x} are not 4-byte aligned")
    head = min(n, (-codes_ptr % 16) // 4)
    quads = (n - head) // 4
    return head, max(1, min(2 * sms, _cdiv(quads, BLOCK_THREADS)))


def moments_plan(n: int, x_ptr: int, itemsize: int) -> Tuple[int, int]:
    """(head, grid) of a K1 or K2 launch: `head` rows (0-1 of float64,
    0-3 of float32) bring x at `x_ptr` to a 16-byte boundary; then one
    block of MOMENTS_THREADS threads per two quads a thread, at most
    MOMENTS_MAX_GRID blocks."""
    if itemsize not in (4, 8) or x_ptr % itemsize:
        raise ValueError(f"x of {itemsize}-byte values at {x_ptr:#x} is not aligned to them")
    head = min(n, (-x_ptr % 16) // itemsize)
    return head, _moments_grid(n - head)


def _moments_grid(body: int) -> int:
    return max(1, min(MOMENTS_MAX_GRID, _cdiv(body // 4, 2 * MOMENTS_THREADS)))


_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
_TICKETS_LOCK = threading.Lock()


def _tickets(device: torch.device, stream: int) -> torch.Tensor:
    """The ticket counter of K1's and K2's last-block fold on one stream.
    A launch draws a ticket per block, and the last draw wraps the counter
    back to 0. Launches on one stream run one after another, so each finds
    its stream's counter at 0; two streams never share one."""
    key = (device.index, stream)
    with _TICKETS_LOCK:
        tickets = _TICKETS.get(key)
        if tickets is None:  # zeroed on this stream, before any launch on it
            tickets = torch.zeros(1, dtype=torch.int32, device=device)
            _TICKETS[key] = tickets
    return tickets


def hist16_plan(n: int, sms: int, x_ptr: int) -> Tuple[int, int, int]:
    """(head, window, grid) of a K4 launch: `head` rows (0 or 1) bring the
    float64 x at `x_ptr` to a 16-byte boundary; the rest is cut into
    windows of `window` rows (a multiple of 4, at most HIST_MAX_WINDOW),
    the same number for each of `grid` <= `sms` blocks up to the last.
    A block flushes its 16-bit counters after each window."""
    if n > HIST_MAX_ROWS:
        raise ValueError(f"hist16 takes at most {HIST_MAX_ROWS} rows a call, got {n}")
    if x_ptr % 8:
        raise ValueError(f"float64 x at {x_ptr:#x} is not 8-byte aligned")
    head = min(n, (x_ptr // 8) % 2)
    body = n - head
    if body == 0:
        return head, 4, 1
    per_block = _cdiv(_cdiv(body, HIST_MAX_WINDOW), sms)
    window = _cdiv(body, per_block * sms)
    window += -window % 4
    return head, window, min(sms, _cdiv(body, window))


# ---------------------------------------------------------------------------
# K1: masked count / sum / min / max
# ---------------------------------------------------------------------------


def masked_moments_plain(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(count, sum, min, max) of `x` where `m`, as 4 float64 values.
    Masked rows give 0 to count and sum and +-inf to min and max."""
    xd = x.to(torch.float64)
    if x.numel() == 0:
        return torch.tensor(
            [0.0, 0.0, float("inf"), float("-inf")], dtype=torch.float64, device=x.device
        )
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=x.device)
    zero = torch.zeros((), dtype=torch.float64, device=x.device)
    return torch.stack(
        [
            m.sum().to(torch.float64),
            torch.where(m, xd, zero).sum(),
            torch.where(m, xd, inf).min(),
            torch.where(m, xd, -inf).max(),
        ]
    )


def masked_moments(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(count, sum, min, max) of `x` under the bool mask `m` in one read,
    as a 4-element float64 tensor on x's device."""
    _check_pair(x, m, _FLOATS)
    if x.device.type == "cpu":
        return masked_moments_plain(x, m)
    _require_cuda(x)
    from deequ_tpu_torch.ops import cuda_build

    lib = cuda_build.load()
    head, grid = moments_plan(x.numel(), x.data_ptr(), x.element_size())
    stream = _stream(x)
    out = torch.empty(4, dtype=torch.float64, device=x.device)
    scratch = torch.empty(4 * grid, dtype=torch.float64, device=x.device)  # the partials
    err = lib.dq_masked_moments(
        x.data_ptr(), int(x.dtype == torch.float32), m.data_ptr(), x.numel(),
        head, grid, scratch.data_ptr(), _tickets(x.device, stream).data_ptr(),
        out.data_ptr(), stream,
    )
    _raise_on(err, "masked_moments")
    count_launch(masked_moments)
    return out


masked_moments.launches = 0


# ---------------------------------------------------------------------------
# K2: masked centred sum of squares
# ---------------------------------------------------------------------------


def masked_centered_sumsq_plain(
    x: torch.Tensor, m: torch.Tensor, avg: torch.Tensor
) -> torch.Tensor:
    """sum(((x - avg) * m)^2) in float64, as a 0-d tensor."""
    d = torch.where(m, x.to(torch.float64) - avg, 0.0)
    return (d * d).sum()


def masked_centered_sumsq(
    x: torch.Tensor, m: torch.Tensor, avg: torch.Tensor
) -> torch.Tensor:
    """StandardDeviation's m2: sum(((x - avg) * m)^2) with the centring
    folded into the one read of `x`. `avg` is a 0-d float64 tensor on x's
    device (never a Python float: reading it would sync the host)."""
    _check_pair(x, m, _FLOATS)
    if (
        not isinstance(avg, torch.Tensor)
        or avg.dim() != 0
        or avg.dtype != torch.float64
        or avg.device != x.device
    ):
        raise TypeError(
            f"avg must be a 0-d float64 tensor on {x.device}, got {avg!r}"
        )
    if x.device.type == "cpu":
        return masked_centered_sumsq_plain(x, m, avg)
    _require_cuda(x)
    from deequ_tpu_torch.ops import cuda_build

    lib = cuda_build.load()
    head, grid = moments_plan(x.numel(), x.data_ptr(), x.element_size())
    stream = _stream(x)
    avg = avg.contiguous()
    out = torch.empty((), dtype=torch.float64, device=x.device)
    scratch = torch.empty(grid, dtype=torch.float64, device=x.device)  # the partials
    err = lib.dq_centered_sumsq(
        x.data_ptr(), int(x.dtype == torch.float32), m.data_ptr(), x.numel(),
        head, grid, avg.data_ptr(), scratch.data_ptr(),
        _tickets(x.device, stream).data_ptr(), out.data_ptr(), stream,
    )
    _raise_on(err, "masked_centered_sumsq")
    count_launch(masked_centered_sumsq)
    return out


masked_centered_sumsq.launches = 0


# ---------------------------------------------------------------------------
# K1 and K2 in the kernel's own summation order
# ---------------------------------------------------------------------------


def _warp_tree(v: torch.Tensor) -> torch.Tensor:
    """Lane 0 of a warp tree over the last axis of 32 lanes: lane i adds
    lane i + offset for offset 16, 8, 4, 2, 1 (`__shfl_down_sync`)."""
    for offset in (16, 8, 4, 2, 1):
        v = v[..., :offset] + v[..., offset:2 * offset]
    return v[..., 0]


def _block_tree(v: torch.Tensor) -> torch.Tensor:
    """The fold of blocks of MOMENTS_THREADS values on the last axis:
    the warp trees, then one tree over the warps' values padded with
    zeros to 32 lanes (csrc/kernels.cu block_tree)."""
    warps = _warp_tree(v.reshape(*v.shape[:-1], MOMENTS_THREADS // 32, 32))
    return _warp_tree(F.pad(warps, (0, 32 - warps.shape[-1])))


def _blocked_sum(terms: torch.Tensor, head: int, grid: int) -> torch.Tensor:
    """The kernel's sum of `terms` (float64, 0.0 on masked rows): thread
    t adds head row t, its quads t, t + T, ... (T threads in all) and
    tail row t one after another; then each block's tree, and the tree
    over the partials in index order. Adding 0.0 where the kernel adds
    nothing keeps the bits: a sum that starts at +0.0 is never -0.0."""
    n = terms.numel()
    threads = grid * MOMENTS_THREADS
    acc = torch.zeros(threads, dtype=torch.float64, device=terms.device)
    acc[:head] += terms[:head]
    quads = (n - head) // 4
    steps = _cdiv(quads, threads)
    body = torch.zeros(steps * threads * 4, dtype=torch.float64, device=terms.device)
    body[:4 * quads] = terms[head:head + 4 * quads]
    body = body.view(steps, threads, 4)
    for step in range(steps):
        for row in range(4):
            acc = acc + body[step, :, row]
    tail = terms[head + 4 * quads:]
    acc[:tail.numel()] += tail
    partials = _block_tree(acc.view(grid, MOMENTS_THREADS))
    return _block_tree(F.pad(partials, (0, MOMENTS_THREADS - grid)))


def _blocked_plan(x: torch.Tensor, head: Optional[int]) -> Tuple[int, int]:
    if head is None:
        return moments_plan(x.numel(), x.data_ptr(), x.element_size())
    return head, _moments_grid(x.numel() - head)


def masked_moments_blocked(
    x: torch.Tensor, m: torch.Tensor, head: Optional[int] = None
) -> torch.Tensor:
    """masked_moments with its sum taken in the K1 kernel's order, for
    the plan of x's address or the given `head`; count, min and max are
    the plain version's (exact in any order)."""
    _check_pair(x, m, _FLOATS)
    head, grid = _blocked_plan(x, head)
    plain = masked_moments_plain(x, m)
    total = _blocked_sum(torch.where(m, x.to(torch.float64), 0.0), head, grid)
    return torch.stack([plain[0], total, plain[2], plain[3]])


def masked_centered_sumsq_blocked(
    x: torch.Tensor, m: torch.Tensor, avg: torch.Tensor, head: Optional[int] = None
) -> torch.Tensor:
    """masked_centered_sumsq in the K2 kernel's order: (x - avg), its
    square and each add rounded apart, as the kernel's __dsub_rn,
    __dmul_rn and __dadd_rn."""
    _check_pair(x, m, _FLOATS)
    head, grid = _blocked_plan(x, head)
    d = x.to(torch.float64) - avg
    return _blocked_sum(torch.where(m, d * d, 0.0), head, grid)


# ---------------------------------------------------------------------------
# K3: HLL register max
# ---------------------------------------------------------------------------


def hll_register_max_plain(codes: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Register-wise max over packed (idx << 6 | rank) codes where `m`;
    code 0 and out-of-range registers change nothing. (512,) int32."""
    idx = codes >> 6
    live = m & (codes != 0) & (idx >= 0) & (idx < N_REGISTERS)
    regs = torch.zeros(N_REGISTERS, dtype=torch.int32, device=codes.device)
    return regs.scatter_reduce_(
        0,
        torch.where(live, idx, 0).to(torch.int64),
        torch.where(live, codes & 0x3F, 0),
        "amax",
    )


def hll_register_max(codes: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The 512 HLL registers (int32) of the packed codes under mask `m`."""
    _check_pair(codes, m, (torch.int32,))
    if codes.device.type == "cpu":
        return hll_register_max_plain(codes, m)
    _require_cuda(codes)
    from deequ_tpu_torch.ops import cuda_build

    lib = cuda_build.load()
    head, grid = hll_plan(codes.numel(), sm_count(codes.device), codes.data_ptr())
    out = torch.empty(N_REGISTERS, dtype=torch.int32, device=codes.device)  # zeroed by the launcher
    err = lib.dq_hll_register_max(
        codes.data_ptr(), m.data_ptr(), codes.numel(), head, grid,
        out.data_ptr(), _stream(codes),
    )
    _raise_on(err, "hll_register_max")
    count_launch(hll_register_max)
    return out


hll_register_max.launches = 0

# ---------------------------------------------------------------------------
# K4: 16-bit sortable-key histogram
# ---------------------------------------------------------------------------


def f32_sortable_bin16_plain(x32: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Top 16 bits of each float32 value's order-preserving key (bin
    order is value order); rows not `live` get the sentinel 65535. int32."""
    u = x32.view(torch.int32)
    key = torch.where(u < 0, ~u, u | torch.tensor(-(1 << 31), dtype=torch.int32))
    bins = (key >> 16) & 0xFFFF  # logical shift of the 32-bit key
    return torch.where(live, bins, HIST_SENTINEL)


def hist16_plain(x: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """(65536,) int32 counts of the bins of float32(x) where `live`;
    excluded rows count in bin 65535."""
    bins = f32_sortable_bin16_plain(x.to(torch.float32), live)
    return torch.bincount(bins.long(), minlength=HIST_BINS).to(torch.int32)


def hist16(x: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """The 65536-bin histogram of float32(x)'s sortable-key bins under
    the bool mask `live`, binned inline from one read of x (float64)."""
    _check_pair(x, live, (torch.float64,))
    if x.device.type == "cpu":
        return hist16_plain(x, live)
    _require_cuda(x)
    from deequ_tpu_torch.ops import cuda_build

    lib = cuda_build.load()
    head, window, grid = hist16_plan(x.numel(), sm_count(x.device), x.data_ptr())
    out = torch.empty(HIST_BINS, dtype=torch.int32, device=x.device)  # zeroed by the launcher
    err = lib.dq_hist16(
        x.data_ptr(), live.data_ptr(), x.numel(), head, window, grid,
        out.data_ptr(), _stream(x),
    )
    _raise_on(err, "hist16")
    count_launch(hist16)
    return out


hist16.launches = 0

KERNELS = (masked_moments, masked_centered_sumsq, hll_register_max, hist16)

# the service's workers, a pass's prep thread and the sharded scan launch
# from several threads at once; `kernel.launches += 1` is a read, an add
# and a write, which two threads can interleave and lose a count
_LAUNCH_LOCK = threading.Lock()


def count_launch(kernel) -> None:
    """Add one to `kernel.launches`, atomically across threads."""
    with _LAUNCH_LOCK:
        kernel.launches += 1


def launch_counts() -> Dict[str, int]:
    with _LAUNCH_LOCK:
        return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for k in KERNELS:
            k.launches = 0
