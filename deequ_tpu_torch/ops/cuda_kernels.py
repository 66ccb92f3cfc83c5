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

K5, `classify_hash_dictionary`, replaces no TPU kernel: it moves the JAX
package's host work (`deequ_tpu/ops/strings.py` classify and
hash_strings) onto the card for a large string dictionary, with the same
codes bit for bit.

K6, `hist16_select`, replaces no TPU kernel either: it moves the JAX
package's host selection of a quantile sketch's decimated sample from
K4's bins (`deequ_tpu/analyzers/sketch.py` `host_finish_batch`) onto the
card, with the same sample bit for bit.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deequ_tpu_torch.ops import strings
from deequ_tpu_torch.ops.sketches import hll

N_REGISTERS = 512  # HLL++ p = 9 (ops/sketches/hll.M)
HLL_SEED = int(hll.SEED)  # strings.hash_strings' seed for the HLL codes
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

# ---------------------------------------------------------------------------
# K6: a quantile sketch's decimated sample, selected through K4's bins
# ---------------------------------------------------------------------------

# bins from here on hold no value: the positive-NaN keys (NaN is NULL, so
# no live row lands there) and the excluded rows' sentinel; bin 65408 is
# exactly +inf and holds values
SELECT_VALUE_BINS = 65409
ZERO_BINS = (0x7FFF, 0x8000)  # the bins of -0.0 and +0.0


def decimation(n: int, cap: int) -> Tuple[int, int]:
    """(level, kept) of a batch of `n` live values sampled into at most
    `cap`: level is the smallest L >= 0 with n <= cap * 2^L, and the
    sample keeps ranks stride // 2, stride // 2 + stride, ... of the
    sorted values (stride 2^L), `kept` of them, at most `cap`."""
    if n <= 0:
        return 0, 0
    level = (-(-n // cap) - 1).bit_length() if n > cap else 0
    stride = 1 << level
    return level, -(-(n - stride // 2) // stride)


def select_grid(n: int, sms: int) -> int:
    """Blocks of a K6 launch over `n` rows: four tiles of 1024 rows a
    block at least, at most two blocks per SM. Every pass of one launch
    shares it, so its order depends on n and the card alone."""
    return max(1, min(2 * sms, _cdiv(n, 4 * BLOCK_THREADS)))


def hist16_select_plain(
    x: torch.Tensor, live: torch.Tensor, counts: torch.Tensor, cap: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """hist16_select in PyTorch: the bins of float32(x) where `live`
    (`f32_sortable_bin16_plain`), every row of a bin that owns a rank
    (the two zero bins together), a stable sort of those rows and the
    ranks read off it."""
    c = counts.to(torch.int64).clone()
    c[SELECT_VALUE_BINS:] = 0
    n = int(c.sum())
    level, kept = decimation(n, cap)
    sample = torch.zeros(cap, dtype=torch.float64, device=x.device)
    if kept:
        stride = 1 << level
        ranks = stride // 2 + stride * torch.arange(kept, device=x.device)
        cum = torch.cumsum(c, 0)
        bins_of_rank = torch.searchsorted(cum, ranks, right=True)
        wanted = torch.zeros(HIST_BINS, dtype=torch.bool, device=x.device)
        wanted[bins_of_rank] = True
        # -0.0 and +0.0 are equal values in adjacent bins: take both, so
        # the stable sort leaves zeros in row order, as a stable sort of
        # the whole batch does
        zero_bins = list(ZERO_BINS)
        wanted[zero_bins] = bool(wanted[zero_bins].any())
        bins = f32_sortable_bin16_plain(x.to(torch.float32), live).long()
        gathered = torch.sort(x.to(torch.float64)[wanted[bins]], stable=True).values
        # a rank's place among the wanted rows: less the unwanted rows below its bin
        below = torch.cumsum(torch.where(wanted, 0, c), 0) - torch.where(wanted, 0, c)
        sample[:kept] = gathered[ranks - below[bins_of_rank]]
    as_f64 = functools.partial(torch.tensor, dtype=torch.float64, device=x.device)
    return sample, as_f64(float(n)), as_f64(float(level))


def hist16_select(
    x: torch.Tensor, live: torch.Tensor, counts: torch.Tensor, cap: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A quantile sketch's decimated sample of x (float64) where `live`,
    from `counts`, hist16's histogram of the same rows: the values at
    ranks stride // 2 + stride * j of a stable sort of the live values
    (`decimation(n, cap)`), -0.0 and +0.0 in row order. Returns (sample:
    `cap` float64, zero past the kept ranks; n; level), n and level as
    0-d float64, all on x's device, with no host sync."""
    _check_pair(x, live, (torch.float64,))
    _check_1d("counts", counts, (torch.int32,))
    if counts.numel() != HIST_BINS or counts.device != x.device:
        raise ValueError(f"counts must be hist16's {HIST_BINS} bins on {x.device}")
    if cap < 1:
        raise ValueError(f"cap must be positive, got {cap}")
    if x.numel() > HIST_MAX_ROWS:
        raise ValueError(f"hist16_select takes at most {HIST_MAX_ROWS} rows a call")
    if x.device.type == "cpu":
        return hist16_select_plain(x, live, counts, cap)
    _require_cuda(x)
    from deequ_tpu_torch.ops import cuda_build

    lib = cuda_build.load()
    n = x.numel()
    grid = select_grid(n, sm_count(x.device))
    scratch = torch.empty(lib.dq_hist16_select_scratch(n, cap, grid), dtype=torch.uint8,
                          device=x.device)
    sample = torch.empty(cap, dtype=torch.float64, device=x.device)
    stats = torch.empty(2, dtype=torch.float64, device=x.device)  # n, level
    err = lib.dq_hist16_select(
        x.data_ptr(), live.data_ptr(), n, counts.data_ptr(), cap, grid,
        scratch.data_ptr(), sample.data_ptr(), stats.data_ptr(), _stream(x),
    )
    _raise_on(err, "hist16_select")
    count_launch(hist16_select)
    return sample, stats[0], stats[1]


hist16_select.launches = 0

# ---------------------------------------------------------------------------
# K5: a dictionary's strings classified and hashed, gathered to rows
# ---------------------------------------------------------------------------

# ops/strings.py's length buckets: a string of at most STRINGS_CAP code
# points hashes at the smallest bucket width that holds it; a longer one
# hashes in chunks of STRINGS_CAP, each chunk's hash seeding the next.
STRINGS_BUCKETS = strings._LENGTH_BUCKETS
STRINGS_CAP = strings._BUCKET_CAP
_LONE_TERMINATORS = (0x0D, 0x85, 0x2028, 0x2029)  # stripped alone; \n also after \r


def _signed64(u) -> int:
    """A uint64 constant as the int64 with its bits: the plain version
    does the hash's modular arithmetic in int64, which wraps alike."""
    u = int(u)
    return u - (1 << 64) if u >= 1 << 63 else u


_P1, _P2, _P3, _P4, _P5 = (
    _signed64(p) for p in (hll._PRIME1, hll._PRIME2, hll._PRIME3, hll._PRIME4, hll._PRIME5)
)


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits by 1 <= s <= 63."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _lsr(x, 64 - r)


def _mix(acc: torch.Tensor, word) -> torch.Tensor:
    """One round of strings.hash_strings over a word of two code points."""
    k = _rotl(word * _P2, 31) * _P1
    return _rotl(acc ^ k, 27) * _P1 + _P4


def _avalanche(acc: torch.Tensor) -> torch.Tensor:
    acc = acc ^ _lsr(acc, 33)
    acc = acc * _P2
    acc = acc ^ _lsr(acc, 29)
    acc = acc * _P3
    return acc ^ _lsr(acc, 32)


def _code_points(offsets: torch.Tensor, data: torch.Tensor):
    """The dictionary's UTF-8 decoded as K5 decodes it: every byte that is
    not a continuation byte starts one code point, which takes up to the
    continuation bytes its lead announces, within its entry. Returns
    (code points, their entry, their index in it, code points per entry),
    int64."""
    off = offsets.to(torch.int64)
    n = off.numel() - 1
    b = data.to(torch.int64)
    pos = torch.arange(b.numel(), device=b.device)
    entry = torch.searchsorted(off, pos, right=True) - 1
    inside = (entry >= 0) & (entry < n)
    end = off[1:][entry.clamp(0, n - 1)]
    cont = (b & 0xC0) == 0x80
    more = torch.where(b < 0xC0, 0, torch.where(b < 0xE0, 1, torch.where(b < 0xF0, 2, 3)))
    more = torch.where(b >= 0xF8, 0, more)
    cp = torch.where(b < 0xF8, b & 0x07, b)
    cp = torch.where(b < 0xF0, b & 0x0F, cp)
    cp = torch.where(b < 0xE0, b & 0x1F, cp)
    cp = torch.where(b < 0x80, b, cp)
    b_pad = F.pad(b, (0, 3))
    cont_pad = F.pad(cont, (0, 3))
    taking = torch.ones_like(cont)
    for q in (1, 2, 3):
        taking = taking & (more >= q) & (pos + q < end) & cont_pad[q:q + b.numel()]
        cp = torch.where(taking, (cp << 6) | (b_pad[q:q + b.numel()] & 0x3F), cp)
    lead = inside & ~cont
    cps, ent = cp[lead], entry[lead]
    length = torch.bincount(ent, minlength=n)
    first = torch.cumsum(length, 0) - length
    k = torch.arange(cps.numel(), device=b.device) - first[ent]
    return cps, ent, k, length


def _chunk_hashes(cps, ent, k, ids, n: int, width: int, seeds: torch.Tensor) -> torch.Tensor:
    """strings' `_hash_bucket` of one chunk of each entry in `ids`, of n:
    the code points `cps` of entries `ent` at index `k` from the chunk's
    start, `width` code points wide, each entry with its seed."""
    row = torch.full((n,), -1, dtype=torch.int64, device=cps.device)
    row[ids] = torch.arange(ids.numel(), device=cps.device)
    mine = row[ent] >= 0
    r, kk, v = row[ent[mine]], k[mine], cps[mine]
    half = width // 2
    words = torch.zeros(ids.numel() * half, dtype=torch.int64, device=cps.device)
    low = kk % 2 == 0
    words[r[low] * half + kk[low] // 2] = v[low]
    at = r[~low] * half + kk[~low] // 2
    words[at] = words[at] | (v[~low] << 32)
    nonzero = torch.bincount(r[v != 0], minlength=ids.numel())
    acc = seeds + _P5 + nonzero * _P2
    words = words.view(ids.numel(), half)
    for j in range(half):
        acc = _mix(acc, words[:, j])
    return _avalanche(acc)


def _entry_hashes(cps, ent, k, length, seed: int) -> torch.Tensor:
    """strings.hash_strings of every entry, as int64 bits."""
    n = length.numel()
    dev = length.device
    hashes = torch.zeros(n, dtype=torch.int64, device=dev)
    width = torch.full_like(length, STRINGS_BUCKETS[0])
    for cap in STRINGS_BUCKETS[1:]:
        width = torch.where(length > cap // 2, cap, width)
    for cap in STRINGS_BUCKETS:
        ids = torch.nonzero((length <= STRINGS_CAP) & (width == cap)).flatten()
        if ids.numel():
            seeds = torch.full((ids.numel(),), _signed64(seed), dtype=torch.int64, device=dev)
            hashes[ids] = _chunk_hashes(cps, ent, k, ids, n, cap, seeds)
    long_ids = torch.nonzero(length > STRINGS_CAP).flatten()
    if long_ids.numel():
        # over the cap: 128-code-point chunks, each hash the next one's seed
        acc = torch.full((long_ids.numel(),), _signed64(seed), dtype=torch.int64, device=dev)
        chunks = (length[long_ids] + STRINGS_CAP - 1) // STRINGS_CAP
        chunk = k // STRINGS_CAP
        for c in range(int(chunks.max())):
            live = chunks > c
            ids = long_ids[live]
            mine = chunk == c
            acc[live] = _chunk_hashes(
                cps[mine], ent[mine], k[mine] - c * STRINGS_CAP, ids, n, STRINGS_CAP, acc[live]
            )
        hashes[long_ids] = acc
    return hashes


def _entry_classes(cps, ent, k, length) -> torch.Tensor:
    """strings.classify of every entry (int8 class codes): within the cap,
    trailing NULs fall away before one final Java line terminator is
    stripped, as `_classify_bucket` does; past it, the terminator alone,
    as `_classify_scalar` does."""
    n = length.numel()
    dev = length.device
    first = torch.cumsum(length, 0) - length
    last = max(cps.numel() - 1, 0)

    def at(index, valid):
        if cps.numel() == 0:
            return torch.zeros(n, dtype=torch.int64, device=dev)
        got = cps[(first + index.clamp(min=0)).clamp(max=last)]
        return torch.where(valid, got, 0)

    nz = cps != 0
    last_nz = torch.zeros(n, dtype=torch.int64, device=dev).scatter_reduce(
        0, ent[nz], k[nz] + 1, "amax"
    )
    capped = length <= STRINGS_CAP
    base = torch.where(capped, last_nz, length)
    l1 = at(base - 1, base >= 1)
    l2 = at(base - 2, base >= 2)
    newline = (base > 0) & (l1 == 0x0A)
    lone = (base > 0) & ~newline & torch.isin(l1, torch.tensor(_LONE_TERMINATORS, device=dev))
    body = base - newline.long() - (newline & (l2 == 0x0D)).long() - lone.long()
    c0 = at(torch.zeros_like(length), length >= 1)
    c1 = at(torch.ones_like(length), length >= 2)
    sign = (c0 == ord("+")) | (c0 == ord("-"))
    start = sign.long() + (torch.where(sign, c1, c0) == ord(" ")).long()
    counted = k >= start[ent]
    digit = (cps >= ord("0")) & (cps <= ord("9"))
    dot = cps == ord(".")
    # every code point past the body is a NUL or a terminator: not a
    # digit or a dot, so the body's count is the whole count less them
    bad = torch.bincount(ent[counted & ~digit & ~dot], minlength=n) - (length - body)
    dots = torch.bincount(ent[counted & dot], minlength=n)
    boolean = torch.zeros(n, dtype=torch.bool, device=dev)
    for literal in ("true", "false"):
        hit = body == len(literal)
        for j, ch in enumerate(literal):
            hit = hit & (at(torch.full_like(length, j), length > j) == ord(ch))
        boolean = boolean | hit
    out = torch.full((n,), strings.CODE_STRING, dtype=torch.int8, device=dev)
    out[boolean] = strings.CODE_BOOLEAN
    out[(bad == 0) & (dots == 0)] = strings.CODE_INTEGRAL
    out[(bad == 0) & (dots == 1)] = strings.CODE_FRACTIONAL
    return out


def _packed_registers(hashes: torch.Tensor) -> torch.Tensor:
    """hll.registers_from_hashes packed as `idx << 6 | rank` (int32):
    rank is 1 + the leading zeros of the hash shifted past the index,
    with bit P - 1 set, so it never passes 64 - P + 1."""
    idx = _lsr(hashes, 64 - hll.P)
    x = (hashes << hll.P) | (1 << (hll.P - 1))
    zeros = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        empty = _lsr(x, 64 - s) == 0
        zeros = zeros + torch.where(empty, s, 0)
        x = torch.where(empty, x << s, x)
    return ((idx << 6) | (zeros + 1)).to(torch.int32)


def classify_hash_dictionary_plain(
    offsets: torch.Tensor, data: torch.Tensor, codes: torch.Tensor, seed: int = HLL_SEED
) -> Tuple[torch.Tensor, torch.Tensor]:
    """classify_hash_dictionary in PyTorch: each of the n strings
    data[offsets[i]:offsets[i + 1]] gets the class of strings.classify
    (int8) and the `idx << 6 | rank` of
    hll.registers_from_hashes(strings.hash_strings(..., seed)) (int32),
    gathered to the rows through `codes`; a code outside the dictionary
    (-1, a null row) gives CODE_NULL and 0."""
    n = offsets.numel() - 1
    live = (codes >= 0) & (codes < n)
    if n <= 0:
        return (torch.full_like(codes, strings.CODE_NULL, dtype=torch.int8),
                torch.zeros_like(codes, dtype=torch.int32))
    cps, ent, k, length = _code_points(offsets, data)
    classes = _entry_classes(cps, ent, k, length)
    packed = _packed_registers(_entry_hashes(cps, ent, k, length, seed))
    idx = torch.where(live, codes, 0).long()
    return (
        torch.where(live, classes[idx], strings.CODE_NULL).to(torch.int8),
        torch.where(live, packed[idx], 0).to(torch.int32),
    )


def classify_hash_dictionary(
    offsets: torch.Tensor, data: torch.Tensor, codes: torch.Tensor, seed: int = HLL_SEED
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DataType's class code (int8) and ApproxCountDistinct's packed HLL
    code (int32) of each row of a dictionary-coded string column: the
    dictionary's n strings are data[offsets[i]:offsets[i + 1]] (int64
    offsets, UTF-8 bytes), each row's entry is its int32 code, and a code
    of -1 (a null row) gives CODE_NULL and 0. The same codes as
    strings.classify and hll.registers_from_hashes(strings.hash_strings)
    on the host."""
    _check_1d("offsets", offsets, (torch.int64,))
    _check_1d("data", data, (torch.uint8,))
    _check_1d("codes", codes, (torch.int32,))
    if offsets.numel() < 1:
        raise ValueError("offsets must hold n + 1 >= 1 entries")
    if not offsets.device == data.device == codes.device:
        raise ValueError(
            f"offsets on {offsets.device}, data on {data.device} and codes on "
            f"{codes.device} must share a device"
        )
    if codes.device.type == "cpu":
        return classify_hash_dictionary_plain(offsets, data, codes, seed)
    _require_cuda(codes)
    from deequ_tpu_torch.ops import cuda_build

    lib = cuda_build.load()
    n, rows = offsets.numel() - 1, codes.numel()
    entry_classes = torch.empty(n, dtype=torch.int8, device=codes.device)
    entry_packed = torch.empty(n, dtype=torch.int32, device=codes.device)
    classes = torch.empty(rows, dtype=torch.int8, device=codes.device)
    packed = torch.empty(rows, dtype=torch.int32, device=codes.device)
    err = lib.dq_dict_strings(
        offsets.data_ptr(), data.data_ptr(), n, seed, codes.data_ptr(), rows,
        entry_classes.data_ptr(), entry_packed.data_ptr(), classes.data_ptr(),
        packed.data_ptr(), _stream(codes),
    )
    _raise_on(err, "classify_hash_dictionary")
    count_launch(classify_hash_dictionary)
    return classes, packed


classify_hash_dictionary.launches = 0

KERNELS = (
    masked_moments, masked_centered_sumsq, hll_register_max, hist16, classify_hash_dictionary,
    hist16_select,
)

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
