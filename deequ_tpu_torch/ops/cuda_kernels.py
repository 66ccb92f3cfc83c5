"""CUDA kernels of the fused pass, each beside its plain PyTorch version.

The counterpart of `deequ_tpu/ops/pallas_kernels.py`. Each wrapper takes
the plain version for a tensor on the CPU, and for a CUDA tensor launches
its hand-written kernel (`csrc/kernels.cu`, built by `cuda_build`) or
raises. There is no shape gate and no fallback: the kernels take any
length, 0 and ragged tails included.

Each wrapper counts its kernel launches in a plain integer attribute
(`masked_moments.launches`, ...), so a run can show that its main path
went through the kernels; `reset_launch_counts()` zeroes them.

| wrapper               | replaces (deequ_tpu/ops/pallas_kernels.py) |
|-----------------------|--------------------------------------------|
| masked_moments        | masked_moments (:231)                      |
| masked_centered_sumsq | masked_centered_sumsq (:269)               |
| hll_register_max      | hll_register_max (:58)                     |
"""

from __future__ import annotations

from typing import Dict

import torch

N_REGISTERS = 512  # HLL++ p = 9 (ops/sketches/hll.M)
# Partial slots per reduction: 8 blocks of 256 threads on each of the
# H100's 132 SMs. A constant, so the grid — and with it the summation
# order — depends on the row count alone.
MAX_BLOCKS = 8 * 132
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
    out = torch.empty(4, dtype=torch.float64, device=x.device)
    scratch = torch.empty(4 * MAX_BLOCKS, dtype=torch.float64, device=x.device)
    err = lib.dq_masked_moments(
        x.data_ptr(), int(x.dtype == torch.float32), m.data_ptr(), x.numel(),
        scratch.data_ptr(), MAX_BLOCKS, out.data_ptr(), _stream(x),
    )
    _raise_on(err, "masked_moments")
    masked_moments.launches += 1
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
    avg = avg.contiguous()
    out = torch.empty((), dtype=torch.float64, device=x.device)
    scratch = torch.empty(MAX_BLOCKS, dtype=torch.float64, device=x.device)
    err = lib.dq_centered_sumsq(
        x.data_ptr(), int(x.dtype == torch.float32), m.data_ptr(), x.numel(),
        avg.data_ptr(), scratch.data_ptr(), MAX_BLOCKS, out.data_ptr(), _stream(x),
    )
    _raise_on(err, "masked_centered_sumsq")
    masked_centered_sumsq.launches += 1
    return out


masked_centered_sumsq.launches = 0


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
    out = torch.zeros(N_REGISTERS, dtype=torch.int32, device=codes.device)
    err = lib.dq_hll_register_max(
        codes.data_ptr(), m.data_ptr(), codes.numel(), MAX_BLOCKS,
        out.data_ptr(), _stream(codes),
    )
    _raise_on(err, "hll_register_max")
    hll_register_max.launches += 1
    return out


hll_register_max.launches = 0

KERNELS = (masked_moments, masked_centered_sumsq, hll_register_max)


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
