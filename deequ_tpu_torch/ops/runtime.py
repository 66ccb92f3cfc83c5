"""Execution runtime: the device a run uses, its compute dtype, where
reductions are placed, and the fold-arithmetic tag.

Entry points run on CUDA unless the caller passes ``device="cpu"``. With
no device given and no CUDA device present a run raises: it never moves
to the CPU on its own.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device a run uses: the caller's choice, else ``cuda``. Raises
    when the chosen device is CUDA and no CUDA device is present."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if resolved.index is None:
            resolved = torch.device("cuda", torch.cuda.current_device())
    elif resolved.type != "cpu":
        raise ValueError(f"unsupported device {resolved}; use 'cuda' or 'cpu'")
    return resolved


def compute_dtype() -> torch.dtype:
    """float64 on every device: the H100 folds f64 at memory speed, and
    f64 keeps device partials within the 1e-6 parity bound."""
    return torch.float64


def placement_mode() -> str:
    """Where reductions run. Only ``"device"`` (every analyzer in the
    fused device pass) is ported; ``DEEQU_TPU_PLACEMENT`` naming a
    host-fold placement raises until the host fold is ported."""
    env = os.environ.get("DEEQU_TPU_PLACEMENT", "auto")
    if env in ("auto", "device"):
        return "device"
    if env in ("host", "host-all", "host-discrete"):
        raise NotImplementedError(
            f"DEEQU_TPU_PLACEMENT={env}: the host-fold placements are not ported yet"
        )
    raise ValueError(
        f"DEEQU_TPU_PLACEMENT={env!r}: expected auto, device, host, "
        "host-all or host-discrete"
    )


def fold_variant(device: Optional[torch.device]) -> str:
    """The fold-arithmetic tag a plan signature hashes: "cuda-folds" when
    the moment folds run as CUDA kernels (their summation order differs
    from the plain fold's), "" on the CPU."""
    return "cuda-folds" if device is not None and device.type == "cuda" else ""


def narrow_int_wire(arr: np.ndarray, key: str, sticky: dict) -> np.ndarray:
    """Range-downcast an integer array to the narrowest exact wire dtype.
    `sticky` pins each key's dtype monotonically wider across the batches
    of one pass, so the wire layout does not flap with each batch's range."""
    unsigned = np.issubdtype(arr.dtype, np.unsignedinteger)
    candidates = (
        (np.uint8, np.uint16, np.uint32, np.uint64)
        if unsigned
        else (np.int8, np.int16, np.int32, np.int64)
    )
    chosen = np.dtype(sticky.get(key, candidates[0]))
    if arr.size:
        mn, mx = int(arr.min()), int(arr.max())
        for cand in candidates:
            info = np.iinfo(cand)
            if (
                np.dtype(cand).itemsize >= chosen.itemsize
                and info.min <= mn
                and mx <= info.max
            ):
                chosen = np.dtype(cand)
                break
    chosen = np.dtype(min(chosen, arr.dtype, key=lambda d: np.dtype(d).itemsize))
    sticky[key] = chosen
    return arr.astype(chosen, copy=False)


def wire_pad_size(n: int) -> int:
    """A batch's padded row length on the wire: the next multiple of 8, so
    a bit-packed mask (1 bit per row) decodes to exactly the padded rows.
    (The JAX package pads to a power of two to bound recompiles; eager
    PyTorch compiles nothing, so the port pads only to whole bytes.)"""
    return max(-(-n // 8) * 8, 8)
