"""Vectorized host-side string hashing for the HLL sketch.

Strings never reach the device: a string column is dictionary-encoded
once per table and only its unique values are hashed, vectorized over
the UCS4 code-point matrix of the uniques (a numpy 'U' array viewed as
an (n_unique, max_len) uint32 matrix) — never a Python loop over rows.
"""

from __future__ import annotations

import numpy as np

from deequ_tpu_torch.ops.sketches.hll import (
    _PRIME1 as _P1,
    _PRIME2 as _P2,
    _PRIME3 as _P3,
    _PRIME4 as _P4,
    _PRIME5 as _P5,
    _rotl,
)


def to_codepoint_matrix(uniques: np.ndarray) -> np.ndarray:
    """'U'-dtype array -> (n, max_len) uint32 code points, 0-padded."""
    if uniques.dtype.kind != "U":
        uniques = uniques.astype("U")
    n = len(uniques)
    width = uniques.dtype.itemsize // 4
    if n == 0 or width == 0:
        return np.zeros((n, max(width, 1)), dtype=np.uint32)
    return np.ascontiguousarray(uniques).view(np.uint32).reshape(n, width)


# One long outlier value must not widen the matrix for every unique (an
# (n x max_len) buffer is O(n * longest string)): values are bucketed by
# length and each bucket gets a matrix of its own width; values longer
# than _BUCKET_CAP take a per-value scalar fallback (rare by construction).
_LENGTH_BUCKETS = (8, 16, 32, 64, 128)
_BUCKET_CAP = _LENGTH_BUCKETS[-1]


def _by_length_buckets(uniques: np.ndarray, vectorized, scalar_fallback, out_dtype):
    """Apply `vectorized(sub_uniques_U)` per length bucket and
    `scalar_fallback(python_str)` to over-cap outliers; scatter results
    back into one array aligned with `uniques`."""
    as_obj = uniques if uniques.dtype == object else uniques.astype(object)
    lengths = np.array([len(s) for s in as_obj], dtype=np.int64)
    out = np.zeros(len(uniques), dtype=out_dtype)
    lo = 0
    for cap in _LENGTH_BUCKETS:
        sel = (lengths > lo) | ((lengths == 0) if lo == 0 else False)
        sel &= lengths <= cap
        if sel.any():
            out[sel] = vectorized(as_obj[sel].astype(f"U{cap}"))
        lo = cap
    big = lengths > _BUCKET_CAP
    if big.any():
        for i in np.nonzero(big)[0]:
            out[i] = scalar_fallback(str(as_obj[i]))
    return out


def hash_strings(uniques: np.ndarray, seed: int = 42) -> np.ndarray:
    """Vectorized 64-bit hash of each unique string: xxhash-style mixing
    rounds over the code-point matrix viewed as uint64 words. Bucketing by
    length makes a string's hash depend only on the string itself."""
    if len(uniques) == 0:
        return np.zeros(0, dtype=np.uint64)
    return _by_length_buckets(
        uniques,
        lambda sub: _hash_bucket(sub, seed),
        lambda s: _hash_scalar(s, seed),
        np.uint64,
    )


def _hash_scalar(value: str, seed: int) -> np.uint64:
    """Over-cap outliers: hash 128-codepoint chunks through the bucket
    hash, chaining the seed — deterministic and length-independent."""
    acc = np.uint64(seed)
    for i in range(0, len(value), _BUCKET_CAP):
        chunk = np.array([value[i : i + _BUCKET_CAP]], dtype=f"U{_BUCKET_CAP}")
        acc = _hash_bucket(chunk, int(acc))[0]
    return acc


def _hash_bucket(uniques: np.ndarray, seed: int) -> np.ndarray:
    cm = to_codepoint_matrix(uniques)
    n, width = cm.shape
    if width % 2:
        cm = np.concatenate([cm, np.zeros((n, 1), dtype=np.uint32)], axis=1)
        width += 1
    words = np.ascontiguousarray(cm).view(np.uint64)  # (n, width//2)
    lengths = (cm != 0).sum(axis=1).astype(np.uint64)

    with np.errstate(over="ignore"):
        acc = np.uint64(seed) + _P5 + lengths * _P2
        for j in range(words.shape[1]):
            k = _rotl(words[:, j] * _P2, 31) * _P1
            acc = _rotl(acc ^ k, 27) * _P1 + _P4
        acc ^= acc >> np.uint64(33)
        acc *= _P2
        acc ^= acc >> np.uint64(29)
        acc *= _P3
        acc ^= acc >> np.uint64(32)
    return acc
