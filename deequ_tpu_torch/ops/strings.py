"""Host-side string work: type classification, hashing for the HLL
sketch, numeric parsing and regex matching.

Strings never reach the device: a string column is dictionary-encoded
once per table and every string operation runs over its unique values
only, then gathers to rows. Hashing is vectorized over the UCS4
code-point matrix of the uniques (a numpy 'U' array viewed as an
(n_unique, max_len) uint32 matrix) — never a Python loop over rows.
"""

from __future__ import annotations

import re
from typing import Tuple

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


# -- type classification ------------------------------------------------------

# class codes, in the order of DataTypeHistogram's fields
CODE_NULL, CODE_FRACTIONAL, CODE_INTEGRAL, CODE_BOOLEAN, CODE_STRING = range(5)

_ZERO, _NINE = ord("0"), ord("9")
_DOT, _PLUS, _MINUS, _SPACE = ord("."), ord("+"), ord("-"), ord(" ")


def classify(uniques: np.ndarray) -> np.ndarray:
    """Vectorized value-type classification, same decision as the
    reference's regexes (reference: catalyst/StatefulDataType.scala:36-38):

        FRACTIONAL  ^(-|\\+)? ?\\d*\\.\\d*$
        INTEGRAL    ^(-|\\+)? ?\\d*$
        BOOLEAN     ^(true|false)$

    checked in that order ('\\d' ASCII-only, like Java's default).
    Returns int32 class codes per unique value.
    """
    if len(uniques) == 0:
        return np.zeros(0, dtype=np.int32)
    return _by_length_buckets(
        uniques, _classify_bucket, _classify_scalar, np.int32
    )


def _classify_scalar(value: str) -> int:
    import re

    body = value
    for term in ("\r\n", "\n", "\r", "", " ", " "):
        if body.endswith(term):
            body = body[: -len(term)]
            break
    if re.fullmatch(r"(-|\+)? ?[0-9]*\.[0-9]*", body):
        return CODE_FRACTIONAL
    if re.fullmatch(r"(-|\+)? ?[0-9]*", body):
        return CODE_INTEGRAL
    if body in ("true", "false"):
        return CODE_BOOLEAN
    return CODE_STRING


def _classify_bucket(uniques: np.ndarray) -> np.ndarray:
    cm = to_codepoint_matrix(uniques)
    n, width = cm.shape
    if n == 0:
        return np.zeros(0, dtype=np.int32)

    length = _effective_lengths(cm)

    first = cm[:, 0]
    has_sign = (first == _PLUS) | (first == _MINUS)
    start = has_sign.astype(np.int64)
    # optional single space right after the (optional) sign
    after_sign = cm[np.arange(n), np.minimum(start, width - 1)]
    start = start + ((after_sign == _SPACE) & (start < width))

    pos = np.arange(width)[None, :]
    in_body = (pos >= start[:, None]) & (pos < length[:, None])
    is_digit = (cm >= _ZERO) & (cm <= _NINE)
    is_dot = cm == _DOT

    body_digits_or_dots = np.all(~in_body | is_digit | is_dot, axis=1)
    n_dots = (is_dot & in_body).sum(axis=1)
    fractional = body_digits_or_dots & (n_dots == 1)
    integral = np.all(~in_body | is_digit, axis=1)
    boolean = _equals_literal(cm, length, "true") | _equals_literal(cm, length, "false")

    out = np.full(n, CODE_STRING, dtype=np.int32)
    out[boolean] = CODE_BOOLEAN
    out[integral] = CODE_INTEGRAL
    out[fractional] = CODE_FRACTIONAL
    return out


# Java's `$` (non-MULTILINE) matches before one FINAL line terminator:
# \n, \r\n, \r, ,  ,   — the reference's regexes run
# under java.util.regex, so a single trailing terminator is outside the
# matched body.
_LONE_TERMS = (0x0D, 0x85, 0x2028, 0x2029)
_NL = 0x0A


def _effective_lengths(cm: np.ndarray) -> np.ndarray:
    n, width = cm.shape
    trailing_zeros = np.cumprod((cm == 0)[:, ::-1], axis=1).sum(axis=1)
    length = width - trailing_zeros
    idx = np.arange(n)
    last = cm[idx, np.maximum(length - 1, 0)] * (length > 0)
    is_nl = last == _NL
    length = length - is_nl
    last2 = cm[idx, np.maximum(length - 1, 0)] * (length > 0)
    strip2 = (is_nl & (last2 == 0x0D)) | (
        ~is_nl & np.isin(last2, _LONE_TERMS)
    )
    return length - strip2


def _equals_literal(cm: np.ndarray, length: np.ndarray, literal: str) -> np.ndarray:
    n, width = cm.shape
    if width < len(literal):
        return np.zeros(n, dtype=bool)
    hit = length == len(literal)
    for j, c in enumerate(literal):
        hit &= cm[:, j] == ord(c)
    return hit


# -- numeric parse and pattern match ------------------------------------------


def parse_floats(uniques: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(float64 values, ok mask) per unique string, through
    `pandas.to_numeric(errors="coerce")` as the JAX package parses: its
    answer, quirks included, is the reference's. "nan" parses to NaN,
    which is NULL under this engine's convention, so its ok is False."""
    if len(uniques) == 0:
        return np.zeros(0, dtype=np.float64), np.zeros(0, dtype=bool)
    import pandas as pd

    parsed = pd.to_numeric(pd.Series(uniques, dtype=object), errors="coerce").to_numpy(
        dtype=np.float64
    )
    ok = ~np.isnan(parsed)
    return np.where(ok, parsed, 0.0), ok


def match_pattern(uniques: np.ndarray, pattern: str) -> np.ndarray:
    """Regex search over unique values (Python re, for lookahead and
    backreferences; the vector win is uniques << rows). Spark semantics:
    regexp_extract(col, regex, 0) != '' — a present but empty match is a
    miss (reference: analyzers/PatternMatch.scala:42-50)."""
    rx = re.compile(pattern)
    out = np.zeros(len(uniques), dtype=bool)
    for i, v in enumerate(uniques):
        m = rx.search(str(v))
        out[i] = m is not None and m.group(0) != ""
    return out
