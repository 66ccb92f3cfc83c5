"""Counts-based family fast path: moments, the decimated quantile sample
and HLL registers of a column, derived from its distinct (value, count)
pairs.

The family kernel (`native.masked_moments_select`) pays ~10 ns/row for a
(column, where) family's moments, decimated sample and registers. A
column with few distinct values (quantities, codes, flags, rates, and
every numeric-looking string column's dictionary) needs no per-row pass
for those: ONE counting pass captures the value distribution, and every
output derives from the counts in O(#distinct):

- moments: weighted sums over the distinct values (an exact integer sum
  for integers, a long-double dot for floats);
- the decimated sample: the per-row contract is
  ``sorted(x[mask])[stride/2::stride][:kept]``, and rank lookups into
  the cumulative counts give exactly those order statistics;
- HLL registers: a register is a max over the ranks of the values it
  sees, so hashing each DISTINCT value once gives the registers hashing
  every row gives;
- the level: ``while (cap << level) < m: level += 1``, the C kernel's law.

The counts come from a dense windowed count of an int64 column
(`counts_for_column`: the window is guessed from three 4096-row probes,
and a miss stops the C pass at the first value outside it), from the C
open-addressing counter for floats and sparse integers
(`hash_counts_for_column`), from a dictionary (`_LowCardCounts` in
profiles/internal_analyzers.py), or from the encoded fold's run streams
(data/encfold.py). The JAX counterpart is deequ_tpu/ops/counts_family.py.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

WINDOW = 1 << 16
_PROBE = 4096
_MARGIN = 4096
_SIGN = np.uint64(1) << np.uint64(63)


def enabled() -> bool:
    """``DEEQU_TPU_NO_COUNTS_FASTPATH`` (any value) turns the counts
    routes off: every family then takes its per-row kernel."""
    return not os.environ.get("DEEQU_TPU_NO_COUNTS_FASTPATH")


def _probe_range(values: np.ndarray, valid: Optional[np.ndarray]) -> Optional[Tuple[int, int]]:
    """(min, max) of the valid values in three 4096-row slices (head,
    middle, tail); None when every probed row is null."""
    n = len(values)
    segments = ((0, _PROBE), (n // 2, n // 2 + _PROBE), (max(0, n - _PROBE), n))
    vmin: Optional[int] = None
    vmax: Optional[int] = None
    for a, b in segments:
        v = values[a:b]
        if valid is not None:
            v = v[valid[a:b]]
        if len(v) == 0:
            continue
        lo, hi = int(v.min()), int(v.max())
        vmin = lo if vmin is None else min(vmin, lo)
        vmax = hi if vmax is None else max(vmax, hi)
    if vmin is None or vmax is None:
        return None
    return vmin, vmax


def counts_for_column(
    values: np.ndarray, valid: Optional[np.ndarray], where: Optional[np.ndarray]
) -> Optional[Tuple[np.ndarray, int, int, int]]:
    """(counts[WINDOW], lo, n_valid, n_where) of an int64 column whose live
    values fit a WINDOW-wide range guessed from the probes; None when the
    column is not int64, the probes span too wide, the library is off, or
    a value fell outside the window."""
    from deequ_tpu_torch.ops import native

    if values.dtype != np.int64 or len(values) == 0:
        return None
    probed = _probe_range(values, valid)
    if probed is None:
        return None
    vmin, vmax = probed
    span = vmax - vmin
    if span >= WINDOW - 2 * _MARGIN:
        return None
    # the window centred on the probed range, clamped inside int64
    lo = vmin - (WINDOW - span) // 2
    lo = max(-(1 << 63), min(lo, (1 << 63) - WINDOW))
    res = native.bincount_window(values, valid, where, lo, WINDOW)
    if res is None:
        return None
    counts, n_valid, n_where = res
    return counts, lo, n_valid, n_where


def hash_counts_for_column(
    values: np.ndarray, valid: Optional[np.ndarray], where: Optional[np.ndarray]
):
    """(distinct keys as uint64, counts, n_valid, n_where) from the C
    open-addressing counter, for a float64 column (keys are bit patterns)
    or an int64 one (keys are values); None when the library is off or
    the column holds more than 65,536 distinct values."""
    from deequ_tpu_torch.ops import native

    if values.dtype not in (np.float64, np.int64) or len(values) == 0:
        return None
    return native.hashcount(values.view(np.uint64), valid, where)


def weighted_moments_and_sample(
    values_sorted: np.ndarray,
    counts_sorted: np.ndarray,
    cap: int,
    exact_sum: Optional[int] = None,
):
    """From value-SORTED (distinct value, count) pairs: ((count, sum, min,
    max, m2), the decimated sample, the number of values, the level).
    `exact_sum` is an exactly computed total (the integer routes); else
    the sum is the weighted long-double dot."""
    cs = counts_sorted
    vs = values_sorted
    m = int(cs.sum())
    if m == 0:
        return (
            (0.0, 0.0, float("inf"), float("-inf"), 0.0),
            np.zeros(0, dtype=np.float64),
            0,
            0,
        )
    if exact_sum is not None:
        sum_d = float(exact_sum)
    else:
        sum_d = float(np.dot(cs.astype(np.longdouble), vs))
    avg = sum_d / m
    with np.errstate(over="ignore"):
        # d*d squares in float64 on purpose, as the JAX package does
        d = vs - avg
        m2 = float(np.dot(cs.astype(np.longdouble), (d * d).astype(np.longdouble)))
    level = 0
    while (cap << level) < m:
        level += 1
    stride = 1 << level
    offset = stride >> 1
    kept = max(0, (m - offset + stride - 1) // stride)
    if kept:
        ranks = offset + stride * np.arange(kept, dtype=np.int64)
        positions = np.searchsorted(np.cumsum(cs), ranks, side="right")
        sample = vs[positions]
    else:
        sample = np.zeros(0, dtype=np.float64)
    return (float(m), sum_d, float(vs[0]), float(vs[-1]), m2), sample, m, level


def _exact_int_sum(counts: np.ndarray, ints: np.ndarray) -> int:
    """Σ count·value exactly: an int64 dot while |value| < 2^31 keeps
    every product and the total inside int64, Python ints beyond."""
    if not len(ints):
        return 0
    amax = max(abs(int(ints[0])), abs(int(ints[-1])))
    if amax < (1 << 31):
        return int(np.dot(counts, ints))
    return sum(int(c) * int(v) for c, v in zip(counts, ints))


def _registers_of(keys_i64: np.ndarray, want_regs: bool) -> Optional[np.ndarray]:
    """HLL registers of distinct canonical int64 keys (each hashed once),
    or None when not wanted."""
    if not want_regs:
        return None
    from deequ_tpu_torch.ops.sketches import hll

    regs = np.zeros(hll.M, dtype=np.int32)
    if len(keys_i64):
        packed = hll.pack_codes(keys_i64, np.ones(len(keys_i64), dtype=bool))
        np.maximum.at(regs, packed >> 6, (packed & 0x3F).astype(np.int32))
    return regs


def family_from_hash_counts(
    keys_u64: np.ndarray,
    counts: np.ndarray,
    kind: str,
    cap: int,
    n_where: int,
    want_regs: bool,
):
    """The family kernel's outputs (moments6, sample, n_valid, level,
    registers or None) from distinct-key counts. `kind` is "f64" (keys are
    bit patterns, sorted in the kernel's total order: -0.0 before +0.0) or
    "i64" (keys are values)."""
    keys_u64 = np.asarray(keys_u64, dtype=np.uint64)
    counts = np.asarray(counts)
    exact_sum = None
    if kind == "f64":
        order = np.argsort(np.where(keys_u64 >> np.uint64(63), ~keys_u64, keys_u64 | _SIGN))
        vs = keys_u64[order].view(np.float64)
        cs = counts[order]
    else:
        ints = keys_u64.view(np.int64)
        order = np.argsort(ints)
        ints = ints[order]
        vs = ints.astype(np.float64)
        cs = counts[order]
        exact_sum = _exact_int_sum(cs, ints)
    core, sample, m, level = weighted_moments_and_sample(vs, cs, cap, exact_sum=exact_sum)
    mom = np.array(list(core) + [float(n_where)], dtype=np.float64)
    return mom, sample, m, level, _registers_of(keys_u64.view(np.int64), want_regs)


def family_from_value_counts(
    values: np.ndarray,
    counts: np.ndarray,
    kind: str,
    cap: int,
    n_where: int,
    want_regs: bool,
):
    """The family kernel's outputs from distinct (value, count) pairs in
    the engine's representation (int64 for "i64", float64 for "f64"): the
    values read as hash keys, so every rule is the hash route's, and the
    encoded fold derives what the row path's counts route derives."""
    values = np.ascontiguousarray(values)
    return family_from_hash_counts(values.view(np.uint64), counts, kind, cap, n_where, want_regs)


def family_from_counts(counts: np.ndarray, lo: int, cap: int, n_where: int, want_regs: bool):
    """The family kernel's outputs (moments6, sample, n_valid, level,
    registers or None) from a dense counts window starting at `lo`."""
    nz = np.flatnonzero(counts)
    cs = counts[nz]
    ints = (nz + lo).astype(np.int64)
    vs = ints.astype(np.float64)
    total = _exact_int_sum(cs, ints) if int(cs.sum()) > 0 else 0
    core, sample, m, level = weighted_moments_and_sample(vs, cs, cap, exact_sum=total)
    mom = np.array(list(core) + [float(n_where)], dtype=np.float64)
    return mom, sample, m, level, _registers_of(ints, want_regs)
