"""The encoded fold: analyzer families folded over run streams.

data/native_reader.py's `decode_chunk_runs` turns a dictionary-coded
column chunk the planner approved (ops/fused.py:classify_encfold_columns)
into RunChunk streams — coalesced (run length, dictionary code) value
runs and definition-level runs — without expanding it to rows. This
module takes those streams to the scan's per-batch memo keys:

- `build_payload` slices a batch's rows out of the run streams (rank
  lookups into cumulative sums clip the boundary runs; the C
  `encfold_code_counts` folds the rest) and rolls the dictionary codes up
  to engine values once per batch: the batch's exact value multiset and
  its null count from the definition runs.
- `publish_memos` derives the family memos (moments, decimated quantile
  sample, HLL registers) from that multiset through
  ops/counts_family.family_from_value_counts, the derivation the row
  route's counts shortcut uses on the same multiset: the encoded fold
  gives the row fold's bits by construction.
- `EncFoldStub` stands in for the Column; a reader the plan did not
  foresee (a declined publication) expands it through the row route's
  own `read_chunk` and `assemble_column`, with the same bits.

Publication may always decline (too many distinct values, a corrupt run
slice, a sum it cannot prove exact): the memos stay unset and the stub
expands. It fails closed to the row route, never to wrong values.

The JAX counterpart is deequ_tpu/data/encfold.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from deequ_tpu_torch.data import native_reader as nr
from deequ_tpu_torch.data.table import Column, LazyColumn
from deequ_tpu_torch.ops import native

#: the distinct values below which a batch's SKETCH memos publish: there
#: the row route's counts shortcut provably takes the same batch (its
#: 4096-row sample cannot see more distinct values than the batch holds),
#: so both derive from one multiset through one function. Above it the
#: row route may run the select kernel instead: publication declines
DISTINCT_PUBLISH_CAP = 4000

_WHERE_ALL = "where:<all>"


@dataclass(frozen=True)
class EncFoldColSpec:
    """The planner's verdict for one column, shipped to the source so the
    decode and the publication stay inside what it proved."""

    column: str
    token: str
    #: "i64" | "f64": the counts-family kind of the engine representation
    kind: str
    #: the moments memo may publish with no sketch job on the column:
    #: integer values within +-2^31 by the footer (the kernel's
    #: long-double sum is then exact, equal to the counts route's integer
    #: sum) and no StandardDeviation (its m2 needs the kernel's order);
    #: checked again against each batch's values
    publish_moments: bool


@dataclass
class EncFoldPayload:
    """One column's value multiset over one batch, folded from run
    streams: distinct engine values and their counts (a NaN dictionary
    entry counted as null, as the decode folds NaN rows into the mask),
    with the batch's row and null totals."""

    spec: EncFoldColSpec
    values: np.ndarray  # distinct engine values (int64 or float64)
    counts: np.ndarray  # int64 occurrences, same length
    n_rows: int
    null_count: int
    runs: int  # runs folded
    codes_folded: int  # distinct dictionary codes rolled up


def _cums(rc: nr.RunChunk):
    """Cumulative sums for rank lookups into a RunChunk, made once:
    (rows, nulls, non-null values)."""
    cached = getattr(rc, "_encfold_cums", None)
    if cached is None:
        cached = (
            np.cumsum(rc.def_len),
            np.cumsum(rc.def_len * (rc.def_val == 0)),
            np.cumsum(rc.run_len),
        )
        rc._encfold_cums = cached
    return cached


def _nulls_before(rc: nr.RunChunk, row: int) -> int:
    """Nulls among the chunk's first `row` rows, from the definition runs
    alone."""
    if row <= 0:
        return 0
    def_cum, null_cum, _ = _cums(rc)
    i = int(np.searchsorted(def_cum, row, side="left"))
    prev_rows = int(def_cum[i - 1]) if i > 0 else 0
    prev_nulls = int(null_cum[i - 1]) if i > 0 else 0
    return prev_nulls + ((row - prev_rows) if rc.def_val[i] == 0 else 0)


def _slice_code_counts(rc: nr.RunChunk, lo: int, hi: int) -> Optional[Tuple[np.ndarray, int, int]]:
    """Chunk rows [lo, hi) as per-code counts: (counts, nulls in range,
    runs folded), or None for a corrupt run."""
    nulls_lo, nulls_hi = _nulls_before(rc, lo), _nulls_before(rc, hi)
    nn_lo, nn_hi = lo - nulls_lo, hi - nulls_hi
    nulls_in_range = (hi - lo) - (nn_hi - nn_lo)
    if nn_hi <= nn_lo:
        return np.zeros(rc.dict_count, dtype=np.int64), nulls_in_range, 0
    _, _, run_cum = _cums(rc)
    i0 = int(np.searchsorted(run_cum, nn_lo, side="right"))
    i1 = int(np.searchsorted(run_cum, nn_hi - 1, side="right"))
    run_len = rc.run_len[i0 : i1 + 1].astype(np.int64, copy=True)
    prev = int(run_cum[i0 - 1]) if i0 > 0 else 0
    run_len[0] -= nn_lo - prev
    run_len[-1] -= int(run_cum[i1]) - nn_hi
    counts = native.encfold_code_counts(run_len, rc.run_code[i0 : i1 + 1], rc.dict_count)
    if counts is None:
        return None
    return counts, nulls_in_range, len(run_len)


def build_payload(
    spec: EncFoldColSpec, segments: List[nr.RunChunk], start: int, stop: int
) -> Optional[EncFoldPayload]:
    """Rows [start, stop) of the run segments as the batch's value
    multiset, the codes rolled up to values once per chunk. None when a
    slice fails its checks or the multiset disagrees with the definition
    runs' null count (the stub then expands)."""
    parts_v: List[np.ndarray] = []
    parts_c: List[np.ndarray] = []
    null_count = runs = 0
    for rc, lo, hi in nr._segment_overlaps(segments, start, stop):
        sliced = _slice_code_counts(rc, lo, hi)
        if sliced is None:
            return None
        counts, seg_nulls, seg_runs = sliced
        null_count += seg_nulls
        runs += seg_runs
        nz = np.flatnonzero(counts)
        if len(nz):
            parts_v.append(rc.dict_values[nz])
            parts_c.append(counts[nz])
    n_rows = stop - start
    if parts_v:
        allv, allc = np.concatenate(parts_v), np.concatenate(parts_c)
        # merged by bit pattern: chunks have their own dictionaries, and a
        # wrapped dictionary may map two codes to one engine value
        keys, inverse = np.unique(allv.view(np.uint64), return_inverse=True)
        counts = np.zeros(len(keys), dtype=np.int64)
        np.add.at(counts, inverse, allc)
        values = keys.view(allv.dtype)
        if spec.kind == "f64":
            nan = np.isnan(values)
            if nan.any():
                # NaN rows are nulls in the engine representation
                null_count += int(counts[nan].sum())
                values, counts = values[~nan], counts[~nan]
    else:
        values = np.zeros(0, dtype=np.float64 if spec.kind == "f64" else np.int64)
        counts = np.zeros(0, dtype=np.int64)
    if int(counts.sum()) != n_rows - null_count:
        return None
    return EncFoldPayload(
        spec=spec,
        values=values,
        counts=counts,
        n_rows=n_rows,
        null_count=null_count,
        runs=runs,
        codes_folded=len(values),
    )


def _moments_memo(mom, n_rows: int) -> Dict[str, float]:
    return {
        "count": float(mom[0]),
        "sum": float(mom[1]),
        "min": float(mom[2]),
        "max": float(mom[3]),
        "m2": float(mom[4]),
        "n_where": float(mom[5]),
        "n_rows": float(n_rows),
    }


def publish_memos(built: Dict, payloads: Dict[str, EncFoldPayload], planned) -> int:
    """Publish the family memos of the batch's payloads before the family
    kernels run: a published sample memo skips that column's kernel, and
    its members answer from the memos without building the column.
    Publication declines wherever the row route's bits are not proven for
    this batch. Returns the number of columns published."""
    from deequ_tpu_torch.ops import counts_family

    published = set()
    covered = set()
    for pj in planned:
        payload = payloads.get(pj.column)
        if payload is None or pj.where is not None:
            continue
        covered.add(pj.column)
        if pj.qkey in built or len(payload.values) > DISTINCT_PUBLISH_CAP:
            continue
        mom, sample, n_valid, level, regs = counts_family.family_from_value_counts(
            payload.values, payload.counts, payload.spec.kind, pj.cap, payload.n_rows, pj.want_regs
        )
        built[pj.qkey] = {"sample": sample, "n": int(n_valid), "level": int(level)}
        if regs is not None:
            built[pj.rkey] = regs
        if pj.mkey not in built:
            built[pj.mkey] = _moments_memo(mom, payload.n_rows)
        published.add(pj.column)
    for column, payload in payloads.items():
        # moments only, for a column with no sketch job: the row route runs
        # the sequential moments kernel, so the planner's exact-sum proof
        # is checked again on the values (|v| < 2^31 keeps the kernel's
        # long-double sum exact and equal to the integer sum)
        if column in covered or not payload.spec.publish_moments or payload.spec.kind != "i64":
            continue
        if len(payload.values) and (
            int(payload.values.min()) <= -(1 << 31) or int(payload.values.max()) >= (1 << 31)
        ):
            continue
        # the numpy moments route sums pairwise in float64: with Σ|v| < 2^53
        # every partial sum is an exact integer, and so is its total
        if payload.n_rows >= (1 << 32):
            continue
        if len(payload.values) and int(np.dot(payload.counts, np.abs(payload.values))) >= (1 << 53):
            continue
        mkey = f"__moments:{column}:{_WHERE_ALL}"
        if mkey in built:
            continue
        mom = counts_family.family_from_value_counts(
            payload.values, payload.counts, payload.spec.kind, 4096, payload.n_rows, False
        )[0]
        built[mkey] = _moments_memo(mom, payload.n_rows)
        published.add(column)
    return len(published)


class EncFoldStub(LazyColumn):
    """The Column of an encoded-fold column: the readers the planner
    proved are served by the memos never touch it; another reader (a
    declined publication) expands the kept RunChunks through the row
    route's `read_chunk` and `assemble_column`, with the same bits. Its
    mask comes from the definition runs alone where that is exact."""

    def __init__(self, name, ctype, token, run_segments, start, stop):
        self._enc_token = token
        self._enc_segments = run_segments
        self._enc_start = int(start)
        super().__init__(name, ctype, stop - start)

    def _rebuild(self) -> Column:
        segs = []
        for rc in self._enc_segments:
            dc = getattr(rc, "_encfold_expanded", None)
            if dc is None:
                dc = nr.expand_runs(rc)
                if dc is None:
                    raise RuntimeError(
                        f"encoded-fold column {self.name!r}: a chunk that decoded to "
                        "runs did not decode at row width"
                    )
                rc._encfold_expanded = dc
            segs.append(dc)
        return nr.assemble_column(
            self.name, self._enc_token, segs, self._enc_start, self._enc_start + len(self), {}
        )

    def _quick_valid(self) -> Optional[np.ndarray]:
        """Exact for integers; a float column with a NaN dictionary entry
        rebuilds instead (the decode folds NaN rows into the mask)."""
        for rc in self._enc_segments:
            if rc.kind == "f64" and np.isnan(rc.dict_values).any():
                return None
        out = np.empty(len(self), dtype=np.bool_)
        pos = 0
        stop = self._enc_start + len(self)
        for rc, lo, hi in nr._segment_overlaps(self._enc_segments, self._enc_start, stop):
            out[pos : pos + (hi - lo)] = np.repeat(rc.def_val.astype(np.bool_), rc.def_len)[lo:hi]
            pos += hi - lo
        return out
