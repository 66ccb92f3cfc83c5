"""Row-group statistics records: what a Parquet footer says about each
column chunk, as pure data (`ParquetSource.row_group_stats` is the one
reader). The decode planner's encoded-fold verdict and the wire
planner's int-width pinning read them (ops/fused.py); the JAX package's
pruning interpreter over them (deequ_tpu/lint/pushdown.py) comes with the
platform services.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Tuple


@dataclass(frozen=True)
class ColumnStats:
    """One column chunk's statistics. None = the writer did not record it
    (or recorded it unusably): a verdict then degrades to unknown, never
    to wrong."""

    min_value: Optional[object] = None
    max_value: Optional[object] = None
    null_count: Optional[int] = None
    physical_type: Optional[str] = None
    codec: Optional[str] = None
    encodings: Optional[Tuple[str, ...]] = None
    chunk_offset: Optional[int] = None
    chunk_bytes: Optional[int] = None
    num_values: Optional[int] = None
    max_def_level: Optional[int] = None
    max_rep_level: Optional[int] = None
    #: page placement: a chunk with no dictionary page before its data
    #: pages cannot be all-dictionary-coded
    data_page_offset: Optional[int] = None
    dictionary_page_offset: Optional[int] = None


@dataclass(frozen=True)
class RowGroupStats:
    index: int
    num_rows: int
    columns: Mapping[str, ColumnStats]
