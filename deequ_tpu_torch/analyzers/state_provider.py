"""State checkpoint layer: load/persist analyzer states.

reference: analyzers/StateProvider.scala:36-295; the port's own copy of
deequ_tpu/analyzers/state_provider.py, so that both packages write the
same bytes and read each other's files. The filesystem provider
keeps the reference's binary layouts (big-endian, Java DataOutputStream
conventions) per analyzer type, so the *payload* of a state file is
format-compatible where the underlying sketch is. File *naming* defaults
to SHA-1[:16] of repr(analyzer) (this build's stable scheme);
`naming="reference"` switches to the reference's
MurmurHash3(analyzer.toString) scheme (StateProvider.scala:81-83) so the
two implementations can discover each other's files — see README
'State-file interop' for the JVM-validation caveat.

CAUTION on sketch states across engine versions: HLL registers are a
function of the engine's value hash. If the hash changes between builds
(it did when string hashing moved from per-row blake2b to the vectorized
bucket hash), persisted ApproxCountDistinct states from the older build
merge incorrectly with new ones — the same value lands in different
registers and is double-counted. Invalidate persisted HLL states when
upgrading across a hash change.
"""

from __future__ import annotations

import hashlib
import struct
import threading
from typing import TYPE_CHECKING, Dict, Optional

import numpy as np

from deequ_tpu_torch.analyzers.states import State

# the count column of a persisted frequency table (the reference's name,
# reference: analyzers/Analyzer.scala COUNT_COL; the JAX package keeps
# it in deequ_tpu/analyzers/base.py)
COUNT_COL = "com_amazon_deequ_dq_metrics_count"

if TYPE_CHECKING:
    from deequ_tpu_torch.analyzers.base import Analyzer


class StateLoader:
    def load(self, analyzer: "Analyzer") -> Optional[State]:
        raise NotImplementedError


class StatePersister:
    def persist(self, analyzer: "Analyzer", state: State) -> None:
        raise NotImplementedError


class InMemoryStateProvider(StateLoader, StatePersister):
    """Keyed by analyzer identity (reference: StateProvider.scala:46-69)."""

    def __init__(self) -> None:
        self._states: Dict["Analyzer", State] = {}
        self._lock = threading.Lock()

    def load(self, analyzer: "Analyzer") -> Optional[State]:
        with self._lock:
            return self._states.get(analyzer)

    def persist(self, analyzer: "Analyzer", state: State) -> None:
        with self._lock:
            self._states[analyzer] = state

    def __repr__(self) -> str:
        with self._lock:
            keys = ", ".join(repr(k) for k in self._states)
        return f"InMemoryStateProvider({keys})"


_MM3_C1 = 0xCC9E2D51
_MM3_C2 = 0x1B873593
_MASK32 = 0xFFFFFFFF


def _mm3_rotl(value: int, amount: int) -> int:
    return ((value << amount) | ((value & _MASK32) >> (32 - amount))) & _MASK32


def _mm3_mix_k(k: int) -> int:
    """The murmur3 x86_32 block premix: k*c1, rotl15, k*c2."""
    k = (k * _MM3_C1) & _MASK32
    k = _mm3_rotl(k, 15)
    return (k * _MM3_C2) & _MASK32


def _mm3_mix(h: int, data: int) -> int:
    """One full murmur3 x86_32 mix round (MurmurHash3.mix)."""
    h ^= _mm3_mix_k(data)
    h = _mm3_rotl(h, 13)
    return (h * 5 + 0xE6546B64) & _MASK32


def _mm3_mix_last(h: int, data: int) -> int:
    """Tail mix without the h-side rotation (MurmurHash3.mixLast)."""
    return h ^ _mm3_mix_k(data)


def _mm3_finalize(h: int, length: int) -> int:
    """MurmurHash3.finalizeHash: xor in the length, then avalanche."""
    h ^= length
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK32
    h ^= h >> 16
    return h


def _scala_murmur3_string_hash(s: str, seed: int = 42) -> int:
    """scala.util.hashing.MurmurHash3.stringHash(s, seed) — the hash the
    reference uses to name state files, with the explicit seed 42 from
    its call site (reference: analyzers/StateProvider.scala:81-83,
    ``MurmurHash3.stringHash(analyzer.toString, 42)``). Characters are
    consumed in UTF-16 code-unit pairs ((c[i] << 16) + c[i+1]) through
    the standard murmur3 x86_32 mix rounds; an odd final unit goes
    through mixLast; finalizeHash xors in the code-unit count. The mix/
    finalize primitives are validated against published murmur3 x86_32
    test vectors and hand-derived stringHash values in
    tests/test_persistence.py; there is no JVM in this image, so a
    one-time reference-side smoke test is still documented in README
    ('State-file interop')."""
    h = seed & _MASK32
    # Java charAt/length operate on UTF-16 CODE UNITS: derive them
    # explicitly so non-BMP characters (surrogate pairs on the JVM)
    # hash identically
    raw = s.encode("utf-16-be", "surrogatepass")
    units = [
        (raw[i] << 8) | raw[i + 1] for i in range(0, len(raw), 2)
    ]
    i = 0
    while i + 1 < len(units):
        h = _mm3_mix(h, ((units[i] << 16) + units[i + 1]) & _MASK32)
        i += 2
    if i < len(units):
        h = _mm3_mix_last(h, units[i])
    h = _mm3_finalize(h, len(units))
    # Scala's Int is signed
    return h - (1 << 32) if h >= (1 << 31) else h


class FileSystemStateProvider(StateLoader, StatePersister):
    """Binary per-analyzer state files
    (reference: HdfsStateProvider, StateProvider.scala:72-295).

    `filesystem` selects the storage backend (core/fsio.py — local disk,
    in-memory object-store fake, or any fsspec store). `naming` selects
    the file-name scheme: 'sha1' (default, this build's own stable
    naming) or 'reference' (MurmurHash3 of the analyzer's toString, the
    reference's scheme — lets the two implementations discover each
    other's state files when the payload layouts already match
    byte-for-byte)."""

    def __init__(
        self,
        location_prefix: str,
        allow_overwrite: bool = False,
        filesystem=None,
        naming: str = "sha1",
    ):
        from deequ_tpu_torch.core.fsio import resolve_filesystem

        if naming not in ("sha1", "reference"):
            raise ValueError(f"naming must be 'sha1' or 'reference', got {naming!r}")
        self.location_prefix = location_prefix
        self.allow_overwrite = allow_overwrite
        self.filesystem = resolve_filesystem(filesystem)
        self.naming = naming

    def _identifier(self, analyzer: "Analyzer") -> str:
        if self.naming == "reference":
            return str(_scala_murmur3_string_hash(repr(analyzer)))
        digest = hashlib.sha1(repr(analyzer).encode("utf-8")).hexdigest()[:16]
        return digest

    def _path(self, identifier: str, suffix: str = ".bin") -> str:
        return f"{self.location_prefix}-{identifier}{suffix}"

    # -- persist -------------------------------------------------------------

    def persist(self, analyzer: "Analyzer", state: State) -> None:
        from deequ_tpu_torch.analyzers.frequency import FrequencyBasedAnalyzer
        from deequ_tpu_torch.analyzers.histogram import Histogram

        identifier = self._identifier(analyzer)
        if isinstance(analyzer, (FrequencyBasedAnalyzer, Histogram)):
            # keep the reference's 3-file on-disk layout
            # (parquet + numRows + columns)
            self._persist_frequencies(identifier, state)
        else:
            self._write(identifier, serialize_state(analyzer, state))

    # -- load ----------------------------------------------------------------

    def load(self, analyzer: "Analyzer") -> Optional[State]:
        from deequ_tpu_torch.analyzers.frequency import FrequencyBasedAnalyzer
        from deequ_tpu_torch.analyzers.histogram import Histogram

        identifier = self._identifier(analyzer)
        if isinstance(analyzer, (FrequencyBasedAnalyzer, Histogram)):
            return self._load_frequencies(identifier)
        data = self._read(identifier)
        if data is None:
            return None
        return deserialize_state(analyzer, data)

    # -- io ------------------------------------------------------------------

    def _write(self, identifier: str, payload: bytes) -> None:
        path = self._path(identifier)
        if self.filesystem.exists(path) and not self.allow_overwrite:
            raise FileExistsError(f"File {path} already exists and overwrite disabled")
        self.filesystem.write_bytes(path, payload)

    def _read(self, identifier: str) -> Optional[bytes]:
        path = self._path(identifier)
        if not self.filesystem.exists(path):
            return None
        return self.filesystem.read_bytes(path)

    def _persist_frequencies(self, identifier: str, state) -> None:
        """Frequencies as Parquet + numRows binary
        (reference: StateProvider.scala:211-223)."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        paths = {
            suffix: self._path(identifier, suffix)
            for suffix in ("-frequencies.pqt", "-num_rows.bin", "-columns.txt")
        }
        if not self.allow_overwrite:
            for path in paths.values():
                if self.filesystem.exists(path):
                    raise FileExistsError(
                        f"File {path} already exists and overwrite disabled"
                    )

        # write siblings first, parquet last with atomic publish: load()
        # keys on the .pqt, so a crash mid-persist leaves a state that
        # reads as absent, never corrupt
        self.filesystem.write_bytes(
            paths["-num_rows.bin"], struct.pack(">q", state.num_rows)
        )
        self.filesystem.write_bytes(
            paths["-columns.txt"], "\n".join(state.columns).encode("utf-8")
        )
        with self.filesystem.open_write(paths["-frequencies.pqt"]) as sink:
            if getattr(state, "is_spilled", False):
                # disk-spilled state streams partition by partition into
                # the same Parquet layout (one row group per partition) —
                # persist never materializes the full key set
                writer = None
                for part in state.partitions():
                    at = pa.table(_frequencies_to_columns(part))
                    if writer is None:
                        writer = pq.ParquetWriter(sink, at.schema)
                    writer.write_table(at)
                if writer is None:
                    pq.write_table(
                        pa.table(
                            {
                                **{name: [] for name in state.columns},
                                COUNT_COL: np.array([], dtype=np.int64),
                            }
                        ),
                        sink,
                    )
                else:
                    writer.close()
            else:
                pq.write_table(pa.table(_frequencies_to_columns(state)), sink)

    def _load_frequencies(self, identifier: str):
        import pyarrow.parquet as pq

        pqt_path = self._path(identifier, "-frequencies.pqt")
        if not self.filesystem.exists(pqt_path):
            return None
        columns_payload = self.filesystem.read_bytes(
            self._path(identifier, "-columns.txt")
        ).decode("utf-8")
        columns = [line for line in columns_payload.split("\n") if line]
        (num_rows,) = struct.unpack(
            ">q", self.filesystem.read_bytes(self._path(identifier, "-num_rows.bin"))
        )
        # load row group by row group through the group-cap accumulator:
        # a persisted high-cardinality state comes back SPILLED, keeping
        # the persist/load round trip bounded-memory on both halves
        from deequ_tpu_torch.analyzers.freq_spill import GroupCountAccumulator

        acc = GroupCountAccumulator(columns)
        with self.filesystem.open_read(pqt_path) as source, pq.ParquetFile(
            source
        ) as pf:
            for g in range(pf.metadata.num_row_groups):
                partial = _frequencies_from_table(
                    pf.read_row_group(g), columns, 0
                )
                acc.add(partial)
        state = acc.finalize()
        state.num_rows = int(num_rows)
        return state


def serialize_state(analyzer: "Analyzer", state: State) -> bytes:
    """State -> reference-layout bytes (per-type big-endian formats,
    reference: StateProvider.scala:85-134). Frequency states get a
    self-contained envelope (column names + numRows + in-memory Parquet)
    so they can cross DCN, not just the filesystem."""
    from deequ_tpu_torch.analyzers.frequency import FrequencyBasedAnalyzer
    from deequ_tpu_torch.analyzers.histogram import Histogram
    from deequ_tpu_torch.analyzers.scan import (
        Completeness,
        Compliance,
        Correlation,
        DataType,
        Maximum,
        Mean,
        Minimum,
        PatternMatch,
        Size,
        StandardDeviation,
        Sum,
    )
    from deequ_tpu_torch.analyzers.sketch import ApproxCountDistinct, ApproxQuantile, ApproxQuantiles

    if isinstance(analyzer, Size):
        return struct.pack(">q", state.num_matches)
    if isinstance(analyzer, (Completeness, Compliance, PatternMatch)):
        return struct.pack(">qq", state.num_matches, state.count)
    if isinstance(analyzer, Sum):
        return struct.pack(">d", state.sum_value)
    if isinstance(analyzer, Mean):
        return struct.pack(">dq", state.total, state.count)
    if isinstance(analyzer, Minimum):
        return struct.pack(">d", state.min_value)
    if isinstance(analyzer, Maximum):
        return struct.pack(">d", state.max_value)
    if isinstance(analyzer, (FrequencyBasedAnalyzer, Histogram)):
        return _serialize_frequencies_bytes(state)
    if isinstance(analyzer, DataType):
        payload = struct.pack(
            ">qqqqq",
            state.num_null,
            state.num_fractional,
            state.num_integral,
            state.num_boolean,
            state.num_string,
        )
        return struct.pack(">i", len(payload)) + payload
    if isinstance(analyzer, ApproxCountDistinct):
        words = state.words()
        payload = struct.pack(f">{len(words)}q", *[int(w) for w in words])
        return struct.pack(">i", len(payload)) + payload
    if isinstance(analyzer, Correlation):
        return struct.pack(
            ">dddddd",
            state.n, state.x_avg, state.y_avg, state.ck, state.x_mk, state.y_mk,
        )
    if isinstance(analyzer, StandardDeviation):
        return struct.pack(">ddd", state.n, state.avg, state.m2)
    if isinstance(analyzer, (ApproxQuantile, ApproxQuantiles)):
        return _serialize_kll(state.digest)
    raise ValueError(f"Unable to persist state for analyzer {analyzer!r}.")


def deserialize_state(analyzer: "Analyzer", data: bytes) -> State:
    """Inverse of serialize_state (reference: StateProvider.scala:136-174)."""
    from deequ_tpu_torch.analyzers.frequency import FrequencyBasedAnalyzer
    from deequ_tpu_torch.analyzers.histogram import Histogram
    from deequ_tpu_torch.analyzers.scan import (
        Completeness,
        Compliance,
        Correlation,
        DataType,
        Maximum,
        Mean,
        Minimum,
        PatternMatch,
        Size,
        StandardDeviation,
        Sum,
    )
    from deequ_tpu_torch.analyzers.sketch import (
        ApproxCountDistinct,
        ApproxCountDistinctState,
        ApproxQuantile,
        ApproxQuantiles,
        ApproxQuantileState,
    )
    from deequ_tpu_torch.analyzers import states as S
    from deequ_tpu_torch.ops.sketches import hll as hll_mod

    if isinstance(analyzer, Size):
        return S.NumMatches(struct.unpack(">q", data)[0])
    if isinstance(analyzer, (Completeness, Compliance, PatternMatch)):
        matches, count = struct.unpack(">qq", data)
        return S.NumMatchesAndCount(matches, count)
    if isinstance(analyzer, Sum):
        return S.SumState(struct.unpack(">d", data)[0])
    if isinstance(analyzer, Mean):
        total, count = struct.unpack(">dq", data)
        return S.MeanState(total, count)
    if isinstance(analyzer, Minimum):
        return S.MinState(struct.unpack(">d", data)[0])
    if isinstance(analyzer, Maximum):
        return S.MaxState(struct.unpack(">d", data)[0])
    if isinstance(analyzer, (FrequencyBasedAnalyzer, Histogram)):
        return _deserialize_frequencies_bytes(data)
    if isinstance(analyzer, DataType):
        (length,) = struct.unpack(">i", data[:4])
        values = struct.unpack(">qqqqq", data[4 : 4 + length])
        return S.DataTypeHistogram(*values)
    if isinstance(analyzer, ApproxCountDistinct):
        (length,) = struct.unpack(">i", data[:4])
        words = np.array(
            struct.unpack(f">{length // 8}q", data[4 : 4 + length]), dtype=np.int64
        )
        return ApproxCountDistinctState(hll_mod.unpack_words(words))
    if isinstance(analyzer, Correlation):
        return S.CorrelationState(*struct.unpack(">dddddd", data))
    if isinstance(analyzer, StandardDeviation):
        return S.StandardDeviationState(*struct.unpack(">ddd", data))
    if isinstance(analyzer, (ApproxQuantile, ApproxQuantiles)):
        return ApproxQuantileState(_deserialize_kll(data))
    raise ValueError(f"Unable to load state for analyzer {analyzer!r}.")


def _frequencies_to_columns(state) -> dict:
    """State -> the {key columns..., COUNT_COL} dict both the on-disk
    Parquet layout and the DCN envelope serialize."""
    columns = {
        name: state.key_columns[i].tolist() for i, name in enumerate(state.columns)
    }
    columns[COUNT_COL] = [int(c) for c in state.counts]
    return columns


def _frequencies_from_table(table, columns, num_rows):
    """Arrow table (+ declared key-column order, numRows) -> state."""
    from deequ_tpu_torch.analyzers.frequency import FrequenciesAndNumRows

    counts = np.asarray(table.column(COUNT_COL).to_pylist(), dtype=np.int64)
    key_columns = [
        np.array(table.column(c).to_pylist(), dtype=object) for c in columns
    ]
    return FrequenciesAndNumRows(list(columns), key_columns, counts, int(num_rows))


def _serialize_frequencies_bytes(state) -> bytes:
    """Envelope: ncols, utf8 names, numRows, in-memory Parquet payload.

    Spilled states stream partition by partition into the payload (one
    row group each) — the bytes themselves are necessarily materialized
    (they're about to cross DCN), but the object key set never is."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    sink = pa.BufferOutputStream()
    if getattr(state, "is_spilled", False):
        writer = None
        for part in state.partitions():
            at = pa.table(_frequencies_to_columns(part))
            if writer is None:
                writer = pq.ParquetWriter(sink, at.schema)
            writer.write_table(at)
        if writer is None:
            pq.write_table(
                pa.table(
                    {
                        **{name: [] for name in state.columns},
                        COUNT_COL: np.array([], dtype=np.int64),
                    }
                ),
                sink,
            )
        else:
            writer.close()
    else:
        pq.write_table(pa.table(_frequencies_to_columns(state)), sink)
    parquet = sink.getvalue().to_pybytes()

    parts = [struct.pack(">i", len(state.columns))]
    for name in state.columns:
        encoded = name.encode("utf-8")
        parts.append(struct.pack(">i", len(encoded)))
        parts.append(encoded)
    parts.append(struct.pack(">qi", state.num_rows, len(parquet)))
    parts.append(parquet)
    return b"".join(parts)


def _deserialize_frequencies_bytes(data: bytes):
    import pyarrow.parquet as pq
    import pyarrow as pa

    (ncols,) = struct.unpack(">i", data[:4])
    offset = 4
    columns = []
    for _ in range(ncols):
        (length,) = struct.unpack(">i", data[offset : offset + 4])
        offset += 4
        columns.append(data[offset : offset + length].decode("utf-8"))
        offset += length
    num_rows, parquet_len = struct.unpack(">qi", data[offset : offset + 12])
    offset += 12
    # row-group-wise through the group-cap accumulator: a high-cardinality
    # envelope re-spills on the receiving host instead of materializing
    from deequ_tpu_torch.analyzers.freq_spill import GroupCountAccumulator

    acc = GroupCountAccumulator(columns)
    with pq.ParquetFile(
        pa.BufferReader(data[offset : offset + parquet_len])
    ) as pf:
        for g in range(pf.metadata.num_row_groups):
            acc.add(_frequencies_from_table(pf.read_row_group(g), columns, 0))
    state = acc.finalize()
    state.num_rows = int(num_rows)
    return state


def _serialize_kll(digest) -> bytes:
    """Our own digest layout (KLL, not the reference's GK digest — the
    sketch algorithms differ; see BASELINE.md parity notes)."""
    k, n, levels = digest.to_arrays()
    parts = [struct.pack(">iqi", k, n, len(levels))]
    for level in levels:
        parts.append(struct.pack(">i", len(level)))
        parts.append(np.asarray(level, dtype=">f8").tobytes())
    # trailing generator position: KLL merges draw compaction offsets
    # from the sketch's own rng, so restoring it is what makes a
    # deserialized partial merge bit-identically to the live sketch
    parts.append(digest.rng_state_bytes())
    return b"".join(parts)


def _deserialize_kll(data: bytes):
    from deequ_tpu_torch.ops.sketches.kll import KLLSketch

    k, n, depth = struct.unpack(">iqi", data[:16])
    offset = 16
    levels = []
    for _ in range(depth):
        (length,) = struct.unpack(">i", data[offset : offset + 4])
        offset += 4
        level = np.frombuffer(data[offset : offset + 8 * length], dtype=">f8").astype(
            np.float64
        )
        offset += 8 * length
        levels.append(level)
    sketch = KLLSketch.from_arrays(k, n, levels)
    tail = data[offset:]
    if len(tail) == KLLSketch.RNG_STATE_LEN:
        sketch.set_rng_state_bytes(tail)
    return sketch
