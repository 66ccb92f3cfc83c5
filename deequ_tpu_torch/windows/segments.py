"""Precomputed segment states: power-of-two spans of per-partition DQST
envelopes, persisted through the `StateRepository` under a versioned
`DQSG` envelope keyed by ``(dataset, plan_signature, level, span
fingerprint)``.

Design note — why a segment carries per-partition blobs, not one
pre-merged state: the engine's fold is a sequential left-fold in
partition NAME order, and float addition and KLL merges are not
associative. A pre-merged segment would change the merge tree and
forfeit bit-identity with a full rescan. So a `DQSG` envelope bundles
the span's per-partition `DQST` envelopes (the exact bytes the scan
committed), and a window query still merges partition-by-partition in
global name order — bit-identical by construction. The win is IO
shape, not arithmetic: any window resolves in O(log #partitions)
repository round-trips instead of one per partition, with zero data
rows read either way.

Invalidation is content-keyed: a span's fingerprint hashes its member
``(bucket, partition fingerprint)`` pairs in merge order, so a late or
re-stated partition CHANGES the key of exactly the O(log n) spans
covering its bucket — stale segments are simply never looked up again,
and the fresh keys rebuild lazily from per-partition states. Corrupt,
truncated, or version-bumped entries degrade identically: a DQ323
RuntimeWarning and a rebuild from per-partition states — never a wrong
answer. Writes ride the repository's existing tmp+rename+flock path.

The envelope's bytes equal the JAX package's (deequ_tpu/windows/
segments.py) for equal states.
"""

from __future__ import annotations

import hashlib
import struct
import warnings
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

from deequ_tpu_torch.repository.states import StateDecodeError
from deequ_tpu_torch.testing import faults

__all__ = [
    "SEGMENT_FORMAT_VERSION",
    "SEGMENT_MAGIC",
    "Segment",
    "SegmentStore",
    "aligned_cover",
    "decode_segment",
    "encode_segment",
    "segment_key",
    "span_fingerprint",
]

#: envelope magic — "DeeQu SeGment"; bump SEGMENT_FORMAT_VERSION when
#: this layout changes (the inner DQST blobs carry their own version)
SEGMENT_MAGIC = b"DQSG"
SEGMENT_FORMAT_VERSION = 1

_DIGEST = hashlib.sha256
_DIGEST_LEN = 32


def span_fingerprint(
    level: int, start: int, members: Sequence[Tuple[int, str]]
) -> str:
    """Content key of one span: the level, the absolute span start, and
    every member's ``(bucket, partition fingerprint)`` in merge order.
    Any membership or content change yields a different key, so stale
    segment entries self-invalidate by never being addressed again."""
    h = _DIGEST()
    h.update(SEGMENT_MAGIC)
    h.update(struct.pack(">IIq", SEGMENT_FORMAT_VERSION, int(level), int(start)))
    for bucket, fingerprint in members:
        h.update(struct.pack(">q", int(bucket)))
        h.update(fingerprint.encode("utf-8") + b"\x00")
    return h.hexdigest()[:32]


def segment_key(level: int, fingerprint: str) -> str:
    """The repository key a segment lives under (the `fingerprint` slot
    of the ``(dataset, signature, fingerprint)`` triple). The `seg-`
    prefix keeps segment entries disjoint from partition fingerprints
    (which are bare hex)."""
    return f"seg-L{int(level):02d}-{fingerprint}"


@dataclass
class Segment:
    """One decoded segment: which span, under which plan signature, and
    the member partitions' DQST envelopes in merge (name) order."""

    level: int
    start: int
    signature: str
    #: (partition name, bucket, DQST envelope bytes) in merge order
    entries: List[Tuple[str, int, bytes]]

    @property
    def span(self) -> Tuple[int, int]:
        return (self.start, self.start + (1 << self.level))


def encode_segment(
    level: int,
    start: int,
    signature: str,
    entries: Sequence[Tuple[str, int, bytes]],
) -> bytes:
    """Serialize one span's per-partition envelopes:

        DQSG | version u32 | level u32 | start i64 |
          sig_len u32 | signature utf8 | count u32 |
          ( name_len u32 | name utf8 | bucket i64 |
            blob_len u32 | DQST blob )*
        | sha256(previous bytes)

    Each entry's blob is a complete self-validated `encode_states`
    envelope — byte-identical to what the scan committed per partition,
    so a window merge decodes members exactly as `merge_range` would
    load them one by one."""
    body = bytearray()
    body += SEGMENT_MAGIC
    body += struct.pack(">I", SEGMENT_FORMAT_VERSION)
    body += struct.pack(">Iq", int(level), int(start))
    sig_b = signature.encode("utf-8")
    body += struct.pack(">I", len(sig_b)) + sig_b
    body += struct.pack(">I", len(entries))
    for name, bucket, blob in entries:
        name_b = name.encode("utf-8")
        body += struct.pack(">I", len(name_b)) + name_b
        body += struct.pack(">q", int(bucket))
        body += struct.pack(">I", len(blob)) + blob
    return bytes(body) + _DIGEST(bytes(body)).digest()


def decode_segment(blob: bytes) -> Segment:
    """Inverse of `encode_segment`, validated end to end: digest first
    (corruption), then magic/version (format drift), then per-entry
    bounds (truncation). Any defect raises `StateDecodeError` — the
    caller rebuilds the span from per-partition states."""
    header = len(SEGMENT_MAGIC)
    if len(blob) < header + 4 + _DIGEST_LEN:
        raise StateDecodeError("truncated segment envelope")
    body, digest = blob[:-_DIGEST_LEN], blob[-_DIGEST_LEN:]
    if _DIGEST(body).digest() != digest:
        raise StateDecodeError("segment envelope digest mismatch")
    if body[:header] != SEGMENT_MAGIC:
        raise StateDecodeError("bad segment magic")
    off = header
    try:
        (version,) = struct.unpack_from(">I", body, off)
        off += 4
        if version != SEGMENT_FORMAT_VERSION:
            raise StateDecodeError(
                f"segment format version {version} != {SEGMENT_FORMAT_VERSION}"
            )
        level, start = struct.unpack_from(">Iq", body, off)
        off += 12
        (sig_len,) = struct.unpack_from(">I", body, off)
        off += 4
        signature = body[off : off + sig_len].decode("utf-8")
        off += sig_len
        (count,) = struct.unpack_from(">I", body, off)
        off += 4
        entries: List[Tuple[str, int, bytes]] = []
        for _ in range(count):
            (name_len,) = struct.unpack_from(">I", body, off)
            off += 4
            name = body[off : off + name_len].decode("utf-8")
            if len(name.encode("utf-8")) != name_len:
                raise StateDecodeError("truncated segment entry name")
            off += name_len
            (bucket,) = struct.unpack_from(">q", body, off)
            off += 8
            (blob_len,) = struct.unpack_from(">I", body, off)
            off += 4
            entry = body[off : off + blob_len]
            if len(entry) != blob_len:
                raise StateDecodeError("truncated segment entry payload")
            off += blob_len
            entries.append((name, int(bucket), bytes(entry)))
    except struct.error as e:
        raise StateDecodeError(f"truncated segment envelope: {e}") from e
    if off != len(body):
        raise StateDecodeError("trailing bytes after last segment entry")
    return Segment(
        level=int(level), start=int(start), signature=signature,
        entries=entries,
    )


def aligned_cover(lo: int, hi: int) -> List[Tuple[int, int]]:
    """Greedy decomposition of ``[lo, hi)`` into aligned power-of-two
    spans ``(level, start)`` — each span starts at a multiple of its own
    size. At most 2·log2(hi-lo) spans, ascending; the canonical
    segment-tree cover, so every query over the same range addresses
    the same segment keys."""
    if lo < 0:
        raise ValueError(f"aligned cover needs lo >= 0, got {lo}")
    spans: List[Tuple[int, int]] = []
    cur = int(lo)
    hi = int(hi)
    while cur < hi:
        remaining = hi - cur
        if cur == 0:
            level = remaining.bit_length() - 1
        else:
            align = (cur & -cur).bit_length() - 1
            level = min(align, remaining.bit_length() - 1)
        spans.append((level, cur))
        cur += 1 << level
    return spans


def _warn_segment(dataset: str, key: str, reason: str) -> None:
    """The DQ323 lenient warning: the window stays answerable — the
    span rebuilds from per-partition states — but the operator sees
    exactly which segment entry degraded."""
    warnings.warn(
        f"DQ323: segment entry {key!r} for dataset {dataset!r} is "
        f"unusable ({reason}); the span falls back to per-partition "
        "states and will be rewritten",
        RuntimeWarning,
        stacklevel=3,
    )


class SegmentStore:
    """Segment persistence over a `StateRepository`: the same backends,
    the same ``(dataset, signature, key)`` addressing, the same atomic
    tmp+rename+flock write path — segments are just one more kind of
    envelope in the store."""

    def __init__(self, repository: Any, dataset: str, signature: str) -> None:
        self.repository = repository
        self.dataset = dataset
        self.signature = signature

    def has(self, level: int, fingerprint: str) -> bool:
        return bool(
            self.repository.has_blob(
                self.dataset, self.signature, segment_key(level, fingerprint)
            )
        )

    def load(self, level: int, fingerprint: str) -> Optional[Segment]:
        """The decoded segment, or None on any miss or defect (DQ323
        lenient warning) — never a wrong answer."""
        key = segment_key(level, fingerprint)
        try:
            faults.fault_point("state.segment")
            blob = self.repository.get_blob(self.dataset, self.signature, key)
        except Exception as e:  # noqa: BLE001 — unreadable entry = miss
            _warn_segment(self.dataset, key, f"unreadable: {e}")
            return None
        if blob is None:
            return None
        try:
            segment = decode_segment(blob)
        except StateDecodeError as e:
            _warn_segment(self.dataset, key, str(e))
            return None
        if segment.signature != self.signature:
            _warn_segment(
                self.dataset, key,
                f"plan signature {segment.signature!r} != {self.signature!r}",
            )
            return None
        return segment

    def save(
        self,
        level: int,
        start: int,
        fingerprint: str,
        entries: Sequence[Tuple[str, int, bytes]],
    ) -> bool:
        """Best-effort atomic publish, like `save_states`: a failed
        write never breaks the query — the span just stays cold."""
        blob = encode_segment(level, start, self.signature, entries)
        try:
            faults.fault_point("state.segment")
            self.repository.put_blob(
                self.dataset, self.signature, segment_key(level, fingerprint),
                blob,
            )
        except Exception:  # noqa: BLE001 — cache write must never break a query
            return False
        return True
