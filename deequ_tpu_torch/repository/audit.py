"""Forensics audit trail as first-class repository citizens.

The forensics report (observe/forensics.py: sampled violating rows +
metric provenance) persists through the ordinary `MetricsRepository`
path the same way engine telemetry does (repository/engine.py): an
`AuditRecord` pseudo-analyzer keys one report in the saved metric map,
so the audit trail rides the exact save/load/filter/serde machinery as
the data-quality metrics it explains — one store, one history.

The payload is a versioned binary envelope (NO pickle):

    DQFA | version u32 | payload_len u32 | payload json utf-8
      | sha256(previous bytes)

base64-wrapped when it crosses the JSON serde. Decode failures follow
the state-cache safety contract (repository/states.py): a corrupt,
truncated or version-bumped entry NEVER produces a wrong answer — it
degrades to "no forensics available", surfaced as a DQ317 lenient
warning.
"""

from __future__ import annotations

import base64
import hashlib
import json
import struct
import warnings
from typing import Any, Dict, Optional, Tuple

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.core.maybe import Success
from deequ_tpu_torch.core.metrics import DoubleMetric, Entity
from deequ_tpu_torch.repository.base import MetricsRepository, ResultKey

__all__ = [
    "AUDIT_FORMAT_VERSION",
    "AUDIT_MAGIC",
    "AuditDecodeError",
    "AuditRecord",
    "audit_entry_for",
    "decode_audit",
    "encode_audit",
    "load_audit_trail",
]

#: envelope magic — "DeeQu Forensics Audit"; bump AUDIT_FORMAT_VERSION
#: whenever the ForensicsReport dict shape changes incompatibly
AUDIT_MAGIC = b"DQFA"
AUDIT_FORMAT_VERSION = 1

_DIGEST = hashlib.sha256
_DIGEST_LEN = 32


class AuditDecodeError(ValueError):
    """An audit-trail entry that cannot be decoded (corrupt, truncated,
    or version-mismatched). Callers degrade to no-forensics — never a
    wrong answer."""


def _warn_fallback(reason: str) -> None:
    """The DQ317 lenient warning: one line, machine-greppable code."""
    warnings.warn(
        f"DQ317: forensics audit-trail entry is unusable ({reason}); "
        "the run's forensics are unavailable from this repository",
        RuntimeWarning,
        stacklevel=3,
    )


# -- versioned envelope -------------------------------------------------------


def encode_audit(payload: Dict[str, Any]) -> bytes:
    """Serialize one forensics-report dict into the versioned envelope.
    The JSON is canonicalized (sorted keys) so identical reports encode
    to identical bytes."""
    raw = json.dumps(payload, sort_keys=True, allow_nan=False).encode("utf-8")
    body = bytearray()
    body += AUDIT_MAGIC
    body += struct.pack(">I", AUDIT_FORMAT_VERSION)
    body += struct.pack(">I", len(raw))
    body += raw
    return bytes(body) + _DIGEST(bytes(body)).digest()


def decode_audit(blob: bytes) -> Dict[str, Any]:
    """Inverse of `encode_audit`, validated end to end: digest first
    (corruption), then magic/version (format drift), then payload
    bounds (truncation). Any failure raises `AuditDecodeError`."""
    header = len(AUDIT_MAGIC) + 8
    if len(blob) < header + _DIGEST_LEN:
        raise AuditDecodeError("truncated envelope")
    body, digest = blob[:-_DIGEST_LEN], blob[-_DIGEST_LEN:]
    if _DIGEST(body).digest() != digest:
        raise AuditDecodeError("integrity digest mismatch")
    if body[: len(AUDIT_MAGIC)] != AUDIT_MAGIC:
        raise AuditDecodeError("bad magic")
    version, length = struct.unpack_from(">II", body, len(AUDIT_MAGIC))
    if version != AUDIT_FORMAT_VERSION:
        raise AuditDecodeError(
            f"format version {version} (this build reads {AUDIT_FORMAT_VERSION})"
        )
    if header + length != len(body):
        raise AuditDecodeError("payload length mismatch")
    try:
        payload = json.loads(body[header:].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise AuditDecodeError(f"undecodable payload: {e}") from e
    if not isinstance(payload, dict):
        raise AuditDecodeError("payload is not an object")
    return payload


# -- the pseudo-analyzer keying one audit entry -------------------------------


class AuditRecord(Analyzer):
    """Pseudo-analyzer keying one forensics audit entry in a repository.

    Never runs against data — it exists so the audit trail rides the
    ordinary `AnalyzerContext`/`MetricsRepository` path. `payload` is
    the base64 of the binary envelope; the repr carries a payload
    digest so two different reports never collide under the base
    Analyzer's repr-keyed identity."""

    def __init__(self, payload: str, instance: str = "forensics"):
        self.payload = str(payload)
        self._instance = str(instance)

    @property
    def name(self) -> str:
        return "ForensicsAudit"

    @property
    def instance(self) -> str:
        return self._instance

    @property
    def entity(self) -> Entity:
        return Entity.DATASET

    def compute_state_from(self, table: Any) -> Any:
        raise NotImplementedError(
            "AuditRecord is an audit-trail key, not a data analyzer."
        )

    def to_metric(self) -> DoubleMetric:
        """A success-valued metric (the envelope byte length) so the
        entry survives FileSystemMetricsRepository.save's
        success-metrics filter."""
        try:
            size = len(base64.b64decode(self.payload, validate=True))
        except (ValueError, TypeError):
            size = len(self.payload)
        return DoubleMetric(
            self.entity, self.name, self.instance, Success(float(size))
        )

    def __repr__(self) -> str:
        digest = hashlib.sha256(self.payload.encode("ascii", "replace"))
        return (
            f"AuditRecord(instance={self._instance!r}, "
            f"digest={digest.hexdigest()[:16]!r})"
        )


def audit_entry_for(report: Any) -> Tuple[AuditRecord, DoubleMetric]:
    """(pseudo-analyzer, metric) for one `ForensicsReport` — merge into
    the metric map the suite is about to save and the trail persists
    through whatever repository is attached."""
    blob = encode_audit(report.to_dict())
    record = AuditRecord(base64.b64encode(blob).decode("ascii"))
    return record, record.to_metric()


def load_audit_trail(
    repository: MetricsRepository, result_key: ResultKey
) -> Optional[Any]:
    """The forensics report persisted under `result_key`, or None when
    the key has no audit entry or the entry is unusable (DQ317 warning,
    degrade — never a wrong answer)."""
    from deequ_tpu_torch.observe.forensics import ForensicsReport

    try:
        context = repository.load_by_key(result_key)
    except Exception as e:  # noqa: BLE001 - unreadable history degrades
        _warn_fallback(f"repository load failed: {e}")
        return None
    if context is None:
        return None
    for analyzer in context.metric_map:
        if getattr(analyzer, "name", None) != "ForensicsAudit":
            continue
        payload = getattr(analyzer, "payload", None)
        if not isinstance(payload, str):
            _warn_fallback("entry has no payload")
            return None
        try:
            blob = base64.b64decode(payload, validate=True)
        except (ValueError, TypeError) as e:
            _warn_fallback(f"undecodable base64: {e}")
            return None
        try:
            return ForensicsReport.from_dict(decode_audit(blob))
        except AuditDecodeError as e:
            _warn_fallback(str(e))
            return None
    return None
