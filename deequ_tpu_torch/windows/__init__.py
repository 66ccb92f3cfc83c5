"""Temporal state algebra: windowed metrics over partition time.

The semigroup of mergeable sufficient statistics makes
metrics over ANY span of data a pure state merge — this package turns
that algebra into a first-class time axis. `WindowSpec` (tumbling,
sliding, last-N) compiles a window query into a merge tree over
`StateRepository` entries; precomputed power-of-two segment states
(`DQSG` envelopes, `segments.py`) resolve any window in O(log
#partitions) repository loads with zero data rows read; and
`WindowQuery` (`query.py`) executes the tree bit-identically to a full
rescan of the same partitions. A query runs on CUDA unless the caller
passes ``device="cpu"``: its rescans fold there and its merged states
reduce to metrics there.

The JAX counterpart is deequ_tpu/windows/.
"""

from deequ_tpu_torch.windows.spec import (
    LastN,
    Sliding,
    Timeline,
    Tumbling,
    WindowFrame,
    WindowSpec,
    default_bucket_for,
)
from deequ_tpu_torch.windows.segments import (
    SEGMENT_FORMAT_VERSION,
    SEGMENT_MAGIC,
    Segment,
    SegmentStore,
    aligned_cover,
    decode_segment,
    encode_segment,
    span_fingerprint,
)
from deequ_tpu_torch.windows.query import (
    SpanResolution,
    WindowPlan,
    WindowQuery,
)

__all__ = [
    "SEGMENT_FORMAT_VERSION",
    "SEGMENT_MAGIC",
    "LastN",
    "Segment",
    "SegmentStore",
    "Sliding",
    "SpanResolution",
    "Timeline",
    "Tumbling",
    "WindowFrame",
    "WindowPlan",
    "WindowQuery",
    "WindowSpec",
    "aligned_cover",
    "decode_segment",
    "default_bucket_for",
    "encode_segment",
    "span_fingerprint",
]
