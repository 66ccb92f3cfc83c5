"""mesh.gather_s.scan: self time of the mesh pass's `mesh_gather` spans
(the shards' partials copied to the mesh's first card, stacked, and
their copy to the host enqueued; the fold of the batch before, which
`fused.merge_s.scan` reads, hangs under it), seconds per run; None
without a mesh pass."""
from benchmark.stats import self_time_per_request


def read(run):
    return self_time_per_request(run, ("mesh_gather",))
