"""mesh.ship_s.scan: self time of the mesh pass's `mesh_ship` spans (each
shard's slice of a batch packed into its wire and its copy to the
shard's card enqueued), seconds per run; None without a mesh pass."""
from benchmark.stats import self_time_per_request


def read(run):
    return self_time_per_request(run, ("mesh_ship",))
