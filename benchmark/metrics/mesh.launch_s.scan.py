"""mesh.launch_s.scan: self time of the mesh pass's `mesh_launch` spans (a
shard's wait for its copy, program lookup and launch on its card, host
side), seconds per run; None without a mesh pass."""
from benchmark.stats import self_time_per_request


def read(run):
    return self_time_per_request(run, ("mesh_launch",))
