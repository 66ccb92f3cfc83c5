"""Execution-engine selection: the single-device fused pass or the
mesh-sharded pass (parallel/distributed.py).

Every runner takes `engine`:

    "auto"         -> a mesh over all CUDA devices of the process when it
                      has two or more and the table has at least
                      AUTO_MIN_ROWS rows, else the single-device pass
                      (the default)
    "single"       -> the single-device fused pass
    "distributed"  -> the mesh pass (over `mesh`, else all CUDA devices;
                      a CPU run without a mesh shards over one CPU device)

Resolution returns the DeviceMesh to shard over, or None for the single
device. The JAX counterpart is deequ_tpu/runners/engine.py.
"""

from __future__ import annotations

from typing import Optional

VALID_ENGINES = ("auto", "single", "distributed")

# "auto" shards only a table big enough to pay for the per-shard
# launches and the shard merge; "distributed" ignores the threshold
AUTO_MIN_ROWS = 1 << 17


def resolve_engine(engine: str = "auto", mesh=None, num_rows: Optional[int] = None, device=None):
    """The mesh a run over `num_rows` rows on `device` (a resolved
    torch.device, or None for CUDA) shards over, or None."""
    if engine not in VALID_ENGINES:
        raise ValueError(f"engine must be one of {VALID_ENGINES}, got {engine!r}")
    if engine == "single":
        return None
    if engine == "auto" and num_rows is not None and num_rows < AUTO_MIN_ROWS:
        return None
    from deequ_tpu_torch.parallel.distributed import data_mesh

    if mesh is not None:
        if device is not None and mesh.device_type != device.type:
            raise ValueError(
                f"the mesh's devices are {mesh.device_type}, the run's device is {device}"
            )
        return mesh
    if device is not None and device.type == "cpu":
        # a CPU run meets a mesh only when the caller asks for one
        return data_mesh([device]) if engine == "distributed" else None
    import torch

    if engine == "distributed" or torch.cuda.device_count() > 1:
        return data_mesh()
    return None
